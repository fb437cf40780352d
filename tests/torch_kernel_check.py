"""Seeded workloads that hold the port's CUDA decide kernel against its plain
version. ``chip_smoke.py`` and ``tests/test_torch_kernels.py`` import it.

Everything is made from a ``numpy.random.Generator``: a rule set that mixes
all four control behaviors, bounded-Zipf flow-id pulls, grouped batches with
prioritized rows and mixed or uniform acquires, and a namespace whose guard
budget the pulls cross. :func:`check_steps` runs the kernel's step and the
same step with :func:`decide_rows_plain` on two copies of one state and
compares every output, verdict and state leaf with ``torch.equal``.

:data:`STEP_OFFSETS_MS` spaces the steps so that the 1 s / 10-bucket ring
wraps onto columns that hold counts: one step reads buckets about to expire
(``expiring > 0``), later ones roll a written column and mask an aged one.
:func:`check_steps` reports which of those the run reached.
"""

from __future__ import annotations

from typing import List, Optional
from unittest import mock

import numpy as np
import torch

from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.decide import RequestBatch, make_batch
from sentinel_tpu_torch.engine.rules import ClusterFlowRule, ThresholdMode
from sentinel_tpu_torch.engine.state import (
    ClusterEvent,
    EngineState,
    clone_state,
    flow_spec,
)
from sentinel_tpu_torch.ops import decide_cuda
from sentinel_tpu_torch.stats import window as W

TIGHT_NS = "tight"

# step times after a start 40 ms past a whole second (bucket_ms=100, B=10):
# same bucket, a roll onto an empty column, a read of the buckets about to
# leave the window, then two rolls onto written columns while an older
# written column has aged out of the window
STEP_OFFSETS_MS = (0, 45, 175, 900, 1210, 2010)
# what check_steps reports as reached
COVERAGE = ("rolled_written_column", "masked_aged_column", "expiring_rows")


def mixed_rules(n_flows: int, n_namespaces: int,
                rng: np.random.Generator) -> List[ClusterFlowRule]:
    """``n_flows`` rules with flow_id = slot order 0..n-1: 4 in 5 DEFAULT,
    the rest WARM_UP / RATE_LIMITER / WARM_UP_RATE_LIMITER; both threshold
    modes; namespace 0, which holds flow 0 (the hottest id of a Zipf pull),
    is ``tight``: callers give it a small guard budget to cross."""
    behaviors = rng.choice(
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3], size=n_flows
    )
    counts = rng.integers(10, 200, size=n_flows)
    rules = []
    for i in range(n_flows):
        ns = i % n_namespaces
        rules.append(ClusterFlowRule(
            flow_id=i,
            count=float(counts[i]),
            mode=ThresholdMode.GLOBAL if i % 3 else ThresholdMode.AVG_LOCAL,
            namespace=TIGHT_NS if ns == 0 else f"ns{ns}",
            control_behavior=int(behaviors[i]),
            warm_up_period_sec=int(rng.integers(2, 12)),
            max_queueing_time_ms=int(rng.integers(50, 800)),
        ))
    return rules


class ZipfIds:
    """Bounded Zipf(``alpha``) sampler over ``[0, n)`` (rank 0 hottest)."""

    def __init__(self, n: int, alpha: float = 1.1):
        w = np.arange(1, n + 1, dtype=np.float64) ** -alpha
        self.cdf = np.cumsum(w / w.sum())

    def __call__(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return np.minimum(
            np.searchsorted(self.cdf, rng.random(size)), self.cdf.size - 1
        ).astype(np.int64)


def grouped_batch(config: EngineConfig, rng: np.random.Generator,
                  zipf: ZipfIds, n: int, uniform: bool,
                  unknown: int = 0) -> RequestBatch:
    """A grouped (slot-sorted) batch of ``n`` live rows padded to
    ``config.batch_size``: 10% prioritized, acquire 1 (uniform) or 1..3;
    ``unknown`` rows carry slot -1 (no rule)."""
    slots = zipf(rng, n).astype(np.int32)
    if unknown:
        slots[rng.choice(n, size=unknown, replace=False)] = -1
    slots.sort()
    acq = (np.ones(n, np.int32) if uniform
           else rng.integers(1, 4, size=n).astype(np.int32))
    prio = rng.random(n) < 0.1
    return make_batch(config, slots, acq, prio)


def compare(a, b) -> Optional[float]:
    """``None`` when equal (``torch.equal``), else the max |a - b|."""
    if torch.equal(a, b):
        return None
    return float((a.double() - b.double()).abs().max())


def ring_coverage(config: EngineConfig, state: EngineState,
                  batch: RequestBatch, now: int) -> set:
    """Which of :data:`COVERAGE` a step at ``now`` from ``state`` reaches:
    it zeroes a column that holds counts, its window read must skip an aged
    column that holds counts, or a batch row has PASS counts in the buckets
    about to expire (the priority-occupy ``expiring`` term)."""
    spec = flow_spec(config)
    idx_cur, cur_start = W.bucket_index(spec, now)
    starts = state.flow.starts.cpu()
    counts = state.flow.counts
    written = counts.ne(0).any(dim=2).any(dim=0).cpu()  # [B]
    age = now - starts
    valid = (age >= 0) & (age < spec.interval_ms)
    reached = set()
    if int(starts[idx_cur]) != cur_start and bool(written[idx_cur]):
        reached.add("rolled_written_column")
    others = torch.arange(spec.n_buckets) != idx_cur
    if bool((others & ~valid & written).any()):
        reached.add("masked_aged_column")
    horizon = now + (spec.bucket_ms - now % spec.bucket_ms) - spec.interval_ms
    exp = (valid & (starts <= horizon)).to(counts.device)
    slots = torch.as_tensor(np.asarray(batch.flow_slot)).long()
    slots = slots[slots >= 0].to(counts.device)
    pass_rows = counts[slots][:, :, int(ClusterEvent.PASS)]
    if bool((pass_rows * exp[None, :]).sum() > 0):
        reached.add("expiring_rows")
    return reached


def check_steps(config: EngineConfig, table, state: EngineState,
                batches, nows, uniform: bool):
    """Step the kernel and its plain version over ``batches`` at ``nows``
    from two copies of ``state``. Returns ``(max_abs_err, mismatches,
    kernel_state, statuses, reached)``: mismatches lists ``"step k: field"``
    labels, statuses the kernel side's verdict statuses of every step,
    reached the :data:`COVERAGE` items some step reached."""
    st_k, st_p = clone_state(state), clone_state(state)
    mismatches, max_err, statuses, reached = [], 0.0, [], set()
    for k, (batch, now) in enumerate(zip(batches, nows)):
        reached |= ring_coverage(config, st_p, batch, now)
        seen = {}
        kernel, plain = decide_cuda.decide_rows, decide_cuda.decide_rows_plain

        def kern(*args):
            seen["kernel"] = kernel(*args)
            return seen["kernel"]

        def plain_rows(*args):
            seen["plain"] = plain(*args)
            return seen["plain"]

        with mock.patch.object(decide_cuda, "decide_rows", kern):
            st_k, v_k = decide_cuda.decide_core_kernel(
                config, st_k, table, batch, now, grouped=True,
                uniform=uniform)
        with mock.patch.object(decide_cuda, "decide_rows", plain_rows):
            st_p, v_p = decide_cuda.decide_core_kernel(
                config, st_p, table, batch, now, grouped=True,
                uniform=uniform)
        pairs = [
            (f"rows.{f}", a, b)
            for f, a, b in zip(seen["kernel"]._fields, seen["kernel"],
                               seen["plain"])
        ] + [
            (f"verdict.{f}", a, b) for f, a, b in zip(v_k._fields, v_k, v_p)
        ] + [
            (f"state.{pn}.{f}", a, b)
            for pn, pk, pp in zip(st_k._fields, st_k, st_p)
            for f, a, b in zip(pk._fields, pk, pp)
        ]
        for label, a, b in pairs:
            err = compare(a, b)
            if err is not None:
                mismatches.append(f"step {k}: {label}")
                max_err = max(max_err, err)
        statuses.append(v_k.status)
    return max_err, mismatches, st_k, statuses, reached


def kernel_args(config: EngineConfig, table, state: EngineState,
                batch: RequestBatch, now: int, uniform: bool) -> tuple:
    """Step ``state`` once through the kernel's route and return the
    arguments it handed :func:`decide_rows` (to time the kernel and its
    plain version on the same inputs)."""
    seen = {}

    def grab(*args):
        seen["args"] = args
        return decide_cuda.decide_rows_plain(*args)

    with mock.patch.object(decide_cuda, "decide_rows", grab):
        decide_cuda.decide_core_kernel(config, state, table, batch, now,
                                       grouped=True, uniform=uniform)
    return seen["args"]
