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

:func:`prefix_key_shapes` gives the key vectors the segment-prefix kernels
are held on.

:func:`adversarial_batches` builds grouped batches by their segment heads,
shaped to break a kernel whose blocks each own the segments that start in a
nominal range of ``chunk`` rows (``decide_cuda.launch_grid``): heads exactly
at, one before and one after the range bounds, ranges with no head, a
segment longer than a 1024-row tile and one longer than the range, one flow
for the whole batch, a flow per row, rows without a rule beside real slot-0
rows, and a padded tail (which also maps onto slot 0). :func:`shape_coverage`
reports which of :data:`SHAPE_COVERAGE` a batch reaches. With ``repeats``,
:func:`check_steps` launches the kernel that many times from each step's
input state and holds every repeat bitwise to the first, so that a race
between blocks shows.
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


# the key vectors the segment-prefix kernels are held on (prefix_key_shapes)
PREFIX_KEY_SHAPES = ("zipf", "one_key", "distinct", "low8_equal",
                     "low16_equal", "extremes")
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def prefix_key_shapes(rng: np.random.Generator, n: int) -> dict:
    """``{shape: [n] int32 keys}``, batch order unsorted: bounded-Zipf flow
    ids; one key for every row; a key per row; keys that agree in their low
    8 bits, or low 16 bits, and differ only above (one radix digit groups
    nothing); and negative keys with ``INT32_MIN`` and ``INT32_MAX``."""
    groups = max(2, n // 4)
    hi = rng.integers(0, groups, size=n).astype(np.int64)
    extremes = np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX - 1,
                         INT32_MAX], np.int64)
    mixed = np.where(rng.random(n) < 0.5, rng.choice(extremes, size=n),
                     rng.integers(INT32_MIN, 0, size=n))
    shapes = {
        "zipf": ZipfIds(4096)(rng, n),
        "one_key": np.full(n, 7),
        "distinct": rng.permutation(n),
        "low8_equal": (hi << 8) | 0xA5,
        "low16_equal": ((hi << 16) | 0xBEEF) - 2**31,
        "extremes": mixed,
    }
    return {k: v.astype(np.int32) for k, v in shapes.items()}


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


TILE_ROWS = 1024  # the widest tile the decide kernel is built for
SHAPE_COVERAGE = (
    "segment_over_tile", "segment_over_chunk", "head_at_bound",
    "head_before_bound", "head_after_bound", "empty_block", "one_flow",
    "all_distinct", "no_rule_beside_slot0", "padded_tail",
)


def required_shapes(n: int) -> set:
    """The :data:`SHAPE_COVERAGE` items a batch size of ``n`` can reach."""
    need = set(SHAPE_COVERAGE)
    if n <= TILE_ROWS:
        need.discard("segment_over_tile")
    return need


def batch_from_heads(config: EngineConfig, rng: np.random.Generator,
                     heads: np.ndarray, uniform: bool, n_flows: int,
                     no_rule: int = 0) -> RequestBatch:
    """A grouped batch whose segment heads are the true entries of
    ``heads`` (row 0 is always one), padded to ``config.batch_size``. Flow
    ids are drawn sorted and distinct from the first ``2 * len(heads)`` ids,
    so that successive batches meet the same flows; with ``no_rule`` the
    first segment is flow 0 and its first ``no_rule`` rows carry slot -1."""
    n = heads.size
    heads = heads.copy()
    heads[0] = True
    seg = np.cumsum(heads) - 1
    k = int(seg[-1]) + 1
    universe = min(n_flows, 2 * n)
    if k > universe:
        raise ValueError(f"{k} segments over {universe} flows")
    ids = np.sort(rng.choice(universe, size=k, replace=False))
    if no_rule:
        if ids[0] != 0:
            ids[0] = 0
        if no_rule >= int((seg == 0).sum()):
            raise ValueError("no real slot-0 row beside the rows without "
                             "a rule")
    slots = ids[seg].astype(np.int32)
    slots[:no_rule] = -1
    acq = (np.ones(n, np.int32) if uniform
           else rng.integers(1, 4, size=n).astype(np.int32))
    prio = rng.random(n) < 0.1
    return make_batch(config, slots, acq, prio)


def adversarial_batches(config: EngineConfig, rng: np.random.Generator,
                        chunk: int, uniform: bool, n_flows: int):
    """``[(name, batch)]``, one batch per entry of :data:`STEP_OFFSETS_MS`,
    each ``config.batch_size`` rows shaped against blocks of ``chunk``
    nominal rows."""
    N = config.batch_size

    def bounds(p_head, shift):
        heads = rng.random(N) < p_head
        for k in range(1, -(-N // chunk)):
            at = k * chunk
            heads[at - 1:at + 2] = False
            if (k + shift) % 4 == 3:
                # no head in the whole nominal range of block k
                heads[at:at + chunk] = False
            else:
                heads[min(at + (0, -1, 1)[(k + shift) % 4], N - 1)] = True
        return heads

    def long_segments():
        heads = rng.random(N) < 0.5
        a = chunk // 2
        b = a + min(TILE_ROWS + 476, N // 2)
        c = b + min(chunk + 7, N // 4)
        heads[a:c] = False
        heads[[a, b, min(c, N - 1)]] = True
        return heads

    one_flow = np.zeros(N, bool)
    distinct = np.ones(N, bool)
    if N > n_flows:
        raise ValueError(f"{N} distinct flows of {n_flows}")
    mixed = rng.random(N - max(1, N // 8)) < 0.2
    mixed[1:6] = False  # slot 0's segment holds 6 rows or more
    cases = [
        ("chunk_bounds", bounds(0.3, 0), 0),
        ("long_segments", long_segments(), 0),
        ("one_flow", one_flow, 0),
        ("all_distinct", distinct, 0),
        ("no_rule_and_padding", mixed, 3),
        ("chunk_bounds_sparse", bounds(0.02, 1), 0),
    ]
    if len(cases) != len(STEP_OFFSETS_MS):
        raise AssertionError("one adversarial batch per step")
    return [(name, batch_from_heads(config, rng, heads, uniform, n_flows,
                                    no_rule))
            for name, heads, no_rule in cases]


def shape_coverage(config: EngineConfig, batch: RequestBatch, chunk: int,
                   n_flows: int) -> set:
    """Which of :data:`SHAPE_COVERAGE` one batch reaches, as the kernel sees
    it: segments are runs of equal safe slot (out-of-range slots read 0)."""
    slot = np.asarray(batch.flow_slot)
    valid = np.asarray(batch.valid)
    N = slot.size
    in_range = (slot >= 0) & (slot < n_flows)
    safe = np.where(in_range, slot, 0)
    heads = np.concatenate([[True], safe[1:] != safe[:-1]])
    at = np.nonzero(heads)[0]
    lengths = np.diff(np.concatenate([at, [N]]))
    reached = set()
    if (lengths > TILE_ROWS).any():
        reached.add("segment_over_tile")
    if (lengths > chunk).any():
        reached.add("segment_over_chunk")
    for k in range(1, -(-N // chunk)):
        b = k * chunk
        if heads[b]:
            reached.add("head_at_bound")
        elif heads[b - 1]:
            reached.add("head_before_bound")
        elif b + 1 < N and heads[b + 1]:
            reached.add("head_after_bound")
        if not heads[b:b + chunk].any():
            reached.add("empty_block")
    if at.size == 1:
        reached.add("one_flow")
    if at.size == N:
        reached.add("all_distinct")
    if ((slot[:-1] == -1) & valid[:-1] & (slot[1:] == 0) & valid[1:]).any():
        reached.add("no_rule_beside_slot0")
    if not valid[-1] and (valid & (slot == 0)).any():
        reached.add("padded_tail")
    return reached


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
                batches, nows, uniform: bool, repeats: int = 1):
    """Step the kernel and its plain version over ``batches`` at ``nows``
    from two copies of ``state``. Returns ``(max_abs_err, mismatches,
    kernel_state, statuses, reached)``: mismatches lists ``"step k: field"``
    labels, statuses the kernel side's verdict statuses of every step,
    reached the :data:`COVERAGE` items some step reached. With ``repeats``
    above 1 the kernel is launched that many times from each step's input
    state, and a repeat that differs in any bit is a mismatch."""
    st_k, st_p = clone_state(state), clone_state(state)
    mismatches, max_err, statuses, reached = [], 0.0, [], set()
    for k, (batch, now) in enumerate(zip(batches, nows)):
        reached |= ring_coverage(config, st_p, batch, now)
        seen = {}
        kernel, plain = decide_cuda.decide_rows, decide_cuda.decide_rows_plain

        def kern(cfg, flow, occ, fstarts, *rest, k=k):
            before = (flow.clone(), fstarts.clone()) if repeats > 1 else None
            first = seen["kernel"] = kernel(cfg, flow, occ, fstarts, *rest)
            for rep in range(1, repeats):
                flow_r, fstarts_r = before[0].clone(), before[1].clone()
                again = kernel(cfg, flow_r, occ, fstarts_r, *rest)
                differ = [f for f, a, b in zip(first._fields, again, first)
                          if not torch.equal(a, b)]
                differ += [f for f, a, b in (("flow", flow_r, flow),
                                             ("fstarts", fstarts_r, fstarts))
                           if not torch.equal(a, b)]
                if differ:
                    mismatches.append(
                        f"step {k}: repeat {rep} differs in {differ}")
            return first

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
