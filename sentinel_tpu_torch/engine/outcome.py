"""Completion-outcome step: the device half of the outcome plane (port of
``sentinel_tpu/engine/outcome.py``).

Clients report ``(flow, rt_ms, exception)`` completions in batches; the
token service funnels each validated batch through the step built here. One
step rolls the per-flow ``state.outcome`` window ``[F, B, 16]`` once and
scatter-adds into its current bucket:

- ``RT_SUM``     += rt_ms
- ``COMPLETE``   += 1
- ``EXCEPTION``  += exception
- ``SLOW``       += rt_ms > the flow's breaker cutoff (breakers loaded only)
- ``RT_HIST0+b`` += 1, ``b = clip(floor(log2(rt + 1)), 0, NB - 1)``

With breakers loaded it also resolves HALF_OPEN probes: the first report of
a flow whose breaker holds a live probe ticket closes the breaker (a fast,
non-exception completion) or sends it back to OPEN.

Differences from the JAX module:

- **In place.** The reference donates the state; here the step writes the
  ``outcome`` and ``breaker`` tensors in place and returns the same state.
- **Masked rows, not dropped indices.** The reference routes invalid rows to
  row ``max_flows`` and lets ``mode="drop"`` discard them. Here they keep
  their index and add 0 (``stats.window``'s masked scatters), which CUDA's
  ``index_add_`` accepts.
- **One scatter.** The reference's two scatters (the row channels, then the
  histogram cell, whose second roll is a no-op) are one ``index_add_`` over
  ``K x (3 or 4 + 1)`` targets after a single roll. Integer adds give the
  same sums in any order, so duplicate slots and atomics are exact.
- **No cond.** The reference's ``lax.cond(any(live), ...)`` around probe
  resolution becomes unconditional compute plus masks: with no live row
  nothing is written, bit for bit the off arm, and no device-to-host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.prefix import segment_prefix_builder
from sentinel_tpu_torch.engine.rules import DegradeStrategy
from sentinel_tpu_torch.engine.state import (
    BR_CLOSED,
    BR_HALF_OPEN,
    BR_OPEN,
    BreakerState,
    EngineState,
    N_RT_BUCKETS,
    OutcomeChannel,
    flow_spec,
)
from sentinel_tpu_torch.stats import window as W
from sentinel_tpu_torch.stats.window import NEVER


def rt_bucket(rt_ms: torch.Tensor) -> torch.Tensor:
    """Log2 histogram cell of an RT in ms, ``clip(floor(log2(rt+1)), 0,
    NB-1)``, with the reference's integer bit-length semantics: the count of
    powers ``2^1 .. 2^(NB-1)`` that ``max(rt, 0) + 1`` reaches (int32, so
    ``rt = 2^31 - 1`` wraps to a negative and lands in cell 0, as it does in
    the reference). Counting only up to ``2^(NB-1)`` is the reference's
    count over ``2^1 .. 2^30`` clipped to ``NB - 1``. ``r >= 2^k`` is
    tested as ``r >> k > 0`` against an ``arange`` made on the device (a
    constant copied from the host would wait for the stream to drain)."""
    rt = torch.as_tensor(rt_ms).to(torch.int32)
    r = torch.clamp_min(rt, 0) + 1
    shifts = torch.arange(1, N_RT_BUCKETS, dtype=torch.int32,
                          device=r.device)
    return torch.sum((r[:, None] >> shifts[None, :]) > 0, dim=1,
                     dtype=torch.int32)


def _gather_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Row ids as ``jnp`` gathers read them: negatives in ``[-n, 0)`` wrap,
    then every id is clamped into ``[0, n)``."""
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + n, ids)
    return torch.clamp(ids, 0, n - 1)


def _resolve_probes(
    br: BreakerState,
    br_strategy: torch.Tensor,  # int8 [F] rule column
    br_slow_rt_ms: torch.Tensor,  # int32 [F]
    gslot: torch.Tensor,  # int32 [K] slots, 0 where invalid
    in_rng: torch.Tensor,  # bool [K] valid & slot in range
    rt_ms: torch.Tensor,  # int32 [K]
    exc: torch.Tensor,  # int32 [K]
    now: int,
) -> BreakerState:
    """HALF_OPEN probe resolution, in place: the first report (in batch
    order) of each flow whose breaker is HALF_OPEN with a live probe ticket
    decides it. Success (fast for SLOW_REQUEST_RATIO, no exception
    otherwise) closes the breaker with ``opened_ms = now`` (the stats
    fence); failure reopens it with a fresh recovery clock."""
    f = br.state.shape[0]
    g = _gather_rows(gslot, f)
    st = br.state[g].to(torch.int32)
    probe = br.probe_ms[g]
    live = in_rng & (st == BR_HALF_OPEN) & (probe != NEVER)
    # rank over the ungrouped report rows, as the reference builds it
    rank = segment_prefix_builder(gslot, "auto")(live.to(torch.float32))
    elected = live & (rank == 0.0)
    strat = br_strategy[g].to(torch.int32)
    fail = torch.where(
        strat == int(DegradeStrategy.SLOW_REQUEST_RATIO),
        rt_ms > br_slow_rt_ms[g],
        exc > 0,
    )
    # one elected row per slot, so no two writes to a slot conflict
    W.masked_set_(br.state, gslot, BR_OPEN, elected & fail)
    W.masked_set_(br.state, gslot, BR_CLOSED, elected & ~fail)
    W.masked_set_(br.opened_ms, gslot, int(now), elected)
    W.masked_set_(br.probe_ms, gslot, NEVER, elected)
    return br


def _outcome_core(
    config: EngineConfig,
    state: EngineState,
    slots: torch.Tensor,  # int32 [K] rule slots
    rt_ms: torch.Tensor,  # int32 [K] validated response times
    exc: torch.Tensor,  # int32 [K] 1 = exception, 0 = success
    valid: torch.Tensor,  # bool [K]
    now: int,
    br_strategy: Optional[torch.Tensor] = None,  # int8 [F], or None
    br_slow_rt_ms: Optional[torch.Tensor] = None,  # int32 [F], or None
) -> EngineState:
    spec = flow_spec(config)
    dev = state.outcome.counts.device
    slots = slots.to(device=dev, dtype=torch.int32)
    rt = rt_ms.to(device=dev, dtype=torch.int32)
    exc = exc.to(device=dev, dtype=torch.int32)
    valid = valid.to(device=dev, dtype=torch.bool)
    k = slots.shape[0]
    ones = torch.ones((k,), dtype=torch.int32, device=dev)
    # the row channels are RT_SUM, COMPLETE, EXCEPTION (and SLOW): 0, 1, 2, 3
    cols = [rt, ones, exc]
    if br_strategy is not None:
        # SLOW: counted at report time against the flow's DegradeRule cutoff
        # (slots without a breaker carry NO_SLOW_RT_MS, so never count)
        f = br_strategy.shape[0]
        gslot = torch.where(valid, slots, 0)
        in_rng = valid & (slots >= 0) & (slots < f)
        cols.append((rt > br_slow_rt_ms[_gather_rows(gslot, f)]).to(
            torch.int32))
    cols.append(ones)  # the histogram cell
    n_cols = len(cols)
    chan = torch.arange(n_cols - 1, dtype=torch.int32, device=dev)
    chan_ids = torch.cat([
        chan[None, :].expand(k, n_cols - 1),
        (int(OutcomeChannel.RT_HIST0) + rt_bucket(rt))[:, None],
    ], dim=1)
    values = torch.where(valid[:, None], torch.stack(cols, dim=1), 0)
    ws = W.roll(spec, state.outcome, now)
    idx, _ = W.bucket_index(spec, now)
    W._scatter_add_(ws.counts, slots[:, None].expand(k, n_cols).reshape(-1),
                    idx, chan_ids.reshape(-1), values.reshape(-1))
    if br_strategy is not None:
        _resolve_probes(state.breaker, br_strategy, br_slow_rt_ms, gslot,
                        in_rng, rt, exc, now)
    return state


def outcome_step_donating(config: EngineConfig):
    """The in-place step ``(state, slots, rt, exc, valid, now) -> state``
    (the port of the reference's donated jit). Callers must not hold another
    reference they expect unchanged.

    With breakers loaded the caller also passes the ``br_strategy`` /
    ``br_slow_rt_ms`` rule columns (the 8-argument form), which turns on the
    SLOW channel and HALF_OPEN probe resolution; the 6-argument form leaves
    the breaker columns alone."""

    def step(state, slots, rt_ms, exc, valid, now, br_strategy=None,
             br_slow_rt_ms=None):
        return _outcome_core(config, state, torch.as_tensor(slots),
                             torch.as_tensor(rt_ms), torch.as_tensor(exc),
                             torch.as_tensor(valid), int(now), br_strategy,
                             br_slow_rt_ms)

    return step
