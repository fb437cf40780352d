"""Device-resident circuit breaking: the breaker gate (port of
``sentinel_tpu/engine/degrade.py::breaker_gate``).

CLOSED → OPEN on a fenced outcome window crossing its threshold; OPEN →
HALF_OPEN after ``recovery_timeout_ms``, electing the first row of the flow
in batch order as the probe; a probe whose report never came re-arms after
another recovery timeout. HALF_OPEN → CLOSED/OPEN is decided by the outcome
step (``engine/outcome.py``), from the probe's completion report.

The reference gates the arm behind a ``lax.cond`` on "any breaker row in the
batch"; here it always runs. With no breaker row every mask is False, so the
outputs equal the gated-off arm bit for bit, and no device-to-host sync is
needed. A table with ``None`` br_* columns (no degrade rules) skips the arm
outright, as in the reference.
"""

from __future__ import annotations

import torch

from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.rules import DegradeStrategy, RuleTable
from sentinel_tpu_torch.engine.state import (
    BR_CLOSED,
    BR_HALF_OPEN,
    BR_OPEN,
    EngineState,
    OutcomeChannel,
)
from sentinel_tpu_torch.stats.window import NEVER, masked_set_


def breaker_gate(
    config: EngineConfig,
    spec,
    state: EngineState,
    rules: RuleTable,
    now: int,
    safe_slot: torch.Tensor,  # int32 [N] clamped local slots
    active: torch.Tensor,  # bool [N] — ns-admitted owned rows
    flow_prefix,  # same-flow exclusive prefix closure over batch order
) -> tuple:
    """Evaluate breaker transitions for one batch; returns
    ``(degraded, retry_ms, breaker)``. The breaker columns are updated in
    place. ``degraded`` rows must be stripped from ``active`` before
    admission and answer DEGRADED with ``retry_ms`` in ``remaining``."""
    n = safe_slot.shape[0]
    dev = safe_slot.device
    if rules.br_strategy is None:
        return (
            torch.zeros((n,), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            state.breaker,
        )
    now = int(now)
    slot = safe_slot.to(torch.int64)
    strat = rules.br_strategy[slot].to(torch.int32)
    br_rows = active & (strat >= 0)

    br = state.breaker
    st = br.state[slot].to(torch.int32)
    opened = br.opened_ms[slot]
    probe = br.probe_ms[slot]
    thr = rules.br_threshold[slot]
    minreq = rules.br_min_request[slot]
    stat_ms = rules.br_stat_ms[slot]
    rec_ms = rules.br_recovery_ms[slot]

    # fenced stat window: buckets alive in the sliding window AND not older
    # than the stat interval or the last transition
    lo = torch.maximum(now - stat_ms, opened)  # [N]
    starts = state.outcome.starts  # [B]
    age = now - starts
    bvalid = (age >= 0) & (age < spec.interval_ms)
    inc = (bvalid[None, :] & (starts[None, :] >= lo[:, None])).to(
        torch.float32
    )  # [N, B]
    counts = state.outcome.counts[slot]  # [N, B, C]
    inc_i = inc.to(counts.dtype)

    def chan_sum(ch):
        return torch.sum(counts[:, :, int(ch)] * inc_i, dim=1,
                         dtype=counts.dtype)

    total_i = chan_sum(OutcomeChannel.COMPLETE)
    errs = chan_sum(OutcomeChannel.EXCEPTION).to(torch.float32)
    slows = chan_sum(OutcomeChannel.SLOW).to(torch.float32)
    denom = torch.clamp_min(total_i.to(torch.float32), 1.0)
    metric = torch.where(
        strat == int(DegradeStrategy.SLOW_REQUEST_RATIO),
        slows / denom,
        torch.where(
            strat == int(DegradeStrategy.ERROR_RATIO), errs / denom, errs
        ),
    )
    # strict > like the reference; gated on minRequestAmount
    crossing = (total_i >= minreq) & (metric > thr)

    is_closed = st == BR_CLOSED
    is_open = st == BR_OPEN
    is_half = st == BR_HALF_OPEN
    just_open = br_rows & is_closed & crossing
    open_elapsed = is_open & ((now - opened) >= rec_ms)
    probe_stale = is_half & ((now - probe) >= rec_ms)
    electable = br_rows & (open_elapsed | probe_stale)
    # HALF_OPEN probe election: first electable row of the flow wins
    rank = flow_prefix(electable.to(torch.float32))
    is_probe = electable & (rank == 0.0)

    degraded = br_rows & (
        just_open
        | (is_open & ~open_elapsed)
        | (is_half & ~probe_stale)
        | (electable & ~is_probe)
    )
    retry = torch.where(
        just_open | (electable & ~is_probe),
        rec_ms,
        torch.where(
            is_open & ~open_elapsed,
            opened + rec_ms - now,
            probe + rec_ms - now,  # HALF_OPEN with a live probe
        ),
    )
    retry_ms = torch.where(
        degraded, torch.clamp_min(retry, 0), 0
    ).to(torch.int32)

    # transition scatters: values are flow-uniform, so rows of one flow
    # write identical values
    masked_set_(br.state, slot, BR_OPEN, just_open)
    masked_set_(br.state, slot, BR_HALF_OPEN, electable)
    masked_set_(br.opened_ms, slot, now, just_open)
    masked_set_(br.probe_ms, slot, NEVER, just_open)
    masked_set_(br.probe_ms, slot, now, electable)
    return degraded, retry_ms, br
