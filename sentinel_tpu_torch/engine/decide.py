"""The batched token-verdict step (port of ``sentinel_tpu/engine/decide.py``).

One call decides a micro-batch of token requests against the engine state:

1. **Namespace guard** — ``GlobalRequestLimiter.tryPass`` as a windowed
   request counter per namespace.
2. **Circuit breakers** — DEGRADED rows are shed before admission.
3. **Threshold** — ``count × (GLOBAL ? 1 : connectedCount) × exceedCount``,
   bent by the warmup curve for WARM_UP rules.
4. **Admission** — window PASS (+ matured borrows + LEASED) plus the in-batch
   prefix of earlier admitted same-flow tokens; odd refinement passes, or
   the closed form when every row acquires the same count.
5. **Pacing** — RATE_LIMITER rows as a batch closed form.
6. **Priority occupy** — blocked prioritized rows borrow the next window.

Port notes:

- The state is updated **in place**: JAX's buffer donation
  (``decide_donating``) becomes writes into the state tensors. ``decide``
  copies the state first and so keeps the reference's pure signature.
- ``now`` is a host ``int``.
- Every ``lax.cond`` of the reference becomes unconditional compute (plus
  a select on the same predicate where the arms differ). The gated-off arms
  coincide with what the unconditional compute yields, so results stay
  bit-identical, and the step never waits on the device.
- Mesh sharding: the reference's ``axis_name`` becomes ``axis``, a
  :class:`ShardAxis` (the shard's rank, the mesh size, its ``psum`` and
  ``pmax``, and where its rows stand in the batch).
  ``parallel/sharding.py`` runs this core once per shard, on the rows whose
  flow the shard owns and no others; ``axis=None`` is the single-shard
  step, where every hook is the identity.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.degrade import breaker_gate as _breaker_gate
from sentinel_tpu_torch.engine.prefix import (
    segment_prefix_builder as _segment_prefix_builder,
)
from sentinel_tpu_torch.engine.rules import RuleTable, ThresholdMode
from sentinel_tpu_torch.engine.state import (
    ClusterEvent,
    EngineState,
    clone_state,
    flow_spec,
)
from sentinel_tpu_torch.stats import window as W


class TokenStatus(enum.IntEnum):
    """Verdict statuses (``TokenResultStatus.java`` names). OVERLOAD,
    STANDBY, MOVED and NOT_LEASABLE are answered by the service layers the
    reference has beside the decide step; the step itself never emits
    them."""

    OK = 0
    BLOCKED = 1
    SHOULD_WAIT = 2
    NO_RULE_EXISTS = 3
    TOO_MANY_REQUEST = 4
    FAIL = 5
    RELEASE_OK = 6
    ALREADY_RELEASE = 7
    OVERLOAD = 8
    STANDBY = 9
    MOVED = 10
    NOT_LEASABLE = 11
    DEGRADED = 12


class RequestBatch(NamedTuple):
    flow_slot: object  # int32 [N]; -1 → NO_RULE
    acquire: object  # int32 [N]
    prioritized: object  # bool [N]
    valid: object  # bool [N] — padding mask


class VerdictBatch(NamedTuple):
    status: torch.Tensor  # int8 [N]
    wait_ms: torch.Tensor  # int32 [N]
    remaining: torch.Tensor  # int32 [N]


class ShardAxis(NamedTuple):
    """One shard's view of the flow mesh axis (the reference's
    ``axis_index`` / ``psum`` / ``pmax`` over ``axis_name``). ``psum`` and
    ``pmax`` take this shard's tensor and return the reduction over every
    shard, on this shard's device.

    Under an axis the core is given only the rows whose flow this shard
    owns, in batch order. The owned rows of the whole batch fall into
    ``n_runs`` runs, maximal stretches of one owner; ``runs`` (int64, on
    the shard's device) numbers the run of each of this shard's rows. The
    namespace guard counts the other shards' earlier rows by run."""

    rank: int
    size: int
    psum: Callable[[torch.Tensor], torch.Tensor]
    pmax: Callable[[torch.Tensor], torch.Tensor]
    runs: Optional[torch.Tensor] = None
    n_runs: int = 0


def _identity(x):
    return x


def shard_slots(flow_slot: torch.Tensor, f_local: int,
                axis: Optional[ShardAxis]):
    """``(in_range, safe_slot)`` of global slots for the shard that owns
    rows ``[rank * f_local, (rank + 1) * f_local)``; rows of no rule and of
    padding are out of range and read local row 0."""
    if axis is None:
        in_range = (flow_slot >= 0) & (flow_slot < f_local)
        return in_range, torch.where(in_range, flow_slot, 0)
    local = flow_slot - axis.rank * f_local
    in_range = (flow_slot >= 0) & (local >= 0) & (local < f_local)
    return in_range, torch.where(in_range, local, 0)


def rule_presence(batch, owned: torch.Tensor):
    """``(live, no_rule)``: valid rows whose flow has a rule, and valid rows
    with none. On a mesh the one shard whose range holds a row's slot is the
    only one that can own it, so its own answer is the reference's psum of
    ownership."""
    return batch.valid & owned, batch.valid & ~owned


def make_batch(
    config: EngineConfig,
    flow_slots: Sequence[int],
    acquires: Optional[Sequence[int]] = None,
    prioritized: Optional[Sequence[bool]] = None,
) -> RequestBatch:
    """Pad host request lists to the static batch size (numpy leaves; the
    step moves them to the state's device)."""
    n = len(flow_slots)
    N = config.batch_size
    if n > N:
        raise ValueError(f"batch of {n} exceeds configured size {N}")
    slot = np.full(N, -1, dtype=np.int32)
    acq = np.zeros(N, dtype=np.int32)
    prio = np.zeros(N, dtype=bool)
    valid = np.zeros(N, dtype=bool)
    slot[:n] = np.asarray(flow_slots, dtype=np.int32)
    acq[:n] = np.asarray(acquires, dtype=np.int32) if acquires is not None else 1
    if prioritized is not None:
        prio[:n] = np.asarray(prioritized, dtype=bool)
    valid[:n] = True
    return RequestBatch(
        flow_slot=slot, acquire=acq, prioritized=prio, valid=valid
    )


def alloc_fused_batch(config: EngineConfig, depth: int) -> RequestBatch:
    """One ``[depth, batch_size]`` stacked-frame staging block for
    :func:`decide_fused_donating`."""
    N = config.batch_size
    return RequestBatch(
        flow_slot=np.empty((depth, N), np.int32),
        acquire=np.empty((depth, N), np.int32),
        prioritized=np.empty((depth, N), bool),
        valid=np.empty((depth, N), bool),
    )


def make_batch_into(
    out: RequestBatch,
    row: int,
    flow_slots,
    acquires=None,
    prioritized=None,
) -> None:
    """:func:`make_batch` writing into row ``row`` of a stacked staging
    block, with identical padding semantics."""
    N = out.flow_slot.shape[-1]
    n = len(flow_slots)
    if n > N:
        raise ValueError(f"batch of {n} exceeds configured size {N}")
    slot, acq, prio, valid = (
        out.flow_slot[row], out.acquire[row], out.prioritized[row],
        out.valid[row],
    )
    slot[:n] = flow_slots
    slot[n:] = -1
    acq[:n] = 1 if acquires is None else acquires
    acq[n:] = 0
    prio[:n] = False if prioritized is None else prioritized
    prio[n:] = False
    valid[:n] = True
    valid[n:] = False


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device``. To a card the copy goes through a pinned staging
    buffer and does not wait for the stream (a copy from pageable memory
    would); PyTorch's pinned allocator keeps the buffer until the copy has
    run, so the caller may reuse ``a`` at once."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def batch_to(batch: RequestBatch, device) -> RequestBatch:
    """Move a batch's leaves (numpy or tensors) to ``device`` with the
    reference's dtypes."""
    dtypes = (torch.int32, torch.int32, torch.bool, torch.bool)
    return RequestBatch(*(
        (leaf.to(device) if isinstance(leaf, torch.Tensor)
         else host_to_device(np.asarray(leaf), device)).to(dt)
        for leaf, dt in zip(batch, dtypes)
    ))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Correctly rounded float32 ``a * b + c`` (one rounding), on any device.

    In float64 the product is exact and TwoSum gives the exact error ``e``
    of the rounded sum ``s``; forcing ``s`` odd when ``e != 0`` (round to
    odd) makes the final rounding to float32 correct.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf"))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _warmup_curve(
    spec,
    now,
    passed,
    cnt,
    cnt_safe,
    warn,
    max_token,
    slope,
    cold_count,
    filled,
    tokens,
    warm_rows,
):
    """WARM_UP lazy token sync + slope curve on gathered ``[N]`` columns.

    The op sequence is the reference's as XLA compiles it (see the two
    comments below): it is the parity contract with the JAX package and
    with the CUDA kernel. Rows
    outside ``warm_rows`` come back with ``qps = cnt`` and
    ``do_sync = False``. Returns ``(qps, tokens_new, do_sync, cur_sec)``.
    """
    pass_qps = passed * (1000.0 / spec.interval_ms)
    cur_sec = now - now % 1000
    can_refill = (tokens < warn) | ((tokens > warn) & (pass_qps < cold_count))
    elapsed = (cur_sec - filled).to(torch.float32)
    # the reference writes `elapsed * cnt_safe / 1000.0`; XLA rewrites a
    # division by a constant into a multiply by its float32 reciprocal
    cooled = torch.minimum(
        tokens + torch.where(can_refill, elapsed * cnt_safe * 0.001, 0.0),
        max_token,
    )
    synced = torch.clamp_min(cooled - pass_qps, 0.0)
    do_sync = warm_rows & (cur_sec > filled)
    tokens_new = torch.where(do_sync, synced, tokens)
    above = torch.clamp_min(tokens_new - warn, 0.0)
    # `above * slope + 1.0 / cnt_safe`, which XLA contracts into one fused
    # multiply-add
    warning_qps = 1.0 / fma_f32(above, slope, 1.0 / cnt_safe)
    qps = torch.where(warm_rows & (tokens_new >= warn), warning_qps, cnt)
    return qps, tokens_new, do_sync, cur_sec


def _occupy_feasible(
    config,
    try_occupy,
    passed,
    expiring,
    admitted_prefix,
    waiting,
    occ_prefix,
    acquire_f,
    threshold,
):
    """The priority-occupy headroom check (``ClusterFlowChecker.canOccupy``)
    on gathered ``[N]`` columns."""
    return try_occupy & (
        passed - expiring + admitted_prefix + waiting + occ_prefix + acquire_f
        <= config.max_occupy_ratio * threshold
    )


def _ns_guard(config, spec, ns_state, rules, now, owned, safe_slot, live,
              axis: Optional[ShardAxis] = None):
    """Namespace guard (request-count qps, ``GlobalRequestLimiter``).

    Returns ``(ns_id, ns_ok, seg_ns_sum)``. The reference picks the precise
    arm (an ``[N, NS]`` one-hot cumsum) behind a ``lax.cond`` on "some
    namespace crosses its budget inside this batch"; here both arms run and
    the same predicate selects.

    On a mesh (``axis``) the shard has only its own rows. Each shard counts
    its live rows by run and namespace, one psum gives every shard those
    ``[n_runs, NS]`` counts, and a row's precise prefix is its own shard's
    earlier rows plus the other shards' rows of earlier runs: the
    reference's batch-wide prefix, whose terms are whole numbers, so the
    sums agree bitwise. ``seg_ns_sum`` then sums over every shard (a psum),
    so the replicated namespace window is updated identically everywhere."""
    slot = safe_slot.to(torch.int64)
    ns_id = torch.where(owned, rules.namespace_id[slot], 0).to(torch.int64)
    live_f = live.to(torch.float32)
    NS = config.max_namespaces
    psum = _identity if axis is None else axis.psum

    def seg_ns_sum(vals):
        out = torch.zeros((NS,), dtype=torch.float32, device=vals.device)
        return psum(out.index_add_(0, ns_id, vals.to(torch.float32)))

    # the reference's [N, NS] one-hot cumsum over the batch axis, laid out
    # [NS, N] so the scan runs along the contiguous axis (a batch-axis scan
    # of [16384, 64] is a slow outer-dimension scan on the GPU)
    one_hot_t = (
        torch.arange(NS, device=slot.device)[:, None] == ns_id[None, :]
    ).to(torch.float32)
    ns_incl = torch.cumsum(one_hot_t * live_f[None, :], dim=1)
    ns_prefix = torch.gather(ns_incl, 0, ns_id[None, :])[0] - live_f
    if axis is None:
        ns_live_tot = seg_ns_sum(live_f)
    else:
        cell = axis.runs * NS + ns_id
        mine = torch.zeros((axis.n_runs * NS,), dtype=torch.float32,
                           device=slot.device).index_add_(0, cell, live_f)
        every = axis.psum(mine)
        ns_live_tot = every.view(axis.n_runs, NS).sum(dim=0)
        others = (every - mine).view(axis.n_runs, NS)
        before = (torch.cumsum(others, dim=0) - others).view(-1)
        ns_prefix = ns_prefix + before[cell]

    ns_ids_dense = torch.arange(NS, dtype=torch.int32, device=slot.device)
    ns_already_dense = W.window_sum_at(
        spec, ns_state, now, 0, ns_ids_dense
    ).to(torch.float32)
    ns_budget_dense = rules.ns_max_qps * (spec.interval_ms / 1000.0)
    crossing = (
        (ns_live_tot > 0)
        & (ns_already_dense + ns_live_tot > ns_budget_dense)
        & (ns_already_dense + 1.0 <= ns_budget_dense)
    )
    ok_precise = (
        ns_already_dense[ns_id] + ns_prefix + 1.0
    ) <= ns_budget_dense[ns_id]
    ok_fast = ((ns_already_dense + 1.0) <= ns_budget_dense)[ns_id]
    ns_ok = torch.where(torch.any(crossing), ok_precise, ok_fast)
    return ns_id, ns_ok, seg_ns_sum


def _decide_core(
    config: EngineConfig,
    state: EngineState,
    rules: RuleTable,
    batch: RequestBatch,
    now: int,
    grouped: bool = False,
    uniform: bool = False,
    axis: Optional[ShardAxis] = None,
) -> tuple:
    """The decision pipeline in torch ops; updates ``state`` in place and
    returns ``(state, verdicts)``.

    ``grouped``: same-flow requests are contiguous in the batch (the host
    batcher sorted them), so the segment prefix needs no device sort.
    ``uniform``: all live requests acquire the same count, so greedy
    admission has a one-pass closed form.
    ``axis``: this shard of a flow mesh. The shard owns the flow rows of
    ``state`` and ``rules`` (global slots ``rank * f_local`` on), and
    ``batch`` holds only the rows whose flow it owns (possibly none). Its
    verdicts are those rows' verdicts; the psums give the namespace guard
    the other shards' rows, and a pmax keeps the replicated occupy
    ``starts`` equal on every shard.
    """
    spec = flow_spec(config)
    now = int(now)
    dev = state.flow.counts.device
    batch = batch_to(batch, dev)
    N = batch.valid.shape[0]
    f_local = rules.valid.shape[0]

    in_range, safe_slot = shard_slots(batch.flow_slot, f_local, axis)
    slot = safe_slot.to(torch.int64)
    owned = in_range & rules.valid[slot]
    live, no_rule = rule_presence(batch, owned)

    acquire_f = batch.acquire.to(torch.float32)

    ns_id, ns_ok, seg_ns_sum = _ns_guard(
        config, spec, state.ns, rules, now, owned, safe_slot, live, axis
    )
    too_many = live & ~ns_ok
    ns_admitted = live & ns_ok
    active = ns_admitted & owned

    if config.prefix_impl == "grouped":
        raise ValueError(
            "prefix_impl='grouped' is not a config value; pass grouped=True "
            "to decide() from a batcher that groups same-flow requests"
        )
    flow_prefix = _segment_prefix_builder(
        safe_slot, "grouped" if grouped else config.prefix_impl
    )

    # 1b. circuit breakers: DEGRADED rows write no flow-window events
    degraded, br_retry, breaker_ws = _breaker_gate(
        config, spec, state, rules, now, safe_slot, active, flow_prefix
    )
    active = active & ~degraded

    # 2. per-request threshold
    conn = rules.ns_connected[ns_id].to(torch.float32)
    factor = torch.where(
        rules.mode[slot] == int(ThresholdMode.AVG_LOCAL), conn, 1.0
    )

    passed = (
        W.window_sum_at(spec, state.flow, now, ClusterEvent.PASS, slot)
        + W.window_sum_at(spec, state.occupy, now, 0, slot)
        + W.window_sum_at(spec, state.flow, now, ClusterEvent.LEASED, slot)
    ).to(torch.float32)

    # 2b. traffic shaping
    beh = rules.behavior[slot].to(torch.int32)
    is_warm = (beh == 1) | (beh == 3)
    is_pace = (beh == 2) | (beh == 3)
    warm_rows = active & is_warm
    pace_try = active & is_pace
    active_window = active & ~is_pace

    cnt = rules.count[slot]
    cnt_safe = torch.clamp_min(cnt, 1e-6)

    qps, tokens_new, do_sync, cur_sec = _warmup_curve(
        spec, now, passed, cnt, cnt_safe,
        rules.warning_token[slot],
        rules.max_token[slot],
        rules.slope[slot],
        rules.cold_count[slot],
        state.shaping.warm_filled[slot],
        state.shaping.warm_tokens[slot],
        warm_rows,
    )

    rate_qps = qps * factor * config.exceed_count
    threshold = rate_qps * (spec.interval_ms / 1000.0)

    # 3. prefix-sum admission (odd refinement count ⇒ ⊆ sequential-exact)
    if uniform:
        a = uniform_acquire(live, batch.acquire)
        a_safe = torch.clamp_min(a, 1.0)
        rank = flow_prefix(active_window.to(torch.float32))
        admit = active_window & (passed + rank * a + a <= threshold)
        quota = torch.floor(torch.clamp_min(threshold - passed, 0.0) / a_safe)
        admitted_prefix = torch.minimum(rank, quota) * a
    else:
        iters = config.admission_refine_iters
        if iters % 2 == 0:
            raise ValueError(
                "admission_refine_iters must be odd: an odd iteration count "
                "makes the final admission mask a subset of the "
                "sequential-greedy set (no-overshoot guarantee)"
            )
        admit = active_window
        for _ in range(iters):
            contrib = torch.where(admit, acquire_f, 0.0)
            prefix = flow_prefix(contrib)
            admit = active_window & (passed + prefix + acquire_f <= threshold)
        admitted_prefix = flow_prefix(torch.where(admit, acquire_f, 0.0))

    # 3b. pacing (RateLimiterController.canPass as a batch closed form)
    cost_f = torch.round(1000.0 * acquire_f / torch.clamp_min(rate_qps, 1e-6))
    rel0 = torch.clamp_min(
        state.shaping.lpt[slot] - now, -(2**20)
    ).to(torch.float32)
    maxq = rules.max_queue_ms[slot].to(torch.float32)

    def pace_pass(accept):
        contrib = torch.where(accept, cost_f, 0.0)
        incl = flow_prefix(contrib) + cost_f
        rank_p = flow_prefix(accept.to(torch.float32))
        first = accept & (rank_p == 0.0)
        # the first accepted row's cost, broadcast to its flow: at most
        # one nonzero per slot, so an index_add of zeros elsewhere is exact
        c_first = torch.zeros((f_local,), dtype=torch.float32, device=dev)
        c_first.index_add_(0, slot, torch.where(first, cost_f, 0.0))
        return torch.maximum(rel0, -c_first[slot]) + incl

    accept = pace_try
    l_rel = pace_pass(accept)
    for _i in range(0 if uniform else config.admission_refine_iters):
        accept = pace_try & (l_rel <= maxq)
        l_rel = pace_pass(accept)
    accept = pace_try & (l_rel <= maxq)
    pace_wait = torch.clamp_min(l_rel, 0.0).to(torch.int32)
    lpt_sched = torch.round(l_rel).to(torch.int32) + now
    pace_admit = accept
    pace_now = pace_admit & (pace_wait == 0)
    pace_later = pace_admit & (pace_wait > 0)
    pace_reject = pace_try & ~pace_admit

    # 4. priority occupy of the next window
    blocked = active_window & ~admit
    wait_next = spec.bucket_ms - (now % spec.bucket_ms)
    try_occupy = blocked & batch.prioritized & (beh == 0)
    next_start = now + wait_next
    horizon = next_start - spec.interval_ms
    cur_valid = W.valid_mask(spec, state.flow, now)
    expiring_mask = cur_valid & (state.flow.starts <= horizon)
    pass_rows = state.flow.counts[slot, :, int(ClusterEvent.PASS)]  # [N, B]
    expiring = torch.sum(
        pass_rows * expiring_mask[None, :].to(pass_rows.dtype), dim=1,
        dtype=pass_rows.dtype,
    ).to(torch.float32)
    waiting = W.future_sum_at(spec, state.occupy, now, 0, slot).to(
        torch.float32
    )
    occ_prefix = flow_prefix(torch.where(try_occupy, acquire_f, 0.0))
    can_occupy = _occupy_feasible(
        config, try_occupy, passed, expiring, admitted_prefix, waiting,
        occ_prefix, acquire_f, threshold,
    )
    hard_block = blocked & ~can_occupy

    # ---- every read of the input state is done; the writes follow -------
    W.masked_set_(state.shaping.warm_tokens, slot, tokens_new, do_sync)
    W.masked_set_(state.shaping.warm_filled, slot, cur_sec, do_sync)
    W.masked_max_(state.shaping.lpt, slot, lpt_sched, accept)

    # 5. window updates
    admit_i = (admit | pace_now).to(torch.int32)
    hard_i = (hard_block | pace_reject).to(torch.int32)
    ev = ClusterEvent
    row_updates = torch.stack(
        [
            batch.acquire * admit_i,  # PASS
            admit_i,  # PASS_REQUEST
            batch.acquire * hard_i,  # BLOCK
            hard_i,  # BLOCK_REQUEST
            # prioritized traffic admitted normally (OCCUPIED_PASS)
            batch.acquire * (admit & batch.prioritized).to(torch.int32),
        ],
        dim=1,
    )
    W.add_event_rows(
        spec, state.flow, now, safe_slot, row_updates,
        channels=(ev.PASS, ev.PASS_REQUEST, ev.BLOCK, ev.BLOCK_REQUEST,
                  ev.OCCUPIED_PASS),
    )
    charge_wait = torch.where(
        can_occupy, torch.full((N,), wait_next, dtype=torch.int32,
                               device=dev), pace_wait
    )
    W.add_future(
        spec, state.occupy, now,
        wait_ms=charge_wait,
        resource_ids=safe_slot,
        channel_ids=torch.zeros((N,), dtype=torch.int64, device=dev),
        values=batch.acquire,
        valid=can_occupy | pace_later,
        combine_desired=None if axis is None else axis.pmax,
    )
    W.add_column(spec, state.ns, now, seg_ns_sum(ns_admitted))

    # 6. verdicts
    verdicts = _verdicts(
        batch, no_rule, too_many, degraded, admit, pace_now, can_occupy,
        pace_later, hard_block, pace_reject, wait_next, pace_wait,
        threshold, passed, admitted_prefix, acquire_f, br_retry,
    )
    return state._replace(breaker=breaker_ws), verdicts


def uniform_acquire(live: torch.Tensor, acquire: torch.Tensor):
    """The uniform form's ``a``: the largest live acquire, as float32 (0
    for no rows). On a mesh each shard takes it over its own rows; under
    the uniform contract every live row acquires the same count, so a shard
    with a live row finds the batch's value, and one without admits
    nothing whatever ``a`` is."""
    if acquire.shape[0] == 0:
        return torch.zeros((), dtype=torch.float32, device=acquire.device)
    return torch.max(torch.where(live, acquire, 0)).to(torch.float32)


def _verdicts(
    batch, no_rule, too_many, degraded, admit, pace_now, can_occupy,
    pace_later, hard_block, pace_reject, wait_next, pace_wait, threshold,
    passed, admitted_prefix, acquire_f, br_retry,
) -> VerdictBatch:
    """The verdicts of the step's rows, shared by both decide backends. A
    shard of a mesh answers only for its own rows; the rows no shard owns
    are answered by ``parallel/sharding.py``."""
    status_code = torch.where(
        degraded,
        int(TokenStatus.DEGRADED) + 1,
        torch.where(
            admit | pace_now,
            int(TokenStatus.OK) + 1,
            torch.where(
                can_occupy | pace_later,
                int(TokenStatus.SHOULD_WAIT) + 1,
                torch.where(
                    hard_block | pace_reject, int(TokenStatus.BLOCKED) + 1, 0
                ),
            ),
        ),
    ).to(torch.int32)
    status = torch.where(
        ~batch.valid,
        int(TokenStatus.FAIL),
        torch.where(
            no_rule,
            int(TokenStatus.NO_RULE_EXISTS),
            torch.where(
                too_many,
                int(TokenStatus.TOO_MANY_REQUEST),
                torch.where(status_code > 0, status_code - 1,
                            int(TokenStatus.FAIL)),
            ),
        ),
    ).to(torch.int8)
    wait_ms = torch.where(
        can_occupy, wait_next, torch.where(pace_later, pace_wait, 0)
    ).to(torch.int32)
    remaining_local = torch.clamp(
        threshold - passed - admitted_prefix
        - torch.where(admit, acquire_f, 0.0),
        0.0,
        2**30,
    ).to(torch.int32)
    # blocked and paced verdicts carry remaining=0; DEGRADED carries
    # retry-after-ms
    remaining = torch.where(
        admit, remaining_local, torch.where(degraded, br_retry, 0)
    ).to(torch.int32)
    return VerdictBatch(status=status, wait_ms=wait_ms, remaining=remaining)


def resolve_decide_impl(impl: str, device) -> str:
    """Resolve ``EngineConfig.decide_impl`` for tensors on ``device``:
    ``"pallas"`` (the CUDA kernel's step) or ``"xla"`` (the torch-ops
    pipeline). ``"auto"`` takes the kernel on CUDA and the torch ops
    elsewhere."""
    if impl in ("xla", "pallas"):
        return impl
    if impl != "auto":
        raise ValueError(
            f"unknown decide impl {impl!r}; use 'auto'|'xla'|'pallas'"
        )
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def _core_for(config: EngineConfig, grouped: bool, device):
    """The decide-core callable for this config and device.

    The kernel's segment-tail write-back is race-free only under the
    grouped-batch contract, so non-grouped callers always get the torch-ops
    pipeline (the reference's ``_core_for`` sends them to XLA)."""
    if grouped and resolve_decide_impl(config.decide_impl, device) == "pallas":
        from sentinel_tpu_torch.ops.decide_cuda import decide_core_kernel

        return decide_core_kernel
    return _decide_core


def decide(
    config: EngineConfig,
    state: EngineState,
    rules: RuleTable,
    batch: RequestBatch,
    now: int,
    grouped: bool = False,
    uniform: bool = False,
) -> tuple:
    """``(state, rules, batch, now) -> (state', verdicts)`` without touching
    ``state`` (it is copied first, like the reference's pure function)."""
    st = clone_state(state)
    core = _core_for(config, grouped, st.flow.counts.device)
    return core(config, st, rules, batch, now, grouped=grouped,
                uniform=uniform)


def decide_donating(config: EngineConfig, grouped: bool = False,
                    uniform: bool = False):
    """A step like :func:`decide` that updates the passed state **in place**
    (the port of JAX's buffer donation). Returns
    ``step(state, rules, batch, now) -> (state, verdicts)``; the returned
    state is the same tensors. Callers must not hold another reference they
    expect unchanged."""

    def step(state, rules, batch, now):
        core = _core_for(config, grouped, state.flow.counts.device)
        return core(config, state, rules, batch, now, grouped=grouped,
                    uniform=uniform)

    return step


def decide_fused_donating(config: EngineConfig, depth: int,
                          grouped: bool = False, uniform: bool = False):
    """``depth`` chained steps over stacked ``[depth, batch_size]`` frames,
    updating the state in place. The reference's ``lax.scan`` becomes a
    Python loop: frame ``k`` sees exactly the state frame ``k-1`` produced,
    at one shared ``now``. Verdict leaves come back ``[depth, batch_size]``.
    """
    if depth < 1:
        raise ValueError(f"fused depth must be >= 1, got {depth}")

    def fused(state, rules, batches, now):
        dev = state.flow.counts.device
        core = _core_for(config, grouped, dev)
        batches = batch_to(batches, dev)
        outs = []
        for k in range(depth):
            frame = RequestBatch(*(leaf[k] for leaf in batches))
            state, v = core(config, state, rules, frame, now,
                            grouped=grouped, uniform=uniform)
            outs.append(v)
        return state, VerdictBatch(*(
            torch.stack(leaves) for leaves in zip(*outs)
        ))

    return fused
