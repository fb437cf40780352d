"""The decide step over the flow plane as one hand-written CUDA kernel (port
of ``sentinel_tpu/ops/decide_pallas.py``).

Three layers, mirroring the reference:

- :func:`decide_core_kernel` — the drop-in ``_decide_core`` twin (the
  reference's ``decide_core_pallas``): the ``[N]``-sized prologue (namespace
  guard, breaker gate, write mask) and epilogue (shaper-clock scatters,
  occupy charge, namespace column, verdict stitching) in torch ops, around
  one call of :func:`decide_rows`.
- :func:`decide_rows` — the kernel's wrapper (the reference's
  ``_call_decide_kernel``). On CUDA tensors it launches ``csrc/decide.cu``
  (a roll launch, then the decide launch: a grid of blocks that each own
  whole segments of the grouped batch, :func:`launch_grid`) and adds one to
  ``LAUNCHES["decide_rows"]``; on CPU tensors it runs :func:`decide_rows_plain`.
  It never falls back from the kernel.
- :func:`decide_rows_plain` — the same function in plain torch ops (the
  per-row math of the reference's ``_make_decide_kernel``). The CPU tests
  hold it against the reference; on the card the kernel is held against it.

The reference caps batches at 1024 rows (VMEM) and sends larger ones to XLA;
the CUDA kernel takes any ``N``, so every serving bucket goes through it.
Results are unchanged: the reference's fallback is its bitwise-equal XLA
path. The state is updated in place (the reference aliases the flow plane,
``input_output_aliases={0: 0}``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.prefix import _grouped_prefix
from sentinel_tpu_torch.engine.rules import RuleTable, ThresholdMode
from sentinel_tpu_torch.engine.state import (
    ClusterEvent,
    EngineState,
    N_CLUSTER_EVENTS,
    flow_spec,
)
from sentinel_tpu_torch.ops._launch import check
from sentinel_tpu_torch.stats import window as W

# the kernel keeps the window starts of one ring in shared memory
MAX_BUCKETS = 64

# kernel launches on CUDA tensors, by wrapper; CPU calls do not count. The
# shards of a flow mesh launch from threads of their own, so a count is
# taken under a lock.
LAUNCHES = {"decide_rows": 0}
_COUNT_LOCK = threading.Lock()

# The decide launch's grid: at most one block per SM of an H100 (132), each
# with a nominal range of MIN_CHUNK rows or more. Any grid gives the same
# result; the kernel's block width is fixed in csrc/decide.cu.
SM_COUNT = 132
MIN_CHUNK = 32


def launch_grid(n_rows: int) -> tuple:
    """``(blocks, chunk)`` of the decide launch for a batch of ``n_rows``:
    block ``b`` owns the segments whose head lies in ``[b * chunk,
    (b + 1) * chunk)``."""
    chunk = max(-(-n_rows // SM_COUNT), MIN_CHUNK)
    return -(-n_rows // chunk), chunk


class DecideRows(NamedTuple):
    """The kernel's ``[N]`` outputs, as the reference's ten output refs."""

    admit: torch.Tensor  # bool
    can_occupy: torch.Tensor  # bool
    pace_accept: torch.Tensor  # bool
    pace_wait: torch.Tensor  # int32
    passed: torch.Tensor  # float32
    threshold: torch.Tensor  # float32
    admitted_prefix: torch.Tensor  # float32
    tokens_new: torch.Tensor  # float32
    do_sync: torch.Tensor  # bool
    lpt_sched: torch.Tensor  # int32


# the columns decide_rows takes, with their dtypes (the reference's order)
ROW_COLUMNS = (
    ("safe_slot", torch.int32),
    ("write_ok", torch.bool),
    ("acquire", torch.int32),
    ("live", torch.bool),
    ("active", torch.bool),
    ("beh", torch.int32),
    ("prioritized", torch.bool),
    ("factor", torch.float32),
    ("cnt", torch.float32),
    ("warn", torch.float32),
    ("max_token", torch.float32),
    ("slope", torch.float32),
    ("cold_count", torch.float32),
    ("max_queue_ms", torch.int32),
    ("lpt_rows", torch.int32),
    ("wtok_rows", torch.float32),
    ("wfill_rows", torch.int32),
)


def _scalars(config: EngineConfig, now: int) -> dict:
    """Host-side floor-division results and float32 constants, computed
    once so the kernel and the plain version share them."""
    spec = flow_spec(config)
    idx_cur, cur_start = W.bucket_index(spec, now)
    wait_next = spec.bucket_ms - now % spec.bucket_ms
    return dict(
        idx_cur=idx_cur,
        cur_start=cur_start,
        cur_sec=now - now % 1000,
        horizon=now + wait_next - spec.interval_ms,
        interval_ms=spec.interval_ms,
        # the reference multiplies float32 arrays by these Python floats,
        # i.e. by their float32 roundings
        interval_scale=float(np.float32(spec.interval_ms / 1000.0)),
        pass_qps_scale=float(np.float32(1000.0 / spec.interval_ms)),
    )


def decide_rows_plain(
    config: EngineConfig,
    flow_counts: torch.Tensor,  # [F, B, E] i32, updated in place
    occ_counts: torch.Tensor,  # [F, B, 1] i32
    fstarts: torch.Tensor,  # [B] i32, updated in place
    ostarts: torch.Tensor,  # [B] i32
    now: int,
    cols: dict,
    uniform: bool,
) -> DecideRows:
    """The kernel's function in plain torch ops (the reference's
    ``_make_decide_kernel`` body, op for op)."""
    spec = flow_spec(config)
    now = int(now)
    sc = _scalars(config, now)
    idx_cur, cur_start = sc["idx_cur"], sc["cur_start"]
    interval_ms = spec.interval_ms
    ev = ClusterEvent
    from sentinel_tpu_torch.engine.decide import (
        _occupy_feasible,
        _warmup_curve,
        uniform_acquire,
    )

    fstarts_old = fstarts.clone()
    ostarts_old = ostarts
    # roll: conditional stale-column zero, before the row gather
    stale = fstarts_old[idx_cur] != cur_start
    flow_counts[:, idx_cur, :].mul_(torch.where(stale, 0, 1).to(torch.int32))

    slot = cols["safe_slot"]
    slot_l = slot.to(torch.int64)
    fvals = flow_counts[slot_l]  # [N, B, E] post-roll
    ovals = occ_counts[slot_l][:, :, 0]  # [N, B]
    acquire = cols["acquire"]
    acquire_f = acquire.to(torch.float32)
    live = cols["live"]
    active = cols["active"]
    beh = cols["beh"]
    prio = cols["prioritized"]
    factor = cols["factor"]
    cnt = cols["cnt"]

    f_age = now - fstarts_old
    f_valid = ((f_age >= 0) & (f_age < interval_ms)).to(torch.int32)
    o_age = now - ostarts_old
    o_valid = ((o_age >= 0) & (o_age < interval_ms)).to(torch.int32)
    o_ahead = ostarts_old - now
    o_future = ((o_ahead > 0) & (o_ahead <= interval_ms)).to(torch.int32)

    def rowsum(rows, mask):
        return torch.sum(rows * mask[None, :], dim=1, dtype=torch.int32)

    pass_rows = fvals[:, :, int(ev.PASS)]
    leased_rows = fvals[:, :, int(ev.LEASED)]
    passed = (
        rowsum(pass_rows, f_valid)
        + rowsum(ovals, o_valid)
        + rowsum(leased_rows, f_valid)
    ).to(torch.float32)

    is_warm = (beh == 1) | (beh == 3)
    is_pace = (beh == 2) | (beh == 3)
    warm_rows = active & is_warm
    pace_try = active & is_pace
    active_window = active & ~is_pace

    cnt_safe = torch.clamp_min(cnt, 1e-6)
    qps, tokens_new, do_sync, _cur_sec = _warmup_curve(
        spec, now, passed, cnt, cnt_safe,
        cols["warn"], cols["max_token"], cols["slope"], cols["cold_count"],
        cols["wfill_rows"], cols["wtok_rows"], warm_rows,
    )
    rate_qps = qps * factor * config.exceed_count
    threshold = rate_qps * (spec.interval_ms / 1000.0)

    flow_prefix = _grouped_prefix(slot)

    if uniform:
        a = uniform_acquire(live, acquire)
        a_safe = torch.clamp_min(a, 1.0)
        rank = flow_prefix(active_window.to(torch.float32))
        admit = active_window & (passed + rank * a + a <= threshold)
        quota = torch.floor(torch.clamp_min(threshold - passed, 0.0) / a_safe)
        admitted_prefix = torch.minimum(rank, quota) * a
    else:
        admit = active_window
        for _ in range(config.admission_refine_iters):
            contrib = torch.where(admit, acquire_f, 0.0)
            prefix = flow_prefix(contrib)
            admit = active_window & (passed + prefix + acquire_f <= threshold)
        admitted_prefix = flow_prefix(torch.where(admit, acquire_f, 0.0))

    cost_f = torch.round(1000.0 * acquire_f / torch.clamp_min(rate_qps, 1e-6))
    rel0 = torch.clamp_min(cols["lpt_rows"] - now, -(2**20)).to(torch.float32)
    maxq = cols["max_queue_ms"].to(torch.float32)
    rev_prefix = _grouped_prefix(torch.flip(slot, (0,)))

    def pace_pass(accept):
        contrib = torch.where(accept, cost_f, 0.0)
        incl = flow_prefix(contrib) + cost_f
        rank_p = flow_prefix(accept.to(torch.float32))
        first = accept & (rank_p == 0.0)
        # segment sum of the first-row-only costs: prefix + own + suffix
        t = torch.where(first, cost_f, 0.0)
        c_first = (
            flow_prefix(t) + t
            + torch.flip(rev_prefix(torch.flip(t, (0,))), (0,))
        )
        return torch.maximum(rel0, -c_first) + incl

    accept = pace_try
    l_rel = pace_pass(accept)
    for _i in range(0 if uniform else config.admission_refine_iters):
        accept = pace_try & (l_rel <= maxq)
        l_rel = pace_pass(accept)
    accept = pace_try & (l_rel <= maxq)
    wait_i = torch.clamp_min(l_rel, 0.0).to(torch.int32)
    lpt_sched = torch.round(l_rel).to(torch.int32) + now
    pace_now = accept & (wait_i == 0)
    pace_reject = pace_try & ~accept

    blocked = active_window & ~admit
    try_occupy = blocked & prio & (beh == 0)
    horizon = sc["horizon"]
    exp_mask = ((f_valid != 0) & (fstarts_old <= horizon)).to(torch.int32)
    expiring = rowsum(pass_rows, exp_mask).to(torch.float32)
    waiting = rowsum(ovals, o_future).to(torch.float32)
    occ_prefix = flow_prefix(torch.where(try_occupy, acquire_f, 0.0))
    can_occupy = _occupy_feasible(
        config, try_occupy, passed, expiring, admitted_prefix,
        waiting, occ_prefix, acquire_f, threshold,
    )
    hard_block = blocked & ~can_occupy

    admit_i = (admit | pace_now).to(torch.int32)
    hard_i = (hard_block | pace_reject).to(torch.int32)
    deltas = torch.stack([
        acquire * admit_i,  # PASS
        admit_i,  # PASS_REQUEST
        acquire * hard_i,  # BLOCK
        hard_i,  # BLOCK_REQUEST
        acquire * (admit & prio).to(torch.int32),  # OCCUPIED_PASS
        torch.zeros_like(acquire),  # LEASED
    ], dim=1).to(torch.float32)  # [N, E]
    # inclusive segment totals; the segment-tail row carries the segment's
    # whole delta, and it is the one row that writes (write_ok)
    totals = torch.stack(
        [(flow_prefix(deltas[:, e]) + deltas[:, e]).to(torch.int32)
         for e in range(N_CLUSTER_EVENTS)],
        dim=1,
    )
    wok = cols["write_ok"]
    flow_counts[:, idx_cur, :].index_put_(
        (slot_l,), torch.where(wok[:, None], totals, 0), accumulate=True
    )
    fstarts[idx_cur].fill_(cur_start)  # no host-scalar copy: no stream wait

    return DecideRows(
        admit=admit, can_occupy=can_occupy, pace_accept=accept,
        pace_wait=wait_i, passed=passed, threshold=threshold,
        admitted_prefix=admitted_prefix, tokens_new=tokens_new,
        do_sync=do_sync, lpt_sched=lpt_sched,
    )


_C_ARGTYPES = (
    [ctypes.c_void_p] * 4  # flow, occ, fstarts, ostarts
    + [ctypes.c_longlong]  # F
    + [ctypes.c_int] * 10  # B N now idx_cur cur_start cur_sec horizon
    #                        interval_ms uniform refine_iters
    + [ctypes.c_float] * 4  # exceed interval_scale pass_qps_scale occ_ratio
    + [ctypes.c_void_p] * len(ROW_COLUMNS)
    + [ctypes.c_void_p] * len(DecideRows._fields)
    + [ctypes.c_void_p] * 2  # work, scratch
    + [ctypes.c_int] * 2  # blocks chunk
    + [ctypes.c_void_p]  # stream
)
# csrc/decide.cu: PL_COUNT planes of N words for a block that owns more rows
# than its shared memory holds, and SCRATCH_INTS words from launch 1 to 2
_WORK_PLANES = 13
_SCRATCH_INTS = 129


def _kernel_lib():
    from sentinel_tpu_torch.ops import _build

    lib = _build.load("decide")
    fn = lib.sentinel_decide_rows
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
        layout = []
        for query in (lib.sentinel_decide_work_planes,
                      lib.sentinel_decide_scratch_ints):
            query.argtypes = []
            query.restype = ctypes.c_int
            layout.append(query())
        if layout != [_WORK_PLANES, _SCRATCH_INTS]:
            raise RuntimeError("csrc/decide.cu workspace layout changed")
    return fn


def _check(name, t, dtype, shape, device):
    check("decide_rows", name, t, dtype, shape, device)


def decide_rows(
    config: EngineConfig,
    flow_counts: torch.Tensor,
    occ_counts: torch.Tensor,
    fstarts: torch.Tensor,
    ostarts: torch.Tensor,
    now: int,
    cols: dict,
    uniform: bool,
) -> DecideRows:
    """The kernel's wrapper: ``flow_counts`` and ``fstarts`` are updated in
    place; returns the ``[N]`` decision columns. ``N`` may be 0 (a mesh
    shard that owns no row of the frame): the flow window still rolls, and
    only the kernel's first launch (the roll, a grid over the ``F x E``
    column) and the one-thread record of the new start run.

    CPU tensors run :func:`decide_rows_plain`. CUDA tensors launch the
    kernel (after checking device, dtype, shape and contiguity) or raise.
    """
    now = int(now)
    device = flow_counts.device
    if device.type == "cpu":
        return decide_rows_plain(config, flow_counts, occ_counts, fstarts,
                                 ostarts, now, cols, uniform)
    if device.type != "cuda":
        raise ValueError(f"decide_rows: unsupported device {device}")
    F, B, E = flow_counts.shape
    N = cols["safe_slot"].shape[0]
    if E != N_CLUSTER_EVENTS or B != config.n_buckets or B > MAX_BUCKETS:
        raise ValueError(f"decide_rows: flow plane shape {(F, B, E)}")
    _check("flow_counts", flow_counts, torch.int32, (F, B, E), device)
    _check("occ_counts", occ_counts, torch.int32, (F, B, 1), device)
    _check("fstarts", fstarts, torch.int32, (B,), device)
    _check("ostarts", ostarts, torch.int32, (B,), device)
    for name, dtype in ROW_COLUMNS:
        _check(name, cols[name], dtype, (N,), device)

    def empty(dtype):
        return torch.empty((N,), dtype=dtype, device=device)

    out = DecideRows(
        admit=empty(torch.bool), can_occupy=empty(torch.bool),
        pace_accept=empty(torch.bool), pace_wait=empty(torch.int32),
        passed=empty(torch.float32), threshold=empty(torch.float32),
        admitted_prefix=empty(torch.float32),
        tokens_new=empty(torch.float32), do_sync=empty(torch.bool),
        lpt_sched=empty(torch.int32),
    )
    # one allocation: the spill planes, then the scratch of launch 1
    work = torch.empty((_WORK_PLANES * N + _SCRATCH_INTS,), dtype=torch.int32,
                       device=device)
    blocks, chunk = launch_grid(N)
    sc = _scalars(config, now)
    fn = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(
        flow_counts.data_ptr(), occ_counts.data_ptr(), fstarts.data_ptr(),
        ostarts.data_ptr(),
        F, B, N, now, sc["idx_cur"], sc["cur_start"], sc["cur_sec"],
        sc["horizon"], sc["interval_ms"], int(bool(uniform)),
        int(config.admission_refine_iters),
        float(config.exceed_count), sc["interval_scale"],
        sc["pass_qps_scale"], float(config.max_occupy_ratio),
        *(cols[name].data_ptr() for name, _ in ROW_COLUMNS),
        *(t.data_ptr() for t in out),
        work.data_ptr(), work.data_ptr() + 4 * _WORK_PLANES * N,
        blocks, chunk, stream,
    )
    if err != 0:
        raise RuntimeError(f"decide kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES["decide_rows"] += 1
    return out


def decide_core_kernel(
    config: EngineConfig,
    state: EngineState,
    rules: RuleTable,
    batch,
    now: int,
    grouped: bool = False,
    uniform: bool = False,
    axis: Optional[object] = None,
) -> tuple:
    """Drop-in ``_decide_core`` twin backed by the kernel: same signature,
    same outputs, bitwise-equal results, state updated in place. Requires
    the grouped-batch contract; non-grouped calls take the torch-ops
    pipeline. Under a flow mesh (``axis``, an ``engine.decide.ShardAxis``)
    ``batch`` holds only the shard's own rows, as for ``_decide_core``, and
    the prologue and epilogue take the same hooks; the launch covers those
    rows alone (none: the launch only rolls the shard's flow window)."""
    import importlib

    D = importlib.import_module("sentinel_tpu_torch.engine.decide")
    if not grouped:
        return D._decide_core(config, state, rules, batch, now,
                              grouped=grouped, uniform=uniform, axis=axis)
    if config.admission_refine_iters % 2 == 0:
        raise ValueError("admission_refine_iters must be odd")

    spec = flow_spec(config)
    now = int(now)
    dev = state.flow.counts.device
    batch = D.batch_to(batch, dev)
    N = batch.valid.shape[0]
    f_local = rules.valid.shape[0]

    # ---- prologue: [N]-sized setup, namespace guard, breakers ------------
    in_range, safe_slot = D.shard_slots(batch.flow_slot, f_local, axis)
    slot = safe_slot.to(torch.int64)
    owned = in_range & rules.valid[slot]
    live, no_rule = D.rule_presence(batch, owned)
    acquire_f = batch.acquire.to(torch.float32)

    ns_id, ns_ok, seg_ns_sum = D._ns_guard(
        config, spec, state.ns, rules, now, owned, safe_slot, live, axis
    )
    too_many = live & ~ns_ok
    ns_admitted = live & ns_ok
    active = ns_admitted & owned

    # degraded rows are stripped from `active` before the kernel sees them
    degraded, br_retry, breaker_ws = D._breaker_gate(
        config, spec, state, rules, now, safe_slot, active,
        _grouped_prefix(safe_slot),
    )
    active = active & ~degraded

    conn = rules.ns_connected[ns_id].to(torch.float32)
    factor = torch.where(
        rules.mode[slot] == int(ThresholdMode.AVG_LOCAL), conn, 1.0
    )
    beh = rules.behavior[slot].to(torch.int32)
    is_pace = (beh == 2) | (beh == 3)
    pace_try_mask = active & is_pace
    active_window = active & ~is_pace

    # one write-back row per safe_slot segment: its LAST in-range row
    false1 = torch.zeros((1,), dtype=torch.bool, device=dev)
    next_same = torch.cat([safe_slot[1:] == safe_slot[:-1], false1])
    next_in = torch.cat([in_range[1:], false1])
    write_ok = in_range & ~(next_same & next_in)

    cols = dict(
        safe_slot=safe_slot.contiguous(),
        write_ok=write_ok,
        acquire=batch.acquire.contiguous(),
        live=live,
        active=active,
        beh=beh,
        prioritized=batch.prioritized.contiguous(),
        factor=factor.contiguous(),
        cnt=rules.count[slot],
        warn=rules.warning_token[slot],
        max_token=rules.max_token[slot],
        slope=rules.slope[slot],
        cold_count=rules.cold_count[slot],
        max_queue_ms=rules.max_queue_ms[slot],
        lpt_rows=state.shaping.lpt[slot],
        wtok_rows=state.shaping.warm_tokens[slot],
        wfill_rows=state.shaping.warm_filled[slot],
    )
    rows = decide_rows(
        config, state.flow.counts, state.occupy.counts, state.flow.starts,
        state.occupy.starts, now, cols, uniform,
    )

    admit = rows.admit
    can_occupy = rows.can_occupy
    pace_admit = rows.pace_accept
    pace_wait = rows.pace_wait
    pace_now = pace_admit & (pace_wait == 0)
    pace_later = pace_admit & (pace_wait > 0)
    pace_reject = pace_try_mask & ~pace_admit
    hard_block = (active_window & ~admit) & ~can_occupy
    wait_next = spec.bucket_ms - (now % spec.bucket_ms)

    # ---- epilogue: O(batch) scatters, same as the torch-ops pipeline ------
    cur_sec = now - now % 1000
    W.masked_set_(state.shaping.warm_tokens, slot, rows.tokens_new,
                  rows.do_sync)
    W.masked_set_(state.shaping.warm_filled, slot, cur_sec, rows.do_sync)
    W.masked_max_(state.shaping.lpt, slot, rows.lpt_sched, pace_admit)
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

    verdicts = D._verdicts(
        batch, no_rule, too_many, degraded, admit, pace_now, can_occupy,
        pace_later, hard_block, pace_reject, wait_next, pace_wait,
        rows.threshold, rows.passed, rows.admitted_prefix, acquire_f,
        br_retry,
    )
    return state._replace(breaker=breaker_ws), verdicts
