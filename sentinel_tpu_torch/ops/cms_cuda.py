"""The windowed count-min decide + update as one hand-written CUDA kernel
(port of ``sentinel_tpu/ops/cms_pallas.py``).

- :func:`cms_decide_update` — the kernel's wrapper. On CUDA tensors it
  launches ``csrc/cms.cu`` (one launch of one block, the roll included) and
  adds one to ``LAUNCHES["cms_decide_update"]``; given the slim twin
  (``slim=``), the same launch runs the twin's pre- and post-step
  (``sketch/slim.py``) and adds one to ``LAUNCHES["cms_slim_fused"]`` too.
  On CPU tensors it runs :func:`cms_decide_update_plain` (the twin there is
  the torch-op composition of ``engine/param.py::param_decide``). It never
  falls back from the kernel.
- :func:`cms_decide_update_plain` — the same function in torch ops, op for
  op the reference's XLA core (``engine/param.py::_param_decide_jax``). It
  is the port's torch-ops core (``ParamConfig(impl="jax")``), the CPU path,
  and what the kernel is held against on the card.

Both update ``counts`` and ``starts`` in place (the reference aliases the
planes, ``input_output_aliases={0: 0}``) and take the state's own
``[P, B, D, W]`` layout; the reference's transposes to ``[B*D, P, W]``
planes serve the TPU's DMA and are not carried over. The reference caps the
kernel at 1024 rows; this one takes any ``N``.

The helpers below (ring slot, roll, window mask, key mix, prefix admission)
are shared with the SALSA kernel's plain version (``ops/salsa_cuda.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sentinel_tpu_torch.ops._launch import check, raise_on, stream_of

# the kernels keep one flag per ring bucket in shared memory
MAX_BUCKETS = 64
# in-batch prefix refinement passes: odd, so the admitted set never
# overshoots the sequential-greedy one (engine/decide.py)
REFINE_ITERS = 3
# the prefix key's multiplier, 0x9E3779B9 as int32
KEY_MIX = -1640531527

# kernel launches on CUDA tensors, by wrapper; CPU calls do not count
LAUNCHES = {"cms_decide_update": 0, "cms_slim_fused": 0}


def ring(now: int, bucket_ms: int, n_buckets: int) -> Tuple[int, int]:
    """``(current ring slot, current bucket start)``; floor ops, as the
    reference's int32 ``//`` and ``%``."""
    return (now // bucket_ms) % n_buckets, now - now % bucket_ms


def roll_(counts: torch.Tensor, starts: torch.Tensor, cur: int,
          cur_start: int) -> None:
    """Zero ring slot ``cur`` of ``counts [P, B, ...]`` when its recorded
    start is stale, then record ``cur_start``; decided on the device."""
    keep = (starts[cur] == cur_start).to(counts.dtype)
    counts[:, cur].mul_(keep)
    starts[cur].fill_(cur_start)  # no host-scalar copy: no stream wait


def bucket_ok(starts: torch.Tensor, now: int,
              interval_ms: int) -> torch.Tensor:
    """``[B] int32`` 1 where a bucket lies inside the window (post-roll
    starts; int32 arithmetic wraps as in the reference)."""
    age = now - starts
    return ((age >= 0) & (age < interval_ms)).to(torch.int32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to its int32 two's-complement value."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def mix_keys(safe_slot: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The in-batch prefix key ``key = key * KEY_MIX + idx[:, d]`` over the
    lanes, wrapping like the reference's int32 arithmetic (computed in int64
    and reduced, so no signed overflow happens on any device)."""
    key = safe_slot.to(torch.int64)
    for d in range(idx.shape[1]):
        key = _wrap32(key * KEY_MIX + idx[:, d].to(torch.int64))
    return key.to(torch.int32)


def admit_rows(key, live, est, acquire, threshold) -> torch.Tensor:
    """Greedy in-batch admission on the (slot, index-tuple) key: requests on
    one key are admitted in batch order against the shared budget,
    ``est + prefix + acquire <= threshold`` in float32, left to right."""
    from sentinel_tpu_torch.engine.prefix import segment_prefix_builder

    seg_prefix = segment_prefix_builder(key, "sort")
    acq = acquire.to(torch.int32)
    est_f = est.to(torch.float32)
    acq_f = acq.to(torch.float32)
    admit = live
    for _ in range(REFINE_ITERS):
        prefix = seg_prefix(torch.where(admit, acq, 0))
        admit = live & (est_f + prefix + acq_f <= threshold)
    return admit


def cms_decide_update_plain(
    counts: torch.Tensor,  # [P, B, D, W] int32, updated in place
    starts: torch.Tensor,  # [B] int32, updated in place
    rule_slot: torch.Tensor,  # [N] int32, -1 -> no rule
    idx: torch.Tensor,  # [N, D] int32
    acquire: torch.Tensor,  # [N] int32
    threshold: torch.Tensor,  # [N] float32
    valid: torch.Tensor,  # [N] bool
    now: int,
    bucket_ms: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (admit [N] bool, estimate [N] int32)`` in torch ops.

    Rolls the current bucket, estimates each row as the min over lanes of
    its windowed cell sums, admits with the in-batch prefix, and adds the
    admitted acquires to the current bucket's lanes."""
    now = int(now)
    P, B, D, W = counts.shape
    cur, cur_start = ring(now, bucket_ms, B)
    roll_(counts, starts, cur, cur_start)
    ok = bucket_ok(starts, now, bucket_ms * B)

    safe = torch.where(rule_slot >= 0, rule_slot, 0).to(torch.int64)
    live = valid & (rule_slot >= 0)
    d_ar = torch.arange(D, device=counts.device)[None, :]
    idx_l = idx.to(torch.int64)
    sums = sum(counts[safe[:, None], b, d_ar, idx_l] * ok[b]
               for b in range(B))  # [N, D]
    est = torch.min(sums, dim=1).values

    admit = admit_rows(mix_keys(safe, idx), live, est, acquire, threshold)

    upd = torch.where(admit, acquire.to(torch.int32), 0)
    flat = ((safe[:, None] * B + cur) * D + d_ar) * W + idx_l
    counts.view(-1).index_add_(0, flat.reshape(-1),
                               upd[:, None].expand(-1, D).reshape(-1))
    return admit, est


_C_ARGTYPES = (
    [ctypes.c_void_p] * 2  # counts, starts
    + [ctypes.c_int] * 4  # P B D W
    + [ctypes.c_void_p] * 5  # slot idx acquire threshold valid
    + [ctypes.c_int] * 5  # N now cur cur_start interval_ms
    + [ctypes.c_void_p] * 2  # admit est
    + [ctypes.c_void_p] * 3  # slim slim_auth idx_slim
    + [ctypes.c_int] * 2  # Ds Ws
    + [ctypes.c_void_p]  # work
    + [ctypes.c_longlong, ctypes.c_void_p]  # work words, stream
)


def load_param_kernel(name: str, entry: str, argtypes,
                      words_entry: str = "sentinel_param_work_words",
                      words_argtypes=(ctypes.c_int,)):
    """``(kernel entry, workspace words)`` of ``csrc/<name>.cu``, typed for
    ctypes."""
    from sentinel_tpu_torch.ops import _build

    lib = _build.load(name)
    fn, words = getattr(lib, entry), getattr(lib, words_entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        words.argtypes = list(words_argtypes)
        words.restype = ctypes.c_longlong
    return fn, words


def _kernel_lib():
    """``(entry, words(N, twin))``."""
    return load_param_kernel("cms", "sentinel_cms_decide", _C_ARGTYPES,
                             "sentinel_cms_work_words",
                             (ctypes.c_int, ctypes.c_int))


def check_rows(fn: str, rule_slot, idx, acquire, threshold, valid, D,
               device) -> int:
    """Check the ``[N]`` row columns a param kernel takes; returns N."""
    N = rule_slot.shape[0] if isinstance(rule_slot, torch.Tensor) else 0
    if N < 1:
        raise ValueError(f"{fn}: empty batch")
    check(fn, "rule_slot", rule_slot, torch.int32, (N,), device)
    check(fn, "idx", idx, torch.int32, (N, D), device)
    check(fn, "acquire", acquire, torch.int32, (N,), device)
    check(fn, "threshold", threshold, torch.float32, (N,), device)
    check(fn, "valid", valid, torch.bool, (N,), device)
    return N


def cms_decide_update(
    counts: torch.Tensor,
    starts: torch.Tensor,
    rule_slot: torch.Tensor,
    idx: torch.Tensor,
    acquire: torch.Tensor,
    threshold: torch.Tensor,
    valid: torch.Tensor,
    now: int,
    bucket_ms: int,
    slim: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: ``counts`` and ``starts`` are updated in place;
    returns ``(admit [N] bool, estimate [N] int32)``.

    ``slim = (cells [P, B, Ds, Ws] int32, auth [B] bool, idx_slim [N, Ds]
    int32)``: the slim twin, updated in place by the same launch, as
    ``slim_prestep``, this step on the lowered thresholds, then
    ``slim_poststep`` would (``sketch/slim.py``); the estimate is then fat +
    slim. CUDA tensors only.

    CPU tensors run :func:`cms_decide_update_plain`. CUDA tensors launch
    the kernel (after checking device, dtype, shape and contiguity) or
    raise. Rows whose slot, cell index or slim cell index lies outside the
    sketch are not live and estimate 0 on the card (the plain version
    raises on them; the reference's two cores differ from each other there,
    and its callers never pass such rows)."""
    now = int(now)
    device = counts.device
    if device.type == "cpu":
        if slim is not None:
            raise ValueError("cms_decide_update: the slim twin rides the "
                             "kernel on CUDA tensors only")
        return cms_decide_update_plain(counts, starts, rule_slot, idx,
                                       acquire, threshold, valid, now,
                                       bucket_ms)
    if device.type != "cuda":
        raise ValueError(f"cms_decide_update: unsupported device {device}")
    fn_name = "cms_decide_update"
    if counts.dim() != 4:
        raise ValueError(f"{fn_name}: counts must be [P, B, D, W]")
    P, B, D, W = counts.shape
    if B > MAX_BUCKETS:
        raise ValueError(f"{fn_name}: {B} buckets, at most {MAX_BUCKETS}")
    check(fn_name, "counts", counts, torch.int32, (P, B, D, W), device)
    check(fn_name, "starts", starts, torch.int32, (B,), device)
    N = check_rows(fn_name, rule_slot, idx, acquire, threshold, valid, D,
                   device)
    twin, Ds, Ws = (0, 0, 0), 0, 0
    if slim is not None:
        cells, auth, idx_slim = slim
        if cells.dim() != 4 or cells.shape[:2] != (P, B):
            raise ValueError(f"{fn_name}: slim must be [P, B, Ds, Ws]")
        Ds, Ws = cells.shape[2:]
        if Ws < 1:
            raise ValueError(f"{fn_name}: an empty slim twin")
        check(fn_name, "slim", cells, torch.int32, (P, B, Ds, Ws), device)
        check(fn_name, "slim_auth", auth, torch.bool, (B,), device)
        check(fn_name, "idx_slim", idx_slim, torch.int32, (N, Ds), device)
        twin = (cells.data_ptr(), auth.data_ptr(), idx_slim.data_ptr())
    cur, cur_start = ring(now, bucket_ms, B)
    admit = torch.empty((N,), dtype=torch.bool, device=device)
    est = torch.empty((N,), dtype=torch.int32, device=device)
    fn, work_words = _kernel_lib()
    words = work_words(N, int(Ws > 0))
    work = torch.empty((words,), dtype=torch.int32, device=device)
    err = fn(
        counts.data_ptr(), starts.data_ptr(), P, B, D, W,
        rule_slot.data_ptr(), idx.data_ptr(), acquire.data_ptr(),
        threshold.data_ptr(), valid.data_ptr(),
        N, now, cur, cur_start, bucket_ms * B,
        admit.data_ptr(), est.data_ptr(), *twin, Ds, Ws, work.data_ptr(),
        words, stream_of(device),
    )
    raise_on(fn_name, err)
    LAUNCHES[fn_name] += 1
    if Ws:
        LAUNCHES["cms_slim_fused"] += 1
    return admit, est
