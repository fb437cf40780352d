"""The SALSA decide + update as one hand-written CUDA kernel (port of
``sentinel_tpu/ops/salsa_pallas.py``).

The count-min decide of ``ops/cms_cuda.py`` over the int16 pair encoding
of :mod:`sentinel_tpu_torch.sketch.salsa`: gathers decode the pair in
flight, admitted adds to a merged pair are routed to its even cell, and the
current-bucket plane is re-encoded with merge-on-saturation, counting each
newly merged pair into ``merges``.

- :func:`salsa_decide_update` — the kernel's wrapper. On CUDA tensors it
  launches ``csrc/salsa.cu`` (one launch of one block, the roll included,
  which re-encodes only the pairs the admitted rows address) and adds one to
  ``LAUNCHES["salsa_decide_update"]``; on CPU tensors it runs
  :func:`salsa_decide_update_plain`. It never falls back from the kernel.
- :func:`salsa_decide_update_plain` — the same function in torch ops, op
  for op the reference's XLA core (``sketch/salsa.py::salsa_decide_jax``),
  whole-plane re-encode included: the port's torch-ops core, the CPU path,
  and the kernel's yardstick.

The kernel and the plain version agree on every plane this encoder produced
(from zeros, through rolls, updates and imports of reference states): there
the re-encode is the identity on a pair that received no add. The kernel's
note in ``csrc/salsa.cu`` states the precondition.

``counts``, ``starts`` and ``merges`` are updated in place, in the state's
``[P, B, D, 2W]`` layout. Any ``N`` is taken (the reference caps at 1024).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sentinel_tpu_torch.ops._launch import check, raise_on, stream_of
from sentinel_tpu_torch.ops.cms_cuda import (
    MAX_BUCKETS,
    admit_rows,
    bucket_ok,
    check_rows,
    load_param_kernel,
    mix_keys,
    ring,
    roll_,
)
from sentinel_tpu_torch.sketch.salsa import CAP, decode_plane, encode_plane

LAUNCHES = {"salsa_decide_update": 0}

# The kernel's per-pair add sums: an int32 [P, D, 2W] buffer (twice the
# bytes of one int16 plane) that is all zero between calls, because the
# launch clears every cell it added to. It is kept per device, stream and
# sketch shape instead of being allocated and cleared every call.
#
# Lifetime: made at the first launch for its key, held until the process
# ends, until MAX_DELTAS newer keys push it out (oldest first), or until a
# launch for its key returns an error. A fault that shows only after the
# launch returned is a sticky CUDA error: no later call on that context
# succeeds, so a buffer it left non-zero is never read again.
# ParamState does not hold the buffer because its fields are the
# reference's, one to one (interop, checkpoints).
MAX_DELTAS = 4
_DELTAS: dict = {}


def persistent_delta(counts: torch.Tensor) -> Optional[torch.Tensor]:
    """The add-sum buffer the kernel keeps for ``counts``' device, current
    stream and shape, if a launch has made one: all zero between calls."""
    if counts.device.type != "cuda":
        return None
    return _DELTAS.get(_delta_key(counts))


def _delta_key(counts: torch.Tensor) -> tuple:
    P, _, D, C = counts.shape
    return (counts.device, stream_of(counts.device), P, D, C)


def salsa_decide_update_plain(
    counts: torch.Tensor,  # [P, B, D, 2W] int16, updated in place
    starts: torch.Tensor,  # [B] int32, updated in place
    merges: torch.Tensor,  # [P] int32, updated in place
    rule_slot: torch.Tensor,
    idx: torch.Tensor,  # [N, D] int32 cell indices over 2W cells
    acquire: torch.Tensor,
    threshold: torch.Tensor,
    valid: torch.Tensor,
    now: int,
    bucket_ms: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (admit [N] bool, estimate [N] int32)`` in torch ops."""
    now = int(now)
    P, B, D, C = counts.shape
    cur, cur_start = ring(now, bucket_ms, B)
    roll_(counts, starts, cur, cur_start)  # zeroed cells are unmerged zeros
    ok = bucket_ok(starts, now, bucket_ms * B)

    safe = torch.where(rule_slot >= 0, rule_slot, 0).to(torch.int64)
    live = valid & (rule_slot >= 0)
    d_ar = torch.arange(D, device=counts.device)[None, :]
    idx_l = idx.to(torch.int64)
    pair = (idx_l // 2) * 2  # [N, D] even cell of each index's pair

    def gather_dec(b):
        lo = counts[safe[:, None], b, d_ar, pair].to(torch.int32)
        hi = counts[safe[:, None], b, d_ar, pair + 1].to(torch.int32)
        merged = hi < 0
        mval = lo + CAP * (-hi - 1)
        own = torch.where(idx_l % 2 == 0, lo, hi)
        return torch.where(merged, mval, own) * ok[b]

    sums = sum(gather_dec(b) for b in range(B))  # [N, D]
    est = torch.min(sums, dim=1).values

    admit = admit_rows(mix_keys(safe, idx), live, est, acquire, threshold)

    # decode the current plane, add with merged pairs routed to their even
    # cell, re-encode the whole plane (merges)
    dec, merged_cur = decode_plane(counts[:, cur])  # [P, D, 2W], [P, D, W]
    m_req = merged_cur[safe[:, None], d_ar, idx_l // 2]  # [N, D]
    idx_eff = torch.where(m_req, pair, idx_l)
    upd = torch.where(admit, acquire.to(torch.int32), 0)
    flat = (safe[:, None] * D + d_ar) * C + idx_eff
    dec.view(-1).index_add_(0, flat.reshape(-1),
                            upd[:, None].expand(-1, D).reshape(-1))
    new_plane, newly = encode_plane(dec, merged_cur)
    counts[:, cur] = new_plane
    merges += newly.sum(dim=(1, 2)).to(torch.int32)
    return admit, est


_C_ARGTYPES = (
    [ctypes.c_void_p] * 3  # counts, starts, merges
    + [ctypes.c_int] * 4  # P B D W (pairs per lane)
    + [ctypes.c_void_p] * 5  # slot idx acquire threshold valid
    + [ctypes.c_int] * 5  # N now cur cur_start interval_ms
    + [ctypes.c_void_p] * 3  # admit est work
    + [ctypes.c_longlong]  # work words
    + [ctypes.c_void_p] * 2  # delta stream
)


def _kernel_lib():
    return load_param_kernel("salsa", "sentinel_salsa_decide", _C_ARGTYPES)


def salsa_decide_update(
    counts: torch.Tensor,
    starts: torch.Tensor,
    merges: torch.Tensor,
    rule_slot: torch.Tensor,
    idx: torch.Tensor,
    acquire: torch.Tensor,
    threshold: torch.Tensor,
    valid: torch.Tensor,
    now: int,
    bucket_ms: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: ``counts``, ``starts`` and ``merges`` are
    updated in place; returns ``(admit [N] bool, estimate [N] int32)``.

    CPU tensors run :func:`salsa_decide_update_plain`. CUDA tensors launch
    the kernel (after checking device, dtype, shape and contiguity) or
    raise. Rows whose slot or cell index lies outside the sketch are not
    live and estimate 0 on the card (the plain version raises on them; the
    reference's two cores differ from each other there, and its callers
    never pass such rows)."""
    now = int(now)
    device = counts.device
    if device.type == "cpu":
        return salsa_decide_update_plain(counts, starts, merges, rule_slot,
                                         idx, acquire, threshold, valid,
                                         now, bucket_ms)
    if device.type != "cuda":
        raise ValueError(f"salsa_decide_update: unsupported device {device}")
    fn_name = "salsa_decide_update"
    if counts.dim() != 4 or counts.shape[3] % 2:
        raise ValueError(f"{fn_name}: counts must be [P, B, D, 2W]")
    P, B, D, C = counts.shape
    if B > MAX_BUCKETS:
        raise ValueError(f"{fn_name}: {B} buckets, at most {MAX_BUCKETS}")
    check(fn_name, "counts", counts, torch.int16, (P, B, D, C), device)
    check(fn_name, "starts", starts, torch.int32, (B,), device)
    check(fn_name, "merges", merges, torch.int32, (P,), device)
    N = check_rows(fn_name, rule_slot, idx, acquire, threshold, valid, D,
                   device)
    cur, cur_start = ring(now, bucket_ms, B)
    admit = torch.empty((N,), dtype=torch.bool, device=device)
    est = torch.empty((N,), dtype=torch.int32, device=device)
    fn, work_words = _kernel_lib()
    words = work_words(N)
    work = torch.empty((words,), dtype=torch.int32, device=device)
    key = _delta_key(counts)
    delta = _DELTAS.get(key)
    if delta is None:
        while len(_DELTAS) >= MAX_DELTAS:
            del _DELTAS[next(iter(_DELTAS))]
        delta = _DELTAS[key] = torch.zeros((P, D, C), dtype=torch.int32,
                                           device=device)
    err = fn(
        counts.data_ptr(), starts.data_ptr(), merges.data_ptr(),
        P, B, D, C // 2,
        rule_slot.data_ptr(), idx.data_ptr(), acquire.data_ptr(),
        threshold.data_ptr(), valid.data_ptr(),
        N, now, cur, cur_start, bucket_ms * B,
        admit.data_ptr(), est.data_ptr(), work.data_ptr(), words,
        delta.data_ptr(), stream_of(device),
    )
    if err != 0:
        _DELTAS.pop(key, None)  # it may no longer be all zero
    raise_on(fn_name, err)
    LAUNCHES[fn_name] += 1
    return admit, est
