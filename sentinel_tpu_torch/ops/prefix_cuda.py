"""The exclusive segment prefix over ungrouped keys as hand-written CUDA
kernels (port of ``sentinel_tpu/ops/prefix_pallas.py``):
``out[i] = sum(contrib[j] for j < i if keys[j] == keys[i])``.

The reference's kernel re-matches every key pair on every call. Its caller,
the ungrouped decide step, calls it 13 times on one key vector, so the port
splits it in two (``csrc/prefix.cu`` has the design):

- :func:`segment_prefix_plan` — once per key vector: a stable sort of
  (key, row) by the key's bits, as a :class:`PrefixPlan`. On CUDA tensors it
  launches the plan kernel and adds one to
  ``LAUNCHES["segment_prefix_plan"]``; on CPU tensors it runs
  :func:`segment_prefix_plan_plain`.
- :func:`segment_prefix_apply` — once per call: gather in sorted order,
  segmented exclusive scan, scatter back to row order, O(N). On CUDA tensors
  it launches the apply kernel and adds one to
  ``LAUNCHES["segment_prefix_apply"]``; on CPU tensors it runs
  :func:`segment_prefix_apply_plain`.
- :func:`segment_prefix` — plan + apply, for one-shot callers.
- :func:`segment_prefix_plain` — the reference's masked sum in torch ops:
  the oracle the plan and apply are held against.

No wrapper falls back from its kernel, and none sorts with a library call
on CUDA tensors. ``engine/prefix.py`` selects them with ``impl="pallas"``.
Contributions must be integer-valued float32 whose batch total stays below
2^24: then every partial sum is exact and the order of additions cannot
matter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sentinel_tpu_torch.ops._launch import check, raise_on, stream_of

LAUNCHES = {"segment_prefix_plan": 0, "segment_prefix_apply": 0}

# rows per chunk of the plain version's [rows, N] mask
_PLAIN_ROWS = 2048
_ROW_BITS = 0x7FFFFFFF


class PrefixPlan(NamedTuple):
    """``order [N] int32``: the row of sorted item ``k``, with bit 31 set
    where item ``k`` starts a run of equal keys. Items are sorted stably by
    the key's 32 bits (as unsigned), so rows of one key keep batch order."""

    order: torch.Tensor


def segment_prefix_plain(keys: torch.Tensor,
                         contrib: torch.Tensor) -> torch.Tensor:
    """``([N] int, [N] float) -> [N] float32`` by a same-key, strictly
    lower mask, ``_PLAIN_ROWS`` rows at a time."""
    n = keys.shape[0]
    c = contrib.to(torch.float32)
    j = torch.arange(n, device=keys.device)
    out = []
    for i0 in range(0, n, _PLAIN_ROWS):
        i = j[i0:i0 + _PLAIN_ROWS]
        mask = (keys[i0:i0 + _PLAIN_ROWS, None] == keys[None, :]) & (
            j[None, :] < i[:, None])
        out.append(torch.where(mask, c[None, :], 0.0).sum(dim=1))
    if not out:
        return torch.zeros((0,), dtype=torch.float32, device=keys.device)
    return torch.cat(out)


def segment_prefix_plan_plain(keys: torch.Tensor) -> PrefixPlan:
    """The plan in torch ops: a stable argsort of the key's bits (int32
    keys as unsigned, the kernel's order; wider keys by value)."""
    bits = keys.to(torch.int64)
    if keys.dtype == torch.int32:
        bits = bits & 0xFFFFFFFF
    order = torch.argsort(bits, stable=True)
    sorted_bits = bits[order]
    head = torch.ones_like(order, dtype=torch.bool)
    head[1:] = sorted_bits[1:] != sorted_bits[:-1]
    packed = torch.where(head, order - 2**31, order)  # bit 31 at a head
    return PrefixPlan(packed.to(torch.int32))


def segment_prefix_apply_plain(plan: PrefixPlan,
                               contrib: torch.Tensor) -> torch.Tensor:
    """The apply in torch ops: gather in sorted order, exclusive cumsum less
    the value at the run's head, scatter back."""
    p = plan.order.to(torch.int64)
    rows = p & _ROW_BITS
    head = p < 0
    c = contrib.to(torch.float32)[rows]
    excl = torch.cumsum(c, dim=0) - c
    run = torch.cumsum(head.to(torch.int64), dim=0) - 1
    out = torch.empty_like(c)
    out[rows] = excl - excl[head][run]
    return out


def _lib():
    from sentinel_tpu_torch.ops import _build

    lib = _build.load("prefix")
    if lib.sentinel_prefix_apply.argtypes is None:
        for fn in (lib.sentinel_prefix_plan_work,
                   lib.sentinel_prefix_apply_work):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_longlong
        lib.sentinel_prefix_plan.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_longlong, ctypes.c_void_p])
        lib.sentinel_prefix_plan.restype = ctypes.c_int
        lib.sentinel_prefix_apply.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_void_p])
        lib.sentinel_prefix_apply.restype = ctypes.c_int
    return lib


def _workspace(words: int, device) -> torch.Tensor:
    return torch.empty((max(1, words),), dtype=torch.int32, device=device)


def segment_prefix_plan(keys: torch.Tensor) -> PrefixPlan:
    """The plan kernel's wrapper: ``[N] int32 keys -> PrefixPlan``.

    CPU tensors run :func:`segment_prefix_plan_plain`. CUDA tensors launch
    the kernel (keys must be int32 and contiguous) or raise."""
    device = keys.device
    if device.type == "cpu":
        return segment_prefix_plan_plain(keys)
    if device.type != "cuda":
        raise ValueError(f"segment_prefix_plan: unsupported device {device}")
    n = keys.shape[0]
    check("segment_prefix_plan", "keys", keys, torch.int32, (n,), device)
    order = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return PrefixPlan(order)
    lib = _lib()
    words = lib.sentinel_prefix_plan_work(n)
    work = _workspace(words, device)
    err = lib.sentinel_prefix_plan(keys.data_ptr(), n, order.data_ptr(),
                                   work.data_ptr(), words, stream_of(device))
    raise_on("segment_prefix_plan", err)
    LAUNCHES["segment_prefix_plan"] += 1
    return PrefixPlan(order)


def segment_prefix_apply(plan: PrefixPlan,
                         contrib: torch.Tensor) -> torch.Tensor:
    """The apply kernel's wrapper: ``(PrefixPlan, [N] float-like) -> [N]
    float32``.

    CPU tensors run :func:`segment_prefix_apply_plain`. CUDA tensors launch
    the kernel or raise."""
    order = plan.order
    device = order.device
    if device.type == "cpu":
        return segment_prefix_apply_plain(plan, contrib)
    if device.type != "cuda":
        raise ValueError(f"segment_prefix_apply: unsupported device {device}")
    n = order.shape[0]
    check("segment_prefix_apply", "plan", order, torch.int32, (n,), device)
    c = contrib.to(torch.float32).contiguous()
    check("segment_prefix_apply", "contrib", c, torch.float32, (n,), device)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = _lib()
    words = lib.sentinel_prefix_apply_work(n)
    work = _workspace(words, device)
    err = lib.sentinel_prefix_apply(order.data_ptr(), c.data_ptr(),
                                    out.data_ptr(), n, work.data_ptr(), words,
                                    stream_of(device))
    raise_on("segment_prefix_apply", err)
    LAUNCHES["segment_prefix_apply"] += 1
    return out


def segment_prefix(keys: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """``([N] int32, [N] float-like) -> [N] float32``: one plan, one apply
    (each its kernel on CUDA tensors, its plain version on CPU tensors)."""
    return segment_prefix_apply(segment_prefix_plan(keys), contrib)
