"""The exclusive segment prefix over ungrouped keys as a hand-written CUDA
kernel (port of ``sentinel_tpu/ops/prefix_pallas.py``):
``out[i] = sum(contrib[j] for j < i if keys[j] == keys[i])``.

- :func:`segment_prefix` — the kernel's wrapper. On CUDA tensors it
  launches ``csrc/prefix.cu`` and adds one to
  ``LAUNCHES["segment_prefix"]``; on CPU tensors it runs
  :func:`segment_prefix_plain`. It never falls back from the kernel.
- :func:`segment_prefix_plain` — the same masked sum in torch ops.

``engine/prefix.py`` selects it with ``impl="pallas"``. Contributions must
be non-negative integer-valued float32 whose batch total stays below 2^24:
then every partial sum is exact and the order of additions cannot matter.
"""

from __future__ import annotations

import ctypes

import torch

from sentinel_tpu_torch.ops._launch import check, raise_on, stream_of

LAUNCHES = {"segment_prefix": 0}

# rows per chunk of the plain version's [rows, N] mask
_PLAIN_ROWS = 2048


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


def _kernel_lib():
    from sentinel_tpu_torch.ops import _build

    fn = _build.load("prefix").sentinel_segment_prefix
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def segment_prefix(keys: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: ``([N] int32, [N] float-like) -> [N] float32``.

    CPU tensors run :func:`segment_prefix_plain`. CUDA tensors launch the
    kernel (keys must be int32 and contiguous) or raise."""
    device = keys.device
    if device.type == "cpu":
        return segment_prefix_plain(keys, contrib)
    if device.type != "cuda":
        raise ValueError(f"segment_prefix: unsupported device {device}")
    n = keys.shape[0]
    check("segment_prefix", "keys", keys, torch.int32, (n,), device)
    c = contrib.to(torch.float32).contiguous()
    check("segment_prefix", "contrib", c, torch.float32, (n,), device)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return out
    err = _kernel_lib()(keys.data_ptr(), c.data_ptr(), out.data_ptr(), n,
                        stream_of(device))
    raise_on("segment_prefix", err)
    LAUNCHES["segment_prefix"] += 1
    return out
