"""Exclusive segment-prefix sum over batch order (port of
``sentinel_tpu/engine/prefix.py``).

``prefix(contrib)[i] = sum(contrib[j] for j < i if keys[j] == keys[i])``.

- ``grouped``: keys already grouped (same-key rows contiguous); a global
  cumsum minus the segment base propagated by a running max. The serving
  path. Exact while the batch-wide total stays below 2^24.
- ``matmul``: same-key strictly-lower mask @ contrib. Needs full float32
  products: the builder turns TF32 off for CUDA matmuls
  (``torch.backends.cuda.matmul.allow_tf32 = False`` and
  ``torch.set_float32_matmul_precision("highest")``), the counterpart of the
  reference's ``Precision.HIGHEST``.
- ``sort``: one stable argsort per builder, then the grouped prefix.
- ``pallas``: the reference's tiled prefix kernel, ported as two CUDA
  kernels (``ops/prefix_cuda.py``; their plain versions on CPU tensors):
  one plan per builder (a stable sort of the keys), one O(N) apply per call.

Contributions must be non-negative integer-valued float32.
"""

from __future__ import annotations

import torch

from sentinel_tpu_torch.ops.scan import blocked_cummax, blocked_cumsum

_IMPLS = ("matmul", "sort", "grouped", "pallas")


def _grouped_prefix(keys: torch.Tensor):
    """Prefix fn for keys whose equal values are contiguous in batch order."""
    seg_start = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=keys.device),
        keys[1:] != keys[:-1],
    ])

    def prefix(c: torch.Tensor) -> torch.Tensor:
        c = c.to(torch.float32)
        incl = blocked_cumsum(c)
        excl = incl - c
        # exclusive sum at this row's segment head, carried forward by a
        # running max (contribs >= 0 keep excl non-decreasing)
        base = blocked_cummax(torch.where(seg_start, excl, -1.0))
        return excl - base

    return prefix


def segment_prefix_builder(keys: torch.Tensor, impl: str = "auto"):
    """Returns ``prefix(contrib)`` for the key vector ``keys``."""
    n = keys.shape[0]
    if impl == "auto":
        impl = "matmul" if n <= 2048 else "sort"
    if impl not in _IMPLS:
        raise ValueError(
            f"unknown prefix_impl {impl!r}; use 'auto' or one of {_IMPLS}"
        )

    if impl == "grouped":
        return _grouped_prefix(keys)

    if impl == "pallas":
        from sentinel_tpu_torch.ops import prefix_cuda

        plan = prefix_cuda.segment_prefix_plan(
            keys.to(torch.int32).contiguous())

        def prefix_kernel(contrib: torch.Tensor) -> torch.Tensor:
            return prefix_cuda.segment_prefix_apply(plan, contrib)

        return prefix_kernel

    if impl == "matmul":
        if keys.device.type == "cuda":
            # exact integer counts need full float32 products, not TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        i = torch.arange(n, device=keys.device)
        tri = i[:, None] > i[None, :]
        mat = ((keys[:, None] == keys[None, :]) & tri).to(torch.float32)

        def prefix_mat(contrib: torch.Tensor) -> torch.Tensor:
            return torch.matmul(mat, contrib.to(torch.float32))

        return prefix_mat

    # -- sort: one stable argsort per builder, shared by every call --------
    order = torch.argsort(keys, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=keys.device)
    grouped = _grouped_prefix(keys[order])

    def prefix_sort(contrib: torch.Tensor) -> torch.Tensor:
        return grouped(contrib[order])[inv]

    return prefix_sort
