"""SALSA self-adjusting counters for the param sketch (port of
``sentinel_tpu/sketch/salsa.py``; arXiv:2102.12531).

Same bytes as the int32 count-min, twice the cells: ``counts`` is
``[P, B, depth, 2*width]`` int16. When a cell saturates it merges with its
pair neighbour into one double-width counter. The merge state is in-band:

- unmerged pair ``(2p, 2p+1)``: two int16 counters, each kept at or below
  ``SAT`` by merge-after-batch;
- merged pair: the value ``v`` is split as ``cells[2p] = v % CAP`` and
  ``cells[2p+1] = -(v // CAP) - 1``; the negative high half is the merge
  flag, with ``CAP * 32767`` (~134M) of headroom.

A merge stores the max of the two cells (each an upper bound of its own key
set), so no key undercounts; a bucket roll zeroes int16 cells into unmerged
zeros.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LOGCAP = 12
CAP = 1 << LOGCAP  # low-half radix of a merged pair
SAT = 1 << 14  # merge threshold: cell > SAT after a batch -> merge its pair
MERGE_CEIL = CAP * 32767 - 1  # merged-pair clamp (~134M)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[..., W], [..., W] -> [..., 2W] with even/odd lanes restored."""
    return torch.stack([even, odd], dim=-1).reshape(
        even.shape[:-1] + (even.shape[-1] * 2,)
    )


def decode_plane(cells: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., 2W] int16 -> (dec [..., 2W] int32, merged [..., W] bool)``.

    Accumulation form: a merged pair carries its whole value at the EVEN
    cell (the odd cell decodes to 0), so routed adds land in one place.
    """
    c = cells.to(torch.int32)
    lo, hi = c[..., 0::2], c[..., 1::2]
    merged = hi < 0
    mval = lo + CAP * (-hi - 1)
    even = torch.where(merged, mval, lo)
    odd = torch.where(merged, 0, hi)
    return _interleave(even, odd), merged


def encode_plane(dec: torch.Tensor,
                 merged: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`decode_plane` plus merge-on-saturation:
    ``-> (cells int16, newly_merged [..., W] bool)``. An unmerged pair with
    either side above ``SAT`` merges, taking the max of the two."""
    ev, od = dec[..., 0::2], dec[..., 1::2]
    newly = (~merged) & ((ev > SAT) | (od > SAT))
    m2 = merged | newly
    val = torch.where(newly, torch.maximum(ev, od), ev)
    val = torch.clamp_max(val, MERGE_CEIL)
    lo16 = torch.where(m2, val % CAP, ev).to(torch.int16)
    hi16 = torch.where(m2, -(val // CAP) - 1, od).to(torch.int16)
    return _interleave(lo16, hi16), newly


def decode_cells_np(cells: np.ndarray) -> np.ndarray:
    """Host mirror for export paths: ``[..., 2W] int16 -> [..., 2W] int32``
    per-cell query values (both cells of a merged pair read the merged
    value, what a gather at either index sees)."""
    c = cells.astype(np.int64)
    lo, hi = c[..., 0::2], c[..., 1::2]
    merged = hi < 0
    mval = lo + CAP * (-hi - 1)
    even = np.where(merged, mval, lo)
    odd = np.where(merged, mval, hi)
    out = np.empty(c.shape, np.int32)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def salsa_decide_jax(config, state, rule_slot, idx, acquire, threshold,
                     valid, now):
    """The torch-ops core over the SALSA encoding (the reference's XLA
    core, op for op; see :func:`sentinel_tpu_torch.ops.salsa_cuda.
    salsa_decide_update_plain`). ``state`` is updated in place."""
    from sentinel_tpu_torch.ops.salsa_cuda import salsa_decide_update_plain

    admit, est = salsa_decide_update_plain(
        state.counts, state.starts, state.merges, rule_slot, idx, acquire,
        threshold, valid, now, config.bucket_ms,
    )
    return state, admit, est


def salsa_decide_kernel(config, state, rule_slot, idx, acquire, threshold,
                        valid, now):
    """The same contract through the CUDA kernel's wrapper."""
    from sentinel_tpu_torch.ops.salsa_cuda import salsa_decide_update

    admit, est = salsa_decide_update(
        state.counts, state.starts, state.merges, rule_slot, idx, acquire,
        threshold, valid, now, config.bucket_ms,
    )
    return state, admit, est
