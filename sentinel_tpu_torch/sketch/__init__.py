"""Sketch variants of the hot-param plane (port of
``sentinel_tpu/sketch/__init__.py``).

``ParamConfig.sketch`` selects the fat (update) sketch: ``"cms"`` (int32
count-min) or ``"salsa"`` (:mod:`sentinel_tpu_torch.sketch.salsa`, int16
self-adjusting counters at the same bytes); ``ParamConfig.impl``
independently selects the kernel or the torch ops. The slim twin
(:mod:`sentinel_tpu_torch.sketch.slim`) composes around either variant.

Besides the decide path's current-bucket gather, this module holds what the
service needs outside the kernels: the host decode of exported cells, the
MOVE import's fold into the current bucket, and the metrics snapshot.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

VARIANTS = ("cms", "salsa")


def gather_current_estimate(config, counts, rule_slot, idx,
                            cur_idx: int) -> torch.Tensor:
    """``[N] int32`` per-request fat estimate over the CURRENT bucket only
    (min over lanes), decoding in flight for SALSA."""
    from sentinel_tpu_torch.sketch.salsa import CAP

    safe = torch.where(rule_slot >= 0, rule_slot, 0).to(torch.int64)
    d_ar = torch.arange(config.depth, device=counts.device)[None, :]
    idx_l = idx.to(torch.int64)
    if config.sketch == "salsa":
        pair = (idx_l // 2) * 2
        lo = counts[safe[:, None], cur_idx, d_ar, pair].to(torch.int32)
        hi = counts[safe[:, None], cur_idx, d_ar, pair + 1].to(torch.int32)
        merged = hi < 0
        mval = lo + CAP * (-hi - 1)
        own = torch.where(idx_l % 2 == 0, lo, hi)
        per_d = torch.where(merged, mval, own)
    else:
        per_d = counts[safe[:, None], cur_idx, d_ar, idx_l]
    return torch.min(per_d, dim=1).values


def decoded_counts_np(config, counts) -> np.ndarray:
    """Host view of fat cells (a tensor or an array) as per-cell *query*
    values: the identity for count-min, the pairwise decode for SALSA (both
    cells of a merged pair read the merged value). Exports sum these, so
    the wire document is plain int sums whatever the encoding."""
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    if config.sketch == "salsa":
        from sentinel_tpu_torch.sketch.salsa import decode_cells_np

        return decode_cells_np(np.asarray(counts))
    return np.asarray(counts)


def fold_param_sums(config, state, now: int, rows, sums):
    """Add imported per-cell window sums (``[R, depth, cells]``) into the
    current bucket of rows ``rows`` of the param plane, in place; returns
    ``state``.

    A stale current bucket rotates first (its fat and slim columns zeroed,
    its slim authority dropped, its start stamped), checked on the device:
    no host scalar is written into a device tensor. For SALSA the add
    happens in decoded space (a merged pair takes both cells' sums into its
    joint counter, the union bound) and the touched rows re-encode with the
    usual merge on saturation, counted into ``state.merges``: the plane
    stays one the encoder produced, which ``csrc/salsa.cu``'s touched-pairs
    re-encode needs."""
    from sentinel_tpu_torch.engine.decide import host_to_device
    from sentinel_tpu_torch.sketch.salsa import CAP, MERGE_CEIL, SAT

    idx = int((now // config.bucket_ms) % config.n_buckets)
    aligned = int(now - now % config.bucket_ms)
    keep = state.starts[idx] == aligned
    state.counts[:, idx].mul_(keep.to(state.counts.dtype))
    if config.slim_enabled:
        state.slim[:, idx].mul_(keep.to(state.slim.dtype))
    state.slim_auth[idx].logical_and_(keep)
    state.starts[idx].fill_(aligned)
    if rows is None or not len(rows):
        return state
    dev = state.counts.device
    rows_d = host_to_device(np.asarray(rows, np.int64), dev)
    sums_d = host_to_device(np.asarray(sums, np.int64), dev)
    plane = state.counts[:, idx]  # a view: [P, D, cells]
    if config.sketch != "salsa":
        plane.index_add_(0, rows_d, sums_d.to(torch.int32))
        return state
    c = plane.index_select(0, rows_d).to(torch.int64)
    lo, hi = c[..., 0::2], c[..., 1::2]
    merged = hi < 0
    mval = lo + CAP * (-hi - 1)
    ev = torch.where(merged, mval, lo)
    od = torch.where(merged, 0, hi)
    add_ev, add_od = sums_d[..., 0::2], sums_d[..., 1::2]
    ev_r = ev + torch.where(merged, add_ev + add_od, add_ev)
    od_r = od + torch.where(merged, 0, add_od)
    newly = (~merged) & ((ev_r > SAT) | (od_r > SAT))
    m2 = merged | newly
    val = torch.where(newly, torch.maximum(ev_r, od_r), ev_r)
    val = torch.clamp_max(val, MERGE_CEIL)
    lo16 = torch.where(m2, val % CAP, ev_r).to(torch.int16)
    hi16 = torch.where(m2, -(val // CAP) - 1, od_r).to(torch.int16)
    new_rows = torch.stack([lo16, hi16], dim=-1).reshape(c.shape)
    plane.index_copy_(0, rows_d, new_rows)
    state.merges.index_add_(
        0, rows_d, newly.sum(dim=(1, 2)).to(torch.int32))
    return state


def sketch_stats(config, state) -> Dict[str, object]:
    """Host snapshot for the ``sketch`` observability block
    (``clusterServerStats``, the scrape): variant, fat and slim bytes, SALSA
    merge counters (one read of the ``[P]`` merge column)."""
    merges = state.merges.cpu().numpy()
    nz = np.nonzero(merges)[0]

    def nbytes(t: torch.Tensor) -> int:
        return int(t.numel() * t.element_size())

    return {
        "variant": config.sketch,
        "fatBytes": nbytes(state.counts),
        "slimBytes": nbytes(state.slim) if config.slim_enabled else 0,
        "slimEnabled": bool(config.slim_enabled),
        "mergesTotal": int(merges.sum()),
        "mergesBySlot": {int(s): int(merges[s]) for s in nz},
    }
