"""Sketch variants of the hot-param plane (port of the decide-path half of
``sentinel_tpu/sketch/__init__.py``).

``ParamConfig.sketch`` selects the fat (update) sketch: ``"cms"`` (int32
count-min) or ``"salsa"`` (:mod:`sentinel_tpu_torch.sketch.salsa`, int16
self-adjusting counters at the same bytes); ``ParamConfig.impl``
independently selects the kernel or the torch ops. The slim twin
(:mod:`sentinel_tpu_torch.sketch.slim`) composes around either variant.
"""

from __future__ import annotations

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
