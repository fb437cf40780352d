"""Slim twin of the fat param sketch (port of the decide-path half of
``sentinel_tpu/sketch/slim.py``; SF-sketch, arXiv:1701.04148).

The fat sketch (count-min or SALSA) takes every update; the twin,
``slim[P, B, slim_depth, slim_width]`` int32, is what replication deltas
ship. Whenever a value is touched, the fat sketch's post-update
current-bucket estimate of that value is scatter-max'd into the value's slim
cells, so every slim cell holds the max over its colliding values of an
upper bound and the windowed slim estimate never undercounts.

A standby flags the buckets whose slim rows arrived by delta
(``ParamState.slim_auth``) and serves ``fat + slim(auth buckets)``; on a
primary no flag is set and the slim estimate is 0.

Both steps update the state in place.
"""

from __future__ import annotations

import numpy as np
import torch

from sentinel_tpu_torch.ops.cms_cuda import bucket_ok, ring

# lane-constant offset of the twin's host hash: slim lanes come from a part
# of the splitmix sequence no plausible fat depth reaches
SLIM_SALT = 64


def slim_indices(config, value_hashes: np.ndarray) -> np.ndarray:
    """``[N] int64 -> [N, slim_depth] int32`` twin cell indices (host)."""
    from sentinel_tpu_torch.engine.param import hash_indices

    return hash_indices(
        value_hashes, config.slim_depth, config.slim_width, salt=SLIM_SALT
    )


def slim_prestep(config, state, rule_slot, idx_slim, now: int) -> torch.Tensor:
    """Roll the slim ring for the current bucket (a stale bucket is a new
    window bucket: its slim column is zeroed and its authority dropped) and
    return the per-request slim estimate ``[N] int32`` over authoritative
    live buckets. Reads the fat ring's starts before the core rolls them."""
    now = int(now)
    B = config.n_buckets
    cur, cur_start = ring(now, config.bucket_ms, B)
    keep = state.starts[cur] == cur_start
    state.slim[:, cur].mul_(keep.to(torch.int32))
    state.slim_auth[cur] = state.slim_auth[cur] & keep

    starts = state.starts.clone()
    starts[cur] = cur_start
    use = bucket_ok(starts, now, config.interval_ms) * \
        state.slim_auth.to(torch.int32)  # [B]

    safe = torch.where(rule_slot >= 0, rule_slot, 0).to(torch.int64)
    ds_ar = torch.arange(config.slim_depth, device=state.slim.device)[None, :]
    idx_l = idx_slim.to(torch.int64)
    sums = sum(state.slim[safe[:, None], b, ds_ar, idx_l] * use[b]
               for b in range(B))  # [N, Ds]
    est_slim = torch.min(sums, dim=1).values
    return torch.where(rule_slot >= 0, est_slim, 0)


def slim_poststep(config, state, rule_slot, idx, idx_slim, valid,
                  now: int) -> None:
    """Scatter-max each touched value's post-update current-bucket fat
    estimate into its slim cells. ``state`` is the post-core state. The max
    is order-independent, so the result is exact on any device."""
    from sentinel_tpu_torch.sketch import gather_current_estimate

    cur, _ = ring(int(now), config.bucket_ms, config.n_buckets)
    est_cur = gather_current_estimate(config, state.counts, rule_slot, idx,
                                      cur)  # [N] int32
    live = valid & (rule_slot >= 0)
    safe = torch.where(rule_slot >= 0, rule_slot, 0).to(torch.int64)
    Ds, Ws = config.slim_depth, config.slim_width
    ds_ar = torch.arange(Ds, device=state.slim.device)[None, :]
    vals = torch.where(live, est_cur, 0)[:, None].expand(-1, Ds)
    flat = ((safe[:, None] * config.n_buckets + cur) * Ds + ds_ar) * Ws \
        + idx_slim.to(torch.int64)
    state.slim.view(-1).scatter_reduce_(0, flat.reshape(-1),
                                        vals.reshape(-1), reduce="amax")
