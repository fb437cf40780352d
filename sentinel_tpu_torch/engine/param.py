"""Hot-parameter counting as a windowed count-min sketch (port of
``sentinel_tpu/engine/param.py``).

The reference server bounds per-value cardinality with LRU maps (4,000
values per bucket, 200k per resource: ``ParameterMetric.java:37-39``,
``ClusterParamMetric.java:37``), which undercounts evicted keys. Here each
(rule, time bucket) holds a count-min sketch: fixed memory, and it
over-estimates, the safe direction for rate limiting.

Shapes: ``counts[P, B, depth, width]`` int32 (``"cms"``) or
``[P, B, depth, 2*width]`` int16 (``"salsa"``, :mod:`sentinel_tpu_torch.
sketch.salsa`): P param-rule slots, B time buckets on one shared ring.
Hash indices are computed on the host from the application's 64-bit value
hash, so the device step is gather, prefix admission and scatter.

Port notes:

- :func:`param_decide` updates the state **in place** and returns it (the
  reference returns a new state); callers that need the old state copy it
  first.
- ``ParamConfig.impl``: ``"pallas"`` runs the hand-written CUDA kernels
  (``ops/cms_cuda.py``, ``ops/salsa_cuda.py``); ``"jax"`` runs the torch-ops
  core; ``"auto"`` takes the kernel on CUDA tensors and the torch ops
  elsewhere. The reference's timing probe is not carried over: the kernel
  is chosen by the device, never because it failed.
- ``now`` is a host ``int`` (engine ms).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device

# Mixing constants for the host-side index derivation (splitmix64 finalizer
# per depth lane, a public-domain construction).
_MIX = np.uint64(0x9E3779B97F4A7C15)
_FIN1 = np.uint64(0xBF58476D1CE4E5B9)
_FIN2 = np.uint64(0x94D049BB133111EB)

NEVER = -(2**30)


def hash_indices(
    value_hashes: np.ndarray, depth: int, width: int, salt: int = 0
) -> np.ndarray:
    """``[N] int64 -> [N, depth] int32`` sketch cell indices (host).

    ``salt`` offsets the lane constants so an auxiliary sketch (the slim
    twin) draws its lanes from a disjoint part of the splitmix sequence.
    """
    h = value_hashes.astype(np.uint64)
    with np.errstate(over="ignore"):
        lane = np.arange(salt + 1, salt + depth + 1, dtype=np.uint64) * _MIX
        x = h[:, None] + lane[None, :]
        x = (x ^ (x >> np.uint64(30))) * _FIN1
        x = (x ^ (x >> np.uint64(27))) * _FIN2
        x = x ^ (x >> np.uint64(31))
        return (x % np.uint64(width)).astype(np.int32)


class ParamConfig(NamedTuple):
    max_param_rules: int = 256  # P
    depth: int = 2
    width: int = 2048
    bucket_ms: int = 500
    n_buckets: int = 2  # a 1 s sliding window, like the local second-level
    # "pallas" = the CUDA kernels; "jax" = the torch-ops core; "auto" = the
    # kernel on CUDA tensors, the torch ops elsewhere
    impl: str = "auto"
    # "cms" = plain int32 count-min; "salsa" = self-adjusting int16 counters
    # (sketch/salsa.py): 2x the cells at the same bytes
    sketch: str = "cms"
    # slim twin geometry (sketch/slim.py): [P, B, slim_depth, slim_width]
    # int32, maintained from the fat sketch; slim_width=0 disables it
    slim_depth: int = 2
    slim_width: int = 256

    @property
    def interval_ms(self) -> int:
        return self.bucket_ms * self.n_buckets

    @property
    def cell_width(self) -> int:
        """Host hash width: SALSA packs 2 int16 cells into the int32
        footprint, so its index space is ``2*width``."""
        return self.width * (2 if self.sketch == "salsa" else 1)

    @property
    def slim_enabled(self) -> bool:
        return self.slim_depth > 0 and self.slim_width > 0


class ParamState(NamedTuple):
    starts: torch.Tensor  # [B] int32 engine-ms (shared ring)
    counts: torch.Tensor  # [P, B, depth, width] int32 (cms)
    #                       [P, B, depth, 2*width] int16 (salsa)
    slim: torch.Tensor  # [P, B, slim_depth, slim_width] int32 slim twin
    slim_auth: torch.Tensor  # [B] bool: buckets whose slim rows count
    merges: torch.Tensor  # [P] int32 cumulative SALSA pair merges


def make_param_state(config: ParamConfig,
                     device: DeviceLike = None) -> ParamState:
    """A zeroed state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    P, B = config.max_param_rules, config.n_buckets
    fat = torch.int16 if config.sketch == "salsa" else torch.int32
    return ParamState(
        starts=torch.full((B,), NEVER, dtype=torch.int32, device=dev),
        counts=torch.zeros((P, B, config.depth, config.cell_width),
                           dtype=fat, device=dev),
        slim=torch.zeros((P, B, config.slim_depth, config.slim_width),
                         dtype=torch.int32, device=dev),
        slim_auth=torch.zeros((B,), dtype=torch.bool, device=dev),
        merges=torch.zeros((P,), dtype=torch.int32, device=dev),
    )


def resolve_param_impl(impl: str, device) -> str:
    """``"pallas"`` (the CUDA kernel) or ``"jax"`` (the torch-ops core) for
    tensors on ``device``; ``"auto"`` takes the kernel on CUDA."""
    if impl in ("jax", "pallas"):
        return impl
    if impl != "auto":
        raise ValueError(
            f"unknown param impl {impl!r}; use 'auto'|'jax'|'pallas'"
        )
    return "pallas" if torch.device(device).type == "cuda" else "jax"


def _core(config: ParamConfig, impl: str):
    if config.sketch == "salsa":
        from sentinel_tpu_torch.sketch import salsa

        return (salsa.salsa_decide_kernel if impl == "pallas"
                else salsa.salsa_decide_jax)
    if config.sketch == "cms":
        return _param_decide_kernel if impl == "pallas" else _param_decide_jax
    raise ValueError(
        f"unknown param sketch {config.sketch!r}; use 'cms'|'salsa'"
    )


def param_decide(
    config: ParamConfig,
    state: ParamState,
    rule_slot: torch.Tensor,  # [N] int32, -1 -> no rule
    idx: torch.Tensor,  # [N, depth] int32 cell indices
    acquire: torch.Tensor,  # [N] int32
    threshold: torch.Tensor,  # [N] float32
    valid: torch.Tensor,  # [N] bool
    now: int,
    idx_slim: Optional[torch.Tensor] = None,  # [N, slim_depth] int32
) -> Tuple[ParamState, torch.Tensor, torch.Tensor]:
    """``-> (state, admit [N] bool, estimate [N] int32)``; ``state`` is
    updated in place.

    The slim twin is composed around whichever core runs, as in the
    reference: roll the slim ring and take the slim estimate over
    delta-authoritative buckets, run the core with the threshold reduced by
    it, then scatter-max the post-update fat estimate into the twin.
    ``idx_slim=None`` skips the twin.
    """
    now = int(now)
    core = _core(config, resolve_param_impl(config.impl,
                                            state.counts.device))
    if idx_slim is None or not config.slim_enabled:
        return core(config, state, rule_slot, idx, acquire, threshold,
                    valid, now)
    from sentinel_tpu_torch.sketch.slim import slim_poststep, slim_prestep

    est_slim = slim_prestep(config, state, rule_slot, idx_slim, now)
    thr = threshold.to(torch.float32) - est_slim.to(torch.float32)
    state, admit, est_fat = core(config, state, rule_slot, idx, acquire,
                                 thr, valid, now)
    slim_poststep(config, state, rule_slot, idx, idx_slim, valid, now)
    return state, admit, est_fat + est_slim


def _param_decide_jax(config, state, rule_slot, idx, acquire, threshold,
                      valid, now):
    """The torch-ops core (the reference's XLA core, op for op; see
    :func:`sentinel_tpu_torch.ops.cms_cuda.cms_decide_update_plain`)."""
    from sentinel_tpu_torch.ops.cms_cuda import cms_decide_update_plain

    admit, est = cms_decide_update_plain(
        state.counts, state.starts, rule_slot, idx, acquire, threshold,
        valid, now, config.bucket_ms,
    )
    return state, admit, est


def _param_decide_kernel(config, state, rule_slot, idx, acquire, threshold,
                         valid, now):
    """The same contract through the CUDA kernel's wrapper."""
    from sentinel_tpu_torch.ops.cms_cuda import cms_decide_update

    admit, est = cms_decide_update(
        state.counts, state.starts, rule_slot, idx, acquire, threshold,
        valid, now, config.bucket_ms,
    )
    return state, admit, est
