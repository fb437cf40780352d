"""Static engine geometry (copy of ``sentinel_tpu/engine/config.py``).

Rule *contents* are dynamic, sizes are not: every state tensor is allocated
from these numbers.
"""

from __future__ import annotations

from typing import NamedTuple


class EngineConfig(NamedTuple):
    """Sizes for the device tensors.

    Defaults mirror the reference cluster server: 1s interval / 10 buckets
    (``ServerFlowConfig.java:29-30``), 30k default namespace guard
    (``ServerFlowConfig.java:31``).
    """

    max_flows: int = 4096  # rule slots (F)
    max_namespaces: int = 64  # NS
    batch_size: int = 1024  # N — requests per device step
    bucket_ms: int = 100
    n_buckets: int = 10
    max_occupy_ratio: float = 1.0  # ServerFlowConfig.maxOccupyRatio
    exceed_count: float = 1.0  # ServerFlowConfig.exceedCount
    # in-batch prefix refinement passes — MUST be odd (odd counts keep the
    # admission mask a subset of the sequential-greedy set)
    admission_refine_iters: int = 3
    # segment-prefix implementation for non-grouped batches: "matmul",
    # "sort", "auto" (matmul ≤ 2048 rows, sort above) or "pallas" (the
    # CUDA segment-prefix kernel, ops/prefix_cuda.py). Grouped host batches
    # always take the "grouped" prefix.
    prefix_impl: str = "auto"
    # decision-step backend: "pallas" runs grouped batches through the
    # hand-written CUDA kernel (ops/decide_cuda.py + csrc/decide.cu); "auto"
    # picks the kernel on CUDA tensors and the torch-ops pipeline elsewhere;
    # "xla" always runs the torch-ops pipeline (engine/decide._decide_core).
    # Non-grouped batches always take the torch-ops pipeline.
    decide_impl: str = "auto"

    @property
    def interval_ms(self) -> int:
        return self.bucket_ms * self.n_buckets
