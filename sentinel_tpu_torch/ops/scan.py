"""Cumulative sums and maxes along the batch axis (port of
``sentinel_tpu/ops/scan_mm.py``).

The reference builds them from blocked triangular matmuls because XLA's 1-D
scan is slow on the TPU; off the TPU it calls ``jnp.cumsum`` /
``lax.cummax`` itself (``scan_mm.py:34,68``). The port takes ``torch.cumsum``
and ``torch.cummax`` on every device. The names are kept so the callers read
like the reference. Exact for integer-valued float32 inputs whose totals
stay below 2^24.
"""

from __future__ import annotations

import torch


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumsum along axis 0 of ``[N]`` or ``[N, K]``."""
    return torch.cumsum(x.to(torch.float32), dim=0)


def blocked_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 running max along axis 0 of ``[N]``."""
    return torch.cummax(x.to(torch.float32), dim=0).values
