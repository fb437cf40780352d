"""Server-side overload protection: deadline-aware admission + shedding.

The port's copy of ``sentinel_tpu/overload/__init__.py``.

See :mod:`sentinel_tpu_torch.overload.admission` for the BBR-style controller and
the brownout ladder, and ``docs/ROBUSTNESS.md`` for the operational model.
"""

from sentinel_tpu_torch.overload.admission import (
    AdmissionController,
    BrownoutLevel,
    OverloadConfig,
    parse_shares,
)

__all__ = [
    "AdmissionController",
    "BrownoutLevel",
    "OverloadConfig",
    "parse_shares",
]
