"""Batched decision engine of the port (counterpart of
``sentinel_tpu.engine``).

The step functions live in :mod:`sentinel_tpu_torch.engine.decide`; unlike
the reference package this one does not re-export a ``decide`` function, so
the submodule name is never shadowed.
"""

from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.rules import (
    ClusterFlowRule,
    ControlBehavior,
    DegradeRule,
    DegradeStrategy,
    RuleTable,
    ThresholdMode,
    build_rule_table,
    drain_pending_clear,
)
from sentinel_tpu_torch.engine.state import EngineState, make_state

__all__ = [
    "ClusterFlowRule",
    "ControlBehavior",
    "DegradeRule",
    "DegradeStrategy",
    "EngineConfig",
    "EngineState",
    "RuleTable",
    "ThresholdMode",
    "build_rule_table",
    "drain_pending_clear",
    "make_state",
]
