"""Local (in-process) engine: the sentinel-core analog (the port's copy of
``sentinel_tpu/local``). A cluster-mode rule asks the token service that
``sentinel_tpu_torch.cluster.api`` holds: an embedded one on the card, or a
client of token servers.

Importing this package wires the default slot set (the reference does this via
``Env`` static init → ``InitExecutor.doInit`` → SPI; here the module imports
below register each slot in order — the same extension seam, minus classpath
scanning).

Public API::

    from sentinel_tpu_torch import local as sentinel
    from sentinel_tpu_torch.local import FlowRule, FlowRuleManager, BlockException

    FlowRuleManager.load_rules([FlowRule(resource="hello", count=20)])
    try:
        with sentinel.entry("hello"):
            serve()
    except BlockException:
        fallback()
"""

# Slot registration order is by the order constants, not import order.
from sentinel_tpu_torch.local import chain as _chain  # core slots
from sentinel_tpu_torch.local import authority as _authority  # noqa: F401
from sentinel_tpu_torch.local import system_adaptive as _system  # noqa: F401
from sentinel_tpu_torch.local import param as _param  # noqa: F401
from sentinel_tpu_torch.local import flow as _flow  # noqa: F401
from sentinel_tpu_torch.local import degrade as _degrade  # noqa: F401

from sentinel_tpu_torch.local.base import (
    AuthorityException,
    BlockException,
    DegradeException,
    EntryType,
    FlowException,
    ParamFlowException,
    ResourceWrapper,
    SystemBlockException,
)
from sentinel_tpu_torch.local.authority import (
    AuthorityRule,
    AuthorityRuleManager,
    AuthorityStrategy,
)
from sentinel_tpu_torch.local.context import enter as enter_context, exit as exit_context
from sentinel_tpu_torch.local.degrade import (
    CircuitBreaker,
    DegradeGrade,
    DegradeRule,
    DegradeRuleManager,
    State as CircuitBreakerState,
    register_state_change_observer,
)
from sentinel_tpu_torch.local.flow import (
    ControlBehavior,
    FlowGrade,
    FlowRule,
    FlowRuleManager,
    FlowStrategy,
)
from sentinel_tpu_torch.local.param import (
    ParamFlowItem,
    ParamFlowRule,
    ParamFlowRuleManager,
)
from sentinel_tpu_torch.local.sph import Entry, entry, sph, trace, try_entry
from sentinel_tpu_torch.local.system_adaptive import SystemRule, SystemRuleManager

__all__ = [
    "entry",
    "try_entry",
    "trace",
    "Entry",
    "sph",
    "enter_context",
    "exit_context",
    "EntryType",
    "ResourceWrapper",
    "BlockException",
    "FlowException",
    "DegradeException",
    "SystemBlockException",
    "AuthorityException",
    "ParamFlowException",
    "FlowRule",
    "FlowRuleManager",
    "FlowGrade",
    "FlowStrategy",
    "ControlBehavior",
    "DegradeRule",
    "DegradeRuleManager",
    "DegradeGrade",
    "CircuitBreaker",
    "CircuitBreakerState",
    "register_state_change_observer",
    "SystemRule",
    "SystemRuleManager",
    "AuthorityRule",
    "AuthorityRuleManager",
    "AuthorityStrategy",
    "ParamFlowRule",
    "ParamFlowItem",
    "ParamFlowRuleManager",
]


def reset_for_tests() -> None:
    """Full local-engine reset (ContextTestUtil analog)."""
    from sentinel_tpu_torch.local import chain, context
    from sentinel_tpu_torch.local.sph import sph as _sph

    FlowRuleManager.reset_for_tests()
    ParamFlowRuleManager.reset_for_tests()
    DegradeRuleManager.reset_for_tests()
    SystemRuleManager.reset_for_tests()
    AuthorityRuleManager.reset_for_tests()
    chain.reset_cluster_nodes_for_tests()
    chain.reset_entry_node_for_tests()
    context.reset_for_tests()
    _sph().reset_for_tests()
    from sentinel_tpu_torch.local.sph import set_enabled as _set_enabled

    _set_enabled(True)
