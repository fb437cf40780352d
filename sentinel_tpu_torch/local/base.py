"""Local-engine fundamentals: block exceptions, resource identity, constants
(the port's copy of ``sentinel_tpu/local/base.py``).

Analogs: ``BlockException`` hierarchy (``sentinel-core/.../slots/block/*``),
``ResourceWrapper``/``EntryType`` (``slotchain/``), order constants
(``Constants.java:76-83``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class EntryType(enum.Enum):
    IN = "IN"  # inbound traffic — subject to system-adaptive protection
    OUT = "OUT"


class BlockException(Exception):
    """Base for all flow-control verdict exceptions (``BlockException.java``)."""

    def __init__(self, rule_limit_app: str = "", message: str = "", rule: Any = None):
        super().__init__(message or self.__class__.__name__)
        self.rule_limit_app = rule_limit_app
        self.rule = rule


class FlowException(BlockException):
    pass


class DegradeException(BlockException):
    pass


class SystemBlockException(BlockException):
    def __init__(self, resource_name: str, limit_type: str):
        super().__init__(message=f"SystemBlock: {limit_type}")
        self.resource_name = resource_name
        self.limit_type = limit_type


class AuthorityException(BlockException):
    pass


class ParamFlowException(BlockException):
    def __init__(self, resource_name: str = "", message: str = "", rule: Any = None):
        super().__init__(message=message or "ParamFlowException", rule=rule)
        self.resource_name = resource_name


class PriorityWaitException(Exception):
    """Internal signal: prioritized request borrowed a future window and already
    waited; it passes without counting a new PASS (``PriorityWaitException.java``,
    handled at ``StatisticSlot.java:77-86``)."""

    def __init__(self, wait_ms: int):
        super().__init__(f"wait {wait_ms}ms")
        self.wait_ms = wait_ms


@dataclass(frozen=True)
class ResourceWrapper:
    """Resource identity: name + direction (``slotchain/ResourceWrapper.java``).

    Equality/hash are by name only, matching the reference (``ResourceWrapper
    .equals`` compares name) so one chain/node exists per name.
    """

    name: str
    entry_type: EntryType = EntryType.OUT

    def __eq__(self, other):
        return isinstance(other, ResourceWrapper) and self.name == other.name

    def __hash__(self):
        return hash(self.name)


# Slot order constants (reference Constants.java:76-83); smaller runs earlier.
ORDER_NODE_SELECTOR_SLOT = -10000
ORDER_CLUSTER_BUILDER_SLOT = -9000
ORDER_LOG_SLOT = -8000
ORDER_STATISTIC_SLOT = -7000
ORDER_AUTHORITY_SLOT = -6000
ORDER_SYSTEM_SLOT = -5000
ORDER_GATEWAY_FLOW_SLOT = -4000
ORDER_PARAM_FLOW_SLOT = -3000
ORDER_FLOW_SLOT = -2000
ORDER_DEGRADE_SLOT = -1000

# reference Constants.java:37 — beyond this many distinct resources, entries
# pass through unguarded rather than allocating more chains.
MAX_SLOT_CHAIN_SIZE = 6000

TOTAL_IN_RESOURCE_NAME = "__total_inbound_traffic__"  # Constants.TOTAL_IN_RESOURCE_NAME
CONTEXT_DEFAULT_NAME = "sentinel_default_context"
LIMIT_APP_DEFAULT = "default"
LIMIT_APP_OTHER = "other"
