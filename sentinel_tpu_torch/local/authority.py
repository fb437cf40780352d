"""Origin-based authority (white/black list) rules (the port's copy of
``sentinel_tpu/local/authority.py``).

Analog of ``slots/block/authority/*`` — ``AuthoritySlot.java:36``,
``AuthorityRuleChecker.java:28-30``, ``AuthorityRuleManager``.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, List

from sentinel_tpu_torch.local.base import AuthorityException, ORDER_AUTHORITY_SLOT
from sentinel_tpu_torch.local.chain import ProcessorSlot, slot_registry


class AuthorityStrategy(enum.IntEnum):
    WHITE = 0
    BLACK = 1


@dataclass
class AuthorityRule:
    resource: str
    limit_app: str  # comma-separated origins
    strategy: AuthorityStrategy = AuthorityStrategy.WHITE


def pass_check(rule: AuthorityRule, origin: str) -> bool:
    """``AuthorityRuleChecker.passCheck``: empty origin or empty list passes;
    WHITE requires membership, BLACK requires absence."""
    if not origin or not rule.limit_app:
        return True
    listed = origin in {s.strip() for s in rule.limit_app.split(",")}
    if rule.strategy == AuthorityStrategy.WHITE:
        return listed
    return not listed


class AuthorityRuleManager:
    _lock = threading.RLock()
    _rules: Dict[str, List[AuthorityRule]] = {}

    @classmethod
    def load_rules(cls, rules: List[AuthorityRule]) -> None:
        new_map: Dict[str, List[AuthorityRule]] = {}
        for r in rules or []:
            if r.resource:
                new_map.setdefault(r.resource, []).append(r)
        with cls._lock:
            cls._rules = new_map

    @classmethod
    def get_rules(cls, resource: str) -> List[AuthorityRule]:
        return cls._rules.get(resource, [])

    @classmethod
    def register_property(cls, prop) -> None:
        prop.listen(lambda rules: cls.load_rules(rules or []))

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._rules = {}


class AuthoritySlot(ProcessorSlot):
    """``AuthoritySlot.java:36``."""

    def entry(self, context, resource, node, count, prioritized, args):
        for rule in AuthorityRuleManager.get_rules(resource.name):
            if not pass_check(rule, context.origin):
                raise AuthorityException(
                    context.origin, f"authority: {resource.name}", rule
                )
        self.fire_entry(context, resource, node, count, prioritized, args)


slot_registry.register(AuthoritySlot, order=ORDER_AUTHORITY_SLOT, name="AuthoritySlot")
