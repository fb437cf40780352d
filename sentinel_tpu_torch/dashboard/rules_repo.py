"""Id-keyed rule repository backing the per-rule-type console views.

Analog of the reference dashboard's ``InMemoryRuleRepositoryAdapter``
(``sentinel-dashboard/.../repository/rule/InMemoryRuleRepositoryAdapter.java``)
behind ``FlowControllerV1`` and its siblings: the console edits individual
rules by id; the dashboard keeps the id ↔ rule mapping (agents only ever see
whole lists) and pushes the assembled list to every healthy machine after
each mutation.

Rules are plain dicts in the agent's JSON schema (the same payloads
``setRules`` accepts) — the repository is storage + identity, not parsing.
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Dict, List, Optional, Tuple


class InMemoryRuleRepository:
    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        # (app, rule_type) → {id: rule-dict}
        self._rules: Dict[Tuple[str, str], Dict[int, dict]] = {}

    @staticmethod
    def _content_key(rule: dict) -> str:
        return json.dumps(rule, sort_keys=True, default=str)

    def sync(self, app: str, rule_type: str, rules: List[dict]) -> List[dict]:
        """Replace the stored set from a live fetch. Ids are STABLE across
        syncs: a fetched rule whose content matches an existing entry keeps
        that entry's id (like the reference's ``InMemoryRuleRepositoryAdapter``
        keeping ids server-side), so concurrent console tabs and page reloads
        don't orphan an in-flight edit's id. Only genuinely new rules get
        fresh ids. Returns the stored entries with ids attached."""
        with self._lock:
            prev = self._rules.get((app, rule_type), {})
            # content → ids of previous entries, consumed first-come (stable
            # for duplicates: N identical rules keep N distinct ids)
            by_content: Dict[str, List[int]] = {}
            for rule_id, rule in sorted(prev.items()):
                by_content.setdefault(self._content_key(rule), []).append(rule_id)
            entries: Dict[int, dict] = {}
            for rule in rules:
                pool = by_content.get(self._content_key(rule))
                rule_id = pool.pop(0) if pool else next(self._ids)
                entries[rule_id] = dict(rule)
            self._rules[(app, rule_type)] = entries
            return [{"id": i, **r} for i, r in sorted(entries.items())]

    def known(self, app: str, rule_type: str) -> bool:
        """Whether this (app, type) has ever been synced/mutated — a fresh
        dashboard must sync from the live agent before its first mutation or
        the push would overwrite rules the agent already holds."""
        with self._lock:
            return (app, rule_type) in self._rules

    def list(self, app: str, rule_type: str) -> List[dict]:
        with self._lock:
            entries = self._rules.get((app, rule_type), {})
            return [{"id": i, **r} for i, r in sorted(entries.items())]

    def add(self, app: str, rule_type: str, rule: dict) -> int:
        with self._lock:
            rule_id = next(self._ids)
            self._rules.setdefault((app, rule_type), {})[rule_id] = dict(rule)
            return rule_id

    def update(self, app: str, rule_type: str, rule_id: int,
               rule: dict) -> bool:
        with self._lock:
            entries = self._rules.get((app, rule_type), {})
            if rule_id not in entries:
                return False
            entries[rule_id] = dict(rule)
            return True

    def delete(self, app: str, rule_type: str, rule_id: int) -> bool:
        with self._lock:
            entries = self._rules.get((app, rule_type), {})
            return entries.pop(rule_id, None) is not None

    def plain_rules(self, app: str, rule_type: str) -> List[dict]:
        """The id-less list an agent's setRules expects."""
        with self._lock:
            entries = self._rules.get((app, rule_type), {})
            return [dict(r) for _, r in sorted(entries.items())]
