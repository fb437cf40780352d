"""Per-rule local degradation when no token server is reachable
(the port's copy of ``sentinel_tpu/ha/fallback.py``).

Mirrors the reference's fail-to-local semantics
(``FlowRuleChecker.fallbackToLocalOrPass``) at the *client* layer: when the
failover client exhausts its endpoint list, every request still resolves —
never an exception, never an indefinite FAIL — according to a per-flow-id
policy:

- **PASS**: admit (the reference's pass-through when
  ``fallback_to_local_when_fail`` is off).
- **BLOCK**: reject (fail-closed for rules that must not over-admit).
- **THROTTLE**: run a *local* sliding-window check against a degraded
  threshold via the existing ``local.flow`` controllers — the fail-to-local
  path proper, sized for one node's fair share of the cluster budget.

Throttle state is per flow_id (a host ``StatisticNode`` + a controller from
:func:`sentinel_tpu_torch.local.flow.fallback_controller`) and is created lazily —
fallback is the degraded path, its setup cost must not precede the failure
it handles.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.cluster.token_service import TokenResult
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.local.base import PriorityWaitException
from sentinel_tpu_torch.local.flow import fallback_controller
from sentinel_tpu_torch.local.stat import StatisticNode
from sentinel_tpu_torch.metrics.ha import ha_metrics


class FallbackAction(enum.IntEnum):
    PASS = 0
    BLOCK = 1
    THROTTLE = 2


@dataclass(frozen=True)
class FallbackRule:
    """Fallback policy for one cluster flow id.

    ``count`` is the *local* degraded QPS budget for THROTTLE (typically the
    cluster threshold divided by the expected client count — the AVG_LOCAL
    share); ``max_queueing_time_ms > 0`` paces instead of rejecting."""

    flow_id: int
    action: FallbackAction = FallbackAction.THROTTLE
    count: float = 0.0
    max_queueing_time_ms: int = 0


class _Throttle:
    """Lazy per-flow local window + controller.

    ``lock`` makes a rejecting controller's check and its count one step, so
    that threads sharing the policy cannot both take a window's last token
    (the reference checks and counts apart). The pacer and a prioritized
    borrow sleep inside ``can_pass`` and stay unlocked, as in the reference:
    a lock there would serialize the sleeps."""

    __slots__ = ("node", "controller", "lock")

    def __init__(self, rule: FallbackRule):
        self.node = StatisticNode()
        self.controller = fallback_controller(
            rule.count, rule.max_queueing_time_ms
        )
        self.lock = (threading.Lock() if rule.max_queueing_time_ms <= 0
                     else None)

    def admit(self, acquire: int, prioritized: bool) -> bool:
        if prioritized or self.lock is None:
            return self._admit(acquire, prioritized)
        with self.lock:
            return self._admit(acquire, False)

    def _admit(self, acquire: int, prioritized: bool) -> bool:
        try:
            ok = bool(self.controller.can_pass(self.node, acquire,
                                               prioritized))
        except PriorityWaitException:
            # the controller already waited the occupied window in; admitted
            ok = True
        if ok:
            self.node.add_pass(acquire, _clock.now_ms())
        return ok


class LocalFallbackPolicy:
    """flow_id → FallbackRule table with a default action for unlisted ids.

    A THROTTLE default throttles unlisted ids against ``default_count`` /
    ``default_max_queueing_time_ms`` (the zero default admits nothing —
    still a resolved BLOCKED verdict, never an exception).

    Thread-safe; shared by every request the failover client degrades."""

    def __init__(
        self,
        rules: Iterable[FallbackRule] = (),
        default_action: FallbackAction = FallbackAction.PASS,
        default_count: float = 0.0,
        default_max_queueing_time_ms: int = 0,
    ):
        self.default_action = FallbackAction(default_action)
        self.default_count = float(default_count)
        self.default_max_queueing_time_ms = int(default_max_queueing_time_ms)
        self._lock = threading.Lock()
        self._rules: Dict[int, FallbackRule] = {}
        self._throttles: Dict[int, _Throttle] = {}
        self._passed = 0
        self._blocked = 0
        self.load_rules(rules)

    def load_rules(self, rules: Iterable[FallbackRule]) -> None:
        table = {int(r.flow_id): r for r in rules}
        with self._lock:
            self._rules = table
            # reloads reset throttle state, matching local.flow's
            # re-instantiated controllers on rule reload
            self._throttles = {}

    def rule_for(self, flow_id: int) -> Optional[FallbackRule]:
        with self._lock:
            return self._rules.get(int(flow_id))

    # -- decision path -------------------------------------------------------
    def decide(self, flow_id: int, acquire: int = 1,
               prioritized: bool = False) -> TokenResult:
        """One degraded verdict. Counts into ``sentinel_fallback_total``."""
        rule = self.rule_for(flow_id)
        action = rule.action if rule is not None else self.default_action
        if action == FallbackAction.PASS:
            self._count("pass", passed=True)
            return TokenResult(TokenStatus.OK)
        if action == FallbackAction.BLOCK:
            self._count("block", passed=False)
            return TokenResult(TokenStatus.BLOCKED)
        if rule is None:
            # unlisted id under a THROTTLE default: synthesize a rule so the
            # degraded hot path still resolves (against the default budget)
            # instead of dereferencing None
            rule = FallbackRule(
                int(flow_id),
                FallbackAction.THROTTLE,
                count=self.default_count,
                max_queueing_time_ms=self.default_max_queueing_time_ms,
            )
        throttle = self._throttle_for(rule)
        now = _clock.now_ms()
        if throttle.admit(acquire, prioritized):
            self._count("throttle_pass", passed=True)
            return TokenResult(TokenStatus.OK)
        throttle.node.add_block(acquire, now)
        self._count("throttle_block", passed=False)
        return TokenResult(TokenStatus.BLOCKED)

    def decide_batch_arrays(
        self, flow_ids, acquires=None, prios=None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Array-shaped degraded verdicts matching the
        ``TokenService.request_batch_arrays`` contract."""
        flow_ids = np.asarray(flow_ids, np.int64)
        n = flow_ids.shape[0]
        status = np.empty(n, np.int8)
        remaining = np.zeros(n, np.int32)
        wait = np.zeros(n, np.int32)
        for i in range(n):
            r = self.decide(
                int(flow_ids[i]),
                1 if acquires is None else int(acquires[i]),
                False if prios is None else bool(prios[i]),
            )
            status[i] = int(r.status)
            remaining[i] = r.remaining
            wait[i] = r.wait_ms
        return status, remaining, wait

    # -- internals -----------------------------------------------------------
    def _throttle_for(self, rule: FallbackRule) -> _Throttle:
        with self._lock:
            throttle = self._throttles.get(rule.flow_id)
            if throttle is None:
                throttle = self._throttles[rule.flow_id] = _Throttle(rule)
            return throttle

    def _count(self, action: str, passed: bool) -> None:
        ha_metrics().count_fallback(action)
        with self._lock:
            if passed:
                self._passed += 1
            else:
                self._blocked += 1

    def stats(self) -> dict:
        """Pass/block totals since construction (bench artifact shape)."""
        with self._lock:
            total = self._passed + self._blocked
            return {
                "passed": self._passed,
                "blocked": self._blocked,
                "blocked_rate": (self._blocked / total) if total else 0.0,
            }
