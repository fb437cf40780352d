"""Flow rules: QPS/concurrency limiting with four traffic-shaping behaviors
(the port's copy of ``sentinel_tpu/local/flow.py``).

Analog of ``slots/block/flow/*`` — ``FlowSlot.java:142``,
``FlowRuleChecker.java:42-208``, the four ``TrafficShapingController``s
(``controller/{Default,RateLimiter,WarmUp,WarmUpRateLimiter}Controller.java``)
and ``FlowRuleManager.java:49`` / ``FlowRuleUtil.java:102-148``.

Controllers are stateful per rule and are re-instantiated on rule reload
(matching the reference: warm-up curves and pacing state reset when rules
change, ``FlowRuleUtil.buildFlowRuleMap``).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from sentinel_tpu_torch.cluster import api as cluster_api
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.property import DynamicProperty
from sentinel_tpu_torch.local import chain as chain_mod
from sentinel_tpu_torch.local.base import (
    FlowException,
    LIMIT_APP_DEFAULT,
    LIMIT_APP_OTHER,
    ORDER_FLOW_SLOT,
    PriorityWaitException,
)
from sentinel_tpu_torch.local.chain import ProcessorSlot, slot_registry
from sentinel_tpu_torch.local.stat import DEFAULT_OCCUPY_TIMEOUT_MS, StatisticNode


class FlowGrade(enum.IntEnum):
    THREAD = 0  # concurrency
    QPS = 1


class FlowStrategy(enum.IntEnum):
    DIRECT = 0
    RELATE = 1
    CHAIN = 2


class ControlBehavior(enum.IntEnum):
    DEFAULT = 0  # reject (+ priority occupy)
    WARM_UP = 1
    RATE_LIMITER = 2
    WARM_UP_RATE_LIMITER = 3


@dataclass
class FlowRule:
    """``FlowRule.java`` — field names and defaults preserved."""

    resource: str
    count: float = 0.0
    grade: FlowGrade = FlowGrade.QPS
    limit_app: str = LIMIT_APP_DEFAULT
    strategy: FlowStrategy = FlowStrategy.DIRECT
    ref_resource: str = ""
    control_behavior: ControlBehavior = ControlBehavior.DEFAULT
    warm_up_period_sec: int = 10
    max_queueing_time_ms: int = 500
    cluster_mode: bool = False
    cluster_config: Optional[dict] = None
    # compare=False: the mutable controller must not defeat DynamicProperty's
    # equal-value dedup, or every republish of an identical config would reset
    # warm-up/pacing state
    _rater: "TrafficShapingController" = field(
        init=False, repr=False, compare=False, default=None
    )


# ---------------------------------------------------------------------------
# Traffic-shaping controllers
# ---------------------------------------------------------------------------


class TrafficShapingController:
    def can_pass(self, node: StatisticNode, acquire: int, prioritized: bool = False) -> bool:
        raise NotImplementedError


class DefaultController(TrafficShapingController):
    """Reject excess; prioritized QPS requests may borrow a future window
    (``DefaultController.java:49-69``)."""

    def __init__(self, count: float, grade: FlowGrade):
        self.count = count
        self.grade = grade

    def _used(self, node: StatisticNode, now: int) -> float:
        if self.grade == FlowGrade.THREAD:
            return float(node.cur_thread_num)
        return node.pass_qps(now)

    def can_pass(self, node, acquire, prioritized=False):
        now = _clock.now_ms()
        cur = self._used(node, now)
        if cur + acquire <= self.count:
            return True
        if prioritized and self.grade == FlowGrade.QPS:
            wait = node.try_occupy_next(now, acquire, self.count)
            if wait <= DEFAULT_OCCUPY_TIMEOUT_MS:
                node.add_occupied_pass(acquire, wait, now)
                _clock.get_clock().wait_ms(wait)
                raise PriorityWaitException(wait)
        return False


class RateLimiterController(TrafficShapingController):
    """Leaky-bucket pacing: requests queue up to ``max_queueing_time_ms``
    (``RateLimiterController.java:46-91``; the CAS on ``latestPassedTime``
    becomes a lock — the host path is not the hot path here)."""

    def __init__(self, count: float, max_queueing_time_ms: int):
        self.count = count
        self.max_queueing_time_ms = max_queueing_time_ms
        self._latest_passed_time = -1
        self._lock = threading.Lock()

    def can_pass(self, node, acquire, prioritized=False):
        if acquire <= 0:
            return True
        if self.count <= 0:
            return False
        now = _clock.now_ms()
        cost_ms = round(1000.0 * acquire / self.count)
        with self._lock:
            expected = self._latest_passed_time + cost_ms
            if expected <= now:
                self._latest_passed_time = now
                return True
            wait = expected - now
            if wait > self.max_queueing_time_ms:
                return False
            self._latest_passed_time = expected
        _clock.get_clock().wait_ms(wait)
        return True


class WarmUpController(TrafficShapingController):
    """Guava-SmoothWarmingUp-style cold-start curve
    (``WarmUpController.java:64-170``): a token bucket whose fill level above
    ``warning_token`` maps to a reduced admissible QPS along a linear slope;
    sustained traffic drains the bucket back to full speed over
    ``warm_up_period_sec``."""

    def __init__(self, count: float, warm_up_period_sec: int, cold_factor: Optional[int] = None):
        cold = cold_factor if cold_factor is not None else SentinelConfig.cold_factor()
        if cold <= 1:
            raise ValueError("cold factor must be > 1")
        if count <= 0:
            raise ValueError("warm-up requires count > 0")
        self.count = count
        self.cold_factor = cold
        # token maths (WarmUpController.java:94-111)
        self.warning_token = int((warm_up_period_sec * count) / (cold - 1))
        self.max_token = int(
            self.warning_token + 2.0 * warm_up_period_sec * count / (1.0 + cold)
        )
        self.slope = (cold - 1.0) / count / max(1, (self.max_token - self.warning_token))
        self._stored_tokens = 0.0
        self._last_filled_ms = 0
        self._lock = threading.Lock()

    def can_pass(self, node, acquire, prioritized=False):
        now = _clock.now_ms()
        pass_qps = node.pass_qps(now)
        previous_qps = node.previous_pass_qps(now)
        with self._lock:
            self._sync_token(previous_qps, now)
            rest = self._stored_tokens
            if rest >= self.warning_token:
                above = rest - self.warning_token
                warning_qps = 1.0 / (above * self.slope + 1.0 / self.count)
                return pass_qps + acquire <= warning_qps
            return pass_qps + acquire <= self.count

    def _sync_token(self, pass_qps: float, now: int) -> None:
        cur_sec = now - now % 1000
        if cur_sec <= self._last_filled_ms:
            return
        self._stored_tokens = self._cool_down(cur_sec, pass_qps)
        self._stored_tokens = max(0.0, self._stored_tokens - pass_qps)
        self._last_filled_ms = cur_sec

    def _cool_down(self, cur_sec: int, pass_qps: float) -> float:
        old = self._stored_tokens
        new = old
        refill = (cur_sec - self._last_filled_ms) * self.count / 1000.0
        if old < self.warning_token:
            new = old + refill
        elif old > self.warning_token:
            # below cold-rate traffic → keep cooling down (refilling); the
            # threshold floors like the reference's int division, so traffic
            # at exactly the admitted cold rate does drain the bucket
            if pass_qps < int(self.count) // self.cold_factor:
                new = old + refill
        return min(new, self.max_token)


class WarmUpRateLimiterController(TrafficShapingController):
    """Warm-up curve + pacing (``WarmUpRateLimiterController.java:27``): the
    pacing interval derives from the warm-up-adjusted admissible QPS."""

    def __init__(self, count: float, warm_up_period_sec: int, max_queueing_time_ms: int,
                 cold_factor: Optional[int] = None):
        self._warmup = WarmUpController(count, warm_up_period_sec, cold_factor)
        self.count = count
        self.max_queueing_time_ms = max_queueing_time_ms
        self._latest_passed_time = -1
        self._lock = threading.Lock()

    def can_pass(self, node, acquire, prioritized=False):
        now = _clock.now_ms()
        previous_qps = node.previous_pass_qps(now)
        with self._warmup._lock:
            self._warmup._sync_token(previous_qps, now)
            rest = self._warmup._stored_tokens
            if rest >= self._warmup.warning_token:
                above = rest - self._warmup.warning_token
                warning_qps = 1.0 / (above * self._warmup.slope + 1.0 / self.count)
                cost_ms = round(1000.0 * acquire / warning_qps)
            else:
                cost_ms = round(1000.0 * acquire / self.count)
        with self._lock:
            expected = self._latest_passed_time + cost_ms
            if expected <= now:
                self._latest_passed_time = now
                return True
            wait = expected - now
            if wait > self.max_queueing_time_ms:
                return False
            self._latest_passed_time = expected
        _clock.get_clock().wait_ms(wait)
        return True


def generate_rater(rule: FlowRule) -> TrafficShapingController:
    """``FlowRuleUtil.generateRater`` (``FlowRuleUtil.java:132-148``): shaping
    behaviors only apply to QPS-grade rules."""
    if rule.grade == FlowGrade.QPS:
        if rule.control_behavior == ControlBehavior.WARM_UP:
            return WarmUpController(rule.count, rule.warm_up_period_sec)
        if rule.control_behavior == ControlBehavior.RATE_LIMITER:
            return RateLimiterController(rule.count, rule.max_queueing_time_ms)
        if rule.control_behavior == ControlBehavior.WARM_UP_RATE_LIMITER:
            return WarmUpRateLimiterController(
                rule.count, rule.warm_up_period_sec, rule.max_queueing_time_ms
            )
    return DefaultController(rule.count, rule.grade)


def fallback_controller(
    count: float, max_queueing_time_ms: int = 0
) -> TrafficShapingController:
    """Controller for the cluster fail-to-local path (``ha.fallback``): a
    degraded QPS budget enforced locally while the token servers are down.
    ``max_queueing_time_ms > 0`` paces (leaky bucket) instead of rejecting —
    the same two shapes ``generate_rater`` picks between, minus warm-up
    (a fallback window is too short for a ramp to mean anything)."""
    if max_queueing_time_ms > 0:
        return RateLimiterController(count, max_queueing_time_ms)
    return DefaultController(count, FlowGrade.QPS)


# ---------------------------------------------------------------------------
# Rule manager
# ---------------------------------------------------------------------------


class FlowRuleManager:
    """Holds the active rule map; subscribes to a dynamic property
    (``FlowRuleManager.java:49-75``)."""

    _lock = threading.RLock()
    _rules: Dict[str, List[FlowRule]] = {}
    _property: Optional[DynamicProperty] = None

    @classmethod
    def load_rules(cls, rules: List[FlowRule]) -> None:
        new_map: Dict[str, List[FlowRule]] = {}
        for rule in rules or []:
            if rule.count < 0 or not rule.resource:
                continue
            try:
                rule._rater = generate_rater(rule)
            except Exception:
                # one malformed rule (e.g. WARM_UP with count=0) must not
                # abort the whole batch — matches the reference's per-rule
                # isValidRule filtering
                from sentinel_tpu_torch.core.log import record_log

                record_log.warning("ignoring invalid flow rule: %r", rule)
                continue
            new_map.setdefault(rule.resource, []).append(rule)
        # FlowRuleComparator: specific-origin rules first, then 'other', then
        # 'default' — ensures origin-specific limits take precedence.
        def key(r: FlowRule) -> int:
            if r.limit_app == LIMIT_APP_DEFAULT:
                return 2
            if r.limit_app == LIMIT_APP_OTHER:
                return 1
            return 0

        for lst in new_map.values():
            lst.sort(key=key)
        with cls._lock:
            cls._rules = new_map

    @classmethod
    def register_property(cls, prop: DynamicProperty) -> None:
        """``register2Property``: rules then follow the datasource."""
        with cls._lock:
            cls._property = prop
            prop.listen(lambda rules: cls.load_rules(rules or []))

    @classmethod
    def get_rules(cls, resource: str) -> List[FlowRule]:
        return cls._rules.get(resource, [])

    @classmethod
    def all_rules(cls) -> List[FlowRule]:
        return [r for lst in cls._rules.values() for r in lst]

    @classmethod
    def has_limit_app(cls, resource: str, origin: str) -> bool:
        """Is ``origin`` named by any rule of this resource? (the 'other'
        semantics, ``FlowRuleChecker.java:115-145``)."""
        return any(r.limit_app == origin for r in cls.get_rules(resource))

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._rules = {}
            cls._property = None


# ---------------------------------------------------------------------------
# Checker + slot
# ---------------------------------------------------------------------------


def _filter_origin(origin: str) -> bool:
    return bool(origin) and origin not in (LIMIT_APP_DEFAULT, LIMIT_APP_OTHER)


def select_node(rule: FlowRule, context, node):
    """``selectNodeByRequesterAndStrategy`` (``FlowRuleChecker.java:115-145``)."""
    limit_app = rule.limit_app
    origin = context.origin
    if limit_app == origin and _filter_origin(origin):
        if rule.strategy == FlowStrategy.DIRECT:
            return context.cur_entry.origin_node
        return _select_reference_node(rule, context, node)
    if limit_app == LIMIT_APP_DEFAULT:
        if rule.strategy == FlowStrategy.DIRECT:
            return node.cluster_node
        return _select_reference_node(rule, context, node)
    if limit_app == LIMIT_APP_OTHER and not FlowRuleManager.has_limit_app(
        rule.resource, origin
    ):
        if rule.strategy == FlowStrategy.DIRECT:
            return context.cur_entry.origin_node
        return _select_reference_node(rule, context, node)
    return None


def _select_reference_node(rule: FlowRule, context, node):
    ref = rule.ref_resource
    if not ref:
        return None
    if rule.strategy == FlowStrategy.RELATE:
        return chain_mod.get_cluster_node(ref)
    if rule.strategy == FlowStrategy.CHAIN:
        return node if context.name == ref else None
    return None


def can_pass_check(rule: FlowRule, context, node, acquire: int,
                   prioritized: bool = False) -> bool:
    if rule.cluster_mode:
        return _pass_cluster_check(rule, context, node, acquire, prioritized)
    return _pass_local_check(rule, context, node, acquire, prioritized)


def _pass_local_check(rule, context, node, acquire, prioritized):
    selected = select_node(rule, context, node)
    if selected is None:
        return True
    return rule._rater.can_pass(selected, acquire, prioritized)


def _pass_cluster_check(rule, context, node, acquire, prioritized):
    """Cluster branch (``FlowRuleChecker.java:147-208``): ask the token
    service; on failure fall back to local or pass-through."""
    try:
        result = cluster_api.request_token(rule, acquire, prioritized)
    except Exception:
        return _fallback(rule, context, node, acquire, prioritized)
    if result is None:
        return _fallback(rule, context, node, acquire, prioritized)
    return cluster_api.apply_token_result(
        result, rule, context, node, acquire, prioritized, _fallback
    )


def _fallback(rule, context, node, acquire, prioritized):
    """``fallbackToLocalOrPass`` (``FlowRuleChecker.java:158-173``)."""
    cfg = rule.cluster_config or {}
    if cfg.get("fallback_to_local_when_fail", True):
        return _pass_local_check(rule, context, node, acquire, prioritized)
    return True


def check_flow(resource, context, node, count: int, prioritized: bool) -> None:
    for rule in FlowRuleManager.get_rules(resource.name):
        if not can_pass_check(rule, context, node, count, prioritized):
            raise FlowException(rule.limit_app, f"flow limit: {resource.name}", rule)


class FlowSlot(ProcessorSlot):
    """``FlowSlot.java:142``."""

    def entry(self, context, resource, node, count, prioritized, args):
        check_flow(resource, context, node, count, prioritized)
        self.fire_entry(context, resource, node, count, prioritized, args)


slot_registry.register(FlowSlot, order=ORDER_FLOW_SLOT, name="FlowSlot")
