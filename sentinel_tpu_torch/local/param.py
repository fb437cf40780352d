"""Hot-parameter flow control (local mode) (the port's copy of
``sentinel_tpu/local/param.py``).

Analog of ``sentinel-extension/sentinel-parameter-flow-control``:
``ParamFlowSlot`` (@Spi order −3000, ``ParamFlowSlot.java:34-84`` — picks
``args[param_idx]``), ``ParamFlowChecker.java:46-190``:

- **QPS mode** — a decentralized token bucket per parameter value: token
  count + last-refill-time per value, refill ``elapsed × count / duration``,
  optional burst headroom (``passLocalCheck``/``passDefaultLocalCheck``).
- **RATE_LIMITER mode** — per-value leaky-bucket pacing
  (``passThrottleLocalCheck``).
- **THREAD mode** — per-value concurrency, decremented on exit.
- per-item overrides (``parsedHotItems``), LRU-bounded value maps
  (``ParameterMetric.java:35-55``: 4,000 values per metric by default).
- cluster branch → ``requestParamsToken`` with the value's stable hash
  (``ParamFlowChecker.java:72``), falling back to local on failure.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from sentinel_tpu_torch.cluster import api as cluster_api
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.hashing import stable_param_hash
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.local.base import ORDER_PARAM_FLOW_SLOT, ParamFlowException
from sentinel_tpu_torch.local.chain import ProcessorSlot, slot_registry
from sentinel_tpu_torch.local.flow import ControlBehavior, FlowGrade


@dataclass
class ParamFlowItem:
    """Per-value threshold override (``ParamFlowItem.java``)."""

    object_value: Any
    count: float


@dataclass
class ParamFlowRule:
    resource: str
    param_idx: int = 0
    count: float = 0.0
    grade: FlowGrade = FlowGrade.QPS
    duration_sec: int = 1
    burst_count: int = 0
    control_behavior: ControlBehavior = ControlBehavior.DEFAULT
    max_queueing_time_ms: int = 0
    items: List[ParamFlowItem] = field(default_factory=list)
    cluster_mode: bool = False
    cluster_config: Optional[dict] = None

    # built once at rule load (parsedHotItems analog); falls back to a scan
    # for unhashable override values
    _item_map: Optional[Dict[Any, float]] = field(
        default=None, repr=False, compare=False
    )

    def item_threshold(self, value: Any) -> float:
        if self._item_map is not None:
            try:
                return self._item_map.get(value, self.count)
            except TypeError:
                pass  # unhashable value
        for item in self.items:
            if item.object_value == value:
                return item.count
        return self.count


class _Lru(OrderedDict):
    """Bounded map (ConcurrentLinkedHashMapWrapper analog)."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def touch(self, key, default):
        if key in self:
            self.move_to_end(key)
            return self[key]
        self[key] = default
        if len(self) > self.cap:
            self.popitem(last=False)
        return default


MAX_VALUES_PER_RULE = 4000  # ParameterMetric.BASE_PARAM_MAX_CAPACITY


class _RuleState:
    """Per-rule mutable value maps (ParameterMetric analog)."""

    __slots__ = ("lock", "tokens", "last_fill_ms", "latest_passed_ms", "threads")

    def __init__(self):
        self.lock = threading.Lock()
        self.tokens: _Lru = _Lru(MAX_VALUES_PER_RULE)
        self.last_fill_ms: _Lru = _Lru(MAX_VALUES_PER_RULE)
        self.latest_passed_ms: _Lru = _Lru(MAX_VALUES_PER_RULE)
        self.threads: Dict[Any, int] = {}


def _check_qps(rule: ParamFlowRule, st: _RuleState, value: Any, acquire: int) -> bool:
    """Token bucket per value (``ParamFlowChecker.passDefaultLocalCheck``)."""
    now = _clock.now_ms()
    threshold = rule.item_threshold(value)
    burst = rule.burst_count
    duration_ms = rule.duration_sec * 1000
    with st.lock:
        last = st.last_fill_ms.touch(value, None)
        if last is None:
            # first sight: full bucket minus this acquisition
            if threshold + burst < acquire:
                st.last_fill_ms[value] = now
                st.tokens[value] = 0.0
                return False
            st.last_fill_ms[value] = now
            st.tokens[value] = threshold + burst - acquire
            return True
        tokens = st.tokens.touch(value, 0.0)
        elapsed = now - last
        if elapsed >= 0:
            refill = elapsed * threshold / duration_ms
            tokens = min(tokens + refill, threshold + burst)
            st.last_fill_ms[value] = now
        if tokens < acquire:
            st.tokens[value] = tokens
            return False
        st.tokens[value] = tokens - acquire
        return True


def _check_throttle(rule: ParamFlowRule, st: _RuleState, value: Any, acquire: int) -> bool:
    """Leaky bucket per value (``passThrottleLocalCheck``)."""
    now = _clock.now_ms()
    threshold = rule.item_threshold(value)
    if threshold <= 0:
        return False
    cost_ms = round(rule.duration_sec * 1000.0 * acquire / threshold)
    with st.lock:
        latest = st.latest_passed_ms.touch(value, -1)
        expected = latest + cost_ms
        if expected <= now:
            st.latest_passed_ms[value] = now
            return True
        wait = expected - now
        if wait > rule.max_queueing_time_ms:
            return False
        st.latest_passed_ms[value] = expected
    _clock.get_clock().wait_ms(wait)
    return True


def _check_thread(rule: ParamFlowRule, st: _RuleState, value: Any, acquire: int) -> bool:
    """Check-and-increment atomically under the rule lock; the caller rolls
    back on a later rule's block (reference splits check and increment across
    the slot chain, widening a TOCTOU window — here the cap cannot be
    exceeded)."""
    threshold = rule.item_threshold(value)
    with st.lock:
        cur = st.threads.get(value, 0)
        if cur + acquire > threshold:
            return False
        st.threads[value] = cur + acquire
        return True


def _release_thread(st: _RuleState, value: Any, count: int) -> None:
    with st.lock:
        remaining = st.threads.get(value, 0) - count
        if remaining > 0:
            st.threads[value] = remaining
        else:
            st.threads.pop(value, None)


class ParamFlowRuleManager:
    _lock = threading.RLock()
    _rules: Dict[str, List[Tuple[ParamFlowRule, _RuleState]]] = {}

    @classmethod
    def load_rules(cls, rules: List[ParamFlowRule]) -> None:
        with cls._lock:
            # preserve counters for rules that did not change (the reference's
            # ParameterMetric cache keyed by rule survives reloads) — a
            # datasource republish must not refill every value's bucket or
            # orphan in-flight THREAD holds
            old: Dict[str, List[Tuple[ParamFlowRule, _RuleState]]] = cls._rules
            leftovers = {res: list(lst) for res, lst in old.items()}
            new_map: Dict[str, List[Tuple[ParamFlowRule, _RuleState]]] = {}
            for rule in rules or []:
                if not rule.resource or rule.count < 0 or rule.param_idx < 0:
                    continue
                state = None
                for i, (old_rule, old_state) in enumerate(
                    leftovers.get(rule.resource, [])
                ):
                    if old_rule == rule:
                        state = old_state
                        del leftovers[rule.resource][i]
                        break
                if state is None:
                    state = _RuleState()
                try:
                    rule._item_map = {i.object_value: i.count for i in rule.items}
                except TypeError:
                    rule._item_map = None
                new_map.setdefault(rule.resource, []).append((rule, state))
            cls._rules = new_map

    @classmethod
    def get_rules(cls, resource: str):
        return cls._rules.get(resource, [])

    @classmethod
    def all_rules(cls) -> Dict[str, List[ParamFlowRule]]:
        with cls._lock:
            return {res: [r for r, _ in lst] for res, lst in cls._rules.items()}

    @classmethod
    def register_property(cls, prop) -> None:
        prop.listen(lambda rules: cls.load_rules(rules or []))

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._rules = {}


def _pass_check(
    rule: ParamFlowRule, st: _RuleState, value: Any, acquire: int
) -> Tuple[bool, bool]:
    """Returns ``(passed, thread_hold_taken)``."""
    if rule.cluster_mode:
        ok = _pass_cluster_check(rule, value, acquire)
        if ok is not None:
            return ok, False
        # fall through to local when the cluster path is unavailable
        cfg = rule.cluster_config or {}
        if not cfg.get("fallback_to_local_when_fail", True):
            return True, False
    if rule.grade == FlowGrade.THREAD:
        ok = _check_thread(rule, st, value, acquire)
        return ok, ok
    if rule.control_behavior == ControlBehavior.RATE_LIMITER:
        return _check_throttle(rule, st, value, acquire), False
    return _check_qps(rule, st, value, acquire), False


def _pass_cluster_check(rule: ParamFlowRule, value: Any, acquire: int):
    """Returns True/False on a definitive cluster verdict, None to fall back."""
    try:
        service = cluster_api._pick_service()
        flow_id = (rule.cluster_config or {}).get("flow_id")
        if service is None or flow_id is None:
            return None
        result = service.request_params_token(
            int(flow_id), acquire, [stable_param_hash(value)]
        )
        if result.status == TokenStatus.OK:
            return True
        if result.status == TokenStatus.BLOCKED:
            return False
        return None
    except Exception:
        return None


class ParamFlowSlot(ProcessorSlot):
    """``ParamFlowSlot.java:34-84``."""

    def entry(self, context, resource, node, count, prioritized, args):
        rules = ParamFlowRuleManager.get_rules(resource.name)
        if rules:
            holds = []  # THREAD increments already taken, for exit/rollback
            for rule, st in rules:
                if rule.param_idx >= len(args):
                    continue  # no such arg → rule not applicable
                value = args[rule.param_idx]
                if value is None:
                    continue
                ok, held = _pass_check(rule, st, value, count)
                if held:
                    holds.append((st, value))
                if not ok:
                    # roll back holds taken by earlier rules of this entry
                    for h_st, h_value in holds:
                        _release_thread(h_st, h_value, count)
                    raise ParamFlowException(
                        resource.name, f"param flow: {resource.name}", rule
                    )
            if holds:
                context.cur_entry.param_holds = holds
        self.fire_entry(context, resource, node, count, prioritized, args)

    def exit(self, context, resource, count, args):
        entry = context.cur_entry
        holds = entry.param_holds if entry is not None else None
        if holds:
            for st, value in holds:
                _release_thread(st, value, count)
        self.fire_exit(context, resource, count, args)


slot_registry.register(ParamFlowSlot, order=ORDER_PARAM_FLOW_SLOT, name="ParamFlowSlot")
