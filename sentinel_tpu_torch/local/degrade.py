"""Circuit breaking: slow-call ratio / error ratio / error count
(the port's copy of ``sentinel_tpu/local/degrade.py``).

Analog of ``slots/block/degrade/*`` — ``DegradeSlot.java:38-66``,
``AbstractCircuitBreaker.java:33-155`` (CLOSED/OPEN/HALF_OPEN machine),
``ExceptionCircuitBreaker.java:35`` and ``ResponseTimeCircuitBreaker.java:34``,
``DegradeRuleManager.java:43``.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.local.base import DegradeException, ORDER_DEGRADE_SLOT
from sentinel_tpu_torch.local.chain import ProcessorSlot, slot_registry
from sentinel_tpu_torch.local.stat import HostWindow


class DegradeGrade(enum.IntEnum):
    # RuleConstant.java:29-37
    SLOW_REQUEST_RATIO = 0
    ERROR_RATIO = 1
    ERROR_COUNT = 2


class State(enum.IntEnum):
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


@dataclass
class DegradeRule:
    """``DegradeRule.java`` — for SLOW_REQUEST_RATIO, ``count`` is the max
    allowed RT (ms) and ``slow_ratio_threshold`` the trip ratio; for the error
    grades ``count`` is the ratio/count threshold."""

    resource: str
    grade: DegradeGrade = DegradeGrade.SLOW_REQUEST_RATIO
    count: float = 0.0
    time_window_sec: int = 0  # recovery (retry) timeout
    min_request_amount: int = 5
    stat_interval_ms: int = 1000
    slow_ratio_threshold: float = 1.0
    limit_app: str = "default"


# Window channels for breaker counters (one HostWindow, private channel use:
# chan 0 = total, 1 = error, 2 = slow; we reuse HostWindow's channel array).
_TOTAL, _ERROR, _SLOW = 0, 1, 2

StateChangeObserver = Callable[[str, State, State, DegradeRule], None]
_observers: List[StateChangeObserver] = []


def register_state_change_observer(obs: StateChangeObserver) -> None:
    """``EventObserverRegistry`` analog."""
    _observers.append(obs)


def clear_state_change_observers() -> None:
    _observers.clear()


class CircuitBreaker:
    """``AbstractCircuitBreaker``: the state machine; subclasses supply the
    trip condition from their sliding counters."""

    def __init__(self, rule: DegradeRule):
        self.rule = rule
        self.retry_timeout_ms = rule.time_window_sec * 1000
        self._state = State.CLOSED
        self._next_retry_ms = 0
        self._lock = threading.RLock()
        # sampleCount=1 per the reference's SimpleErrorCounterLeapArray —
        # one bucket spanning stat_interval_ms
        self._counter = HostWindow(rule.stat_interval_ms, 1)

    # -- state transitions (AbstractCircuitBreaker.java:93-155) -------------
    def _notify(self, prev: State, new: State) -> None:
        for obs in _observers:
            try:
                obs(self.rule.resource, prev, new, self.rule)
            except Exception:
                pass

    def _to_open(self) -> None:
        prev = self._state
        self._state = State.OPEN
        self._next_retry_ms = _clock.now_ms() + self.retry_timeout_ms
        self._notify(prev, State.OPEN)

    def _from_open_to_half_open(self) -> bool:
        if self._state == State.OPEN:
            self._state = State.HALF_OPEN
            self._notify(State.OPEN, State.HALF_OPEN)
            return True
        return False

    def _from_half_open_to_open(self) -> None:
        if self._state == State.HALF_OPEN:
            self._state = State.OPEN
            self._next_retry_ms = _clock.now_ms() + self.retry_timeout_ms
            self._notify(State.HALF_OPEN, State.OPEN)

    def _from_half_open_to_close(self) -> None:
        if self._state == State.HALF_OPEN:
            self._state = State.CLOSED
            self._counter = HostWindow(self.rule.stat_interval_ms, 1)
            self._notify(State.HALF_OPEN, State.CLOSED)

    @property
    def state(self) -> State:
        return self._state

    def try_pass(self) -> bool:
        """Entry-side gate (``AbstractCircuitBreaker.tryPass``): CLOSED passes;
        OPEN passes one probe once the retry timeout arrives (→ HALF_OPEN);
        HALF_OPEN rejects everything but the in-flight probe."""
        with self._lock:
            if self._state == State.CLOSED:
                return True
            if self._state == State.OPEN:
                if _clock.now_ms() >= self._next_retry_ms:
                    return self._from_open_to_half_open()
                return False
            return False  # HALF_OPEN: probe already in flight

    def on_request_complete(self, rt_ms: float, error: Optional[BaseException]) -> None:
        raise NotImplementedError


class ExceptionCircuitBreaker(CircuitBreaker):
    """ERROR_RATIO / ERROR_COUNT (``ExceptionCircuitBreaker.java:35``)."""

    def on_request_complete(self, rt_ms, error):
        with self._lock:
            now = _clock.now_ms()
            self._counter.add(now, _TOTAL, 1)
            if error is not None:
                self._counter.add(now, _ERROR, 1)
            self._handle_state(now, error is not None)

    def _handle_state(self, now: int, is_error: bool) -> None:
        if self._state == State.OPEN:
            return
        if self._state == State.HALF_OPEN:
            if is_error:
                self._from_half_open_to_open()
            else:
                self._from_half_open_to_close()
            return
        total = self._counter.sum(now, _TOTAL)
        errors = self._counter.sum(now, _ERROR)
        if total < self.rule.min_request_amount:
            return
        if self.rule.grade == DegradeGrade.ERROR_RATIO:
            if total > 0 and errors / total >= self.rule.count:
                self._to_open()
        else:  # ERROR_COUNT
            if errors >= self.rule.count:
                self._to_open()


class ResponseTimeCircuitBreaker(CircuitBreaker):
    """SLOW_REQUEST_RATIO (``ResponseTimeCircuitBreaker.java:34``):
    ``rule.count`` = max allowed RT; trips when the slow fraction over the stat
    interval reaches ``slow_ratio_threshold``."""

    def on_request_complete(self, rt_ms, error):
        with self._lock:
            now = _clock.now_ms()
            slow = rt_ms > self.rule.count
            self._counter.add(now, _TOTAL, 1)
            if slow:
                self._counter.add(now, _SLOW, 1)
            if self._state == State.OPEN:
                return
            if self._state == State.HALF_OPEN:
                if slow:
                    self._from_half_open_to_open()
                else:
                    self._from_half_open_to_close()
                return
            total = self._counter.sum(now, _TOTAL)
            slows = self._counter.sum(now, _SLOW)
            if total < self.rule.min_request_amount:
                return
            if total > 0 and slows / total >= self.rule.slow_ratio_threshold:
                self._to_open()


def _make_breaker(rule: DegradeRule) -> Optional[CircuitBreaker]:
    if rule.grade == DegradeGrade.SLOW_REQUEST_RATIO:
        return ResponseTimeCircuitBreaker(rule)
    if rule.grade in (DegradeGrade.ERROR_RATIO, DegradeGrade.ERROR_COUNT):
        return ExceptionCircuitBreaker(rule)
    return None


class DegradeRuleManager:
    """``DegradeRuleManager.java:43`` — breakers rebuild (and reset state) on
    rule reload, matching the reference."""

    _lock = threading.RLock()
    _breakers: Dict[str, List[CircuitBreaker]] = {}

    @classmethod
    def load_rules(cls, rules: List[DegradeRule]) -> None:
        new_map: Dict[str, List[CircuitBreaker]] = {}
        for rule in rules or []:
            if not rule.resource or rule.count < 0:
                continue
            cb = _make_breaker(rule)
            if cb is not None:
                new_map.setdefault(rule.resource, []).append(cb)
        with cls._lock:
            cls._breakers = new_map

    @classmethod
    def get_breakers(cls, resource: str) -> List[CircuitBreaker]:
        return cls._breakers.get(resource, [])

    @classmethod
    def register_property(cls, prop) -> None:
        prop.listen(lambda rules: cls.load_rules(rules or []))

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._breakers = {}


class DegradeSlot(ProcessorSlot):
    """``DegradeSlot.java:41-66``: gate on entry, feed breakers on exit."""

    def entry(self, context, resource, node, count, prioritized, args):
        for cb in DegradeRuleManager.get_breakers(resource.name):
            if not cb.try_pass():
                raise DegradeException(
                    cb.rule.limit_app, f"degrade: {resource.name}", cb.rule
                )
        self.fire_entry(context, resource, node, count, prioritized, args)

    def exit(self, context, resource, count, args):
        entry = context.cur_entry
        if entry is not None and entry.block_error is None:
            rt = _clock.now_ms() - entry.create_ms
            for cb in DegradeRuleManager.get_breakers(resource.name):
                cb.on_request_complete(rt, entry.error)
        self.fire_exit(context, resource, count, args)


slot_registry.register(DegradeSlot, order=ORDER_DEGRADE_SLOT, name="DegradeSlot")
