"""Millisecond clock with explicit injection for deterministic tests.

Host-only copy of ``sentinel_tpu/core/clock.py`` (the port imports nothing of
the JAX package): every device step takes ``now_ms`` as an argument, and the
host obtains it from a swappable :class:`Clock`. Tests install a
:class:`ManualClock`. While chaos is armed, :func:`now_ms` adds the
``clock_skew`` offset, as the reference does.
"""

from __future__ import annotations

import threading
import time

from sentinel_tpu_torch import chaos as _chaos


class Clock:
    """Source of wall-clock milliseconds. Subclass to virtualize time."""

    def now_ms(self) -> int:
        raise NotImplementedError

    def wait_ms(self, ms: float) -> None:
        """Block for ``ms``; virtual clocks advance instead of sleeping."""
        raise NotImplementedError


class SystemClock(Clock):
    __slots__ = ()

    def now_ms(self) -> int:
        return time.time_ns() // 1_000_000

    def wait_ms(self, ms: float) -> None:
        if ms > 0:
            time.sleep(ms / 1000.0)


class ManualClock(Clock):
    """Deterministic clock for tests."""

    __slots__ = ("_ms",)

    def __init__(self, start_ms: int = 1_700_000_000_000):
        self._ms = int(start_ms)

    def now_ms(self) -> int:
        return self._ms

    def wait_ms(self, ms: float) -> None:
        if ms > 0:
            self._ms += int(ms)

    def set_ms(self, ms: int) -> None:
        self._ms = int(ms)

    def advance(self, delta_ms: int) -> None:
        self._ms += int(delta_ms)

    def sleep(self, delta_ms: int) -> None:
        self.advance(delta_ms)

    def sleep_second(self, seconds: int = 1) -> None:
        self.advance(seconds * 1000)


_lock = threading.Lock()
_clock: Clock = SystemClock()


def get_clock() -> Clock:
    return _clock


def set_clock(clock: Clock) -> Clock:
    """Install a process-global clock; returns the previous one."""
    global _clock
    with _lock:
        prev, _clock = _clock, clock
        return prev


def now_ms() -> int:
    if _chaos.ARMED:  # clock_skew injection (constant offset while armed)
        return _clock.now_ms() + int(_chaos.skew_ms())
    return _clock.now_ms()
