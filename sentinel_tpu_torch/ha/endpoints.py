"""Per-endpoint health: exponential backoff + jitter, half-open breaker
(the port's copy of ``sentinel_tpu/ha/endpoints.py``).

The failover client needs one judgment per endpoint: "may I send the next
request here?" This module answers it with a three-state circuit breaker:

- **CLOSED** (healthy): requests flow; failures accumulate.
- **OPEN** (down): after ``failure_threshold`` consecutive failures the
  endpoint is evicted; re-probe no earlier than an exponentially growing,
  jittered backoff (``base_ms · 2^(k-1)``, capped at ``max_ms``).
- **HALF_OPEN**: the backoff elapsed; exactly ONE probe request is let
  through. Success closes the breaker, failure re-opens it with a longer
  backoff. Because only ``record_success``/``record_failure`` leave this
  state, callers must treat an admitted probe as a commitment: consult
  ``allows_request()`` immediately before dispatching to the endpoint,
  never speculatively for endpoints that might not be tried. As a backstop
  against a prober that dies without reporting, a probe that hasn't been
  answered within a backoff-length grace window forfeits its slot and the
  next ``allows_request()`` admits a fresh probe.

Time comes from the injectable ``core.clock`` so tests drive the state
machine with a ``ManualClock``; jitter comes from an injectable uniform
source for the same reason. Thread-safe: the failover client calls this from
whatever thread carries the request.
"""

from __future__ import annotations

import enum
import random
import threading
from dataclasses import dataclass

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig

# SentinelConfig keys (defaults registered in core.config._DEFAULTS)
KEY_FAILURE_THRESHOLD = "sentinel.tpu.ha.failure.threshold"
KEY_BACKOFF_BASE_MS = "sentinel.tpu.ha.backoff.base.ms"
KEY_BACKOFF_MAX_MS = "sentinel.tpu.ha.backoff.max.ms"
KEY_BACKOFF_JITTER = "sentinel.tpu.ha.backoff.jitter"


@dataclass(frozen=True)
class Endpoint:
    """One token-server address in the ordered endpoint list."""

    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


class HealthState(enum.IntEnum):
    CLOSED = 0  # healthy
    OPEN = 1  # evicted, waiting out the backoff
    HALF_OPEN = 2  # backoff elapsed; one probe in flight


class EndpointHealth:
    """Circuit-breaker state for one endpoint."""

    def __init__(
        self,
        failure_threshold: int = None,
        backoff_base_ms: float = None,
        backoff_max_ms: float = None,
        jitter: float = None,
        rand=random.random,
    ):
        self.failure_threshold = max(1, int(
            failure_threshold
            if failure_threshold is not None
            else SentinelConfig.get_int(KEY_FAILURE_THRESHOLD, 3)
        ))
        self.backoff_base_ms = float(
            backoff_base_ms
            if backoff_base_ms is not None
            else SentinelConfig.get_float(KEY_BACKOFF_BASE_MS, 100.0)
        )
        self.backoff_max_ms = float(
            backoff_max_ms
            if backoff_max_ms is not None
            else SentinelConfig.get_float(KEY_BACKOFF_MAX_MS, 10_000.0)
        )
        self.jitter = float(
            jitter
            if jitter is not None
            else SentinelConfig.get_float(KEY_BACKOFF_JITTER, 0.2)
        )
        self._rand = rand
        self._lock = threading.Lock()
        self.state = HealthState.CLOSED
        self.consecutive_failures = 0
        self.retry_at_ms = 0
        self._opened = 0  # open cycles since last success → backoff exponent
        self._probe_deadline_ms = 0.0  # HALF_OPEN: when the probe forfeits

    # -- queries ------------------------------------------------------------
    def allows_request(self) -> bool:
        """May the next request go to this endpoint? An OPEN breaker whose
        backoff elapsed transitions to HALF_OPEN and admits exactly one
        probe (subsequent calls are refused until that probe reports).

        A ``True`` answer in non-CLOSED states hands out the probe slot, so
        call this only when the request WILL be dispatched to the endpoint —
        an admitted-but-never-sent probe would otherwise pin the breaker in
        HALF_OPEN until the grace window below reclaims it."""
        now = _clock.now_ms()
        with self._lock:
            if self.state == HealthState.CLOSED:
                return True
            if self.state == HealthState.OPEN:
                if now >= self.retry_at_ms:
                    self.state = HealthState.HALF_OPEN
                    self._probe_deadline_ms = now + self.backoff_ms()
                    return True
                return False
            # HALF_OPEN: one probe in flight — unless it was admitted a full
            # backoff ago and never reported (the dispatcher died before
            # calling record_*); then it forfeits and a fresh probe goes out
            if now >= self._probe_deadline_ms:
                self._probe_deadline_ms = now + self.backoff_ms()
                return True
            return False

    @property
    def healthy(self) -> bool:
        return self.state == HealthState.CLOSED

    def backoff_ms(self) -> float:
        """Jittered delay for the current open cycle (exponent capped so the
        doubling can't overflow long before max_ms clamps it)."""
        k = min(max(self._opened, 1), 32)
        raw = min(self.backoff_base_ms * (2 ** (k - 1)), self.backoff_max_ms)
        return raw * (1.0 + self.jitter * self._rand())

    # -- transitions ---------------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self.state = HealthState.CLOSED
            self.consecutive_failures = 0
            self.retry_at_ms = 0
            self._opened = 0

    def record_failure(self) -> None:
        now = _clock.now_ms()
        with self._lock:
            self.consecutive_failures += 1
            if self.state == HealthState.HALF_OPEN:
                # failed probe: straight back to OPEN with a longer backoff
                self._opened += 1
                self.state = HealthState.OPEN
                self.retry_at_ms = now + self.backoff_ms()
            elif (
                self.state == HealthState.CLOSED
                and self.consecutive_failures >= self.failure_threshold
            ):
                self._opened += 1
                self.state = HealthState.OPEN
                self.retry_at_ms = now + self.backoff_ms()

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state.name,
                "consecutiveFailures": self.consecutive_failures,
                "retryAtMs": int(self.retry_at_ms),
            }
