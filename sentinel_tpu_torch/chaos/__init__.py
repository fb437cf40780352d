"""Chaos fault-injection registry: env/config-armed, zero overhead when off.

The port's copy of ``sentinel_tpu/chaos/__init__.py``; both packages read
the same ``SENTINEL_CHAOS`` spec.

Robustness claims ("every request resolves, no deadlock, clean drain") are
only worth what the failure modes they survived are worth — so the serving
path carries explicit injection points and this registry decides, per event,
whether a fault fires. Six injectors cover the failure classes the cluster
subsystem must absorb:

``lane_delay``
    Sleep inside a serving lane (asyncio micro-batcher / native intake) —
    models a descheduled or GC-stalled host thread.
``frame_drop``
    A decoded request frame vanishes before the device sees it — models a
    lossy middlebox / dropped TCP segment past the kernel. The client's
    timeout is the only resolution path, which is exactly the invariant
    under test.
``frame_corrupt``
    Flip one byte of a wire buffer (outbound on the client, inbound in
    ``FrameReader``) — models bit rot and framing bugs; the peer must drop
    the connection gracefully, never a thread.
``device_stall``
    Sleep ahead of the device dispatch in ``TokenService`` — models a slow
    device step or a stalled GPU; backpressure and deadline shed must
    hold.
``clock_skew``
    Constant offset added to :func:`sentinel_tpu_torch.core.clock.now_ms` —
    models NTP step/drift against the windowed estimators.
``conn_reset``
    The client tears its socket down mid-request — models RST storms;
    breakers and reconnect backoff must absorb it.

Arming is explicit (:func:`arm`) or via the environment at import time::

    SENTINEL_CHAOS="lane_delay:p=0.2,ms=5;frame_drop:p=0.05" \
    SENTINEL_CHAOS_SEED=1234 python -m ...

Spec grammar: ``point[:k=v[,k=v...]]`` joined by ``;`` — keys are ``p``
(fire probability, default 1), ``ms`` (magnitude for delay/stall/skew,
default 0) and ``n`` (max firings, 0 = unlimited). A fixed seed makes a
chaos run reproducible; firings are counted per point (:func:`fired`) so
tests can assert a fault actually happened.

Hot paths guard every probe with the module attribute ``ARMED`` — one
attribute read when chaos is off, which is the "zero overhead" contract.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

# Module-level fast flag: call sites do `if chaos.ARMED and chaos.should(..)`
# so a disarmed process pays one attribute read per probe, nothing else.
ARMED = False

POINTS = (
    "lane_delay",
    "frame_drop",
    "frame_corrupt",
    "device_stall",
    "clock_skew",
    "conn_reset",
)

ENV_SPEC = "SENTINEL_CHAOS"
ENV_SEED = "SENTINEL_CHAOS_SEED"


@dataclass
class Injector:
    point: str
    p: float = 1.0  # fire probability per probe
    ms: float = 0.0  # magnitude (delay/stall/skew), milliseconds
    n: int = 0  # max firings; 0 = unlimited


def parse_spec(spec: str) -> Dict[str, Injector]:
    """``"lane_delay:p=0.2,ms=5;frame_drop"`` → {point: Injector}."""
    out: Dict[str, Injector] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, args = part.partition(":")
        name = name.strip()
        if name not in POINTS:
            raise ValueError(f"unknown chaos point {name!r} (valid: {POINTS})")
        inj = Injector(name)
        for kv in args.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k == "p":
                inj.p = float(v)
            elif k == "ms":
                inj.ms = float(v)
            elif k == "n":
                inj.n = int(v)
            else:
                raise ValueError(f"unknown chaos arg {k!r} in {part!r}")
        out[name] = inj
    return out


class ChaosRegistry:
    """Thread-safe injector set + seeded RNG + per-point fire counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inj: Dict[str, Injector] = {}
        self._rng = random.Random()
        self._fired: Dict[str, int] = {}

    # -- arming -------------------------------------------------------------
    def arm(
        self,
        spec: Union[str, Dict[str, Injector]],
        seed: Optional[int] = None,
    ) -> None:
        global ARMED
        inj = parse_spec(spec) if isinstance(spec, str) else dict(spec)
        with self._lock:
            self._inj = inj
            self._fired = {}
            if seed is not None:
                self._rng = random.Random(seed)
        ARMED = bool(inj)

    def disarm(self) -> None:
        global ARMED
        with self._lock:
            self._inj = {}
            self._fired = {}
        ARMED = False

    def arm_from_env(self, environ=None) -> bool:
        """Arm from ``SENTINEL_CHAOS``/``SENTINEL_CHAOS_SEED``; returns
        whether anything armed. Called once at import."""
        env = os.environ if environ is None else environ
        spec = env.get(ENV_SPEC, "").strip()
        if not spec:
            return False
        seed = env.get(ENV_SEED)
        self.arm(spec, seed=int(seed) if seed else None)
        return True

    # -- introspection ------------------------------------------------------
    @property
    def armed(self) -> bool:
        return bool(self._inj)

    def injectors(self) -> Dict[str, Injector]:
        with self._lock:
            return dict(self._inj)

    def fired(self) -> Dict[str, int]:
        """Per-point firing counts since arm() — chaos tests assert the
        fault under test actually happened."""
        with self._lock:
            return dict(self._fired)

    # -- probes (hot path; call only behind `chaos.ARMED`) ------------------
    def should(self, point: str) -> bool:
        inj = self._inj.get(point)
        if inj is None:
            return False
        with self._lock:
            if inj.n and self._fired.get(point, 0) >= inj.n:
                return False
            if inj.p < 1.0 and self._rng.random() >= inj.p:
                return False
            self._fired[point] = self._fired.get(point, 0) + 1
        return True

    def delay_s(self, point: str) -> float:
        inj = self._inj.get(point)
        if inj is None or inj.ms <= 0:
            return 0.0
        return inj.ms / 1000.0 if self.should(point) else 0.0

    def maybe_sleep(self, point: str) -> None:
        d = self.delay_s(point)
        if d:
            time.sleep(d)

    def mangle(self, point: str, data: bytes) -> bytes:
        """Flip one byte of ``data`` when the injector fires."""
        if not data or not self.should(point):
            return data
        buf = bytearray(data)
        with self._lock:
            i = self._rng.randrange(len(buf))
        buf[i] ^= 0xFF
        return bytes(buf)

    def skew_ms(self) -> float:
        """Constant clock offset while a ``clock_skew`` injector is armed
        (not probabilistic — a skewed clock stays skewed)."""
        inj = self._inj.get("clock_skew")
        return inj.ms if inj is not None else 0.0


_REG = ChaosRegistry()


def registry() -> ChaosRegistry:
    return _REG


# module-level aliases so call sites read `chaos.should(...)`
def arm(spec, seed: Optional[int] = None) -> None:
    _REG.arm(spec, seed=seed)


def disarm() -> None:
    _REG.disarm()


def should(point: str) -> bool:
    return _REG.should(point)


def delay_s(point: str) -> float:
    return _REG.delay_s(point)


def maybe_sleep(point: str) -> None:
    _REG.maybe_sleep(point)


def mangle(point: str, data: bytes) -> bytes:
    return _REG.mangle(point, data)


def skew_ms() -> float:
    return _REG.skew_ms()


def fired() -> Dict[str, int]:
    return _REG.fired()


_REG.arm_from_env()
