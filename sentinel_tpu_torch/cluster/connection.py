"""Namespace-scoped connection groups.

The port's copy of ``sentinel_tpu/cluster/connection.py``.

Analog of ``connection/ConnectionManager.java:35`` + ``ConnectionGroup.java``:
the token server groups client connections by the namespace they declared in
their PING handshake; each group's connected count feeds the AVG_LOCAL
threshold scaling (``ClusterFlowChecker.java:43-47`` →
``rules.ns_connected`` in the device table here).

Instance-scoped rather than the reference's static map: every ``TokenServer``
owns one manager, so two embedded servers in one process (tests, multi-pod
dryruns) don't share groups.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

from sentinel_tpu_torch.core import clock as _clock


class ConnectionManager:
    def __init__(
        self, on_count_changed: Optional[Callable[[str, int], None]] = None
    ):
        self._lock = threading.Lock()
        self._groups: Dict[str, Set[str]] = {}
        # address → namespaces it registered (one connection may serve
        # several namespaces; each PING adds one)
        self._by_address: Dict[str, Set[str]] = {}
        # address → last activity ms (PING or any request), for the idle
        # sweep (ScanIdleConnectionTask.java analog)
        self._last_active_ms: Dict[str, int] = {}
        # address → transport closer; the sweep CLOSES reaped connections
        # (like the reference closing the netty channel) so a client that
        # was merely quiet reconnects + re-PINGs and is counted again
        self._closers: Dict[str, Callable[[], None]] = {}
        self._on_count_changed = on_count_changed

    def attach_closer(self, address: str, closer: Callable[[], None]) -> None:
        """Register the transport-close hook for a connection (thread-safe
        callable; the server passes a loop.call_soon_threadsafe wrapper).

        Also seeds the liveness stamp: the reference tracks every accepted
        channel from its first activity, so a socket that connects but never
        PINGs must still age out of the idle sweep instead of being held
        open forever."""
        with self._lock:
            self._closers[address] = closer
            self._last_active_ms.setdefault(address, _clock.now_ms())

    def add(self, namespace: str, address: str) -> int:
        """Register; returns the group's connected count (PING response)."""
        with self._lock:
            group = self._groups.setdefault(namespace, set())
            group.add(address)
            self._by_address.setdefault(address, set()).add(namespace)
            self._last_active_ms[address] = _clock.now_ms()
            n = len(group)
        if self._on_count_changed is not None:
            self._on_count_changed(namespace, n)
        return n

    def touch(self, address: str) -> None:
        """Refresh a connection's liveness (any request counts, like the
        reference updating ``Connection.lastReadTime`` per channelRead)."""
        if address in self._last_active_ms:  # racy pre-check is fine: worst
            with self._lock:  # case a just-removed address gets a stale stamp
                if address in self._last_active_ms:
                    self._last_active_ms[address] = _clock.now_ms()

    def sweep_idle(self, ttl_ms: float) -> List[str]:
        """Close + drop connections with no PING/request inside ``ttl_ms``;
        returns the reaped addresses. ``ScanIdleConnectionTask.java`` analog:
        a wedged client must not inflate AVG_LOCAL connected counts forever
        (thresholds would stay too high). Closing the transport — not just
        deregistering — means a merely-quiet client notices, reconnects, and
        re-PINGs back into its group instead of being undercounted forever."""
        now = _clock.now_ms()
        with self._lock:
            stale = [
                addr for addr, ts in self._last_active_ms.items()
                if now - ts > ttl_ms
            ]
            closers = [self._closers.get(a) for a in stale]
        for addr, closer in zip(stale, closers):
            if closer is not None:
                try:
                    closer()
                except Exception:
                    pass
            self.remove_address(addr)
        return stale

    def remove_address(self, address: str) -> None:
        """Drop every registration of a disconnected client."""
        changed: List[tuple] = []
        with self._lock:
            self._last_active_ms.pop(address, None)
            self._closers.pop(address, None)
            for ns in self._by_address.pop(address, ()):
                group = self._groups.get(ns)
                if group is not None:
                    group.discard(address)
                    changed.append((ns, len(group)))
                    if not group:
                        del self._groups[ns]
        if self._on_count_changed is not None:
            for ns, n in changed:
                self._on_count_changed(ns, n)

    def connected_count(self, namespace: str) -> int:
        with self._lock:
            return len(self._groups.get(namespace, ()))

    def namespaces(self) -> List[str]:
        with self._lock:
            return sorted(self._groups)

    def snapshot(self) -> Dict[str, List[str]]:
        """namespace → sorted addresses (FetchClusterServerInfo shape)."""
        with self._lock:
            return {ns: sorted(g) for ns, g in self._groups.items()}


class IdleConnectionSweeper:
    """Periodic ``sweep_idle`` driver (``ScanIdleConnectionTask.java``: the
    reference schedules it at fixed rate on the server's scheduler pool).

    The period is wall-clock (daemon timer); the idle judgment itself uses
    the injectable ``core.clock`` so tests advance a ManualClock and call
    ``sweep_idle`` directly.
    """

    def __init__(self, connections: ConnectionManager, ttl_s: float = 600.0,
                 period_s: Optional[float] = None):
        self.connections = connections
        self.ttl_ms = ttl_s * 1000.0
        self.period_s = period_s if period_s is not None else max(ttl_s / 2, 0.5)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="sentinel-idle-conn-sweep", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        from sentinel_tpu_torch.core.log import record_log

        while not self._stop.wait(self.period_s):
            reaped = self.connections.sweep_idle(self.ttl_ms)
            if reaped:
                record_log.info(
                    "idle sweep reaped %d connection(s): %s",
                    len(reaped), ", ".join(reaped),
                )
