"""In-memory metric store with bounded retention.

Analog of ``repository/metric/InMemoryMetricsRepository.java:40-63``
(5-minute in-memory window, per app+resource).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.core import clock as _clock

RETENTION_MS = 5 * 60 * 1000  # InMemoryMetricsRepository.java:42


@dataclass
class MetricEntry:
    app: str
    resource: str
    timestamp_ms: int
    pass_qps: float = 0.0
    block_qps: float = 0.0
    success_qps: float = 0.0
    exception_qps: float = 0.0
    rt: float = 0.0
    machine: str = ""  # "ip:port" for per-machine series; "" = app-wide sum

    def to_dict(self) -> dict:
        return {
            "app": self.app,
            "resource": self.resource,
            "timestamp": self.timestamp_ms,
            "passQps": self.pass_qps,
            "blockQps": self.block_qps,
            "successQps": self.success_qps,
            "exceptionQps": self.exception_qps,
            "rt": self.rt,
            "machine": self.machine,
        }


class InMemoryMetricsRepository:
    def __init__(self, retention_ms: int = RETENTION_MS):
        self._lock = threading.Lock()
        self.retention_ms = retention_ms
        # (app, resource) → {timestamp → MetricEntry}
        self._store: Dict[Tuple[str, str], Dict[int, MetricEntry]] = {}
        # per-machine drill-down series (the reference's metric.js charts
        # one machine at a time): (app, machine, resource) → {ts → entry}
        self._machine_store: Dict[
            Tuple[str, str, str], Dict[int, MetricEntry]
        ] = {}
        self._last_sweep_ms = 0

    def save(self, entry: MetricEntry, merge: bool = False) -> None:
        with self._lock:
            series = self._store.setdefault((entry.app, entry.resource), {})
            existing = series.get(entry.timestamp_ms) if merge else None
            if existing is not None:
                existing.pass_qps += entry.pass_qps
                existing.block_qps += entry.block_qps
                existing.success_qps += entry.success_qps
                existing.exception_qps += entry.exception_qps
                existing.rt = max(existing.rt, entry.rt)
            else:
                # the app-wide series never carries a machine tag: merge
                # sums lines from several machines into one entry
                series[entry.timestamp_ms] = replace(entry, machine="")
            if entry.machine:
                mkey = (entry.app, entry.machine, entry.resource)
                self._machine_store.setdefault(mkey, {})[
                    entry.timestamp_ms
                ] = entry
            self._sweep_locked()

    def save_all(self, entries: List[MetricEntry], merge: bool = False) -> None:
        for e in entries:
            self.save(e, merge=merge)

    def _sweep_locked(self) -> None:
        """Evict past-retention entries across *all* series (at most once per
        second): idle series must age out too, or per-URL resource cardinality
        grows the store without bound."""
        now = _clock.now_ms()
        if now - self._last_sweep_ms < 1_000:
            return
        self._last_sweep_ms = now
        horizon = now - self.retention_ms
        for store in (self._store, self._machine_store):
            for key in list(store):
                series = store[key]
                for ts in [t for t in series if t < horizon]:
                    del series[ts]
                if not series:
                    del store[key]

    def query(
        self, app: str, resource: str, start_ms: int, end_ms: int
    ) -> List[MetricEntry]:
        horizon = _clock.now_ms() - self.retention_ms
        start_ms = max(start_ms, horizon)  # never serve past-retention data
        with self._lock:
            series = self._store.get((app, resource), {})
            # copies: merge-saves mutate stored entries in place, and readers
            # serialize outside the lock
            return sorted(
                (
                    replace(e)
                    for ts, e in series.items()
                    if start_ms <= ts <= end_ms
                ),
                key=lambda e: e.timestamp_ms,
            )

    def query_machine(
        self, app: str, machine: str, resource: str,
        start_ms: int, end_ms: int
    ) -> List[MetricEntry]:
        """One machine's own series for a resource (``metric.js`` drill-down
        analog) — the un-merged lines the fetcher pulled from that machine."""
        horizon = _clock.now_ms() - self.retention_ms
        start_ms = max(start_ms, horizon)
        with self._lock:
            series = self._machine_store.get((app, machine, resource), {})
            return sorted(
                (
                    replace(e)
                    for ts, e in series.items()
                    if start_ms <= ts <= end_ms
                ),
                key=lambda e: e.timestamp_ms,
            )

    def machines_of_resource(self, app: str, resource: str) -> List[str]:
        """Machines with live (in-retention) data for a resource."""
        horizon = _clock.now_ms() - self.retention_ms
        with self._lock:
            return sorted(
                m
                for (a, m, r), series in self._machine_store.items()
                if a == app and r == resource
                and any(t >= horizon for t in series)
            )

    @staticmethod
    def _by_volume(pairs, now: int, horizon: int) -> List[str]:
        """Resources sorted by last-minute pass+block volume, live
        (in-retention) series only — the reference's sidebar order. One
        implementation for the app-wide and per-machine views so the two
        sidebars can never diverge."""
        volume: Dict[str, float] = {}
        for resource, series in pairs:
            if not any(t >= horizon for t in series):
                continue
            volume[resource] = sum(
                e.pass_qps + e.block_qps
                for ts, e in series.items()
                if ts >= now - 60_000
            )
        return sorted(volume, key=lambda r: (-volume[r], r))

    def resources_of_machine(self, app: str, machine: str) -> List[str]:
        """One machine's resources sorted by its own recent volume
        (``identity.js`` analog: the per-machine resource view)."""
        now = _clock.now_ms()
        with self._lock:
            return self._by_volume(
                (
                    (resource, series)
                    for (a, m, resource), series
                    in self._machine_store.items()
                    if a == app and m == machine
                ),
                now, now - self.retention_ms,
            )

    def resources_of_app(self, app: str) -> List[str]:
        """Resources sorted by recent pass+block volume (the reference sorts
        the sidebar by last-minute QPS); past-retention series are excluded."""
        now = _clock.now_ms()
        with self._lock:
            return self._by_volume(
                (
                    (resource, series)
                    for (a, resource), series in self._store.items()
                    if a == app
                ),
                now, now - self.retention_ms,
            )
