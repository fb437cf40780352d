"""Scheduled metric pull from every healthy machine.

Analog of ``metric/MetricFetcher.java:70-210``: for each app, poll each
healthy machine's ``/metric`` command for the window since the last fetch,
sum the per-machine lines by (resource, second), and store into the
repository. The reference trails real time by a few seconds so machines have
flushed their metric logs; same here (``FETCH_DELAY_MS``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.dashboard.api_client import ApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement
from sentinel_tpu_torch.dashboard.repository import InMemoryMetricsRepository, MetricEntry

FETCH_DELAY_MS = 2_000  # let apps flush their 1s aggregation first
MAX_WINDOW_MS = 60_000  # don't backfill more than a minute on catch-up


class MetricFetcher:
    def __init__(
        self,
        apps: AppManagement,
        repository: InMemoryMetricsRepository,
        client: Optional[ApiClient] = None,
        interval_s: float = 1.0,
    ):
        self.apps = apps
        self.repository = repository
        self.client = client or ApiClient()
        self.interval_s = interval_s
        # (app, machine-key) → end of that machine's last successful window.
        # Per-machine windows: one machine timing out must not advance the
        # others' (or its own) window past data not yet pulled.
        self._last_fetch: Dict[tuple, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def fetch_once(self, app: str) -> int:
        """Pull each machine's pending window for ``app``; returns the number
        of entries merged into the repository.

        Cross-machine sums by (resource, second) happen in the repository
        (``save_all(..., merge=True)``): each machine's lines are fetched
        exactly once, so merge-adds are safe even when machines are on
        different catch-up windows.
        """
        now = _clock.now_ms()
        end = now - FETCH_DELAY_MS
        stored = 0
        healthy = self.apps.healthy_machines(app)
        # prune cursors for machine incarnations that left discovery entirely
        # (pods restarting on ephemeral ports would otherwise leak one key
        # per incarnation); still-registered-but-dead machines keep theirs
        registered = {(app, m.key) for m in self.apps.machines(app)}
        for key in [
            k for k in self._last_fetch if k[0] == app and k not in registered
        ]:
            del self._last_fetch[key]
        for machine in healthy:
            key = (app, machine.key)
            # MetricSearcher windows are inclusive on both ends, so the next
            # window starts one ms after the last — a second-aligned line at
            # exactly the boundary must not be fetched (and merge-summed) twice
            start = self._last_fetch.get(key, end - 5_000 - 1) + 1
            if end < start:
                continue
            start = max(start, end - MAX_WINDOW_MS)
            nodes = self.client.fetch_metrics(machine, start, end)
            if nodes is None:
                continue  # transport failure: retry the same window next tick
            entries = [
                MetricEntry(
                    app=app,
                    resource=node.resource,
                    timestamp_ms=node.timestamp_ms,
                    pass_qps=node.pass_qps,
                    block_qps=node.block_qps,
                    success_qps=node.success_qps,
                    exception_qps=node.exception_qps,
                    rt=node.rt,
                    # machine tag feeds the per-machine drill-down series;
                    # the merged app-wide series strips it on save
                    machine=machine.key,
                )
                for node in nodes
            ]
            self.repository.save_all(entries, merge=True)
            self._last_fetch[key] = end
            stored += len(entries)
        return stored

    def prune_dead_apps(self, live_apps) -> None:
        """Drop cursors of apps that left discovery entirely — fetch_once
        prunes per-machine cursors within a live app, but never visits a
        vanished app, so ephemeral per-deploy app names would otherwise leak
        one cursor set each."""
        live = set(live_apps)
        for key in [k for k in self._last_fetch if k[0] not in live]:
            del self._last_fetch[key]

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            live_apps = self.apps.apps()
            self.prune_dead_apps(live_apps)
            for app in live_apps:
                try:
                    self.fetch_once(app)
                except Exception:
                    record_log.exception("metric fetch for %s failed", app)

    def start(self) -> "MetricFetcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="sentinel-metric-fetcher"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            if thread.is_alive():
                return
            self._thread = None
        self._stop.clear()
