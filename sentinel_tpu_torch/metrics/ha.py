"""HA counters: failover, fallback, and snapshot events.

The port's copy of ``sentinel_tpu/metrics/ha.py``.

Companion of :mod:`sentinel_tpu_torch.metrics.server` for the cluster HA subsystem
(the reference's `ha` package): the failover client counts endpoint evictions, the
local fallback policy counts degraded verdicts, and the snapshot manager
counts save/restore cycles. One process-wide singleton, rendered under the
Prometheus surface (``sentinel_failover_total`` / ``sentinel_fallback_total``
/ ``sentinel_snapshot_total``) and as JSON for bench artifacts.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


def _escape(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class HaMetrics:
    """Failover/fallback/snapshot counters for this process."""

    def __init__(self):
        self._lock = threading.Lock()
        # (from_endpoint, to_endpoint) → count; to="" means "no endpoint
        # left" (the request degraded to the local fallback path)
        self._failover: Dict[Tuple[str, str], int] = {}
        # action → count: pass | block | throttle_pass | throttle_block |
        # rls_allow | rls_deny
        self._fallback: Dict[str, int] = {}
        self._snapshot: Dict[str, int] = {}  # op → count: save | restore
        self._last_failover_ms = 0
        # warm-standby replication (ha.replication): event → count, where
        # event ∈ shipped | applied | snapshot | need_snapshot | reconnect |
        # error | promoted
        self._repl: Dict[str, int] = {}
        self._repl_bytes = 0
        # acked end-to-end delta age, as observed by the sender (wall-clock
        # ms between export_delta's capture and the standby's ACK)
        self._repl_lag_ms = 0.0
        # live shard rebalancing (cluster.rebalance): event → count, where
        # event ∈ begin | commit | abort | advise
        self._rebalance: Dict[str, int] = {}
        self._rebalance_bytes = 0  # MOVE_STATE payload bytes shipped
        self._rebalance_redirects = 0  # MOVED verdicts answered
        # end-to-end move duration (begin → commit ack), wall-clock ms
        from sentinel_tpu_torch.metrics.histogram import LatencyHistogram

        self._move_ms = LatencyHistogram(lo=1.0, hi=60_000.0)

    # -- writers ------------------------------------------------------------
    def count_failover(self, from_endpoint: str, to_endpoint: str,
                       now_ms: int = 0) -> None:
        key = (from_endpoint, to_endpoint)
        with self._lock:
            self._failover[key] = self._failover.get(key, 0) + 1
            if now_ms:
                self._last_failover_ms = now_ms

    def count_fallback(self, action: str, n: int = 1) -> None:
        with self._lock:
            self._fallback[action] = self._fallback.get(action, 0) + n

    def count_snapshot(self, op: str) -> None:
        with self._lock:
            self._snapshot[op] = self._snapshot.get(op, 0) + 1

    def count_repl(self, event: str, n: int = 1) -> None:
        with self._lock:
            self._repl[event] = self._repl.get(event, 0) + n

    def add_repl_bytes(self, n: int) -> None:
        with self._lock:
            self._repl_bytes += int(n)

    def set_repl_lag(self, ms: float) -> None:
        with self._lock:
            self._repl_lag_ms = float(ms)

    def count_rebalance(self, event: str, n: int = 1) -> None:
        with self._lock:
            self._rebalance[event] = self._rebalance.get(event, 0) + n

    def add_rebalance_state_bytes(self, n: int) -> None:
        with self._lock:
            self._rebalance_bytes += int(n)

    def count_rebalance_redirects(self, n: int = 1) -> None:
        with self._lock:
            self._rebalance_redirects += int(n)

    def observe_move_ms(self, ms: float) -> None:
        self._move_ms.record(float(ms))  # histogram is itself thread-safe

    # -- readers ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "failover": [
                    {"from": f, "to": t, "count": c}
                    for (f, t), c in sorted(self._failover.items())
                ],
                "fallback": dict(sorted(self._fallback.items())),
                "snapshots": dict(sorted(self._snapshot.items())),
                "lastFailoverMs": self._last_failover_ms,
                "replication": {
                    "events": dict(sorted(self._repl.items())),
                    "bytesTotal": self._repl_bytes,
                    "lagMs": self._repl_lag_ms,
                },
                "rebalance": {
                    "events": dict(sorted(self._rebalance.items())),
                    "stateBytesTotal": self._rebalance_bytes,
                    "redirectsTotal": self._rebalance_redirects,
                    "moveMs": self._move_ms.snapshot(),
                },
            }

    def fallback_totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fallback)

    def render(self) -> str:
        """Prometheus exposition (no trailing newline; the exporter joins
        sections)."""
        lines = [
            "# HELP sentinel_failover_total Token-client endpoint failovers "
            "(from → to; to=\"\" means degraded to local fallback).",
            "# TYPE sentinel_failover_total counter",
        ]
        with self._lock:
            failover = sorted(self._failover.items())
            fallback = sorted(self._fallback.items())
            snapshots = sorted(self._snapshot.items())
        if failover:
            for (f, t), count in failover:
                lines.append(
                    "sentinel_failover_total"
                    f'{{from="{_escape(f)}",to="{_escape(t)}"}} {count}'
                )
        else:
            lines.append('sentinel_failover_total{from="",to=""} 0')
        lines.append(
            "# HELP sentinel_fallback_total Requests resolved by the local "
            "fallback policy, by action."
        )
        lines.append("# TYPE sentinel_fallback_total counter")
        if fallback:
            for action, count in fallback:
                lines.append(
                    f'sentinel_fallback_total{{action="{_escape(action)}"}}'
                    f" {count}"
                )
        else:
            lines.append('sentinel_fallback_total{action="pass"} 0')
        lines.append(
            "# HELP sentinel_snapshot_total Token-server state snapshot "
            "operations."
        )
        lines.append("# TYPE sentinel_snapshot_total counter")
        if snapshots:
            for op, count in snapshots:
                lines.append(
                    f'sentinel_snapshot_total{{op="{_escape(op)}"}} {count}'
                )
        else:
            lines.append('sentinel_snapshot_total{op="save"} 0')
        with self._lock:
            repl = sorted(self._repl.items())
            repl_bytes = self._repl_bytes
            repl_lag = self._repl_lag_ms
        lines.append(
            "# HELP sentinel_repl_deltas_total Warm-standby replication "
            "events (shipped/applied/snapshot/need_snapshot/reconnect/"
            "error/promoted)."
        )
        lines.append("# TYPE sentinel_repl_deltas_total counter")
        if repl:
            for event, count in repl:
                lines.append(
                    "sentinel_repl_deltas_total"
                    f'{{event="{_escape(event)}"}} {count}'
                )
        else:
            lines.append('sentinel_repl_deltas_total{event="shipped"} 0')
        lines.append(
            "# HELP sentinel_repl_bytes_total Replication payload bytes "
            "shipped to standbys."
        )
        lines.append("# TYPE sentinel_repl_bytes_total counter")
        lines.append(f"sentinel_repl_bytes_total {repl_bytes}")
        lines.append(
            "# HELP sentinel_repl_lag_ms Age of the last acked delta "
            "(capture → standby ACK, wall-clock ms)."
        )
        lines.append("# TYPE sentinel_repl_lag_ms gauge")
        lines.append(f"sentinel_repl_lag_ms {repl_lag:g}")
        with self._lock:
            rebalance = sorted(self._rebalance.items())
            reb_bytes = self._rebalance_bytes
            reb_redirects = self._rebalance_redirects
        lines.append(
            "# HELP sentinel_rebalance_moves_total Live namespace-move "
            "protocol events (begin/commit/abort) and sustained-pressure "
            "advisories (advise)."
        )
        lines.append("# TYPE sentinel_rebalance_moves_total counter")
        if rebalance:
            for event, count in rebalance:
                lines.append(
                    "sentinel_rebalance_moves_total"
                    f'{{event="{_escape(event)}"}} {count}'
                )
        else:
            lines.append('sentinel_rebalance_moves_total{event="begin"} 0')
        lines.append(
            "# HELP sentinel_rebalance_state_bytes_total MOVE_STATE payload "
            "bytes shipped during namespace moves."
        )
        lines.append("# TYPE sentinel_rebalance_state_bytes_total counter")
        lines.append(f"sentinel_rebalance_state_bytes_total {reb_bytes}")
        lines.append(
            "# HELP sentinel_rebalance_redirects_total MOVED verdicts "
            "answered for flows of a moving (or moved-away) namespace."
        )
        lines.append("# TYPE sentinel_rebalance_redirects_total counter")
        lines.append(
            f"sentinel_rebalance_redirects_total {reb_redirects}"
        )
        lines.append(self._move_ms.render_prometheus(
            "sentinel_rebalance_move_duration_ms",
            "End-to-end namespace move duration (begin to commit ack, "
            "wall-clock ms).",
        ))
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._failover.clear()
            self._fallback.clear()
            self._snapshot.clear()
            self._last_failover_ms = 0
            self._repl.clear()
            self._repl_bytes = 0
            self._repl_lag_ms = 0.0
            self._rebalance.clear()
            self._rebalance_bytes = 0
            self._rebalance_redirects = 0
            self._move_ms.reset()


_SINGLETON = HaMetrics()


def ha_metrics() -> HaMetrics:
    """The process-wide HA metrics registry."""
    return _SINGLETON


def reset_ha_metrics_for_tests() -> None:
    _SINGLETON.reset()
