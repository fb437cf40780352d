"""Prometheus-format metric exporter (analog of ``sentinel-metric-exporter``;
the port's copy of ``sentinel_tpu/metrics/exporter.py``).

The reference exposes one JMX MBean per resource, refreshed by a collector
(``exporter/jmx/{JMXMetricExporter,MBeanRegistry,MetricBeanWriter}.java``);
the Python-ecosystem equivalent is a Prometheus scrape endpoint. Rendering
happens at scrape time straight off the live ``ClusterNode`` windows — no
refresh thread needed (Prometheus pulls; JMX needed push-into-beans).

Exposed series (labels: ``resource``):

- ``sentinel_pass_qps`` / ``sentinel_block_qps`` / ``sentinel_success_qps``
  / ``sentinel_exception_qps`` — 1s-window rates
- ``sentinel_rt_avg_ms`` — average response time over the window
- ``sentinel_concurrency`` — current in-flight entries

Alongside the window gauges, two cumulative ``counter`` series
(``sentinel_pass_total`` / ``sentinel_block_total``, fed by a built-in
:class:`MetricExtension` on the entry hot path) give scrapers proper
``rate()``-able totals, and the body ends with the token server's
``sentinel_server_*`` section (:mod:`sentinel_tpu_torch.metrics.server`). The
exposition is 0.0.4: newline-terminated, no ``# EOF`` marker (that is
OpenMetrics 1.0; sending it under the 0.0.4 content type breaks strict
parsers).

Serve standalone via :class:`PrometheusExporter` (its own port, like the
JMX exporter's own registry), or mount :func:`render` under any existing
HTTP surface (the command center registers it at ``/metric/prometheus``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.httpd import HttpService, Response
from sentinel_tpu_torch.datasource import base as _datasource_base
from sentinel_tpu_torch.local import chain as _chain
from sentinel_tpu_torch.metrics import extension as _ext
from sentinel_tpu_torch.metrics.ha import ha_metrics
from sentinel_tpu_torch.metrics.server import server_metrics

_HELP = """\
# HELP sentinel_pass_qps Admitted requests per second (1s sliding window).
# TYPE sentinel_pass_qps gauge
# HELP sentinel_block_qps Blocked requests per second (1s sliding window).
# TYPE sentinel_block_qps gauge
# HELP sentinel_success_qps Completed requests per second (1s sliding window).
# TYPE sentinel_success_qps gauge
# HELP sentinel_exception_qps Business exceptions per second (1s sliding window).
# TYPE sentinel_exception_qps gauge
# HELP sentinel_rt_avg_ms Average response time over the 1s window.
# TYPE sentinel_rt_avg_ms gauge
# HELP sentinel_concurrency Current in-flight entries.
# TYPE sentinel_concurrency gauge
"""


def _escape(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _CumulativeCounters(_ext.MetricExtension):
    """Built-in extension feeding ``sentinel_pass_total`` /
    ``sentinel_block_total`` — the window gauges answer "how fast right
    now", these answer "how much since start", which is what Prometheus
    ``rate()``/``increase()`` want as input."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pass: Dict[str, int] = {}
        self._block: Dict[str, int] = {}

    def add_pass(self, resource: str, n: int, args) -> None:
        with self._lock:
            self._pass[resource] = self._pass.get(resource, 0) + n

    def add_block(self, resource: str, n: int, origin, error, args) -> None:
        with self._lock:
            self._block[resource] = self._block.get(resource, 0) + n

    def totals(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        with self._lock:
            return dict(self._pass), dict(self._block)

    def reset(self) -> None:
        with self._lock:
            self._pass.clear()
            self._block.clear()


_COUNTERS = _CumulativeCounters()
_ENSURE_LOCK = threading.Lock()


def _ensure_counters_registered() -> None:
    """(Re)register the counter extension. ``clear_extensions_for_tests``
    wipes the registry between tests; re-arming at render time (with a data
    reset, so each re-arm starts a fresh cumulative epoch) keeps production
    monotonic and tests deterministic."""
    with _ENSURE_LOCK:
        if _COUNTERS not in _ext.get_extensions():
            _COUNTERS.reset()
            _ext.register_extension(_COUNTERS)


_ensure_counters_registered()

_COUNTER_HELP = """\
# HELP sentinel_pass_total Admitted requests since process start.
# TYPE sentinel_pass_total counter
# HELP sentinel_block_total Blocked requests since process start.
# TYPE sentinel_block_total counter\
"""

_START_TIME_S = time.time()


def build_info() -> Dict[str, str]:
    """Identity labels for ``sentinel_build_info`` — also stamped into
    bench artifacts and black-box dumps so any saved document names the
    build that produced it. ``torch_backend`` is ``cuda`` where torch sees a
    card, else ``cpu`` (the reference's ``jax_backend`` label)."""
    import torch

    from sentinel_tpu_torch import __version__
    from sentinel_tpu_torch.cluster.protocol import WIRE_REV

    return {
        "version": __version__,
        "wire_rev": str(WIRE_REV),
        "torch_backend": "cuda" if torch.cuda.is_available() else "cpu",
    }


def uptime_seconds() -> float:
    """Seconds since this process imported the exporter (the scrape
    surface's lifetime — counter resets correlate with this going to 0)."""
    return time.time() - _START_TIME_S


def _render_build_info() -> str:
    info = build_info()
    labels = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(info.items()))
    return (
        "# HELP sentinel_build_info Build identity (constant 1; labels "
        "carry version, wire rev, torch backend).\n"
        "# TYPE sentinel_build_info gauge\n"
        f"sentinel_build_info{{{labels}}} 1\n"
        "# HELP sentinel_server_uptime_seconds Seconds since process "
        "start (exporter import).\n"
        "# TYPE sentinel_server_uptime_seconds gauge\n"
        f"sentinel_server_uptime_seconds {uptime_seconds():g}"
    )


def render(now_ms: Optional[int] = None) -> str:
    """Prometheus text exposition: per-resource window gauges + cumulative
    counters + the token server's ``sentinel_server_*`` section (which
    carries the ``sentinel_sketch_*`` param-sketch series)."""
    _ensure_counters_registered()
    now = _clock.now_ms() if now_ms is None else now_ms
    lines = [_HELP.rstrip("\n")]
    node_map = _chain.cluster_node_map()
    for name, node in sorted(node_map.items()):
        label = f'{{resource="{_escape(name)}"}}'
        success = node.success_qps(now)
        avg_rt = node.avg_rt(now)
        for metric, value in (
            ("sentinel_pass_qps", node.pass_qps(now)),
            ("sentinel_block_qps", node.block_qps(now)),
            ("sentinel_success_qps", success),
            ("sentinel_exception_qps", node.exception_qps(now)),
            ("sentinel_rt_avg_ms", avg_rt),
            ("sentinel_concurrency", node.cur_thread_num),
        ):
            lines.append(f"{metric}{label} {value:g}")
    passed, blocked = _COUNTERS.totals()
    lines.append(_COUNTER_HELP)
    for name in sorted(set(node_map) | set(passed) | set(blocked)):
        label = f'{{resource="{_escape(name)}"}}'
        lines.append(f"sentinel_pass_total{label} {passed.get(name, 0)}")
        lines.append(f"sentinel_block_total{label} {blocked.get(name, 0)}")
    lines.append(
        "# HELP sentinel_datasource_refresh_failures_total Failed rule "
        "datasource refreshes (read or parse), by datasource class."
    )
    lines.append("# TYPE sentinel_datasource_refresh_failures_total counter")
    failures = _datasource_base.refresh_failure_totals()
    if failures:
        for name, count in sorted(failures.items()):
            lines.append(
                "sentinel_datasource_refresh_failures_total"
                f'{{source="{_escape(name)}"}} {count}'
            )
    else:
        lines.append(
            'sentinel_datasource_refresh_failures_total{source=""} 0'
        )
    lines.append(server_metrics().render())
    lines.append(ha_metrics().render())
    # client-side receive accounting (import deferred: cluster.client pulls
    # in the token-service stack, which this module must not load eagerly)
    from sentinel_tpu_torch.cluster import client as _client

    lines.append(
        "# HELP sentinel_client_recv_bytes_total Bytes received from token "
        "servers by this process's client readers."
    )
    lines.append("# TYPE sentinel_client_recv_bytes_total counter")
    lines.append(
        f"sentinel_client_recv_bytes_total "
        f"{_client.client_recv_bytes_total()}"
    )
    lines.append(
        "# HELP sentinel_client_recv_buf_grows_total Growable receive "
        "buffer expansions across client readers."
    )
    lines.append("# TYPE sentinel_client_recv_buf_grows_total counter")
    lines.append(
        f"sentinel_client_recv_buf_grows_total "
        f"{_client.client_recv_buf_grows_total()}"
    )
    lines.append(
        "# HELP sentinel_client_unknown_frames_total Frames with a type "
        "byte this build doesn't speak, skipped by client readers instead "
        "of dropping the connection (mixed-rev rollout canary)."
    )
    lines.append("# TYPE sentinel_client_unknown_frames_total counter")
    lines.append(
        f"sentinel_client_unknown_frames_total "
        f"{_client.client_unknown_frames_total()}"
    )
    # DCN-tier aggregation health (import deferred for the same reason)
    from sentinel_tpu_torch.cluster import namespaces as _namespaces

    lines.append(
        "# HELP sentinel_assignment_snapshot_errors_total Pod metric "
        "snapshots that failed (raised or were malformed) during "
        "cross-pod aggregation."
    )
    lines.append(
        "# TYPE sentinel_assignment_snapshot_errors_total counter"
    )
    lines.append(
        f"sentinel_assignment_snapshot_errors_total "
        f"{_namespaces.snapshot_error_total()}"
    )
    lines.append(
        "# HELP sentinel_assignment_move_dedup_total Mid-MOVE duplicate "
        "flow copies dropped during cross-pod aggregation (source pod "
        "still reporting a moved namespace's frozen window)."
    )
    lines.append(
        "# TYPE sentinel_assignment_move_dedup_total counter"
    )
    lines.append(
        f"sentinel_assignment_move_dedup_total "
        f"{_namespaces.move_dedup_total()}"
    )
    # per-tenant SLO plane (burn rates, latency, shed attribution)
    from sentinel_tpu_torch.trace.slo import slo_plane

    lines.append(slo_plane().render())
    lines.append(_render_build_info())
    return "\n".join(lines) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class PrometheusExporter:
    """Standalone scrape endpoint: ``GET /metrics``."""

    def __init__(self, host: str = "0.0.0.0", port: int = 9092):
        self._service = HttpService(self._route, host, port, "prom-exporter")

    def _route(self, method: str, path: str, params: dict, body: str) -> Response:
        if method == "GET" and path in ("metrics", ""):
            return (200, render(), CONTENT_TYPE)
        return (404, "not found\n", "text/plain")

    def start(self) -> "PrometheusExporter":
        self._service.start()
        return self

    @property
    def port(self) -> int:
        return self._service.port

    def stop(self) -> None:
        self._service.stop()
