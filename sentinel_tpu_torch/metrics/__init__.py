"""Metric pipeline (the port's copy of ``sentinel_tpu/metrics``): 1-second
aggregation of every resource's cluster node into rolling log files, the
searcher the ``/metric`` command reads, the pluggable extension SPI on the
statistic write path, the Prometheus scrape exporter, and the server's host
metric planes (latency histograms, the HA counters, the per-second
timeline, the server metrics registry, the profiler hook, the stat
logger).

Re-exports are LAZY (PEP 562), as in ``cluster``: the exporter and the
metric log read the local engine's nodes, whose modules import this
package's submodules, so an eager re-export would import them in a cycle.
"""

_EXPORTS = {
    "MetricNode": "sentinel_tpu_torch.metrics.log",
    "MetricWriter": "sentinel_tpu_torch.metrics.log",
    "MetricSearcher": "sentinel_tpu_torch.metrics.log",
    "MetricTimer": "sentinel_tpu_torch.metrics.log",
    "MetricExtension": "sentinel_tpu_torch.metrics.extension",
    "register_extension": "sentinel_tpu_torch.metrics.extension",
    "clear_extensions_for_tests": "sentinel_tpu_torch.metrics.extension",
    "LatencyHistogram": "sentinel_tpu_torch.metrics.histogram",
    "log_buckets": "sentinel_tpu_torch.metrics.histogram",
    "ProfilerHook": "sentinel_tpu_torch.metrics.profiler",
    "ServerMetrics": "sentinel_tpu_torch.metrics.server",
    "server_metrics": "sentinel_tpu_torch.metrics.server",
    "reset_server_metrics_for_tests": "sentinel_tpu_torch.metrics.server",
    "PrometheusExporter": "sentinel_tpu_torch.metrics.exporter",
    "render": "sentinel_tpu_torch.metrics.exporter",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'sentinel_tpu_torch.metrics' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
