"""Metric extension SPI — user-pluggable sinks on the statistic write path
(the port's copy of ``sentinel_tpu/metrics/extension.py``).

Analog of ``metric/extension/MetricExtension.java`` +
``MetricExtensionProvider`` and the ``MetricEntryCallback``/
``MetricExitCallback`` pair hooked into ``StatisticSlot`` via
``StatisticSlotCallbackRegistry``: every pass/block/success/exception/rt
event is fanned out to registered extensions (Prometheus, StatsD, custom
counters) in addition to the built-in window counters.

Extensions must be cheap and non-blocking — they run inline on the entry
hot path, exactly like the reference's callbacks.
"""

from __future__ import annotations

import threading
from typing import Tuple

_lock = threading.Lock()
_extensions: Tuple["MetricExtension", ...] = ()


class MetricExtension:
    """Override any subset; default is no-op (``MetricExtension.java``)."""

    def add_pass(self, resource: str, n: int, args) -> None:
        pass

    def add_block(self, resource: str, n: int, origin: str, error, args) -> None:
        pass

    def add_success(self, resource: str, n: int, args) -> None:
        pass

    def add_exception(self, resource: str, n: int, error) -> None:
        pass

    def add_rt(self, resource: str, rt_ms: float, args) -> None:
        pass

    def increase_thread_num(self, resource: str, args) -> None:
        pass

    def decrease_thread_num(self, resource: str, args) -> None:
        pass


def register_extension(ext: MetricExtension) -> None:
    global _extensions
    with _lock:
        _extensions = _extensions + (ext,)


def get_extensions() -> Tuple[MetricExtension, ...]:
    return _extensions


def clear_extensions_for_tests() -> None:
    global _extensions
    with _lock:
        _extensions = ()


# Hot-path dispatch helpers: a single tuple read when nothing is registered.
# Each callback is isolated — a faulty extension must not corrupt the
# statistic slot's counting (an escaped error here would leak thread counts
# or mask a BlockException mid-flight; the reference catches Throwable
# around its callbacks for the same reason).

def _safe(fn, *args) -> None:
    try:
        fn(*args)
    except Exception:
        from sentinel_tpu_torch.core.log import record_log

        record_log.exception("metric extension %r failed", fn)


def on_pass(resource: str, n: int, args) -> None:
    for ext in _extensions:
        _safe(ext.add_pass, resource, n, args)


def on_block(resource: str, n: int, origin: str, error, args) -> None:
    for ext in _extensions:
        _safe(ext.add_block, resource, n, origin, error, args)


def on_complete(resource: str, n: int, rt_ms: float, args) -> None:
    for ext in _extensions:
        _safe(ext.add_success, resource, n, args)
        _safe(ext.add_rt, resource, rt_ms, args)


def on_exception(resource: str, n: int, error) -> None:
    for ext in _extensions:
        _safe(ext.add_exception, resource, n, error)


def on_thread_inc(resource: str, args) -> None:
    for ext in _extensions:
        _safe(ext.increase_thread_num, resource, args)


def on_thread_dec(resource: str, args) -> None:
    for ext in _extensions:
        _safe(ext.decrease_thread_num, resource, args)
