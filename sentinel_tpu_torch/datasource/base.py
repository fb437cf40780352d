"""Datasource abstractions.

Analogs: ``ReadableDataSource<S,T>`` / ``WritableDataSource<T>`` /
``Converter<S,T>`` and ``AbstractDataSource`` / ``AutoRefreshDataSource``
(``sentinel-datasource-extension/.../datasource/AbstractDataSource.java:29``,
``AutoRefreshDataSource.java:32``), plus ``WritableDataSourceRegistry``
(write-back target of the ``setRules`` command,
``ModifyRulesCommandHandler.java:46``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, Optional, TypeVar

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.core.property import DynamicProperty

S = TypeVar("S")
T = TypeVar("T")

Converter = Callable[[S], T]

# failed refreshes by datasource class, fed to the Prometheus surface as
# ``sentinel_datasource_refresh_failures_total`` (metrics.exporter)
_FAILURES_LOCK = threading.Lock()
_REFRESH_FAILURES: Dict[str, int] = {}


def _count_refresh_failure(source: "ReadableDataSource") -> None:
    name = type(source).__name__
    with _FAILURES_LOCK:
        _REFRESH_FAILURES[name] = _REFRESH_FAILURES.get(name, 0) + 1


def refresh_failure_totals() -> Dict[str, int]:
    """Cumulative failed refreshes per datasource class."""
    with _FAILURES_LOCK:
        return dict(_REFRESH_FAILURES)


def reset_refresh_failures_for_tests() -> None:
    with _FAILURES_LOCK:
        _REFRESH_FAILURES.clear()


class ReadableDataSource(Generic[S, T]):
    """Parses a source value into rules and publishes into ``property``."""

    def __init__(self, converter: Converter):
        self.converter = converter
        self.property: DynamicProperty = DynamicProperty()

    def read_source(self) -> S:
        raise NotImplementedError

    def load_config(self) -> Optional[T]:
        return self.converter(self.read_source())

    def refresh(self) -> bool:
        """One read→parse→publish cycle. Returns True on success. A failed
        read or parse keeps the last-known-good config published (a broken
        source must degrade to stale rules, never to NO rules) and counts
        toward ``sentinel_datasource_refresh_failures_total``."""
        try:
            config = self.load_config()
        except Exception as e:
            _count_refresh_failure(self)
            record_log.warning("datasource refresh failed: %s", e)
            return False
        if config is None and self.property.value is not None:
            # a parse that yields nothing while good config is live is a
            # failure (truncated file mid-write, empty GET on a flaky
            # backend) — publishing None would wipe the rules
            _count_refresh_failure(self)
            record_log.warning(
                "datasource refresh parsed no config; keeping last-known-good"
            )
            return False
        self.property.update_value(config)
        return True

    def close(self) -> None:
        pass


class AutoRefreshDataSource(ReadableDataSource[S, T]):
    """Polls ``read_source`` on a background thread
    (``AutoRefreshDataSource.java:32``). Subclasses may override
    ``is_modified`` to skip unchanged sources.

    Consecutive failures back the poll off exponentially (doubling per
    failure, capped at ``backoff_cap_x`` times the configured interval) so a
    dead backend is probed, not hammered; one success snaps the cadence
    back."""

    def __init__(self, converter: Converter, refresh_interval_s: float = 3.0,
                 backoff_cap_x: float = 10.0):
        super().__init__(converter)
        self.refresh_interval_s = refresh_interval_s
        self.backoff_cap_x = float(backoff_cap_x)
        self._consecutive_failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AutoRefreshDataSource":
        self.refresh()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sentinel-datasource-refresh"
        )
        self._thread.start()
        return self

    def _poll_interval_s(self) -> float:
        cap = self.refresh_interval_s * self.backoff_cap_x
        return min(
            self.refresh_interval_s * (2.0 ** self._consecutive_failures), cap
        )

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_interval_s()):
            try:
                if not self.is_modified():
                    continue
                ok = self.refresh()
            except Exception as e:
                ok = False
                _count_refresh_failure(self)
                record_log.warning("datasource poll failed: %s", e)
            if ok:
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1

    def is_modified(self) -> bool:
        return True

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class WritableDataSource(Generic[T]):
    def write(self, value: T) -> None:
        raise NotImplementedError


class WritableDataSourceRegistry:
    """Per-rule-type write-back targets (``WritableDataSourceRegistry.java``)."""

    _lock = threading.RLock()
    _sources: Dict[str, WritableDataSource] = {}

    @classmethod
    def register(cls, rule_type: str, source: WritableDataSource) -> None:
        with cls._lock:
            cls._sources[rule_type] = source

    @classmethod
    def get(cls, rule_type: str) -> Optional[WritableDataSource]:
        return cls._sources.get(rule_type)

    @classmethod
    def write_if_registered(cls, rule_type: str, value) -> bool:
        src = cls.get(rule_type)
        if src is None:
            return False
        src.write(value)
        return True

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._sources.clear()
