"""Push-style datasource base: a background watcher thread that blocks on the
backend's change-notification primitive (long-poll, subscription) and
refreshes the property when the source changes.

This is the structural analog of the reference's listener-based backends
(e.g. Nacos ``configService.addListener``, ZooKeeper ``NodeCacheListener``,
Redis pub/sub — one submodule each under ``sentinel-extension/
sentinel-datasource-*``): the vendor client's callback thread becomes an
explicit watch loop here.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.datasource.base import Converter, ReadableDataSource

# After a watch error, back off instead of hot-looping against a dead server.
WATCH_RETRY_DELAY_S = 1.0


class WatchingDataSource(ReadableDataSource):
    """Subclasses implement ``watch_once`` — block until a change is likely
    (or a timeout elapses) and return True to trigger a refresh."""

    def __init__(self, converter: Converter):
        super().__init__(converter)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WatchingDataSource":
        self.refresh()  # initial load, like every reference datasource ctor
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"sentinel-datasource-{type(self).__name__}",
        )
        self._thread.start()
        return self

    def watch_once(self) -> bool:
        raise NotImplementedError

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.watch_once() and not self._stop.is_set():
                    self.refresh()
            except Exception as e:
                record_log.warning(
                    "%s watch failed: %s", type(self).__name__, e
                )
                self._stop.wait(WATCH_RETRY_DELAY_S)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
