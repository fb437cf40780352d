"""ZooKeeper datasource (analog of ``sentinel-datasource-zookeeper``).

The reference watches a znode with Curator's ``NodeCache``. ZooKeeper speaks
a binary protocol with session heartbeats — not something to hand-roll —
so this backend drives an injectable client object with the tiny surface it
needs (``get(path) -> (bytes, stat)`` and ``DataWatch``-style callbacks).
``kazoo.client.KazooClient`` satisfies it directly when kazoo is installed;
environments without kazoo can inject any conforming client (tests use a
fake), and constructing without either raises with guidance instead of
failing at import time.
"""

from __future__ import annotations

from typing import Optional

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.datasource.base import Converter, ReadableDataSource


class ZookeeperDataSource(ReadableDataSource):
    def __init__(
        self,
        converter: Converter,
        server_addr: str = "127.0.0.1:2181",
        path: str = "/sentinel/rules",
        client=None,
    ):
        super().__init__(converter)
        self.path = path
        self._owns_client = client is None
        if client is None:
            try:
                from kazoo.client import KazooClient  # type: ignore
            except ImportError as e:  # pragma: no cover - env-dependent
                raise ImportError(
                    "ZookeeperDataSource needs the 'kazoo' package (not "
                    "bundled in this image) or an injected client exposing "
                    "get(path) and DataWatch(path, func)"
                ) from e
            client = KazooClient(hosts=server_addr)
        self.client = client

    def start(self) -> "ZookeeperDataSource":
        if self._owns_client:
            self.client.start()
        # ensure_path keeps first-boot ordering race-free: watch an existing
        # (possibly empty) node rather than racing its creation
        ensure = getattr(self.client, "ensure_path", None)
        if ensure is not None:
            ensure(self.path)

        def _on_change(data, stat, *_):
            if data is None:
                return
            try:
                self.property.update_value(self.converter(data.decode()))
            except Exception as e:
                record_log.warning("zookeeper rule payload rejected: %s", e)

        # kazoo's DataWatch fires immediately with the current value, which
        # doubles as the initial load
        self.client.DataWatch(self.path, _on_change)
        return self

    def read_source(self) -> str:
        data, _stat = self.client.get(self.path)
        return (data or b"").decode()

    def close(self) -> None:
        if self._owns_client:
            try:
                self.client.stop()
            except Exception:
                pass
