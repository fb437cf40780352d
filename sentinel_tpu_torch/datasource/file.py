"""File-backed datasources (``FileRefreshableDataSource.java:39`` /
``FileWritableDataSource``)."""

from __future__ import annotations

import os
from typing import Optional

from sentinel_tpu_torch.datasource.base import (
    AutoRefreshDataSource,
    Converter,
    WritableDataSource,
)


class FileRefreshableDataSource(AutoRefreshDataSource[str, object]):
    """Re-reads a file when its mtime/size changes."""

    def __init__(self, path: str, converter: Converter,
                 refresh_interval_s: float = 3.0, encoding: str = "utf-8"):
        self.path = path
        self.encoding = encoding
        self._last_sig: Optional[tuple] = None
        super().__init__(converter, refresh_interval_s)

    def read_source(self) -> str:
        with open(self.path, "r", encoding=self.encoding) as f:
            return f.read()

    def is_modified(self) -> bool:
        try:
            st = os.stat(self.path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            return False
        if sig != self._last_sig:
            self._last_sig = sig
            return True
        return False

    def refresh(self) -> bool:
        try:
            st = os.stat(self.path)
            self._last_sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            pass
        return super().refresh()


class FileWritableDataSource(WritableDataSource):
    def __init__(self, path: str, serializer, encoding: str = "utf-8"):
        self.path = path
        self.serializer = serializer
        self.encoding = encoding

    def write(self, value) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding=self.encoding) as f:
            f.write(self.serializer(value))
        os.replace(tmp, self.path)
