"""Nacos config datasource (analog of ``sentinel-datasource-nacos``).

The reference wires the Nacos Java client's ``addListener``; the client
implements that with the open long-poll protocol spoken here directly:

- read:  ``GET /nacos/v1/cs/configs?dataId&group[&tenant]``
- watch: ``POST /nacos/v1/cs/configs/listener`` with
  ``Listening-Configs = dataId^2group^2md5[^2tenant]^1`` and a
  ``Long-Pulling-Timeout`` header; the server parks the request until the
  config's md5 diverges (response non-empty → changed).

(^1/^2 are the protocol's 0x01/0x02 field separators.)
"""

from __future__ import annotations

import hashlib
import urllib.parse
from typing import Optional

from sentinel_tpu_torch.datasource.base import Converter
from sentinel_tpu_torch.datasource.http_util import request
from sentinel_tpu_torch.datasource.push_base import WatchingDataSource

_SEP_FIELD = "\x02"
_SEP_LINE = "\x01"


class NacosDataSource(WatchingDataSource):
    def __init__(
        self,
        converter: Converter,
        server_addr: str = "127.0.0.1:8848",
        data_id: str = "sentinel-rules",
        group: str = "DEFAULT_GROUP",
        namespace: Optional[str] = None,
        long_poll_timeout_ms: int = 30_000,
        context_path: str = "/nacos",
    ):
        self.base = f"http://{server_addr}{context_path}/v1/cs"
        self.data_id = data_id
        self.group = group
        self.namespace = namespace
        self.long_poll_timeout_ms = long_poll_timeout_ms
        self._md5 = ""
        super().__init__(converter)

    def read_source(self) -> str:
        params = {"dataId": self.data_id, "group": self.group}
        if self.namespace:
            params["tenant"] = self.namespace
        resp = request(f"{self.base}/configs", params=params, timeout_s=5.0)
        if resp.status == 404:
            self._md5 = ""
            return ""
        if resp.status != 200:
            raise RuntimeError(f"nacos get failed: {resp.status}")
        self._md5 = hashlib.md5(resp.body).hexdigest()
        return resp.text

    def watch_once(self) -> bool:
        fields = [self.data_id, self.group, self._md5]
        if self.namespace:
            fields.append(self.namespace)
        listening = _SEP_FIELD.join(fields) + _SEP_LINE
        resp = request(
            f"{self.base}/configs/listener",
            method="POST",
            data=urllib.parse.urlencode(
                {"Listening-Configs": listening}
            ).encode(),
            headers={
                "Long-Pulling-Timeout": str(self.long_poll_timeout_ms),
                "Content-Type": "application/x-www-form-urlencoded",
            },
            timeout_s=self.long_poll_timeout_ms / 1000.0 + 10.0,
        )
        if resp.status != 200:
            raise RuntimeError(f"nacos listener failed: {resp.status}")
        return bool(resp.text.strip())  # non-empty body names changed configs
