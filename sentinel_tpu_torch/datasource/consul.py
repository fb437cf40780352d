"""Consul KV datasource (analog of ``sentinel-datasource-consul``).

The reference module long-polls the KV endpoint with Consul *blocking
queries* (wait + last index); same here, directly over the HTTP API:
``GET /v1/kv/<key>?index=<last>&wait=<s>s`` blocks until the key changes or
the wait elapses. The value arrives base64-encoded in the JSON body and the
``X-Consul-Index`` header carries the next cursor.
"""

from __future__ import annotations

import base64
from typing import Optional

from sentinel_tpu_torch.datasource.base import Converter
from sentinel_tpu_torch.datasource.http_util import request
from sentinel_tpu_torch.datasource.push_base import WatchingDataSource


class ConsulDataSource(WatchingDataSource):
    def __init__(
        self,
        converter: Converter,
        host: str = "127.0.0.1",
        port: int = 8500,
        rule_key: str = "sentinel/rules",
        token: Optional[str] = None,
        wait_s: int = 60,
    ):
        self.base_url = f"http://{host}:{port}/v1/kv/{rule_key}"
        self.token = token
        self.wait_s = wait_s
        self._index = 0
        super().__init__(converter)

    def _headers(self):
        return {"X-Consul-Token": self.token} if self.token else {}

    def read_source(self) -> str:
        resp = request(self.base_url, headers=self._headers(), timeout_s=5.0)
        if resp.status == 404:
            return ""
        self._index = int(resp.headers.get("X-Consul-Index", self._index) or 0)
        entries = resp.json()
        if not entries:
            return ""
        raw = entries[0].get("Value")
        return base64.b64decode(raw).decode("utf-8") if raw else ""

    def watch_once(self) -> bool:
        resp = request(
            self.base_url,
            params={"index": str(self._index), "wait": f"{self.wait_s}s"},
            headers=self._headers(),
            # the blocking query may legitimately hold the connection the
            # whole wait window plus consul's jitter
            timeout_s=self.wait_s + 10.0,
        )
        # 404 is a valid blocking-query answer (key absent yet — the index
        # still advances when it is created); anything else non-200 must
        # raise so the watch loop backs off instead of hot-looping (e.g. an
        # instant 403 on an expired ACL token carries no index and would
        # otherwise spin at network speed)
        if resp.status not in (200, 404):
            raise RuntimeError(f"consul blocking query failed: {resp.status}")
        new_index = int(resp.headers.get("X-Consul-Index", 0) or 0)
        changed = new_index != self._index
        self._index = new_index
        return changed
