"""Apollo config datasource (analog of ``sentinel-datasource-apollo``).

The reference reads one property (``ruleKey``) of an Apollo namespace via
the Apollo OpenAPI client. Here the open HTTP API is used directly:

- read:  ``GET /configs/{appId}/{cluster}/{namespace}`` →
  ``{"releaseKey": ..., "configurations": {ruleKey: rulesJson}}``
- watch: ``GET /notifications/v2?appId&cluster&notifications=[...]`` —
  Apollo's long-poll; HTTP 200 means a listed namespace changed
  (304 = timeout, nothing changed).
"""

from __future__ import annotations

import json

from sentinel_tpu_torch.datasource.base import Converter
from sentinel_tpu_torch.datasource.http_util import request
from sentinel_tpu_torch.datasource.push_base import WatchingDataSource


class ApolloDataSource(WatchingDataSource):
    def __init__(
        self,
        converter: Converter,
        server_url: str = "http://127.0.0.1:8080",
        app_id: str = "sentinel",
        cluster: str = "default",
        namespace: str = "application",
        rule_key: str = "sentinel.rules",
        default_value: str = "",
        long_poll_timeout_s: float = 60.0,
    ):
        self.server_url = server_url.rstrip("/")
        self.app_id = app_id
        self.cluster = cluster
        self.namespace = namespace
        self.rule_key = rule_key
        self.default_value = default_value
        self.long_poll_timeout_s = long_poll_timeout_s
        self._notification_id = -1
        super().__init__(converter)

    def read_source(self) -> str:
        resp = request(
            f"{self.server_url}/configs/{self.app_id}/{self.cluster}/"
            f"{self.namespace}",
            timeout_s=5.0,
        )
        if resp.status != 200:
            return self.default_value
        configs = resp.json().get("configurations") or {}
        return configs.get(self.rule_key, self.default_value)

    def watch_once(self) -> bool:
        notifications = json.dumps(
            [{"namespaceName": self.namespace,
              "notificationId": self._notification_id}]
        )
        resp = request(
            f"{self.server_url}/notifications/v2",
            params={
                "appId": self.app_id,
                "cluster": self.cluster,
                "notifications": notifications,
            },
            timeout_s=self.long_poll_timeout_s + 10.0,
        )
        if resp.status == 304:
            return False  # long-poll timeout, nothing changed
        if resp.status != 200:
            raise RuntimeError(f"apollo notifications failed: {resp.status}")
        for note in resp.json() or []:
            if note.get("namespaceName") == self.namespace:
                self._notification_id = note.get(
                    "notificationId", self._notification_id
                )
        return True
