"""Spring Cloud Config datasource (analog of
``sentinel-datasource-spring-cloud-config``).

Reads one property out of a config-server environment:
``GET {uri}/{application}/{profile}[/{label}]`` → property sources searched
front-to-back (highest precedence first, config-server order) for
``rule_key``. The reference refreshes on Spring's ``RefreshEvent``; without
a Spring bus this polls, which is what the config-server's own clients do
absent a bus too.
"""

from __future__ import annotations

from typing import Optional

from sentinel_tpu_torch.datasource.base import AutoRefreshDataSource, Converter
from sentinel_tpu_torch.datasource.http_util import request


class SpringCloudConfigDataSource(AutoRefreshDataSource):
    def __init__(
        self,
        converter: Converter,
        uri: str = "http://127.0.0.1:8888",
        application: str = "sentinel",
        profile: str = "default",
        label: Optional[str] = None,
        rule_key: str = "sentinel.rules",
        refresh_interval_s: float = 3.0,
    ):
        self.uri = uri.rstrip("/")
        self.application = application
        self.profile = profile
        self.label = label
        self.rule_key = rule_key
        super().__init__(converter, refresh_interval_s)

    def read_source(self) -> str:
        path = f"{self.uri}/{self.application}/{self.profile}"
        if self.label:
            path += f"/{self.label}"
        resp = request(path, timeout_s=5.0)
        if resp.status != 200:
            raise RuntimeError(f"config server status {resp.status}")
        for source in resp.json().get("propertySources") or []:
            value = (source.get("source") or {}).get(self.rule_key)
            if value is not None:
                return str(value)
        return ""
