"""Eureka metadata datasource (analog of ``sentinel-datasource-eureka``).

The reference reads rule JSON out of a Eureka *instance's metadata map*
(``metadata.<ruleKey>``), polling the registry. Same model here over the
open REST API: ``GET /eureka/apps/{appId}`` (JSON accept), take the first
UP instance's ``metadata[rule_key]``. Multiple registry URLs are tried in
order — the reference's fallback-server behavior.
"""

from __future__ import annotations

from typing import List, Sequence

from sentinel_tpu_torch.datasource.base import AutoRefreshDataSource, Converter
from sentinel_tpu_torch.datasource.http_util import request


class EurekaDataSource(AutoRefreshDataSource):
    def __init__(
        self,
        converter: Converter,
        app_id: str,
        instance_id: str,
        service_urls: Sequence[str] = ("http://127.0.0.1:8761/eureka",),
        rule_key: str = "sentinel.rules",
        refresh_interval_s: float = 3.0,
    ):
        self.app_id = app_id
        self.instance_id = instance_id
        self.service_urls: List[str] = [u.rstrip("/") for u in service_urls]
        self.rule_key = rule_key
        super().__init__(converter, refresh_interval_s)

    def read_source(self) -> str:
        last_err: Exception = RuntimeError("no eureka service urls")
        for base in self.service_urls:
            try:
                resp = request(
                    f"{base}/apps/{self.app_id}",
                    headers={"Accept": "application/json"},
                    timeout_s=5.0,
                )
                if resp.status != 200:
                    raise RuntimeError(f"eureka status {resp.status}")
                instances = (resp.json().get("application") or {}).get(
                    "instance"
                ) or []
                if isinstance(instances, dict):
                    # Eureka's XStream JSON renders a single-instance app as
                    # an object, not a one-element list
                    instances = [instances]
                for inst in instances:
                    if inst.get("instanceId") != self.instance_id:
                        continue
                    return (inst.get("metadata") or {}).get(self.rule_key, "")
                return ""  # instance not registered (yet) → no rules
            except Exception as e:  # try the next registry replica
                last_err = e
        raise last_err
