"""HTTP client to app command centers (``client/SentinelApiClient.java:93``).

Fetches metric log lines and rules from, and pushes rules to, a machine's
command center (the embedded HTTP server every guarded app runs).

Port note: a promotion the machine answered with an error (its token
service or door failed to build or start: a command center answers such a
failure with status 500 and the error) raises :class:`CommandFailed` from
:meth:`ApiClient.set_cluster_mode`, so the dashboard's answer carries it.
An unreachable machine still reads as ``False``, as in the reference.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.dashboard.discovery import MachineInfo
from sentinel_tpu_torch.metrics.log import MetricNode


# Budget for promoting an agent to token server: the handler builds the
# token service and its door before acking (on a cold card the first build
# of the kernels and of the native library takes tens of seconds). The
# handler is idempotent, so even a timeout here reconciles on retry.
PROMOTE_TIMEOUT_S = 120.0


class CommandFailed(Exception):
    """A machine's command center answered a command with an error status
    (the command ran and failed there), as opposed to being unreachable."""


class ApiClient:
    def __init__(self, timeout_s: float = 3.0,
                 promote_timeout_s: float = PROMOTE_TIMEOUT_S):
        self.timeout_s = timeout_s
        self.promote_timeout_s = promote_timeout_s

    def _get(self, machine: MachineInfo, command: str, params: dict,
             timeout_s: Optional[float] = None,
             raise_answered: bool = False) -> Optional[str]:
        query = urllib.parse.urlencode({k: v for k, v in params.items() if v is not None})
        url = f"http://{machine.ip}:{machine.port}/{command}?{query}"
        try:
            with urllib.request.urlopen(
                url, timeout=timeout_s or self.timeout_s
            ) as rsp:
                return rsp.read().decode()
        except urllib.error.HTTPError as e:
            if raise_answered:
                detail = e.read().decode(errors="replace")
                raise CommandFailed(
                    f"{command} on {machine.key} answered {e.code}: {detail}"
                ) from e
            record_log.warning("command %s on %s failed: %s", command, machine.key, e)
            return None
        except Exception as e:
            record_log.warning("command %s on %s failed: %s", command, machine.key, e)
            return None

    def _post(self, machine: MachineInfo, command: str, params: dict,
              body: str) -> Optional[str]:
        query = urllib.parse.urlencode(params)
        url = f"http://{machine.ip}:{machine.port}/{command}?{query}"
        try:
            req = urllib.request.Request(
                url, data=body.encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as rsp:
                return rsp.read().decode()
        except Exception as e:
            record_log.warning("command %s on %s failed: %s", command, machine.key, e)
            return None

    # -- metrics (MetricFetcher's transport) --------------------------------
    def fetch_metrics(
        self, machine: MachineInfo, start_ms: int, end_ms: int
    ) -> Optional[List[MetricNode]]:
        """Metric lines for the window, or ``None`` on transport failure —
        the fetcher must not advance a machine's window past data it never
        received."""
        text = self._get(
            machine, "metric", {"startTime": start_ms, "endTime": end_ms}
        )
        if text is None:
            return None
        if not text:
            return []
        nodes = []
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                nodes.append(MetricNode.from_line(line))
            except (ValueError, IndexError):
                continue
        return nodes

    # -- rules (SentinelApiClient.fetchRules / setRulesAsync) ---------------
    def fetch_json(self, machine: MachineInfo, command: str,
                   params: Optional[dict] = None):
        """GET a command and parse its JSON body; None on transport/parse
        failure. The cluster monitor screens ride this for
        ``cluster/server/info``, ``cluster/server/metrics`` and
        ``cluster/client/fetchConfig`` (the dashboard-side counterpart of
        ``ClusterConfigService``'s state fetches)."""
        text = self._get(machine, command, params or {})
        if text is None:
            return None
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            record_log.warning(
                "bad %s payload from %s", command, machine.key
            )
            return None

    def fetch_rules(self, machine: MachineInfo, rule_type: str) -> Optional[list]:
        return self.fetch_json(machine, "getRules", {"type": rule_type})

    def get_cluster_mode(self, machine: MachineInfo) -> Optional[int]:
        raw = self._get(machine, "getClusterMode", {})
        if raw is None:
            return None
        try:
            return int(json.loads(raw).get("mode", -1))
        except (ValueError, AttributeError):
            return None

    def set_cluster_mode(
        self, machine: MachineInfo, mode: int, token_port: Optional[int] = None
    ) -> bool:
        """True once the machine switched; False when it could not be
        reached. Raises :class:`CommandFailed` when it answered that the
        switch failed."""
        params = {"mode": str(mode)}
        if token_port is not None:
            params["tokenPort"] = str(token_port)
        timeout_s = (
            max(self.timeout_s, self.promote_timeout_s) if mode == 1 else None
        )
        return self._get(
            machine, "setClusterMode", params, timeout_s=timeout_s,
            raise_answered=True,
        ) is not None

    def push_cluster_client_config(
        self, machine: MachineInfo, server_host: str, server_port: int
    ) -> bool:
        body = json.dumps(
            {"serverHost": server_host, "serverPort": server_port}
        )
        return self._post(machine, "cluster/client/modifyConfig", {}, body) is not None

    def push_api_definitions(self, machine: MachineInfo, body: str) -> bool:
        """Replace a machine's gateway custom-API groups (raw JSON array)."""
        rsp = self._post(machine, "gateway/updateApiDefinitions", {}, body)
        return rsp is not None and "success" in rsp

    def push_rules(self, machine: MachineInfo, rule_type: str, rules: list) -> bool:
        rsp = self._post(
            machine, "setRules", {"type": rule_type}, json.dumps(rules)
        )
        return rsp is not None and "success" in rsp
