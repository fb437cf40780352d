"""Runtime cluster-mode transitions (``ClusterStateManager.java`` analog;
the port's copy of ``sentinel_tpu/ha/manager.py``).

The reference flips a node between CLIENT and SERVER at runtime
(``ClusterStateManager.applyState``) and the slot chain picks the new
service on the very next request because ``FlowRuleChecker`` consults the
global state per call. This build works the same way — ``cluster.api``'s
``_pick_service()`` reads module globals on every cluster check — so a
transition here rewires the slot chain live, with no restart and no
re-registration of rules on the local side.

What this class adds over raw ``transport.handlers.apply_cluster_mode``:

- **to_client** installs a :class:`~sentinel_tpu_torch.ha.failover.FailoverTokenClient`
  (ordered endpoint list + local fallback) instead of a single-host client;
- **to_server** optionally restores the newest state snapshot into the
  embedded service before it takes traffic — the warm-standby promotion
  path (a demoted primary's artifact, or one fetched over the
  ``cluster/server/snapshot`` transport command);
- every transition closes what the previous mode held (client socket,
  server port) instead of leaking it.

``ClusterStateManager(server_factory=...)`` passes ``apply_cluster_mode``'s
``server_factory`` down (None: the reference's ``DefaultTokenService()``,
on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.ha.failover import FailoverTokenClient
from sentinel_tpu_torch.ha.fallback import LocalFallbackPolicy
from sentinel_tpu_torch.transport.command import ServerFactory


class ClusterStateManager:
    """Client/server/off transitions for this node."""

    def __init__(self, server_factory: Optional[ServerFactory] = None):
        self.server_factory = server_factory

    def to_client(
        self,
        endpoints: Sequence,
        timeout_ms: int = 20,
        namespace: str = "default",
        fallback: Optional[LocalFallbackPolicy] = None,
        **failover_kwargs,
    ) -> FailoverTokenClient:
        """Run as a cluster client against the ordered endpoint list.

        A running embedded server is stopped first (its port frees for
        whoever is promoted in our place). Returns the installed client."""
        from sentinel_tpu_torch.cluster import api as cluster_api
        from sentinel_tpu_torch.transport.handlers import apply_cluster_mode

        if cluster_api.get_mode() == cluster_api.ClusterMode.SERVER:
            apply_cluster_mode(int(cluster_api.ClusterMode.NOT_STARTED))
        client = FailoverTokenClient(
            endpoints,
            timeout_ms=timeout_ms,
            namespace=namespace,
            fallback=fallback,
            **failover_kwargs,
        )
        cluster_api.set_client(client)  # sets CLIENT mode, closes the old one
        record_log.info(
            "cluster mode → CLIENT (%d endpoint(s), namespace=%s)",
            len(client.health_snapshot()), namespace,
        )
        return client

    def to_server(
        self,
        token_port: int = 18730,
        snapshot_dir: Optional[str] = None,
        restore: bool = True,
    ):
        """Promote this node to an embedded token server. With
        ``snapshot_dir`` and ``restore``, a cold service (no rules loaded
        yet) restores the newest snapshot artifact before taking traffic —
        the warm-standby path. Returns the embedded service."""
        from sentinel_tpu_torch.cluster import api as cluster_api
        from sentinel_tpu_torch.transport.handlers import apply_cluster_mode

        cluster_api.clear_client()
        apply_cluster_mode(
            int(cluster_api.ClusterMode.SERVER), token_port,
            self.server_factory,
        )
        service = cluster_api.get_embedded_server()
        if restore and snapshot_dir and not service.current_rules():
            from sentinel_tpu_torch.ha.snapshot import restore_latest

            if restore_latest(service, snapshot_dir):
                record_log.info(
                    "cluster mode → SERVER (port %d, state restored from %s)",
                    token_port, snapshot_dir,
                )
                return service
        record_log.info("cluster mode → SERVER (port %d)", token_port)
        return service

    def to_off(self) -> None:
        """Back to NOT_STARTED: stop the embedded server if running, drop
        the client if installed. Local (non-cluster) rules keep working."""
        from sentinel_tpu_torch.cluster import api as cluster_api
        from sentinel_tpu_torch.transport.handlers import apply_cluster_mode

        apply_cluster_mode(int(cluster_api.ClusterMode.NOT_STARTED))
        cluster_api.clear_client()
        record_log.info("cluster mode → off")

    # -- introspection -------------------------------------------------------
    def current_mode(self):
        from sentinel_tpu_torch.cluster import api as cluster_api

        return cluster_api.get_mode()

    def status(self) -> dict:
        from sentinel_tpu_torch.cluster import api as cluster_api
        from sentinel_tpu_torch.transport.handlers import (
            _EMBEDDED_LOCK,
            _EMBEDDED_SERVER,
        )

        out = {"mode": self.current_mode().name}
        with _EMBEDDED_LOCK:
            server = _EMBEDDED_SERVER["server"]
        if server is not None:
            out["serverPort"] = server.port
        client = cluster_api._client
        if isinstance(client, FailoverTokenClient):
            out["endpoints"] = client.health_snapshot()
        return out
