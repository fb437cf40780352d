"""Cluster flow control of the port (the port's copy of
``sentinel_tpu/cluster/__init__.py``).

- ``protocol``: binary wire codec (5 request types, length-prefixed frames —
  the shape of ``sentinel-cluster-common-default``'s netty codec).
- ``token_service``: the ``TokenService`` SPI and its engine-backed default
  (``DefaultTokenService.java:36`` analog whose decision path is the decide
  kernel on the card).
- ``server`` / ``server_native``: the asyncio and the native front doors.
- ``client``: sync token client with xid-correlated responses, timeout and
  reconnect (``DefaultClusterTokenClient``/``NettyTransportClient`` analog).
- ``api``: process-global cluster state (CLIENT/SERVER/OFF) consumed by the
  local flow checker's cluster branch (``ClusterStateManager`` analog).
- ``namespaces`` / ``routing`` / ``rebalance``: namespace ownership across
  pods, the namespace-routing client and live moves.

Re-exports are LAZY (PEP 562): importing a torch-free submodule
(``protocol``, ``connection``) must not pull the torch-backed service
stack — socket-only processes (load clients, sidecars that only speak the
wire format) depend on that boundary.
"""

_EXPORTS = {
    "TokenResult": "sentinel_tpu_torch.cluster.token_service",
    "TokenService": "sentinel_tpu_torch.cluster.token_service",
    "DefaultTokenService": "sentinel_tpu_torch.cluster.token_service",
    "ConcurrencyManager": "sentinel_tpu_torch.cluster.concurrent",
    "ConcurrentFlowRule": "sentinel_tpu_torch.cluster.concurrent",
    "ExpiryTask": "sentinel_tpu_torch.cluster.concurrent",
    "ClusterMode": "sentinel_tpu_torch.cluster.api",
    "get_mode": "sentinel_tpu_torch.cluster.api",
    "set_client": "sentinel_tpu_torch.cluster.api",
    "set_embedded_server": "sentinel_tpu_torch.cluster.api",
    "set_mode": "sentinel_tpu_torch.cluster.api",
    "ConnectionManager": "sentinel_tpu_torch.cluster.connection",
    "NamespaceAssignment": "sentinel_tpu_torch.cluster.namespaces",
    "aggregate_snapshots": "sentinel_tpu_torch.cluster.namespaces",
    "flow_namespaces": "sentinel_tpu_torch.cluster.namespaces",
    "partition_rules": "sentinel_tpu_torch.cluster.namespaces",
    "RoutingTokenClient": "sentinel_tpu_torch.cluster.routing",
    "MoveCoordinator": "sentinel_tpu_torch.cluster.rebalance",
    "MoveTarget": "sentinel_tpu_torch.cluster.rebalance",
    "ShardMap": "sentinel_tpu_torch.cluster.rebalance",
    "ShardMapPublisher": "sentinel_tpu_torch.cluster.rebalance",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'sentinel_tpu_torch.cluster' has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
