"""Datasource-driven cluster assignment (the port's copy of
``sentinel_tpu/cluster/assign.py``).

The reference's cluster client/server configuration is property-driven:
``ClusterClientConfigManager`` registers ``SentinelProperty`` instances for
the client assignment and config (``sentinel-cluster-client-default/.../
config/ClusterClientConfigManager.java``), and ``ClusterStateManager``
applies mode switches from properties too — the HTTP commands are just one
writer of those properties. Round 2 only had the command path; this module
adds the property path with the SAME payloads the commands accept, so a
fleet re-points itself from any datasource (file, nacos, etcd, …) without a
dashboard in the loop.

Usage::

    ds = FileRefreshableDataSource(path, converter=json.loads).start()
    register_client_assign_property(ds.property)
    # file contents: {"serverHost": "10.0.0.5", "serverPort": 18730,
    #                 "requestTimeout": 20, "namespace": "ns1"}

    register_cluster_mode_property(mode_ds.property)
    # contents: 0 | 1 | -1, or {"mode": 1, "tokenPort": 18730}

Where the reference's listeners log and swallow every exception, the port's
swallow only a payload they reject (logged, the reference's contract: a bad
mode value, a non-mapping assignment, an assignment without a server). A
failure to build, start or move the token service or its door, or to
install the client, propagates out of the listener: a direct
``property.update_value`` or ``datasource.refresh()`` raises it, and a
polling data source counts it in ``refresh_failure_totals()``. A fleet
left without a token server is never only a log line.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

from sentinel_tpu_torch.cluster.api import ClusterMode
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.core.property import DynamicProperty
from sentinel_tpu_torch.transport.command import ServerFactory

_lock = threading.Lock()
_assign_property: Optional[DynamicProperty] = None
_assign_listener = None
_mode_property: Optional[DynamicProperty] = None
_mode_listener = None


def _on_assignment(value) -> None:
    if value is None:
        return
    from sentinel_tpu_torch.transport.handlers import apply_client_assignment

    try:
        data = dict(value)
        int(data.get("serverPort", 0))
        int(data.get("requestTimeout", 20))
    except (TypeError, ValueError):
        record_log.exception("cluster assignment rejected: %r", value)
        return
    error = apply_client_assignment(data)
    if error:
        record_log.warning("cluster assignment rejected: %s", error)


def _on_mode(value, server_factory: Optional[ServerFactory] = None) -> None:
    if value is None:
        return
    from sentinel_tpu_torch.transport.handlers import apply_cluster_mode

    try:
        if isinstance(value, dict):
            mode = int(value.get("mode", -1))
            port = int(value.get("tokenPort", 18730))
        else:
            mode, port = int(value), 18730
        ClusterMode(mode)
    except (TypeError, ValueError):
        record_log.exception("cluster mode switch rejected: %r", value)
        return
    apply_cluster_mode(mode, port, server_factory)


def register_client_assign_property(prop: DynamicProperty) -> None:
    """Subscribe the token-client assignment to a property
    (``ClusterClientConfigManager.registerServerAssignProperty`` analog).
    The property's value is the modifyConfig payload:
    ``{serverHost, serverPort[, requestTimeout][, namespace]}``."""
    global _assign_property, _assign_listener
    with _lock:
        if _assign_property is not None and _assign_listener is not None:
            _assign_property.remove_listener(_assign_listener)
        _assign_property = prop
        _assign_listener = prop.listen(_on_assignment)


def register_cluster_mode_property(
    prop: DynamicProperty,
    server_factory: Optional[ServerFactory] = None,
) -> None:
    """Subscribe this agent's cluster mode to a property
    (``ClusterStateManager.registerProperty`` analog). The value is the
    setClusterMode payload: an int mode, or ``{mode, tokenPort}``.
    ``server_factory`` is ``apply_cluster_mode``'s: the door mode 1 starts
    (None: the reference's ``DefaultTokenService()``, on the card)."""
    global _mode_property, _mode_listener
    with _lock:
        if _mode_property is not None and _mode_listener is not None:
            _mode_property.remove_listener(_mode_listener)
        _mode_property = prop
        _mode_listener = prop.listen(
            functools.partial(_on_mode, server_factory=server_factory)
        )


def reset_for_tests() -> None:
    global _assign_property, _assign_listener, _mode_property, _mode_listener
    with _lock:
        if _assign_property is not None and _assign_listener is not None:
            _assign_property.remove_listener(_assign_listener)
        if _mode_property is not None and _mode_listener is not None:
            _mode_property.remove_listener(_mode_listener)
        _assign_property = _assign_listener = None
        _mode_property = _mode_listener = None
