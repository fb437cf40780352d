"""Process-global cluster state + the local flow checker's cluster branch
(the port's copy of ``sentinel_tpu/cluster/api.py``).

Analog of ``ClusterStateManager.java:38-86`` (mode CLIENT=0 / SERVER=1) and
the verdict-application half of ``FlowRuleChecker.passClusterCheck``
(``FlowRuleChecker.java:147-208``).
"""

from __future__ import annotations

import enum
import threading
from typing import Optional

from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.decide import TokenStatus


class ClusterMode(enum.IntEnum):
    NOT_STARTED = -1
    CLIENT = 0
    SERVER = 1  # embedded token server


_lock = threading.RLock()
_mode = ClusterMode.NOT_STARTED
_client: Optional[TokenService] = None
_embedded: Optional[TokenService] = None


def _close_quietly(service) -> None:
    # a client's close is best-effort (leases, outcomes): a failure there
    # must not stop a mode switch
    try:
        service.close()
    except Exception:
        record_log.exception("closing token client %r failed", service)


def set_client(client: TokenService) -> None:
    global _client, _mode
    with _lock:
        prev, _client = _client, client
        _mode = ClusterMode.CLIENT
    # a replaced client holds a socket + reader thread; reassignment (e.g.
    # the dashboard re-pointing the fleet) must not leak one per swap
    if prev is not None and prev is not client:
        _close_quietly(prev)


def clear_client() -> None:
    """Drop (and close) the installed token client WITHOUT switching modes —
    the client holds a socket + reader thread, so a node promoted to SERVER
    (or switched off) must not leak one per transition."""
    global _client
    with _lock:
        prev, _client = _client, None
    if prev is not None:
        _close_quietly(prev)


def set_embedded_server(service: TokenService) -> None:
    global _embedded, _mode
    with _lock:
        _embedded = service
        _mode = ClusterMode.SERVER


def clear_embedded_server() -> None:
    """Demotion path: forget the embedded service WITHOUT switching modes —
    cluster/server/* commands must answer 'not a token server' afterwards
    instead of operating on a stopped server's service."""
    global _embedded
    with _lock:
        _embedded = None


def set_mode(mode: ClusterMode) -> None:
    global _mode
    with _lock:
        _mode = mode


def get_mode() -> ClusterMode:
    return _mode


def get_embedded_server() -> Optional[TokenService]:
    """The in-process token service when this agent runs in SERVER mode
    (``EmbeddedClusterTokenServerProvider`` analog) — the cluster/server/*
    command handlers operate on it."""
    return _embedded


def _pick_service() -> Optional[TokenService]:
    """``FlowRuleChecker.pickClusterService`` (``:176-184``)."""
    if _mode == ClusterMode.CLIENT:
        return _client
    if _mode == ClusterMode.SERVER:
        return _embedded
    return None


def reset_for_tests() -> None:
    global _mode, _client, _embedded
    with _lock:
        prev_client, _client = _client, None
        _mode = ClusterMode.NOT_STARTED
        _embedded = None
    if prev_client is not None:
        _close_quietly(prev_client)


# -- called from sentinel_tpu_torch.local.flow ------------------------------------


def request_token(rule, acquire: int, prioritized: bool) -> Optional[TokenResult]:
    service = _pick_service()
    if service is None:
        return None
    flow_id = (rule.cluster_config or {}).get("flow_id")
    if flow_id is None:
        return None
    return service.request_token(int(flow_id), acquire, prioritized)


def apply_token_result(
    result: TokenResult, rule, context, node, acquire, prioritized, fallback
) -> bool:
    """``FlowRuleChecker.applyTokenResult`` (``:186-208``): OK → pass;
    SHOULD_WAIT → sleep the hint then pass; BLOCKED → block; anything else
    (FAIL / NO_RULE / TOO_MANY) → local fallback or pass-through."""
    if result.status == TokenStatus.OK:
        return True
    if result.status == TokenStatus.SHOULD_WAIT:
        _clock.get_clock().wait_ms(result.wait_ms)
        return True
    if result.status == TokenStatus.BLOCKED:
        return False
    return fallback(rule, context, node, acquire, prioritized)
