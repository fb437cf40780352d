"""Namespace-routing token client (the port's copy of
``sentinel_tpu/cluster/routing.py``).

The reference points each app at its namespace's token server through
assignment config (``ClusterClientAssignConfig`` pushed via the property
system); an app in several namespaces would run several clients. This client
generalizes that: it holds one ``TokenClient`` per pod and routes each
request by ``flow_id → namespace → pod``, so a caller is oblivious to the
partitioning (``cluster/namespaces.py``).

Reconfiguration (``update``) swaps the routing tables atomically — in-flight
requests finish against the old pod (its verdict is still valid: counters
are ephemeral and the old owner keeps enforcing until clients drain), new
requests go to the new owner. The whole routing view lives in ONE immutable
``_RouteState`` object replaced wholesale under the lock: readers take a
single reference-read snapshot, so no request can observe half of an update
(new pod table, old endpoint table), and retired clients are closed only
AFTER the new state is visible — never under the lock, never while a reader
that snapshotted the old state may still be dispatching on them.

Live rebalancing (``cluster.rebalance``) plugs in two ways: shard maps
pushed through the property system land via :meth:`apply_shard_map`
(epoch-fenced — a stale map is ignored), and a server answering
``TokenStatus.MOVED`` teaches the client passively: the response's
``remaining`` carries the new shard-map epoch and (on transports that
support it) ``endpoint`` names the destination, so the client installs the
route, retries once against the new owner, and degrades through the local
fallback policy if the destination is unreachable.

Unlike the reference, the router probes its pod clients for no hook: each
must have ``ping``, ``close`` and an assignable ``on_shard_map`` (the
port's :class:`~sentinel_tpu_torch.cluster.client.TokenClient` does), and
one that lacks them raises ``AttributeError``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

from sentinel_tpu_torch.cluster.client import TokenClient
from sentinel_tpu_torch.cluster.rebalance import decode_shard_map_doc
from sentinel_tpu_torch.cluster.token_service import (
    TokenResult,
    TokenService,
)
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.metrics.ha import ha_metrics

Endpoint = Tuple[str, int]


class _RouteState:
    """One immutable snapshot of the entire routing view. Never mutated
    after construction — reconfiguration builds a replacement and swaps the
    single ``RoutingTokenClient._state`` reference (atomic in CPython)."""

    __slots__ = ("epoch", "namespace_of", "pod_of", "endpoints", "clients",
                 "global_flows")

    def __init__(self, epoch, namespace_of, pod_of, endpoints, clients,
                 global_flows=None):
        self.epoch = int(epoch)  # shard-map epoch fence
        self.namespace_of: Mapping[int, str] = namespace_of
        self.pod_of: Mapping[str, str] = pod_of
        self.endpoints: Mapping[str, Endpoint] = endpoints
        self.clients: Mapping[str, TokenService] = clients
        # hierarchy tier: flow_id (str) → global budget coordinator
        # endpoint, carried verbatim from the shard map's global_flows
        # section under the same epoch fence
        self.global_flows: Mapping[str, str] = global_flows or {}

    def replace(self, **kw) -> "_RouteState":
        fields = {s: kw.get(s, getattr(self, s)) for s in self.__slots__}
        return _RouteState(**fields)


def _parse_endpoint(text: str) -> Optional[Endpoint]:
    host, sep, port = str(text).rpartition(":")
    if not sep or not host:
        return None
    try:
        return host, int(port)
    except ValueError:
        return None


class RoutingTokenClient(TokenService):
    def __init__(
        self,
        timeout_ms: int = 20,
        namespace_of: Optional[Mapping[int, str]] = None,
        pod_of: Optional[Mapping[str, str]] = None,
        endpoints: Optional[Mapping[str, Endpoint]] = None,
        client_factory: Callable[..., TokenService] = TokenClient,
        fallback=None,
        shard_maps=None,
    ):
        self.timeout_ms = timeout_ms
        self._factory = client_factory
        self._lock = threading.Lock()
        # the one mutable cell: an immutable routing snapshot, swapped
        # wholesale (see module docstring)
        self._state = _RouteState(
            0, dict(namespace_of or {}), dict(pod_of or {}),
            dict(endpoints or {}), {},
        )
        # when the cluster moves a namespace out from under us and the
        # destination is unreachable, this policy answers locally instead of
        # surfacing MOVED to the caller (None → MOVED is surfaced)
        self.fallback = fallback
        # namespaces each pod's client has declared via the PING handshake —
        # a pod can serve several, and AVG_LOCAL counts need every one
        self._declared: Dict[str, set] = {}
        # concurrent-mode: per-pod token ids are local counters (each pod's
        # ConcurrencyManager counts from 1), so the router namespaces the
        # ids it returns by embedding a pod number in the high bits — the
        # caller-visible id is globally unique and release routes exactly
        self._pod_nums: Dict[str, int] = {}  # pod_id → 1-based number
        self._pods_by_num: Dict[int, str] = {}
        if shard_maps is not None:
            # ShardMapPublisher (cluster.rebalance): follow pushes passively
            shard_maps.listen(self.apply_shard_map)

    # -- reconfiguration ----------------------------------------------------
    @property
    def epoch(self) -> int:
        """Shard-map epoch of the installed routing view."""
        return self._state.epoch

    @property
    def _clients(self) -> Mapping[str, TokenService]:
        """Read-only view of the live per-pod clients (tests and
        introspection; the authoritative copy lives in ``_state``)."""
        return self._state.clients

    def update(
        self,
        namespace_of: Optional[Mapping[int, str]] = None,
        pod_of: Optional[Mapping[str, str]] = None,
        endpoints: Optional[Mapping[str, Endpoint]] = None,
    ) -> None:
        """Install new routing tables (assignment-config push analog).
        Pods that disappeared get their clients closed — only after the new
        state is published, so a reader that routed on the old snapshot
        never dispatches on a client closed mid-request by this thread."""
        retired = []
        with self._lock:
            st = self._state
            kw = {}
            if namespace_of is not None:
                kw["namespace_of"] = dict(namespace_of)
            if pod_of is not None:
                kw["pod_of"] = dict(pod_of)
            if endpoints is not None:
                kw["endpoints"] = dict(endpoints)
                clients = dict(st.clients)
                for pod_id in list(clients):
                    if pod_id not in kw["endpoints"]:
                        retired.append(clients.pop(pod_id))
                        self._declared.pop(pod_id, None)
                kw["clients"] = clients
            self._state = st.replace(**kw)
        for client in retired:  # after the swap, outside the lock
            client.close()

    def apply_shard_map(self, shard_map) -> bool:
        """Point every namespace the map names at its endpoint. Epoch-fenced:
        a map no newer than the installed view is ignored (returns False),
        so out-of-order pushes can't roll routes back."""
        with self._lock:
            st = self._state
            if int(shard_map.epoch) <= st.epoch:
                return False
            pod_of = dict(st.pod_of)
            endpoints = dict(st.endpoints)
            for ns, ep_text in shard_map.endpoint_of.items():
                ep = _parse_endpoint(ep_text)
                if ep is None:
                    record_log.warning(
                        "shard map epoch %s names unparseable endpoint %r "
                        "for %r; keeping old route",
                        shard_map.epoch, ep_text, ns,
                    )
                    continue
                pod_of[ns] = str(ep_text)
                endpoints[str(ep_text)] = ep
            kw = {}
            gf = shard_map.global_flows
            if gf:
                # the hierarchy section replaces wholesale — it is part of
                # the same epoched document, not a per-entry merge
                kw["global_flows"] = dict(gf)
            self._state = st.replace(
                epoch=int(shard_map.epoch), pod_of=pod_of,
                endpoints=endpoints, **kw,
            )
        return True

    def _wire_push(self, client) -> None:
        """Subscribe a freshly-built pod client to rev-7 shard-map pushes:
        decoded maps feed :meth:`apply_shard_map`, so a MOVE or election
        outcome re-routes us within one RTT instead of a MOVED round trip.
        The epoch fence makes stale or duplicate pushes harmless."""

        def _learn(blob: bytes) -> None:
            try:
                self.apply_shard_map(decode_shard_map_doc(blob))
            except ValueError:
                pass  # torn push payload; the polling plane will catch up

        client.on_shard_map = _learn

    def coordinator_of(self, flow_id) -> Optional[str]:
        """The global budget coordinator endpoint for ``flow_id`` per the
        installed shard map's ``global_flows`` section, or None when the
        flow has no hierarchical budget. Lock-free snapshot read."""
        return self._state.global_flows.get(str(int(flow_id)))

    def _learn_move(self, namespace: str, ep_text: str, epoch: int) -> bool:
        """Install a single route learned from a MOVED redirect. Same epoch
        fence as :meth:`apply_shard_map`."""
        ep = _parse_endpoint(ep_text)
        if ep is None:
            return False
        with self._lock:
            st = self._state
            if int(epoch) <= st.epoch:
                return False
            pod_of = dict(st.pod_of)
            endpoints = dict(st.endpoints)
            pod_of[namespace] = str(ep_text)
            endpoints[str(ep_text)] = ep
            self._state = st.replace(
                epoch=int(epoch), pod_of=pod_of, endpoints=endpoints,
            )
        return True

    # -- routing ------------------------------------------------------------
    def _route_for(self, flow_id: int):
        """(client, pod_id) actually routed to, or None. One state snapshot
        decides the route — callers that need the pod identity (concurrent
        token-id prefixing) must use THIS pair, not re-derive the pod, or a
        concurrent update() can name a different pod than the issuer."""
        st = self._state  # one atomic snapshot; no lock for the happy path
        ns = st.namespace_of.get(flow_id)
        if ns is None:
            return None
        pod_id = st.pod_of.get(ns)
        if pod_id is None:
            return None
        client = st.clients.get(pod_id)
        declare = False
        if client is None:
            with self._lock:
                st = self._state  # re-snapshot: tables may have moved on
                pod_id = st.pod_of.get(ns, pod_id)
                endpoint = st.endpoints.get(pod_id)
                if endpoint is None:
                    return None
                client = st.clients.get(pod_id)
                if client is None:
                    client = self._factory(
                        endpoint[0], endpoint[1],
                        timeout_ms=self.timeout_ms, namespace=ns,
                    )
                    self._wire_push(client)
                    clients = dict(st.clients)
                    clients[pod_id] = client
                    self._state = st.replace(clients=clients)
                    self._declared[pod_id] = {ns}  # ctor namespace auto-pings
                elif ns not in self._declared.setdefault(pod_id, set()):
                    self._declared[pod_id].add(ns)
                    declare = True
        else:
            with self._lock:
                if ns not in self._declared.setdefault(pod_id, set()):
                    self._declared[pod_id].add(ns)
                    declare = True
        if declare:
            # additional namespace on an existing pod connection: declare it
            # so the server's AVG_LOCAL connection count includes us
            # (best-effort, outside the lock — a lost ping only delays the
            # count to the next keepalive)
            client.ping(namespace=ns)
        return client, pod_id

    def _client_for(self, flow_id: int) -> Optional[TokenService]:
        route = self._route_for(flow_id)
        return None if route is None else route[0]

    # -- MOVED redirects ----------------------------------------------------
    @staticmethod
    def _is_moved(result) -> bool:
        return (
            isinstance(result, TokenResult)
            and result.status == TokenStatus.MOVED
        )

    def _follow_move(self, flow_id, from_pod, moved, op, decide):
        """A server answered MOVED: learn the new route (from the response's
        endpoint trailer, or a shard-map push that already landed), retry
        ONCE against the new owner, and degrade through the local fallback
        policy when the destination is unreachable or unknown. Returns
        (result, pod_id) with the pod that actually issued the verdict."""
        ha_metrics().count_fallback("moved_follow")
        st = self._state
        ns = st.namespace_of.get(flow_id)
        endpoint = moved.endpoint or ""
        epoch = int(moved.remaining)
        if ns is not None and endpoint:
            self._learn_move(ns, endpoint, epoch)
        route = self._route_for(flow_id)
        if route is not None and route[1] != from_pod:
            client, pod_id = route
            try:
                result = op(client)
            except Exception:
                record_log.exception(
                    "moved-to destination %s raised; degrading", pod_id,
                )
                result = None
            if result is not None and not self._is_moved(result):
                return result, pod_id
        # no newer route, destination unreachable, or it answered MOVED
        # again (a second hop inside one request is a routing storm, not a
        # redirect to chase): answer locally or surface the redirect
        if self.fallback is not None:
            ha_metrics().count_fallback("moved_degraded")
            return decide(), from_pod
        return moved, from_pod

    # -- TokenService -------------------------------------------------------
    def request_token(self, flow_id, acquire=1, prioritized=False) -> TokenResult:
        route = self._route_for(flow_id)
        if route is None:
            # unknown flow/namespace/pod: same shape as the reference's
            # no-rule path — caller falls back to its local check
            return TokenResult(TokenStatus.NO_RULE_EXISTS)
        client, pod_id = route
        result = client.request_token(flow_id, acquire, prioritized)
        if self._is_moved(result):
            result, _ = self._follow_move(
                flow_id, pod_id, result,
                lambda c: c.request_token(flow_id, acquire, prioritized),
                lambda: self.fallback.decide(flow_id, acquire, prioritized),
            )
        return result

    def request_params_token(self, flow_id, acquire, param_hashes) -> TokenResult:
        route = self._route_for(flow_id)
        if route is None:
            return TokenResult(TokenStatus.NO_RULE_EXISTS)
        client, pod_id = route
        result = client.request_params_token(flow_id, acquire, param_hashes)
        if self._is_moved(result):
            result, _ = self._follow_move(
                flow_id, pod_id, result,
                lambda c: c.request_params_token(
                    flow_id, acquire, param_hashes
                ),
                lambda: self.fallback.decide(flow_id, acquire),
            )
        return result

    # pod number lives in bits 48+ of the caller-visible token id; pod-local
    # ids below 2^48 (a per-pod counter would take >8900 years at 1M acq/s)
    _POD_ID_SHIFT = 48
    _LOCAL_ID_MASK = (1 << 48) - 1

    def request_concurrent_token(self, flow_id, acquire=1, prioritized=False):
        route = self._route_for(flow_id)
        if route is None:
            return TokenResult(TokenStatus.NO_RULE_EXISTS)
        client, pod_id = route
        result = client.request_concurrent_token(flow_id, acquire, prioritized)
        if self._is_moved(result):
            result, pod_id = self._follow_move(
                flow_id, pod_id, result,
                lambda c: c.request_concurrent_token(
                    flow_id, acquire, prioritized
                ),
                lambda: self.fallback.decide(flow_id, acquire, prioritized),
            )
        if (
            result.ok and result.token_id
            and result.token_id <= self._LOCAL_ID_MASK
        ):
            with self._lock:
                num = self._pod_nums.get(pod_id)
                if num is None:
                    num = len(self._pod_nums) + 1
                    self._pod_nums[pod_id] = num
                    self._pods_by_num[num] = pod_id
            return TokenResult(
                result.status, result.remaining, result.wait_ms,
                (num << self._POD_ID_SHIFT) | result.token_id,
            )
        return result

    def release_concurrent_token(self, token_id):
        token_id = int(token_id)
        num = token_id >> self._POD_ID_SHIFT
        local_id = token_id & self._LOCAL_ID_MASK
        st = self._state
        with self._lock:
            pod_id = self._pods_by_num.get(num)
        if pod_id is not None and pod_id in st.clients:
            clients = [st.clients[pod_id]]
        elif num:
            # prefixed id whose issuing pod left the routing table: only
            # that pod could hold the token (ids are pod-scoped), and its
            # counters died with it — fail fast as already-released.
            # Broadcasting the masked local id could wrongly release an
            # UNRELATED token that another pod issued under the same
            # local counter value.
            return TokenResult(TokenStatus.ALREADY_RELEASE)
        else:
            # genuinely unprefixed id (issued outside the router):
            # degrade to first-success fan-out with the raw id
            clients = list(st.clients.values())
        result = TokenResult(TokenStatus.FAIL)
        for client in clients:
            r = client.release_concurrent_token(local_id)
            if r.ok:  # RELEASE_OK — a release never answers plain OK
                return r
            result = r
        return result

    def close(self) -> None:
        with self._lock:
            st = self._state
            self._state = st.replace(clients={})
            self._declared.clear()
        for client in st.clients.values():
            client.close()
