"""FailoverTokenClient: ordered endpoint list with eviction + fallback
(the port's copy of ``sentinel_tpu/ha/failover.py``).

A drop-in ``TokenService`` for the client side of cluster flow control:
instead of pinning one host (``cluster.client.TokenClient``), it walks an
ordered endpoint list — primary first, standbys after — and serves each
request from the first endpoint whose circuit breaker admits it. A FAIL
verdict (the client-side degraded status for send failure / timeout /
connection loss) records a failure against that endpoint; after
``failure_threshold`` consecutive failures the endpoint is evicted (breaker
OPEN) and the next request goes straight to the standby — so a SIGKILLed
primary costs at most ``threshold × request_timeout`` of unhealthy verdicts
before the standby serves, well inside the configured failover deadline.

When NO endpoint is available (all breakers open, or the per-request
failover deadline is spent), the request resolves through the
:class:`~sentinel_tpu_torch.ha.fallback.LocalFallbackPolicy` — pass, block, or
local-window throttle per rule — and never raises.

Wire-level behavior (timeouts, pipelined BATCH_FLOW chunks, reconnect
backoff) stays in the wrapped per-endpoint ``TokenClient``s; this class only
decides *where* a request goes and *what* happens when nowhere is healthy.

Unlike the reference, the walk probes its members for no hook: a
``client_factory`` builds objects with the port ``TokenClient``'s surface
(``on_brownout``, ``ping_ex``, ``lease_stats``, ``consecutive_failures``
besides the ``TokenService`` calls), and a missing one is an
``AttributeError``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from sentinel_tpu_torch.cluster.client import TokenClient
from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.ha.endpoints import Endpoint, EndpointHealth
from sentinel_tpu_torch.ha.fallback import LocalFallbackPolicy
from sentinel_tpu_torch.metrics.ha import ha_metrics

KEY_FAILOVER_DEADLINE_MS = "sentinel.tpu.ha.failover.deadline.ms"


class _Member:
    __slots__ = ("endpoint", "health", "client")

    def __init__(self, endpoint: Endpoint, health: EndpointHealth, client):
        self.endpoint = endpoint
        self.health = health
        self.client = client


class FailoverTokenClient(TokenService):
    def __init__(
        self,
        endpoints: Sequence,
        timeout_ms: int = 20,
        namespace: str = "default",
        fallback: Optional[LocalFallbackPolicy] = None,
        failure_threshold: Optional[int] = None,
        backoff_base_ms: Optional[float] = None,
        backoff_max_ms: Optional[float] = None,
        deadline_ms: Optional[float] = None,
        client_factory: Callable = TokenClient,
        lease: bool = False,
        lease_want: int = 256,
    ):
        if not endpoints:
            raise ValueError("at least one endpoint required")
        self.namespace = namespace
        self.timeout_ms = timeout_ms
        # lease kwargs are forwarded only when enabled so stub factories
        # that predate wire rev 5 keep working unchanged
        extra = {"lease": True, "lease_want": lease_want} if lease else {}
        # overall per-request budget for walking the endpoint list; once
        # spent, the request degrades to fallback instead of trying further
        # standbys (the configured failover deadline)
        self.deadline_ms = float(
            deadline_ms
            if deadline_ms is not None
            else SentinelConfig.get_float(KEY_FAILOVER_DEADLINE_MS, 500.0)
        )
        self.fallback = fallback if fallback is not None else (
            LocalFallbackPolicy()
        )
        self._members: List[_Member] = []
        for ep in endpoints:
            if not isinstance(ep, Endpoint):
                ep = Endpoint(str(ep[0]), int(ep[1]))
            self._members.append(
                _Member(
                    ep,
                    EndpointHealth(
                        failure_threshold=failure_threshold,
                        backoff_base_ms=backoff_base_ms,
                        backoff_max_ms=backoff_max_ms,
                    ),
                    client_factory(
                        ep.host, ep.port, timeout_ms=timeout_ms,
                        namespace=namespace, **extra,
                    ),
                )
            )
        self._lock = threading.Lock()
        self._active = 0  # index of the member that served last (telemetry)
        # rev-7 brownout advisories: per-member wall-clock until which the
        # endpoint has ADVERTISED it is shedding. An advisory only reorders
        # the walk (standbys first) — it never removes the endpoint, so a
        # fleet-wide brownout still gets served by the least-bad member.
        self._brownout_until: List[float] = [0.0] * len(self._members)
        for i, member in enumerate(self._members):
            self._arm_push(i, member)

    # -- rev-7 push interest -------------------------------------------------
    def _arm_push(self, index: int, member: _Member) -> None:
        """(Re-)subscribe to a member client's brownout pushes. The callback
        lives on the client object and survives its internal reconnects;
        re-arming after a walk lands elsewhere (``_note_served``) keeps the
        subscription alive even if a wrapper swapped the callback out."""
        client = member.client

        def _advise(level, retry_after_ms, _i=index):
            if int(level) <= 0:
                self._brownout_until[_i] = 0.0
                return
            hold = float(retry_after_ms) if retry_after_ms > 0 else 100.0
            self._brownout_until[_i] = _clock.now_ms() + hold

        client.on_brownout = _advise

    def _walk_order(self) -> List[int]:
        """Endpoint indices in walk order: members without a live brownout
        advisory first, advertised-browned members demoted to the tail (the
        early-walk hint — we reach the standby BEFORE burning a round trip
        on an endpoint that told us it is shedding). All browned, or none:
        the configured order stands."""
        now = _clock.now_ms()
        until = self._brownout_until
        n = len(self._members)
        browned = [i for i in range(n) if until[i] > now]
        if not browned or len(browned) == n:
            return list(range(n))
        ha_metrics().count_fallback("brownout_hint")
        return [i for i in range(n) if until[i] <= now] + browned

    # -- endpoint walk -------------------------------------------------------
    def _note_served(self, index: int) -> None:
        with self._lock:
            if index != self._active:
                prev = self._members[self._active].endpoint
                ha_metrics().count_failover(
                    str(prev), str(self._members[index].endpoint),
                    now_ms=_clock.now_ms(),
                )
                record_log.warning(
                    "token client failed over: %s -> %s", prev,
                    self._members[index].endpoint,
                )
                self._active = index
                # the walk landed on a different endpoint: re-register push
                # interest there so revocations/advisories keep flowing
                self._arm_push(index, self._members[index])

    def _note_exhausted(self) -> None:
        """Every endpoint refused or failed → this request degrades."""
        with self._lock:
            prev = self._members[self._active].endpoint
        ha_metrics().count_failover(str(prev), "", now_ms=_clock.now_ms())

    @staticmethod
    def _overloaded(result) -> bool:
        """An explicit server-side admission refusal (OVERLOAD). A batch
        counts only when EVERY row was refused — a partially-admitted batch
        is an answer and returns to the caller as-is."""
        if isinstance(result, TokenResult):
            return result.status == TokenStatus.OVERLOAD
        if isinstance(result, tuple) and len(result) == 3:
            status = np.asarray(result[0])
            return status.size > 0 and bool(
                (status == int(TokenStatus.OVERLOAD)).all()
            )
        return False

    @staticmethod
    def _moved_redirect(result) -> bool:
        """A live-rebalance redirect (MOVED): the namespace is being (or has
        been) handed to another server. Same whole-batch rule as OVERLOAD."""
        if isinstance(result, TokenResult):
            return result.status == TokenStatus.MOVED
        if isinstance(result, tuple) and len(result) == 3:
            status = np.asarray(result[0])
            return status.size > 0 and bool(
                (status == int(TokenStatus.MOVED)).all()
            )
        return False

    @staticmethod
    def _standby_refusal(result) -> bool:
        """An unpromoted warm standby's closed-door refusal (STANDBY). Same
        whole-batch rule as OVERLOAD: every row refused, or it's an
        answer."""
        if isinstance(result, TokenResult):
            return result.status == TokenStatus.STANDBY
        if isinstance(result, tuple) and len(result) == 3:
            status = np.asarray(result[0])
            return status.size > 0 and bool(
                (status == int(TokenStatus.STANDBY)).all()
            )
        return False

    @staticmethod
    def _degraded(result) -> bool:
        """A server-side circuit-breaker refusal (DEGRADED): the resource's
        breaker is OPEN and the server is answering honestly with a
        retry-after hint. Same whole-batch rule as OVERLOAD."""
        if isinstance(result, TokenResult):
            return result.status == TokenStatus.DEGRADED
        if isinstance(result, tuple) and len(result) == 3:
            status = np.asarray(result[0])
            return status.size > 0 and bool(
                (status == int(TokenStatus.DEGRADED)).all()
            )
        return False

    @staticmethod
    def _lease_refusal(result) -> bool:
        """A lease-protocol refusal (NOT_LEASABLE: flow not leasable, lease
        revoked, or no headroom to delegate). The wrapped per-endpoint
        client already degrades its own lease refusals to per-request RPCs,
        so this only fires for custom clients that surface the status — but
        when it does, the server is alive and answering honestly. Same
        whole-batch rule as OVERLOAD."""
        if isinstance(result, TokenResult):
            return result.status == TokenStatus.NOT_LEASABLE
        if isinstance(result, tuple) and len(result) == 3:
            status = np.asarray(result[0])
            return status.size > 0 and bool(
                (status == int(TokenStatus.NOT_LEASABLE)).all()
            )
        return False

    def _call(self, op: Callable, failed=None):
        """Walk available endpoints inside the deadline; ``op(member)``
        returns the raw result and ``failed(result)`` judges it. Returns the
        first healthy result or None when the list is exhausted.

        OVERLOAD replies are proof of life, not failure: the server is up
        and explicitly refusing admission, so the breaker records SUCCESS
        (evicting an overloaded-but-alive server would dogpile the
        standbys) and the walk tries the next endpoint. When every
        reachable endpoint is overloaded the first OVERLOAD reply — with
        its retry hint — is returned rather than degrading to fallback.

        STANDBY replies are likewise proof of life: an unpromoted warm
        standby keeps its door closed so clients walk on to the primary.
        Unlike OVERLOAD, a STANDBY reply carries no verdict at all, so it
        is never returned — if nothing else answers, the local fallback
        decides (without counting the cluster as exhausted: the standby is
        alive and about to promote).

        MOVED replies (live shard rebalancing) are proof of life too: the
        server is up and telling us the namespace now lives elsewhere. This
        client has no shard map to follow the redirect with (that is
        RoutingTokenClient's job), so it records SUCCESS — evicting a
        healthy server for answering honestly would be wrong — and walks on
        to the next endpoint, which may be the move's destination.

        DEGRADED replies (server-side circuit breaking) are proof of life
        as well: the resource's breaker is OPEN, which says the PROTECTED
        DEPENDENCY is unhealthy, not the token server. The breaker records
        SUCCESS and the walk tries the next endpoint (a standby whose
        replicated breaker lags may still admit); when nothing answers
        better the first DEGRADED verdict — with its retry-after hint in
        ``remaining`` — is returned rather than degrading to fallback,
        which would defeat the breaker's whole purpose."""
        if failed is None:
            failed = lambda r: (
                r is None
                or (isinstance(r, TokenResult)
                    and r.status == TokenStatus.FAIL)
            )
        deadline = _clock.now_ms() + self.deadline_ms
        overload_result = None
        degraded_result = None
        saw_standby = False
        for i in self._walk_order():
            member = self._members[i]
            # health is consulted immediately before dispatch, never up
            # front for the whole list: allows_request() may flip an OPEN
            # breaker to HALF_OPEN and hand this call its one probe slot,
            # which MUST be followed by record_success/record_failure below
            # — a member the walk never reaches (earlier endpoint served,
            # deadline broke the loop) must not be flipped speculatively
            if not member.health.allows_request():
                continue
            try:
                result = op(member)
            except Exception:
                record_log.exception(
                    "token endpoint %s raised; treating as failure",
                    member.endpoint,
                )
                result = None
            if failed(result):
                member.health.record_failure()
                if _clock.now_ms() >= deadline:
                    break
                continue
            member.health.record_success()
            if self._standby_refusal(result):
                saw_standby = True
                ha_metrics().count_fallback("standby_redirect")
                if _clock.now_ms() >= deadline:
                    break
                continue
            if self._moved_redirect(result):
                saw_standby = True  # alive, not exhausted — same as STANDBY
                ha_metrics().count_fallback("moved_redirect")
                if _clock.now_ms() >= deadline:
                    break
                continue
            if self._lease_refusal(result):
                # proof of life, never eviction: a server refusing to
                # delegate its window still decides per-request RPCs fine.
                # The refusal carries no admission verdict, so walk on; the
                # member's own client falls back to wire on the next call.
                saw_standby = True
                ha_metrics().count_fallback("lease_refused")
                if _clock.now_ms() >= deadline:
                    break
                continue
            if self._degraded(result):
                ha_metrics().count_fallback("degraded")
                if degraded_result is None:
                    degraded_result = result
                if _clock.now_ms() >= deadline:
                    break
                continue
            if self._overloaded(result):
                ha_metrics().count_fallback("overload_backoff")
                if overload_result is None:
                    overload_result = result
                if _clock.now_ms() >= deadline:
                    break
                continue
            self._note_served(i)
            return result
        if degraded_result is not None:
            # the breaker verdict is authoritative cluster state (the same
            # OPEN row replicates everywhere) — prefer it over OVERLOAD
            return degraded_result
        if overload_result is not None:
            return overload_result
        if not saw_standby:
            self._note_exhausted()
        return None

    # -- TokenService --------------------------------------------------------
    def request_token(self, flow_id, acquire=1, prioritized=False):
        result = self._call(
            lambda m: m.client.request_token(flow_id, acquire, prioritized)
        )
        if result is not None:
            return result
        return self.fallback.decide(flow_id, acquire, prioritized)

    def request_params_token(self, flow_id, acquire, param_hashes):
        result = self._call(
            lambda m: m.client.request_params_token(
                flow_id, acquire, param_hashes
            )
        )
        if result is not None:
            return result
        return self.fallback.decide(flow_id, acquire)

    def request_concurrent_token(self, flow_id, acquire=1, prioritized=False):
        result = self._call(
            lambda m: m.client.request_concurrent_token(
                flow_id, acquire, prioritized
            )
        )
        if result is not None:
            return result
        return self.fallback.decide(flow_id, acquire, prioritized)

    def release_concurrent_token(self, token_id):
        result = self._call(
            lambda m: m.client.release_concurrent_token(token_id)
        )
        if result is not None:
            return result
        # a release that can reach no server is lost either way; report OK so
        # callers don't retry forever against a dead cluster (the server-side
        # TTL sweep reclaims the permit)
        ha_metrics().count_fallback("release_dropped")
        return TokenResult(TokenStatus.RELEASE_OK)

    # -- hierarchy tier (share agent → coordinator) --------------------------
    def _hier_call(self, op: Callable):
        """Endpoint walk for hierarchy control ops (share grant/renew/
        return, demand report). STANDBY replies walk on as usual;
        NOT_LEASABLE is ambiguous here — the true coordinator refusing
        headroom, or a door with no coordinator attached — so it walks on
        too but is REMEMBERED and returned when no endpoint answers
        better (the agent treats it as an authoritative zero-share)."""
        deadline = _clock.now_ms() + self.deadline_ms
        refusal = None
        for i in self._walk_order():
            member = self._members[i]
            if not member.health.allows_request():
                continue
            try:
                result = op(member)
            except Exception:
                record_log.exception(
                    "hier endpoint %s raised; treating as failure",
                    member.endpoint,
                )
                result = None
            if result is None:
                member.health.record_failure()
                if _clock.now_ms() >= deadline:
                    break
                continue
            member.health.record_success()
            if int(result.status) == int(TokenStatus.STANDBY):
                ha_metrics().count_fallback("standby_redirect")
                if _clock.now_ms() >= deadline:
                    break
                continue
            if int(result.status) == int(TokenStatus.NOT_LEASABLE):
                if refusal is None:
                    refusal = result
                if _clock.now_ms() >= deadline:
                    break
                continue
            self._note_served(i)
            return result
        return refusal

    def share_op(self, msg_type, flow_id, want=0, share_id=0, used=0):
        """Walk endpoints for a SHARE_* op; returns ``P.LeaseResponse``
        or None when nothing answered."""
        return self._hier_call(
            lambda m: m.client.share_op(
                msg_type, flow_id, want, share_id=share_id, used=used
            )
        )

    def demand_report(self, pod_id, entries):
        """Walk endpoints for a DEMAND_REPORT; returns the ack
        ``P.LeaseResponse`` or None."""
        return self._hier_call(
            lambda m: m.client.demand_report(pod_id, entries)
        )

    def request_batch_arrays(self, flow_ids, acquires=None, prios=None,
                             timeout_ms: Optional[int] = None):
        def op(member):
            return member.client.request_batch_arrays(
                flow_ids, acquires, prios, timeout_ms=timeout_ms
            )

        result = self._call(op, failed=lambda r: r is None)
        if result is not None:
            # degraded verdicts inside an otherwise-delivered batch (FAIL
            # statuses) stay as-is: the server answered, per-row FAIL means
            # the server's own step degraded, not the transport
            return result
        return self.fallback.decide_batch_arrays(flow_ids, acquires, prios)

    def request_batch(self, requests):
        if not requests:
            return []
        n = len(requests)
        status, remaining, wait = self.request_batch_arrays(
            np.fromiter((f for f, _, _ in requests), np.int64, n),
            np.fromiter((a for _, a, _ in requests), np.int32, n),
            np.fromiter((p for _, _, p in requests), bool, n),
        )
        return [
            TokenResult(TokenStatus(int(status[i])), int(remaining[i]),
                        int(wait[i]))
            for i in range(n)
        ]

    def ping(self, namespace: Optional[str] = None) -> bool:
        """True when some endpoint's server answers the ping affirmatively.

        Only transport-level failure — no reply at all, or a raised
        exception — charges an endpoint's breaker. A live server that
        answers the ping negatively (e.g. an unknown namespace) is
        reachable, and repeated health pings must not evict it from
        rotation; its answer closes the breaker and is returned as-is."""
        answered_no = False
        deadline = _clock.now_ms() + self.deadline_ms
        for i in self._walk_order():
            member = self._members[i]
            if not member.health.allows_request():
                continue
            try:
                # None = transport failure, bool = the server's answer
                reply = member.client.ping_ex(namespace)
            except Exception:
                record_log.exception(
                    "token endpoint %s raised on ping; treating as failure",
                    member.endpoint,
                )
                reply = None
            if reply is None:
                member.health.record_failure()
                if _clock.now_ms() >= deadline:
                    break
                continue
            member.health.record_success()  # reachable: the probe is answered
            if reply:
                self._note_served(i)
                return True
            answered_no = True
        if not answered_no:
            self._note_exhausted()
        return False

    # -- lifecycle / introspection ------------------------------------------
    def close(self) -> None:
        for member in self._members:
            try:
                member.client.close()
            except Exception:
                pass

    @property
    def active_endpoint(self) -> Endpoint:
        with self._lock:
            return self._members[self._active].endpoint

    def lease_stats(self) -> dict:
        """Merged lease counters across member clients (zeros when the
        members don't lease)."""
        merged: dict = {}
        for member in self._members:
            try:
                for key, value in member.client.lease_stats().items():
                    merged[key] = merged.get(key, 0) + int(value)
            except Exception:
                continue
        return merged

    def health_snapshot(self) -> List[dict]:
        out = []
        with self._lock:
            active = self._active
        now = _clock.now_ms()
        for i, member in enumerate(self._members):
            entry = {"endpoint": str(member.endpoint), "active": i == active}
            entry["brownoutMs"] = max(0, int(self._brownout_until[i] - now))
            entry.update(member.health.snapshot())
            entry["connectFailures"] = int(member.client.consecutive_failures)
            out.append(entry)
        return out
