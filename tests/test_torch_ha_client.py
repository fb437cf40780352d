"""The port's client-side HA (``sentinel_tpu_torch.ha``: the endpoint
breaker, the failover token client and the local fallback policy) and the
cluster client's reconnect, against the JAX package's.

- The reference's ``tests/test_ha.py`` on the port: ``TestEndpointHealth``,
  ``TestFailoverClient``, ``TestLocalFallbackPolicy``,
  ``TestClientReconnectBackoff`` and ``TestKillPrimaryDrill``, the drill
  through the port's asyncio door and through its native door. The stub
  member client has the port ``TokenClient``'s whole surface: the port's
  failover client probes its members for no hook.
- The dead connection's teardown wakes only the waiters of that connection:
  a request that reconnected while the teardown ran gets its answer, not a
  spurious FAIL (the reference's client wakes every waiter; ROADMAP §C).
- Across packages, in lockstep on both packages' manual clocks: the port's
  ``FailoverTokenClient`` over two JAX doors and the JAX one over two port
  doors answer a seeded sequence of flow, batch, param and ping requests
  equally, through the primary, after it stops (the walk to the second
  door) and after both stop (the fallback policy).
"""

import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from sentinel_tpu.cluster.server import TokenServer as JTokenServer  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.param import ParamConfig as JParamConfig  # noqa: E402
from sentinel_tpu.engine.rules import ThresholdMode as JTM  # noqa: E402
from sentinel_tpu.ha import FailoverTokenClient as JFailover  # noqa: E402
from sentinel_tpu.ha import FallbackAction as JAction  # noqa: E402
from sentinel_tpu.ha import FallbackRule as JFallbackRule  # noqa: E402
from sentinel_tpu.ha import LocalFallbackPolicy as JPolicy  # noqa: E402
from sentinel_tpu.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as j_reset_metrics,
)

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
    TokenResult,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.engine.rules import ThresholdMode  # noqa: E402
from sentinel_tpu_torch.ha import (  # noqa: E402
    Endpoint,
    EndpointHealth,
    FailoverTokenClient,
    FallbackAction,
    FallbackRule,
    HealthState,
    LocalFallbackPolicy,
)
from sentinel_tpu_torch.metrics.ha import (  # noqa: E402
    ha_metrics,
    reset_ha_metrics_for_tests,
)
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
)
from torch_ha_check import manual_clocks  # noqa: E402

CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=64)
G = ThresholdMode.GLOBAL


@pytest.fixture(autouse=True)
def _fresh_ha_metrics():
    reset_ha_metrics_for_tests()
    yield
    reset_ha_metrics_for_tests()


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` (the suite's fixture installs the JAX
    package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


class StubClient:
    """client_factory stand-in: scriptable per-endpoint behavior, with the
    port ``TokenClient``'s surface."""

    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        self.host = host
        self.port = port
        self.alive = True
        self.calls = 0
        self.closed = False
        self.on_brownout = None
        self.consecutive_failures = 0

    def request_token(self, flow_id, acquire=1, prioritized=False):
        self.calls += 1
        if not self.alive:
            return TokenResult(TokenStatus.FAIL)
        return TokenResult(TokenStatus.OK, remaining=int(self.port))

    def request_batch_arrays(self, flow_ids, acquires=None, prios=None,
                             timeout_ms=None):
        self.calls += 1
        if not self.alive:
            return None
        n = len(flow_ids)
        return (
            np.full(n, int(TokenStatus.OK), np.int8),
            np.full(n, int(self.port), np.int32),
            np.zeros(n, np.int32),
        )

    def ping_ex(self, namespace=None):
        # None = no reply (transport failure), as TokenClient.ping_ex
        self.calls += 1
        return True if self.alive else None

    def lease_stats(self):
        return {}

    def close(self):
        self.closed = True


class TestEndpointHealth:
    def test_closed_allows_and_failures_below_threshold_stay_closed(
        self, manual_clock
    ):
        h = EndpointHealth(failure_threshold=3, backoff_base_ms=100,
                           rand=lambda: 0.0)
        assert h.allows_request() and h.healthy
        h.record_failure()
        h.record_failure()
        assert h.state == HealthState.CLOSED
        assert h.allows_request()
        assert h.consecutive_failures == 2

    def test_threshold_opens_and_backoff_gates_retry(self, manual_clock):
        h = EndpointHealth(failure_threshold=2, backoff_base_ms=100,
                           jitter=0.0, rand=lambda: 0.0)
        h.record_failure()
        h.record_failure()
        assert h.state == HealthState.OPEN
        assert not h.allows_request()
        manual_clock.advance(99)
        assert not h.allows_request()
        manual_clock.advance(1)
        # backoff elapsed: exactly ONE probe admitted
        assert h.allows_request()
        assert h.state == HealthState.HALF_OPEN
        assert not h.allows_request()

    def test_probe_success_closes(self, manual_clock):
        h = EndpointHealth(failure_threshold=1, backoff_base_ms=50,
                           jitter=0.0, rand=lambda: 0.0)
        h.record_failure()
        manual_clock.advance(50)
        assert h.allows_request()
        h.record_success()
        assert h.state == HealthState.CLOSED
        assert h.consecutive_failures == 0
        assert h.allows_request()

    def test_probe_failure_doubles_backoff(self, manual_clock):
        h = EndpointHealth(failure_threshold=1, backoff_base_ms=100,
                           backoff_max_ms=10_000, jitter=0.0,
                           rand=lambda: 0.0)
        h.record_failure()  # opens, retry in 100ms
        first_retry = h.retry_at_ms
        assert first_retry == manual_clock.now_ms() + 100
        manual_clock.advance(100)
        assert h.allows_request()  # half-open probe
        h.record_failure()  # probe failed → re-open with 200ms
        assert h.state == HealthState.OPEN
        assert h.retry_at_ms == manual_clock.now_ms() + 200

    def test_backoff_caps_at_max(self, manual_clock):
        h = EndpointHealth(failure_threshold=1, backoff_base_ms=100,
                           backoff_max_ms=400, jitter=0.0, rand=lambda: 0.0)
        for _ in range(6):  # many open cycles
            h.record_failure()
            manual_clock.advance(int(h.retry_at_ms - manual_clock.now_ms()))
            assert h.allows_request()
        h.record_failure()
        assert h.retry_at_ms - manual_clock.now_ms() == 400

    def test_jitter_applied(self, manual_clock):
        h = EndpointHealth(failure_threshold=1, backoff_base_ms=100,
                           jitter=0.5, rand=lambda: 1.0)
        h.record_failure()
        assert h.retry_at_ms == manual_clock.now_ms() + 150

    def test_snapshot_shape(self):
        h = EndpointHealth(failure_threshold=1)
        snap = h.snapshot()
        assert snap["state"] == "CLOSED"
        assert snap["consecutiveFailures"] == 0

    def test_forfeited_half_open_probe_readmits_after_grace(
        self, manual_clock
    ):
        h = EndpointHealth(failure_threshold=1, backoff_base_ms=100,
                           jitter=0.0, rand=lambda: 0.0)
        h.record_failure()
        manual_clock.advance(100)
        assert h.allows_request()  # probe slot handed out
        assert h.state == HealthState.HALF_OPEN
        assert not h.allows_request()
        # the probe's dispatcher died without reporting: after a
        # backoff-length grace the slot forfeits and a fresh probe goes out
        # instead of the breaker refusing forever
        manual_clock.advance(100)
        assert h.allows_request()
        h.record_success()
        assert h.state == HealthState.CLOSED


class TestFailoverClient:
    def _client(self, fallback=None, **kw):
        kw.setdefault("failure_threshold", 2)
        kw.setdefault("backoff_base_ms", 50.0)
        return FailoverTokenClient(
            [("primary", 1), ("standby", 2)],
            client_factory=StubClient, fallback=fallback, **kw
        )

    def test_serves_from_primary_when_healthy(self):
        fc = self._client()
        r = fc.request_token(7)
        assert r.ok and r.remaining == 1  # StubClient answers its port
        assert str(fc.active_endpoint) == "primary:1"

    def test_dead_primary_evicted_standby_serves(self):
        fc = self._client()
        fc._members[0].client.alive = False
        r = fc.request_token(7)
        # the SAME request walks past the failing primary to the standby
        assert r.ok and r.remaining == 2
        assert str(fc.active_endpoint) == "standby:2"
        failovers = ha_metrics().snapshot()["failover"]
        assert {"from": "primary:1", "to": "standby:2", "count": 1} in failovers
        # after threshold failures the primary stops being tried at all
        fc.request_token(7)
        calls_before = fc._members[0].client.calls
        fc.request_token(7)
        assert fc._members[0].client.calls == calls_before

    def test_all_down_resolves_via_fallback_never_raises(self):
        policy = LocalFallbackPolicy(
            [FallbackRule(9, FallbackAction.BLOCK)],
            default_action=FallbackAction.PASS,
        )
        fc = self._client(fallback=policy)
        for m in fc._members:
            m.client.alive = False
        for _ in range(10):
            r = fc.request_token(9)
            assert r.status == TokenStatus.BLOCKED
            assert fc.request_token(777).status == TokenStatus.OK
        degraded = [
            f for f in ha_metrics().snapshot()["failover"] if f["to"] == ""
        ]
        assert degraded and degraded[0]["count"] >= 1

    def test_default_fallback_is_pass_through(self):
        fc = self._client()  # no explicit policy
        for m in fc._members:
            m.client.alive = False
        assert fc.request_token(1).status == TokenStatus.OK

    def test_batch_arrays_degrade_to_fallback(self):
        policy = LocalFallbackPolicy([FallbackRule(5, FallbackAction.BLOCK)])
        fc = self._client(fallback=policy)
        for m in fc._members:
            m.client.alive = False
        status, remaining, wait = fc.request_batch_arrays(
            np.array([5, 6], np.int64)
        )
        assert status.tolist() == [int(TokenStatus.BLOCKED), int(TokenStatus.OK)]
        assert remaining.shape == wait.shape == (2,)

    def test_recovered_primary_serves_again(self, manual_clock):
        fc = self._client()
        fc._members[0].client.alive = False
        assert fc.request_token(7).remaining == 2  # standby took over
        fc.request_token(7)  # breaker opens on the primary
        fc._members[0].client.alive = True
        manual_clock.advance(10_000)  # backoff elapses → half-open probe
        r = fc.request_token(7)
        assert r.remaining == 1
        assert str(fc.active_endpoint) == "primary:1"
        assert fc._members[0].health.state == HealthState.CLOSED

    def test_unprobed_standby_not_stuck_half_open(self, manual_clock):
        # full outage opens both breakers; after recovery the first request
        # must flip only the endpoint it actually dispatches to — a standby
        # the walk never reaches must not be parked in HALF_OPEN (a state
        # only record_success/record_failure can leave)
        fc = self._client()  # threshold 2, backoff 50ms
        for m in fc._members:
            m.client.alive = False
        fc.request_token(1)
        fc.request_token(1)
        assert all(m.health.state == HealthState.OPEN for m in fc._members)
        for m in fc._members:
            m.client.alive = True
        manual_clock.advance(60_000)  # both backoffs elapsed
        assert fc.request_token(1).remaining == 1  # primary probe serves
        assert fc._members[1].health.state == HealthState.OPEN
        # and the standby still takes over the moment the primary dies again
        fc._members[0].client.alive = False
        r = fc.request_token(1)
        assert r.ok and r.remaining == 2

    def test_raising_client_treated_as_failure(self):
        class Raising(StubClient):
            def request_token(self, *a, **k):
                raise ConnectionError("boom")

        fc = FailoverTokenClient(
            [("p", 1), ("s", 2)],
            client_factory=lambda h, p, **kw: (
                Raising(h, p, **kw) if p == 1 else StubClient(h, p, **kw)
            ),
            failure_threshold=1,
        )
        r = fc.request_token(1)
        assert r.ok and r.remaining == 2

    def test_ping_and_health_snapshot(self):
        fc = self._client()
        assert fc.ping() is True
        fc._members[0].client.alive = False
        fc._members[1].client.alive = False
        fc.request_token(1)
        fc.request_token(1)
        assert fc.ping() is False
        snap = fc.health_snapshot()
        assert [e["endpoint"] for e in snap] == ["primary:1", "standby:2"]
        assert all(e["state"] == "OPEN" for e in snap)

    def test_ping_false_answer_does_not_charge_breaker(self):
        class NsRejecting(StubClient):
            def ping_ex(self, namespace=None):
                self.calls += 1
                if not self.alive:
                    return None
                return False  # reachable, but rejects the namespace

        fc = FailoverTokenClient(
            [("p", 1)], client_factory=NsRejecting, failure_threshold=1
        )
        for _ in range(5):
            assert fc.ping("unknown") is False
        health = fc._members[0].health
        assert health.state == HealthState.CLOSED
        assert health.consecutive_failures == 0

    def test_ping_transport_failure_still_charges_breaker(self):
        fc = self._client()  # threshold 2
        for m in fc._members:
            m.client.alive = False
        assert fc.ping() is False
        assert fc.ping() is False
        assert all(m.health.state == HealthState.OPEN for m in fc._members)

    def test_close_closes_every_member(self):
        fc = self._client()
        fc.close()
        assert all(m.client.closed for m in fc._members)

    def test_endpoint_objects_accepted(self):
        fc = FailoverTokenClient(
            [Endpoint("h", 42)], client_factory=StubClient
        )
        assert fc.request_token(1).remaining == 42

    def test_empty_endpoint_list_rejected(self):
        with pytest.raises(ValueError):
            FailoverTokenClient([], client_factory=StubClient)


class TestLocalFallbackPolicy:
    def test_action_matrix(self):
        policy = LocalFallbackPolicy(
            [
                FallbackRule(1, FallbackAction.PASS),
                FallbackRule(2, FallbackAction.BLOCK),
            ],
            default_action=FallbackAction.BLOCK,
        )
        assert policy.decide(1).status == TokenStatus.OK
        assert policy.decide(2).status == TokenStatus.BLOCKED
        assert policy.decide(999).status == TokenStatus.BLOCKED

    def test_throttle_enforces_local_budget(self, manual_clock):
        policy = LocalFallbackPolicy(
            [FallbackRule(3, FallbackAction.THROTTLE, count=5.0)]
        )
        verdicts = [policy.decide(3).status for _ in range(8)]
        assert verdicts.count(TokenStatus.OK) == 5
        assert verdicts.count(TokenStatus.BLOCKED) == 3
        # the next window refills the budget
        manual_clock.advance(1000)
        assert policy.decide(3).status == TokenStatus.OK

    def test_throttle_budget_holds_across_threads(self, manual_clock,
                                                 monkeypatch):
        # the window's read yields the interpreter, so that a thread
        # switch between the check and the count shows as over-admission
        from sentinel_tpu_torch.local.stat import StatisticNode

        read = StatisticNode.pass_qps

        def slow_read(self, now=None):
            qps = read(self, now)
            time.sleep(0.0005)
            return qps

        monkeypatch.setattr(StatisticNode, "pass_qps", slow_read)
        policy = LocalFallbackPolicy(
            default_action=FallbackAction.THROTTLE, default_count=20.0)
        passed = []

        def work():
            passed.append(sum(policy.decide(9).status == TokenStatus.OK
                              for _ in range(40)))

        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert sum(passed) == 20
        assert policy.stats()["passed"] == 20
        assert policy.stats()["blocked"] == 8 * 40 - 20

    def test_throttle_pacing_mode(self, manual_clock):
        policy = LocalFallbackPolicy(
            [FallbackRule(4, FallbackAction.THROTTLE, count=1000.0,
                          max_queueing_time_ms=50)]
        )
        # pacing admits sequential requests at 1/ms without blocking
        for _ in range(3):
            assert policy.decide(4).status == TokenStatus.OK

    def test_stats_and_counters(self):
        policy = LocalFallbackPolicy(
            [FallbackRule(2, FallbackAction.BLOCK)]
        )
        policy.decide(1)
        policy.decide(2)
        stats = policy.stats()
        assert stats == {"passed": 1, "blocked": 1, "blocked_rate": 0.5}
        totals = ha_metrics().fallback_totals()
        assert totals["pass"] == 1 and totals["block"] == 1

    def test_default_throttle_unlisted_id_uses_default_budget(
        self, manual_clock
    ):
        policy = LocalFallbackPolicy(
            default_action=FallbackAction.THROTTLE, default_count=2.0
        )
        verdicts = [policy.decide(77).status for _ in range(4)]
        assert verdicts.count(TokenStatus.OK) == 2
        assert verdicts.count(TokenStatus.BLOCKED) == 2

    def test_default_throttle_zero_budget_blocks_never_raises(self):
        policy = LocalFallbackPolicy(default_action=FallbackAction.THROTTLE)
        assert policy.decide(5).status == TokenStatus.BLOCKED
        status, _, _ = policy.decide_batch_arrays(np.array([5, 6], np.int64))
        assert status.tolist() == [int(TokenStatus.BLOCKED)] * 2

    def test_reload_resets_throttle_state(self, manual_clock):
        rule = FallbackRule(3, FallbackAction.THROTTLE, count=2.0)
        policy = LocalFallbackPolicy([rule])
        policy.decide(3)
        policy.decide(3)
        assert policy.decide(3).status == TokenStatus.BLOCKED
        policy.load_rules([rule])  # fresh controller → fresh budget
        assert policy.decide(3).status == TokenStatus.OK


class TestClientReconnectBackoff:
    def test_backoff_grows_with_consecutive_failures(self):
        client = TokenClient("127.0.0.1", 1)  # nothing listens on port 1
        assert client.consecutive_failures == 0
        assert client._ensure_connected() is False
        assert client.consecutive_failures == 1
        first_delay = client._reconnect_delay_s
        assert 0 < first_delay < 1.0
        # inside the backoff window the client does NOT dial again
        assert client._ensure_connected() is False
        assert client.consecutive_failures == 1
        # force the gate open repeatedly: the delay ladder doubles
        client._last_connect_attempt = 0.0
        client._ensure_connected()
        assert client.consecutive_failures == 2
        assert client._reconnect_delay_s > first_delay

    def test_backoff_caps_at_max(self):
        client = TokenClient("127.0.0.1", 1)
        client._reconnect_max_s = 0.5
        for _ in range(12):
            client._last_connect_attempt = 0.0
            client._ensure_connected()
        assert client.consecutive_failures == 12
        assert client._reconnect_delay_s <= 0.5 * 1.2001  # max × (1+jitter)

    def test_success_resets_failure_count(self):
        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules([ClusterFlowRule(1, 100.0, G)])
        server = TokenServer(svc, port=0)
        server.start()
        try:
            client = TokenClient("127.0.0.1", 1)
            client._ensure_connected()  # fails: port 1
            assert client.consecutive_failures == 1
            client.port = server.port
            client._last_connect_attempt = 0.0
            assert client._ensure_connected() is True
            assert client.consecutive_failures == 0
            assert client._reconnect_delay_s == 0.0
            client.close()
        finally:
            server.stop()

    def test_ping_ex_separates_transport_failure_from_answer(self):
        dead = TokenClient("127.0.0.1", 1)  # nothing listens on port 1
        assert dead.ping_ex() is None
        assert dead.ping() is False
        dead.close()
        svc = DefaultTokenService(CFG, device="cpu")
        server = TokenServer(svc, port=0)
        server.start()
        try:
            live = TokenClient("127.0.0.1", server.port, timeout_ms=2000)
            assert live.ping_ex() is True
            assert live.ping() is True
            live.close()
        finally:
            server.stop()


class TestKillPrimaryDrill:
    """ISSUE acceptance: with two servers up and the primary killed
    mid-load, the client converges on the standby within the deadline; with
    all servers down every request resolves via local fallback."""

    @staticmethod
    def _start_server(door):
        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules([ClusterFlowRule(42, 10_000.0, G)])
        server = (TokenServer if door == "asyncio" else NativeTokenServer)(
            svc, port=0)
        server.start()
        return server

    @pytest.mark.parametrize("door", ["asyncio", "native"])
    def test_failover_within_deadline_then_fallback(self, door):
        primary = self._start_server(door)
        standby = self._start_server(door)
        deadline_ms = 500.0
        fc = FailoverTokenClient(
            [("127.0.0.1", primary.port), ("127.0.0.1", standby.port)],
            timeout_ms=200,
            failure_threshold=1,
            deadline_ms=deadline_ms,
            fallback=LocalFallbackPolicy(
                [FallbackRule(42, FallbackAction.BLOCK)]
            ),
        )
        try:
            assert fc.request_token(42).ok
            assert str(fc.active_endpoint) == f"127.0.0.1:{primary.port}"
            primary.stop()  # the kill
            t0 = time.monotonic()
            converged_ms = None
            while time.monotonic() - t0 < 5.0:
                r = fc.request_token(42)  # must never raise
                if (
                    r.ok
                    and str(fc.active_endpoint)
                    == f"127.0.0.1:{standby.port}"
                ):
                    converged_ms = (time.monotonic() - t0) * 1e3
                    break
            assert converged_ms is not None, "never converged on the standby"
            assert converged_ms <= deadline_ms, converged_ms
            assert fc.request_token(42).ok  # standby keeps serving
            standby.stop()  # now EVERYTHING is down
            saw_block = False
            for _ in range(20):
                r = fc.request_token(42)  # still never raises
                saw_block = saw_block or r.status == TokenStatus.BLOCKED
            assert saw_block, "fallback policy never engaged"
        finally:
            fc.close()
            primary.stop()
            standby.stop()


class _HeldServer:
    """A raw token server on localhost: answers PING at once and holds
    every FLOW reply until ``release`` is set. ``flows`` counts the FLOW
    frames it received."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.release = threading.Event()
        self.got_flow = threading.Event()
        self.conns = []
        self._stop = False
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        reader = P.FrameReader()
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    return
                for payload in reader.feed(data):
                    req = P.decode_request(payload)
                    if isinstance(req, P.Ping):
                        conn.sendall(P.encode_response(P.FlowResponse(
                            req.xid, P.MsgType.PING, 0, 1)))
                        continue
                    self.got_flow.set()
                    self.release.wait(10)
                    conn.sendall(P.encode_response(P.FlowResponse(
                        req.xid, P.MsgType.FLOW, int(TokenStatus.OK), 7)))
        except OSError:
            return

    def close(self):
        self._stop = True
        self.release.set()
        self.sock.close()
        for c in self.conns:
            c.close()


class TestReconnectRace:
    def test_dead_connection_teardown_wakes_only_its_own_waiters(
            self, monkeypatch):
        """The old connection's teardown is held between clearing ``_sock``
        and waking its waiters (its ``close``); a request reconnects in that
        window and waits on the new connection. Once the teardown goes on,
        that request must still get its answer, not a FAIL."""
        server = _HeldServer()
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            assert client.ping()
            old = client._sock
            entered, hold = threading.Event(), threading.Event()
            real_close = socket.socket.close

            def held_close(sock):
                if sock is old:
                    entered.set()
                    hold.wait(10)
                real_close(sock)

            monkeypatch.setattr(socket.socket, "close", held_close)
            teardown = threading.Thread(
                target=client._drop_connection, args=(old,), daemon=True)
            teardown.start()
            assert entered.wait(5)
            assert client._sock is None
            result = {}
            req = threading.Thread(
                target=lambda: result.setdefault(
                    "r", client.request_token(1)), daemon=True)
            req.start()
            assert server.got_flow.wait(5)  # sent on the new connection
            assert client._sock is not None and client._sock is not old
            hold.set()
            teardown.join(5)
            assert not teardown.is_alive()
            time.sleep(0.05)  # a wrongly woken waiter answers FAIL now
            server.release.set()
            req.join(5)
            assert not req.is_alive()
            r = result["r"]
            assert r.status == TokenStatus.OK and r.remaining == 7, r
        finally:
            hold.set()
            server.release.set()
            monkeypatch.undo()
            client.close()
            server.close()


def _across_plan(rng: np.random.Generator) -> list:
    """Seeded client calls: single flows, batches, param requests and pings
    on the door pair's flows, in three acts separated by door stops."""
    steps = []
    for act in range(3):
        for _ in range(14):
            kind = rng.choice(["flow", "batch", "param", "ping"],
                              p=[0.4, 0.3, 0.2, 0.1])
            if kind == "flow":
                steps.append(("flow", int(rng.choice(_FLOWS)),
                              int(rng.integers(1, 3))))
            elif kind == "batch":
                steps.append(("batch", rng.choice(_FLOWS + [999], 9)))
            elif kind == "param":
                steps.append(("param", _PARAM_FLOW,
                              [int(h) for h in rng.integers(1, 40, 2)]))
            else:
                steps.append(("ping",))
            if rng.random() < 0.3:
                steps.append(("advance", int(rng.integers(50, 400))))
        if act < 2:
            steps.append(("stop", act))
    return steps


_FLOWS = [1, 2, 3, 4]
_PARAM_FLOW = 9


def _answer(client, step):
    kind = step[0]
    if kind == "flow":
        r = client.request_token(step[1], step[2])
        return (int(r.status), r.remaining, r.wait_ms)
    if kind == "batch":
        out = client.request_batch_arrays(np.asarray(step[1], np.int64))
        return tuple(tuple(int(v) for v in a) for a in out)
    if kind == "param":
        r = client.request_params_token(step[1], 1, step[2])
        return (int(r.status), r.remaining, r.wait_ms)
    return bool(client.ping())


class TestAcrossPackages:
    def test_failover_clients_answer_equally_across_doors(self):
        """The port's failover client over two JAX doors and the JAX one
        over two port doors, in lockstep: every answer equal through the
        primary, the walk after it stops and the fallback after both stop."""
        t_reset_metrics()
        j_reset_metrics()
        with manual_clocks() as (jc, tc):
            j_doors, t_doors = [], []
            for _ in range(2):
                js = JService(JConfig(max_flows=64, max_namespaces=4,
                                      batch_size=64),
                              param_config=JParamConfig(max_param_rules=16,
                                                        width=128))
                js.load_rules([JRule(f, 5.0 + f, JTM.GLOBAL)
                               for f in _FLOWS])
                js.load_param_rules([JParamRule(_PARAM_FLOW, 3.0)])
                ts = DefaultTokenService(
                    EngineConfig(max_flows=64, max_namespaces=4,
                                 batch_size=64),
                    param_config=ParamConfig(max_param_rules=16, width=128),
                    device="cpu")
                ts.load_rules([ClusterFlowRule(f, 5.0 + f, G)
                               for f in _FLOWS])
                ts.load_param_rules([ClusterParamFlowRule(_PARAM_FLOW, 3.0)])
                j_doors.append(JTokenServer(js, port=0, idle_ttl_s=None,
                                            push=False))
                t_doors.append(TokenServer(ts, port=0, idle_ttl_s=None,
                                           push=False))
            for d in j_doors + t_doors:
                d.start()
            # the port's client on the JAX doors, the JAX client on the
            # port's; the same policy on both sides
            port_fc = FailoverTokenClient(
                [("127.0.0.1", d.port) for d in j_doors], timeout_ms=5000,
                failure_threshold=1, fallback=LocalFallbackPolicy(
                    [FallbackRule(1, FallbackAction.BLOCK),
                     FallbackRule(2, FallbackAction.THROTTLE, count=2.0)],
                    default_action=FallbackAction.PASS))
            jax_fc = JFailover(
                [("127.0.0.1", d.port) for d in t_doors], timeout_ms=5000,
                failure_threshold=1, fallback=JPolicy(
                    [JFallbackRule(1, JAction.BLOCK),
                     JFallbackRule(2, JAction.THROTTLE, count=2.0)],
                    default_action=JAction.PASS))
            try:
                for k, step in enumerate(_across_plan(
                        np.random.default_rng(31))):
                    if step[0] == "advance":
                        jc.advance(step[1])
                        tc.advance(step[1])
                        continue
                    if step[0] == "stop":
                        j_doors[step[1]].stop()
                        t_doors[step[1]].stop()
                        continue
                    a = _answer(port_fc, step)
                    b = _answer(jax_fc, step)
                    assert a == b, (k, step, a, b)
                    assert port_fc._active == jax_fc._active, (k, step)
                assert port_fc._active == 1
                assert port_fc.fallback.stats() == jax_fc.fallback.stats()
                assert port_fc.fallback.stats()["blocked"] > 0
                assert [e["state"] for e in port_fc.health_snapshot()] == \
                    [e["state"] for e in jax_fc.health_snapshot()]
            finally:
                port_fc.close()
                jax_fc.close()
                for d in j_doors + t_doors:
                    d.stop()
