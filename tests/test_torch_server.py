"""The port's asyncio front door (``sentinel_tpu_torch.cluster.server``)
serving a CPU ``DefaultTokenService``, against the JAX package's.

- Lockstep parity: one seeded frame sequence (``torch_door_check``: Zipf
  BATCH_FLOW pulls, one larger than a frame, FLOW, PARAM_FLOW, OUTCOME_REPORT
  with a PING barrier, leases, CONCURRENT acquire / release, over breakers)
  through the JAX ``TokenServer`` and the port's, each over its own package's
  ``ManualClock``: the reply bytes must be equal, and so must
  ``outcome_stats`` / ``breaker_stats`` / ``lease_stats`` afterwards.
- The door's cases of the reference's ``tests/test_cluster.py`` on the port
  (``TestTransport``, ``TestMultiLoopServer``, ``TestIdleReaping``,
  ``TestProfilingHook``, ``TestPipelinedDispatch``,
  ``TestReviewRegressions``), driven by the port's ``TokenClient``
  (``TestEmbeddedClusterFlow`` needs the local engine, ROADMAP item 13).
- ``metrics_port`` serves the Prometheus exposition (the exporter), the
  constructor's signature pinned to the reference's, and hierarchy frames routed to an attached
  coordinator through both of the port's doors (NOT_LEASABLE without one).
"""

import inspect
import shutil
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule as JConcRule,
)
from sentinel_tpu.cluster.server import TokenServer as JTokenServer  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import DegradeRule as JDegrade  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.param import ParamConfig as JParamConfig  # noqa: E402
from sentinel_tpu.engine.rules import (  # noqa: E402
    DegradeStrategy as JDS,
    ThresholdMode as JTM,
)
from sentinel_tpu.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as j_reset_metrics,
)

import torch_door_check as DK  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from torch_kernel_check import ZipfIds  # noqa: E402
from sentinel_tpu_torch.cluster import client as client_mod  # noqa: E402
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu_torch.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule,
)
from sentinel_tpu_torch.cluster.connection import ConnectionManager  # noqa: E402
from sentinel_tpu_torch.cluster.hierarchy import (  # noqa: E402
    GlobalBudgetCoordinator,
    GlobalFlowBudget,
)
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    DegradeRule,
    DegradeStrategy,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
)

G = ThresholdMode.GLOBAL
CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=64)
START_MS = 1_700_000_000_000

# the lockstep configuration (as the native door's lockstep test): flows
# with every control behaviour, breakers on every 10th flow, four param
# rules, three lease flows, three concurrency rules
LS_FLOWS = 200
LS_KW = dict(max_flows=256, max_namespaces=4, batch_size=256)
LS_PARAM_KW = dict(max_param_rules=16, width=128)
LS_PARAM_FLOWS = (1000, 1001, 1002, 1003)
LS_LEASE_FLOWS = (151, 173, 193)
LS_CONC_FLOWS = (2000, 2001, 2002)
LS_PULLS = (64, 1024, 6000)
LS_ROUNDS = 3
LS_ADVANCES_MS = (5, 130, 45, 230)


@pytest.fixture(autouse=True)
def clean_metrics():
    t_reset_metrics()
    j_reset_metrics()
    yield
    t_reset_metrics()
    j_reset_metrics()


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` for one test."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


def _service(**kw):
    return DefaultTokenService(CFG, device="cpu", **kw)


@pytest.fixture
def live_server():
    svc = _service()
    svc.load_rules([ClusterFlowRule(flow_id=1, count=5.0, mode=G)])
    server = TokenServer(svc, port=0, batch_window_ms=0.5)
    server.start()
    yield server, svc
    server.stop()


def _wait(predicate, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# -- lockstep parity with the JAX asyncio door --------------------------------
def _ls_rule_fields(fid):
    beh = 1 if fid % 17 == 0 else 2 if fid % 13 == 0 else \
        3 if fid % 19 == 0 else 0
    return dict(flow_id=fid, count=20.0 + fid % 30, namespace=(
        "default" if fid % 3 else "ns1"), control_behavior=beh)


def _ls_load(svc, Rule, Degrade, DS, TM, ParamRule, ConcRule):
    degrade = []
    for fid in range(0, LS_FLOWS, 10):
        s = (fid // 10) % 3
        degrade.append(Degrade(
            flow_id=fid, strategy=DS(s), threshold=20.0 if s == 2 else 0.5,
            slow_rt_ms=100, min_request_amount=5, stat_interval_ms=1000,
            recovery_timeout_ms=1000))
    svc.load_degrade_rules(degrade)
    svc.load_rules([Rule(mode=TM.GLOBAL, **_ls_rule_fields(f))
                    for f in range(LS_FLOWS)], ns_max_qps=1e9)
    svc.load_param_rules([ParamRule(f, 5.0 + f % 3) for f in LS_PARAM_FLOWS])
    svc.load_concurrent_rules([ConcRule(f, 2, resource_timeout_ms=600_000)
                               for f in LS_CONC_FLOWS])


def _ls_run(server, mc):
    steps = DK.lockstep_plan(
        np.random.default_rng(9), ZipfIds(LS_FLOWS), np.arange(LS_FLOWS),
        LS_PULLS, LS_PARAM_FLOWS, LS_LEASE_FLOWS, LS_CONC_FLOWS, LS_ROUNDS,
        P.MAX_BATCH_PER_FRAME, LS_ADVANCES_MS)
    conn = DK.RawConn(P, server.port)
    try:
        conn.ping(1)
        return DK.run_lockstep(P, conn, steps, mc.advance)
    finally:
        conn.close()


def _stats(svc):
    return svc.outcome_stats(), svc.breaker_stats(), svc.lease_stats()


@pytest.fixture(scope="module")
def reference_lockstep():
    """The JAX asyncio door's replies and stats for the lockstep
    sequence."""
    mc = j_clock.ManualClock(START_MS)
    prev = j_clock.set_clock(mc)
    try:
        svc = JService(JConfig(**LS_KW),
                       param_config=JParamConfig(**LS_PARAM_KW))
        _ls_load(svc, JRule, JDegrade, JDS, JTM, JParamRule, JConcRule)
        server = JTokenServer(svc, port=0, idle_ttl_s=None)
        server.start()
        try:
            replies, counts = _ls_run(server, mc)
        finally:
            server.stop()
        return replies, counts, _stats(svc)
    finally:
        j_clock.set_clock(prev)


def test_lockstep_replies_equal_the_reference_door(reference_lockstep):
    ref_replies, ref_counts, ref_stats = reference_lockstep
    mc = t_clock.ManualClock(START_MS)
    prev = t_clock.set_clock(mc)
    try:
        svc = DefaultTokenService(EngineConfig(**LS_KW),
                                  param_config=ParamConfig(**LS_PARAM_KW),
                                  device="cpu")
        _ls_load(svc, ClusterFlowRule, DegradeRule, DegradeStrategy,
                 ThresholdMode, ClusterParamFlowRule, ConcurrentFlowRule)
        server = TokenServer(svc, port=0, idle_ttl_s=None)
        server.start()
        try:
            replies, counts = _ls_run(server, mc)
        finally:
            server.stop()
        stats = _stats(svc)
    finally:
        t_clock.set_clock(prev)
    assert counts == ref_counts
    assert counts["param_frames"] == 9
    assert len(replies) == len(ref_replies)
    for i, (a, b) in enumerate(zip(replies, ref_replies)):
        assert a == b, f"reply {i} differs"
    for name, a, b in zip(("outcome_stats", "breaker_stats", "lease_stats"),
                          stats, ref_stats):
        assert a == b, name
    outcome, breakers, leases = stats
    assert outcome["reported"] > 0 and sum(outcome["dropped"].values()) > 0
    assert leases["granted"] > 0 and leases["renewed"] > 0
    statuses = np.concatenate([
        P.decode_batch_response(r)[1] for r in replies
        if P.peek_type(r) == P.MsgType.BATCH_FLOW])
    for st in (TokenStatus.OK, TokenStatus.BLOCKED, TokenStatus.DEGRADED):
        assert (statuses == int(st)).any(), st


# -- TestReviewRegressions -----------------------------------------------------
class TestReviewRegressions:
    def test_connected_count_survives_rule_reload(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=5, count=3.0,
                                        mode=ThresholdMode.AVG_LOCAL)])
        svc.connected_count_changed("default", 3)
        svc.load_rules([ClusterFlowRule(flow_id=5, count=4.0,
                                        mode=ThresholdMode.AVG_LOCAL)])
        results = svc.request_batch([(5, 1, False)] * 20)
        assert sum(r.ok for r in results) == 12

    def test_connected_count_unknown_namespace_is_deferred(self, manual_clock):
        svc = _service()
        svc.connected_count_changed("ns-without-rules", 7)
        svc.load_rules([ClusterFlowRule(
            flow_id=9, count=2.0, mode=ThresholdMode.AVG_LOCAL,
            namespace="ns-without-rules")])
        results = svc.request_batch([(9, 1, False)] * 20)
        assert sum(r.ok for r in results) == 14

    def test_long_uptime_rebase_preserves_limits(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=3.0, mode=G)])
        assert svc.request_token(1).ok
        manual_clock.sleep(13 * 24 * 3600 * 1000)
        results = [svc.request_token(1) for _ in range(5)]
        assert sum(r.ok for r in results) == 3
        assert (manual_clock.now_ms() - svc._epoch_ms) < 2**30
        manual_clock.sleep(1100)
        assert svc.request_token(1).ok

    def test_bind_failure_raises_with_cause_and_allows_retry(self):
        svc = _service()
        s1 = TokenServer(svc, port=0)
        s1.start()
        try:
            s2 = TokenServer(svc, port=s1.port)
            with pytest.raises(RuntimeError, match="failed to start"):
                s2.start()
            s2.port = 0
            s2.start()
            s2.stop()
        finally:
            s1.stop()

    def test_concurrent_msgs_do_not_consume_flow_budget(self, live_server):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            r = client.request_concurrent_token(1)
            assert r.status == TokenStatus.NO_RULE_EXISTS
            assert sum(client.request_token(1).ok for _ in range(6)) == 5
        finally:
            client.close()


# -- TestTransport ---------------------------------------------------------------
class TestTransport:
    def test_client_server_roundtrip(self, live_server):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            assert client.ping()
            results = [client.request_token(1) for _ in range(8)]
            assert sum(r.ok for r in results) == 5
            assert sum(r.status == TokenStatus.BLOCKED for r in results) == 3
        finally:
            client.close()

    def test_client_survives_server_restart(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=2, count=1e9, mode=G)])
        server = TokenServer(svc, port=0)
        server.start()
        port = server.port
        client = TokenClient("127.0.0.1", port, timeout_ms=5000)
        try:
            assert client.request_token(2).ok
            server.stop()
            assert client.request_token(2).status == TokenStatus.FAIL
            svc2 = _service()
            svc2.load_rules([ClusterFlowRule(flow_id=2, count=1e9, mode=G)])
            server2 = TokenServer(svc2, port=port)
            server2.start()
            try:
                deadline = time.time() + 10
                while time.time() < deadline:
                    client._last_connect_attempt = 0.0  # skip the backoff
                    if client.request_token(2).ok:
                        break
                    time.sleep(0.1)
                else:
                    raise AssertionError("client never reconnected")
            finally:
                server2.stop()
        finally:
            client.close()

    def test_serving_under_concurrent_rule_reloads(self, manual_clock):
        svc = DefaultTokenService(CFG, device="cpu", serve_buckets=(64,))

        def rules(count):
            return [ClusterFlowRule(flow_id=i, count=count, mode=G)
                    for i in range(32)]
        svc.load_rules(rules(1e9), ns_max_qps=1e12)
        svc.warmup()
        stop = threading.Event()
        errors = []

        def reloader():
            c = 0
            try:
                while not stop.is_set():
                    c += 1
                    svc.load_rules(rules(1e9 + c), ns_max_qps=1e12)
            except Exception as e:
                errors.append(e)

        def worker(seed):
            rng = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    ids = rng.integers(0, 32, size=48).astype(np.int64)
                    status, _, _ = svc.request_batch_arrays(ids)
                    assert status.shape == (48,)
                    bad = set(np.unique(status)) - {
                        int(TokenStatus.OK), int(TokenStatus.BLOCKED)}
                    assert not bad, f"unexpected statuses {bad}"
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=reloader, daemon=True)] + [
            threading.Thread(target=worker, args=(k,), daemon=True)
            for k in range(3)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive(), "thread deadlocked"
        svc.close()
        assert not errors, errors[0]

    def test_decoders_never_crash_on_fuzzed_payloads(self):
        rng = np.random.default_rng(11)
        good = P.encode_batch_request(7, np.arange(5, dtype=np.int64))[2:]
        cases = [bytes(rng.integers(0, 256, size=int(n)).astype(np.uint8))
                 for n in rng.integers(0, 200, size=2000)]
        cases += [good[:k] for k in range(len(good))]
        for payload in cases:
            for fn in (P.decode_request, P.decode_batch_request,
                       P.decode_batch_response):
                try:
                    fn(payload)
                except (ValueError, struct.error):
                    pass

    def test_malformed_batch_response_degrades_to_none(self, live_server,
                                                       monkeypatch):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            assert client.ping()

            def _bad_decode(payload):
                raise ValueError("truncated frame")

            monkeypatch.setattr(client_mod.P, "decode_batch_response",
                                _bad_decode)
            assert client.request_batch_arrays(
                np.array([1, 1], np.int64)) is None
        finally:
            client.close()

    def test_concurrent_clients_share_budget(self, live_server):
        server, svc = live_server
        results = []
        lock = threading.Lock()

        def worker():
            client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
            try:
                mine = [client.request_token(1) for _ in range(4)]
                with lock:
                    results.extend(mine)
            finally:
                client.close()

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(r.ok for r in results) == 5
        assert len(results) == 16

    def test_timeout_returns_fail(self):
        client = TokenClient("127.0.0.1", 1, timeout_ms=50)
        assert client.request_token(1).status == TokenStatus.FAIL
        client.close()

    def test_batch_frame_roundtrip(self, live_server):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            status, _, _ = client.request_batch_arrays(
                np.full(8, 1, np.int64))
            assert status.shape == (8,)
            assert int((status == int(TokenStatus.OK)).sum()) == 5
            assert int((status == int(TokenStatus.BLOCKED)).sum()) == 3
        finally:
            client.close()

    def test_batch_matches_single_semantics(self, live_server):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            results = client.request_batch([(1, 1, False)] * 4)
            assert sum(r.ok for r in results) == 4
            singles = [client.request_token(1) for _ in range(4)]
            assert sum(r.ok for r in singles) == 1
        finally:
            client.close()

    def test_batch_unknown_flow_gets_no_rule(self, live_server):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            status, _, _ = client.request_batch_arrays(
                np.array([999999], np.int64))
            assert int(status[0]) == int(TokenStatus.NO_RULE_EXISTS)
        finally:
            client.close()


class TestMultiLoopServer:
    def test_reuseport_loops_share_budget(self):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=10.0, mode=G)])
        server = TokenServer(svc, port=0, n_loops=2)
        server.start()
        try:
            clients = [TokenClient("127.0.0.1", server.port, timeout_ms=5000)
                       for _ in range(4)]
            oks = 0
            for c in clients:
                out = c.request_batch_arrays(np.full(5, 1, np.int64))
                assert out is not None
                oks += int((out[0] == int(TokenStatus.OK)).sum())
            for c in clients:
                c.close()
            assert oks == 10
        finally:
            server.stop()


class TestIdleReaping:
    def test_sweep_deflates_connected_count(self, manual_clock):
        counts = {}
        cm = ConnectionManager(
            on_count_changed=lambda ns, n: counts.__setitem__(ns, n))
        cm.add("default", "10.0.0.1:1000")
        cm.add("default", "10.0.0.2:1000")
        assert counts["default"] == 2
        manual_clock.advance(500_000)
        cm.touch("10.0.0.2:1000")
        manual_clock.advance(400_000)
        assert cm.sweep_idle(ttl_ms=600_000) == ["10.0.0.1:1000"]
        assert counts["default"] == 1
        assert cm.connected_count("default") == 1

    def test_never_pinged_connection_is_reaped(self, manual_clock):
        cm = ConnectionManager()
        closed = []
        cm.attach_closer("10.0.0.9:4242", lambda: closed.append(True))
        manual_clock.advance(900_000)
        assert cm.sweep_idle(ttl_ms=600_000) == ["10.0.0.9:4242"]
        assert closed == [True]

    def test_touch_refreshes_never_pinged_connection(self, manual_clock):
        cm = ConnectionManager()
        cm.attach_closer("10.0.0.9:4242", lambda: None)
        manual_clock.advance(500_000)
        cm.touch("10.0.0.9:4242")
        manual_clock.advance(400_000)
        assert cm.sweep_idle(ttl_ms=600_000) == []

    def test_batch_traffic_refreshes_liveness(self, live_server, manual_clock):
        server, svc = live_server
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            assert client.ping()
            assert server.connections.connected_count("default") == 1
            manual_clock.advance(500_000)
            assert client.request_batch_arrays(
                np.array([1], np.int64)) is not None
            manual_clock.advance(200_000)
            assert server.connections.sweep_idle(ttl_ms=600_000) == []
            assert server.connections.connected_count("default") == 1
        finally:
            client.close()

    def test_rule_reload_during_flight_uses_live_slots(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=5.0, mode=G)])
        real_lock = svc._lock

        class ReloadOnEnter:
            fired = False

            def __enter__(self):
                if not ReloadOnEnter.fired:
                    ReloadOnEnter.fired = True
                    svc._lock = real_lock
                    svc.load_rules([
                        ClusterFlowRule(flow_id=2, count=7.0, mode=G),
                        ClusterFlowRule(flow_id=1, count=5.0, mode=G)])
                return real_lock.__enter__()

            def __exit__(self, *exc):
                return real_lock.__exit__(*exc)

        svc._lock = ReloadOnEnter()
        status, _, _ = svc.request_batch_arrays(np.full(10, 2, np.int64))
        assert ReloadOnEnter.fired
        assert int((status == int(TokenStatus.OK)).sum()) == 7
        assert int((status == int(TokenStatus.BLOCKED)).sum()) == 3

    def test_sweep_closes_transport_and_client_recovers(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=5.0, mode=G)])
        server = TokenServer(svc, port=0)
        server.start()
        client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
        try:
            assert client.ping()
            assert server.connections.connected_count("default") == 1
            manual_clock.advance(700_000)
            assert len(server.connections.sweep_idle(ttl_ms=600_000)) == 1
            assert server.connections.connected_count("default") == 0
            _wait(lambda: client._sock is None, "the client saw no EOF")
            client._last_connect_attempt = 0.0  # skip the backoff
            assert client.request_token(1).status is not TokenStatus.FAIL
            _wait(lambda: server.connections.connected_count("default") == 1,
                  "the reconnect's PING never re-registered")
        finally:
            client.close()
            server.stop()

    def test_wedged_client_threshold_deflates(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=3, count=4.0,
                                        mode=ThresholdMode.AVG_LOCAL)])
        cm = ConnectionManager(on_count_changed=svc.connected_count_changed)
        cm.add("default", "a:1")
        cm.add("default", "b:1")
        assert sum(svc.request_token(3).ok for _ in range(10)) == 8
        manual_clock.advance(700_000)
        cm.sweep_idle(ttl_ms=600_000)
        manual_clock.advance(2_000)
        assert sum(svc.request_token(3).ok for _ in range(10)) == 4


class TestProfilingHook:
    def test_profile_dir_produces_trace(self, tmp_path):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=100.0, mode=G)])
        server = TokenServer(svc, port=0, profile_dir=str(tmp_path))
        server.start()
        try:
            client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
            assert client.request_token(1).ok
            client.close()
        finally:
            server.stop()
        assert any(p.is_file() for p in tmp_path.rglob("*"))


class TestPipelinedDispatch:
    def test_dispatch_then_materialize_matches_request(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=100.0, mode=G)])
        status, remaining, wait = svc.dispatch_batch_arrays(
            np.array([1, 1, 404], np.int64))()
        assert status.tolist() == [int(TokenStatus.OK)] * 2 + [
            int(TokenStatus.NO_RULE_EXISTS)]
        assert len(remaining) == len(wait) == 3

    def test_two_inflight_dispatches_share_budget(self, manual_clock):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=10.0, mode=G)])
        ids = np.full(8, 1, np.int64)
        m1 = svc.dispatch_batch_arrays(ids)
        m2 = svc.dispatch_batch_arrays(ids)
        s1, s2 = m1()[0], m2()[0]
        assert int((s1 == 0).sum()) + int((s2 == 0).sum()) == 10

    def test_chunked_burst_dispatches_all_before_materializing(
        self, manual_clock
    ):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=1000.0, mode=G)])
        status = svc.dispatch_batch_arrays(np.full(150, 1, np.int64))()[0]
        assert len(status) == 150
        assert int((status == int(TokenStatus.OK)).sum()) == 150

    def test_server_max_inflight_serves_concurrent_frames(self):
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=1, count=1e6, mode=G)])
        server = TokenServer(svc, port=0, max_inflight=3)
        server.start()
        try:
            assert server.tuning_kwargs()["max_inflight"] == 3
            clients = [TokenClient("127.0.0.1", server.port, timeout_ms=10_000)
                       for _ in range(3)]
            results = []

            def pump(c):
                ids = np.full(32, 1, np.int64)
                for _ in range(20):
                    out = c.request_batch_arrays(ids)
                    results.append(out is not None and len(out[0]) == 32)

            threads = [threading.Thread(target=pump, args=(c,))
                       for c in clients]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for c in clients:
                c.close()
            assert all(results) and len(results) == 60
        finally:
            server.stop()

    def test_budget_not_double_spent_across_inflight_steps(self, manual_clock):
        budget = 50
        svc = _service()
        svc.load_rules([ClusterFlowRule(flow_id=7, count=float(budget),
                                        mode=G)])
        server = TokenServer(svc, port=0, max_inflight=3)
        server.start()
        try:
            oks, errors = [], []

            def pump():
                c = TokenClient("127.0.0.1", server.port, timeout_ms=10_000)
                ids = np.full(16, 7, np.int64)
                n_ok = 0
                try:
                    for _ in range(10):
                        out = c.request_batch_arrays(ids)
                        if out is None:
                            errors.append("a pull got no answer")
                            return
                        n_ok += int((out[0] == int(TokenStatus.OK)).sum())
                    oks.append(n_ok)
                finally:
                    c.close()

            threads = [threading.Thread(target=pump) for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors, errors
            assert sum(oks) == budget
        finally:
            server.stop()


# -- refusals, signature, hierarchy routing ----------------------------------
def test_metrics_port_is_refused():
    """No longer refused: ``metrics_port=0`` binds the exporter at start
    and the scrape answers with the exposition."""
    import urllib.request

    server = TokenServer(_service(), port=0, metrics_port=0)
    server.start()
    try:
        assert server.metrics_port
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.metrics_port}/metrics", timeout=5
        ) as rsp:
            body = rsp.read().decode()
        assert "sentinel_build_info{" in body and body.endswith("\n")
    finally:
        server.stop()


def test_door_signature_is_the_reference():
    ref = inspect.signature(JTokenServer.__init__).parameters
    got = inspect.signature(TokenServer.__init__).parameters
    assert list(got) == list(ref)
    for name, p in ref.items():
        assert got[name].default == p.default, name
        assert got[name].kind == p.kind, name


def _hier_exchange(port):
    conn = DK.RawConn(P, port)
    try:
        conn.ping(1)
        conn.send(P.encode_lease_request(9, P.MsgType.SHARE_GRANT, 1, 4))
        grant = P.decode_lease_response(conn.recv())
        conn.send(P.encode_demand_report(10, "pod-a", [(1, grant.lease_id,
                                                         1500)]))
        report = P.decode_lease_response(conn.recv())
        conn.send(P.encode_lease_request(11, P.MsgType.SHARE_RENEW, 1, 3,
                                         lease_id=grant.lease_id))
        renew = P.decode_lease_response(conn.recv())
        conn.send(P.encode_lease_request(12, P.MsgType.SHARE_RETURN, 1, 0,
                                         lease_id=renew.lease_id))
        ret = P.decode_lease_response(conn.recv())
        return grant, report, renew, ret
    finally:
        conn.close()


@pytest.mark.parametrize("door", ["asyncio", "native"])
def test_hierarchy_frames_reach_the_coordinator(door, manual_clock):
    """A share grant, a demand report, a renew and a return through the
    door land in the service's coordinator; a door whose service has none
    answers NOT_LEASABLE."""
    if door == "native" and not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    Door = TokenServer if door == "asyncio" else NativeTokenServer
    svc = _service()
    svc.load_rules([ClusterFlowRule(flow_id=1, count=5.0, mode=G)])
    server = Door(svc, port=0, idle_ttl_s=None)
    server.start()
    try:
        grant, *_ = _hier_exchange(server.port)
        assert (grant.xid, grant.status) == (9, P.NOT_LEASABLE_STATUS)
        coord = GlobalBudgetCoordinator([GlobalFlowBudget(1, 5.0)])
        svc.attach_hierarchy(coord)
        grant, report, renew, ret = _hier_exchange(server.port)
    finally:
        server.stop()
    assert (grant.xid, grant.status, grant.tokens) == (9, 0, 4)
    assert grant.ttl_ms == coord.share_ttl_ms and grant.lease_id > 0
    assert (report.xid, report.status, report.tokens) == (10, 0, 1)
    assert (renew.xid, renew.status, renew.tokens) == (11, 0, 3)
    assert renew.lease_id != grant.lease_id
    assert (ret.xid, ret.status) == (12, 0)
    stats = coord.stats()
    assert (stats["share_grants"], stats["share_renews"],
            stats["share_returns"], stats["demand_reports"]) == (1, 1, 1, 1)
    assert coord.outstanding_shares() == 0
