"""The port's native front door (``sentinel_tpu_torch.cluster.server_native``)
serving a CPU ``DefaultTokenService``, against the JAX package's door.

- Lockstep parity: one seeded frame sequence (``torch_door_check``: Zipf
  BATCH_FLOW pulls, one larger than a frame, FLOW, PARAM_FLOW, OUTCOME_REPORT
  with a PING barrier, leases, CONCURRENT acquire / release, over breakers)
  through the JAX ``NativeTokenServer`` and the port's, each over its own
  package's ``ManualClock``: the reply bytes must be equal, and so must
  ``outcome_stats`` / ``breaker_stats`` / ``lease_stats`` afterwards.
- The behaviours of ``tests/test_native_server.py`` on the port's door,
  driven by the reference's ``TokenClient``; the xid probe; push frames on a
  rule reload and a breaker trip; ``namespace_index`` against the
  reference's; the shared-memory door.
- The refusals: ``snapshot_dir`` / ``standby_of`` / ``replicate_to`` /
  ``metrics_port`` raise, MOVE and REPL frames close their connection, a
  hierarchy frame gets NOT_LEASABLE, a failed native build raises.

Door tests skip only when no C++ compiler is on ``PATH``.
"""

import os
import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster import protocol as JP  # noqa: E402
from sentinel_tpu.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule as JConcRule,
)
from sentinel_tpu.cluster.server_native import (  # noqa: E402
    NativeTokenServer as JNativeTokenServer,
)
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
from torch_kernel_check import ZipfIds  # noqa: E402
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule,
)
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
    native_available,
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
from sentinel_tpu_torch.metrics.ha import ha_metrics  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
    server_metrics,
)

G = ThresholdMode.GLOBAL
CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=256)
START_MS = 1_700_000_000_000

# the lockstep configuration: flows with every control behaviour, breakers
# on every 10th flow, four param rules, three lease flows, three
# concurrency rules
LS_FLOWS = 200
LS_KW = dict(max_flows=256, max_namespaces=4, batch_size=256)
LS_PARAM_KW = dict(max_param_rules=16, width=128)
LS_PARAM_FLOWS = (1000, 1001, 1002, 1003)
LS_LEASE_FLOWS = (151, 173, 193)  # cold, plain, no breaker: leasable
LS_CONC_FLOWS = (2000, 2001, 2002)
# 64, a frame of 1024 (the fused depth-4 path at batch 256), and a pull
# larger than a frame (5040 + 960 rows)
LS_PULLS = (64, 1024, 6000)
LS_ROUNDS = 3
LS_ADVANCES_MS = (5, 130, 45, 230)


@pytest.fixture(scope="module")
def cxx():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    assert native_available()


@pytest.fixture(autouse=True)
def clean_metrics():
    t_reset_metrics()
    j_reset_metrics()
    yield
    t_reset_metrics()
    j_reset_metrics()


def _service(**kw):
    svc = DefaultTokenService(CFG, device="cpu", **kw)
    svc.load_rules([
        ClusterFlowRule(flow_id=1, count=5.0, mode=G),
        ClusterFlowRule(flow_id=2, count=1e9, mode=G),
    ])
    return svc


@pytest.fixture()
def port_server(cxx):
    svc = _service()
    server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
    server.start()
    yield server, svc
    server.stop()


def _wait(predicate, what, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# -- lockstep parity with the JAX door ---------------------------------------
def _ls_rule_fields(fid):
    beh = 1 if fid % 17 == 0 else 2 if fid % 13 == 0 else \
        3 if fid % 19 == 0 else 0
    return dict(flow_id=fid, count=20.0 + fid % 30, namespace=(
        "default" if fid % 3 else "ns1"), control_behavior=beh)


def _ls_degrade_fields(fid):
    s = (fid // 10) % 3
    return dict(flow_id=fid, threshold=20.0 if s == 2 else 0.5,
                slow_rt_ms=100, min_request_amount=5, stat_interval_ms=1000,
                recovery_timeout_ms=1000), s


def _ls_load(svc, Rule, Degrade, DS, TM, ParamRule, ConcRule):
    degrade = []
    for fid in range(0, LS_FLOWS, 10):
        fields, s = _ls_degrade_fields(fid)
        degrade.append(Degrade(strategy=DS(s), **fields))
    svc.load_degrade_rules(degrade)
    svc.load_rules([Rule(mode=TM.GLOBAL, **_ls_rule_fields(f))
                    for f in range(LS_FLOWS)], ns_max_qps=1e9)
    svc.load_param_rules([ParamRule(f, 5.0 + f % 3) for f in LS_PARAM_FLOWS])
    svc.load_concurrent_rules([ConcRule(f, 2, resource_timeout_ms=600_000)
                               for f in LS_CONC_FLOWS])


def _ls_steps():
    return DK.lockstep_plan(
        np.random.default_rng(5), ZipfIds(LS_FLOWS), np.arange(LS_FLOWS),
        LS_PULLS, LS_PARAM_FLOWS, LS_LEASE_FLOWS, LS_CONC_FLOWS, LS_ROUNDS,
        P.MAX_BATCH_PER_FRAME, LS_ADVANCES_MS)


def _ls_run(server, mc):
    conn = DK.RawConn(P, server.port)
    try:
        conn.ping(1)
        return DK.run_lockstep(P, conn, _ls_steps(), mc.advance)
    finally:
        conn.close()


def _stats(svc):
    return svc.outcome_stats(), svc.breaker_stats(), svc.lease_stats()


@pytest.fixture(scope="module")
def reference_lockstep(cxx):
    """The JAX door's replies and stats for the lockstep sequence."""
    mc = j_clock.ManualClock(START_MS)
    prev = j_clock.set_clock(mc)
    try:
        svc = JService(JConfig(**LS_KW),
                       param_config=JParamConfig(**LS_PARAM_KW))
        _ls_load(svc, JRule, JDegrade, JDS, JTM, JParamRule, JConcRule)
        server = JNativeTokenServer(svc, port=0, idle_ttl_s=None)
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
        server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
        server.start()
        try:
            replies, counts = _ls_run(server, mc)
        finally:
            server.stop()
        stats = _stats(svc)
    finally:
        t_clock.set_clock(prev)
    assert counts == ref_counts
    assert counts["device_steps"] == 3 * (4 + 3) and counts["param_frames"] == 9
    assert len(replies) == len(ref_replies)
    for i, (a, b) in enumerate(zip(replies, ref_replies)):
        assert a == b, f"reply {i} differs"
    for name, a, b in zip(("outcome_stats", "breaker_stats", "lease_stats"),
                          stats, ref_stats):
        assert a == b, name
    # the sequence reached every plane it is meant to hold
    outcome, breakers, leases = stats
    assert outcome["reported"] > 0 and sum(outcome["dropped"].values()) > 0
    assert breakers["rules"] == LS_FLOWS // 10
    assert leases["granted"] > 0 and leases["renewed"] > 0
    statuses = np.concatenate([
        JP.decode_batch_response(r)[1] for r in replies
        if JP.peek_type(r) == JP.MsgType.BATCH_FLOW])
    for st in (TokenStatus.OK, TokenStatus.BLOCKED, TokenStatus.DEGRADED):
        assert (statuses == int(st)).any(), st


# -- the behaviours of the reference's door tests ----------------------------
def test_ping_batch_single_roundtrip(port_server):
    server, svc = port_server
    client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
    try:
        assert client.ping()
        assert server.connections.connected_count("default") == 1
        out = client.request_batch_arrays(np.full(20, 1, np.int64))
        assert out is not None
        assert int((out[0] == int(TokenStatus.OK)).sum()) == 5
        assert int((out[0] == int(TokenStatus.BLOCKED)).sum()) == 15
        assert all(client.request_token(2).ok for _ in range(5))
        assert (int(client.request_token(999).status)
                == int(TokenStatus.NO_RULE_EXISTS))
    finally:
        client.close()


def test_multi_frame_pipelined_batch(port_server):
    # a pull larger than one frame goes out as pipelined chunk frames;
    # verdict order must match request order across the chunks
    server, svc = port_server
    client = TokenClient("127.0.0.1", server.port, timeout_ms=5000)
    try:
        n = 12_000  # > MAX_BATCH_PER_FRAME (5040)
        out = client.request_batch_arrays(np.full(n, 2, np.int64))
        assert out is not None
        assert int((out[0] == int(TokenStatus.OK)).sum()) == n
    finally:
        client.close()


def test_concurrent_clients_share_budget(port_server):
    server, svc = port_server
    results = []
    lock = threading.Lock()

    def worker():
        client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
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
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sum(r.ok for r in results) == 5
    assert len(results) == 16


def test_malformed_frame_closes_connection(port_server):
    server, svc = port_server
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=3)
    try:
        sock.sendall(b"\x00\x01\xff")  # runt frame (len 1 < header)
        sock.settimeout(3)
        assert sock.recv(64) == b""
    finally:
        sock.close()


def test_empty_batch_frame_answered_not_stranded(port_server):
    server, svc = port_server
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=3)
    try:
        payload = struct.pack(">IBH", 42, 5, 0)  # xid 42, BATCH_FLOW, n 0
        sock.sendall(struct.pack(">H", len(payload)) + payload)
        sock.settimeout(3)
        assert sock.recv(64) == struct.pack(">H", 7) + payload
        row = struct.pack(">qiB", 2, 1, 0)
        payload = struct.pack(">IBH", 43, 5, 1) + row
        sock.sendall(struct.pack(">H", len(payload)) + payload)
        rsp = sock.recv(64)
        (ln,) = struct.unpack(">H", rsp[:2])
        assert (ln,) + struct.unpack(">IBH", rsp[2:9]) == (16, 43, 5, 1)
        assert rsp[9] == int(TokenStatus.OK)
    finally:
        sock.close()


def test_close_event_deflates_connected_count(port_server):
    server, svc = port_server
    client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
    assert client.ping()
    assert server.connections.connected_count("default") == 1
    client.close()
    _wait(lambda: server.connections.connected_count("default") == 0,
          "the close event did not deflate the group")


def test_concurrent_mode_over_native_control_path(port_server):
    server, svc = port_server
    svc.load_concurrent_rules([ConcurrentFlowRule(flow_id=9,
                                                  concurrency_level=2)])
    client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
    try:
        a = client.request_concurrent_token(9)
        b = client.request_concurrent_token(9)
        c = client.request_concurrent_token(9)
        assert a.ok and b.ok and not c.ok
        r = client.release_concurrent_token(a.token_id)
        assert int(r.status) == int(TokenStatus.RELEASE_OK)
        assert client.request_concurrent_token(9).ok
    finally:
        client.close()


def test_tuning_kwargs_roundtrip(port_server):
    server, svc = port_server
    kw = server.tuning_kwargs()
    assert kw["max_batch"] == server.max_batch
    assert kw["n_dispatchers"] == server.n_dispatchers
    assert kw["push"] is True


def test_restart_clears_phantom_connections(port_server):
    server, svc = port_server
    client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
    try:
        assert client.ping()
        assert server.connections.connected_count("default") == 1
    finally:
        client.close()
    server.stop()
    assert server.connections.connected_count("default") == 0
    server.start()
    assert server.connections.connected_count("default") == 0


def test_native_idle_sweep_closes_quiet_connection(cxx):
    server = NativeTokenServer(_service(), port=0, idle_ttl_s=0.3)
    server.start()
    client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
    try:
        assert client.ping()
        assert server.connections.connected_count("default") == 1
        _wait(lambda: server.connections.connected_count("default") == 0,
              "the idle sweep did not close the connection")
    finally:
        client.close()
        server.stop()


def test_tracked_dispatch_permit_lifecycle(cxx):
    server = NativeTokenServer(_service(), port=0, idle_ttl_s=None,
                               max_device_inflight=2)
    calls = []

    def fake_dispatch(ids, counts, prios):
        calls.append(len(ids))
        return lambda: ("status", "remaining", "wait")

    args = (np.array([1], np.int64), np.array([1], np.int32),
            np.array([False], bool))
    mat1, rel1, ov1 = server._tracked_dispatch(fake_dispatch, *args)
    assert server._device_inflight == 1 and ov1 is False
    mat2, rel2, ov2 = server._tracked_dispatch(fake_dispatch, *args)
    assert server._device_inflight == 2 and ov2 is True
    assert mat1() == ("status", "remaining", "wait")
    assert server._device_inflight == 1
    rel1()  # idempotent with mat1's own release
    assert server._device_inflight == 1
    rel2()
    assert server._device_inflight == 0
    mat2()
    assert server._device_inflight == 0
    assert calls == [1, 1]

    def boom(ids, counts, prios):
        raise RuntimeError("device fell over")

    with pytest.raises(RuntimeError):
        server._tracked_dispatch(boom, *args)
    assert server._device_inflight == 0


def test_inflight_bound_blocks_second_dispatch(cxx):
    server = NativeTokenServer(_service(), port=0, idle_ttl_s=None,
                               max_device_inflight=1)
    args = (np.array([1], np.int64), np.array([1], np.int32),
            np.array([False], bool))
    _mat1, rel1, _ = server._tracked_dispatch(lambda *a: (lambda: None),
                                              *args)
    entered, done = threading.Event(), threading.Event()

    def second():
        entered.set()
        server._tracked_dispatch(lambda *a: (lambda: None), *args)[1]()
        done.set()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    assert entered.wait(2.0)
    assert not done.wait(0.4)  # held while the first group is live
    rel1()
    assert done.wait(2.0)
    t.join(timeout=2.0)
    assert server._device_inflight == 0


def test_overlap_surface_and_gauge_drain(port_server):
    server, svc = port_server
    client = TokenClient("127.0.0.1", server.port, timeout_ms=3000)
    try:
        for _ in range(30):
            client.request_batch([(2, 1, False)] * 32)
    finally:
        client.close()
    snap = server_metrics().snapshot()
    assert snap["overlapSavedMsTotal"] >= 0.0
    assert "device_inflight" in snap["gauges"]
    # the served batches reached the port's verdict counters
    ok = sum(v["count"] for v in snap["verdicts"] if v["verdict"] == "pass")
    assert ok >= 30 * 32
    text = server_metrics().render()
    assert "sentinel_server_device_inflight" in text
    server.stop()
    assert server._device_inflight == 0


# -- the xid probe, push, namespace attribution, the shm door ----------------
def test_xid_probe_every_xid_once(cxx):
    svc = DefaultTokenService(CFG, device="cpu")
    svc.load_rules([ClusterFlowRule(f, 1e9, G) for f in range(40)],
                   ns_max_qps=1e12)
    server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
    server.start()
    try:
        probe = DK.xid_probe(P, server.port, np.arange(40), frames=24,
                             rows=1024)
    finally:
        server.stop()
    assert probe["exact"], probe
    assert probe["frames_answered"] == 24


def test_push_frames_on_reload_and_breaker_trip(cxx):
    svc = DefaultTokenService(CFG, device="cpu", lease_ttl_ms=60_000)
    svc.load_degrade_rules([DegradeRule(
        7, DegradeStrategy.ERROR_COUNT, 3.0, min_request_amount=1,
        recovery_timeout_ms=2500)])
    svc.load_rules([ClusterFlowRule(f, 1e6, G) for f in (5, 6, 7)])
    server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
    server.start()
    conn = DK.RawConn(P, server.port)
    try:
        conn.ping(1)
        conn.send(P.encode_lease_request(10, P.MsgType.LEASE_GRANT, 5, 8))
        lease = P.decode_lease_response(conn.recv())
        assert lease.status == 0 and lease.lease_id > 0
        svc.load_rules([ClusterFlowRule(f, 1e6, G) for f in (6, 7)])
        # a breaker trip: errors reported on flow 7, then a pull on it
        conn.send(P.encode_batch_request(11, np.full(4, 7, np.int64)))
        conn.recv()
        conn.send(P.encode_outcome_report(
            12, np.full(8, 7, np.int64), np.full(8, 5, np.int32),
            np.ones(8, bool)))
        conn.ping(2)  # the barrier: the report has been taken
        conn.send(P.encode_batch_request(13, np.full(4, 7, np.int64)))
        _x, st, _r, _w = P.decode_batch_response(conn.recv())
        assert (st == int(TokenStatus.DEGRADED)).all()
        svc.breaker_stats()  # the scan that observes the edge
        _wait(lambda: len(conn.pushes) >= 3, "push frames")
    finally:
        conn.close()
        server.stop()
    pushes = [P.decode_push(p) for p in conn.pushes]
    kinds = [p.msg_type for p in pushes]
    revoke = pushes[kinds.index(P.MsgType.LEASE_REVOKE)]
    assert (revoke.lease_id, revoke.flow_id, revoke.tokens) == (
        lease.lease_id, 5, lease.tokens)
    epoch = pushes[kinds.index(P.MsgType.RULE_EPOCH_INVALIDATE)]
    assert epoch.epoch == svc._state_gen
    flip = pushes[kinds.index(P.MsgType.BREAKER_FLIP)]
    assert (flip.flow_id, flip.state, flip.retry_after_ms) == (7, 1, 2500)


def test_rule_epoch_counts_as_the_reference():
    """The epoch a reload announces is the reference's rule generation."""
    jsvc = JService(JConfig(max_flows=64, max_namespaces=4, batch_size=64))
    tsvc = DefaultTokenService(EngineConfig(max_flows=64, max_namespaces=4,
                                            batch_size=64), device="cpu")
    for svc, Rule, ParamRule in ((jsvc, JRule, JParamRule),
                                 (tsvc, ClusterFlowRule,
                                  ClusterParamFlowRule)):
        svc.load_rules([Rule(1, 5.0)])
        svc.load_param_rules([ParamRule(3, 5.0)])
        svc.load_rules([Rule(2, 5.0)])
    assert tsvc._state_gen == jsvc._state_gen == 3


def test_namespace_index_equals_the_reference():
    kw = dict(max_flows=64, max_namespaces=8, batch_size=64)
    jsvc = JService(JConfig(**kw))
    tsvc = DefaultTokenService(EngineConfig(**kw), device="cpu")
    fields = [dict(flow_id=f, count=5.0, namespace=f"ns{f % 5}")
              for f in range(0, 60, 2)]
    jsvc.load_rules([JRule(**d) for d in fields])
    tsvc.load_rules([ClusterFlowRule(**d) for d in fields])
    ids = np.random.default_rng(3).integers(-5, 70, 500)
    j_idx, j_names = jsvc.namespace_index(ids)
    t_idx, t_names = tsvc.namespace_index(ids)
    np.testing.assert_array_equal(t_idx, j_idx)
    assert t_idx.dtype == j_idx.dtype
    assert tuple(t_names) == tuple(j_names)


def test_shm_door_serves_a_batch(cxx, tmp_path):
    from sentinel_tpu_torch.native.lib import ShmRingClient

    server = NativeTokenServer(_service(), port=0, idle_ttl_s=None,
                               shm_dir=str(tmp_path))
    server.start()
    try:
        client = ShmRingClient(str(tmp_path))
        try:
            assert client.send_frame(
                P.encode_batch_request(77, np.full(9, 1, np.int64)),
                timeout_ms=2000)
            payload = None
            deadline = time.monotonic() + 10
            while payload is None and time.monotonic() < deadline:
                payload = client.recv_payload(timeout_ms=200)
        finally:
            client.close()
    finally:
        server.stop()
    xid, st, _rem, _wait = P.decode_batch_response(payload)
    assert xid == 77
    assert (st == int(TokenStatus.OK)).sum() == 5
    assert (st == int(TokenStatus.BLOCKED)).sum() == 4


# -- refusals ----------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(snapshot_dir="/nonexistent"),
    dict(standby_of="127.0.0.1:1"),
    dict(replicate_to=["127.0.0.1:1"]),
    dict(metrics_port=0),
])
def test_unported_features_are_refused(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NativeTokenServer(_service(), port=0, **kw)


def test_snapshot_dir_from_the_environment_is_refused(monkeypatch):
    monkeypatch.setenv("SENTINEL_SNAPSHOT_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="snapshot"):
        NativeTokenServer(_service(), port=0)


def test_move_and_repl_frames_close_their_connection(port_server):
    server, svc = port_server
    before = ha_metrics().snapshot()["rebalance"]["events"].get("refused", 0)
    for frame in (P.encode_move_ctrl(5, P.MsgType.MOVE_BEGIN, 1, "ns1",
                                     "peer"),
                  P.encode_repl_hello(6, 1, 0, 0, "primary")):
        conn = DK.RawConn(P, server.port)
        try:
            conn.ping(1)
            conn.send(frame)
            assert conn.closed_by_peer(), P.peek_type(frame[2:])
        finally:
            conn.close()
    after = ha_metrics().snapshot()["rebalance"]["events"]["refused"]
    assert after == before + 1
    # the door keeps serving
    conn = DK.RawConn(P, server.port)
    try:
        assert conn.ping(2) >= 1
    finally:
        conn.close()


def test_hierarchy_frames_get_not_leasable(port_server):
    server, svc = port_server
    assert svc.hierarchy is None
    conn = DK.RawConn(P, server.port)
    try:
        conn.ping(1)
        conn.send(P.encode_lease_request(9, P.MsgType.SHARE_GRANT, 1, 4))
        r = P.decode_lease_response(conn.recv())
        assert (r.xid, r.status) == (9, P.NOT_LEASABLE_STATUS)
        conn.send(P.encode_demand_report(10, "pod-a", [(1, 0, 1500)]))
        r = P.decode_lease_response(conn.recv())
        assert (r.xid, r.status) == (10, P.NOT_LEASABLE_STATUS)
    finally:
        conn.close()


def test_failed_native_build_raises(cxx, monkeypatch, tmp_path):
    from sentinel_tpu_torch.native import build, lib

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCES", [broken])
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(lib, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        lib.load()
    with pytest.raises(RuntimeError, match="native build failed"):
        native_available()
    with pytest.raises(RuntimeError, match="native build failed"):
        NativeTokenServer(_service(), port=0)
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert not os.path.exists(build.target())
