"""The port's token clients (``sentinel_tpu_torch.cluster.client.
TokenClient`` and ``cluster.shm_client.ShmTokenClient``) against the port's
doors and, across packages, against the JAX package's.

- The client cases of the reference's ``tests/test_lease.py``
  (``TestClientLease``) on the port's client against both port doors. The
  reference's ``test_local_admission_amortizes_rpcs`` is sensitive to load
  (ROADMAP §C: the renew-ahead thread takes the lease out of the cache
  before its RPC, so a request in that window goes to the wire); the port's
  copy holds the renew thread on an event until the requests are done, so
  the ratio it asserts is what the code guarantees.
- The client cases of the reference's ``tests/test_push.py``
  (``TestPushE2E``): a rule reload revokes a leased client's slice, a
  brownout transition reaches ``on_brownout``, a shard-map push reaches
  ``on_shard_map`` (the routing client is ROADMAP item 12), a push-dark door
  sends nothing; and a breaker flip parks the flow behind the client's local
  DEGRADED clock.
- Across packages, in lockstep on both packages' manual clocks: the port's
  client against a JAX door and the JAX client against a port door, every
  answer equal (``torch_hier_check.client_lockstep``).
- The port's ``ShmTokenClient`` against the port's native door (the client
  cases of the reference's ``tests/test_shm_door.py``): every answer equal
  to a TCP client's on a second door, segments reclaimed on close and after a
  client's SIGKILL, backpressure on a full ring.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster.client import TokenClient as JTokenClient  # noqa: E402
from sentinel_tpu.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule as JConcRule,
)
from sentinel_tpu.cluster.server import TokenServer as JTokenServer  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
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
import torch_hier_check as HC  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from torch_ha_check import manual_clocks  # noqa: E402
from torch_kernel_check import ZipfIds  # noqa: E402
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu_torch.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule,
)
from sentinel_tpu_torch.cluster.rebalance import (  # noqa: E402
    ShardMap,
    decode_shard_map_doc,
    encode_shard_map_doc,
)
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
)
from sentinel_tpu_torch.cluster.shm_client import ShmTokenClient  # noqa: E402
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
from sentinel_tpu_torch.native.lib import ShmRingClient  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = ThresholdMode.GLOBAL
CFG = EngineConfig(max_flows=16, max_namespaces=4, batch_size=64)
FLOW = 11
DOORS = ("asyncio", "native")


@pytest.fixture(autouse=True)
def clean_metrics():
    t_reset_metrics()
    j_reset_metrics()
    yield
    t_reset_metrics()
    j_reset_metrics()


def _needs_cxx(door):
    if door == "native" and not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")


def _door(door, svc, **kw):
    _needs_cxx(door)
    Door = TokenServer if door == "asyncio" else NativeTokenServer
    server = Door(svc, port=0, idle_ttl_s=None, **kw)
    server.start()
    return server


def _wait(predicate, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# -- TestClientLease ----------------------------------------------------------
@pytest.fixture(params=DOORS)
def served(request):
    # the system clock: the client's lease cache runs on time.monotonic; the
    # TTL is far beyond the test, so only explicit paths end a lease
    svc = DefaultTokenService(CFG, device="cpu", lease_ttl_ms=60_000)
    svc.load_rules([ClusterFlowRule(1, 1e9, G)])
    server = _door(request.param, svc)
    yield svc, server
    server.stop()
    svc.close()


class _HeldRenews:
    """Holds a client's renew-ahead threads until :meth:`release`: the
    renew retires the cached lease before its RPC, so a request that runs
    while it is in flight goes to the wire (ROADMAP §C)."""

    def __init__(self, client):
        self.go = threading.Event()
        self.threads = []
        renew = client._renew_flow

        def held(flow_id):
            self.go.wait(30)
            renew(flow_id)

        def spawn(flow_id):
            t = threading.Thread(target=held, args=(flow_id,), daemon=True)
            self.threads.append(t)
            t.start()

        client._spawn_renew = spawn

    def release(self):
        self.go.set()
        for t in self.threads:
            t.join(30)


class TestClientLease:
    def test_local_admission_amortizes_rpcs(self, served):
        svc, server = served
        c = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                        lease=True, lease_want=64)
        held = _HeldRenews(c)
        try:
            for _ in range(40):
                assert c.request_token(1).ok
            s = c.lease_stats()
            # one synchronous grant; the renew-ahead kicked at half the
            # slice and is held; everything else never touched the wire
            assert s["granted"] == 1 and s["renewed"] == 0
            assert s["local_admits"] == 40
            assert s["wire_rows"] == 0
            assert s["rpcs"] == 2  # the handshake and the grant
            assert len(held.threads) == 1
            held.release()
            s = c.lease_stats()
            assert s["renewed"] == 1 and s["rpcs"] == 3 and s["cached"] == 1
            assert svc.lease_stats()["renewed"] == 1
        finally:
            held.release()
            c.close()

    @pytest.mark.parametrize("door", DOORS)
    def test_refusal_falls_back_to_wire_decisions(self, door):
        svc = DefaultTokenService(CFG, device="cpu", lease_fraction=0.0)
        svc.load_rules([ClusterFlowRule(1, 1e9, G)])
        server = _door(door, svc)
        c = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                        lease=True, lease_want=64)
        try:
            for _ in range(10):
                assert c.request_token(1).ok
            s = c.lease_stats()
            assert s["refused"] >= 1
            assert s["local_admits"] == 0
            assert s["wire_rows"] == 10
        finally:
            c.close()
            server.stop()
            svc.close()

    def test_close_returns_the_unused_slice(self, served):
        svc, server = served
        c = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                        lease=True, lease_want=64)
        for _ in range(5):
            assert c.request_token(1).ok
        c.close()
        assert c.lease_stats()["returned"] == 1
        s = svc.lease_stats()
        assert s["outstanding"] == 0 and s["outstanding_tokens"] == 0
        assert s["returned"] == 1

    def test_batch_admits_locally_and_rolls_back_on_failure(self, served):
        """``request_batch_arrays`` with a lease: a flow whose slice covers
        its whole in-batch demand admits locally; a wire leg that fails
        gives the local rows back."""
        svc, server = served
        svc.load_rules([ClusterFlowRule(1, 1e9, G),
                        ClusterFlowRule(2, 1e9, G)])
        c = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                        lease=True, lease_want=64)
        held = _HeldRenews(c)
        try:
            assert c.request_token(1).ok  # the grant
            st, rem, _ = c.request_batch_arrays(np.asarray([1, 1, 2, 1]))
            assert st.tolist() == [0, 0, 0, 0]
            assert rem[[0, 1, 3]].tolist() == [60, 60, 60]
            s = c.lease_stats()
            assert s["local_admits"] == 4 and s["wire_rows"] == 1
            c._wire_batch_arrays = lambda *a, **k: None
            assert c.request_batch_arrays(np.asarray([1, 2])) is None
            assert c.lease_stats()["local_admits"] == 4
            assert c._leases[1].used == 4
        finally:
            held.release()
            c.close()


# -- TestPushE2E --------------------------------------------------------------
@pytest.fixture(params=DOORS)
def push_server(request):
    svc = DefaultTokenService(CFG, device="cpu")
    svc.load_rules([ClusterFlowRule(FLOW, 1e9, G)])
    server = _door(request.param, svc)
    yield server
    server.stop()


class TestPushE2E:
    def test_rule_reload_revokes_leased_client_within_poll_budget(
        self, push_server
    ):
        c = TokenClient("127.0.0.1", push_server.port, timeout_ms=5000,
                        lease=True, lease_want=64)
        try:
            assert c.request_token(FLOW).ok
            _wait(lambda: c.lease_stats()["granted"] >= 1,
                  "lease never granted")
            push_server.service.load_rules([ClusterFlowRule(FLOW, 1e9, G)])
            _wait(lambda: c.push_stats()["rule_epoch_invalidate"] >= 1,
                  "epoch invalidate never arrived")
            _wait(lambda: not c._leases, "pushed revoke never dropped lease")
            assert c.request_token(FLOW).ok
        finally:
            c.close()

    def test_brownout_transition_reaches_on_brownout(self, push_server):
        c = TokenClient("127.0.0.1", push_server.port, timeout_ms=5000)
        got = []
        c.on_brownout = lambda level, retry: got.append((level, retry))
        try:
            assert c.ping()
            push_server.overload.on_level_change(2, 250)
            _wait(lambda: got, "brownout advisory never arrived")
            assert got[0] == (2, 250)
        finally:
            c.close()

    def test_shard_map_push_reaches_on_shard_map(self, push_server):
        c = TokenClient("127.0.0.1", push_server.port, timeout_ms=5000)
        docs = []
        c.on_shard_map = docs.append
        try:
            assert c.ping()
            pushed = ShardMap(epoch=7, endpoint_of={"default": "h:1"},
                              global_flows={str(FLOW): "10.9.9.9:7000"})
            push_server.push_hub.push_shard_map(encode_shard_map_doc(pushed))
            _wait(lambda: docs, "pushed shard map never arrived")
            got = decode_shard_map_doc(docs[0])
            assert got.epoch == 7
            assert got.coordinator_of(FLOW) == "10.9.9.9:7000"
            assert c.push_stats()["shard_map_push"] == 1
        finally:
            c.close()

    @pytest.mark.parametrize("door", DOORS)
    def test_push_dark_server_sends_nothing(self, door):
        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules([ClusterFlowRule(FLOW, 1e9, G)])
        server = _door(door, svc, push=False)
        c = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                        lease=True, lease_want=64)
        try:
            assert c.request_token(FLOW).ok
            _wait(lambda: c.lease_stats()["granted"] >= 1,
                  "lease never granted")
            svc.load_rules([ClusterFlowRule(FLOW, 1e9, G)])
            time.sleep(0.3)
            assert c.push_stats()["rule_epoch_invalidate"] == 0
            assert server.push_hub.stats()["sent"] == {}
        finally:
            c.close()
            server.stop()

    def test_breaker_flip_parks_the_flow_locally(self, push_server):
        """A BREAKER_FLIP push to OPEN makes the client answer DEGRADED
        with the pushed retry-after, without a frame; a flip back lifts
        it."""
        c = TokenClient("127.0.0.1", push_server.port, timeout_ms=5000)
        try:
            assert c.ping()
            rpcs = c.lease_stats()["rpcs"]
            push_server.push_hub.push_breaker_flip(FLOW, 1, 5000)
            _wait(lambda: c.push_stats()["breaker_clocks"] == 1,
                  "breaker flip never arrived")
            r = c.request_token(FLOW)
            assert r.status == TokenStatus.DEGRADED
            assert 0 < r.remaining <= 5000
            assert c.lease_stats()["rpcs"] == rpcs  # answered locally
            push_server.push_hub.push_breaker_flip(FLOW, 0, 0)
            _wait(lambda: c.push_stats()["breaker_clocks"] == 0,
                  "the closing flip never arrived")
            assert c.request_token(FLOW).ok
        finally:
            c.close()


# -- across packages ----------------------------------------------------------
X_KW = dict(max_flows=64, max_namespaces=4, batch_size=64)
X_FLOWS = 40
X_PARAM_FLOWS = (100, 101)
X_LEASE_FLOWS = (33, 37)
X_CONC_FLOWS = (200, 201)


def _x_load(svc, Rule, Degrade, DS, TM, ParamRule, ConcRule):
    svc.load_degrade_rules([Degrade(
        flow_id=f, strategy=DS(1), threshold=0.5, slow_rt_ms=100,
        min_request_amount=5, stat_interval_ms=1000,
        recovery_timeout_ms=1000) for f in range(0, X_FLOWS, 10)])
    svc.load_rules([Rule(flow_id=f, count=10.0 + f % 20, mode=TM.GLOBAL,
                         namespace="default" if f % 3 else "ns1")
                    for f in range(X_FLOWS)], ns_max_qps=1e9)
    svc.load_param_rules([ParamRule(f, 4.0) for f in X_PARAM_FLOWS])
    svc.load_concurrent_rules([ConcRule(f, 2, resource_timeout_ms=600_000)
                               for f in X_CONC_FLOWS])


def test_clients_across_packages():
    """The port's client on a JAX door and the JAX client on a port door
    (both asyncio, push off so that every answer is a wire answer), the same
    seeded steps in lockstep: every answer equal."""
    with manual_clocks() as (jc, tc):
        jsvc = JService(JConfig(decide_impl="xla", **X_KW),
                        param_config=JParamConfig(max_param_rules=4,
                                                  width=64),
                        serve_buckets=(64,), fuse_depths=())
        tsvc = DefaultTokenService(EngineConfig(**X_KW), device="cpu",
                                   param_config=ParamConfig(
                                       max_param_rules=4, width=64),
                                   serve_buckets=(64,), fuse_depths=())
        _x_load(jsvc, JRule, JDegrade, JDS, JTM, JParamRule, JConcRule)
        _x_load(tsvc, ClusterFlowRule, DegradeRule, DegradeStrategy,
                ThresholdMode, ClusterParamFlowRule, ConcurrentFlowRule)
        jdoor = JTokenServer(jsvc, port=0, idle_ttl_s=None, push=False)
        tdoor = TokenServer(tsvc, port=0, idle_ttl_s=None, push=False)
        jdoor.start()
        tdoor.start()
        clients = [TokenClient("127.0.0.1", jdoor.port, timeout_ms=30_000),
                   JTokenClient("127.0.0.1", tdoor.port, timeout_ms=30_000)]
        try:
            steps = DK.lockstep_plan(
                np.random.default_rng(13), ZipfIds(X_FLOWS),
                np.arange(X_FLOWS), (16, 64), X_PARAM_FLOWS, X_LEASE_FLOWS,
                X_CONC_FLOWS, 3, P.MAX_BATCH_PER_FRAME, (5, 130, 45, 230),
                report_rows=64)

            def advance(ms):
                jc.advance(ms)
                tc.advance(ms)

            out = HC.client_lockstep(P, clients, steps, advance)
        finally:
            for c in clients:
                c.close()
            jdoor.stop()
            tdoor.stop()
        assert out["fails"] == 0
        assert out["device_steps"] == 15 and out["param_frames"] == 9
        assert {0, 1} <= set(out["statuses"])
        assert jsvc.outcome_stats() == tsvc.outcome_stats()
        assert jsvc.lease_stats() == tsvc.lease_stats()
        assert jsvc.breaker_stats() == tsvc.breaker_stats()


# -- the shared-memory client -------------------------------------------------
@pytest.fixture
def shm_pair(tmp_path):
    """A native door with an shm ring and a second one on TCP, over equal
    services, and the port's clock installed."""
    _needs_cxx("native")
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    svcs = []
    for _ in range(2):
        s = DefaultTokenService(EngineConfig(**X_KW), device="cpu",
                                param_config=ParamConfig(max_param_rules=4,
                                                         width=64))
        _x_load(s, ClusterFlowRule, DegradeRule, DegradeStrategy,
                ThresholdMode, ClusterParamFlowRule, ConcurrentFlowRule)
        svcs.append(s)
    shm_dir = str(tmp_path / "shm")
    os.makedirs(shm_dir)
    shm_door = NativeTokenServer(svcs[0], port=0, idle_ttl_s=None,
                                 shm_dir=shm_dir, push=False)
    tcp_door = NativeTokenServer(svcs[1], port=0, idle_ttl_s=None,
                                 push=False)
    shm_door.start()
    tcp_door.start()
    try:
        yield mc, shm_door, tcp_door, shm_dir
    finally:
        shm_door.stop()
        tcp_door.stop()
        t_clock.set_clock(prev)


def test_shm_client_answers_equal_a_tcp_client(shm_pair):
    mc, shm_door, tcp_door, shm_dir = shm_pair
    clients = [ShmTokenClient(shm_dir, timeout_ms=30_000),
               TokenClient("127.0.0.1", tcp_door.port, timeout_ms=30_000)]
    try:
        steps = DK.lockstep_plan(
            np.random.default_rng(17), ZipfIds(X_FLOWS), np.arange(X_FLOWS),
            (16, 64), X_PARAM_FLOWS, X_LEASE_FLOWS, X_CONC_FLOWS, 3,
            P.MAX_BATCH_PER_FRAME, (5, 130, 45, 230), report_rows=64)
        out = HC.client_lockstep(P, clients, steps, mc.advance)
        assert out["fails"] == 0 and out["device_steps"] == 15
        assert shm_door.service.outcome_stats() == \
            tcp_door.service.outcome_stats()
        assert shm_door.stats()["shm_segments"] == 1
    finally:
        for c in clients:
            c.close()
    _wait(lambda: shm_door.stats()["shm_segments"] == 0,
          "closed client's segment never reclaimed")
    assert [f for f in os.listdir(shm_dir) if f.endswith(".ring")] == []


def test_shm_ring_full_is_backpressure_not_death(shm_pair):
    """A burst the client does not drain: every published request is
    answered or counted ``ring_full``, the segment survives, and the
    client serves again."""
    mc, shm_door, _, shm_dir = shm_pair
    full_before = int(shm_door.stats().get("shm_ring_full", 0))
    ring = ShmRingClient(shm_dir, n_slots=8)
    try:
        frame = P.encode_batch_request(
            7, np.full(1, 1, np.int64), np.full(1, 1, np.int32),
            np.zeros(1, np.uint8))
        sent = sum(bool(ring.send_frame(frame, timeout_ms=200))
                   for _ in range(32))
        assert sent >= 8
        got = 0
        while ring.recv_payload(timeout_ms=500) is not None:
            got += 1
        dropped = int(shm_door.stats().get("shm_ring_full", 0)) - full_before
        assert got + dropped == sent
    finally:
        ring.close()
    c = ShmTokenClient(shm_dir, timeout_ms=10_000)
    try:
        assert c.ping()
        assert c.request_batch_arrays(np.full(3, 1, np.int64)) is not None
    finally:
        c.close()


_SHM_CHILD = r"""
import os, signal, sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster.shm_client import ShmTokenClient
c = ShmTokenClient(sys.argv[1], timeout_ms=10_000)
assert c.request_batch_arrays(np.full(3, 1, np.int64)) is not None
sys.stdout.write("READY\n")
sys.stdout.flush()
os.kill(os.getpid(), signal.SIGSTOP)  # parked until the parent kills it
"""


def test_shm_client_killed_its_segment_is_reclaimed(shm_pair, tmp_path):
    mc, shm_door, _, shm_dir = shm_pair
    env = {**os.environ, "CSP_SENTINEL_LOG_DIR": str(tmp_path)}
    proc = subprocess.Popen(
        [sys.executable, "-I", "-c", _SHM_CHILD.format(repo=REPO), shm_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    try:
        line = proc.stdout.readline()
        assert line.strip() == "READY", proc.stderr.read()
        assert shm_door.stats()["shm_segments"] >= 1
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    _wait(lambda: shm_door.stats()["shm_segments"] == 0,
          "the killed client's segment was never reclaimed")
    c = ShmTokenClient(shm_dir, timeout_ms=10_000)
    try:
        st = c.request_batch_arrays(np.full(3, 1, np.int64))[0]
        assert (st == int(TokenStatus.OK)).all()
    finally:
        c.close()
