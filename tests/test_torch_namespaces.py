"""Namespace partitioning and the namespace-routing client of the port
(``sentinel_tpu_torch.cluster.namespaces`` / ``routing``) against the JAX
package's.

The reference's ``tests/test_namespace_partition.py`` (16 tests) on the
port's copies: the ownership map, rule partitioning, the routing client
over stub pod clients, connection groups fed by the PING handshake, two
in-process pods on the CPU, concurrent-token routing; the routing part of
``tests/test_rebalance.py`` (l.446-693: the swap race, the epoch fences on
maps and on learned moves, MOVED as the failover client's proof of life,
rebalance advisories, ``aggregate_snapshots``' error accounting);
``tests/test_hierarchy.py::TestAggregateGlobalBlock``; and
``tests/test_push.py::test_shard_map_push_rewires_routing_client`` through
both port doors.

Across packages: partitions, flow namespaces and aggregated snapshots
(with the dedup and error counters) of one seeded input are equal; the
lazy ``cluster`` exports name the same things.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster import namespaces as JNS  # noqa: E402
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine.rules import ThresholdMode as JTM  # noqa: E402

from sentinel_tpu_torch.cluster import namespaces as NS  # noqa: E402
from sentinel_tpu_torch.cluster.connection import (  # noqa: E402
    ConnectionManager,
)
from sentinel_tpu_torch.cluster.namespaces import (  # noqa: E402
    NamespaceAssignment,
    aggregate_snapshots,
    flow_namespaces,
    partition_rules,
)
from sentinel_tpu_torch.cluster.rebalance import (  # noqa: E402
    ShardMap,
    encode_shard_map_doc,
)
from sentinel_tpu_torch.cluster.routing import (  # noqa: E402
    RoutingTokenClient,
)
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
    TokenResult,
    TokenService,
)
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    EngineConfig,
)
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.rules import ThresholdMode  # noqa: E402
from sentinel_tpu_torch.metrics.ha import ha_metrics  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests,
)

CPU = "cpu"


class TestNamespaceAssignment:
    def test_assign_move_generation(self):
        a = NamespaceAssignment({"ns1": "pod0"})
        assert a.pod_of("ns1") == "pod0"
        assert a.generation == 0
        a.assign("ns2", "pod1")
        assert a.generation == 1
        a.move("ns2", "pod0")
        assert a.generation == 2
        assert a.namespaces_of("pod0") == ["ns1", "ns2"]
        a.assign("ns2", "pod0")  # no-op: same owner
        assert a.generation == 2
        a.unassign("ns1")
        assert a.pod_of("ns1") is None
        assert a.generation == 3

    def test_partition_rules_and_unassigned(self):
        a = NamespaceAssignment({"a": "pod0", "b": "pod1"})
        rules = [
            ClusterFlowRule(flow_id=1, count=1, namespace="a"),
            ClusterFlowRule(flow_id=2, count=1, namespace="b"),
            ClusterFlowRule(flow_id=3, count=1, namespace="a"),
            ClusterFlowRule(flow_id=4, count=1, namespace="orphan"),
        ]
        parts = partition_rules(rules, a)
        assert [r.flow_id for r in parts["pod0"]] == [1, 3]
        assert [r.flow_id for r in parts["pod1"]] == [2]
        # unassigned namespaces surface under None instead of vanishing
        assert [r.flow_id for r in parts[None]] == [4]
        assert flow_namespaces(rules)[4] == "orphan"


class TestConnectionManager:
    def test_groups_counts_and_callbacks(self):
        seen = []
        cm = ConnectionManager(
            on_count_changed=lambda ns, n: seen.append((ns, n)))
        assert cm.add("a", "1.1.1.1:1") == 1
        assert cm.add("a", "1.1.1.1:2") == 2
        assert cm.add("b", "1.1.1.1:1") == 1  # one conn, two namespaces
        assert cm.connected_count("a") == 2
        cm.remove_address("1.1.1.1:1")  # drops both registrations
        assert cm.connected_count("a") == 1
        assert cm.connected_count("b") == 0
        assert cm.namespaces() == ["a"]
        assert ("a", 2) in seen and ("b", 0) in seen

    def test_duplicate_add_is_idempotent(self):
        cm = ConnectionManager()
        cm.add("a", "x:1")
        assert cm.add("a", "x:1") == 1
        assert cm.snapshot() == {"a": ["x:1"]}


class _StubClient(TokenService):
    """Records which pod answered; stands in for a real TokenClient."""

    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        self.endpoint = (host, port)
        self.namespace = namespace
        self.calls = []
        self.pinged = []
        self.closed = False

    def request_token(self, flow_id, acquire=1, prioritized=False):
        self.calls.append(flow_id)
        return TokenResult(TokenStatus.OK, remaining=self.endpoint[1])

    def ping(self, namespace=None):
        self.pinged.append(namespace or self.namespace)
        return True

    def close(self):
        self.closed = True


class TestRoutingTokenClient:
    def _router(self):
        return RoutingTokenClient(
            namespace_of={1: "a", 2: "b"},
            pod_of={"a": "pod0", "b": "pod1"},
            endpoints={"pod0": ("h0", 10), "pod1": ("h1", 11)},
            client_factory=_StubClient,
        )

    def test_routes_by_namespace(self):
        r = self._router()
        assert r.request_token(1).remaining == 10  # pod0's port marker
        assert r.request_token(2).remaining == 11
        # unknown flow → NO_RULE (caller falls back locally)
        assert r.request_token(99).status == TokenStatus.NO_RULE_EXISTS

    def test_client_carries_namespace_handshake(self):
        r = self._router()
        r.request_token(1)
        client = r._clients["pod0"]
        assert client.namespace == "a"

    def test_pod_serving_multiple_namespaces_declares_each(self):
        r = RoutingTokenClient(
            namespace_of={1: "a", 2: "b"},
            pod_of={"a": "pod0", "b": "pod0"},
            endpoints={"pod0": ("h0", 10)},
            client_factory=_StubClient,
        )
        r.request_token(1)
        r.request_token(2)
        r.request_token(2)  # already declared — no extra ping
        client = r._clients["pod0"]
        assert client.namespace == "a"  # ctor namespace (auto-handshake)
        assert client.pinged == ["b"]

    def test_update_moves_namespace_and_closes_dead_pods(self):
        r = self._router()
        r.request_token(2)
        old = r._clients["pod1"]
        r.update(pod_of={"a": "pod0", "b": "pod0"},
                 endpoints={"pod0": ("h0", 10)})
        assert r.request_token(2).remaining == 10
        assert old.closed

    def test_close_closes_all(self):
        r = self._router()
        r.request_token(1)
        r.request_token(2)
        clients = list(r._clients.values())
        r.close()
        assert all(c.closed for c in clients)

    def test_pod_client_without_ping_raises(self):
        """The port probes no hook: a second namespace on a pod whose
        client cannot declare it raises instead of going unannounced."""

        class NoPing:
            def __init__(self, host, port, timeout_ms=20,
                         namespace="default"):
                pass

            def request_token(self, flow_id, acquire=1, prioritized=False):
                return TokenResult(TokenStatus.OK)

        r = RoutingTokenClient(
            namespace_of={1: "a", 2: "b"}, pod_of={"a": "p", "b": "p"},
            endpoints={"p": ("h", 1)}, client_factory=NoPing)
        assert r.request_token(1).ok
        with pytest.raises(AttributeError):
            r.request_token(2)


class TestAggregation:
    def test_sums_disjoint_and_overlapping(self):
        total = aggregate_snapshots([
            {1: {"pass_qps": 5.0}, 2: {"pass_qps": 1.0}},
            {3: {"pass_qps": 2.0}, 2: {"pass_qps": 0.5}},  # mid-move overlap
        ])
        assert total[1]["pass_qps"] == 5.0
        assert total[2]["pass_qps"] == 1.5
        assert total[3]["pass_qps"] == 2.0


class TestAggregateGlobalBlock:
    def test_mid_move_copies_dedupe_and_global_block_sums(self):
        NS.reset_move_dedup_for_tests()
        src = {42: {"pass_qps": 5.0, "leased_tokens": 30.0,
                    "moved_epoch": 3}}
        dst = {42: {"pass_qps": 2.0, "leased_tokens": 20.0}}
        out = aggregate_snapshots([src, dst], global_budgets={42: 100})
        # the source's frozen copy dropped; the marker never leaks out
        assert out[42] == {"pass_qps": 2.0, "leased_tokens": 20.0}
        g = out["global"]["42"]
        assert g == {"budget_tokens": 100.0, "leased_tokens": 20.0,
                     "occupancy": 0.2}
        assert NS.move_dedup_total() == 1

    def test_all_marked_keeps_newest_epoch_copy(self):
        NS.reset_move_dedup_for_tests()
        old = {42: {"pass_qps": 1.0, "moved_epoch": 2}}
        new = {42: {"pass_qps": 9.0, "moved_epoch": 5}}
        out = aggregate_snapshots([old, new])
        assert out[42] == {"pass_qps": 9.0}


class TestPartitionIsolationE2E:
    """Two in-process pods; namespace movement repoints routing and the new
    owner enforces with fresh windows."""

    def test_isolation_and_movement(self):
        rules = [
            ClusterFlowRule(flow_id=1, count=1e9, namespace="a",
                            mode=ThresholdMode.GLOBAL),
            ClusterFlowRule(flow_id=2, count=1e9, namespace="b",
                            mode=ThresholdMode.GLOBAL),
        ]
        assignment = NamespaceAssignment({"a": "pod0", "b": "pod1"})
        pods = {
            p: DefaultTokenService(
                EngineConfig(max_flows=8, max_namespaces=4, batch_size=8),
                device=CPU)
            for p in ("pod0", "pod1")
        }
        parts = partition_rules(rules, assignment)
        for pod_id, pod_rules in parts.items():
            pods[pod_id].load_rules(pod_rules)

        assert pods["pod0"].request_token(1).status == TokenStatus.OK
        assert pods["pod0"].request_token(2).status == \
            TokenStatus.NO_RULE_EXISTS
        assert pods["pod1"].request_token(2).status == TokenStatus.OK

        assignment.move("b", "pod0")
        parts = partition_rules(rules, assignment)
        pods["pod0"].load_rules(parts["pod0"])
        pods["pod1"].load_rules(parts.get("pod1", []))
        assert pods["pod0"].request_token(2).status == TokenStatus.OK
        assert pods["pod1"].request_token(2).status == \
            TokenStatus.NO_RULE_EXISTS
        for svc in pods.values():
            svc.close()

    def test_avg_local_scales_with_handshaked_clients(self):
        """Connection-group counts from the PING handshake scale AVG_LOCAL
        thresholds (ClusterFlowChecker.java:43-47)."""
        from sentinel_tpu_torch.cluster.client import TokenClient

        svc = DefaultTokenService(
            EngineConfig(max_flows=8, max_namespaces=4, batch_size=8),
            device=CPU)
        svc.load_rules([
            ClusterFlowRule(flow_id=5, count=2.0, namespace="grp",
                            mode=ThresholdMode.AVG_LOCAL),
        ])
        server = TokenServer(svc, host="127.0.0.1", port=0)
        server.start()
        try:
            c1 = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                             namespace="grp")
            c2 = TokenClient("127.0.0.1", server.port, timeout_ms=5000,
                             namespace="grp")
            assert c1.ping() and c2.ping()
            assert server.connections.connected_count("grp") == 2
            # threshold = 2.0/client × 2 clients = 4 global
            statuses = [c1.request_token(5).status for _ in range(6)]
            assert statuses.count(TokenStatus.OK) == 4, statuses
            assert statuses.count(TokenStatus.BLOCKED) == 2, statuses
            c1.close()
            c2.close()
        finally:
            server.stop()
            svc.close()


class _ConcurrentStubClient(_StubClient):
    """Pod-local concurrent-token semantics: ids count from 1 PER POD, so
    cross-pod collisions are real."""

    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        super().__init__(host, port, timeout_ms, namespace)
        self._next = 1
        self.held = {}

    def request_concurrent_token(self, flow_id, acquire=1,
                                 prioritized=False):
        tid = self._next
        self._next += 1
        self.held[tid] = flow_id
        return TokenResult(TokenStatus.OK, remaining=5, token_id=tid)

    def release_concurrent_token(self, token_id):
        if int(token_id) in self.held:
            del self.held[int(token_id)]
            return TokenResult(TokenStatus.RELEASE_OK)
        return TokenResult(TokenStatus.ALREADY_RELEASE)


class TestConcurrentTokenRouting:
    def _router(self):
        return RoutingTokenClient(
            namespace_of={1: "a", 2: "b"},
            pod_of={"a": "pod0", "b": "pod1"},
            endpoints={"pod0": ("h0", 10), "pod1": ("h1", 11)},
            client_factory=_ConcurrentStubClient,
        )

    def test_release_targets_issuing_pod_only(self):
        router = self._router()
        ra = router.request_concurrent_token(1)  # pod0 issues local id 1
        rb = router.request_concurrent_token(2)  # pod1 ALSO issues id 1
        assert ra.ok and rb.ok
        assert ra.token_id != rb.token_id
        pod0 = router._clients["pod0"]
        pod1 = router._clients["pod1"]
        assert pod0.held and pod1.held
        out = router.release_concurrent_token(ra.token_id)
        assert out.ok
        assert not pod0.held
        assert pod1.held == {1: 2}

    def test_release_unprefixed_id_falls_back_to_fanout(self):
        router = self._router()
        r = router.request_concurrent_token(1)
        raw_local = r.token_id & ((1 << 48) - 1)
        out = router.release_concurrent_token(raw_local)
        assert out.ok  # found via first-success fan-out

    def test_release_after_pod_removed_fails_fast(self):
        router = self._router()
        ra = router.request_concurrent_token(1)  # pod0 local id 1
        rb = router.request_concurrent_token(2)  # pod1 ALSO local id 1
        assert ra.ok and rb.ok
        pod1 = router._clients["pod1"]
        router.update(
            pod_of={"b": "pod1"},
            endpoints={"pod1": ("h1", 11)},  # pod0 removed
        )
        out = router.release_concurrent_token(ra.token_id)
        assert out.status == TokenStatus.ALREADY_RELEASE
        assert pod1.held == {1: 2}

    def test_release_result_is_release_ok(self):
        router = self._router()
        r = router.request_concurrent_token(1)
        out = router.release_concurrent_token(r.token_id)
        assert out.status == TokenStatus.RELEASE_OK


# -- the routing part of tests/test_rebalance.py -----------------------------
class _StubPodClient:
    """client_factory stand-in recording close ordering for the swap race:
    retired clients must only be closed AFTER the new routing state is
    visible to readers."""

    owner = None  # class attr: the RoutingTokenClient under test

    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        self.port = port
        self.closed = False
        self.closed_while_live = False

    def request_token(self, fid, acquire=1, prioritized=False):
        return TokenResult(TokenStatus.OK, remaining=self.port)

    def ping(self, namespace=None):
        return True

    def close(self):
        if (
            _StubPodClient.owner is not None
            and self in _StubPodClient.owner._clients.values()
        ):
            self.closed_while_live = True
        self.closed = True


def test_routing_update_closes_retired_clients_after_swap():
    rc = RoutingTokenClient(
        namespace_of={1: "ns"}, pod_of={"ns": "pod0"},
        endpoints={"pod0": ("h", 1)}, client_factory=_StubPodClient,
    )
    _StubPodClient.owner = rc
    try:
        assert rc.request_token(1).remaining == 1  # materializes pod0
        old = rc._clients["pod0"]
        rc.update(pod_of={"ns": "pod1"}, endpoints={"pod1": ("h", 2)})
        assert old.closed and not old.closed_while_live
        assert rc.request_token(1).remaining == 2
    finally:
        _StubPodClient.owner = None
        rc.close()


def test_routing_update_swap_is_atomic_under_concurrent_readers():
    """Hammer update() against readers: every request resolves and no
    retired client is ever closed while still routable."""
    rc = RoutingTokenClient(
        namespace_of={1: "ns"}, pod_of={"ns": "pod0"},
        endpoints={"pod0": ("h", 1)}, client_factory=_StubPodClient,
    )
    _StubPodClient.owner = rc
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            try:
                r = rc.request_token(1)
                assert r.remaining in (1, 2)
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for i in range(200):
            pod = "pod0" if i % 2 == 0 else "pod1"
            port = 1 if i % 2 == 0 else 2
            rc.update(pod_of={"ns": pod}, endpoints={pod: ("h", port)})
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors
    finally:
        stop.set()
        _StubPodClient.owner = None
        rc.close()


def test_routing_epoch_fence_on_maps_and_learned_moves():
    rc = RoutingTokenClient(
        namespace_of={1: "ns"}, pod_of={"ns": "old:1"},
        endpoints={"old:1": ("old", 1)}, client_factory=_StubPodClient,
    )
    try:
        assert rc.apply_shard_map(ShardMap(3, {"ns": "new:2"}))
        assert rc.epoch == 3
        # stale pushes (≤ current epoch) never roll a route back
        assert not rc.apply_shard_map(ShardMap(3, {"ns": "older:9"}))
        assert not rc.apply_shard_map(ShardMap(2, {"ns": "older:9"}))
        assert rc._state.pod_of["ns"] == "new:2"
        # MOVED-learned single routes obey the same fence
        assert not rc._learn_move("ns", "older:9", 3)
        assert rc._learn_move("ns", "newest:7", 4)
        assert rc.epoch == 4 and rc._state.pod_of["ns"] == "newest:7"
        # an unparseable endpoint in a newer map must not clobber the route
        assert rc.apply_shard_map(ShardMap(5, {"ns": "garbage"}))
        assert rc.epoch == 5 and rc._state.pod_of["ns"] == "newest:7"
    finally:
        rc.close()


class _MovedPod:
    """A pod that answers MOVED naming ``dst:1`` at epoch 9; ``dst`` answers
    OK, a third host raises."""

    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        self.host = host
        self.closed = False

    def request_token(self, fid, acquire=1, prioritized=False):
        if self.host == "src":
            return TokenResult(TokenStatus.MOVED, remaining=9,
                               endpoint="dst:1")
        if self.host == "dst":
            return TokenResult(TokenStatus.OK, remaining=42)
        raise ConnectionResetError("unreachable")

    def ping(self, namespace=None):
        return True

    def close(self):
        self.closed = True


def test_moved_answer_teaches_the_route_and_retries_once():
    rc = RoutingTokenClient(
        namespace_of={1: "ns"}, pod_of={"ns": "src:1"},
        endpoints={"src:1": ("src", 1)}, client_factory=_MovedPod,
    )
    before = ha_metrics().snapshot()["fallback"].get("moved_follow", 0)
    try:
        r = rc.request_token(1)
        assert (r.status, r.remaining) == (TokenStatus.OK, 42)
        assert rc.epoch == 9 and rc._state.pod_of["ns"] == "dst:1"
        after = ha_metrics().snapshot()["fallback"].get("moved_follow", 0)
        assert after == before + 1
        # the learned route serves directly now
        assert rc.request_token(1).remaining == 42
    finally:
        rc.close()


def test_unreachable_destination_degrades_through_the_fallback():
    from sentinel_tpu_torch.ha import (
        FallbackAction,
        FallbackRule,
        LocalFallbackPolicy,
    )

    class ToNowhere(_MovedPod):
        def request_token(self, fid, acquire=1, prioritized=False):
            if self.host == "src":
                return TokenResult(TokenStatus.MOVED, remaining=3,
                                   endpoint="gone:5")
            raise ConnectionResetError("unreachable")

    rc = RoutingTokenClient(
        namespace_of={1: "ns"}, pod_of={"ns": "src:1"},
        endpoints={"src:1": ("src", 1)}, client_factory=ToNowhere,
        fallback=LocalFallbackPolicy([FallbackRule(1,
                                                   FallbackAction.BLOCK)]),
    )
    plain = RoutingTokenClient(
        namespace_of={1: "ns"}, pod_of={"ns": "src:1"},
        endpoints={"src:1": ("src", 1)}, client_factory=ToNowhere,
    )
    try:
        assert rc.request_token(1).status == TokenStatus.BLOCKED
        # without a fallback policy the redirect is surfaced
        assert plain.request_token(1).status == TokenStatus.MOVED
    finally:
        rc.close()
        plain.close()


class _MovedOrOkClient:
    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        self.host = host

    def request_token(self, fid, acquire=1, prioritized=False):
        if self.host == "moved":
            return TokenResult(TokenStatus.MOVED, remaining=9,
                               endpoint="dst:1")
        return TokenResult(TokenStatus.OK, remaining=42)

    def close(self):
        pass

    # the port's failover client probes no hook: its members carry these
    def ping_ex(self, namespace=None):
        return True

    def on_brownout(self, level, retry_after_ms):
        pass

    def lease_stats(self):
        return {}

    def consecutive_failures(self):
        return 0


def _failover(endpoints):
    from sentinel_tpu_torch.ha.failover import FailoverTokenClient

    return FailoverTokenClient(endpoints, client_factory=_MovedOrOkClient,
                               failure_threshold=1)


def test_failover_treats_moved_as_proof_of_life():
    fc = _failover([("moved", 1), ("alive", 2)])
    before = ha_metrics().snapshot()["fallback"].get("moved_redirect", 0)
    try:
        r = fc.request_token(1)
        assert r.status == TokenStatus.OK and r.remaining == 42
        # with threshold=1 a single recorded FAILURE would evict; the MOVED
        # endpoint must still be in rotation (it recorded SUCCESS)
        assert fc._members[0].health.allows_request()
        after = ha_metrics().snapshot()["fallback"].get("moved_redirect", 0)
        assert after == before + 1
    finally:
        fc.close()


def test_failover_all_moved_degrades_to_fallback_without_eviction():
    fc = _failover([("moved", 1), ("moved", 2)])
    try:
        r = fc.request_token(1)
        assert r.status != TokenStatus.MOVED
        assert all(m.health.allows_request() for m in fc._members)
    finally:
        fc.close()


def _advising_controller(top_n, **kw):
    from sentinel_tpu_torch.metrics.server import ServerMetrics
    from sentinel_tpu_torch.overload.admission import (
        AdmissionController,
        OverloadConfig,
    )

    m = ServerMetrics()
    m.count_verdict("pass", "hot", 500)
    m.count_verdict("pass", "lukewarm", 40)
    m.count_verdict("block", "cold", 3)
    return AdmissionController(
        OverloadConfig(headroom_shed=0.0, min_bdp=0.0, sustain_ms=0.0,
                       recheck_ms=0.0, advise_top_n=top_n, **kw),
        metrics=m,
    )


def test_sustained_pressure_emits_rebalance_advise():
    from sentinel_tpu_torch.overload.admission import BrownoutLevel

    ac = _advising_controller(2, advise_interval_ms=0.0)
    heard = []
    ac.on_advice = heard.append
    ac.note_enqueued(8)
    assert ac.level() is not BrownoutLevel.NORMAL
    advice = ac.last_advice
    assert advice is not None and heard == [advice]
    named = [e["namespace"] for e in advice["namespaces"]]
    assert named == ["hot", "lukewarm"]  # top-N by verdict delta
    assert advice["namespaces"][0]["verdicts"] == 500
    assert advice["level"] == ac.snapshot()["levelName"]
    assert ac.snapshot()["lastAdvice"] is advice


def test_advise_disabled_with_top_n_zero():
    from sentinel_tpu_torch.overload.admission import BrownoutLevel

    ac = _advising_controller(0)
    ac.note_enqueued(8)
    assert ac.level() is not BrownoutLevel.NORMAL
    assert ac.last_advice is None


def test_aggregate_snapshots_skips_bad_pods_and_counts_them():
    NS.reset_snapshot_errors_for_tests()

    def unreachable():
        raise ConnectionError("pod down")

    out = aggregate_snapshots([
        {1: {"pass": 2.0}},
        unreachable,  # fetch raises → skipped, counted
        lambda: {1: {"pass": 3.0}, 2: {"block": 1.0}},
        {1: "not-a-mapping"},  # malformed payload → skipped, counted
    ])
    assert out[1]["pass"] == pytest.approx(5.0)
    assert out[2]["block"] == pytest.approx(1.0)
    assert NS.snapshot_error_total() == 2


# -- tests/test_push.py: a pushed shard map rewires the router ---------------
@pytest.fixture(params=("asyncio", "native"))
def push_door(request):
    reset_server_metrics_for_tests()
    svc = DefaultTokenService(
        EngineConfig(max_flows=16, max_namespaces=4, batch_size=64),
        device=CPU)
    svc.load_rules([ClusterFlowRule(11, 1e9, ThresholdMode.GLOBAL)])
    Door = TokenServer if request.param == "asyncio" else NativeTokenServer
    server = Door(svc, port=0, idle_ttl_s=None)
    server.start()
    yield server
    server.stop()
    reset_server_metrics_for_tests()


def _wait(predicate, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_shard_map_push_rewires_routing_client(push_door):
    ns, flow = "default", 11
    router = RoutingTokenClient(
        timeout_ms=5000,
        namespace_of={flow: ns},
        pod_of={ns: "pod-a"},
        endpoints={"pod-a": ("127.0.0.1", push_door.port)},
    )
    try:
        assert router.request_token(flow).ok  # builds the pod client
        pushed = ShardMap(
            epoch=7,
            endpoint_of={ns: f"127.0.0.1:{push_door.port}"},
            global_flows={str(flow): "10.9.9.9:7000"},
        )
        push_door.push_hub.push_shard_map(encode_shard_map_doc(pushed))
        _wait(lambda: router.epoch == 7, "pushed shard map never applied")
        assert router.coordinator_of(flow) == "10.9.9.9:7000"
        # stale epoch pushed later is fenced out
        stale = ShardMap(epoch=3, endpoint_of={},
                         global_flows={str(flow): "10.0.0.1:1"})
        push_door.push_hub.push_shard_map(encode_shard_map_doc(stale))
        time.sleep(0.1)
        assert router.coordinator_of(flow) == "10.9.9.9:7000"
    finally:
        router.close()


# -- across packages ----------------------------------------------------------
def _seeded_rules(rng, n=64):
    nss = [f"ns{i}" for i in range(6)]
    out = []
    for fid in rng.choice(2**40, size=n, replace=False):
        ns = nss[int(rng.integers(len(nss)))]
        out.append((int(fid), float(rng.integers(1, 100)), ns))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_partitions_and_aggregation_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    spec = _seeded_rules(rng)
    t_rules = [ClusterFlowRule(f, c, ThresholdMode.GLOBAL, ns)
               for f, c, ns in spec]
    j_rules = [JRule(f, c, JTM.GLOBAL, ns) for f, c, ns in spec]
    owners = {f"ns{i}": f"pod{i % 3}" for i in range(5)}  # ns5 unassigned
    t_part = partition_rules(t_rules, NamespaceAssignment(owners))
    j_part = JNS.partition_rules(j_rules, JNS.NamespaceAssignment(owners))
    assert {k: [r.flow_id for r in v] for k, v in t_part.items()} == {
        k: [r.flow_id for r in v] for k, v in j_part.items()}
    assert flow_namespaces(t_rules) == JNS.flow_namespaces(j_rules)

    fids = [f for f, _c, _ns in spec]
    snaps = []
    for pod in range(4):
        snap = {}
        for fid in rng.choice(fids, size=20, replace=False):
            row = {"pass_qps": float(rng.integers(0, 50)),
                   "leased_tokens": float(rng.integers(0, 9))}
            if rng.random() < 0.3:
                row["moved_epoch"] = int(rng.integers(1, 6))
            snap[int(fid)] = row
        snaps.append(snap)
    snaps.insert(2, {1: "not-a-mapping"})
    budgets = {int(f): float(rng.integers(0, 3)) for f in fids[:10]}
    for mod in (NS, JNS):
        mod.reset_snapshot_errors_for_tests()
        mod.reset_move_dedup_for_tests()
    got = aggregate_snapshots(snaps, global_budgets=budgets)
    want = JNS.aggregate_snapshots(snaps, global_budgets=budgets)
    assert got == want
    assert NS.snapshot_error_total() == JNS.snapshot_error_total() == 1
    assert NS.move_dedup_total() == JNS.move_dedup_total() > 0


def test_lazy_cluster_exports_are_the_reference():
    import importlib
    import subprocess
    import sys

    import sentinel_tpu.cluster as JC
    import sentinel_tpu_torch.cluster as TC

    assert TC.__all__ == JC.__all__
    assert sorted(TC._EXPORTS) == sorted(JC._EXPORTS)
    for name, mod in TC._EXPORTS.items():
        assert mod == JC._EXPORTS[name].replace(
            "sentinel_tpu.", "sentinel_tpu_torch.", 1)
        assert getattr(TC, name) is getattr(importlib.import_module(mod),
                                            name)
    assert set(TC.__all__) <= set(dir(TC))
    with pytest.raises(AttributeError):
        TC.NoSuchThing
    # importing the wire codec leaves the torch service stack unloaded
    repo = __file__.rsplit("/tests/", 1)[0]
    code = ("import sys\n"
            f"sys.path.insert(0, {repo!r})\n"
            "import sentinel_tpu_torch.cluster.protocol\n"
            "import sentinel_tpu_torch.cluster.connection\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'sentinel_tpu_torch.cluster.token_service' "
            "not in sys.modules\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
