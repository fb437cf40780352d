"""The hierarchy tier of the port (``sentinel_tpu_torch.cluster.hierarchy``
and the service's hold and demand calls) against the JAX package's.

The cases of the reference's ``tests/test_hierarchy.py`` on the port's
classes (``TestWaterFill``, ``TestDemandReportCodec``,
``TestCoordinatorLedger``, ``TestShareHolds``, ``TestMoveCarriesShareCharge``,
``TestLedgerSnapshotPiggyback``, ``TestCoordinatorElection``, and
``TestCoordinatorKill`` through the port's asyncio ``TokenServer`` and a
``TokenClient`` agent client, ``torch_hier_check.single_endpoint``; the
agent's default client, the port's ``FailoverTokenClient``, walks a dead
coordinator endpoint to a live one; the reference's
``TestAggregateGlobalBlock`` needs ``cluster/namespaces.py``, item 12).

Across packages, bitwise: a seeded sequence of holds, pulls and clock steps
(``torch_hier_check.hold_plan``) on a JAX and a port service, with every
verdict, ``share_holds()``, ``demand_rates()``, ``window_budget()`` and the
flow plane equal; ``water_fill`` over a seeded fuzz; the coordinator's
``export_doc`` and stats after the same ops; a JAX agent against a port door
hosting a port coordinator and a port agent against a JAX door hosting a
JAX coordinator, with equal shares; and ``export_delta["hier"]`` streamed
from a JAX primary into a port standby and the reverse.
"""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster import hierarchy as JH  # noqa: E402
from sentinel_tpu.cluster.client import TokenClient as JTokenClient  # noqa: E402
from sentinel_tpu.cluster.server import TokenServer as JTokenServer  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.rules import ThresholdMode as JTM  # noqa: E402
from sentinel_tpu.ha import replication as JR  # noqa: E402
from sentinel_tpu.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as j_reset_metrics,
)

import torch_hier_check as HC  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu_torch.cluster.hierarchy import (  # noqa: E402
    COORD_LOCK_KEY,
    CoordinatorElection,
    GlobalBudgetCoordinator,
    GlobalFlowBudget,
    PodShareAgent,
    decode_coord_lock,
    water_fill,
)
from sentinel_tpu_torch.cluster.rebalance import (  # noqa: E402
    ShardMapPublisher,
    decode_shard_map_doc,
)
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.rules import ThresholdMode  # noqa: E402
from sentinel_tpu_torch.ha import replication as TR  # noqa: E402
from sentinel_tpu_torch.ha.failover import FailoverTokenClient  # noqa: E402
from sentinel_tpu_torch.ha.snapshot import (  # noqa: E402
    decode_snapshot,
    encode_snapshot,
)
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
    server_metrics,
)
from torch_ha_check import JAX, PORT, manual_clocks  # noqa: E402
from torch_parity import assert_states_equal  # noqa: E402

G = ThresholdMode.GLOBAL
# default window: 10 x 100 ms buckets, so the threshold is the rule's count
CFG = EngineConfig(max_flows=64, max_namespaces=8, batch_size=64)
FLOW = 101


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` for one test."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture
def clocks():
    with manual_clocks() as pair:
        yield pair


@pytest.fixture(autouse=True)
def clean_metrics():
    t_reset_metrics()
    j_reset_metrics()
    yield
    t_reset_metrics()
    j_reset_metrics()


def _svc(count=50.0, ns="default", **kw):
    svc = DefaultTokenService(CFG, device="cpu", **kw)
    svc.load_rules([ClusterFlowRule(FLOW, count, G, ns)])
    return svc


def _drain(svc, flow=FLOW):
    """Admit until BLOCKED; returns how many decisions passed."""
    passed = 0
    while svc.request_token(flow).ok:
        passed += 1
        assert passed <= 1000, "window never closed"
    return passed


def _coord(budget=100.0, **kw):
    kw.setdefault("share_ttl_ms", 5000)
    return GlobalBudgetCoordinator(
        [GlobalFlowBudget(FLOW, budget, 1.0)], **kw
    )


# -- water-fill proration -----------------------------------------------------
class TestWaterFill:
    def test_under_demand_splits_slack_equally(self):
        assert water_fill(100, {"a": 60.0, "b": 20.0}) == {"a": 70, "b": 30}

    def test_over_demand_levels_the_fill(self):
        assert water_fill(100, {"a": 500.0, "b": 100.0}) == {"a": 50, "b": 50}

    def test_floor_keeps_a_collapsed_pod_alive(self):
        assert water_fill(100, {"a": 500.0, "b": 0.0}, floor=10) == {
            "a": 90, "b": 10,
        }

    def test_floors_exceeding_budget_degrade_to_equal_split(self):
        out = water_fill(10, {"a": 5.0, "b": 5.0, "c": 5.0}, floor=6)
        assert sum(out.values()) == 10
        assert max(out.values()) - min(out.values()) <= 1

    def test_empty_and_zero_budget(self):
        assert water_fill(100, {}) == {}
        assert water_fill(0, {"a": 5.0}) == {"a": 0}

    def test_fuzz_conserves_budget_and_order(self):
        rng = np.random.default_rng(7)
        for _ in range(300):
            n = int(rng.integers(1, 7))
            budget = int(rng.integers(1, 1000))
            demands = {
                f"p{i}": float(rng.integers(0, 2000)) for i in range(n)
            }
            floor = int(rng.integers(0, max(1, budget // n)))
            out = water_fill(budget, demands, floor)
            assert sum(out.values()) == budget, (budget, demands, floor, out)
            assert out == water_fill(budget, demands, floor)
            pods = sorted(demands, key=lambda p: demands[p])
            for lo, hi in zip(pods, pods[1:]):
                if demands[hi] > demands[lo]:
                    assert out[hi] >= out[lo] - 1, (demands, floor, out)

    def test_fuzz_equals_the_reference(self):
        """Float demands, fractional levels and floors: the port's shares
        are the reference's, integer for integer."""
        rng = np.random.default_rng(11)
        for _ in range(500):
            n = int(rng.integers(0, 8))
            budget = int(rng.integers(0, 5000))
            demands = {f"pod-{i}": float(rng.random() * 3000)
                       for i in range(n)}
            floor = int(rng.integers(0, max(1, budget // max(1, n) + 3)))
            assert water_fill(budget, demands, floor) == JH.water_fill(
                budget, demands, floor), (budget, demands, floor)


# -- demand-report codec ------------------------------------------------------
class TestDemandReportCodec:
    ENTRIES = [(FLOW, 9, 1500), (7, 0, 0), (-3, 2**40, -250)]

    LEN = P._LEN.size  # frames are length-prefixed; decode takes the payload

    def test_roundtrip(self):
        frame = P.encode_demand_report(42, "pod-a", self.ENTRIES)
        payload = bytes(frame[self.LEN:])
        xid, pod, entries = P.decode_demand_report(payload)
        assert (xid, pod, list(entries)) == (42, "pod-a", self.ENTRIES)

    def test_empty_entries_roundtrip(self):
        payload = bytes(P.encode_demand_report(1, "p", [])[self.LEN:])
        assert P.decode_demand_report(payload) == (1, "p", [])

    def test_every_truncation_cut_raises(self):
        payload = bytes(
            P.encode_demand_report(42, "pod-a", self.ENTRIES)[self.LEN:]
        )
        for cut in range(len(payload)):
            with pytest.raises(ValueError):
                P.decode_demand_report(payload[:cut])

    def test_trailing_garbage_raises(self):
        payload = bytes(
            P.encode_demand_report(42, "pod-a", self.ENTRIES)[self.LEN:]
        )
        with pytest.raises(ValueError):
            P.decode_demand_report(payload + b"\x00")

    def test_mistyped_frame_raises(self):
        payload = bytearray(P.encode_demand_report(1, "p", [])[self.LEN:])
        payload[4] = int(P.MsgType.SHARE_GRANT)  # flip the type byte
        with pytest.raises(ValueError):
            P.decode_demand_report(bytes(payload))


# -- coordinator ledger -------------------------------------------------------
class TestCoordinatorLedger:
    def test_grants_never_exceed_budget(self, manual_clock):
        c = _coord(100.0)
        a = c.share_grant(FLOW, 80)
        b = c.share_grant(FLOW, 80)
        assert a.status == 0 and a.tokens == 80 and a.lease_id > 0
        assert b.status == 0 and b.tokens == 20
        assert c.outstanding_shares() == 100

    def test_exhausted_pool_grants_zero_not_refusal(self, manual_clock):
        c = _coord(100.0)
        c.share_grant(FLOW, 100)
        r = c.share_grant(FLOW, 50)
        assert r.status == 0 and r.tokens == 0 and r.lease_id == 0

    def test_unknown_flow_is_not_leasable(self, manual_clock):
        assert _coord().share_grant(999, 10).status == int(
            P.NOT_LEASABLE_STATUS
        )

    def test_renew_reclaims_own_tokens_first(self, manual_clock):
        c = _coord(100.0)
        g = c.share_grant(FLOW, 100)
        r = c.share_renew(g.lease_id, FLOW, 0, 100)
        assert r.tokens == 100 and r.lease_id != g.lease_id
        assert c.outstanding_shares() == 100

    def test_return_frees_the_pool(self, manual_clock):
        c = _coord(100.0)
        g = c.share_grant(FLOW, 100)
        assert c.share_return(g.lease_id, 0).status == 0
        assert c.share_return(g.lease_id, 0).status == 0  # idempotent
        assert c.share_grant(FLOW, 100).tokens == 100

    def test_ttl_expiry_reclaims_a_dead_pods_share(self, manual_clock):
        c = _coord(100.0, share_ttl_ms=500)
        c.share_grant(FLOW, 100)
        manual_clock.advance(501)
        assert c.outstanding_shares() == 0
        assert c.stats()["share_expired"] == 1
        assert c.share_grant(FLOW, 100).tokens == 100

    def test_demand_report_labels_shares_and_targets_follow(
        self, manual_clock
    ):
        c = _coord(100.0, min_share_frac=0.05)
        ga = c.share_grant(FLOW, 50)
        gb = c.share_grant(FLOW, 50)
        assert c.handle_demand_report(
            "a", [(FLOW, ga.lease_id, 60_000)]
        ).tokens == 1
        c.handle_demand_report("b", [(FLOW, gb.lease_id, 40_000)])
        assert c.reconcile_once()[FLOW] == {"a": 60, "b": 40}
        # hysteresis: a 2-token wobble (< 10% of budget) keeps old targets
        c.handle_demand_report("a", [(FLOW, ga.lease_id, 62_000)])
        c.handle_demand_report("b", [(FLOW, gb.lease_id, 38_000)])
        assert c.reconcile_once()[FLOW] == {"a": 60, "b": 40}
        c.handle_demand_report("a", [(FLOW, ga.lease_id, 90_000)])
        c.handle_demand_report("b", [(FLOW, gb.lease_id, 10_000)])
        assert c.reconcile_once()[FLOW] == {"a": 90, "b": 10}

    def test_stale_demand_ages_out(self, manual_clock):
        c = _coord(100.0, share_ttl_ms=500)
        c.handle_demand_report("a", [(FLOW, 0, 60_000)])
        assert c.reconcile_once()[FLOW] != {}
        manual_clock.advance(1001)  # 2 x share_ttl_ms
        assert c.reconcile_once()[FLOW] == {}

    def test_ledger_doc_roundtrip(self, manual_clock):
        c = _coord(100.0)
        g = c.share_grant(FLOW, 70)
        c.handle_demand_report("a", [(FLOW, g.lease_id, 60_000)])
        c.reconcile_once()
        d = _coord(100.0)
        d.import_doc(c.export_doc())
        assert d.outstanding_shares() == 70
        assert d.stats()["targets"] == c.stats()["targets"]
        assert d.share_grant(FLOW, 100).tokens == 30

    def test_ops_and_docs_equal_the_reference(self, clocks):
        """A seeded op sequence on a JAX and a port coordinator (both
        packages' clocks in step): every result, the stats and the ledger
        document after each op equal."""
        jc, tc = clocks
        budgets = [(FLOW, 100.0), (7, 37.5), (8, 250.0)]
        coords = [
            JH.GlobalBudgetCoordinator(
                [JH.GlobalFlowBudget(f, q, 1.0) for f, q in budgets],
                share_ttl_ms=700, reconcile_ms=50),
            GlobalBudgetCoordinator(
                [GlobalFlowBudget(f, q, 1.0) for f, q in budgets],
                share_ttl_ms=700, reconcile_ms=50),
        ]
        rng = np.random.default_rng(29)
        ids = [0]
        for i in range(400):
            op = int(rng.integers(0, 5))
            fid = int(rng.choice([FLOW, 7, 8, 999]))
            want = int(rng.integers(0, 120))
            if op == 0:
                res = [c.share_grant(fid, want) for c in coords]
            elif op == 1:
                sid = int(rng.choice(ids))
                res = [c.share_renew(sid, fid, 0, want) for c in coords]
            elif op == 2:
                sid = int(rng.choice(ids))
                res = [c.share_return(sid, 0) for c in coords]
            elif op == 3:
                pod = f"pod-{int(rng.integers(0, 3))}"
                entries = [(int(f), int(rng.choice(ids)),
                            int(rng.integers(0, 300_000)))
                           for f in rng.choice([FLOW, 7, 8, 999], 2)]
                res = [c.handle_demand_report(pod, entries) for c in coords]
            else:
                res = [c.reconcile_once() for c in coords]
            if op == 4:
                assert res[0] == res[1], i
            else:
                a, b = res
                assert (a.status, a.lease_id, a.tokens, a.ttl_ms,
                        a.endpoint) == (b.status, b.lease_id, b.tokens,
                                        b.ttl_ms, b.endpoint), i
                if a.lease_id:
                    ids.append(int(a.lease_id))
            assert coords[0].export_doc() == coords[1].export_doc(), i
            assert coords[0].stats() == coords[1].stats(), i
            assert coords[0].outstanding_shares() == \
                coords[1].outstanding_shares(), i
            ms = int(rng.choice([0, 3, 40, 250]))
            jc.advance(ms)
            tc.advance(ms)


# -- pod-side share holds -----------------------------------------------------
class TestShareHolds:
    def test_hold_squeezes_headroom_exactly(self, manual_clock):
        svc = _svc(50.0)
        assert svc.set_share_hold(FLOW, 30) == 30
        assert svc.share_holds() == {FLOW: 30}
        assert _drain(svc) == 20

    def test_hold_grows_and_shrinks_exactly(self, manual_clock):
        svc = _svc(50.0)
        svc.set_share_hold(FLOW, 30)
        assert _drain(svc) == 20            # PASS 20 + LEASED 30 = 50
        svc.set_share_hold(FLOW, 10)        # shrink frees 20
        assert _drain(svc) == 20            # PASS 40 + LEASED 10 = 50
        svc.set_share_hold(FLOW, 45)        # grow past the window: shut
        assert _drain(svc) == 0
        svc.set_share_hold(FLOW, 0)         # drop entirely
        assert svc.share_holds() == {}
        assert _drain(svc) == 10            # PASS 40 of 50 remain charged

    def test_hold_decays_one_window_after_agent_stops(self, manual_clock):
        svc = _svc(50.0)
        svc.request_token(FLOW)  # pin the engine epoch before the hold
        svc.set_share_hold(FLOW, 30)
        manual_clock.advance(1001)  # > one window with NO re-top
        assert svc.share_holds() == {}
        assert _drain(svc) == 50

    def test_migrating_hold_survives_many_windows(self, manual_clock):
        svc = _svc(50.0)
        svc.request_token(FLOW)
        svc.set_share_hold(FLOW, 30)
        for _ in range(25):
            manual_clock.advance(100)
            assert svc.set_share_hold(FLOW, 30) == 30
        assert svc.share_holds() == {FLOW: 30}
        assert _drain(svc) == 20

    def test_unknown_flow_hold_is_a_noop(self, manual_clock):
        svc = _svc(50.0)
        assert svc.set_share_hold(999, 30) == 0
        assert svc.share_holds() == {}

    @pytest.mark.parametrize("seed", [3, 17, 41])
    def test_hold_sequence_equals_the_reference(self, seed, clocks):
        """Holds re-topped, decayed and migrated across bucket rolls and
        whole windows, with pulls between: every answer, and the flow plane
        after, bitwise equal to the JAX service's."""
        kw = dict(max_flows=64, max_namespaces=4, batch_size=64)
        rules = [(fid, float(30 + 7 * fid % 50), fid % 3 == 0,
                  "default" if fid % 2 else "ns1") for fid in range(24)]
        js = JService(JConfig(decide_impl="xla", **kw))
        ts = DefaultTokenService(EngineConfig(**kw), device="cpu")
        js.load_rules([JRule(f, c, JTM.AVG_LOCAL if avg else JTM.GLOBAL, ns)
                       for f, c, avg, ns in rules])
        ts.load_rules([ClusterFlowRule(
            f, c, ThresholdMode.AVG_LOCAL if avg else G, ns)
            for f, c, avg, ns in rules])
        for s in (js, ts):
            s.connected_count_changed("ns1", 3)
        rng = np.random.default_rng(seed)
        held = [int(f) for f in rng.choice(24, 8, replace=False)]
        steps = HC.hold_plan(rng, held, rounds=20, others=[30, 2, 5])

        def advance(ms):
            for c in clocks:
                c.advance(ms)

        out = HC.run_hold_plan(
            [(js, js.request_batch_arrays), (ts, ts.request_batch_arrays)],
            steps, advance)
        assert out["hold_calls"] > 50 and out["pulls"] == 20
        assert_states_equal(js._state, ts._state, f"seed {seed}")
        assert js.share_holds() == ts.share_holds()
        for f in held:
            assert js.window_budget(f) == ts.window_budget(f)


# -- MOVE carries the share charge --------------------------------------------
class TestMoveCarriesShareCharge:
    def test_begin_move_drops_registry_but_charge_rides_export(
        self, manual_clock
    ):
        src = _svc(50.0, ns="mv")
        for _ in range(5):
            assert src.request_token(FLOW).ok
        src.set_share_hold(FLOW, 30)
        src.begin_move("mv", "dst-pod:4242", epoch=3)
        assert src.share_holds() == {}
        doc = src.export_namespace_state("mv")
        dst = DefaultTokenService(CFG, device="cpu")
        dst.import_namespace_state(doc)
        assert dst.share_holds() == {}
        assert _drain(dst) == 15

    def test_abort_move_restores_source_with_hold_charge(self, manual_clock):
        src = _svc(50.0, ns="mv")
        src.set_share_hold(FLOW, 30)
        src.begin_move("mv", "dst-pod:4242", epoch=3)
        src.abort_move("mv")
        assert _drain(src) == 20


# -- snapshot and delta piggyback ---------------------------------------------
class TestLedgerSnapshotPiggyback:
    def test_hier_doc_rides_snapshot_codec(self, manual_clock):
        svc = _svc()
        coord = _coord(100.0)
        svc.attach_hierarchy(coord)
        g = coord.share_grant(FLOW, 70)
        coord.handle_demand_report("a", [(FLOW, g.lease_id, 60_000)])
        doc = encode_snapshot(svc.export_state())
        assert doc["hier"]["flows"][str(FLOW)]["shares"]
        standby = _svc()
        standby.attach_hierarchy(_coord(100.0))
        standby.import_state(decode_snapshot(doc))
        assert standby.hierarchy.outstanding_shares() == 70

    def test_snapshot_without_coordinator_has_no_hier_block(
        self, manual_clock
    ):
        doc = encode_snapshot(_svc().export_state())
        assert "hier" not in doc
        _svc().import_state(decode_snapshot(doc))

    @pytest.mark.parametrize("primary_kind", ["jax", "port"])
    def test_hier_block_streams_across_packages(self, primary_kind, clocks):
        """A primary with a coordinator bootstraps a standby of the other
        package through the snapshot blob, then streams deltas: each
        delta's ``hier`` block lands in the standby's idle coordinator, and
        the two ledgers' documents stay equal."""
        budgets = [(2, 40.0), (5, 70.0)]
        other = "port" if primary_kind == "jax" else "jax"
        kinds = {"jax": (JAX, JR), "port": (PORT, TR)}

        def coordinator(kind):
            if kind == "jax":
                return JH.GlobalBudgetCoordinator(
                    [JH.GlobalFlowBudget(f, q, 1.0) for f, q in budgets])
            return GlobalBudgetCoordinator(
                [GlobalFlowBudget(f, q, 1.0) for f, q in budgets])

        pkind, pcodec = kinds[primary_kind]
        skind, scodec = kinds[other]
        primary = pkind.make()
        coord = coordinator(primary_kind)
        primary.attach_hierarchy(coord)
        primary.replication_enable()
        standby = skind.make(order=-1)
        standby.attach_hierarchy(coordinator(other))
        blob = pcodec.encode_snapshot_blob(primary.export_state())
        standby.import_state(scodec.decode_snapshot_blob(blob))
        primary.export_delta()
        rng = np.random.default_rng(5)
        sids = [0]
        for tick in range(6):
            for _ in range(4):
                fid = int(rng.choice([2, 5]))
                r = coord.share_renew(int(rng.choice(sids)), fid, 0,
                                      int(rng.integers(1, 60)))
                sids.append(int(r.lease_id))
                coord.handle_demand_report(
                    f"pod-{tick % 2}", [(fid, int(r.lease_id),
                                         int(rng.integers(0, 90_000)))])
            coord.reconcile_once()
            primary.request_batch_arrays(np.asarray([2, 5, 5], np.int64))
            delta = primary.export_delta()
            assert delta["hier"] == coord.export_doc()
            standby.apply_replication_delta(
                scodec.decode_delta_blob(pcodec.encode_delta_blob(delta)))
            assert standby.hierarchy.export_doc() == coord.export_doc(), tick
            for c in clocks:
                c.advance(int(rng.integers(20, 200)))


# -- coordinator kill over the wire -------------------------------------------
class TestCoordinatorKill:
    def test_pods_hold_last_share_and_admissions_stay_bounded(self):
        budget = 40.0  # 40 tokens over the 1s window, fleet-wide
        svc_a = _svc(budget)
        svc_b = _svc(budget)
        svc_a.request_token(FLOW)
        svc_b.request_token(FLOW)
        coord = GlobalBudgetCoordinator(
            [GlobalFlowBudget(FLOW, budget, 1.0)],
            share_ttl_ms=30_000, reconcile_ms=50,
        )
        svc_a.attach_hierarchy(coord)
        srv = TokenServer(svc_a, port=0)
        srv.start()
        agents = []
        try:
            flows = [GlobalFlowBudget(FLOW, budget, 1.0)]
            for svc, pod in ((svc_a, "pod-a"), (svc_b, "pod-b")):
                agents.append(PodShareAgent(
                    svc, [f"127.0.0.1:{srv.port}"], pod, flows,
                    tick_ms=50, timeout_ms=2000, deadline_ms=2000,
                    client_cls=HC.single_endpoint(TokenClient),
                ))
            for ag in agents:
                ag.tick()
            coord.reconcile_once()
            for ag in agents:
                ag.tick()
            shares = {ag.pod_id: ag.shares()[FLOW] for ag in agents}
            assert sum(shares.values()) <= int(budget)
            assert all(s > 0 for s in shares.values())
            outstanding = coord.outstanding_shares()

            srv.stop()  # SIGKILL stand-in: the door goes dark mid-lease

            for ag in agents:
                ag.tick()  # RPCs fail; must not raise
            admitted = 0
            for ag, svc in zip(agents, (svc_a, svc_b)):
                ag.tick()
                assert ag.shares()[FLOW] == shares[ag.pod_id]
                assert ag.stats()["agent_degraded"] == 1
                admitted += _drain(svc)
            assert admitted <= int(budget) + outstanding
            assert admitted <= sum(shares.values())
        finally:
            for ag in agents:
                ag.close()
            coord.stop()
            srv.stop()

    def test_default_client_walks_a_dead_coordinator_to_a_live_one(self):
        """With no ``client_cls`` the agent ticks through the port's
        ``FailoverTokenClient``: the first endpoint, where nothing listens,
        is walked past to the live coordinator's door."""
        budget = 40.0
        svc = _svc(budget)
        coord = GlobalBudgetCoordinator(
            [GlobalFlowBudget(FLOW, budget, 1.0)],
            share_ttl_ms=30_000, reconcile_ms=50,
        )
        svc.attach_hierarchy(coord)
        srv = TokenServer(svc, port=0)
        srv.start()
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()
        live = f"127.0.0.1:{srv.port}"
        agent = PodShareAgent(
            svc, [f"127.0.0.1:{dead_port}", live], "pod-a",
            [GlobalFlowBudget(FLOW, budget, 1.0)],
            tick_ms=50, timeout_ms=2000, deadline_ms=4000,
        )
        try:
            assert isinstance(agent._client, FailoverTokenClient)
            agent.tick()
            coord.reconcile_once()
            agent.tick()
            assert 0 < agent.shares()[FLOW] <= int(budget)
            assert str(agent._client.active_endpoint) == live
            dead_health = agent._client.health_snapshot()[0]
            assert dead_health["consecutiveFailures"] >= 1
        finally:
            agent.close()
            srv.stop()

    def test_hier_stats_reach_server_metrics(self, manual_clock):
        """The service's hierarchy provider: agent counters overlaid by the
        coordinator's ledger, and the live hold tokens."""
        svc = _svc(50.0)
        assert svc.hier_stats() == {} == server_metrics().hier_stats()
        coord = _coord(50.0)
        svc.attach_hierarchy(coord)
        agent = PodShareAgent(svc, ["127.0.0.1:1"], "pod-a", [FLOW],
                              client_cls=_LocalClient.bind(coord))
        agent.tick()
        stats = server_metrics().hier_stats()
        assert stats == svc.hier_stats()
        assert stats["agent_ticks"] == 1 and stats["share_grants"] == 1
        assert stats["hold_tokens"] == sum(svc.share_holds().values()) == 0
        assert stats["share_tokens"] == {FLOW: 50}


class _LocalClient:
    """An agent client that calls a coordinator in process."""

    @classmethod
    def bind(cls, coord):
        return lambda endpoints, timeout_ms, deadline_ms: cls(coord)

    def __init__(self, coord):
        self.coord = coord

    def share_op(self, msg_type, flow_id, want=0, share_id=0, used=0):
        if msg_type == P.MsgType.SHARE_GRANT:
            return self.coord.share_grant(flow_id, want)
        if msg_type == P.MsgType.SHARE_RENEW:
            return self.coord.share_renew(share_id, flow_id, used, want)
        return self.coord.share_return(share_id, used)

    def demand_report(self, pod_id, entries):
        return self.coord.handle_demand_report(pod_id, entries)

    def close(self):
        pass


# -- agents of each package against the other's door --------------------------
def _agent_rounds(clocks, door_kind):
    """Two pods (the door's own service hosts the coordinator; the other
    pod is of the other package) share two global flows; a skew of demand
    to pod B. Returns every agent's shares after each round."""
    flows = [(2, 40.0), (5, 70.0)]
    kw = dict(max_flows=64, max_namespaces=4, batch_size=64)
    jcfg = JConfig(decide_impl="xla", **kw)
    tcfg = EngineConfig(**kw)

    def jsvc():
        s = JService(jcfg, serve_buckets=(64,), fuse_depths=())
        s.load_rules([JRule(f, q, JTM.GLOBAL) for f, q in flows])
        return s

    def tsvc():
        s = DefaultTokenService(tcfg, device="cpu", serve_buckets=(64,),
                                fuse_depths=())
        s.load_rules([ClusterFlowRule(f, q, G) for f, q in flows])
        return s

    if door_kind == "port":
        svc_a, svc_b = tsvc(), jsvc()
        coord = GlobalBudgetCoordinator(
            [GlobalFlowBudget(f, q, 1.0) for f, q in flows])
        door = TokenServer(svc_a, port=0, idle_ttl_s=None)
        agent_a, client_a = PodShareAgent, TokenClient
        agent_b, client_b = JH.PodShareAgent, JTokenClient
    else:
        svc_a, svc_b = jsvc(), tsvc()
        coord = JH.GlobalBudgetCoordinator(
            [JH.GlobalFlowBudget(f, q, 1.0) for f, q in flows])
        door = JTokenServer(svc_a, port=0, idle_ttl_s=None)
        agent_a, client_a = JH.PodShareAgent, JTokenClient
        agent_b, client_b = PodShareAgent, TokenClient
    svc_a.attach_hierarchy(coord)
    door.start()
    agents = []
    try:
        ep = [f"127.0.0.1:{door.port}"]
        agents = [
            agent_a(svc_a, ep, "pod-a", [f for f, _ in flows],
                    timeout_ms=5000, deadline_ms=5000,
                    client_cls=HC.single_endpoint(client_a)),
            agent_b(svc_b, ep, "pod-b", [f for f, _ in flows],
                    timeout_ms=5000, deadline_ms=5000,
                    client_cls=HC.single_endpoint(client_b)),
        ]
        seen = []
        ids = np.asarray([5] * 30 + [2] * 20, np.int64)
        for r in range(6):
            if r >= 2:
                svc_b.request_batch_arrays(ids)
            for ag in agents:
                ag.tick()
            coord.reconcile_once()
            seen.append([ag.shares() for ag in agents]
                        + [svc_a.share_holds(), svc_b.share_holds()])
            for c in clocks:
                c.advance(100)
        return seen, coord.export_doc()
    finally:
        for ag in agents:
            ag.close()
        door.stop()


def test_agents_of_each_package_against_the_others_door(clocks):
    """A port agent against a JAX door hosting a JAX coordinator, and a JAX
    agent against a port door hosting a port coordinator: the same rounds
    give the same shares, holds and ledger."""
    port_door = _agent_rounds(clocks, "port")
    for c in clocks:
        c.advance(5000)
    jax_door = _agent_rounds(clocks, "jax")
    assert port_door[0] == jax_door[0]
    assert port_door[0][-1][1][5] > port_door[0][-1][0][5]  # skewed to B
    docs = [port_door[1], jax_door[1]]
    for d in docs:
        d.pop("flows")  # reported at different clocks; the shares compared
    assert docs[0] == docs[1]


# -- coordinator auto-election -------------------------------------------------
class _StubService:
    hierarchy = None

    def attach_hierarchy(self, coord):
        self.hierarchy = coord


class _StubHub:
    def __init__(self):
        self.pushed = []

    def push_shard_map(self, doc):
        self.pushed.append(doc)


class TestCoordinatorElection:
    def _pair(self, pub, **kw):
        budgets = [GlobalFlowBudget(FLOW, 100.0, 1.0)]
        svc_a, svc_b = _StubService(), _StubService()
        hub_a, hub_b = _StubHub(), _StubHub()
        ea = CoordinatorElection(
            svc_a, pub, "pod-a", "10.0.0.1:7000", budgets,
            lock_ttl_ms=3000, push_hubs=[hub_a], **kw,
        )
        eb = CoordinatorElection(
            svc_b, pub, "pod-b", "10.0.0.2:7000", budgets,
            lock_ttl_ms=3000, push_hubs=[hub_b], **kw,
        )
        return (svc_a, hub_a, ea), (svc_b, hub_b, eb)

    def test_exactly_one_winner_and_map_names_it(self, manual_clock):
        pub = ShardMapPublisher()
        (svc_a, hub_a, ea), (svc_b, hub_b, eb) = self._pair(pub)
        try:
            assert ea.tick() is True
            assert eb.tick() is False
            assert svc_a.hierarchy is not None and svc_b.hierarchy is None
            m = pub.current()
            assert m.coordinator_of(FLOW) == "10.0.0.1:7000"
            lock = decode_coord_lock(m.global_flows[COORD_LOCK_KEY])
            assert lock[0] == "pod-a"
            assert len(hub_a.pushed) == 1 and not hub_b.pushed
            pushed = decode_shard_map_doc(hub_a.pushed[0])
            assert pushed.coordinator_of(FLOW) == "10.0.0.1:7000"
            manual_clock.wait_ms(2000)
            assert ea.tick() is True
            assert len(hub_a.pushed) == 1
            assert pub.current().coordinator_of(FLOW) != \
                m.global_flows[COORD_LOCK_KEY]
        finally:
            ea.stop(release=False)
            eb.stop(release=False)

    def test_crash_failover_waits_out_the_ttl(self, manual_clock):
        pub = ShardMapPublisher()
        (svc_a, _, ea), (svc_b, hub_b, eb) = self._pair(pub)
        try:
            assert ea.tick() is True and eb.tick() is False
            ea.hard_stop()
            manual_clock.wait_ms(1000)
            assert eb.tick() is False
            manual_clock.wait_ms(3000)
            assert eb.tick() is True
            assert svc_b.hierarchy is not None
            assert pub.current().coordinator_of(FLOW) == "10.0.0.2:7000"
            assert len(hub_b.pushed) == 1
        finally:
            eb.stop(release=False)

    def test_graceful_stop_hands_over_without_ttl_wait(self, manual_clock):
        pub = ShardMapPublisher()
        (svc_a, _, ea), (svc_b, _, eb) = self._pair(pub)
        try:
            assert ea.tick() is True
            ea.stop()
            assert COORD_LOCK_KEY not in pub.current().global_flows
            assert svc_a.hierarchy is None
            assert eb.tick() is True
        finally:
            eb.stop(release=False)

    def test_racing_claims_resolve_to_one_leader(self, manual_clock):
        pub = ShardMapPublisher()
        (svc_a, _, ea), (svc_b, _, eb) = self._pair(pub)
        try:
            base = pub.current()
            now = t_clock.now_ms()
            wins = [ea._publish_claim(base, now), eb._publish_claim(base, now)]
            assert wins.count(True) == 1
            a, b = ea.tick(), eb.tick()
            assert (a, b) in ((True, False), (False, True))
            assert (svc_a.hierarchy is None) != (svc_b.hierarchy is None)
        finally:
            ea.stop(release=False)
            eb.stop(release=False)

    def test_deposed_leader_steps_down(self, manual_clock):
        pub = ShardMapPublisher()
        (svc_a, _, ea), (svc_b, _, eb) = self._pair(pub)
        try:
            assert ea.tick() is True
            coord_a = svc_a.hierarchy
            ea.hard_stop()
            manual_clock.wait_ms(4000)
            assert eb.tick() is True
            assert ea.tick() is False
            assert svc_a.hierarchy is None
            assert ea.stats()["depositions"] == 1
            assert coord_a is not svc_b.hierarchy
        finally:
            eb.stop(release=False)

    def test_a_real_service_attaches_and_detaches(self, manual_clock):
        """The election over the port's service (not a stub): the winner's
        service hosts the coordinator, and a graceful stop detaches it."""
        pub = ShardMapPublisher()
        svc = _svc()
        e = CoordinatorElection(svc, pub, "pod-a", "127.0.0.1:1",
                                [GlobalFlowBudget(FLOW, 10.0, 1.0)])
        assert e.tick() is True
        assert isinstance(svc.hierarchy, GlobalBudgetCoordinator)
        e.stop()
        assert svc.hierarchy is None


def test_threads_start_and_stop():
    """The coordinator's reconcile loop and the agent's tick loop run on
    their threads and stop within their join bound."""
    svc = _svc()
    coord = _coord(50.0, reconcile_ms=5)
    agent = PodShareAgent(svc, ["127.0.0.1:1"], "pod-a", [FLOW], tick_ms=5,
                          client_cls=_LocalClient.bind(coord))
    coord.start()
    agent.start()
    deadline = time.monotonic() + 5.0
    while agent.stats()["agent_ticks"] < 3 or \
            coord.stats()["reconciles"] < 3:
        assert time.monotonic() < deadline, "loops never ticked"
        time.sleep(0.01)
    agent.stop()
    coord.stop()
    assert not any(t.name in ("hier-reconcile", "hier-share-agent")
                   for t in threading.enumerate())
    assert agent.shares() == {FLOW: 0}  # stop returned the share
