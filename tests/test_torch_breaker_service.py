"""Completion reports and circuit breaking through the port's token service
(``device="cpu"``) against the reference ``DefaultTokenService``.

Both services sit on manual clocks set to the same millisecond and take the
same seeded stream (``torch_outcome_check``): pulls of 64 / 200 / 256 rows
and an oversized pull that takes the fused path, interleaved with report
batches of 64 / 300 / 1024 rows drawn from what each pull admitted (about
1% invalid), over breakers of all three strategies, a third of them sick.
After every operation the verdicts, every state leaf, the ingest and drop
counters, ``breaker_stats``, ``outcome_stats`` and ``metrics_snapshot``
must be equal, and the stream must trip, probe, close and reopen breakers.
Also: degrade-rule reloads and the rule-management surface.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sentinel_tpu.cluster.token_service as j_token_service  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import DegradeRule as JDegrade  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.rules import (  # noqa: E402
    DegradeStrategy as JDS,
    ThresholdMode as JTM,
)

import torch_outcome_check as OC  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
    TokenResult,
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
from sentinel_tpu_torch.stats.window import NEVER  # noqa: E402
from torch_parity import assert_states_equal  # noqa: E402

KW = dict(max_flows=512, max_namespaces=4, batch_size=256)
START_MS = 1_700_000_000_040
N_RULES = 200
PLAN = (("pull", 64), ("report", 64), ("pull", 200), ("report", 300),
        ("pull", 256), ("report", 1024), ("pull", 2 * 256 + 40),
        ("report", 1024))
ADVANCES_MS = (20, 60, 35, 90, 45, 120, 60, 70)  # 500 ms a round


def _ns(fid):
    return "default" if fid % 3 else "ns1"


def _flow_specs():
    return [dict(flow_id=fid, count=float(40 + fid % 50), mode=1,
                 namespace=_ns(fid)) for fid in range(N_RULES)]


def _rules(specs, rule, mode):
    return [rule(**{**s, "mode": mode(s["mode"])}) for s in specs]


def _degrades(specs, rule, strategy):
    return [rule(**{**s, "strategy": strategy(s["strategy"])})
            for s in specs]


@pytest.fixture
def clocks():
    jc, tc = j_clock.ManualClock(START_MS), t_clock.ManualClock(START_MS)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    yield jc, tc
    j_clock.set_clock(prev_j)
    t_clock.set_clock(prev_t)


def _services(degrade_specs):
    jsvc = JService(JConfig(decide_impl="xla", **KW), fuse_depths=(2,))
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu",
                               fuse_depths=(2,))
    specs = _flow_specs()
    jsvc.load_rules(_rules(specs, JRule, JTM))
    tsvc.load_rules(_rules(specs, ClusterFlowRule, ThresholdMode))
    jsvc.load_degrade_rules(_degrades(degrade_specs, JDegrade, JDS))
    tsvc.load_degrade_rules(_degrades(degrade_specs, DegradeRule,
                                      DegradeStrategy))
    return jsvc, tsvc


def _assert_same(jsvc, tsvc, label):
    assert_states_equal(jsvc._state, tsvc._state, label)
    assert jsvc.breaker_stats() == tsvc.breaker_stats(), label
    assert jsvc.outcome_stats() == tsvc.outcome_stats(), label
    assert jsvc.metrics_snapshot() == tsvc.metrics_snapshot(), label


def _zipf_ids(n_known):
    w = np.arange(1, n_known + 11, dtype=np.float64) ** -1.1
    cdf = np.cumsum(w / w.sum())

    def draw(rng, n):
        return np.minimum(np.searchsorted(cdf, rng.random(n)),
                          cdf.size - 1).astype(np.int64)

    return draw


def test_breaker_stream_matches_reference(clocks, monkeypatch):
    jc, tc = clocks
    specs = OC.degrade_specs(range(N_RULES), _ns)
    assert {s["strategy"] for s in specs} == {0, 1, 2}
    jsvc, tsvc = _services(specs)
    edges = OC.BreakerEdges()
    seen = {int(s) for s in TokenStatus}
    statuses = set()
    # every edge either service's scans see (the dispatch path's too),
    # summed: the reference's go to its transition counter, the port's
    # scan returns them
    names = DefaultTokenService._BR_STATE_NAMES
    j_edges, scanned = {}, {}

    def j_count(frm, to, n):
        j_edges[(frm, to)] = j_edges.get((frm, to), 0) + n

    def t_scan(force=False, _scan=tsvc._breaker_scan):
        got = _scan(force)
        for key, c in got.items():
            scanned[key] = scanned.get(key, 0) + c
        return got

    monkeypatch.setattr(j_token_service._SM, "count_breaker_transition",
                        j_count)
    monkeypatch.setattr(tsvc, "_breaker_scan", t_scan)

    def advance(ms):
        jc.advance(ms)
        tc.advance(ms)

    def check_op(kind, r, i, n, outs):
        label = f"round {r} step {i} {kind} n={n}"
        if kind == "pull":
            assert OC.verdicts_equal(outs), label
            statuses.update(np.unique(outs[1][0]).tolist())
        else:
            assert outs[0] == outs[1], label
        jsvc._breaker_scan(force=True)
        tsvc._breaker_scan(force=True)
        assert j_edges == {(names[f], names[t]): c
                           for (f, t), c in scanned.items()}, label
        _assert_same(jsvc, tsvc, label)
        edges.update(tsvc.breaker_stats())

    OC.drive((jsvc, tsvc), advance, np.random.default_rng(5),
             _zipf_ids(N_RULES), PLAN, ADVANCES_MS, rounds=8,
             check_op=check_op, check_round=lambda r: None)
    assert statuses <= seen
    assert int(TokenStatus.DEGRADED) in statuses
    edges.require(trips=3, probes=3, closes=1, reopens=1)
    # every edge the scans saw is one the snapshots saw, and the reverse
    assert {OC.BreakerEdges.NAMES[k]: c for k, c in scanned.items()
            if k in OC.BreakerEdges.NAMES} == edges.counts
    dropped = tsvc.outcome_stats()["dropped"]
    assert set(dropped) == {"negative", "too_large", "unknown_flow",
                            "non_finite"}, dropped


def test_degrade_reload_keeps_surviving_breakers(clocks):
    jc, tc = clocks
    specs = OC.degrade_specs(range(N_RULES), _ns)
    # two breaker-only flows (no flow rule), one of which the reload drops
    extra = [dict(specs[1], flow_id=fid) for fid in (900, 910)]
    jsvc, tsvc = _services(specs + extra)
    rng = np.random.default_rng(9)
    ids_all = np.concatenate([np.arange(0, N_RULES, 10), [900, 910]])
    for _ in range(12):
        ids = np.repeat(ids_all, 6)
        for s in (jsvc, tsvc):
            s.request_batch_arrays(ids)
        fl, rt, exc = OC.report_rows(rng, ids, 400)
        exc[:] = True  # every breaker trips on the next pull
        for s in (jsvc, tsvc):
            s.report_outcomes(fl, rt, exc)
        jc.advance(150)
        tc.advance(150)
    before = tsvc.breaker_stats()["flows"]
    assert sum(e["state_code"] == 1 for e in before.values()) >= 10
    assert before[910]["state_code"] == 1
    slot_910 = tsvc._index.slot_of[910]
    dropped_with_rule = specs[1]["flow_id"]  # keeps its flow rule
    keep = specs[::2] + extra[:1]
    added = [dict(specs[1], flow_id=5)]  # a flow rule gains a breaker
    for s, rule, strat in ((jsvc, JDegrade, JDS),
                           (tsvc, DegradeRule, DegradeStrategy)):
        s.load_degrade_rules(_degrades(keep + added, rule, strat))
    _assert_same(jsvc, tsvc, "after the reload")
    after = tsvc.breaker_stats()["flows"]
    for s in keep:
        assert after[s["flow_id"]] == before[s["flow_id"]]
    assert after[5]["state"] == "closed"
    assert 910 not in jsvc._index.slot_of and 910 not in after
    # the breaker-only flow's freed slot is cleared; a flow that keeps its
    # flow rule keeps its (now unread) breaker columns, in both packages
    br = tsvc._state.breaker
    assert int(br.state[slot_910]) == 0
    assert int(br.opened_ms[slot_910]) == NEVER
    slot = tsvc._index.slot_of[dropped_with_rule]
    assert int(br.state[slot]) == before[dropped_with_rule]["state_code"]
    assert tsvc.current_degrade_rules() == _degrades(
        keep + added, DegradeRule, DegradeStrategy)
    # the next operations still agree
    ids = np.repeat(ids_all, 3)
    outs = [s.request_batch_arrays(ids) for s in (jsvc, tsvc)]
    assert OC.verdicts_equal(outs)
    _assert_same(jsvc, tsvc, "after the reload's next pull")


def test_rule_surface_matches_reference(clocks):
    jsvc, tsvc = _services(OC.degrade_specs(range(40), _ns))
    for s in (jsvc, tsvc):
        s.namespace_set.add("spare")
    assert jsvc.served_namespaces() == tsvc.served_namespaces()
    assert jsvc.config_snapshot() == tsvc.config_snapshot()
    j_ns1 = [dataclasses.asdict(r) for r in jsvc.current_rules("ns1")]
    t_ns1 = [dataclasses.asdict(r) for r in tsvc.current_rules("ns1")]
    assert j_ns1 == t_ns1 and len(t_ns1) > 10
    # replace one namespace's rules, keep the other's
    new_ns1 = [dict(flow_id=fid, count=7.0, mode=0, namespace="default")
               for fid in (300, 301)]
    jsvc.load_namespace_rules("ns1", _rules(new_ns1, JRule, JTM))
    tsvc.load_namespace_rules("ns1", _rules(new_ns1, ClusterFlowRule,
                                            ThresholdMode))
    assert [r.namespace for r in tsvc.current_rules("ns1")] == ["ns1"] * 2
    new_deg = [dict(OC.degrade_specs([0], _ns)[0], flow_id=301)]
    jsvc.load_namespace_degrade_rules(
        "ns1", _degrades(new_deg, JDegrade, JDS))
    tsvc.load_namespace_degrade_rules(
        "ns1", _degrades(new_deg, DegradeRule, DegradeStrategy))
    assert (len(tsvc.current_degrade_rules("ns1"))
            == len(jsvc.current_degrade_rules("ns1")))
    for s in (jsvc, tsvc):
        s.set_max_allowed_qps(123.0)
        s.connected_count_changed("ns1", 4)
        s.connected_count_changed("nowhere", 2)
    assert jsvc.config_snapshot() == tsvc.config_snapshot()
    assert_states_equal(jsvc._state, tsvc._state, "after the reloads")
    np.testing.assert_array_equal(np.asarray(jsvc._table.ns_connected),
                                  tsvc._table.ns_connected.numpy())
    ids = np.array([300, 300, 301, 5, 6, 301, 999] * 10)
    outs = [s.request_batch_arrays(ids) for s in (jsvc, tsvc)]
    assert OC.verdicts_equal(outs)
    assert_states_equal(jsvc._state, tsvc._state, "after a pull")


def test_token_result_surface():
    r = TokenResult(TokenStatus.DEGRADED, remaining=250)
    assert r.retry_after_ms == 250 and not r.ok
    assert TokenResult(TokenStatus.RELEASE_OK).ok
    assert TokenResult(TokenStatus.OK, remaining=3).retry_after_ms == 0
    assert TokenResult(TokenStatus.MOVED, endpoint="h:1").endpoint == "h:1"
