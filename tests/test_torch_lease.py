"""Token leases through the port's token service (``device="cpu"``) against
the reference ``DefaultTokenService``, on manual clocks set to the same
millisecond: grant, pulls against the LEASED charge, renew (credit and a
fresh slice), return, the credit landing only in the grant's own bucket
(and dropped once that bucket was reused), TTL expiry, revocation when a
reload drops the rule, and NOT_LEASABLE for shaped and breaker-guarded
flows. After every operation the results, ``lease_stats``,
``outstanding_leases`` and every state leaf must be equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import DegradeRule as JDegrade  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.rules import ThresholdMode as JTM  # noqa: E402

from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    DegradeRule,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.state import ClusterEvent  # noqa: E402
from torch_parity import assert_states_equal  # noqa: E402

KW = dict(max_flows=64, max_namespaces=4, batch_size=64)
START_MS = 1_700_000_000_010
TTL_MS = 400


def _flow_specs(drop=()):
    specs = [dict(flow_id=fid, count=float(20 + 5 * fid), mode=int(fid % 2),
                  namespace="default" if fid % 3 else "ns1")
             for fid in range(1, 9) if fid not in drop]
    specs.append(dict(flow_id=20, count=30.0, mode=1, control_behavior=1))
    return specs


@pytest.fixture
def pair():
    jc, tc = j_clock.ManualClock(START_MS), t_clock.ManualClock(START_MS)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    jsvc = JService(JConfig(decide_impl="xla", **KW), fuse_depths=(),
                    lease_ttl_ms=TTL_MS)
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu",
                               fuse_depths=(), lease_ttl_ms=TTL_MS)
    for s, rule, mode, deg in ((jsvc, JRule, JTM, JDegrade),
                               (tsvc, ClusterFlowRule, ThresholdMode,
                                DegradeRule)):
        s.load_degrade_rules([deg(flow_id=7, threshold=0.5)])
        s.load_rules([rule(**{**r, "mode": mode(r["mode"])})
                      for r in _flow_specs()], connected={"default": 2})
    yield jsvc, tsvc, (jc, tc)
    j_clock.set_clock(prev_j)
    t_clock.set_clock(prev_t)


def _leased(svc, slot):
    counts = svc._state.flow.counts
    return np.asarray(counts)[slot, :, int(ClusterEvent.LEASED)]


def _run(pair, op, *args):
    jsvc, tsvc, _ = pair
    j = getattr(jsvc, op)(*args)
    t = getattr(tsvc, op)(*args)
    if dataclasses.is_dataclass(j):
        j, t = dataclasses.asdict(j), dataclasses.asdict(t)
    assert j == t, (op, args, j, t)
    assert jsvc.lease_stats() == tsvc.lease_stats(), op
    assert jsvc.outstanding_leases() == tsvc.outstanding_leases(), op
    assert_states_equal(jsvc._state, tsvc._state, f"{op}{args}")
    return t


def _advance(pair, ms):
    for c in pair[2]:
        c.advance(ms)


def test_lease_lifecycle_matches_reference(pair):
    jsvc, tsvc, _ = pair
    slot1 = tsvc._index.slot_of[1]
    g = _run(pair, "lease_grant", 1, 30)
    assert g["status"] == int(TokenStatus.OK) and g["tokens"] > 0
    # pulls see the LEASED charge
    ids = np.array([1] * 40 + [2] * 10)
    outs = [s.request_batch_arrays(ids) for s in (jsvc, tsvc)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert_states_equal(jsvc._state, tsvc._state, "pull after grant")
    # renew in the grant's bucket: the unused tokens come back there
    before = _leased(tsvc, slot1).copy()
    r = _run(pair, "lease_renew", g["lease_id"], 1, 3, 10)
    assert r["status"] == int(TokenStatus.OK)
    assert r["lease_id"] != g["lease_id"]
    diff = _leased(tsvc, slot1) - before
    assert diff.sum() == r["tokens"] - (g["tokens"] - 3)
    # renew 150 ms later: the credit goes to the grant's bucket, not now's
    _advance(pair, 150)
    before = _leased(tsvc, slot1).copy()
    r2 = _run(pair, "lease_renew", r["lease_id"], 1, 1, 5)
    diff = _leased(tsvc, slot1) - before
    assert sorted(int(x) for x in diff[diff != 0]) == sorted(
        [-(r["tokens"] - 1), r2["tokens"]])
    # return early, crediting the unused part
    _run(pair, "lease_return", r2["lease_id"], 2)
    _run(pair, "lease_return", r2["lease_id"], 2)  # idempotent
    # a lease renewed after its bucket was reused: the credit is dropped
    g3 = _run(pair, "lease_grant", 2, 8)
    _advance(pair, 1_050)
    _run(pair, "lease_renew", g3["lease_id"], 2, 0, 4)
    # TTL expiry: renewing an expired lease is a credit-less grant
    g4 = _run(pair, "lease_grant", 3, 6)
    _advance(pair, TTL_MS + 1)
    assert tsvc.lease_stats()["revoked"] >= 1
    _run(pair, "lease_renew", g4["lease_id"], 3, 0, 6)
    _run(pair, "lease_grant", 1, 10_000)  # headroom-capped
    ids = np.array([1, 2, 3, 4] * 12)
    outs = [s.request_batch_arrays(ids) for s in (jsvc, tsvc)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert_states_equal(jsvc._state, tsvc._state, "final pull")
    stats = tsvc.lease_stats()
    assert stats["granted"] >= 3 and stats["renewed"] >= 3
    assert stats["returned"] == 1


def test_refusals_match_reference(pair):
    cases = [
        (20, 5, TokenStatus.NOT_LEASABLE),  # shaped (warm-up) rule
        (7, 5, TokenStatus.NOT_LEASABLE),  # breaker-guarded
        (99, 5, TokenStatus.NO_RULE_EXISTS),
        (1, 0, TokenStatus.NOT_LEASABLE),  # nothing wanted
    ]
    for fid, want, status in cases:
        res = _run(pair, "lease_grant", fid, want)
        assert res["status"] == int(status), (fid, res)
    # drain flow 4's headroom with grants until it is refused
    for _ in range(12):
        res = _run(pair, "lease_grant", 4, 1_000)
    assert res["status"] == int(TokenStatus.NOT_LEASABLE)


def test_reload_revokes_dead_leases(pair):
    jsvc, tsvc, _ = pair
    keep = _run(pair, "lease_grant", 2, 5)
    dead = _run(pair, "lease_grant", 3, 5)
    for s, rule, mode in ((jsvc, JRule, JTM),
                          (tsvc, ClusterFlowRule, ThresholdMode)):
        s.load_rules([rule(**{**r, "mode": mode(r["mode"])})
                      for r in _flow_specs(drop=(3,))])
    assert jsvc.lease_stats() == tsvc.lease_stats()
    assert tsvc.lease_stats()["revoked"] == 1
    assert set(tsvc._leases) == {keep["lease_id"]}
    _run(pair, "lease_renew", keep["lease_id"], 2, 1, 5)
    _run(pair, "lease_renew", dead["lease_id"], 3, 1, 5)
