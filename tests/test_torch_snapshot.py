"""The HA snapshot across packages: a JAX primary's ``export_state`` restored
by the port's ``import_state``, and the reverse.

Each direction restores the primary's capture into two standbys, one of
each package, that loaded their rules in another order first (so every row
is remapped by flow_id, namespace and param rule). After the restore and
after each of the next pulls, reports and param requests, the standbys'
verdicts, report counts and param verdicts equal each other's and the
primary's, and the two standbys' state leaves (the outcome and breaker
planes included) and param sketches are bit-identical. A geometry mismatch
raises before anything mutates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    ControlBehavior as JCB,
    DegradeStrategy as JDS,
    ThresholdMode as JTM,
)

import torch_outcome_check as OC  # noqa: E402
from sentinel_tpu_torch import interop  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    ControlBehavior,
    DegradeRule,
    DegradeStrategy,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from torch_parity import assert_arrays_equal, assert_states_equal  # noqa: E402

KW = dict(max_flows=128, max_namespaces=4, batch_size=128)
PKW = dict(max_param_rules=8, width=128)
START_MS = 1_700_000_000_020
N_RULES = 60


def _ns(fid):
    return "default" if fid % 3 else "ns1"


FLOW = [dict(flow_id=fid, count=float(20 + fid % 30), mode=fid % 2,
             namespace=_ns(fid), control_behavior=(1 if fid % 17 == 5 else 0))
        for fid in range(N_RULES)]
DEGRADE = OC.degrade_specs(range(N_RULES), _ns)
PARAM = [dict(flow_id=fid, count=3.0, namespace=_ns(fid))
         for fid in (2, 5, 9)]


class Kind:
    def __init__(self, service, config, pconfig, rule, mode, behavior,
                 degrade, strategy, param_rule):
        self.__dict__.update(locals())

    def make(self, order=1):
        s = self.service(self.config(decide_impl="xla", **KW)
                         if self.service is JService
                         else self.config(**KW),
                         param_config=self.pconfig(**PKW),
                         **({} if self.service is JService
                            else {"device": "cpu"}),
                         fuse_depths=())
        s.load_rules([self.rule(**{**r, "mode": self.mode(r["mode"]),
                                   "control_behavior": self.behavior(
                                       r["control_behavior"])})
                      for r in FLOW[::order]])
        s.load_degrade_rules([self.degrade(**{**d, "strategy": self.strategy(
            d["strategy"])}) for d in DEGRADE[::order]])
        s.load_param_rules([self.param_rule(**p) for p in PARAM[::order]])
        return s


JAX = Kind(JService, JConfig, JParamConfig, JRule, JTM, JCB, JDegrade, JDS,
           JParamRule)
PORT = Kind(DefaultTokenService, EngineConfig, ParamConfig, ClusterFlowRule,
            ThresholdMode, ControlBehavior, DegradeRule, DegradeStrategy,
            ClusterParamFlowRule)


@pytest.fixture
def clocks():
    jc, tc = j_clock.ManualClock(START_MS), t_clock.ManualClock(START_MS)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    yield jc, tc
    j_clock.set_clock(prev_j)
    t_clock.set_clock(prev_t)


def _zipf(rng, n):
    w = np.arange(1, N_RULES + 6, dtype=np.float64) ** -1.1
    return np.minimum(np.searchsorted(np.cumsum(w / w.sum()), rng.random(n)),
                      N_RULES + 4).astype(np.int64)


def _traffic(services, clocks, rng, rounds, check):
    """Pulls, reports and param requests on every service; ``check`` after
    each operation gets each service's result."""
    for r in range(rounds):
        ids = _zipf(rng, 100)
        outs = [s.request_batch_arrays(ids) for s in services]
        check("pull", outs)
        admitted = ids[outs[0][0] == OC.OK]
        fl, rt, exc = OC.report_rows(rng, admitted, 120)
        check("report", [s.report_outcomes(fl, rt, exc) for s in services])
        hashes = [int(h) for h in rng.integers(0, 6, 3)]
        fid = int(rng.choice([2, 5, 9, 11]))
        check("param", [int(s.request_params_token(fid, 1, hashes).status)
                        for s in services])
        ms = int(rng.integers(60, 260))
        for c in clocks:
            c.advance(ms)


def _same(results):
    first = results[0]
    for other in results[1:]:
        if isinstance(first, tuple):
            for a, b in zip(first, other):
                np.testing.assert_array_equal(a, b)
        else:
            assert first == other


def _assert_standbys_equal(js, ts, label):
    assert_states_equal(js._state, ts._state, label)
    jp = interop.param_state_to_numpy(js._param_state)
    tp = interop.param_state_to_numpy(ts._param_state)
    for key in jp:
        assert_arrays_equal(jp[key], tp[key], f"{label}: param.{key}")
    assert js.breaker_stats() == ts.breaker_stats(), label
    assert js.outcome_stats()["flows"] == ts.outcome_stats()["flows"], label


@pytest.mark.parametrize("primary_kind", ["jax", "port"])
def test_snapshot_restores_across_packages(primary_kind, clocks):
    kinds = {"jax": JAX, "port": PORT}
    primary = kinds[primary_kind].make()
    rng = np.random.default_rng(3)
    _traffic([primary], clocks, rng, rounds=12, check=lambda k, o: None)
    stats = primary.breaker_stats()["flows"]
    assert {e["state_code"] for e in stats.values()} >= {0, 1}
    snap = primary.export_state()
    # standbys that loaded their rules in the reverse order
    js, ts = JAX.make(order=-1), PORT.make(order=-1)
    assert js._index.slot_of == ts._index.slot_of
    assert ts._index.slot_of != snap["slot_of"]
    for standby in (js, ts):
        standby.import_state(snap)
    _assert_standbys_equal(js, ts, "after the restore")
    assert ts.breaker_stats() == primary.breaker_stats()
    exported = ts.export_state()
    for key in ("flow", "occupy", "ns", "outcome", "shaping", "breaker",
                "param"):
        for leaf, arr in snap[key].items():
            assert np.asarray(exported[key][leaf]).dtype == np.asarray(
                arr).dtype, (key, leaf)

    def check(kind, outs):
        _same(outs)
        _assert_standbys_equal(js, ts, f"after a {kind}")

    _traffic([primary, js, ts], clocks, rng, rounds=5, check=check)


def test_geometry_mismatch_raises_before_mutating(clocks):
    primary = JAX.make()
    _traffic([primary], clocks, np.random.default_rng(4), rounds=2,
             check=lambda k, o: None)
    snap = primary.export_state()
    ts = DefaultTokenService(EngineConfig(**{**KW, "n_buckets": 5}),
                             param_config=ParamConfig(**PKW), device="cpu")
    ts.load_rules([ClusterFlowRule(flow_id=1, count=5.0)])
    before = interop.state_to_numpy(ts._state)
    rules_before = ts.current_rules()
    with pytest.raises(ValueError, match="geometry mismatch"):
        ts.import_state(snap)
    after = interop.state_to_numpy(ts._state)
    for key in before:
        assert_arrays_equal(before[key], after[key], key)
    assert ts.current_rules() == rules_before
    assert ts.current_degrade_rules() == []
    assert ts._epoch_ms is None
