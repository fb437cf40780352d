"""Shared kit of the HA tests: one rule set and one seeded stream of pulls,
reports and param requests, built in either package.

``JAX`` and ``PORT`` make a ``DefaultTokenService`` of their package at the
tests' small size (``max_flows=128``, ``batch_size=128``,
``max_param_rules=8``, ``width=128``) with 60 flow rules (both threshold
modes, a few shaped, two namespaces), every flow's breaker
(``torch_outcome_check.degrade_specs``) and three param rules; ``order=-1``
loads every rule list reversed, so the slots differ and every row a
snapshot or delta carries is remapped. ``traffic`` drives services in
lockstep and hands each operation's results to a check. The tests install
both packages' ``ManualClock`` (``manual_clocks``) and advance them
together.
"""

import contextlib

import numpy as np

from sentinel_tpu.cluster.token_service import (
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock
from sentinel_tpu.engine import ClusterFlowRule as JRule
from sentinel_tpu.engine import DegradeRule as JDegrade
from sentinel_tpu.engine import EngineConfig as JConfig
from sentinel_tpu.engine.param import ParamConfig as JParamConfig
from sentinel_tpu.engine.rules import (
    ControlBehavior as JCB,
    DegradeStrategy as JDS,
    ThresholdMode as JTM,
)

import torch_outcome_check as OC
from sentinel_tpu_torch import interop
from sentinel_tpu_torch.cluster.token_service import (
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock
from sentinel_tpu_torch.engine import (
    ClusterFlowRule,
    ControlBehavior,
    DegradeRule,
    DegradeStrategy,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.param import ParamConfig
from torch_parity import assert_arrays_equal, assert_states_equal
from torch_repl_check import flow_rows_diff

KW = dict(max_flows=128, max_namespaces=4, batch_size=128)
PKW = dict(max_param_rules=8, width=128)
START_MS = 1_700_000_000_020
N_RULES = 60
PARAM_FLOWS = (2, 5, 9)


def _ns(fid):
    return "default" if fid % 3 else "ns1"


FLOW = [dict(flow_id=fid, count=float(20 + fid % 30), mode=fid % 2,
             namespace=_ns(fid), control_behavior=(1 if fid % 17 == 5 else 0))
        for fid in range(N_RULES)]
DEGRADE = OC.degrade_specs(range(N_RULES), _ns)
PARAM = [dict(flow_id=fid, count=3.0, namespace=_ns(fid))
         for fid in PARAM_FLOWS]


class Kind:
    """One package's service, rule and config classes."""

    def __init__(self, name, service, config, pconfig, rule, mode, behavior,
                 degrade, strategy, param_rule):
        self.__dict__.update(locals())

    def make(self, order=1, rules=True, **pkw):
        """A service with the kit's rules (loaded in ``order``), or none
        (``rules=False``: a cold standby); ``pkw`` overrides the param
        config (``sketch``, ``slim_width``)."""
        s = self.service(self.config(decide_impl="xla", **KW)
                         if self.service is JService
                         else self.config(**KW),
                         param_config=self.pconfig(**{**PKW, **pkw}),
                         **({} if self.service is JService
                            else {"device": "cpu"}),
                         fuse_depths=())
        if not rules:
            return s
        s.load_rules([self.rule(**{**r, "mode": self.mode(r["mode"]),
                                   "control_behavior": self.behavior(
                                       r["control_behavior"])})
                      for r in FLOW[::order]])
        s.load_degrade_rules([self.degrade(**{**d, "strategy": self.strategy(
            d["strategy"])}) for d in DEGRADE[::order]])
        s.load_param_rules([self.param_rule(**p) for p in PARAM[::order]])
        return s


JAX = Kind("jax", JService, JConfig, JParamConfig, JRule, JTM, JCB, JDegrade,
           JDS, JParamRule)
PORT = Kind("port", DefaultTokenService, EngineConfig, ParamConfig,
            ClusterFlowRule, ThresholdMode, ControlBehavior, DegradeRule,
            DegradeStrategy, ClusterParamFlowRule)
KINDS = {"jax": JAX, "port": PORT}


@contextlib.contextmanager
def manual_clocks(start_ms=START_MS):
    """Both packages' ``ManualClock`` at ``start_ms``, as ``(jax, port)``."""
    jc, tc = j_clock.ManualClock(start_ms), t_clock.ManualClock(start_ms)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    try:
        yield jc, tc
    finally:
        j_clock.set_clock(prev_j)
        t_clock.set_clock(prev_t)


def zipf(rng, n):
    """Bounded-Zipf flow ids over the rules and five ids without one."""
    w = np.arange(1, N_RULES + 6, dtype=np.float64) ** -1.1
    return np.minimum(np.searchsorted(np.cumsum(w / w.sum()), rng.random(n)),
                      N_RULES + 4).astype(np.int64)


def traffic(services, clocks, rng, rounds, check):
    """Pulls, reports and param requests on every service; ``check`` after
    each operation gets each service's result."""
    for r in range(rounds):
        ids = zipf(rng, 100)
        outs = [s.request_batch_arrays(ids) for s in services]
        check("pull", outs)
        admitted = ids[outs[0][0] == OC.OK]
        fl, rt, exc = OC.report_rows(rng, admitted, 120)
        check("report", [s.report_outcomes(fl, rt, exc) for s in services])
        hashes = [int(h) for h in rng.integers(0, 6, 3)]
        fid = int(rng.choice([*PARAM_FLOWS, 11]))
        check("param", [int(s.request_params_token(fid, 1, hashes).status)
                        for s in services])
        ms = int(rng.integers(60, 260))
        for c in clocks:
            c.advance(ms)


def same(results):
    first = results[0]
    for other in results[1:]:
        if isinstance(first, tuple):
            for a, b in zip(first, other):
                np.testing.assert_array_equal(a, b)
        else:
            assert first == other


def assert_standbys_equal(js, ts, label):
    """Every state leaf, the param sketch and the breaker and outcome reads
    of two services with the same slot assignment."""
    assert_states_equal(js._state, ts._state, label)
    jp = interop.param_state_to_numpy(js._param_state)
    tp = interop.param_state_to_numpy(ts._param_state)
    for key in jp:
        assert_arrays_equal(jp[key], tp[key], f"{label}: param.{key}")
    assert js.breaker_stats() == ts.breaker_stats(), label
    assert js.outcome_stats()["flows"] == ts.outcome_stats()["flows"], label


def assert_flow_rows_equal(primary, standby, label):
    """Every per-flow row (flow, occupy, outcome, shaping, breaker), every
    namespace row and the rings' starts of ``standby`` equal ``primary``'s,
    matched by flow_id and namespace name (the slots may differ)."""
    bad = flow_rows_diff(primary, standby)
    assert not bad, f"{label}: {bad}"
