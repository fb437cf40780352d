"""The port's local engine with cluster-mode rules answered by an embedded
token service (``cluster_api.set_embedded_server``), against the JAX
package's.

- The reference's ``tests/test_cluster.py::TestEmbeddedClusterFlow`` on the
  port: a cluster-mode ``FlowRule`` enforced by the embedded service, and the
  fall-back to the local rule when no service is installed; the same for a
  cluster-mode ``ParamFlowRule``.
- The seeded SDK stream of ``tests/torch_sdk_check.py`` (2,000 entries over
  200 resources: cluster-mode flow and param rules, warm-up, pacing,
  THREAD, degrade, system and authority rules, 8 origins, overlapping
  entries with business exceptions) through the JAX package's engine with a
  JAX service embedded and through the port's with a ``device="cpu"``
  service embedded, each on its own package's ``ManualClock``: every
  verdict and every node's counters equal, exactly; once with the native
  library's windows and once with numpy's (``SENTINEL_TPU_NATIVE=0``'s
  ``HostWindow``).
- A service that raises inside the cluster branch: the entry falls back to
  its local rule (the reference's contract, ``FlowRuleChecker.java:158-173``).
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import sentinel_tpu.local as j_local  # noqa: E402
from sentinel_tpu.cluster import api as j_api  # noqa: E402
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.param import ParamConfig as JParamConfig  # noqa: E402
from sentinel_tpu.engine.rules import ThresholdMode as JTM  # noqa: E402
from sentinel_tpu.local import chain as j_chain  # noqa: E402
from sentinel_tpu.local import context as j_context  # noqa: E402

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
import torch_sdk_check as SDK  # noqa: E402
import sentinel_tpu_torch.local as sentinel  # noqa: E402
from sentinel_tpu_torch.cluster import api as cluster_api  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.core.hashing import stable_param_hash  # noqa: E402
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.local import (  # noqa: E402
    BlockException,
    FlowRule,
    FlowRuleManager,
    ParamFlowException,
    ParamFlowRule,
    ParamFlowRuleManager,
)
from sentinel_tpu_torch.local import chain as t_chain  # noqa: E402
from sentinel_tpu_torch.local import context as t_context  # noqa: E402
from sentinel_tpu_torch.local import stat  # noqa: E402
from torch_ha_check import manual_clocks  # noqa: E402

CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=64)
G = ThresholdMode.GLOBAL
j_sph = importlib.import_module("sentinel_tpu.local.sph")
t_sph = importlib.import_module("sentinel_tpu_torch.local.sph")

# the SDK lockstep's geometry: 200 resources, every 6th in cluster mode
SDK_RESOURCES = 200
SDK_ENTRIES = 2000
SDK_PARAM_FLOWS = tuple(range(500, 516))


@pytest.fixture
def clocks():
    with manual_clocks() as pair:
        yield pair


@pytest.fixture(params=["native", "host"])
def windows(request, monkeypatch):
    monkeypatch.setattr(stat, "_NATIVE", request.param == "native")
    return request.param


@pytest.fixture
def clean(clocks, windows):
    sentinel.reset_for_tests()
    cluster_api.reset_for_tests()
    yield clocks[1]
    cluster_api.reset_for_tests()
    sentinel.reset_for_tests()


def _count(resource, n, args=()):
    ok = blocked = 0
    for _ in range(n):
        try:
            with sentinel.entry(resource, args=args):
                ok += 1
        except BlockException:
            blocked += 1
    return ok, blocked


class TestEmbeddedClusterFlow:
    """Local flow checker + cluster_mode rule through the embedded service
    (DefaultEmbeddedTokenServer shape)."""

    def test_cluster_verdict_enforced(self, clean):
        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules([ClusterFlowRule(flow_id=77, count=2.0, mode=G)])
        cluster_api.set_embedded_server(svc)
        FlowRuleManager.load_rules(
            [
                FlowRule(
                    resource="api", count=1000.0, cluster_mode=True,
                    cluster_config={"flow_id": 77},
                )
            ]
        )
        assert _count("api", 5) == (2, 3)

    def test_fallback_to_local_when_no_service(self, clean):
        # mode NOT_STARTED → cluster check falls back to local rule count
        FlowRuleManager.load_rules(
            [
                FlowRule(
                    resource="api2", count=3.0, cluster_mode=True,
                    cluster_config={"flow_id": 88},
                )
            ]
        )
        assert _count("api2", 5) == (3, 2)

    def test_param_verdict_enforced(self, clean):
        svc = DefaultTokenService(
            CFG, param_config=ParamConfig(max_param_rules=16, width=128),
            device="cpu")
        svc.load_param_rules([ClusterParamFlowRule(9, 2.0)])
        cluster_api.set_embedded_server(svc)
        ParamFlowRuleManager.load_rules([ParamFlowRule(
            resource="p", param_idx=0, count=1000.0, cluster_mode=True,
            cluster_config={"flow_id": 9})])
        assert _count("p", 4, args=("alice",)) == (2, 2)
        assert _count("p", 1, args=("bob",)) == (1, 0)
        # the service counted the value's stable hash
        r = svc.request_params_token(9, 1, [stable_param_hash("alice")])
        assert not r.ok
        with pytest.raises(ParamFlowException):
            sentinel.entry("p", args=("alice",))

    def test_raising_service_falls_back_to_the_local_rule(self, clean):
        class Raising(DefaultTokenService):
            def request_token(self, *a, **k):
                raise RuntimeError("device lost")

            def request_params_token(self, *a, **k):
                raise RuntimeError("device lost")

        cluster_api.set_embedded_server(Raising(CFG, device="cpu"))
        FlowRuleManager.load_rules([FlowRule(
            resource="api3", count=2.0, cluster_mode=True,
            cluster_config={"flow_id": 1})])
        ParamFlowRuleManager.load_rules([ParamFlowRule(
            resource="p2", param_idx=0, count=1.0, cluster_mode=True,
            cluster_config={"flow_id": 9})])
        assert _count("api3", 4) == (2, 2)
        assert _count("p2", 3, args=(7,)) == (1, 2)


def _jax_engine(lay):
    svc = JService(JConfig(max_flows=64, max_namespaces=4, batch_size=64),
                   param_config=JParamConfig(max_param_rules=16, width=128))
    svc.load_rules([JRule(f, 30.0, JTM.GLOBAL, control_behavior=beh)
                    for f, beh in _service_flows(lay)])
    svc.load_param_rules([JParamRule(pf, 3.0) for pf in SDK_PARAM_FLOWS])
    return svc


def _port_engine(lay):
    svc = DefaultTokenService(
        EngineConfig(max_flows=64, max_namespaces=4, batch_size=64),
        param_config=ParamConfig(max_param_rules=16, width=128),
        device="cpu")
    svc.load_rules([ClusterFlowRule(f, 30.0, G, control_behavior=beh)
                    for f, beh in _service_flows(lay)])
    svc.load_param_rules([ClusterParamFlowRule(pf, 3.0)
                          for pf in SDK_PARAM_FLOWS])
    return svc


def _service_flows(lay):
    # the cluster flows, one in 5 paced (SHOULD_WAIT verdicts) and one in 7
    # warming up
    return [(f, 2 if f % 5 == 4 else 1 if f % 7 == 6 else 0)
            for f in sorted(lay["cluster"].values())]


def _run(L, api, sph_mod, chain_mod, context_mod, svc, clock):
    L.reset_for_tests()
    api.reset_for_tests()
    api.set_embedded_server(svc)
    lay = SDK.layout(SDK_RESOURCES, range(SDK_RESOURCES), SDK_PARAM_FLOWS)
    SDK.load_rules(L, lay)
    steps = SDK.stream(np.random.default_rng(2024), lay, SDK_ENTRIES)
    try:
        verdicts = SDK.drive(L, sph_mod, steps, clock.now_ms, clock.advance)
        counters = SDK.node_counters(chain_mod, context_mod, clock.now_ms())
    finally:
        api.reset_for_tests()
        L.reset_for_tests()
    return verdicts, counters, clock.now_ms()


@pytest.fixture(scope="module")
def jax_sdk_run():
    """The JAX package's engine over the seeded stream (its windows are its
    own business: the reference)."""
    lay = SDK.layout(SDK_RESOURCES, range(SDK_RESOURCES), SDK_PARAM_FLOWS)
    with manual_clocks() as (jc, _):
        return _run(j_local, j_api, j_sph, j_chain, j_context,
                    _jax_engine(lay), jc)


class TestSdkLockstep:
    def test_every_verdict_and_counter_equals_the_reference(
            self, jax_sdk_run, windows):
        lay = SDK.layout(SDK_RESOURCES, range(SDK_RESOURCES), SDK_PARAM_FLOWS)
        calls = {"flow": 0, "param": 0}
        svc = _port_engine(lay)

        class Counted:
            # counts the cluster checks that reach the service
            def request_token(self, *a, **k):
                calls["flow"] += 1
                return svc.request_token(*a, **k)

            def request_params_token(self, *a, **k):
                calls["param"] += 1
                return svc.request_params_token(*a, **k)

            def close(self):
                svc.close()

        with manual_clocks() as (_, tc):
            got = _run(sentinel, cluster_api, t_sph, t_chain, t_context,
                       Counted(), tc)
        want = jax_sdk_run
        assert got[2] == want[2], "the engine clocks diverged"
        first = next((k for k, (a, b) in enumerate(zip(want[0], got[0]))
                      if a != b), None)
        assert first is None, (first, want[0][first], got[0][first])
        assert len(got[0]) == SDK_ENTRIES
        assert SDK.diff(want[1], got[1]) == []
        kinds = {v if v == "pass" else v[0] for v in got[0]}
        assert {"pass", "FlowException", "ParamFlowException",
                "DegradeException", "SystemBlockException",
                "AuthorityException"} <= kinds, kinds
        assert calls["flow"] > 100 and calls["param"] > 20, calls
