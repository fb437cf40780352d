"""The adapters and the data sources of both packages over one seeded HTTP
stream, against each other on the CPU.

- The stream of ``tests/torch_adapter_check.py`` at a small size (1,500
  requests over 150 routes, 256 cluster flows, 8 cluster param rules):
  a gateway in front of WSGI and ASGI middleware and ``@sentinel_resource``
  functions, every rule read from files by ``FileRefreshableDataSource``
  (the token service's flow rules through a property listener), a push of
  three files halfway. It runs through the JAX package's stack with a JAX
  ``DefaultTokenService`` embedded, and through the port's with a
  ``device="cpu"`` service embedded, each on its own package's
  ``ManualClock``, reading the same rule files: every response (status,
  headers, body) and every node's counters equal, exactly; the push
  advances each service's rule epoch by one and changes the pushed
  routes' answers. The port's run goes once on the native library's
  windows and once on numpy's ``HostWindow``.
- Converters: seeded rule sets of every kind through both packages'
  ``*_to_json`` give byte-equal texts, and each package's ``*_from_json``
  reads the other's text to equal fields.
- Rule-manager order: the cluster-mode param rule file and the gateway
  rule file loaded in both orders leave the same param rules in both
  packages, and the user's param rule survives
  ``GatewayRuleManager.load_rules`` (``gateway.py:217-226``).
- A flow rule file's ``clusterConfig`` in the keys the local engine reads
  gets the service's verdict; in the upstream's camelCase, the local
  rule's, in both packages alike.
"""

import dataclasses
import enum

import numpy as np
import pytest

pytest.importorskip("torch")

from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.param import ParamConfig as JParamConfig  # noqa: E402

import torch_adapter_check as AC  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
import torch_sdk_check as SDK  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.local import stat  # noqa: E402
from torch_ha_check import manual_clocks  # noqa: E402

J = AC.package("sentinel_tpu")
T = AC.package("sentinel_tpu_torch")

ROUTES = 150
REQUESTS = 1500
FLOWS = 256
NS = 4
PARAM_FLOWS = tuple(range(500, 508))
KW = dict(max_flows=FLOWS, max_namespaces=NS, batch_size=64)
PKW = dict(max_param_rules=16, width=128)
SEED = 2027


def _lay():
    rng = np.random.default_rng(SEED)
    return AC.layout(ROUTES, rng.permutation(FLOWS), PARAM_FLOWS)


def _jax_service():
    svc = JService(JConfig(**KW), param_config=JParamConfig(**PKW))
    svc.load_param_rules([JParamRule(pf, 1.0 + k % 3)
                          for k, pf in enumerate(PARAM_FLOWS)])
    return svc


def _port_service():
    svc = DefaultTokenService(EngineConfig(**KW),
                              param_config=ParamConfig(**PKW), device="cpu")
    svc.load_param_rules([ClusterParamFlowRule(pf, 1.0 + k % 3)
                          for k, pf in enumerate(PARAM_FLOWS)])
    return svc


class Counted:
    """The embedded service, counting the cluster checks that reach it."""

    def __init__(self, svc):
        self.svc = svc
        self.calls = {"flow": 0, "param": 0}

    def request_token(self, *a, **k):
        self.calls["flow"] += 1
        return self.svc.request_token(*a, **k)

    def request_params_token(self, *a, **k):
        self.calls["param"] += 1
        return self.svc.request_params_token(*a, **k)

    def close(self):
        self.svc.close()


def _run(P, svc, clock, rule_dir):
    lay = _lay()
    docs = AC.rule_docs(lay, FLOWS, NS)
    steps = AC.stream(np.random.default_rng(SEED + 1), lay, REQUESTS)
    after = AC.push(docs, lay, steps, np.random.default_rng(SEED + 2))
    AC.reset(P)
    # the failure counters are the process's: other tests count into them
    P.base.reset_refresh_failures_for_tests()
    counted = Counted(svc)
    P.api.set_embedded_server(counted)
    epochs = []
    try:
        AC.write_rules(P, rule_dir, docs)
        srcs = AC.open_sources(
            P, rule_dir, lambda rules: svc.load_rules(rules, ns_max_qps=1e9))
        stacks = AC.build_stacks(P, lay)

        def at_half():
            AC.write_rules(P, rule_dir, after, AC.PUSHED_FILES)
            before = svc.state_generation()
            AC.refresh(srcs, AC.PUSHED_FILES)
            epochs.append(svc.state_generation() - before)

        responses = AC.drive(stacks, steps, clock.advance, at_half)
        counters = SDK.node_counters(P.chain, P.context, clock.now_ms())
        failures = P.base.refresh_failure_totals()
    finally:
        AC.reset(P)
    return dict(responses=responses, counters=counters, calls=counted.calls,
                epochs=epochs, failures=failures, end_ms=clock.now_ms(),
                lay=lay, steps=steps, docs=docs, after=after)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    rule_dir = str(tmp_path_factory.mktemp("adapter_rules"))
    with manual_clocks() as (jc, _):
        return rule_dir, _run(J, _jax_service(), jc, rule_dir)


@pytest.fixture(params=["native", "host"])
def windows(request, monkeypatch):
    monkeypatch.setattr(stat, "_NATIVE", request.param == "native")
    return request.param


def test_stream_equals_the_reference(jax_run, windows):
    rule_dir, want = jax_run
    with manual_clocks() as (_, tc):
        got = _run(T, _port_service(), tc, rule_dir)
    assert got["end_ms"] == want["end_ms"], "the engine clocks diverged"
    first = next((k for k, (a, b) in enumerate(zip(want["responses"],
                                                   got["responses"]))
                  if a != b), None)
    assert first is None, (first, want["responses"][first],
                           got["responses"][first])
    assert len(got["responses"]) == REQUESTS
    assert SDK.diff(want["counters"], got["counters"]) == []
    assert got["calls"] == want["calls"]
    assert got["epochs"] == want["epochs"] == [1]
    assert got["failures"] == want["failures"] == {}
    lay, steps = got["lay"], got["steps"]
    kinds = AC.tally(lay, steps, got["responses"])
    for kind in ("200", "429", "500", "blocked:ParamFlowException",
                 "blocked:DegradeException"):
        assert kinds.get(kind, 0) > 0, kinds
    assert got["calls"]["flow"] > 50 and got["calls"]["param"] > 50, \
        got["calls"]
    # the push changed the pushed routes' answers
    pushed = set(AC.pushed_routes(lay, got["docs"], got["after"]))
    half = REQUESTS // 2
    before = AC.tally(lay, steps[:half], got["responses"][:half], pushed)
    after = AC.tally(lay, steps[half:], got["responses"][half:], pushed)
    assert after.get("429", 0) > before.get("429", 0), (before, after)
    # the API definition the push added matched requests
    nodes = [k for k in got["counters"] if AC.PUSHED_API in k]
    assert nodes, "the pushed API definition matched no request"


# -- converters ---------------------------------------------------------------

def _rule_docs(rng):
    lay = AC.layout(60, rng.permutation(200), (7, 8, 9))
    docs = AC.rule_docs(lay, 200, 3)
    docs["system"] = [{"highestSystemLoad": float(rng.integers(1, 9)),
                       "highestCpuUsage": round(float(rng.random()), 3),
                       "qps": float(rng.integers(10, 999)), "avgRt": -1.0,
                       "maxThread": float(rng.integers(1, 50))}
                      for _ in range(3)]
    docs["param"][0]["paramFlowItemList"] = [
        {"object": str(v), "count": float(c)}
        for v, c in zip(rng.integers(0, 99, 4), rng.integers(1, 9, 4))]
    return docs


CONVERTERS = ("flow", "param", "degrade", "authority", "system", "gateway",
              "cluster")


def _fields(obj):
    """A rule as plain values (enums by value), to compare across the two
    packages' classes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if not f.name.startswith("_")}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    return obj


@pytest.mark.parametrize("kind", CONVERTERS)
@pytest.mark.parametrize("seed", [3, 4])
def test_converters_are_byte_equal(kind, seed):
    import json

    text = json.dumps(_rule_docs(np.random.default_rng(seed))[kind])
    name = "cluster_flow" if kind == "cluster" else \
        "gateway_flow" if kind == "gateway" else \
        "param_flow" if kind == "param" else kind
    j_from = getattr(J.conv, f"{name}_rules_from_json")
    t_from = getattr(T.conv, f"{name}_rules_from_json")
    j_to = getattr(J.conv, f"{name}_rules_to_json")
    t_to = getattr(T.conv, f"{name}_rules_to_json")
    j_rules, t_rules = j_from(text), t_from(text)
    assert _fields(j_rules) == _fields(t_rules)
    j_text, t_text = j_to(j_rules), t_to(t_rules)
    assert j_text == t_text
    # each package reads the other's text to equal fields
    assert _fields(t_from(j_text)) == _fields(j_rules)
    assert _fields(j_from(t_text)) == _fields(t_rules)


def test_api_definitions_round_trip_byte_equal():
    import json

    docs = AC.api_definitions(40)
    texts = [json.dumps([P.gateway_api.api_definition_to_dict(
        P.gateway_api.parse_api_definition(d)) for d in docs])
        for P in (J, T)]
    assert texts[0] == texts[1] == json.dumps(docs)


# -- rule-manager order -------------------------------------------------------

def _param_rules(P):
    return {res: sorted((_fields(r) for r in lst),
                        key=lambda d: (d["param_idx"], d["count"]))
            for res, lst in P.L.ParamFlowRuleManager.all_rules().items()}


@pytest.mark.parametrize("order", [("param", "gateway"),
                                   ("gateway", "param")])
def test_param_rule_survives_the_gateway_load(order, tmp_path):
    lay = AC.layout(30, range(5), (7, 8))
    docs = AC.rule_docs(lay, 5, 1)
    got = []
    for P in (J, T):
        AC.reset(P)
        try:
            AC.write_rules(P, str(tmp_path), docs, ("param", "gateway"))
            srcs = {
                "param": P.file.FileRefreshableDataSource(
                    str(tmp_path / "param.json"),
                    P.conv.param_flow_rules_from_json),
                "gateway": P.file.FileRefreshableDataSource(
                    str(tmp_path / "gateway.json"),
                    P.conv.gateway_flow_rules_from_json),
            }
            P.L.ParamFlowRuleManager.register_property(
                srcs["param"].property)
            srcs["gateway"].property.listen(
                lambda rules, P=P:
                P.gateway.GatewayRuleManager.load_rules(rules or []))
            AC.refresh(srcs, order)
            got.append(_param_rules(P))
        finally:
            AC.reset(P)
    assert got[0] == got[1]
    rules = got[1]
    # the user's cluster-mode param rules survive in either order
    for k, pf in enumerate((7, 8)):
        assert rules[f"biz{k}"][0]["cluster_mode"] is True
        assert rules[f"biz{k}"][0]["cluster_config"]["flow_id"] == pf
    gateway_owned = {d["resource"] for d in docs["gateway"]}
    if order == ("param", "gateway"):
        assert gateway_owned <= set(rules)
    else:
        # a param file loaded after the gateway's replaces the gateway's
        # generated rules, as in the reference
        assert not gateway_owned & set(rules)


@pytest.mark.parametrize("keys", ["snake", "camel"])
def test_cluster_config_keys_of_a_flow_rule_file(keys, tmp_path):
    """The local engine reads ``flow_id`` from a rule's ``clusterConfig``,
    which the converter passes through as the file has it: a file in the
    upstream's camelCase (``flowId``) gets no cluster verdict, and the
    entry falls back to its local rule, in both packages alike."""
    import json

    cfg = ({"flow_id": 5, "fallback_to_local_when_fail": True}
           if keys == "snake" else
           {"flowId": 5, "fallbackToLocalWhenFail": True})
    (tmp_path / "flow.json").write_text(json.dumps([{
        "resource": "checkout", "count": 4.0, "clusterMode": True,
        "clusterConfig": cfg}]))
    got = []
    with manual_clocks() as (jc, tc):
        for P, svc in ((J, _jax_service()), (T, _port_service())):
            AC.reset(P)
            try:
                svc.load_rules(P.conv.cluster_flow_rules_from_json(
                    json.dumps([{"flowId": 5, "count": 2.0,
                                 "thresholdType": 1}])))
                counted = Counted(svc)
                P.api.set_embedded_server(counted)
                src = P.file.FileRefreshableDataSource(
                    str(tmp_path / "flow.json"), P.conv.flow_rules_from_json)
                P.L.FlowRuleManager.register_property(src.property)
                AC.refresh({"flow": src}, ("flow",))
                passed = 0
                for _ in range(6):
                    try:
                        with P.L.entry("checkout"):
                            passed += 1
                    except P.L.BlockException:
                        pass
                got.append((passed, dict(counted.calls)))
            finally:
                AC.reset(P)
    assert got[0] == got[1]
    if keys == "snake":
        assert got[1] == (2, {"flow": 6, "param": 0})  # the service's count
    else:
        assert got[1] == (4, {"flow": 0, "param": 0})  # the local rule's
