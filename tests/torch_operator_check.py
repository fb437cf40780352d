"""The seeded operator workload: what an operator (a dashboard, Prometheus,
a rule datasource) does to a process that runs ``<package>``'s command
center, and how two such runs are compared.

Shared by ``chip_smoke.py`` (phase 16: the port's command center driving a
token server on the card, against its torch-ops twin) and
``tests/test_torch_operator_parity.py`` (the JAX package's command center
against the port's on the CPU). Imports numpy and the standard library
only: :func:`package` imports the modules of the package it is named.

- :class:`FakeDashboard`: a local HTTP server standing in for the
  dashboard's ``/registry/machine`` (it records every heartbeat).
- :func:`http`: one request to a local command center or exporter.
- :func:`normalize`: a command response as canonical JSON without the
  fields that carry a time, a pid, a host name or a port
  (:data:`VOLATILE_KEYS`).
- :func:`series`: an exposition's lines without the families that measure
  host durations or name the build (:data:`EXCLUDED_FAMILIES`).
- :func:`plan`: the seeded traffic of phase 16a: bounded-Zipf (alpha 1.1)
  pulls of ``rows`` rows over every flow id, a PARAM_FLOW request a step on
  the param rules with Zipf values over 200,000
  (``ClusterParamMetric.java:37``), a report of the admitted rows every
  10th step; :func:`schedule` spreads the commands (:data:`SCHEDULE`)
  over the steps.
- :func:`pushed`: a namespace's rules as ``cluster/server/flowRules``
  returned them, every count changed (:func:`pushed_count`), and the flows
  the next pull probes with :data:`PROBE_ROWS` rows each.
- :func:`command_plan`: the seeded command sequence of the cross-package
  test: rule CRUD on every rule type, gateway API definitions,
  ``setClusterMode`` and the ``cluster/server/*`` commands, with pulls in
  between (:data:`PARITY_PULL`).
- :func:`reset`: every process-global registry a run reads, cleared.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ALPHA = 1.1
VALUES = 200_000
PROBES = 8  # flows of a pushed namespace that the next pull probes
PROBE_ROWS = 8  # rows of each: all pass at the old counts (100 and up)
REPORT_EVERY = 10

# fields that carry a time, a pid, a host name or a port ("clients" lists
# the connected clients' addresses)
VOLATILE_KEYS = frozenset({
    "currentTime", "pid", "hostname", "port", "wall_ms", "clients",
})

# exposition families that measure host durations (histograms of stage,
# decision and move times, and the burn rates read off them) or name the
# build and the process's age; every other series must be equal
EXCLUDED_FAMILIES = (
    "sentinel_build_info",
    "sentinel_server_uptime_seconds",
    "sentinel_server_verdicts_per_sec",  # a rate over host time
    "sentinel_server_queue_wait_ms",
    "sentinel_server_decide_ms",
    "sentinel_server_write_ms",
    "sentinel_server_intake_ms",
    "sentinel_server_dispatch_ms",
    "sentinel_server_overlap_saved_ms_total",
    "sentinel_server_shard_intake_busy_ms_total",
    "sentinel_push_staleness_ms",
    "sentinel_rebalance_move_duration_ms",
    "sentinel_slo_latency_ms",
    "sentinel_slo_burn_rate",  # read off the decision latencies
)

# phase 16a's commands: (share of the steps, action); each runs after the
# step's pull, param request and entries
SCHEDULE = (
    (0.10, ("push", 1)), (0.20, ("push", 5)), (0.245, ("scrape",)),
    (0.25, ("metrics",)), (0.30, ("param",)), (0.40, ("push", 9)),
    (0.495, ("scrape",)), (0.50, ("flow_config",)),
    (0.55, ("namespace_set",)), (0.60, ("push", 13)), (0.745, ("scrape",)),
    (0.75, ("move",)), (0.85, ("metrics",)), (1.0, ("scrape",)),
)


def schedule(steps: int) -> Dict[int, List[tuple]]:
    """:data:`SCHEDULE` over ``steps`` steps: step index → its actions."""
    out: Dict[int, List[tuple]] = {}
    for share, act in SCHEDULE:
        out.setdefault(min(steps - 1, int(share * steps)), []).append(act)
    return out


def package(name: str) -> SimpleNamespace:
    """The modules of the package ``name`` that the workload drives."""
    import importlib

    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    return SimpleNamespace(
        init=m("init"), H=m("transport.handlers"),
        command=m("transport.command"), assign=m("cluster.assign"),
        manager=m("ha.manager"), api=m("cluster.api"),
        config=m("core.config"), file=m("datasource.file"),
        base=m("datasource.base"), L=m("local"), log=m("metrics.log"),
        exporter=m("metrics.exporter"), server=m("metrics.server"),
        ha=m("metrics.ha"), extension=m("metrics.extension"),
        client=m("cluster.client"), namespaces=m("cluster.namespaces"),
        gateway=m("adapters.gateway"), gateway_api=m("adapters.gateway_api"))


def reset(P) -> None:
    """Clear every process-global registry a run reads and writes."""
    P.assign.reset_for_tests()
    if P.H._EMBEDDED_SERVER["server"] is not None:
        P.H.apply_cluster_mode(-1)
    P.H._CLUSTER_CLIENT_CONFIG.clear()
    P.api.reset_for_tests()
    P.L.reset_for_tests()
    P.gateway.GatewayRuleManager.reset_for_tests()
    P.gateway_api.GatewayApiDefinitionManager.reset_for_tests()
    P.server.reset_server_metrics_for_tests()
    P.ha.reset_ha_metrics_for_tests()
    P.extension.clear_extensions_for_tests()
    P.exporter._ensure_counters_registered()  # its totals from zero
    P.client.reset_client_metrics_for_tests()
    P.namespaces.reset_snapshot_errors_for_tests()
    P.namespaces.reset_move_dedup_for_tests()
    P.base.reset_refresh_failures_for_tests()


class FakeDashboard:
    """The dashboard's ``POST /registry/machine``, on 127.0.0.1: records
    each heartbeat's JSON body and answers 200."""

    def __init__(self):
        beats = self.beats = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n).decode()
                if self.path.rstrip("/") == "/registry/machine":
                    beats.append(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "FakeDashboard":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def http(port: int, path: str, body: Optional[str] = None,
         timeout: float = 600.0) -> Tuple[int, str]:
    """(status, text) of one request to ``127.0.0.1:port/path``: a POST
    when ``body`` is given. An error status is returned, not raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}",
        data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as rsp:
            return rsp.status, rsp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in VOLATILE_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def normalize(text: str) -> str:
    """Canonical JSON of a response without :data:`VOLATILE_KEYS`; a text
    response as it is."""
    try:
        obj = json.loads(text)
    except ValueError:
        return text
    return json.dumps(_strip(obj), sort_keys=True)


def family(line: str) -> str:
    """The family a sample, HELP or TYPE line belongs to."""
    if line.startswith("# HELP ") or line.startswith("# TYPE "):
        return line.split(" ")[2]
    name = line.split("{")[0].split(" ")[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def series(text: str,
           excluded: Sequence[str] = EXCLUDED_FAMILIES) -> List[str]:
    """The exposition's lines, those of ``excluded`` families left out."""
    drop = set(excluded)
    return [ln for ln in text.splitlines()
            if ln and family(ln) not in drop]


def first_difference(a: Sequence, b: Sequence) -> Optional[str]:
    for k, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"item {k}: {str(x)[:300]!r} != {str(y)[:300]!r}"
    if len(a) != len(b):
        return f"lengths {len(a)} != {len(b)}"
    return None


def _zipf_cdf(n: int, alpha: float = ALPHA) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return np.cumsum(w / w.sum())


def zipf(rng: np.random.Generator, ranks: np.ndarray, cdf: np.ndarray,
         n: int) -> np.ndarray:
    pos = np.minimum(np.searchsorted(cdf, rng.random(n)), cdf.size - 1)
    return ranks[pos]


def plan(rng: np.random.Generator, flows: int, param_flows: Sequence[int],
         steps: int, rows: int, value_hash) -> List[dict]:
    """``steps`` seeded steps: a ``rows``-row pull of bounded-Zipf flow ids,
    one PARAM_FLOW request (flow, acquire 1, four Zipf values' hashes by
    ``value_hash(flow_ids, values)``), the completion of the admitted rows
    every :data:`REPORT_EVERY` th step (RT 1-200 ms, 2% exceptions), and
    1-3 ms of clock before the step."""
    ranks = rng.permutation(flows).astype(np.int64)
    cdf = _zipf_cdf(flows)
    value_ranks = rng.permutation(VALUES)
    value_cdf = _zipf_cdf(VALUES)
    out = []
    for k in range(steps):
        fid = int(param_flows[int(rng.integers(0, len(param_flows)))])
        values = zipf(rng, value_ranks, value_cdf, 4)
        out.append(dict(
            dt=int(rng.integers(1, 4)),
            ids=zipf(rng, ranks, cdf, rows),
            param=(fid, [int(h) for h in value_hash(
                np.full(values.size, fid, np.int64), values)]),
            report=(k % REPORT_EVERY == REPORT_EVERY - 1),
            rt=rng.integers(1, 201, rows).astype(np.int32),
            exc=rng.random(rows) < 0.02,
        ))
    return out


def pushed_count(flow_id: int) -> float:
    """A pushed rule's new count: 1-4 a second (its old one is 100-199)."""
    return float(1 + flow_id % 4)


def pushed(rules: List[dict]) -> Tuple[List[dict], List[int]]:
    """``rules`` (``cluster/server/flowRules``' answer for one namespace)
    with every count changed, and the :data:`PROBES` flows without traffic
    shaping that the next pull probes."""
    out = [dict(r, count=pushed_count(int(r["flowId"]))) for r in rules]
    plain = sorted(int(r["flowId"]) for r in rules
                   if int(r.get("controlBehavior", 0)) == 0)
    return out, plain[:PROBES]


def probe_rows(probes: Sequence[int]) -> np.ndarray:
    return np.repeat(np.asarray(probes, np.int64), PROBE_ROWS)


def probe_admitted(ids: np.ndarray, status: np.ndarray,
                   probes: Sequence[int], ok: int) -> Dict[int, int]:
    """Rows of each probed flow the pull admitted."""
    return {int(f): int(((ids == f) & (status == ok)).sum()) for f in probes}


# -- the cross-package command sequence --------------------------------------
PARITY_FLOWS = 48  # cluster flow rules of the CPU service, 4 namespaces
PARITY_PULL = 64  # rows of a pull between commands


def parity_flow_rules(rng: np.random.Generator) -> List[dict]:
    """The token server's rules as ``cluster/server/modifyFlowRules``
    bodies, by namespace: counts 2-9, every 7th paced, every 11th warm-up."""
    out = []
    for i in range(PARITY_FLOWS):
        d = {"flowId": 100 + i, "count": float(rng.integers(2, 10)),
             "thresholdType": 1}
        if i % 7 == 3:
            d.update(controlBehavior=2, warmUpPeriodSec=10, coldFactor=3,
                     maxQueueingTimeMs=500)
        elif i % 11 == 5:
            d.update(controlBehavior=1, warmUpPeriodSec=2, coldFactor=3,
                     maxQueueingTimeMs=500)
        out.append(d)
    return out


def command_plan(rng: np.random.Generator) -> List[tuple]:
    """``(kind, path, body)`` steps: ``("cmd", path, body-or-None)`` is one
    command; ``("pull", n, None)`` is ``n`` rows pulled from the embedded
    service in process; ``("advance", ms, None)`` moves both clocks."""
    flow = [{"resource": f"res{i}", "count": float(2 + i % 5), "grade": 1,
             "limitApp": "default"} for i in range(6)]
    flow[2].update(controlBehavior=1, warmUpPeriodSec=10)
    degrade = [{"resource": "res1", "grade": 2, "count": 3,
                "timeWindow": 10, "minRequestAmount": 5,
                "statIntervalMs": 1000}]
    system = [{"qps": 500.0}]
    authority = [{"resource": "res3", "limitApp": "app1,app2",
                  "strategy": 0}]
    param = [{"resource": "res4", "count": 5, "paramIdx": 0,
              "paramFlowItemList": [{"object": "7", "count": 1,
                                     "classType": "int"}]}]
    gateway = [{"resource": "route-a", "count": 4, "intervalSec": 1,
                "grade": 1},
               {"resource": "prod-api", "resourceMode": 1, "count": 9,
                "intervalSec": 1, "paramItem": {"parseStrategy": 0}}]
    apis = [{"apiName": "prod-api", "predicateItems": [
        {"pattern": "/product/", "matchStrategy": 1},
        {"pattern": "/item/**", "matchStrategy": 2}]}]
    rules = parity_flow_rules(rng)
    by_ns: Dict[str, List[dict]] = {}
    for i, d in enumerate(rules):
        by_ns.setdefault(f"pns{i % 4}", []).append(d)
    steps: List[tuple] = [
        ("cmd", "version", None), ("cmd", "basicInfo", None),
        ("cmd", "getClusterMode", None),
        ("cmd", "getSwitch", None),
    ]
    for rtype, body in (("flow", flow), ("degrade", degrade),
                        ("system", system), ("authority", authority),
                        ("paramFlow", param), ("gateway", gateway)):
        steps.append(("cmd", f"setRules?type={rtype}", json.dumps(body)))
        steps.append(("cmd", f"getRules?type={rtype}", None))
    steps += [
        ("cmd", "gateway/updateApiDefinitions", json.dumps(apis)),
        ("cmd", "gateway/getApiDefinitions", None),
        ("cmd", "setRules?type=nonsense", "[]"),
        ("cmd", "cluster/server/info", None),  # not a server yet
        ("cmd", "setClusterMode?mode=1&tokenPort=0", None),
        ("cmd", "getClusterMode", None),
    ]
    for ns in sorted(by_ns):
        steps.append(("cmd", f"cluster/server/modifyFlowRules?namespace={ns}",
                      json.dumps(by_ns[ns])))
    steps += [
        ("cmd", "cluster/server/modifyParamRules?namespace=pns0",
         json.dumps([{"flowId": 100, "count": 3,
                      "itemThresholds": [[77, 1.0]]},
                     {"flowId": 104, "count": 2}])),
        ("cmd", "cluster/server/flowRules?namespace=pns1", None),
        ("cmd", "cluster/server/paramRules", None),
        ("cmd", "cluster/server/fetchConfig", None),
    ]
    for k in range(6):
        steps.append(("advance", int(rng.integers(20, 400)), None))
        steps.append(("pull", PARITY_PULL, None))
        if k == 1:
            steps.append(("cmd", "cluster/server/modifyFlowConfig",
                          json.dumps({"maxAllowedQps": 2000})))
            steps.append(("cmd", "cluster/server/modifyFlowConfig",
                          json.dumps({"sampleCount": 4})))
        if k == 2:
            ns = "pns2"
            changed = [dict(d, count=1.0) for d in by_ns[ns]]
            steps.append(("cmd",
                          f"cluster/server/modifyFlowRules?namespace={ns}",
                          json.dumps(changed)))
        if k == 3:
            steps.append(("cmd", "cluster/server/modifyNamespaceSet",
                          json.dumps(["pns0", "pns1", "extra"])))
        steps.append(("cmd", "cluster/server/metrics", None))
        steps.append(("cmd", "cluster/server/metricList?namespace=pns1",
                      None))
    steps += [
        ("cmd", "cluster/server/info", None),
        ("cmd", "cluster/server/snapshot?action=fetch", None),
        ("cmd", "cluster/server/snapshot?action=save", None),  # no dir
        ("cmd", "cluster/server/promote?action=status", None),
        ("cmd", "cluster/server/modifyFlowRules", "[]"),  # no namespace
        ("cmd", "setClusterMode?mode=-1", None),
        ("cmd", "cluster/server/info", None),
        ("cmd", "cluster/server/metrics", None),
        ("cmd", "setSwitch?value=false", None),
        ("cmd", "getSwitch", None),
        ("cmd", "setSwitch?value=true", None),
    ]
    return steps
