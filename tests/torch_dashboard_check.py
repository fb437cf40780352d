"""A seeded dashboard session, shared by
``tests/test_torch_dashboard_parity.py`` (the JAX package's dashboard and
app stack against the port's, on the CPU) and ``chip_smoke.py`` phase 18
(the port's stack over a token service on the card against its torch-ops
twin). No JAX here: a package is read by name (``package``).

The session (:func:`run`) drives one package's ``DashboardServer`` and one
app: a ``CommandCenter`` whose ``server_factory`` builds the token server,
a ``HeartbeatSender`` pointed at the dashboard, the app's metric log
written each second by its ``MetricTimer`` and the SDK's ``entry``. On the
caller's manual clock it registers the machine by heartbeat; creates,
edits and deletes a rule of every type through ``v1/rule``; replaces the
gateway API definitions; publishes flow rules through ``v2/rules`` into a
``FileRuleStore`` that the app watches with a ``FileRefreshableDataSource``
(every third resource in cluster mode on the token server's flows);
promotes the machine with ``cluster/assign``; runs seeded entries and
pulls from the embedded token service; publishes lowered counts and runs
them again; lets the dashboard's ``MetricFetcher`` pull ``/metric``; reads
the metric routes, ``cluster/monitor`` and the assignment views; and
unassigns the machine. Every answer is kept, normalized (:func:`normalize`).
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np

import torch_operator_check as OC

APP = "dash-app"
RESOURCES = 12  # the SDK's resources res0..res11
CLUSTER_EVERY = 3  # res0, res3, ... check the token server
ENTRIES = 400  # entries a round, over the resources
ROUNDS = 2  # entry rounds: the published counts, then the lowered ones
PULL_ROWS = 256
PULLS = 4  # embedded-service pulls a round

# what differs between two runs of one session and is not the system's
# answer: times, pids, host names and ports (``OC.VOLATILE_KEYS``), the
# build's identity (a heartbeat's version string, the token server's
# ``buildInfo``, which names the array backend), and the token server's
# pipeline stats (host latency histograms) in ``cluster/monitor``; the
# ports inside machine keys and addresses are written as names
# (:func:`normalize`)
VOLATILE_KEYS = OC.VOLATILE_KEYS | {"version", "buildInfo", "stats"}
PORT_KEYS = ("tokenPort", "serverPort")


def package(name: str) -> SimpleNamespace:
    """The modules of the package ``name`` that the session drives."""
    import importlib

    P = OC.package(name)
    for attr, sub in (("dash", "dashboard"),
                      ("dyn", "dashboard.dynamic_rules"),
                      ("heartbeat", "transport.heartbeat"),
                      ("converters", "datasource.converters")):
        setattr(P, attr, importlib.import_module(f"{name}.{sub}"))
    return P


def _strip(obj, ports: Dict[int, str]):
    if isinstance(obj, dict):
        return {k: (ports.get(v, v) if k in PORT_KEYS and isinstance(v, int)
                    else _strip(v, ports))
                for k, v in obj.items() if k not in VOLATILE_KEYS}
    if isinstance(obj, list):
        return [_strip(v, ports) for v in obj]
    if isinstance(obj, str):
        return _name_ports(obj, ports)
    return obj


def _name_ports(text: str, ports: Dict[int, str]) -> str:
    for port, name in ports.items():
        if text == str(port):
            return name
        text = text.replace(f":{port}", f":{name}")
    return text


def normalize(text: str, ports: Dict[int, str]) -> str:
    """Canonical JSON without :data:`VOLATILE_KEYS`, each port in
    ``ports`` written as its name where a string carries it (``ip:port``)
    or a :data:`PORT_KEYS` field holds it; a text answer with its ports
    named."""
    try:
        obj = json.loads(text)
    except ValueError:
        return _name_ports(text, ports)
    return json.dumps(_strip(obj, ports), sort_keys=True)


RULE_CASES = {
    "flow": ({"resource": "crud_flow", "count": 50, "grade": 1},
             {"resource": "crud_flow2", "count": 7, "grade": 1},
             {"resource": "crud_flow2", "count": 9, "grade": 1}),
    "degrade": ({"resource": "crud_deg", "grade": 0, "count": 100,
                 "timeWindow": 10},
                {"resource": "crud_deg2", "grade": 1, "count": 0.5,
                 "timeWindow": 5},
                {"resource": "crud_deg2", "grade": 1, "count": 0.7,
                 "timeWindow": 5}),
    "system": ({"qps": 100000}, {"qps": 200000}, {"qps": 300000}),
    "authority": ({"resource": "crud_auth", "limitApp": "appA",
                   "strategy": 0},
                  {"resource": "crud_auth2", "limitApp": "appB",
                   "strategy": 1},
                  {"resource": "crud_auth2", "limitApp": "appC",
                   "strategy": 1}),
    "paramFlow": ({"resource": "crud_param", "paramIdx": 0, "count": 50},
                  {"resource": "crud_param2", "paramIdx": 0, "count": 5},
                  {"resource": "crud_param2", "paramIdx": 0, "count": 8}),
    "gateway": ({"resource": "crud_gw", "count": 30, "resourceMode": 0},
                {"resource": "crud_gw2", "count": 3, "resourceMode": 0},
                {"resource": "crud_gw2", "count": 6, "resourceMode": 0}),
}

API_DEFS = [
    {"apiName": "dash_api", "predicateItems": [
        {"pattern": "/dash/", "matchStrategy": 1},
        {"pattern": "/exact", "matchStrategy": 0},
    ]},
]


def flow_rules(cluster_flows: List[int], scale: float) -> List[dict]:
    """The v2-published SDK flow rules: a QPS rule on every resource, every
    :data:`CLUSTER_EVERY`-th in cluster mode on a token-server flow (the
    local engine reads ``flow_id`` and ``fallback_to_local_when_fail``)."""
    rules = []
    for k in range(RESOURCES):
        rule = {"resource": f"res{k}", "grade": 1,
                "count": float(max(1, round((4 + k % 5) * scale)))}
        if k % CLUSTER_EVERY == 0:
            rule["clusterMode"] = True
            rule["clusterConfig"] = {
                "flow_id": int(cluster_flows[k // CLUSTER_EVERY]),
                "thresholdType": 1,
                "fallback_to_local_when_fail": True,
            }
        rules.append(rule)
    return rules


def _zipf_resources(rng, n):
    w = np.arange(1, RESOURCES + 1, dtype=np.float64) ** -1.1
    return np.searchsorted(np.cumsum(w / w.sum()), rng.random(n)).clip(
        0, RESOURCES - 1)


class Session:
    """One package's dashboard, app and token server for :func:`run`."""

    def __init__(self, P, clock, factory, root: str, token_port: int):
        self.P, self.clock, self.root = P, clock, root
        self.token_port = token_port
        OC.reset(P)
        P.config.SentinelConfig.set("csp.sentinel.app.name", APP)
        self.store = P.dyn.FileRuleStore(os.path.join(root, "store"))
        self.dash = P.dash.DashboardServer(
            port=0, rule_plugins=self.store.plugins(("flow",))).start()
        # the fetcher is driven here, on the manual clock, not by its loop
        self.dash.fetcher.stop()
        # the JAX package's command center takes no factory: its
        # handlers build ``DefaultTokenService()`` (the caller binds it)
        kwargs = {} if factory is None else dict(server_factory=factory)
        self.cc = P.command.CommandCenter(
            host="127.0.0.1", port=0, **kwargs).start()
        self.key = f"127.0.0.1:{self.cc.port}"
        self.beat = P.heartbeat.HeartbeatSender(
            [f"127.0.0.1:{self.dash.port}"], command_port=self.cc.port,
            client_ip="127.0.0.1")
        self.timer = P.log.MetricTimer(P.log.MetricWriter())
        self.ports = {self.cc.port: "<command-port>",
                      self.dash.port: "<dashboard-port>",
                      token_port: "<token-port>"}
        self.ds = None
        self._second = clock.now_ms() // 1000

    def close(self) -> None:
        if self.ds is not None:
            self.ds.close()
        self.timer.writer.close()
        self.cc.stop()
        self.dash.stop()
        OC.reset(self.P)

    def http(self, method: str, path: str, body=None):
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.dash.port}/{path}", data=data,
            method=method)
        try:
            with urllib.request.urlopen(req, timeout=600) as rsp:
                return rsp.status, rsp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def tick(self, ms: int) -> None:
        """Advance the clock, writing the metric log at each new second."""
        self.clock.advance(ms)
        second = self.clock.now_ms() // 1000
        if second != self._second:
            self._second = second
            self.timer.writer.write(self.timer.collect_once())

    def watch_store(self) -> None:
        P = self.P
        self.ds = P.file.FileRefreshableDataSource(
            self.store.path_for(f"{APP}-flow-rules"),
            P.converters.flow_rules_from_json, refresh_interval_s=3600)
        P.L.FlowRuleManager.register_property(self.ds.property)

    def entries(self, rng, n: int) -> List[str]:
        P, out = self.P, []
        for k in _zipf_resources(rng, n):
            try:
                with P.L.entry(f"res{int(k)}"):
                    out.append("pass")
            except P.L.BlockException as exc:
                out.append(type(exc).__name__)
            self.tick(int(rng.integers(0, 12)))
        return out

    def pull(self, rng, flows: np.ndarray):
        svc = self.P.api.get_embedded_server()
        ids = flows[rng.integers(0, flows.shape[0], PULL_ROWS)]
        st, rem, wait = svc.request_batch_arrays(ids.astype(np.int64))
        return st.tolist(), rem.tolist(), wait.tolist()


def run(P, clock, factory, root: str, token_port: int,
        cluster_flows: List[int], seed: int,
        timed: Optional[Callable[[str, float], None]] = None) -> dict:
    """The session through package ``P``; returns ``responses`` (label,
    status, normalized answer), ``entries``, ``pulls`` and the metric totals
    the dashboard shows beside those of the app's metric log. ``timed``,
    when given, gets the wall seconds of the assignment to its first
    verdict (``assign``), of a publish to the first entry that shows it
    (``push``), of the ``cluster/monitor`` read (``monitor``, with its
    bytes as ``monitor_bytes``), of the dashboard's own fetch of
    ``cluster/server/metrics`` (``server_metrics``, read once more) and of
    the fetcher's pull (``fetch``)."""
    rng = np.random.default_rng(seed)
    s = Session(P, clock, factory, root, token_port)
    responses, entries, pulls = [], [], []
    flows = np.asarray(cluster_flows, np.int64)

    def call(label, method, path, body=None):
        status, text = s.http(method, path, body)
        responses.append((label, status, normalize(text, s.ports)))
        return status, text

    def note(name, seconds):
        if timed is not None:
            timed(name, seconds)

    try:
        responses.append(("heartbeat", s.beat.send_once(), ""))
        call("apps", "GET", "apps")
        call("state", "GET", f"cluster/state?app={APP}")
        for rtype, (first, second, edit) in RULE_CASES.items():
            q = f"app={APP}&type={rtype}"
            call(f"{rtype} add", "POST", f"v1/rule?{q}", first)
            call(f"{rtype} add", "POST", f"v1/rule?{q}", second)
            call(f"{rtype} edit", "PUT", f"v1/rule?{q}&id=2", edit)
            call(f"{rtype} list", "GET", f"v1/rules?{q}")
            call(f"{rtype} delete", "DELETE", f"v1/rule?{q}&id=1")
            call(f"{rtype} rules", "GET", f"rules?{q}")
        call("apis set", "POST", f"v1/gateway/apis?app={APP}", API_DEFS)
        call("apis", "GET", f"v1/gateway/apis?app={APP}")
        s.watch_store()
        call("v2 publish", "POST", f"v2/rules?app={APP}&type=flow",
             flow_rules(cluster_flows, 1.0))
        call("v2 rules", "GET", f"v2/rules?app={APP}&type=flow")
        s.ds.refresh()
        t0 = time.perf_counter()
        call("assign", "POST", f"cluster/assign?app={APP}",
             {"server": s.key, "tokenPort": token_port})
        pulls.append(s.pull(rng, flows))
        note("assign", time.perf_counter() - t0)
        call("state", "GET", f"cluster/state?app={APP}")
        call("assign state", "GET", f"cluster/assign/state?app={APP}")
        for r in range(ROUNDS):
            if r:
                t0 = time.perf_counter()
                call("v2 lower", "POST", f"v2/rules?app={APP}&type=flow",
                     flow_rules(cluster_flows, 0.5))
                s.ds.refresh()
                try:  # the first verdict under the new rules
                    with P.L.entry("res1"):
                        pass
                except P.L.BlockException:
                    pass
                note("push", time.perf_counter() - t0)
            entries.append(s.entries(rng, ENTRIES))
            for _ in range(PULLS):
                pulls.append(s.pull(rng, flows))
                s.tick(int(rng.integers(20, 200)))
        begin = s.clock.now_ms()
        s.tick(2_500)  # past the fetcher's delay
        t0 = time.perf_counter()
        stored = s.dash.fetcher.fetch_once(APP)
        note("fetch", time.perf_counter() - t0)
        responses.append(("fetched", 200, str(stored)))
        call("resources", "GET", f"resources?app={APP}")
        for k in range(RESOURCES):
            call(f"metric res{k}", "GET",
                 f"metric?app={APP}&identity=res{k}")
        call("machine metric", "GET",
             f"metric?app={APP}&identity=res1&machine={s.key}")
        call("metric machines", "GET",
             f"metric/machines?app={APP}&identity=res1")
        t0 = time.perf_counter()
        status, text = call("monitor", "GET", f"cluster/monitor?app={APP}")
        note("monitor", time.perf_counter() - t0)
        note("monitor_bytes", float(len(text)))
        if timed is not None:
            # the monitor's own fetch of the server's per-flow metrics,
            # which the ApiClient bounds by its timeout
            machine = s.dash.apps.healthy_machines(APP)[0]
            t0 = time.perf_counter()
            got = s.dash.client.fetch_json(machine, "cluster/server/metrics")
            note("server_metrics", time.perf_counter() - t0)
            if got is None:
                raise AssertionError("cluster/server/metrics: no answer "
                                     "within the ApiClient's timeout")
        call("unassign", "POST", f"cluster/assign/manage?app={APP}",
             {"unassign": [s.key]})
        call("state", "GET", f"cluster/state?app={APP}")
        totals = metric_totals(P, s, begin)
    finally:
        s.close()
    return dict(responses=responses, entries=entries, pulls=pulls, **totals)


def metric_totals(P, s: Session, before_ms: int) -> dict:
    """Pass and block totals over every resource: the dashboard's
    repository against the app's metric log, over the window the fetcher
    pulled (its first window reaches 5 s before its end)."""
    end = before_ms + 2_500 - 2_000
    start = end - 5_000
    dash = {"pass": 0.0, "block": 0.0}
    for k in range(RESOURCES):
        for e in s.dash.repository.query(APP, f"res{k}", start, end):
            dash["pass"] += e.pass_qps
            dash["block"] += e.block_qps
    app = {"pass": 0.0, "block": 0.0}
    searcher = P.log.MetricSearcher(P.log.default_metric_dir(), APP)
    for node in searcher.find(start, end):
        if node.resource.startswith("res"):
            app["pass"] += node.pass_qps
            app["block"] += node.block_qps
    return dict(dashboard_totals=dash, log_totals=app)
