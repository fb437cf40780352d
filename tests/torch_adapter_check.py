"""The seeded HTTP workload of the adapters and the data sources: a gateway
in front of a WSGI (or ASGI) app guarded by ``<package>.adapters``, every
rule read from files by ``<package>.datasource``, cluster-mode flow and
param rules answered by a token service, and a rule push in the middle of
the stream.

Shared by ``chip_smoke.py`` (phase 15: the port on the card against its
torch-ops twin) and ``tests/test_torch_adapter_parity.py`` (the JAX
package's stack against the port's on the CPU). Imports numpy and the
standard library only: :func:`package` imports the modules of the package
it is named, and everything else takes them from it.

- :func:`layout`: route ``i`` serves ``/g<i % GROUPS>/r<i>``; the gateway
  knows it as route id ``r<i>``, the WSGI/ASGI middleware as resource
  ``GET:<path>``. Every route has a local QPS ``FlowRule`` (every 97th
  WARM_UP, every 89th RATE_LIMITER); every 6th is in cluster mode on the
  next of ``cluster_flow_ids``; every 6th from 3 calls the decorated
  function ``biz<k>``, which carries one cluster-mode ``ParamFlowRule`` on
  argument 0 per id of ``param_flow_ids``; the others call ``profile``, with
  a local param rule (and an override on the hottest user). Every
  ``biz<k>`` has an error-count ``DegradeRule``; authority rules on a few
  routes; gateway rules on every 5th route by route id, and two on each
  API definition, keyed by client IP, the ``X-Tier`` header or the ``uid``
  URL parameter, over every match strategy.
- :func:`rule_docs` / :func:`write_rules`: the rules as the reference's JSON
  rule files (flow, param, degrade, authority, gateway, API definitions and
  the token server's cluster flow rules), written with the package's
  ``FileWritableDataSource``; :func:`open_sources` reads them with its
  ``FileRefreshableDataSource``, each on its manager's property (the
  cluster file's listener reloads the token service).
- :func:`push`: the mid-stream change: a seeded 1% of the cluster rules
  (and the hottest cluster routes' flows) lowered to 2 a second, one
  gateway rule changed, one API definition added.
- :func:`stream`: routes bounded-Zipf (alpha 1.1) through a seeded
  permutation of ranks (the hottest: one route of each class), client IPs
  from 8 apps (and none), ``X-Tier`` values, user ids bounded-Zipf over
  200,000 values (``ClusterParamMetric.java:37``), business failures
  (3%, and 50% on the routes of every third ``biz<k>``),
  30% of requests through the ASGI stack, 0-2 ms between requests.
- :func:`build_stacks`: ``Edge(SentinelGatewayWsgiMiddleware(
  SentinelWsgiMiddleware(app)))`` and its ASGI twin; ``Edge`` takes the
  client IP from ``X-Real-IP`` (a proxy's header) and answers 500 for a
  business failure that every layer has traced.
- :func:`drive`: the stream through the stacks, one request at a time;
  returns every response (status, headers, body).
"""

from __future__ import annotations

import asyncio
import json
import os
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence
from urllib.parse import parse_qsl, urlencode

import numpy as np

IPS = tuple(f"10.0.{i}.{i + 1}" for i in range(8))  # 8 apps
TIERS = ("gold-1", "gold-7", "silver", "bronze", "")
VALUES = 200_000
ALPHA = 1.1
GROUPS = 5
FAIL_SHARE = 0.03
SICK_FAIL_SHARE = 0.5  # on the routes of every third biz<k>
ASGI_SHARE = 0.3
PUSHED_COUNT = 2.0  # a pushed cluster rule's new count
FILES = ("flow", "param", "degrade", "authority", "gateway", "api", "cluster")
PUSHED_FILES = ("cluster", "gateway", "api")
PUSHED_API = "api_pushed"


def package(name: str) -> SimpleNamespace:
    """The modules of the package ``name`` that the workload drives."""
    import importlib

    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    return SimpleNamespace(
        L=m("local"), chain=m("local.chain"), context=m("local.context"),
        api=m("cluster.api"), clock=m("core.clock"),
        decorator=m("adapters.decorator"), wsgi=m("adapters.wsgi"),
        asgi=m("adapters.asgi"), gateway=m("adapters.gateway"),
        gateway_api=m("adapters.gateway_api"), file=m("datasource.file"),
        base=m("datasource.base"), conv=m("datasource.converters"))


def _zipf_p(n: int, alpha: float = ALPHA) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


def route(i: int) -> str:
    return f"r{i}"


def path(i: int) -> str:
    return f"/g{i % GROUPS}/r{i}"


def resource(i: int) -> str:
    return f"GET:{path(i)}"


def route_class(lay: dict, i: int) -> str:
    if i in lay["cluster"]:
        return "cluster_flow"
    if i in lay["param"]:
        return "cluster_param"
    return "local"


def local_count(i: int) -> float:
    return float(5 + i % 50)


def layout(n_routes: int, cluster_flow_ids: Sequence[int],
           param_flow_ids: Sequence[int]) -> dict:
    """Route index → its rules, as plain values (see the module doc).
    ``cluster_flow_ids`` must cover every 6th route."""
    fids = list(cluster_flow_ids)
    cluster = {i: int(fids[k]) for k, i in enumerate(range(0, n_routes, 6))}
    pfs = [int(p) for p in param_flow_ids]
    param = {i: k % len(pfs) for k, i in enumerate(range(3, n_routes, 6))}
    if len(param) < len(pfs):
        raise ValueError("too few routes for the param rules")
    authority = {}
    for k, i in enumerate(range(1, n_routes, 23)):
        authority[i] = ((",".join(IPS[:4]), 0) if k % 2 == 0
                        else (IPS[5], 1))
    return dict(n=n_routes, cluster=cluster, param=param, param_flows=pfs,
                authority=authority,
                gateway=[i for i in range(n_routes) if i % 5 == 2])


def _item(kind: int) -> Optional[dict]:
    """The param item of gateway rule kind ``kind``: client IP (per IP, or
    one IP exactly), the ``X-Tier`` header (prefix, contains), the ``uid``
    URL parameter (regex), or none (a plain route limit)."""
    items = (
        {"parseStrategy": 0},
        {"parseStrategy": 0, "pattern": IPS[3], "matchStrategy": 0},
        {"parseStrategy": 2, "fieldName": "X-Tier", "pattern": "gold",
         "matchStrategy": 1},
        {"parseStrategy": 2, "fieldName": "X-Tier", "pattern": "ilv",
         "matchStrategy": 3},
        {"parseStrategy": 3, "fieldName": "uid", "pattern": r"^1\d*$",
         "matchStrategy": 2},
        None,
    )
    return items[kind % len(items)]


def _gateway_rule(res: str, mode: int, count: float, kind: int) -> dict:
    return {"resource": res, "resourceMode": mode, "count": count,
            "grade": 1, "intervalSec": 1, "controlBehavior": 0, "burst": 0,
            "maxQueueingTimeoutMs": 500, "paramItem": _item(kind)}


def api_definitions(n_routes: int) -> List[dict]:
    """Exact, prefix, regex and group predicates over the routes' paths."""
    return [
        {"apiName": "api_exact", "predicateItems": [
            {"pattern": path(i), "matchStrategy": 0}
            for i in range(0, min(n_routes, 40), 4)]},
        {"apiName": "api_g1", "predicateItems": [
            {"pattern": "/g1/", "matchStrategy": 1}]},
        {"apiName": "api_regex", "predicateItems": [
            {"pattern": r"/g2/r\d*7", "matchStrategy": 2}]},
        {"apiName": "api_group", "predicateItems": [
            {"items": [{"pattern": "/g3/r1", "matchStrategy": 1},
                       {"pattern": path(min(8, n_routes - 1)),
                        "matchStrategy": 0}]}]},
    ]


def cluster_rule_docs(n_flows: int, n_ns: int) -> List[dict]:
    """The token server's flow rules as its rule file holds them: count
    100 + i % 100, GLOBAL, namespace ``ns<i % n_ns>``, every 97th / 89th /
    83rd WARM_UP / RATE_LIMITER / WARM_UP_RATE_LIMITER (``chip_smoke.py``
    phase 3's rules)."""
    docs = []
    for i in range(n_flows):
        beh = 1 if i % 97 == 0 else 2 if i % 89 == 0 else \
            3 if i % 83 == 0 else 0
        d = {"flowId": i, "count": 100.0 + (i % 100), "thresholdType": 1,
             "namespace": f"ns{i % n_ns}"}
        if beh:
            d.update(controlBehavior=beh, warmUpPeriodSec=10, coldFactor=3,
                     maxQueueingTimeMs=500)
        docs.append(d)
    return docs


def rule_docs(lay: dict, n_flows: int, n_ns: int,
              cluster: bool = True) -> Dict[str, list]:
    """Every rule file's content (see the module doc). With
    ``cluster=False`` the flow and param rules in local mode."""
    flow = []
    for i in range(lay["n"]):
        beh = 1 if i % 97 == 0 else 2 if i % 89 == 0 else 0
        fid = lay["cluster"].get(i)
        flow.append({
            "resource": resource(i), "count": local_count(i), "grade": 1,
            "limitApp": "default", "strategy": 0, "controlBehavior": beh,
            "warmUpPeriodSec": 2, "maxQueueingTimeMs": 200,
            "clusterMode": cluster and fid is not None,
            # the keys the local engine's cluster branch reads
            "clusterConfig": None if fid is None else {
                "flow_id": fid, "fallback_to_local_when_fail": True}})
    param = [{"resource": f"biz{k}", "paramIdx": 0, "count": 20.0,
              "grade": 1, "durationInSec": 1, "clusterMode": cluster,
              "clusterConfig": {"flow_id": pf,
                                "fallback_to_local_when_fail": True}}
             for k, pf in enumerate(lay["param_flows"])]
    param.append({"resource": "profile", "paramIdx": 0, "count": 5.0,
                  "grade": 1, "durationInSec": 1, "paramFlowItemList": [
                      {"object": "0", "count": 1.0}]})
    degrade = [{"resource": f"biz{k}", "grade": 2, "count": 1.0,
                "timeWindow": 1, "minRequestAmount": 3,
                "statIntervalMs": 1000}
               for k in range(len(lay["param_flows"]))]
    authority = [{"resource": resource(i), "limitApp": apps,
                  "strategy": s}
                 for i, (apps, s) in sorted(lay["authority"].items())]
    gateway = [_gateway_rule(route(i), 0, 10.0 + 5 * ((i // 5) % 4), i // 5)
               for i in lay["gateway"]]
    # two rules an API definition (aligned param indexes), so that the hot
    # APIs carry every item kind
    gateway += [_gateway_rule(a["apiName"], 1, 40.0, kind)
                for k, a in enumerate(api_definitions(lay["n"]))
                for kind in (k, k + 3)]
    # a rule ahead of its API definition, which the push adds
    gateway.append(_gateway_rule(PUSHED_API, 1, 3.0, 0))
    return dict(flow=flow, param=param, degrade=degrade,
                authority=authority, gateway=gateway,
                api=api_definitions(lay["n"]),
                cluster=cluster_rule_docs(n_flows, n_ns))


def hot_routes(lay: dict, steps: Sequence[dict], cls: str,
               k: int) -> List[int]:
    """The ``k`` routes of class ``cls`` with the most requests."""
    counts: Dict[int, int] = {}
    for st in steps:
        if route_class(lay, st["route"]) == cls:
            counts[st["route"]] = counts.get(st["route"], 0) + 1
    return [i for i, _ in sorted(counts.items(),
                                 key=lambda kv: (-kv[1], kv[0]))[:k]]


def push(docs: Dict[str, list], lay: dict, steps: Sequence[dict],
         rng: np.random.Generator) -> Dict[str, list]:
    """The rule files after the push: a seeded 1% of the cluster rules and
    the flows of the 5 hottest cluster routes lowered to ``PUSHED_COUNT``,
    the hottest gateway route's rule cut to 1, one API definition added
    (the ``/g4/`` prefix, whose gateway rule was loaded before)."""
    new = {k: [dict(d) for d in v] for k, v in docs.items()}
    n = len(new["cluster"])
    pushed = set(int(f) for f in rng.choice(n, max(1, n // 100),
                                            replace=False))
    pushed |= {lay["cluster"][i] for i in hot_routes(lay, steps,
                                                     "cluster_flow", 5)}
    for d in new["cluster"]:
        if d["flowId"] in pushed:
            d["count"] = PUSHED_COUNT
    counts: Dict[int, int] = {}
    for st in steps:
        if st["route"] in lay["gateway"]:
            counts[st["route"]] = counts.get(st["route"], 0) + 1
    hot = route(max(sorted(counts), key=counts.get))
    for d in new["gateway"]:
        if d["resource"] == hot:
            d["count"] = 1.0
    new["api"].append({"apiName": PUSHED_API, "predicateItems": [
        {"pattern": "/g4/", "matchStrategy": 1}]})
    return new


def pushed_routes(lay: dict, before: Dict[str, list],
                  after: Dict[str, list]) -> List[int]:
    """The cluster routes whose flow's count the push lowered."""
    old = {d["flowId"]: d["count"] for d in before["cluster"]}
    low = {d["flowId"] for d in after["cluster"]
           if d["count"] != old[d["flowId"]]}
    return sorted(i for i, f in lay["cluster"].items() if f in low)


def _dump(docs) -> str:
    return json.dumps(docs)


def write_rules(P, rule_dir: str, docs: Dict[str, list],
                names: Sequence[str] = FILES) -> None:
    """Write the rule files ``names`` of ``docs`` with the package's
    ``FileWritableDataSource`` (a temporary file, then a rename, so that a
    poller never reads half a file)."""
    os.makedirs(rule_dir, exist_ok=True)
    for name in names:
        P.file.FileWritableDataSource(
            os.path.join(rule_dir, f"{name}.json"), _dump).write(docs[name])


def open_sources(P, rule_dir: str, load_cluster: Callable[[list], None],
                 refresh_interval_s: float = 3.0) -> Dict[str, object]:
    """One ``FileRefreshableDataSource`` a rule file, each on its manager's
    property (the gateway's and the cluster file's through a listener),
    then one ``refresh()`` each, in file order: the param rules before the
    gateway's, which keep them. Raises if a refresh fails."""
    C, L = P.conv, P.L
    G, GA = P.gateway.GatewayRuleManager, P.gateway_api
    convert = dict(flow=C.flow_rules_from_json,
                   param=C.param_flow_rules_from_json,
                   degrade=C.degrade_rules_from_json,
                   authority=C.authority_rules_from_json,
                   gateway=C.gateway_flow_rules_from_json,
                   api=json.loads,
                   cluster=C.cluster_flow_rules_from_json)
    srcs = {name: P.file.FileRefreshableDataSource(
        os.path.join(rule_dir, f"{name}.json"), convert[name],
        refresh_interval_s=refresh_interval_s) for name in FILES}
    L.FlowRuleManager.register_property(srcs["flow"].property)
    L.ParamFlowRuleManager.register_property(srcs["param"].property)
    L.DegradeRuleManager.register_property(srcs["degrade"].property)
    L.AuthorityRuleManager.register_property(srcs["authority"].property)
    srcs["gateway"].property.listen(lambda rules: G.load_rules(rules or []))
    GA.GatewayApiDefinitionManager.register_property(srcs["api"].property)

    def cluster_rules(rules):
        if rules is not None:
            load_cluster(rules)

    srcs["cluster"].property.listen(cluster_rules)
    refresh(srcs, FILES)
    return srcs


def refresh(srcs: Dict[str, object], names: Sequence[str]) -> None:
    for name in names:
        if not srcs[name].refresh():
            raise AssertionError(f"the {name} rule file did not load")


def refresh_param_rules(P, srcs: Dict[str, object]) -> None:
    """Refresh the param rule file, then load the gateway's rules again. A
    param rule load replaces every param rule, the gateway's generated ones
    too (the reference's order), and refreshing an unchanged gateway file
    fires no listener (``DynamicProperty.update_value`` skips an equal
    value)."""
    refresh(srcs, ("param",))
    P.gateway.GatewayRuleManager.load_rules(
        srcs["gateway"].property.value or [])


def reset(P) -> None:
    """Every rule manager and statistic of the package, and its gateway."""
    P.L.reset_for_tests()
    P.api.reset_for_tests()
    P.gateway.GatewayRuleManager.reset_for_tests()
    P.gateway_api.GatewayApiDefinitionManager.reset_for_tests()
    P.gateway_api.GatewayApiMatcherManager.reset_for_tests()


def stream(rng: np.random.Generator, lay: dict, n_requests: int,
           dt_ms: Sequence[int] = (0, 0, 1, 1, 2)) -> List[dict]:
    """``n_requests`` seeded requests over ``lay``'s routes."""
    n = lay["n"]
    ranks = list(rng.permutation(n))
    # the hottest ranks go to one route of each class and to a gateway
    # route, so that every path sees traffic at any seed
    kinds = (lambda i: i in lay["cluster"], lambda i: i in lay["param"],
             lambda i: i in lay["gateway"], lambda i: i in lay["authority"])
    hot: List[int] = []
    for kind in kinds:
        hot.append(next(i for i in ranks if kind(i) and i not in hot))
    ranks = np.asarray(hot + [i for i in ranks if i not in hot])
    routes = ranks[rng.choice(n, n_requests, p=_zipf_p(n))]
    value_ranks = rng.permutation(VALUES)
    uids = value_ranks[rng.choice(VALUES, n_requests, p=_zipf_p(VALUES))]
    ip = rng.integers(0, len(IPS) + 1, n_requests)  # the last: no IP
    tier = rng.integers(0, len(TIERS), n_requests)
    sick = np.asarray([i in lay["param"] and lay["param"][i] % 3 == 0
                       for i in range(n)])
    fail = rng.random(n_requests) < np.where(sick[routes], SICK_FAIL_SHARE,
                                             FAIL_SHARE)
    asgi = rng.random(n_requests) < ASGI_SHARE
    dt = rng.choice(np.asarray(dt_ms), n_requests)
    return [dict(dt=int(dt[k]), route=int(routes[k]),
                 ip=IPS[ip[k]] if ip[k] < len(IPS) else "",
                 tier=TIERS[tier[k]], uid=str(uids[k]), fail=bool(fail[k]),
                 asgi=bool(asgi[k]))
            for k in range(n_requests)]


def query(st: dict) -> str:
    q = {"uid": st["uid"]}
    if st["fail"]:
        q["fail"] = "1"
    return urlencode(q)


def headers(st: dict) -> Dict[str, str]:
    """The request's headers as a client sends them through a proxy."""
    out = {"X-Real-IP": st["ip"]}
    if st["tier"]:
        out["X-Tier"] = st["tier"]
    return out


class BusinessError(RuntimeError):
    pass


def _lookup(uid: str, fail: bool) -> str:
    if fail:
        raise BusinessError("business failure")
    return f"user:{uid}"


def _blocked(uid: str, fail: bool, ex) -> str:
    return f"blocked:{type(ex).__name__}"


def build_stacks(P, lay: dict) -> SimpleNamespace:
    """The app behind both stacks (see the module doc)."""
    guard = P.decorator.sentinel_resource
    biz = [guard(f"biz{k}", args_as_params=True,
                 block_handler=_blocked)(_lookup)
           for k in range(len(lay["param_flows"]))]
    profile = guard("profile", args_as_params=True,
                    block_handler=_blocked)(_lookup)

    def answer(path_info: str, qs: str) -> bytes:
        i = int(path_info.rsplit("/r", 1)[1])
        q = dict(parse_qsl(qs))
        fn = biz[lay["param"][i]] if i in lay["param"] else profile
        return f"{route(i)} {fn(q['uid'], q.get('fail') == '1')}".encode()

    def wsgi_app(environ, start_response):
        body = answer(environ["PATH_INFO"], environ.get("QUERY_STRING", ""))
        start_response("200 OK", [("Content-Type", "text/plain"),
                                  ("Content-Length", str(len(body)))])
        return [body]

    async def asgi_app(scope, receive, send):
        body = answer(scope["path"], scope["query_string"].decode())
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/plain"),
                                (b"content-length",
                                 str(len(body)).encode())]})
        await send({"type": "http.response.body", "body": body})

    W, A, G = P.wsgi, P.asgi, P.gateway
    wsgi = G.SentinelGatewayWsgiMiddleware(
        W.SentinelWsgiMiddleware(wsgi_app),
        route_extractor=lambda env: env["PATH_INFO"].rsplit("/", 1)[1])
    asgi = G.SentinelGatewayAsgiMiddleware(
        A.SentinelAsgiMiddleware(asgi_app),
        route_extractor=lambda scope: scope["path"].rsplit("/", 1)[1])
    return SimpleNamespace(wsgi=WsgiEdge(wsgi), asgi=AsgiEdge(asgi))


FAILED = b"business failure"


class WsgiEdge:
    """The proxy's hop: ``X-Real-IP`` becomes the peer address, and a
    business failure that the layers below traced becomes a 500."""

    def __init__(self, app):
        self.app = app

    def __call__(self, environ, start_response):
        ip = environ.get("HTTP_X_REAL_IP")
        if ip is not None:
            environ["REMOTE_ADDR"] = ip
        try:
            return self.app(environ, start_response)
        except BusinessError:
            start_response("500 Internal Server Error",
                           [("Content-Type", "text/plain"),
                            ("Content-Length", str(len(FAILED)))])
            return [FAILED]


class AsgiEdge:
    def __init__(self, app):
        self.app = app

    async def __call__(self, scope, receive, send):
        try:
            await self.app(scope, receive, send)
        except BusinessError:
            await send({"type": "http.response.start", "status": 500,
                        "headers": [(b"content-type", b"text/plain")]})
            await send({"type": "http.response.body", "body": FAILED})


def wsgi_request(app, st: dict) -> tuple:
    environ = {"REQUEST_METHOD": "GET", "PATH_INFO": path(st["route"]),
               "QUERY_STRING": query(st), "SERVER_NAME": "gateway",
               "SERVER_PORT": "80", "HTTP_HOST": "gateway",
               "wsgi.url_scheme": "http"}
    for k, v in headers(st).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    got = {}

    def start_response(status, hdrs, exc_info=None):
        got["status"], got["headers"] = status, tuple(hdrs)

    body = app(environ, start_response)
    try:
        data = b"".join(body)
    finally:
        close = getattr(body, "close", None)  # PEP 3333's optional close
        if close is not None:
            close()
    return ("wsgi", got["status"], got["headers"], data)


async def asgi_request(app, st: dict) -> tuple:
    scope = {"type": "http", "method": "GET", "path": path(st["route"]),
             "query_string": query(st).encode(),
             "headers": [(k.lower().encode(), v.encode())
                         for k, v in headers(st).items() if k != "X-Real-IP"]
             + [(b"host", b"gateway")],
             "client": (st["ip"], 40000) if st["ip"] else None}
    sent = []

    async def receive():
        return {"type": "http.request", "body": b"", "more_body": False}

    async def send(msg):
        sent.append(msg)

    await app(scope, receive, send)
    start = sent[0]
    return ("asgi", start["status"],
            tuple((k.decode(), v.decode()) for k, v in start["headers"]),
            b"".join(m.get("body", b"") for m in sent[1:]))


def drive(stacks, steps: Sequence[dict],
          advance: Optional[Callable[[int], None]] = None,
          at_half: Optional[Callable[[], None]] = None) -> List[tuple]:
    """Run ``steps`` through the stacks, one request at a time;
    ``advance(ms)`` steps a manual clock before each, and ``at_half()``
    runs before the request in the middle of the stream."""
    loop = asyncio.new_event_loop()
    out = []
    try:
        for k, st in enumerate(steps):
            if at_half is not None and k == len(steps) // 2:
                at_half()
            if advance is not None and st["dt"]:
                advance(st["dt"])
            if st["asgi"]:
                out.append(loop.run_until_complete(
                    asgi_request(stacks.asgi, st)))
            else:
                out.append(wsgi_request(stacks.wsgi, st))
    finally:
        loop.close()
    return out


def status_code(resp: tuple) -> int:
    s = resp[1]
    return s if isinstance(s, int) else int(s.split()[0])


def tally(lay: dict, steps: Sequence[dict], responses: Sequence[tuple],
          routes: Optional[set] = None) -> Dict[str, int]:
    """Responses by kind: the status, and a 200's decorated-call verdict
    (``pass`` or the ``BlockException`` class), over ``routes`` if given."""
    out: Dict[str, int] = {}
    for st, resp in zip(steps, responses):
        if routes is not None and st["route"] not in routes:
            continue
        code = status_code(resp)
        key = str(code)
        if code == 200:
            verdict = resp[3].split(b" ", 1)[1].decode()
            key = verdict if verdict.startswith("blocked:") else "200"
        out[key] = out.get(key, 0) + 1
    return out
