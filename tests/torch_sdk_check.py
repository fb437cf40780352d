"""The seeded SDK workload: rules for the local engine
(``<package>.local``) with cluster-mode flow and param rules answered by a
token service, a stream of entries, the driver that runs the stream through
``async_entry`` and the snapshot of every node's counters.

Shared by ``chip_smoke.py`` (phase 13: the port on the card against its
torch-ops twin) and ``tests/test_torch_embedded_cluster.py`` (the JAX
package's engine against the port's on the CPU). Imports numpy and the
standard library only: the caller passes the modules of the package it
holds.

- :func:`layout`: which resource carries which rule. Every resource has a
  local ``FlowRule`` (QPS; every 97th WARM_UP, every 89th RATE_LIMITER,
  every 53rd outside the cluster ones THREAD); every 6th is in cluster mode
  on the next of ``cluster_flow_ids``, with ``fallback_to_local_when_fail``;
  one cluster-mode ``ParamFlowRule`` on argument 0 per id of
  ``param_flow_ids``; a ``DegradeRule`` on every 10th (error ratio, error
  count and slow ratio in turn; a third of them sick); a ``SystemRule`` on
  the inbound QPS (every 4th resource is inbound); ``AuthorityRule``\\ s on
  10 resources.
- :func:`stream`: resources bounded-Zipf (alpha 1.1) through a seeded
  permutation of ranks (the five hottest: one resource of each kind),
  origins from 8 apps (and none), parameter values
  bounded-Zipf (alpha 1.1) over 200,000 values
  (``ClusterParamMetric.java:37``), RT 1-200 ms, business exceptions on the
  sick degrade resources, a few prioritized entries, 0-2 ms between
  entries.
- :func:`drive`: each step enters the resource through ``async_entry`` under
  its origin's context and completes the entries whose RT is over (tracing
  the business exception first), so that entries overlap as they do under
  load; returns every verdict (``"pass"``, or the ``BlockException``
  subclass, its message and its rule's class).
- :func:`node_counters`: every cluster, origin, default and entrance node's
  second and minute window sums and thread count, and the inbound entry
  node's.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

APPS = tuple(f"app{i}" for i in range(8))
VALUES = 200_000
ALPHA = 1.1
SYSTEM_QPS = 50.0
WHITE = "app0,app1,app2,app3"
BLACK = "app5"


def _zipf_p(n: int, alpha: float = ALPHA) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


def resource(i: int) -> str:
    return f"res{i}"


def layout(n_resources: int, cluster_flow_ids: Sequence[int],
           param_flow_ids: Sequence[int]) -> dict:
    """Resource index → its rules, as plain values (see the module doc).
    ``cluster_flow_ids`` must cover every 6th resource."""
    cluster = {}
    fids = list(cluster_flow_ids)
    for k, i in enumerate(range(0, n_resources, 6)):
        cluster[i] = int(fids[k])
    cand = [i for i in range(n_resources) if i % 6 == 3]
    step = max(1, len(cand) // max(1, len(param_flow_ids)))
    param = {cand[k * step]: int(pf) for k, pf in enumerate(param_flow_ids)}
    if len(param) != len(param_flow_ids):
        raise ValueError("too few resources for the param rules")
    degrade = {}
    for i in range(0, n_resources, 10):
        grade = (i // 10) % 3  # error ratio, error count, slow ratio
        degrade[i] = dict(grade=grade, sick=(i // 10) % 9 in (0, 4, 8))
    authority = {}
    for k in range(10):
        i = 7 + 11 * k
        if i < n_resources:
            authority[i] = (WHITE, 0) if k % 2 == 0 else (BLACK, 1)
    return dict(n=n_resources, cluster=cluster, param=param,
                degrade=degrade, authority=authority)


def local_count(i: int) -> float:
    return float(5 + i % 50)


def load_rules(L, lay: dict, cluster: bool = True) -> None:
    """Load ``lay``'s rules into the package ``L`` (its ``local``). With
    ``cluster=False`` the same rules in local mode (the yardstick)."""
    flow = []
    for i in range(lay["n"]):
        beh, grade = 0, 1
        if i % 97 == 0:
            beh = 1  # WARM_UP
        elif i % 89 == 0:
            beh = 2  # RATE_LIMITER
        elif i % 53 == 0 and i not in lay["cluster"]:
            grade = 0  # THREAD
        kw = dict(resource=resource(i), count=local_count(i),
                  grade=L.FlowGrade(grade),
                  control_behavior=L.ControlBehavior(beh),
                  warm_up_period_sec=2, max_queueing_time_ms=200)
        if grade == 0:
            kw["count"] = 3.0
        if i in lay["cluster"] and cluster:
            kw.update(cluster_mode=True, cluster_config={
                "flow_id": lay["cluster"][i],
                "fallback_to_local_when_fail": True})
        flow.append(L.FlowRule(**kw))
    L.FlowRuleManager.load_rules(flow)
    L.ParamFlowRuleManager.load_rules([
        L.ParamFlowRule(resource=resource(i), param_idx=0, count=20.0,
                        cluster_mode=cluster,
                        cluster_config={"flow_id": pf,
                                        "fallback_to_local_when_fail": True})
        for i, pf in sorted(lay["param"].items())])
    degrade = []
    for i, d in sorted(lay["degrade"].items()):
        g = d["grade"]
        if g == 0:
            kw = dict(count=0.5)
        elif g == 1:
            kw = dict(count=5.0)
        else:
            kw = dict(count=100.0, slow_ratio_threshold=0.5)
        degrade.append(L.DegradeRule(
            resource=resource(i), grade=L.DegradeGrade(g),
            time_window_sec=1, min_request_amount=5, stat_interval_ms=1000,
            **kw))
    L.DegradeRuleManager.load_rules(degrade)
    L.SystemRuleManager.load_rules([L.SystemRule(qps=SYSTEM_QPS)])
    L.AuthorityRuleManager.load_rules([
        L.AuthorityRule(resource=resource(i), limit_app=apps,
                        strategy=L.AuthorityStrategy(s))
        for i, (apps, s) in sorted(lay["authority"].items())])


def stream(rng: np.random.Generator, lay: dict, n_entries: int,
           dt_ms: Sequence[int] = (0, 0, 1, 1, 2)) -> List[dict]:
    """``n_entries`` seeded entry steps over ``lay``'s resources."""
    n = lay["n"]
    ranks = list(rng.permutation(n))
    # the hottest ranks go to one resource of each kind (in the order the
    # permutation met them), so that every slot sees traffic at any seed;
    # the cluster one fifth, so that the local slots carry most entries
    kinds = (inbound, lambda i: lay["degrade"].get(i, {}).get("sick", False),
             lambda i: i in lay["authority"], lambda i: i in lay["param"],
             lambda i: i in lay["cluster"])
    hot = []
    for kind in kinds:
        hot.append(next(i for i in ranks if kind(i) and i not in hot))
    ranks = np.asarray(hot + [i for i in ranks if i not in hot])
    res = ranks[rng.choice(n, n_entries, p=_zipf_p(n))]
    value_ranks = rng.permutation(VALUES)
    values = value_ranks[rng.choice(VALUES, n_entries, p=_zipf_p(VALUES))]
    origin = rng.integers(0, len(APPS) + 1, n_entries)  # last: no origin
    rt = rng.integers(1, 201, n_entries)
    dt = rng.choice(np.asarray(dt_ms), n_entries)
    prio = rng.random(n_entries) < 0.03
    raise_p = rng.random(n_entries)
    steps = []
    for k in range(n_entries):
        i = int(res[k])
        d = lay["degrade"].get(i)
        steps.append(dict(
            dt=int(dt[k]), res=i,
            origin=APPS[origin[k]] if origin[k] < len(APPS) else "",
            value=int(values[k]), rt=int(rt[k]),
            error=bool(d is not None and d["sick"] and raise_p[k] < 0.6),
            prioritized=bool(prio[k]),
        ))
    return steps


def inbound(i: int) -> bool:
    return i % 4 == 1


def verdict_of(exc) -> tuple:
    return (type(exc).__name__, str(exc), type(exc.rule).__name__)


class BusinessError(RuntimeError):
    pass


def drive(L, sph_mod, steps: Sequence[dict], now: Callable[[], int],
          advance: Optional[Callable[[int], None]] = None,
          lat: Optional[list] = None,
          until: Optional[float] = None) -> List[object]:
    """Run ``steps`` through ``sph_mod.async_entry`` of the package ``L``
    (its ``local`` and ``local.sph``). ``advance(ms)`` steps a manual clock
    before each entry (``None`` on the system clock); entries are exited
    once ``now()`` reaches their RT, and all that are left at the end after
    the clock reaches the last one's. ``lat`` collects ``(resource, s)`` of
    each ``async_entry`` call; ``until`` (a ``time.perf_counter`` reading)
    ends the run early. Returns the verdicts in step order."""
    import time

    heap: list = []
    verdicts: List[object] = []
    out_type = L.EntryType.OUT
    in_type = L.EntryType.IN

    def complete(until: Optional[int]) -> None:
        while heap and (until is None or heap[0][0] <= until):
            due, _, e, err = heapq.heappop(heap)
            if until is None and advance is not None:
                gap = due - now()
                if gap > 0:
                    advance(gap)
            if err:
                e.trace(BusinessError("business failure"))
            e.exit()

    for k, st in enumerate(steps):
        if until is not None and time.perf_counter() > until:
            break
        if advance is not None and st["dt"]:
            advance(st["dt"])
        complete(now())
        origin = st["origin"]
        i = st["res"]
        L.enter_context(f"ctx_{origin}" if origin else
                        "sentinel_default_context", origin)
        try:
            t0 = time.perf_counter()
            try:
                e = sph_mod.async_entry(
                    resource(i), in_type if inbound(i) else out_type,
                    args=(st["value"],), prioritized=st["prioritized"])
            finally:
                if lat is not None:
                    lat.append((i, time.perf_counter() - t0))
        except L.BlockException as exc:
            verdicts.append(verdict_of(exc))
        else:
            verdicts.append("pass")
            heapq.heappush(heap, (now() + st["rt"], k, e, st["error"]))
        finally:
            L.exit_context()
    complete(None)
    return verdicts


def _window(node, now: int) -> tuple:
    return (tuple(node.sec.snapshot(now)), tuple(node.minute.snapshot(now)),
            node.cur_thread_num)


def node_counters(chain_mod, context_mod, now: int) -> Dict[str, object]:
    """Every node's counters (see the module doc), keyed by node."""
    out: Dict[str, object] = {}
    for name, cn in sorted(chain_mod.cluster_node_map().items()):
        out[f"cluster:{name}"] = _window(cn, now)
        for origin, on in sorted(cn.origin_nodes.items()):
            out[f"origin:{name}:{origin}"] = _window(on, now)
    for ctx_name, en in sorted(context_mod._entrance_nodes.items()):
        out[f"entrance:{ctx_name}"] = _window(en, now)
        for child in en.children:
            out[f"default:{ctx_name}:{child.resource.name}"] = _window(
                child, now)
    out["entry_node"] = _window(chain_mod.entry_node(), now)
    return out


def diff(a: dict, b: dict, limit: int = 5) -> List[str]:
    """The first ``limit`` keys on which two :func:`node_counters` differ."""
    keys = sorted(set(a) | set(b))
    bad = [f"{k}: {a.get(k)} != {b.get(k)}" for k in keys
           if a.get(k) != b.get(k)]
    return bad[:limit]
