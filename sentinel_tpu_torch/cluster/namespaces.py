"""Namespace partitioning across pods, the second scaling tier (the port's
copy of ``sentinel_tpu/cluster/namespaces.py``).

Tier 1: within one pod, the flow axis of the engine state shards over the
pod's devices (the reference's ``DefaultTokenService(mesh=...)``; not
ported yet).

Tier 2: namespaces partition across pods, mirroring the reference's
ownership model — a namespace is served by exactly ONE token server
(``ClusterFlowRuleManager.java:67`` keeps namespace → flowId sets,
``ConnectionManager.java:35`` namespace → connection group; clients are
pointed at their namespace's server by assignment config). Decisions never
cross pods, so the cross-pod traffic is only:

- assignment changes (this module's ``NamespaceAssignment``),
- global observability (``aggregate_snapshots`` — the dashboard-facing sum
  of per-pod metric snapshots).

Counter state is ephemeral by design (sliding windows ≤ seconds; SURVEY §5
checkpoint stance), so moving a namespace = repoint rules + clients; the new
owner starts with fresh windows — the same behavior the reference exhibits
when a token server restarts or an assignment changes.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.rules import ClusterFlowRule

# pods whose snapshot fetch raised during aggregate_snapshots — surfaced by
# the exporter as sentinel_assignment_snapshot_errors_total so a pod that
# silently vanishes from the dashboard sum shows up as a counter instead
_SNAPSHOT_ERRORS = 0
_SNAPSHOT_ERRORS_LOCK = threading.Lock()


def count_snapshot_error(n: int = 1) -> None:
    global _SNAPSHOT_ERRORS
    with _SNAPSHOT_ERRORS_LOCK:
        _SNAPSHOT_ERRORS += int(n)


def snapshot_error_total() -> int:
    with _SNAPSHOT_ERRORS_LOCK:
        return _SNAPSHOT_ERRORS


def reset_snapshot_errors_for_tests() -> None:
    global _SNAPSHOT_ERRORS
    with _SNAPSHOT_ERRORS_LOCK:
        _SNAPSHOT_ERRORS = 0


# flow copies dropped by the mid-MOVE dedupe in aggregate_snapshots —
# surfaced as sentinel_assignment_move_dedup_total so a redirect window
# that lingers (end_redirect never called) is visible on the dashboard
_MOVE_DEDUP = 0
_MOVE_DEDUP_LOCK = threading.Lock()


def count_move_dedup(n: int = 1) -> None:
    global _MOVE_DEDUP
    with _MOVE_DEDUP_LOCK:
        _MOVE_DEDUP += int(n)


def move_dedup_total() -> int:
    with _MOVE_DEDUP_LOCK:
        return _MOVE_DEDUP


def reset_move_dedup_for_tests() -> None:
    global _MOVE_DEDUP
    with _MOVE_DEDUP_LOCK:
        _MOVE_DEDUP = 0


class NamespaceAssignment:
    """namespace → pod ownership map with a generation counter.

    The generation bumps on every change so routers can cheaply detect
    staleness (the reference pushes new assignment configs through the
    property system; here the property payload carries ``snapshot()``).
    """

    def __init__(self, initial: Optional[Mapping[str, str]] = None):
        self._lock = threading.Lock()
        self._pod_of: Dict[str, str] = dict(initial or {})
        self.generation = 0

    def assign(self, namespace: str, pod_id: str) -> None:
        with self._lock:
            if self._pod_of.get(namespace) != pod_id:
                self._pod_of[namespace] = pod_id
                self.generation += 1

    move = assign  # moving is just re-assigning; counters don't travel

    def unassign(self, namespace: str) -> None:
        with self._lock:
            if self._pod_of.pop(namespace, None) is not None:
                self.generation += 1

    def pod_of(self, namespace: str) -> Optional[str]:
        with self._lock:
            return self._pod_of.get(namespace)

    def namespaces_of(self, pod_id: str) -> List[str]:
        with self._lock:
            return sorted(
                ns for ns, p in self._pod_of.items() if p == pod_id
            )

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._pod_of)


def partition_rules(
    rules: Iterable[ClusterFlowRule], assignment: NamespaceAssignment
) -> Dict[str, List[ClusterFlowRule]]:
    """Split a global rule set by owning pod (namespace → flowId set,
    ``ClusterFlowRuleManager.java:67``). Rules in unassigned namespaces are
    grouped under ``None`` so callers can surface the config error instead
    of silently dropping quota enforcement."""
    out: Dict[str, List[ClusterFlowRule]] = {}
    for rule in rules:
        out.setdefault(assignment.pod_of(rule.namespace), []).append(rule)
    return out


def flow_namespaces(rules: Iterable[ClusterFlowRule]) -> Dict[int, str]:
    """flow_id → namespace routing key (what clients use to pick a pod)."""
    return {r.flow_id: r.namespace for r in rules}


def aggregate_snapshots(
    snapshots: Iterable[Mapping[int, Mapping[str, float]]],
    global_budgets: Optional[Mapping[int, float]] = None,
) -> Dict[object, Dict[str, float]]:
    """Cross-pod metric aggregation: sum per-flow metric snapshots from every
    pod into the global view the dashboard shows.

    Namespace ownership makes this a disjoint union in steady state, but
    during a MOVE's redirect window BOTH pods report the flow: the source's
    counters froze at the begin-move device step (its snapshot rows carry a
    ``moved_epoch`` marker stamping the shard-map epoch), while the
    destination counts live traffic. Summing both double-reports the frozen
    window, so marked rows dedupe: a flow with any UNMARKED copy keeps only
    the unmarked copies; a flow seen only as marked copies (destination's
    snapshot missing from this pull) keeps the single copy with the highest
    shard-map epoch. Dropped copies are counted in
    ``sentinel_assignment_move_dedup_total``. The ``moved_epoch`` marker
    itself never reaches the output — it is routing metadata, not a metric.

    Items may be mappings or zero-arg callables fetching one (a remote pod's
    stats pull). A pod whose fetch raises — or whose payload is malformed —
    contributes NOTHING (no half-merged rows), is logged, and is counted in
    ``sentinel_assignment_snapshot_errors_total``; it must not abort the
    other pods' aggregation or silently vanish from the sum.

    ``global_budgets`` (flow_id → the coordinator's budget tokens) adds a
    ``"global"`` block for ``clusterServerStats``: fleet-wide LEASED-share
    charge summed across pods vs the global budget, per flow — the one
    number that says whether a hierarchical limit is holding."""
    # staged per-flow copies: (metrics-without-marker, moved_epoch or None)
    copies: Dict[int, List[Tuple[Dict[str, float], Optional[float]]]] = {}
    for i, snap in enumerate(snapshots):
        try:
            if callable(snap):
                snap = snap()
            staged: Dict[int, Tuple[Dict[str, float], Optional[float]]] = {}
            for fid, metrics in snap.items():
                row: Dict[str, float] = {}
                moved: Optional[float] = None
                for k, v in metrics.items():
                    if k == "moved_epoch":
                        moved = float(v)
                    else:
                        row[k] = row.get(k, 0.0) + float(v)
                staged[int(fid)] = (row, moved)
        except Exception:
            record_log.exception(
                "pod snapshot %d failed during aggregation; skipping it", i,
            )
            count_snapshot_error()
            continue
        for fid, copy in staged.items():
            copies.setdefault(fid, []).append(copy)
    out: Dict[object, Dict[str, float]] = {}
    for fid, rows in copies.items():
        unmarked = [r for r, moved in rows if moved is None]
        if unmarked:
            keep = unmarked
        else:
            # every copy is mid-move/committed-away: keep the newest-epoch
            # one (the closest thing to the authoritative frozen window)
            keep = [max(rows, key=lambda rm: rm[1])[0]]
        if len(keep) < len(rows):
            count_move_dedup(len(rows) - len(keep))
        slot = out.setdefault(fid, {})
        for row in keep:
            for k, v in row.items():
                slot[k] = slot.get(k, 0.0) + v
    if global_budgets is not None:
        glob: Dict[str, Dict[str, float]] = {}
        for fid, budget in global_budgets.items():
            leased = float(
                out.get(int(fid), {}).get("leased_tokens", 0.0)
            )
            budget = float(budget)
            glob[str(int(fid))] = {
                "budget_tokens": budget,
                "leased_tokens": leased,
                "occupancy": leased / budget if budget > 0 else 0.0,
            }
        out["global"] = glob
    return out
