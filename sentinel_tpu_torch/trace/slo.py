"""Per-tenant SLO plane: latency histograms, burn rates, shed attribution.

The port's copy of ``sentinel_tpu/trace/slo.py``.

The north star is an SLO (p99 < 2ms), but aggregate stage histograms can't
say WHICH tenant ate the budget. This plane keys everything by namespace:

- a :class:`~sentinel_tpu_torch.metrics.histogram.LatencyHistogram` of decision
  latency (enqueue → verdict materialized) per namespace,
- rolling **multi-window burn rate** against the configured p99 objective
  (``sentinel.tpu.slo.p99.ms``, default 2.0): the objective allows 1% of
  requests over the latency bound, so ``burn = over_fraction / 0.01`` —
  burn 1.0 spends the error budget exactly at the sustainable rate, burn
  14 on the 1m window is the classic page-now signal. Two windows (1m/1h)
  distinguish a transient spike from a sustained bleed,
- per-tenant **shed/over-admission attribution**: refusals (OVERLOAD,
  brownout sheds, too_many_request) counted per namespace, so "who got
  shed" and "who caused the shedding" are answerable separately,
- per-tenant **completion outcomes** (wire-rev-6 OUTCOME_REPORT): reported
  response times feed a second histogram + burn-rate pair against the RT
  objective (``sentinel.tpu.slo.rt.p99.ms``, default 100.0) — the
  latency-burn SLO window over what the protected dependency actually
  served, not just how fast the verdict was — plus exception counts.

Surfaced through the Prometheus exporter (``sentinel_slo_*``),
``clusterServerStats`` (``slo`` block), black-box dumps, and
:func:`merge_fleet` — the fleet view summed across pods on the same pull
path ``aggregate_snapshots`` already uses.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

from sentinel_tpu_torch.metrics.histogram import LatencyHistogram

KEY_OBJECTIVE_MS = "sentinel.tpu.slo.p99.ms"
# completion-RT objective: the p99 bound on what protected calls REPORT
# back (OUTCOME_REPORT rt_ms), as opposed to the decision-latency objective
# above which bounds the admission verdict itself
KEY_RT_OBJECTIVE_MS = "sentinel.tpu.slo.rt.p99.ms"
# the p99 objective tolerates 1% of requests over the bound — that 1% IS
# the error budget the burn rate is measured against
BUDGET_FRACTION = 0.01

_WINDOWS = (("1m", 60), ("1h", 3600))


class _BurnWindow:
    """Per-second (total, over) buckets covering the last ``seconds``;
    stale buckets are lazily reused, so recording is O(1) and reading is
    one pass over at most ``seconds`` small ints."""

    __slots__ = ("seconds", "_stamp", "_total", "_over")

    def __init__(self, seconds: int):
        self.seconds = seconds
        self._stamp = [0] * seconds
        self._total = [0] * seconds
        self._over = [0] * seconds

    def record(self, total: int, over: int, now_s: Optional[int] = None):
        t = int(now_s if now_s is not None else time.time())
        i = t % self.seconds
        if self._stamp[i] != t:
            self._stamp[i] = t
            self._total[i] = 0
            self._over[i] = 0
        self._total[i] += total
        self._over[i] += over

    def totals(self, now_s: Optional[int] = None):
        t = int(now_s if now_s is not None else time.time())
        lo = t - self.seconds
        total = over = 0
        for i in range(self.seconds):
            if lo < self._stamp[i] <= t:
                total += self._total[i]
                over += self._over[i]
        return total, over


class _Tenant:
    __slots__ = ("hist", "windows", "shed", "waited",
                 "rt_hist", "rt_windows", "completed", "exceptions")

    def __init__(self):
        # decision latency in ms; log buckets fine enough to resolve a
        # 2ms objective (0.01ms..10s, 5/decade)
        self.hist = LatencyHistogram(lo=0.01, hi=10_000.0, per_decade=5)
        self.windows = {name: _BurnWindow(s) for name, s in _WINDOWS}
        self.shed: Dict[str, int] = {}
        # SHOULD_WAIT verdicts: served-with-delay (pacing / priority
        # occupy) — counted separately from sheds because the request WAS
        # admitted; a paced tenant is shaped, not failing
        self.waited = 0
        # reported completion RT (OUTCOME_REPORT): wider range than the
        # decision histogram — a protected dependency can take seconds
        self.rt_hist = LatencyHistogram(lo=0.1, hi=100_000.0, per_decade=5)
        self.rt_windows = {name: _BurnWindow(s) for name, s in _WINDOWS}
        self.completed = 0
        self.exceptions = 0


class SloPlane:
    """Process-wide per-namespace SLO accounting. Thread-safe; the
    recording path is one dict lookup + histogram record + two window
    adds per (namespace, batch)."""

    def __init__(self, objective_ms: Optional[float] = None,
                 rt_objective_ms: Optional[float] = None):
        from sentinel_tpu_torch.core.config import SentinelConfig

        if objective_ms is None:
            objective_ms = SentinelConfig.get_float(KEY_OBJECTIVE_MS, 2.0)
        if rt_objective_ms is None:
            rt_objective_ms = SentinelConfig.get_float(
                KEY_RT_OBJECTIVE_MS, 100.0
            )
        self.objective_ms = float(objective_ms)
        self.rt_objective_ms = float(rt_objective_ms)
        self._lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}

    def _tenant(self, ns: str) -> _Tenant:
        t = self._tenants.get(ns)
        if t is None:
            with self._lock:
                t = self._tenants.setdefault(ns, _Tenant())
        return t

    # -- recording ----------------------------------------------------------
    def record(self, namespace: str, latency_ms: float, n: int = 1,
               now_s: Optional[int] = None) -> None:
        """n requests for this tenant observed ``latency_ms`` (a batch
        shares one decision latency — every row waited for the same
        device step)."""
        if n <= 0:
            return
        t = self._tenant(namespace)
        t.hist.record(latency_ms, n)
        over = n if latency_ms > self.objective_ms else 0
        for w in t.windows.values():
            w.record(n, over, now_s)

    def record_waited(self, namespace: str, n: int = 1) -> None:
        """n rows admitted with an assigned wait (SHOULD_WAIT). Latency /
        burn accounting already happened via :meth:`record` — this only
        keeps the per-tenant attribution the stats command and exporter
        surface as ``sentinel_slo_waited_total``."""
        if n <= 0:
            return
        t = self._tenant(namespace)
        with self._lock:
            t.waited += n

    def record_completion(self, namespace: str, rts, n_exception: int = 0,
                          now_s: Optional[int] = None) -> None:
        """A batch of reported completions for this tenant: ``rts`` is an
        array-like of response times in ms (already validated/clamped at
        the wire boundary). Feeds the RT histogram and the latency-burn
        windows against ``rt_objective_ms``; exceptions are counted but do
        NOT burn the RT budget twice (an exception's RT is still a real
        observation of the dependency)."""
        import numpy as np

        r = np.asarray(rts, dtype=np.float64)
        n = int(r.shape[0])
        if n == 0 and n_exception <= 0:
            return
        t = self._tenant(namespace)
        if n:
            # batches repeat few distinct RTs (whole ms); record grouped
            for v, c in zip(*np.unique(r, return_counts=True)):
                t.rt_hist.record(float(v), int(c))
            over = int((r > self.rt_objective_ms).sum())
            for w in t.rt_windows.values():
                w.record(n, over, now_s)
        with self._lock:
            t.completed += n
            t.exceptions += max(0, int(n_exception))

    def record_shed(self, namespace: str, reason: str, n: int = 1) -> None:
        """n rows refused for this tenant (OVERLOAD verdicts, brownout
        sheds, namespace guards). A shed burns the whole budget for those
        requests: counted as over-objective in the burn windows too.
        Every shed path in the process funnels through here (door-level
        ``record_shed_indexed`` and the verdict counter's refusal
        statuses alike), so this is also the single feed point for the
        metric timeline's ``shed`` column — each refused row lands there
        exactly once."""
        if n <= 0:
            return
        t = self._tenant(namespace)
        with self._lock:
            t.shed[reason] = t.shed.get(reason, 0) + n
        for w in t.windows.values():
            w.record(n, n)
        from sentinel_tpu_torch.metrics.timeline import timeline

        timeline().record(namespace, n_shed=n)

    def record_shed_indexed(self, ns_idx, ns_names, reason: str) -> None:
        """Vectorized shed attribution off a ``(ns_idx, ns_names)`` pair
        (the ``TokenService.namespace_index`` shape the front doors use
        for rows that never reach the device)."""
        import numpy as np

        ns_idx = np.asarray(ns_idx)
        if ns_idx.shape[0] == 0:
            return
        counts = np.bincount(ns_idx + 1, minlength=len(ns_names) + 1)
        if counts[0]:
            self.record_shed("(no-rule)", reason, int(counts[0]))
        for j in np.nonzero(counts[1:])[0]:
            self.record_shed(ns_names[int(j)], reason, int(counts[1 + j]))

    # -- reading ------------------------------------------------------------
    def burn_rates(self, namespace: str) -> Dict[str, Optional[float]]:
        t = self._tenants.get(namespace)
        out: Dict[str, Optional[float]] = {}
        for name, _s in _WINDOWS:
            if t is None:
                out[name] = None
                continue
            total, over = t.windows[name].totals()
            out[name] = (
                (over / total) / BUDGET_FRACTION if total else None
            )
        return out

    def snapshot(self) -> dict:
        """The ``clusterServerStats``/black-box shape (and
        :func:`merge_fleet` input)."""
        with self._lock:
            names = list(self._tenants)
        tenants = {}
        for ns in names:
            t = self._tenants[ns]
            h = t.hist.snapshot()
            rates = {}
            windows = {}
            for name, _s in _WINDOWS:
                total, over = t.windows[name].totals()
                windows[name] = {"total": total, "over": over}
                rates[name] = (
                    round((over / total) / BUDGET_FRACTION, 4)
                    if total else None
                )
            rh = t.rt_hist.snapshot()
            rt_rates = {}
            rt_windows = {}
            for name, _s in _WINDOWS:
                total, over = t.rt_windows[name].totals()
                rt_windows[name] = {"total": total, "over": over}
                rt_rates[name] = (
                    round((over / total) / BUDGET_FRACTION, 4)
                    if total else None
                )
            tenants[ns] = {
                "count": h["count"],
                "p50Ms": h["p50"],
                "p99Ms": h["p99"],
                "maxMs": h["max"],
                "burnRate": rates,
                "windows": windows,
                "shed": dict(t.shed),
                "waited": int(t.waited),
                "completed": int(t.completed),
                "exceptions": int(t.exceptions),
                "rtP50Ms": rh["p50"],
                "rtP99Ms": rh["p99"],
                "rtMaxMs": rh["max"],
                "rtBurnRate": rt_rates,
                "rtWindows": rt_windows,
            }
        return {
            "objectiveMs": self.objective_ms,
            "rtObjectiveMs": self.rt_objective_ms,
            "tenants": tenants,
        }

    def render(self) -> str:
        """Prometheus 0.0.4 exposition of the whole plane."""
        lines = [
            "# HELP sentinel_slo_objective_ms Configured per-tenant p99 "
            "latency objective.",
            "# TYPE sentinel_slo_objective_ms gauge",
            f"sentinel_slo_objective_ms {self.objective_ms:g}",
            "# HELP sentinel_slo_rt_objective_ms Configured per-tenant p99 "
            "objective on reported completion RT.",
            "# TYPE sentinel_slo_rt_objective_ms gauge",
            f"sentinel_slo_rt_objective_ms {self.rt_objective_ms:g}",
        ]
        with self._lock:
            names = sorted(self._tenants)
        for i, ns in enumerate(names):
            t = self._tenants[ns]
            lines.append(t.hist.render_prometheus(
                "sentinel_slo_latency_ms",
                "Per-tenant decision latency (enqueue to verdict).",
                labels=f'namespace="{_escape(ns)}"',
                header=(i == 0),  # one HELP/TYPE per family, not per tenant
            ))
        first = True
        for ns in names:
            t = self._tenants[ns]
            if t.rt_hist.count:
                lines.append(t.rt_hist.render_prometheus(
                    "sentinel_slo_rt_ms",
                    "Per-tenant reported completion RT (OUTCOME_REPORT).",
                    labels=f'namespace="{_escape(ns)}"',
                    header=first,
                ))
                first = False
        burn_lines: List[str] = []
        rt_burn_lines: List[str] = []
        shed_lines: List[str] = []
        waited_lines: List[str] = []
        exc_lines: List[str] = []
        for ns in names:
            t = self._tenants[ns]
            for name, _s in _WINDOWS:
                total, over = t.windows[name].totals()
                if total:
                    rate = (over / total) / BUDGET_FRACTION
                    burn_lines.append(
                        f'sentinel_slo_burn_rate{{namespace="{_escape(ns)}"'
                        f',window="{name}"}} {rate:g}'
                    )
                total, over = t.rt_windows[name].totals()
                if total:
                    rate = (over / total) / BUDGET_FRACTION
                    rt_burn_lines.append(
                        f'sentinel_slo_rt_burn_rate'
                        f'{{namespace="{_escape(ns)}"'
                        f',window="{name}"}} {rate:g}'
                    )
            for reason, n in sorted(t.shed.items()):
                shed_lines.append(
                    f'sentinel_slo_shed_total{{namespace="{_escape(ns)}"'
                    f',reason="{reason}"}} {n}'
                )
            if t.waited:
                waited_lines.append(
                    f'sentinel_slo_waited_total{{namespace="{_escape(ns)}"'
                    f'}} {t.waited}'
                )
            if t.exceptions:
                exc_lines.append(
                    f'sentinel_slo_exceptions_total'
                    f'{{namespace="{_escape(ns)}"}} {t.exceptions}'
                )
        if burn_lines:
            lines.append(
                "# HELP sentinel_slo_burn_rate Error-budget burn vs the "
                "p99 objective (1.0 = sustainable)."
            )
            lines.append("# TYPE sentinel_slo_burn_rate gauge")
            lines.extend(burn_lines)
        if rt_burn_lines:
            lines.append(
                "# HELP sentinel_slo_rt_burn_rate Error-budget burn of "
                "reported completion RT vs the RT objective "
                "(1.0 = sustainable)."
            )
            lines.append("# TYPE sentinel_slo_rt_burn_rate gauge")
            lines.extend(rt_burn_lines)
        if shed_lines:
            lines.append(
                "# HELP sentinel_slo_shed_total Refused rows attributed "
                "per tenant."
            )
            lines.append("# TYPE sentinel_slo_shed_total counter")
            lines.extend(shed_lines)
        if waited_lines:
            lines.append(
                "# HELP sentinel_slo_waited_total SHOULD_WAIT verdicts "
                "(delayed admission: pacing / priority occupy) per tenant."
            )
            lines.append("# TYPE sentinel_slo_waited_total counter")
            lines.extend(waited_lines)
        if exc_lines:
            lines.append(
                "# HELP sentinel_slo_exceptions_total Reported completion "
                "exceptions per tenant (OUTCOME_REPORT exc flag)."
            )
            lines.append("# TYPE sentinel_slo_exceptions_total counter")
            lines.extend(exc_lines)
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# -- fleet merge --------------------------------------------------------------
def merge_fleet(snapshots: Iterable[dict]) -> dict:
    """Sum per-tenant SLO snapshots from every pod into the fleet view —
    the SLO-plane analog of ``cluster.namespaces.aggregate_snapshots``
    (and consumed on the same stats-pull path). Window totals and shed
    counts add; burn rates are recomputed from the summed windows (a mean
    of ratios would weight an idle pod equal to a loaded one); p99 keeps
    the worst pod's value (histograms don't merge across the wire — the
    conservative bound is the honest one). Malformed pod payloads
    contribute nothing, mirroring aggregate_snapshots' fault contract."""
    objective = None
    rt_objective = None
    tenants: Dict[str, dict] = {}
    for snap in snapshots:
        try:
            if callable(snap):
                snap = snap()
            if objective is None:
                objective = snap.get("objectiveMs")
            if rt_objective is None:
                rt_objective = snap.get("rtObjectiveMs")
            for ns, t in snap.get("tenants", {}).items():
                agg = tenants.setdefault(ns, {
                    "count": 0, "p99Ms": None, "windows": {
                        name: {"total": 0, "over": 0} for name, _s in _WINDOWS
                    }, "shed": {}, "waited": 0,
                    "completed": 0, "exceptions": 0, "rtP99Ms": None,
                    "rtWindows": {
                        name: {"total": 0, "over": 0} for name, _s in _WINDOWS
                    },
                })
                agg["count"] += int(t.get("count", 0))
                agg["waited"] += int(t.get("waited", 0))
                agg["completed"] += int(t.get("completed", 0))
                agg["exceptions"] += int(t.get("exceptions", 0))
                for key in ("p99Ms", "rtP99Ms"):
                    v = t.get(key)
                    if v is not None and (
                        agg[key] is None or v > agg[key]
                    ):
                        agg[key] = v
                for wkey in ("windows", "rtWindows"):
                    for name, _s in _WINDOWS:
                        w = t.get(wkey, {}).get(name, {})
                        agg[wkey][name]["total"] += int(w.get("total", 0))
                        agg[wkey][name]["over"] += int(w.get("over", 0))
                for reason, n in t.get("shed", {}).items():
                    agg["shed"][reason] = agg["shed"].get(reason, 0) + int(n)
        except Exception:
            from sentinel_tpu_torch.core.log import record_log

            record_log.exception("fleet SLO merge: pod snapshot dropped")
    for agg in tenants.values():
        for wkey, rkey in (("windows", "burnRate"),
                           ("rtWindows", "rtBurnRate")):
            rates = {}
            for name, _s in _WINDOWS:
                w = agg[wkey][name]
                rates[name] = (
                    round((w["over"] / w["total"]) / BUDGET_FRACTION, 4)
                    if w["total"] else None
                )
            agg[rkey] = rates
    return {
        "objectiveMs": objective,
        "rtObjectiveMs": rt_objective,
        "tenants": tenants,
    }


# -- singleton ----------------------------------------------------------------
_PLANE: Optional[SloPlane] = None
_PLANE_LOCK = threading.Lock()


def slo_plane() -> SloPlane:
    global _PLANE
    if _PLANE is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE = SloPlane()
    return _PLANE


def reset_slo_plane_for_tests() -> None:
    global _PLANE
    with _PLANE_LOCK:
        _PLANE = None
