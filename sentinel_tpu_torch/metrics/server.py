"""Server-side pipeline metrics: stage histograms, verdict counters, gauges.

The port's copy of ``sentinel_tpu/metrics/server.py``.

The analog of the reference's ``ClusterServerStatLogUtil`` + dashboard state
commands, grown into an always-on Prometheus surface: the ``TokenServer``
micro-batcher (asyncio and native front doors) records per-stage timings
here, ``DefaultTokenService`` feeds per-namespace verdict counters from each
materialized batch, and the Envoy RLS adapter mirrors its OK/OVER_LIMIT
responses in. One process-wide singleton — multiple servers in one process
(tests, port moves) share it, which matches Prometheus's per-process scrape
model.

Everything here renders under the ``sentinel_server_*`` prefix via
:func:`ServerMetrics.render` (appended to the exporter body) and as JSON via
:func:`ServerMetrics.snapshot` (the ``clusterServerStats`` command).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.metrics.histogram import LatencyHistogram

# TokenStatus codes that appear on the flow batch path → series label.
# (RELEASE_OK / ALREADY_RELEASE ride the host-side concurrent path, which
# answers per-request, not per-batch — they never reach this counter.)
VERDICT_NAMES: Dict[int, str] = {
    0: "pass",            # OK
    1: "block",           # BLOCKED
    2: "should_wait",     # SHOULD_WAIT (occupied-ahead admission)
    3: "no_rule",         # NO_RULE_EXISTS
    4: "too_many_request",  # namespace guard tripped
    5: "fail",            # device step failed / degraded
    8: "overload",        # admission refused: queue full / deadline / brownout
    9: "standby",         # unpromoted warm standby refused to decide
    10: "moved",          # namespace rebalanced away: redirect to new owner
    12: "degraded",       # circuit breaker OPEN/HALF_OPEN refused the row
}

# reasons on the sentinel_server_shed_total counter: every dropped or
# refused frame lands in exactly one of these
SHED_REASONS = (
    "queue_full",    # front-door queue at capacity → answered OVERLOAD
    "deadline",      # client deadline already blown → dropped (no answer)
    "brownout",      # SHED_LOW: non-prioritized rows answered OVERLOAD
    "degrade",       # DEGRADE: rows refused by the probabilistic local gate
    "lane_abandon",  # shutdown abandoned a wedged lane handoff
    "chaos_drop",    # a chaos frame_drop injector ate the frame
)

NO_RULE_NAMESPACE = "(no-rule)"  # requests whose flow_id has no loaded rule


def _escape(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _RateWindow:
    """Windowed events/sec over the last ``seconds`` wall seconds, current
    second included (so short-lived tests and fresh servers report > 0)."""

    def __init__(self, seconds: int = 8):
        self.seconds = max(1, int(seconds))
        self._slots = [(-1, 0)] * self.seconds  # (second, count)
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        sec = _clock.now_ms() // 1000
        i = sec % self.seconds
        with self._lock:
            slot_sec, count = self._slots[i]
            self._slots[i] = (sec, count + n if slot_sec == sec else n)

    def rate(self) -> float:
        sec = _clock.now_ms() // 1000
        lo = sec - self.seconds + 1
        with self._lock:
            total = sum(c for s, c in self._slots if s >= lo)
        return total / float(self.seconds)

    def reset(self) -> None:
        with self._lock:
            self._slots = [(-1, 0)] * self.seconds


class ServerMetrics:
    """All ``sentinel_server_*`` state for this process's token server(s)."""

    # gauges every scrape shows even before a server registers a live reader
    _GAUGE_NAMES = (
        "queue_depth", "inflight_batches", "connections",
        "dispatch_lane_depth", "reply_lane_depth",
        "shm_ring_occupancy", "device_inflight",
    )

    def __init__(self):
        # stage histograms, all in milliseconds except batch_size (requests).
        # 1µs..10s covers a sub-100µs device step and a 1s cold compile alike.
        self.queue_wait_ms = LatencyHistogram(lo=0.001, hi=10_000.0)
        self.decide_ms = LatencyHistogram(lo=0.001, hi=10_000.0)
        self.write_ms = LatencyHistogram(lo=0.001, hi=10_000.0)
        self.batch_size = LatencyHistogram(
            bounds=[float(1 << i) for i in range(17)]  # 1..65536, ×2 ladder
        )
        # per-lane stage histograms for the staged native pipeline:
        # intake_ms = wait_batch pull → handoff enqueue (decode copy + prep);
        # dispatch_ms = drain of the handoff queue → device dispatch issued
        # (host prep + async enqueue; the device step itself is decide_ms).
        self.intake_ms = LatencyHistogram(lo=0.001, hi=10_000.0)
        self.dispatch_ms = LatencyHistogram(lo=0.001, hi=10_000.0)
        # fused multi-frame dispatch: how many engine-batch frames each
        # chained device step folded together (depth 1 = unfused)
        self.fused_depth = LatencyHistogram(
            bounds=[float(1 << i) for i in range(7)]  # 1..64, ×2 ladder
        )
        self._fused_frames = 0
        self._fused_lock = threading.Lock()
        # traffic-shaping waits: every SHOULD_WAIT verdict that carried a
        # positive wait hint (paced admission or priority occupy) — count
        # plus the distribution of assigned waits (whole ms, ≥ 1)
        self.wait_assigned_ms = LatencyHistogram(lo=1.0, hi=60_000.0)
        self._wait_assigned = 0
        self._verdicts: Dict[Tuple[str, str], int] = {}
        self._verdict_lock = threading.Lock()
        self._rate = _RateWindow()
        # shed accounting: frames the server refused (answered OVERLOAD) or
        # dropped (deadline blown, abandoned lane), by reason — the number
        # that used to be invisible when _lane_put gave up silently
        self._shed: Dict[str, int] = {}
        self._shed_lock = threading.Lock()
        # per-intake-shard pull accounting (multi-door native server):
        # shard → {pulls, requests, busy_ms}. busy_ms is cumulative lane
        # busy time, so occupancy over a window is rate(busy_ms)/1000.
        self._shards: Dict[int, Dict[str, float]] = {}
        self._shard_lock = threading.Lock()
        # host bytes copied on the serving path (arena→staging memcpy,
        # fusion concatenate) — the bench divides by verdicts served to
        # report bytes-copied-per-verdict
        self._copy_bytes = 0
        self._copy_lock = threading.Lock()
        # double-buffered device lane: host prep/dispatch time spent while
        # an earlier fused group was still computing on device — work a
        # depth-1 lane would have serialized behind block_until_ready
        self._overlap_ms = 0.0
        self._overlap_lock = threading.Lock()
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._gauge_lock = threading.Lock()
        # sketch observability: the live token service registers a zero-arg
        # provider returning sketch.sketch_stats() (variant, fat/slim bytes,
        # merge counters). Most recent registration wins — same model as a
        # replacement server's gauges.
        self._sketch_provider: Optional[Callable[[], dict]] = None
        self._sketch_lock = threading.Lock()
        # shm front-door observability: the native server registers a
        # zero-arg provider returning the shm door's poll/doorbell/ring-full
        # counters (each independently monotonic; no cross-counter snapshot)
        self._shm_provider: Optional[Callable[[], dict]] = None
        self._shm_lock = threading.Lock()
        # wire-rev-5 lease observability: the live token service registers
        # a zero-arg provider returning its lease_stats() block (cumulative
        # granted/renewed/returned/revoked + outstanding gauges). Same
        # most-recent-wins weakref model as the sketch provider.
        self._lease_provider: Optional[Callable[[], dict]] = None
        self._lease_lock = threading.Lock()
        self._hier_provider: Optional[Callable[[], dict]] = None
        self._hier_lock = threading.Lock()
        # wire-rev-6 outcome observability: the live token service registers
        # a zero-arg provider returning its outcome_stats() block (reported/
        # exception/drop counters + per-flow windowed RT reads off the device
        # outcome columns). Same most-recent-wins weakref model as the rest.
        self._outcome_provider: Optional[Callable[[], dict]] = None
        self._outcome_lock = threading.Lock()
        # circuit-breaker observability: the live token service registers
        # a zero-arg reader returning its breaker_stats() block (per-flow
        # breaker state + clocks, read from the device state columns), and
        # pushes CLOSED/OPEN/HALF_OPEN transition edges through
        # count_breaker_transition as its host mirror observes them.
        self._breaker_provider: Optional[Callable[[], dict]] = None
        self._breaker_transitions: Dict[Tuple[str, str], int] = {}
        self._breaker_lock = threading.Lock()
        # wire-rev-7 push-plane observability: frames emitted by the push
        # hub (by type), lease revocations pushed, and the server-emit →
        # client-apply staleness histogram. Staleness is recorded by the
        # client-side apply off the frame's emit stamp — co-located
        # clients (shm, drills, sidecars sharing the exporter) land it in
        # this process; a remote client's applies surface on its own
        # exporter. A provider exposes the live hub's connection count
        # and drop counters.
        self._push_frames: Dict[str, int] = {}
        self._push_revocations = 0
        self._push_lock = threading.Lock()
        self.push_staleness_ms = LatencyHistogram(lo=0.01, hi=60_000.0)
        self._push_provider: Optional[Callable[[], dict]] = None

    # -- fused dispatch counters --------------------------------------------
    def record_fused(self, depth: int) -> None:
        """One fused device dispatch folding ``depth`` engine-batch frames
        into a single chained step (records the amortization the serving
        path achieved; depth 1 would mean no fusion and is not recorded)."""
        with self._fused_lock:
            self._fused_frames += int(depth)
        self.fused_depth.record(float(depth))

    @property
    def fused_frames_total(self) -> int:
        with self._fused_lock:
            return self._fused_frames

    @property
    def wait_assigned_total(self) -> int:
        with self._verdict_lock:
            return self._wait_assigned

    # -- intake shard + host-copy counters ----------------------------------
    def count_shard_pull(
        self, shard: int, n_rows: int, busy_ms: float
    ) -> None:
        """One intake pull handed to the device lane by ``shard``:
        ``n_rows`` requests, ``busy_ms`` of lane busy time."""
        with self._shard_lock:
            s = self._shards.setdefault(
                int(shard), {"pulls": 0, "requests": 0, "busy_ms": 0.0}
            )
            s["pulls"] += 1
            s["requests"] += int(n_rows)
            s["busy_ms"] += float(busy_ms)

    def shard_totals(self) -> Dict[int, Dict[str, float]]:
        with self._shard_lock:
            return {k: dict(v) for k, v in self._shards.items()}

    def count_copy_bytes(self, n: int) -> None:
        if n <= 0:
            return
        with self._copy_lock:
            self._copy_bytes += int(n)

    @property
    def host_copy_bytes_total(self) -> int:
        with self._copy_lock:
            return self._copy_bytes

    def count_overlap_saved_ms(self, ms: float) -> None:
        """``ms`` of host prep/dispatch that ran while an earlier fused
        group was still in flight on device (the pipelined device lane's
        measured win over a serialized depth-1 lane)."""
        if ms <= 0:
            return
        with self._overlap_lock:
            self._overlap_ms += float(ms)

    @property
    def overlap_saved_ms_total(self) -> float:
        with self._overlap_lock:
            return self._overlap_ms

    # -- shed counters ------------------------------------------------------
    def count_shed(self, reason: str, n: int = 1) -> None:
        """``n`` requests shed for ``reason`` (one of :data:`SHED_REASONS`,
        free-form tolerated so callers can't lose a count to a typo)."""
        if n <= 0:
            return
        with self._shed_lock:
            self._shed[reason] = self._shed.get(reason, 0) + int(n)

    def shed_totals(self) -> Dict[str, int]:
        with self._shed_lock:
            return dict(self._shed)

    @property
    def shed_total(self) -> int:
        with self._shed_lock:
            return sum(self._shed.values())

    def verdict_rate(self) -> float:
        """Windowed verdicts/sec — the throughput input of the BBR
        admission estimator (``overload/admission.py``)."""
        return self._rate.rate()

    # -- verdict counters ---------------------------------------------------
    def count_verdict(self, verdict: str, namespace: str, n: int = 1) -> None:
        key = (verdict, namespace)
        with self._verdict_lock:
            self._verdicts[key] = self._verdicts.get(key, 0) + n

    def verdict_totals_by_namespace(self) -> Dict[str, int]:
        """Cumulative verdicts served per namespace, all verdict classes
        summed — the admission gate diffs successive reads to rank the
        hottest namespaces for its rebalance advisories."""
        out: Dict[str, int] = {}
        with self._verdict_lock:
            for (_verdict, ns), count in self._verdicts.items():
                out[ns] = out.get(ns, 0) + count
        return out

    def record_verdict_batch(
        self,
        status: np.ndarray,
        ns_idx: Optional[np.ndarray],
        ns_names: Tuple[str, ...],
        latency_ms: Optional[float] = None,
        wait_ms: Optional[np.ndarray] = None,
    ) -> None:
        """Count one materialized batch: ``status`` int8[N] TokenStatus
        codes, ``ns_idx`` int32[N] namespace row per request (-1 → no rule;
        None → attribute everything to ``(no-rule)``). Vectorized — a few
        masked bincounts per batch, never a Python loop over requests.

        ``latency_ms`` (decision latency shared by the whole batch) feeds
        the per-tenant SLO plane; refusal statuses are attributed there as
        sheds either way. ``wait_ms`` int32[N] (the verdicts' wait hints)
        feeds the assigned-wait counter/histogram — only positive hints
        count, and only SHOULD_WAIT verdicts carry them."""
        status = np.asarray(status)
        n = int(status.shape[0])
        if n == 0:
            return
        self._rate.add(n)
        if wait_ms is not None:
            w = np.asarray(wait_ms)
            wmask = w > 0
            n_wait = int(wmask.sum())
            if n_wait:
                with self._verdict_lock:
                    self._wait_assigned += n_wait
                # batches repeat few distinct waits; record value-grouped
                for v, c in zip(*np.unique(w[wmask], return_counts=True)):
                    self.wait_assigned_ms.record(float(v), int(c))
        updates: Dict[Tuple[str, str], int] = {}
        for code, vname in VERDICT_NAMES.items():
            mask = status == code
            hits = int(mask.sum())
            if not hits:
                continue
            if ns_idx is None or not len(ns_names):
                updates[(vname, NO_RULE_NAMESPACE)] = hits
                continue
            counts = np.bincount(
                ns_idx[mask] + 1, minlength=len(ns_names) + 1
            )
            if counts[0]:
                updates[(vname, NO_RULE_NAMESPACE)] = int(counts[0])
            for j in np.nonzero(counts[1:])[0]:
                updates[(vname, ns_names[int(j)])] = int(counts[1 + j])
        with self._verdict_lock:
            for key, v in updates.items():
                self._verdicts[key] = self._verdicts.get(key, 0) + v
        self._feed_slo(updates, latency_ms)

    # refusal verdict → the SLO-plane shed reason it is attributed under
    _SLO_SHED_REASONS = {"overload": "overload", "too_many_request":
                         "namespace_guard", "moved": "moved",
                         "degraded": "degraded"}

    def _feed_slo(
        self,
        updates: Dict[Tuple[str, str], int],
        latency_ms: Optional[float],
    ) -> None:
        """Per-tenant SLO + timeline accounting off the verdict-batch
        updates: served rows record the batch's decision latency, refusals
        record as sheds (each row lands in exactly one window bucket —
        served OR shed). The timeline's shed column is fed from
        ``SloPlane.record_shed`` (which this calls), so timeline sums
        reconcile with both ``sentinel_server_verdicts_total`` and
        ``sentinel_slo_shed_total`` deltas."""
        from sentinel_tpu_torch.metrics.timeline import timeline
        from sentinel_tpu_torch.trace.slo import slo_plane

        plane = slo_plane()
        tl = timeline()
        served: Dict[str, int] = {}
        # timeline columns per namespace: [pass, block, other, waited]
        cols: Dict[str, List[int]] = {}
        for (vname, ns), v in updates.items():
            reason = self._SLO_SHED_REASONS.get(vname)
            if reason is not None:
                plane.record_shed(ns, reason, v)
                continue
            served[ns] = served.get(ns, 0) + v
            c = cols.setdefault(ns, [0, 0, 0, 0])
            if vname == "pass":
                c[0] += v
            elif vname == "block":
                c[1] += v
            elif vname == "should_wait":
                # delayed admission (pacing / priority occupy): served, but
                # attributed in its own column so a paced tenant's wall
                # shows shaping, not mystery "other" traffic
                c[3] += v
                plane.record_waited(ns, v)
            else:
                c[2] += v
        for ns, c in cols.items():
            tl.record(ns, n_pass=c[0], n_block=c[1], n_other=c[2],
                      latency_ms=latency_ms, n_waited=c[3])
        if latency_ms is not None:
            for ns, v in served.items():
                plane.record(ns, latency_ms, v)

    def count_rls(self, domain: str, ok_n: int, over_n: int) -> None:
        """Envoy RLS responses, per domain. The descriptors already counted
        once on the engine path under their rule namespace; this adds the
        RLS-shaped view (``namespace="rls:<domain>"``) without touching the
        verdicts/sec rate (no double counting)."""
        ns = f"rls:{domain}"
        with self._verdict_lock:
            if ok_n:
                key = ("pass", ns)
                self._verdicts[key] = self._verdicts.get(key, 0) + int(ok_n)
            if over_n:
                key = ("block", ns)
                self._verdicts[key] = self._verdicts.get(key, 0) + int(over_n)

    # -- gauges -------------------------------------------------------------
    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._gauge_lock:
            self._gauges[name] = fn

    def unregister_gauge(self, name: str, fn: Optional[Callable] = None) -> None:
        """Remove a gauge; with ``fn`` given, only if it is still the
        registered reader (a replacement server's gauge survives the old
        server's teardown)."""
        with self._gauge_lock:
            if fn is None or self._gauges.get(name) is fn:
                self._gauges.pop(name, None)

    def _gauge_values(self) -> Dict[str, float]:
        with self._gauge_lock:
            readers = dict(self._gauges)
        out = {name: 0.0 for name in self._GAUGE_NAMES}
        for name, fn in readers.items():
            try:
                out[name] = float(fn())
            except Exception:
                out[name] = 0.0  # a dying server's reader must not 500 a scrape
        return out

    # -- sketch provider ----------------------------------------------------
    def register_sketch_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the param-sketch stats block
        (the reference's ``sketch.sketch_stats`` shape). The most recently
        constructed service wins; providers return ``{}`` once their
        service is gone."""
        with self._sketch_lock:
            self._sketch_provider = fn

    def sketch_stats(self) -> dict:
        with self._sketch_lock:
            fn = self._sketch_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down service's reader must not 500 a scrape

    # -- shm front door provider --------------------------------------------
    def register_shm_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the shm ring door's counters
        (``{"polls", "doorbells", "ring_full", "segments"}``). Most recent
        registration wins; providers return ``{}`` once their door is
        gone. Values are independently monotonic relaxed atomics — the
        exporter renders each as its own counter, never arithmetic across
        them."""
        with self._shm_lock:
            self._shm_provider = fn

    def shm_stats(self) -> dict:
        with self._shm_lock:
            fn = self._shm_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down door's reader must not 500 a scrape

    # -- lease provider -----------------------------------------------------
    def register_lease_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the token service's lease stats
        (``DefaultTokenService.lease_stats`` shape). Most recent
        registration wins; providers return ``{}`` once their service is
        gone."""
        with self._lease_lock:
            self._lease_provider = fn

    def lease_stats(self) -> dict:
        with self._lease_lock:
            fn = self._lease_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down service's reader must not 500 a scrape

    # -- hierarchy provider -------------------------------------------------
    def register_hier_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the hierarchy tier's stats
        (``DefaultTokenService.hier_stats`` shape — coordinator ledger
        and/or share-agent counters, ``{}`` when neither is attached).
        Most recent registration wins."""
        with self._hier_lock:
            self._hier_provider = fn

    def hier_stats(self) -> dict:
        with self._hier_lock:
            fn = self._hier_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down service's reader must not 500 a scrape

    # -- outcome provider ---------------------------------------------------
    def register_outcome_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the token service's completion
        outcome stats (``DefaultTokenService.outcome_stats`` shape:
        cumulative reported/exception/drop counters plus per-flow windowed
        complete/exception QPS and RT avg/p99 read from the device outcome
        columns). Most recent registration wins; providers return ``{}``
        once their service is gone."""
        with self._outcome_lock:
            self._outcome_provider = fn

    def outcome_stats(self) -> dict:
        with self._outcome_lock:
            fn = self._outcome_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down service's reader must not 500 a scrape

    # -- breaker provider ---------------------------------------------------
    def register_breaker_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the token service's circuit
        breaker stats (``DefaultTokenService.breaker_stats`` shape:
        per-flow breaker state name + clocks read from the device
        ``BreakerState`` columns; ``{}`` with no breakers loaded). Most
        recent registration wins; providers return ``{}`` once their
        service is gone."""
        with self._breaker_lock:
            self._breaker_provider = fn

    def breaker_stats(self) -> dict:
        with self._breaker_lock:
            fn = self._breaker_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down service's reader must not 500 a scrape

    def count_breaker_transition(
        self, from_state: str, to_state: str, n: int = 1
    ) -> None:
        """``n`` breaker transitions ``from_state`` → ``to_state`` observed
        by the host mirror (state names: closed / open / half_open)."""
        if n <= 0:
            return
        key = (str(from_state), str(to_state))
        with self._breaker_lock:
            self._breaker_transitions[key] = (
                self._breaker_transitions.get(key, 0) + int(n)
            )

    def breaker_transition_totals(self) -> Dict[Tuple[str, str], int]:
        with self._breaker_lock:
            return dict(self._breaker_transitions)

    # -- push plane ---------------------------------------------------------
    def count_push_frame(self, type_name: str, n: int = 1) -> None:
        """``n`` rev-7 push frames of ``type_name`` handed to connection
        sinks (counted per delivery attempt that reached a sink, not per
        broadcast call — a hub with no connections counts nothing)."""
        if n <= 0:
            return
        with self._push_lock:
            self._push_frames[type_name] = (
                self._push_frames.get(type_name, 0) + int(n)
            )

    def count_push_revocation(self, n: int = 1) -> None:
        """``n`` leases recalled through pushed LEASE_REVOKE frames (one
        per revoked lease, regardless of how many connections heard it)."""
        if n <= 0:
            return
        with self._push_lock:
            self._push_revocations += int(n)

    def record_push_staleness(self, ms: float, n: int = 1) -> None:
        """One server-emit → client-apply staleness sample (ms), recorded
        by the client-side push apply off the frame's emit stamp."""
        self.push_staleness_ms.record(max(0.0, float(ms)), n)

    def push_frame_totals(self) -> Dict[str, int]:
        with self._push_lock:
            return dict(self._push_frames)

    @property
    def push_revocations_total(self) -> int:
        with self._push_lock:
            return self._push_revocations

    def register_push_provider(self, fn: Callable[[], dict]) -> None:
        """Install the zero-arg reader for the live push hub's state
        (``PushHub.stats`` shape: attached connections, per-type emit
        counts, drops). Most recent registration wins; providers return
        ``{}`` once their hub is gone."""
        with self._push_lock:
            self._push_provider = fn

    def push_stats(self) -> dict:
        with self._push_lock:
            fn = self._push_provider
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:
            return {}  # a torn-down hub's reader must not 500 a scrape

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON shape served by the ``clusterServerStats`` command — the
        same numbers the Prometheus surface renders."""
        with self._verdict_lock:
            verdicts = [
                {"verdict": v, "namespace": ns, "count": c}
                for (v, ns), c in sorted(self._verdicts.items())
            ]
        return {
            "verdicts": verdicts,
            "verdictsPerSec": self._rate.rate(),
            "fusedFramesTotal": self.fused_frames_total,
            "shedTotal": self.shed_total,
            "shedByReason": self.shed_totals(),
            "hostCopyBytesTotal": self.host_copy_bytes_total,
            "overlapSavedMsTotal": round(self.overlap_saved_ms_total, 3),
            "intakeShards": {
                str(k): v for k, v in sorted(self.shard_totals().items())
            },
            "sketch": self.sketch_stats(),
            "shm": self.shm_stats(),
            "lease": self.lease_stats(),
            "hier": self.hier_stats(),
            "outcome": self.outcome_stats(),
            "breaker": {
                **self.breaker_stats(),
                "transitions": [
                    {"from": f, "to": t, "count": c}
                    for (f, t), c in sorted(
                        self.breaker_transition_totals().items()
                    )
                ],
            },
            "push": {
                **self.push_stats(),
                "frames": self.push_frame_totals(),
                "revocations": self.push_revocations_total,
                "stalenessMs": self.push_staleness_ms.snapshot(),
            },
            "stages": {
                "queue_wait_ms": self.queue_wait_ms.snapshot(),
                "decide_ms": self.decide_ms.snapshot(),
                "write_ms": self.write_ms.snapshot(),
                "batch_size": self.batch_size.snapshot(),
                "intake_ms": self.intake_ms.snapshot(),
                "dispatch_ms": self.dispatch_ms.snapshot(),
                "fused_depth": self.fused_depth.snapshot(),
                "wait_assigned_ms": self.wait_assigned_ms.snapshot(),
            },
            "waitAssignedTotal": self.wait_assigned_total,
            "gauges": self._gauge_values(),
        }

    def stage_snapshot(self) -> Dict[str, dict]:
        """Trimmed per-stage view for bench artifacts: p50/p99/count."""
        out = {}
        for name, hist in (
            ("queue_wait_ms", self.queue_wait_ms),
            ("decide_ms", self.decide_ms),
            ("write_ms", self.write_ms),
            ("batch_size", self.batch_size),
            ("intake_ms", self.intake_ms),
            ("dispatch_ms", self.dispatch_ms),
            ("fused_depth", self.fused_depth),
            ("wait_assigned_ms", self.wait_assigned_ms),
        ):
            snap = hist.snapshot()
            out[name] = {
                "p50": snap["p50"], "p99": snap["p99"],
                "count": snap["count"],
                # per-lane busy time over the snapshot window — the serve
                # bench derives lane occupancy from sum/wall
                "sum": round(snap["sum"], 3),
            }
        out["fused_frames_total"] = self.fused_frames_total
        out["shed_total"] = self.shed_totals()
        out["host_copy_bytes_total"] = self.host_copy_bytes_total
        out["overlap_saved_ms_total"] = round(self.overlap_saved_ms_total, 3)
        out["intake_shards"] = {
            str(k): v for k, v in sorted(self.shard_totals().items())
        }
        return out

    def render(self) -> str:
        """``sentinel_server_*`` Prometheus exposition (no trailing
        newline; the exporter joins sections)."""
        lines = [
            "# HELP sentinel_server_verdicts_total Cluster token verdicts "
            "by class and namespace (cumulative).",
            "# TYPE sentinel_server_verdicts_total counter",
        ]
        with self._verdict_lock:
            items = sorted(self._verdicts.items())
        if items:
            for (verdict, ns), count in items:
                lines.append(
                    "sentinel_server_verdicts_total"
                    f'{{verdict="{_escape(verdict)}",'
                    f'namespace="{_escape(ns)}"}} {count}'
                )
        else:
            # zero-sample so the series exists on an idle server and rate()
            # queries don't gap at startup
            lines.append(
                'sentinel_server_verdicts_total{verdict="pass",'
                'namespace="default"} 0'
            )
        lines.append(
            "# HELP sentinel_server_verdicts_per_sec Verdicts per second "
            "(8s window)."
        )
        lines.append("# TYPE sentinel_server_verdicts_per_sec gauge")
        lines.append(f"sentinel_server_verdicts_per_sec {self._rate.rate():g}")
        lines.append(
            "# HELP sentinel_server_fused_frames_total Engine-batch frames "
            "folded into chained multi-frame device dispatches (cumulative)."
        )
        lines.append("# TYPE sentinel_server_fused_frames_total counter")
        lines.append(
            f"sentinel_server_fused_frames_total {self.fused_frames_total}"
        )
        lines.append(
            "# HELP sentinel_server_shed_total Requests refused (OVERLOAD) "
            "or dropped by the server, by reason (cumulative)."
        )
        lines.append("# TYPE sentinel_server_shed_total counter")
        shed = self.shed_totals()
        if shed:
            for reason, count in sorted(shed.items()):
                lines.append(
                    "sentinel_server_shed_total"
                    f'{{reason="{_escape(reason)}"}} {count}'
                )
        else:
            # zero-sample so the series exists before the first shed and
            # rate() queries don't gap when overload begins
            lines.append('sentinel_server_shed_total{reason="queue_full"} 0')
        lines.append(
            "# HELP sentinel_server_host_copy_bytes_total Host bytes "
            "copied on the serving path (arena staging + fusion concat)."
        )
        lines.append("# TYPE sentinel_server_host_copy_bytes_total counter")
        lines.append(
            f"sentinel_server_host_copy_bytes_total "
            f"{self.host_copy_bytes_total}"
        )
        lines.append(
            "# HELP sentinel_server_overlap_saved_ms_total Host prep/"
            "dispatch time spent while an earlier fused group was still "
            "computing on device — serialized time a depth-1 device lane "
            "would have added (ms, cumulative)."
        )
        lines.append("# TYPE sentinel_server_overlap_saved_ms_total counter")
        lines.append(
            "sentinel_server_overlap_saved_ms_total "
            f"{self.overlap_saved_ms_total:g}"
        )
        shards = self.shard_totals()
        if shards:
            for mname, skey, help_text in (
                ("shard_pulls_total", "pulls",
                 "Intake pulls handed to the device lane, per shard."),
                ("shard_requests_total", "requests",
                 "Requests pulled through each intake shard."),
                ("shard_intake_busy_ms_total", "busy_ms",
                 "Cumulative intake-lane busy time per shard (ms); "
                 "rate()/1000 is the shard's occupancy."),
            ):
                lines.append(f"# HELP sentinel_server_{mname} {help_text}")
                lines.append(f"# TYPE sentinel_server_{mname} counter")
                for shard, vals in sorted(shards.items()):
                    lines.append(
                        f'sentinel_server_{mname}{{shard="{shard}"}} '
                        f"{vals[skey]:g}"
                    )
        sketch = self.sketch_stats()
        lines.append(
            "# HELP sentinel_sketch_merges_total SALSA counter-pair merges "
            "in the param sketch, by rule slot (cumulative)."
        )
        lines.append("# TYPE sentinel_sketch_merges_total counter")
        by_slot = sketch.get("mergesBySlot") or {}
        if by_slot:
            for slot, count in sorted(
                (int(s), int(c)) for s, c in by_slot.items()
            ):
                lines.append(
                    f'sentinel_sketch_merges_total{{slot="{slot}"}} {count}'
                )
        else:
            # zero-sample so the series exists before the first merge (or on
            # the cms variant, which never merges)
            lines.append('sentinel_sketch_merges_total{slot="0"} 0')
        for mname, skey, help_text in (
            ("sentinel_sketch_slim_bytes_total", "slimBytes",
             "HBM bytes held by the SF slim twin of the param sketch "
             "(what per-tick replication deltas ship)."),
            ("sentinel_sketch_fat_bytes_total", "fatBytes",
             "HBM bytes held by the fat (update) param sketch."),
        ):
            lines.append(f"# HELP {mname} {help_text}")
            lines.append(f"# TYPE {mname} gauge")
            lines.append(f"{mname} {int(sketch.get(skey, 0) or 0)}")
        shm = self.shm_stats()
        for mname, skey, help_text in (
            ("shm_polls_total", "polls",
             "Shm ring poller wake-to-idle cycles (spin or futex) "
             "(cumulative)."),
            ("shm_doorbells_total", "doorbells",
             "Futex doorbell rings by co-located shm clients — each one is "
             "a syscall the steady state avoided elsewhere (cumulative)."),
            ("shm_ring_full_total", "ring_full",
             "Response-ring pushes dropped after the bounded wait because "
             "the client stopped draining (cumulative)."),
        ):
            lines.append(f"# HELP sentinel_server_{mname} {help_text}")
            lines.append(f"# TYPE sentinel_server_{mname} counter")
            lines.append(
                f"sentinel_server_{mname} {int(shm.get(skey, 0) or 0)}"
            )
        lease = self.lease_stats()
        for mname, skey, help_text in (
            ("sentinel_lease_granted_total", "granted",
             "Wire-rev-5 leases granted: short-TTL client-local admission "
             "slices charged to the LEASED window column (cumulative)."),
            ("sentinel_lease_renewed_total", "renewed",
             "Lease renewals: unused tokens credited, fresh slice granted "
             "(cumulative)."),
            ("sentinel_lease_returned_total", "returned",
             "Leases returned early by clients (cumulative)."),
            ("sentinel_lease_revoked_total", "revoked",
             "Leases ended server-side: TTL expiry, rule-reload drop, or "
             "MOVE recall (cumulative)."),
        ):
            lines.append(f"# HELP {mname} {help_text}")
            lines.append(f"# TYPE {mname} counter")
            lines.append(f"{mname} {int(lease.get(skey, 0) or 0)}")
        for mname, skey, help_text in (
            ("sentinel_lease_outstanding", "outstanding",
             "Live (unexpired, unreturned) leases right now."),
            ("sentinel_lease_outstanding_tokens", "outstanding_tokens",
             "Tokens currently delegated on live leases — the bound on "
             "crash over-admission."),
        ):
            lines.append(f"# HELP {mname} {help_text}")
            lines.append(f"# TYPE {mname} gauge")
            lines.append(f"{mname} {int(lease.get(skey, 0) or 0)}")
        hier = self.hier_stats()
        if hier:
            for mname, skey, help_text in (
                ("sentinel_hier_share_grants_total", "share_grants",
                 "Global-budget shares granted/regranted to pods by the "
                 "coordinator (cumulative)."),
                ("sentinel_hier_reconciles_total", "reconciles",
                 "Coordinator reconciliation passes: water-fill share "
                 "targets over reported demand (cumulative)."),
                ("sentinel_hier_demand_reports_total", "demand_reports",
                 "Per-tick pod demand reports received by the coordinator "
                 "(cumulative)."),
            ):
                lines.append(f"# HELP {mname} {help_text}")
                lines.append(f"# TYPE {mname} counter")
                lines.append(f"{mname} {int(hier.get(skey, 0) or 0)}")
            shares = hier.get("share_tokens") or {}
            if isinstance(shares, dict):
                lines.append(
                    "# HELP sentinel_hier_share_tokens Tokens of the global "
                    "budget currently provisioned to pod shares, per flow "
                    "(coordinator view when co-located, else this pod's own "
                    "share)."
                )
                lines.append("# TYPE sentinel_hier_share_tokens gauge")
                for fid in sorted(shares, key=str):
                    lines.append(
                        f'sentinel_hier_share_tokens{{flow="{fid}"}} '
                        f"{int(shares[fid] or 0)}"
                    )
        outcome = self.outcome_stats()
        for mname, skey, help_text in (
            ("sentinel_outcome_reported_total", "reported",
             "Completion outcomes accepted into the device outcome columns "
             "(OUTCOME_REPORT rows past validation) (cumulative)."),
            ("sentinel_outcome_exceptions_total", "exceptions",
             "Accepted completion outcomes flagged as exceptions "
             "(cumulative)."),
            ("sentinel_outcome_batches_total", "batches",
             "OUTCOME_REPORT batches ingested (cumulative)."),
            ("sentinel_outcome_rt_sum_ms_total", "rt_sum_ms",
             "Sum of accepted reported response times (ms, cumulative) — "
             "divide rates for the fleet RT average."),
        ):
            lines.append(f"# HELP {mname} {help_text}")
            lines.append(f"# TYPE {mname} counter")
            lines.append(f"{mname} {int(outcome.get(skey, 0) or 0)}")
        lines.append(
            "# HELP sentinel_outcome_dropped_total Reported outcomes "
            "rejected at the wire boundary, by reason (negative / "
            "non_finite / too_large / unknown_flow) (cumulative)."
        )
        lines.append("# TYPE sentinel_outcome_dropped_total counter")
        dropped = outcome.get("dropped") or {}
        if dropped:
            for reason, count in sorted(dropped.items()):
                lines.append(
                    "sentinel_outcome_dropped_total"
                    f'{{reason="{_escape(str(reason))}"}} {int(count)}'
                )
        else:
            # zero-sample so the series exists before the first bad report
            lines.append(
                'sentinel_outcome_dropped_total{reason="negative"} 0'
            )
        flows = outcome.get("flows") or {}
        if flows:
            for mname, fkey, help_text in (
                ("sentinel_flow_complete_qps", "complete_qps",
                 "Windowed reported completions per second, per flow "
                 "(device outcome columns)."),
                ("sentinel_flow_exception_qps", "exception_qps",
                 "Windowed reported exceptions per second, per flow."),
                ("sentinel_flow_rt_avg_ms", "rt_avg_ms",
                 "Windowed average reported RT per flow (ms)."),
                ("sentinel_flow_rt_p99_ms", "rt_p99_ms",
                 "Windowed p99 reported RT per flow (ms), from the "
                 "device-side log2 RT histogram (bucket upper edge)."),
            ):
                lines.append(f"# HELP {mname} {help_text}")
                lines.append(f"# TYPE {mname} gauge")
                for fid in sorted(flows, key=int):
                    vals = flows[fid] or {}
                    lines.append(
                        f'{mname}{{flow_id="{int(fid)}"}} '
                        f"{float(vals.get(fkey, 0.0) or 0.0):g}"
                    )
        lines.append(
            "# HELP sentinel_breaker_transitions_total Circuit-breaker "
            "state transitions observed by the host mirror, by edge "
            "(cumulative)."
        )
        lines.append("# TYPE sentinel_breaker_transitions_total counter")
        transitions = self.breaker_transition_totals()
        if transitions:
            for (frm, to), count in sorted(transitions.items()):
                lines.append(
                    "sentinel_breaker_transitions_total"
                    f'{{from="{_escape(frm)}",to="{_escape(to)}"}} {count}'
                )
        else:
            # zero-sample so the series exists before the first trip
            lines.append(
                'sentinel_breaker_transitions_total'
                '{from="closed",to="open"} 0'
            )
        lines.append(
            "# HELP sentinel_push_frames_total Wire-rev-7 push frames "
            "handed to connection sinks, by type (cumulative)."
        )
        lines.append("# TYPE sentinel_push_frames_total counter")
        push_frames = self.push_frame_totals()
        if push_frames:
            for tname, count in sorted(push_frames.items()):
                lines.append(
                    "sentinel_push_frames_total"
                    f'{{type="{_escape(tname)}"}} {count}'
                )
        else:
            # zero-sample so the series exists before the first push
            lines.append('sentinel_push_frames_total{type="lease_revoke"} 0')
        lines.append(
            "# HELP sentinel_push_revocations_total Leases recalled through "
            "pushed LEASE_REVOKE frames (cumulative)."
        )
        lines.append("# TYPE sentinel_push_revocations_total counter")
        lines.append(
            f"sentinel_push_revocations_total {self.push_revocations_total}"
        )
        lines.append(self.push_staleness_ms.render_prometheus(
            "sentinel_push_staleness_ms",
            "Server-emit to client-apply staleness of rev-7 push frames "
            "(ms), recorded by co-located client applies off the frame's "
            "emit stamp.",
        ))
        breaker = self.breaker_stats()
        br_flows = breaker.get("flows") or {}
        if br_flows:
            lines.append(
                "# HELP sentinel_breaker_state Circuit-breaker state per "
                "flow (0 = closed, 1 = open, 2 = half_open), read from the "
                "device BreakerState columns."
            )
            lines.append("# TYPE sentinel_breaker_state gauge")
            for fid in sorted(br_flows, key=int):
                vals = br_flows[fid] or {}
                lines.append(
                    f'sentinel_breaker_state{{flow_id="{int(fid)}"}} '
                    f"{int(vals.get('state_code', 0) or 0)}"
                )
        gauges = self._gauge_values()
        for name, help_text in (
            ("queue_depth", "Requests queued awaiting a device step."),
            ("inflight_batches", "Batches currently in the device pipeline."),
            ("connections", "Open client connections."),
            ("dispatch_lane_depth",
             "Decoded pulls queued between the intake and device lanes."),
            ("reply_lane_depth",
             "Dispatched batches queued between the device and reply lanes."),
            ("shm_ring_occupancy",
             "Fraction of shm request-ring slots occupied across attached "
             "segments (sampled; 0 when no shm door is serving)."),
            ("device_inflight",
             "Fused groups dispatched to the device and not yet "
             "materialized (bounded by max_device_inflight)."),
        ):
            lines.append(f"# HELP sentinel_server_{name} {help_text}")
            lines.append(f"# TYPE sentinel_server_{name} gauge")
            lines.append(f"sentinel_server_{name} {gauges[name]:g}")
        for name, help_text, hist in (
            ("sentinel_server_queue_wait_ms",
             "Enqueue-to-batch-drain wait per queue item (ms).",
             self.queue_wait_ms),
            ("sentinel_server_decide_ms",
             "Device decide step per batch, dispatch to materialized (ms).",
             self.decide_ms),
            ("sentinel_server_write_ms",
             "Host write-out per batch: verdict encode + socket write (ms).",
             self.write_ms),
            ("sentinel_server_batch_size",
             "Requests per device batch.",
             self.batch_size),
            ("sentinel_server_intake_ms",
             "Intake lane: front-door pull to handoff enqueue (ms).",
             self.intake_ms),
            ("sentinel_server_dispatch_ms",
             "Device lane: handoff drain to device dispatch issued (ms).",
             self.dispatch_ms),
            ("sentinel_server_fused_depth",
             "Engine-batch frames per fused device dispatch.",
             self.fused_depth),
            ("sentinel_server_wait_assigned_ms",
             "Wait assigned per SHOULD_WAIT verdict: paced admission or "
             "priority occupy delay (ms).",
             self.wait_assigned_ms),
        ):
            lines.append(hist.render_prometheus(name, help_text))
        lines.append(
            "# HELP sentinel_server_wait_assigned_total SHOULD_WAIT "
            "verdicts that carried a positive wait hint (cumulative)."
        )
        lines.append("# TYPE sentinel_server_wait_assigned_total counter")
        lines.append(
            f"sentinel_server_wait_assigned_total {self.wait_assigned_total}"
        )
        return "\n".join(lines)

    def reset(self) -> None:
        """Zero counters and histograms in place (gauge readers stay —
        their owners' lifecycles manage them). Benches call this between
        load points; tests via :func:`reset_server_metrics_for_tests`."""
        self.queue_wait_ms.reset()
        self.decide_ms.reset()
        self.write_ms.reset()
        self.batch_size.reset()
        self.intake_ms.reset()
        self.dispatch_ms.reset()
        self.fused_depth.reset()
        self.wait_assigned_ms.reset()
        with self._fused_lock:
            self._fused_frames = 0
        with self._verdict_lock:
            self._verdicts.clear()
            self._wait_assigned = 0
        with self._shed_lock:
            self._shed.clear()
        with self._shard_lock:
            self._shards.clear()
        with self._copy_lock:
            self._copy_bytes = 0
        with self._sketch_lock:
            self._sketch_provider = None
        with self._shm_lock:
            self._shm_provider = None
        with self._lease_lock:
            self._lease_provider = None
        with self._hier_lock:
            self._hier_provider = None
        with self._outcome_lock:
            self._outcome_provider = None
        with self._breaker_lock:
            self._breaker_provider = None
            self._breaker_transitions.clear()
        with self._push_lock:
            self._push_provider = None
            self._push_frames.clear()
            self._push_revocations = 0
        self.push_staleness_ms.reset()
        self._rate.reset()


_SINGLETON = ServerMetrics()


def server_metrics() -> ServerMetrics:
    """The process-wide server metrics registry."""
    return _SINGLETON


def reset_server_metrics_for_tests() -> None:
    _SINGLETON.reset()
    # the SLO plane, metric timeline, and flight-recorder rings are fed off
    # this registry's paths; a test that resets one expects all to start clean
    from sentinel_tpu_torch.metrics.timeline import reset_timeline_for_tests
    from sentinel_tpu_torch.trace import ring as _trace_ring
    from sentinel_tpu_torch.trace.slo import reset_slo_plane_for_tests

    reset_slo_plane_for_tests()
    reset_timeline_for_tests()
    _trace_ring.reset_for_tests()
