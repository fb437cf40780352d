"""Per-namespace per-second metric timeline: the cluster-door analog of
``metrics/log.py``.

The port's copy of ``sentinel_tpu/metrics/timeline.py``.

The reference's ``metric.log`` answers "which resource degraded when" —
``MetricWriter`` appends one line per resource per second into size-rolled
files and ``MetricSearcher`` reads a time range back for the dashboard's
realtime fetch. On the cluster serving path the resource axis is the tenant
namespace and the interesting fields are the verdict classes the doors
actually emit, so this module keeps a per-namespace per-second ring of

    pass / block / shed / other counts  +  log-bucketed decision latency

with the same two read surfaces as the local metric log:

- an **in-memory queryable window** (default 10 minutes) behind the
  ``cluster/server/metric`` transport command and the scenario gates, and
- **append-only size-rolled files** (``{app}-timeline.log.N`` + ``.idx``
  second→offset index, MetricWriter parity) when a directory is configured
  (``SENTINEL_TIMELINE_DIR`` or :func:`configure_timeline`), so the window
  survives the process for post-hoc analysis.

Feeding happens on the paths that already exist: ``ServerMetrics``'s
verdict-batch accounting records served rows (with the batch's decision
latency) and ``SloPlane.record_shed`` forwards every refusal, so each row
lands in the timeline exactly once — timeline ``pass``/``block`` sums
reconcile with ``sentinel_server_verdicts_total`` deltas for the same
window, and ``shed`` sums with ``sentinel_slo_shed_total``.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from sentinel_tpu_torch.core.config import SentinelConfig

KEY_WINDOW_S = "sentinel.tpu.timeline.window.s"
ENV_DIR = "SENTINEL_TIMELINE_DIR"

# latency bucket edges (ms): 6/decade over 0.01ms..10s — fine enough to
# resolve a 2ms p99 objective, coarse enough that a second's worth of
# buckets is 37 small ints per tenant
_EDGES = np.geomspace(0.01, 10_000.0, 37)
_N_LAT = len(_EDGES)  # searchsorted index 0.._N_LAT (last = overflow)


@dataclass
class TimelineSample:
    """One (second, namespace) point — the line unit of the timeline log,
    ``MetricNode`` parity with the namespace as the resource."""

    timestamp_ms: int
    namespace: str
    passed: int = 0
    blocked: int = 0
    shed: int = 0
    other: int = 0
    p99_ms: Optional[float] = None
    max_ms: Optional[float] = None
    waited: int = 0  # SHOULD_WAIT: delayed admissions (pacing / occupy)
    completed: int = 0  # reported completions landing this second
    exceptions: int = 0  # completions that ended in a business exception
    rt_sum_ms: int = 0  # summed completion RT (avg = rt_sum_ms / completed)

    def to_line(self) -> str:
        ts = self.timestamp_ms // 1000 * 1000
        ns = self.namespace.replace("|", "_")
        p99 = -1.0 if self.p99_ms is None else self.p99_ms
        mx = -1.0 if self.max_ms is None else self.max_ms
        # waited rides as a 9th field so pre-shaping readers (8-field
        # parsers) keep working on new files; the outcome columns
        # (completed/exceptions/rt_sum) ride as fields 10-12 the same way
        return (
            f"{ts}|{ns}|{self.passed}|{self.blocked}|{self.shed}|"
            f"{self.other}|{p99:g}|{mx:g}|{self.waited}|"
            f"{self.completed}|{self.exceptions}|{self.rt_sum_ms}"
        )

    @classmethod
    def from_line(cls, line: str) -> "TimelineSample":
        p = line.rstrip("\n").split("|")
        p99 = float(p[6])
        mx = float(p[7]) if len(p) > 7 else -1.0
        return cls(
            timestamp_ms=int(p[0]),
            namespace=p[1],
            passed=int(p[2]),
            blocked=int(p[3]),
            shed=int(p[4]),
            other=int(p[5]),
            p99_ms=None if p99 < 0 else p99,
            max_ms=None if mx < 0 else mx,
            waited=int(p[8]) if len(p) > 8 else 0,
            completed=int(p[9]) if len(p) > 9 else 0,
            exceptions=int(p[10]) if len(p) > 10 else 0,
            rt_sum_ms=int(p[11]) if len(p) > 11 else 0,
        )

    def as_dict(self) -> dict:
        return {
            "timestampMs": self.timestamp_ms,
            "namespace": self.namespace,
            "pass": self.passed,
            "block": self.blocked,
            "shed": self.shed,
            "other": self.other,
            "waited": self.waited,
            "p99Ms": self.p99_ms,
            "maxMs": self.max_ms,
            "completed": self.completed,
            "exceptions": self.exceptions,
            "rtSumMs": self.rt_sum_ms,
            "rtAvgMs": (
                self.rt_sum_ms / self.completed if self.completed else None
            ),
        }


class _NsRing:
    """Per-namespace ring of ``window_s`` seconds; stale slots are lazily
    reused on write (same model as the SLO plane's burn windows) so
    recording never sweeps."""

    __slots__ = ("window_s", "stamp", "counts", "lat", "lat_max")

    def __init__(self, window_s: int):
        self.window_s = window_s
        self.stamp = np.zeros(window_s, np.int64)
        # columns: pass, block, shed, other, waited, completed, exceptions,
        # rt_sum_ms
        self.counts = np.zeros((window_s, 8), np.int64)
        self.lat = np.zeros((window_s, _N_LAT + 1), np.int64)
        self.lat_max = np.zeros(window_s, np.float64)

    def slot(self, sec: int) -> int:
        i = sec % self.window_s
        if self.stamp[i] != sec:
            self.stamp[i] = sec
            self.counts[i] = 0
            self.lat[i] = 0
            self.lat_max[i] = 0.0
        return i

    def sample(self, namespace: str, sec: int) -> Optional[TimelineSample]:
        i = sec % self.window_s
        if self.stamp[i] != sec:
            return None
        c = self.counts[i]
        row = self.lat[i]
        total = int(row.sum())
        p99 = mx = None
        if total:
            k = int(np.searchsorted(np.cumsum(row), 0.99 * total))
            p99 = float(_EDGES[min(k, _N_LAT - 1)])
            mx = float(self.lat_max[i])
        return TimelineSample(
            timestamp_ms=sec * 1000,
            namespace=namespace,
            passed=int(c[0]),
            blocked=int(c[1]),
            shed=int(c[2]),
            other=int(c[3]),
            p99_ms=p99,
            max_ms=mx,
            waited=int(c[4]),
            completed=int(c[5]),
            exceptions=int(c[6]),
            rt_sum_ms=int(c[7]),
        )


class MetricTimeline:
    """Process-wide per-namespace per-second timeline. Thread-safe; the
    recording path is one dict lookup + a handful of array adds per
    (namespace, batch)."""

    def __init__(self, window_s: Optional[int] = None,
                 writer: Optional["TimelineWriter"] = None):
        if window_s is None:
            window_s = SentinelConfig.get_int(KEY_WINDOW_S, 600)
        self.window_s = max(2, int(window_s))
        self.writer = writer
        self._lock = threading.Lock()
        self._rings: Dict[str, _NsRing] = {}
        # seconds ≤ this are on disk; flush() bounds its scan to the ring
        # window, so the first flush writes at most window_s seconds
        self._flushed_upto = 0

    # -- recording ----------------------------------------------------------
    def record(self, namespace: str, n_pass: int = 0, n_block: int = 0,
               n_shed: int = 0, n_other: int = 0,
               latency_ms: Optional[float] = None,
               lat_n: Optional[int] = None,
               now_s: Optional[int] = None,
               n_waited: int = 0,
               n_complete: int = 0,
               n_exception: int = 0,
               rt_sum_ms: float = 0.0) -> None:
        """Fold one verdict-batch contribution for ``namespace`` into the
        current second. ``latency_ms`` is the batch's shared decision
        latency, applied to ``lat_n`` rows (default: the served rows of
        this call — pass + block + other + waited; sheds never reached a
        device step so they carry no latency). ``n_waited`` counts
        SHOULD_WAIT verdicts — served-with-delay (pacing / priority
        occupy), their own column so shaping is visible per second.
        ``n_complete``/``n_exception``/``rt_sum_ms`` fold a batched
        completion report (the rev-6 outcome plane) into the second the
        report LANDED — the admission columns describe the decision path,
        these describe what happened after."""
        if (n_pass <= 0 and n_block <= 0 and n_shed <= 0 and n_other <= 0
                and n_waited <= 0 and n_complete <= 0 and n_exception <= 0):
            return
        sec = int(now_s if now_s is not None else time.time())
        with self._lock:
            ring = self._rings.get(namespace)
            if ring is None:
                ring = self._rings.setdefault(namespace, _NsRing(self.window_s))
            i = ring.slot(sec)
            c = ring.counts[i]
            c[0] += max(0, n_pass)
            c[1] += max(0, n_block)
            c[2] += max(0, n_shed)
            c[3] += max(0, n_other)
            c[4] += max(0, n_waited)
            c[5] += max(0, n_complete)
            c[6] += max(0, n_exception)
            c[7] += max(0, int(rt_sum_ms))
            if latency_ms is not None:
                if lat_n is None:
                    lat_n = (max(0, n_pass) + max(0, n_block)
                             + max(0, n_other) + max(0, n_waited))
                if lat_n > 0:
                    k = int(np.searchsorted(_EDGES, latency_ms))
                    ring.lat[i, k] += lat_n
                    if latency_ms > ring.lat_max[i]:
                        ring.lat_max[i] = latency_ms
        if self.writer is not None and sec - 1 > self._flushed_upto:
            self.flush(upto_s=sec - 1)

    # -- persistence --------------------------------------------------------
    def flush(self, upto_s: Optional[int] = None) -> int:
        """Write every completed second in ``(_flushed_upto, upto_s]`` to
        the rolled files (no-op without a writer). Returns lines written.
        Benches call this at scenario end so the artifact and the on-disk
        log agree to the last second."""
        if self.writer is None:
            return 0
        if upto_s is None:
            upto_s = int(time.time())
        n = 0
        with self._lock:
            lo = max(self._flushed_upto + 1, upto_s - self.window_s + 1)
            for sec in range(lo, upto_s + 1):
                batch = []
                for ns in sorted(self._rings):
                    s = self._rings[ns].sample(ns, sec)
                    if s is not None:
                        batch.append(s)
                if batch:
                    self.writer.write(batch)
                    n += len(batch)
            if upto_s > self._flushed_upto:
                self._flushed_upto = upto_s
        return n

    # -- reading ------------------------------------------------------------
    def query(self, begin_ms: int = 0, end_ms: Optional[int] = None,
              namespace: Optional[str] = None) -> List[TimelineSample]:
        """In-memory window read, time-ordered (namespace-ordered within a
        second)."""
        if end_ms is None:
            end_ms = int(time.time() * 1000)
        lo = begin_ms // 1000
        hi = end_ms // 1000
        out: List[TimelineSample] = []
        with self._lock:
            names = (
                [namespace] if namespace is not None else sorted(self._rings)
            )
            for ns in names:
                ring = self._rings.get(ns)
                if ring is None:
                    continue
                for i in range(ring.window_s):
                    sec = int(ring.stamp[i])
                    if lo <= sec <= hi and sec != 0:
                        s = ring.sample(ns, sec)
                        if s is not None:
                            out.append(s)
        out.sort(key=lambda s: (s.timestamp_ms, s.namespace))
        return out

    def find(self, begin_ms: int = 0, end_ms: Optional[int] = None,
             namespace: Optional[str] = None,
             max_lines: int = 12000) -> List[TimelineSample]:
        """Memory + files merged (memory wins on overlap — it includes the
        current incomplete second). The ``cluster/server/metric`` backend."""
        mem = self.query(begin_ms, end_ms, namespace)
        merged = {(s.timestamp_ms, s.namespace): s for s in mem}
        if self.writer is not None:
            searcher = TimelineSearcher(self.writer.base_dir, self.writer.app)
            for s in searcher.find(
                begin_ms,
                end_ms if end_ms is not None else int(time.time() * 1000),
                namespace=namespace, max_lines=max_lines,
            ):
                merged.setdefault((s.timestamp_ms, s.namespace), s)
        out = sorted(merged.values(),
                     key=lambda s: (s.timestamp_ms, s.namespace))
        return out[:max_lines]

    def namespaces(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def status(self) -> dict:
        """The ``clusterServerStats`` ``timeline`` block."""
        with self._lock:
            names = sorted(self._rings)
            last = 0
            for ring in self._rings.values():
                m = int(ring.stamp.max()) if ring.stamp.size else 0
                last = max(last, m)
        return {
            "windowSeconds": self.window_s,
            "namespaces": names,
            "lastSecondMs": last * 1000,
            "fileDir": self.writer.base_dir if self.writer else None,
        }

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._flushed_upto = 0


class TimelineWriter:
    """Size-rolled timeline files with a second→offset index
    (``MetricWriter`` parity: shift-rename rotation, oldest dropped)."""

    def __init__(self, base_dir: str,
                 single_file_size: Optional[int] = None,
                 total_file_count: Optional[int] = None):
        self.base_dir = base_dir
        os.makedirs(self.base_dir, exist_ok=True)
        self.single_file_size = single_file_size or SentinelConfig.get_int(
            "csp.sentinel.metric.file.single.size", 50 * 1024 * 1024
        )
        self.total_file_count = total_file_count or SentinelConfig.get_int(
            "csp.sentinel.metric.file.total.count", 6
        )
        self.app = SentinelConfig.app_name()
        self._lock = threading.Lock()
        self._cur_file = None
        self._cur_idx = None

    def _file_name(self, n: int) -> str:
        return os.path.join(self.base_dir, f"{self.app}-timeline.log.{n}")

    def _roll_if_needed(self) -> None:
        if (self._cur_file is not None
                and self._cur_file.tell() < self.single_file_size):
            return
        if self._cur_file is not None:
            self._cur_file.close()
            self._cur_idx.close()
            for n in range(self.total_file_count - 1, 0, -1):
                src, dst = self._file_name(n - 1), self._file_name(n)
                if os.path.exists(src):
                    os.replace(src, dst)
                    if os.path.exists(src + ".idx"):
                        os.replace(src + ".idx", dst + ".idx")
        path = self._file_name(0)
        self._cur_file = open(path, "a", encoding="utf-8")
        self._cur_idx = open(path + ".idx", "a", encoding="utf-8")

    def write(self, samples: List[TimelineSample]) -> None:
        if not samples:
            return
        with self._lock:
            self._roll_if_needed()
            sec = samples[0].timestamp_ms // 1000
            self._cur_idx.write(f"{sec} {self._cur_file.tell()}\n")
            for s in samples:
                self._cur_file.write(s.to_line() + "\n")
            self._cur_file.flush()
            self._cur_idx.flush()

    def close(self) -> None:
        with self._lock:
            if self._cur_file is not None:
                self._cur_file.close()
                self._cur_idx.close()
                self._cur_file = self._cur_idx = None


class TimelineSearcher:
    """Reads timeline lines in a time range across the rolling files
    (``MetricSearcher`` parity; oldest file first, .idx seek)."""

    def __init__(self, base_dir: str, app: str):
        self.base_dir = base_dir
        self.app = app

    @staticmethod
    def _seek_offset(idx_path: str, begin_ms: int) -> int:
        begin_sec = begin_ms // 1000
        offset = 0
        try:
            with open(idx_path, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        sec_s, off_s = line.split()
                        if int(sec_s) >= begin_sec:
                            break
                        offset = int(off_s)
                    except ValueError:
                        continue
        except OSError:
            return 0
        return offset

    def find(self, begin_ms: int, end_ms: int,
             namespace: Optional[str] = None,
             max_lines: int = 12000) -> List[TimelineSample]:
        out: List[TimelineSample] = []
        n = 0
        while True:
            path = os.path.join(
                self.base_dir, f"{self.app}-timeline.log.{n}")
            if not os.path.exists(path):
                break
            n += 1
        for i in range(n - 1, -1, -1):  # oldest file first
            path = os.path.join(
                self.base_dir, f"{self.app}-timeline.log.{i}")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    f.seek(self._seek_offset(path + ".idx", begin_ms))
                    for line in f:
                        try:
                            s = TimelineSample.from_line(line)
                        except (ValueError, IndexError):
                            continue
                        if s.timestamp_ms < begin_ms:
                            continue
                        if s.timestamp_ms > end_ms:
                            break  # lines are time-ordered within a file
                        if namespace and s.namespace != namespace:
                            continue
                        out.append(s)
                        if len(out) >= max_lines:
                            return out
            except OSError:
                continue
        return out


# -- singleton ----------------------------------------------------------------
_HUB: Optional[MetricTimeline] = None
_HUB_LOCK = threading.Lock()


def timeline() -> MetricTimeline:
    """The process-wide timeline. File persistence turns on when
    ``SENTINEL_TIMELINE_DIR`` is set at first use (or via
    :func:`configure_timeline`); memory-only otherwise."""
    global _HUB
    if _HUB is None:
        with _HUB_LOCK:
            if _HUB is None:
                d = os.environ.get(ENV_DIR)
                writer = TimelineWriter(d) if d else None
                _HUB = MetricTimeline(writer=writer)
    return _HUB


def configure_timeline(base_dir: Optional[str] = None,
                       window_s: Optional[int] = None) -> MetricTimeline:
    """Replace the singleton with an explicitly configured timeline
    (benches point it at their artifact directory before the run)."""
    global _HUB
    with _HUB_LOCK:
        writer = TimelineWriter(base_dir) if base_dir else None
        _HUB = MetricTimeline(window_s=window_s, writer=writer)
        return _HUB


def reset_timeline_for_tests() -> None:
    global _HUB
    with _HUB_LOCK:
        if _HUB is not None and _HUB.writer is not None:
            _HUB.writer.close()
        _HUB = None
