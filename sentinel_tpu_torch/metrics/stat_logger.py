"""Rolling stat logger, the EagleEye analog (the port's copy of
``sentinel_tpu/metrics/stat_logger.py``).

The reference embeds a high-throughput keyed stat logger
(``eagleeye/EagleEye.java:25``, ``StatLogger.java:24,85``,
``StatRollingData``, ``EagleEyeRollingFileAppender``, ``TokenBucket``) used
for the block log (``slots/logger/EagleEyeLogUtil.java``) and the cluster
server's stat logs (``ClusterServerStatLogUtil``). Model: callers ``stat()``
keyed counters on the hot path; a time-window roll swaps the accumulation
map and a writer thread appends one line per key to a size-rolled file:

    timestamp|key1,key2|count          (count-only entries)
    timestamp|key1,key2|count,total    (value entries, e.g. rt sums)

Differences from the JVM design: accumulation is a dict under one lock
instead of CHM+LongAdder (host Python is not the hot path here — the hot
path is on-device; these logs serve the *control* plane), and the roll is
driven lazily by writers plus an explicit ``flush()``, with time from the
process clock so tests drive it with ``ManualClock``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log


# the reference's log-directory property (``LogBase``): set through
# ``SentinelConfig.set`` or ``CSP_SENTINEL_LOG_DIR``; a test points it at a
# temporary directory
LOG_DIR_KEY = "csp.sentinel.log.dir"


def default_stat_log_dir() -> str:
    return (
        SentinelConfig.get(LOG_DIR_KEY)
        or os.environ.get("SENTINEL_LOG_DIR")
        or os.path.expanduser("~/logs/csp")
    )


class RollingFileWriter:
    """Append-only writer with size-based rolling (``EagleEyeRollingFileAppender``):
    at ``max_bytes`` the file rotates to ``.1`` … ``.N`` (oldest dropped)."""

    def __init__(self, path: str, max_bytes: int = 300 * 1024 * 1024,
                 max_backups: int = 3):
        self.path = path
        self.max_bytes = max_bytes
        self.max_backups = max_backups
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write_lines(self, lines: List[str]) -> None:
        if not lines:
            return
        data = "".join(line + "\n" for line in lines)
        with self._lock:
            try:
                if (
                    os.path.exists(self.path)
                    and os.path.getsize(self.path) + len(data) > self.max_bytes
                ):
                    self._roll()
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(data)
            except OSError as e:
                record_log.warning("stat log write failed: %s", e)

    def _roll(self) -> None:
        oldest = f"{self.path}.{self.max_backups}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_backups - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")


class StatLogger:
    """Keyed counter accumulation over fixed time windows.

    ``stat(*key)`` adds to the current window; when a write lands in a new
    window (or ``flush()`` is called) the previous window's map is sealed
    and written out. ``max_entries`` bounds per-window cardinality the way
    EagleEye's entry cap does — overflow keys are dropped and counted in a
    ``__overflow__`` line rather than growing without bound.
    """

    def __init__(
        self,
        name: str,
        interval_ms: int = 1_000,
        log_dir: Optional[str] = None,
        max_bytes: int = 300 * 1024 * 1024,
        max_backups: int = 3,
        max_entries: int = 20_000,
    ):
        self.name = name
        self.interval_ms = interval_ms
        self.max_entries = max_entries
        log_dir = log_dir or default_stat_log_dir()
        self.writer = RollingFileWriter(
            os.path.join(log_dir, f"{name}.log"), max_bytes, max_backups
        )
        self._lock = threading.Lock()
        self._window_start = 0
        self._data: Dict[Tuple[str, ...], List[float]] = {}
        self._overflow = 0

    def stat(self, *key: str, count: int = 1, value: Optional[float] = None):
        now = _clock.now_ms()
        start = now - now % self.interval_ms
        sealed = None
        with self._lock:
            if start != self._window_start:
                sealed = self._seal(start)
            slot = self._data.get(key)
            if slot is None:
                if len(self._data) >= self.max_entries:
                    self._overflow += count
                    slot = None
                else:
                    slot = self._data[key] = [0.0, 0.0, False]
            if slot is not None:
                slot[0] += count
                if value is not None:
                    slot[1] += value
                    slot[2] = True  # any valued stat upgrades the line format
            if sealed:
                # enqueue under the lock: seal order == enqueue order ==
                # file order (the put itself is non-blocking)
                self._write_async(sealed)

    def _write_async(self, lines: List[str]) -> None:
        """Hand a sealed window to the shared writer thread — ``stat()``
        sits on the serving hot path (called per micro-batch by the token
        server), so the file open/roll/append must not stall the caller
        (this is the role EagleEye's dedicated writer thread plays)."""
        _writer_queue_put(self.writer, lines)

    def _seal(self, new_start: int) -> List[str]:
        """Format + clear the finished window. Caller holds the lock."""
        lines = []
        ts = self._window_start
        for key, (count, total, has_value) in self._data.items():
            joined = ",".join(key)
            if has_value:
                lines.append(f"{ts}|{joined}|{int(count)},{total:g}")
            else:
                lines.append(f"{ts}|{joined}|{int(count)}")
        if self._overflow:
            lines.append(f"{ts}|__overflow__|{self._overflow}")
        self._data = {}
        self._overflow = 0
        self._window_start = new_start
        return lines

    def flush(self) -> None:
        """Seal and write the current window immediately (shutdown/tests).

        Routes through the same writer queue as async seals (so the file
        stays in seal order) and waits until everything queued so far —
        including this window — is on disk. If the writer queue is wedged
        (stalled disk), the sealed window is written synchronously as a
        last resort so an explicit flush never silently drops data."""
        with self._lock:
            sealed = self._seal(self._window_start)
        if sealed:
            if not _writer_queue_put(self.writer, sealed):
                self.writer.write_lines(sealed)
                return
        _writer_drain_barrier()


# One shared background writer drains sealed windows for every StatLogger
# (lazily started, daemon — dies with the process). stat()'s hot-path seals
# are fire-and-forget (dropped with a warning if the queue is wedged);
# flush() falls back to a synchronous write so explicit flushes lose
# nothing.
_writer_queue: Optional["queue.Queue"] = None
_writer_lock = threading.Lock()


def _writer_queue_put(writer: RollingFileWriter, lines: List[str]) -> bool:
    """Enqueue for the shared writer thread; False if the queue is full."""
    global _writer_queue
    if _writer_queue is None:
        with _writer_lock:
            if _writer_queue is None:
                import queue as _queue_mod

                q: "queue.Queue" = _queue_mod.Queue(maxsize=1024)

                def drain() -> None:
                    while True:
                        w, ls = q.get()
                        if w is None:  # flush barrier
                            ls.set()
                            continue
                        try:
                            w.write_lines(ls)
                        except Exception:  # never kill the writer thread
                            record_log.exception("stat writer failed")

                threading.Thread(
                    target=drain, name="sentinel-stat-writer", daemon=True
                ).start()
                _writer_queue = q
    try:
        _writer_queue.put_nowait((writer, lines))
        return True
    except Exception:
        # queue full — a stalled disk must not back-pressure the serving
        # path; hot-path callers drop the window (EagleEye drops on
        # overload too), flush() falls back to a synchronous write
        record_log.warning("stat writer queue full; dropped a window")
        return False


def _writer_drain_barrier(timeout_s: float = 5.0) -> None:
    """Block until every window queued so far has been written (bounded:
    a stalled disk makes this a best-effort wait, never a hang)."""
    if _writer_queue is None:
        return
    import queue as _queue_mod

    done = threading.Event()
    try:
        _writer_queue.put((None, done), timeout=timeout_s)
    except _queue_mod.Full:
        return  # writer is wedged; don't hang shutdown on it
    done.wait(timeout_s)


@dataclass
class StatEntry:
    """One parsed stat-log line (``ts|key1,key2|count[,total]``)."""

    timestamp_ms: int
    key: Tuple[str, ...]
    count: int
    total: Optional[float] = None

    @classmethod
    def from_line(cls, line: str) -> "StatEntry":
        ts_s, joined, tail = line.rstrip("\n").split("|", 2)
        if "," in tail:
            count_s, total_s = tail.split(",", 1)
            return cls(int(ts_s), tuple(joined.split(",")),
                       int(count_s), float(total_s))
        return cls(int(ts_s), tuple(joined.split(",")), int(tail))


class StatLogSearcher:
    """Time-range search over one stat log's rotation chain.

    The complement ``RollingFileWriter`` lacks: reads ``<path>.N`` …
    ``<path>.1`` then ``<path>`` (oldest backup first — ``_roll`` shifts
    upward, so higher suffix = older data) and yields entries whose
    window start falls in ``[begin_ms, end_ms]``. Mirrors what
    ``MetricSearcher`` does for the per-resource metric log, minus the
    ``.idx`` seek: stat files are written a whole sealed window at a
    time, so a linear scan is the honest cost model.
    """

    def __init__(self, path: str, max_backups: int = 3):
        self.path = path
        self.max_backups = max_backups

    def _chain(self) -> List[str]:
        paths = [f"{self.path}.{i}"
                 for i in range(self.max_backups, 0, -1)]
        paths.append(self.path)
        return [p for p in paths if os.path.exists(p)]

    def find(self, begin_ms: int, end_ms: int,
             key_prefix: Optional[Tuple[str, ...]] = None,
             max_lines: int = 12_000) -> List[StatEntry]:
        out: List[StatEntry] = []
        for path in self._chain():
            try:
                with open(path, "r", encoding="utf-8") as f:
                    for line in f:
                        try:
                            entry = StatEntry.from_line(line)
                        except (ValueError, IndexError):
                            continue  # torn tail from a crash mid-append
                        if not begin_ms <= entry.timestamp_ms <= end_ms:
                            continue
                        if key_prefix and \
                                entry.key[:len(key_prefix)] != key_prefix:
                            continue
                        out.append(entry)
                        if len(out) >= max_lines:
                            return out
            except OSError:
                continue
        return out


def search_stat_log(name: str, begin_ms: int, end_ms: int,
                    key_prefix: Optional[Tuple[str, ...]] = None,
                    log_dir: Optional[str] = None,
                    max_backups: int = 3) -> List[StatEntry]:
    """Range-search a named stat log (e.g. ``CLUSTER_LOG`` for the
    ``outcome_reported`` lines) without needing the live logger."""
    log_dir = log_dir or default_stat_log_dir()
    return StatLogSearcher(
        os.path.join(log_dir, f"{name}.log"), max_backups=max_backups
    ).find(begin_ms, end_ms, key_prefix=key_prefix)


_registry_lock = threading.Lock()
_registry: Dict[str, StatLogger] = {}


def stat_logger(name: str, **kwargs) -> StatLogger:
    """Process-wide named loggers (``EagleEye.statLoggerBuilder`` registry)."""
    with _registry_lock:
        logger = _registry.get(name)
        if logger is None:
            logger = _registry[name] = StatLogger(name, **kwargs)
        return logger


def reset_registry_for_tests() -> None:
    with _registry_lock:
        _registry.clear()


# -- the two built-in stat logs -------------------------------------------

BLOCK_LOG = "sentinel-block-record"  # EagleEyeLogUtil's block.log analog
CLUSTER_LOG = "sentinel-cluster-server-stat"  # ClusterServerStatLogUtil


def log_block(resource: str, origin: str, rule_type: str, count: int = 1):
    """``EagleEyeLogUtil.log(resource, exceptionName, ruleLimitApp, origin,
    count)`` — one aggregated line per (resource, origin, rule) per second."""
    stat_logger(BLOCK_LOG).stat(resource, origin or "-", rule_type, count=count)


def log_cluster(event: str, flow_id: int = -1, count: int = 1):
    key = (event,) if flow_id < 0 else (event, str(flow_id))
    stat_logger(CLUSTER_LOG).stat(*key, count=count)
