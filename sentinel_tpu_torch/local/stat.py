"""Host-side statistics: per-node sliding windows and the node hierarchy
(the port's copy of ``sentinel_tpu/local/stat.py``).

This is the *local* (in-process, per-call) twin of the device tensors in
``sentinel_tpu_torch.stats.window``: same window semantics, rings sized
``[buckets, channels]`` per node, O(buckets) per operation. Analog of
``StatisticNode``/``DefaultNode``/``EntranceNode``/``ClusterNode``
(``sentinel-core/.../node/*.java``) minus the JVM concurrency machinery
(LongAdder/CAS → one small lock; the GIL makes contention cheap at
local-mode rates).

The device engine is the source of truth for batched/cluster decisions; this
module exists so a single ``entry()`` call costs microseconds, not a device
round-trip.

Windows are the native library's lock-free atomics
(:class:`sentinel_tpu_torch.native.lib.NativeWindow`), built from
``native/src`` at the first window's construction. Unlike the reference,
a failed build raises there: nothing degrades to numpy unasked.
``SENTINEL_TPU_NATIVE=0`` (read once, at import, as in the reference)
selects the numpy :class:`HostWindow` instead; both give the same verdicts.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.local.base import ResourceWrapper

# Channels (host-side; RT is a float channel here, unlike the device split).
PASS = 0
BLOCK = 1
EXCEPTION = 2
SUCCESS = 3
RT = 4
OCCUPIED_PASS = 5
N_CHAN = 6

NEVER = -(2**60)


class HostWindow:
    """Ring of time buckets with mask-on-read deprecation.

    Same math as ``sentinel_tpu_torch.stats.window`` (and the reference
    ``LeapArray.java:100-160``), specialized to one resource on the host.
    Not thread-safe by itself — callers hold the owning node's lock.
    """

    __slots__ = (
        "bucket_ms", "n_buckets", "n_channels", "interval_ms", "starts",
        "counts",
    )

    def __init__(self, bucket_ms: int, n_buckets: int, n_channels: int = N_CHAN):
        self.bucket_ms = bucket_ms
        self.n_buckets = n_buckets
        self.n_channels = n_channels
        self.interval_ms = bucket_ms * n_buckets
        self.starts = np.full(n_buckets, NEVER, dtype=np.int64)
        self.counts = np.zeros((n_buckets, n_channels), dtype=np.float64)

    def _roll(self, now: int) -> int:
        idx = (now // self.bucket_ms) % self.n_buckets
        start = now - now % self.bucket_ms
        if self.starts[idx] != start:
            self.counts[idx] = 0.0
            self.starts[idx] = start
        return idx

    def add(self, now: int, chan: int, n: float = 1.0) -> None:
        idx = self._roll(now)
        self.counts[idx, chan] += n

    def _valid(self, now: int) -> np.ndarray:
        age = now - self.starts
        return (age >= 0) & (age < self.interval_ms)

    def sum(self, now: int, chan: int) -> float:
        return float(self.counts[self._valid(now), chan].sum())

    def qps(self, now: int, chan: int) -> float:
        return self.sum(now, chan) * 1000.0 / self.interval_ms

    def previous_bucket(self, now: int, chan: int) -> float:
        """Count in the bucket one bucket-length before the current one
        (``ArrayMetric.previousWindowPass`` shape, used by warm-up)."""
        prev_start = (now - now % self.bucket_ms) - self.bucket_ms
        idx = (prev_start // self.bucket_ms) % self.n_buckets
        if self.starts[idx] == prev_start:
            return float(self.counts[idx, chan])
        return 0.0

    def min_rt(self, now: int) -> float:
        """Minimum average-RT across valid buckets (``MetricBucket.minRt``
        tracks per-bucket min; we approximate with per-bucket rt/success —
        documented drift, same monotonic use in BBR check)."""
        return self.min_ratio(now, RT, SUCCESS)

    def min_ratio(self, now: int, num_chan: int, den_chan: int) -> float:
        valid = self._valid(now)
        den = self.counts[valid, den_chan]
        num = self.counts[valid, num_chan]
        mask = den > 0
        if not mask.any():
            return 0.0
        return float((num[mask] / den[mask]).min())

    def snapshot(self, now: int) -> list:
        """Per-channel valid sums in one pass (metric-log path)."""
        valid = self._valid(now)
        return [float(x) for x in self.counts[valid].sum(axis=0)]

    def start_at(self, b: int) -> int:
        return int(self.starts[b])

    def count_at(self, b: int, chan: int) -> float:
        return float(self.counts[b, chan])


class FutureWindow:
    """Occupied (borrowed) tokens waiting in future buckets
    (``FutureBucketLeapArray``). Host twin of ``window.add_future``."""

    __slots__ = ("bucket_ms", "n_buckets", "interval_ms", "starts", "counts")

    def __init__(self, bucket_ms: int, n_buckets: int):
        self.bucket_ms = bucket_ms
        self.n_buckets = n_buckets
        self.interval_ms = bucket_ms * n_buckets
        self.starts = np.full(n_buckets, NEVER, dtype=np.int64)
        self.counts = np.zeros(n_buckets, dtype=np.float64)

    def add(self, future_time: int, n: float) -> None:
        idx = (future_time // self.bucket_ms) % self.n_buckets
        start = future_time - future_time % self.bucket_ms
        if self.starts[idx] != start:
            self.counts[idx] = 0.0
            self.starts[idx] = start
        self.counts[idx] += n

    def waiting(self, now: int) -> float:
        ahead = self.starts - now
        return float(self.counts[(ahead > 0) & (ahead <= self.interval_ms)].sum())

    def take_matured(self, now: int) -> float:
        """Tokens whose window start has arrived — they become OCCUPIED_PASS."""
        cur_start = now - now % self.bucket_ms
        idx = (cur_start // self.bucket_ms) % self.n_buckets
        if self.starts[idx] == cur_start:
            n = float(self.counts[idx])
            self.counts[idx] = 0.0
            return n
        return 0.0


class _NativeFutureWindow:
    """FutureWindow API over a 1-channel native window."""

    __slots__ = ("_w", "bucket_ms", "n_buckets", "interval_ms")

    def __init__(self, native_window):
        self._w = native_window
        self.bucket_ms = native_window.bucket_ms
        self.n_buckets = native_window.n_buckets
        self.interval_ms = native_window.interval_ms

    def add(self, future_time: int, n: float) -> None:
        self._w.add_future(future_time, n)

    def waiting(self, now: int) -> float:
        return self._w.future_waiting(now)

    def take_matured(self, now: int) -> float:
        return self._w.take_matured(now)


_NATIVE = os.environ.get("SENTINEL_TPU_NATIVE", "") != "0"


def make_window(bucket_ms: int, n_buckets: int, n_channels: int = N_CHAN):
    """Window factory: the native backend (built at first use; a failed
    build raises), or numpy under ``SENTINEL_TPU_NATIVE=0``."""
    if _NATIVE:
        from sentinel_tpu_torch.native.lib import NativeWindow

        return NativeWindow(bucket_ms, n_buckets, n_channels)
    return HostWindow(bucket_ms, n_buckets, n_channels)


def make_future_window(bucket_ms: int, n_buckets: int):
    if _NATIVE:
        from sentinel_tpu_torch.native.lib import NativeWindow

        return _NativeFutureWindow(NativeWindow(bucket_ms, n_buckets, 1))
    return FutureWindow(bucket_ms, n_buckets)


DEFAULT_OCCUPY_TIMEOUT_MS = 500  # OccupyTimeoutProperty default


class StatisticNode:
    """One metric owner: second-level + minute-level windows + concurrency.

    reference: ``node/StatisticNode.java:90-108`` (1s/2-bucket second window,
    60s/60-bucket minute window, ``curThreadNum`` LongAdder).
    """

    def __init__(self, sec_buckets: int = 2, sec_interval_ms: int = 1000):
        self._lock = threading.RLock()
        self.sec = make_window(sec_interval_ms // sec_buckets, sec_buckets)
        self.minute = make_window(1000, 60)
        self.future = make_future_window(self.sec.bucket_ms, sec_buckets)
        self.cur_thread_num = 0
        # composite-write fast path: when every window is native, one ctypes
        # call covers a whole logical write (touch+PASS, SUCCESS+RT, …) with
        # no Python lock — each C op is atomic and the reference's
        # StatisticNode holds no cross-window lock either. ctypes round
        # trips otherwise dominate the entry hot path.
        self._fast = None
        if _NATIVE:
            from sentinel_tpu_torch.native.lib import NativeWindow

            if (
                isinstance(self.sec, NativeWindow)
                and isinstance(self.minute, NativeWindow)
                and isinstance(self.future, _NativeFutureWindow)
            ):
                self._fast = (
                    self.sec._lib, self.sec._h, self.minute._h,
                    self.future._w._h,
                )

    # -- write path ---------------------------------------------------------
    def increase_thread(self) -> None:
        with self._lock:
            self.cur_thread_num += 1

    def decrease_thread(self) -> None:
        with self._lock:
            self.cur_thread_num -= 1

    def _touch(self, now: int) -> None:
        """Convert matured borrowed tokens (``OccupiableBucketLeapArray``'s
        window-roll transfer): they count as PASS — consuming the new window's
        capacity, preventing double admission — and as OCCUPIED_PASS for
        observability. Callers hold the lock."""
        matured = self.future.take_matured(now)
        if matured:
            self.sec.add(now, PASS, matured)
            self.sec.add(now, OCCUPIED_PASS, matured)
            self.minute.add(now, PASS, matured)
            self.minute.add(now, OCCUPIED_PASS, matured)

    def add_pass(self, n: int = 1, now: Optional[int] = None) -> None:
        now = _clock.now_ms() if now is None else now
        fast = self._fast
        if fast is not None:
            fast[0].sn_stat_pass(fast[1], fast[2], fast[3], now, float(n))
            return
        with self._lock:
            self._touch(now)
            self.sec.add(now, PASS, n)
            self.minute.add(now, PASS, n)

    def add_block(self, n: int = 1, now: Optional[int] = None) -> None:
        now = _clock.now_ms() if now is None else now
        fast = self._fast
        if fast is not None:
            fast[0].sn_stat_event(fast[1], fast[2], now, BLOCK, float(n))
            return
        with self._lock:
            self.sec.add(now, BLOCK, n)
            self.minute.add(now, BLOCK, n)

    def add_exception(self, n: int = 1, now: Optional[int] = None) -> None:
        now = _clock.now_ms() if now is None else now
        fast = self._fast
        if fast is not None:
            fast[0].sn_stat_event(fast[1], fast[2], now, EXCEPTION, float(n))
            return
        with self._lock:
            self.sec.add(now, EXCEPTION, n)
            self.minute.add(now, EXCEPTION, n)

    def add_rt_and_success(self, rt_ms: float, n: int = 1, now: Optional[int] = None) -> None:
        now = _clock.now_ms() if now is None else now
        fast = self._fast
        if fast is not None:
            fast[0].sn_stat_rt_success(
                fast[1], fast[2], now, float(rt_ms), float(n)
            )
            return
        with self._lock:
            self.sec.add(now, SUCCESS, n)
            self.sec.add(now, RT, rt_ms)
            self.minute.add(now, SUCCESS, n)
            self.minute.add(now, RT, rt_ms)

    def add_occupied_pass(self, n: int, wait_ms: int, now: Optional[int] = None) -> None:
        """Borrow from a future window (``StatisticNode.addOccupiedPass``).

        On fast (native-window) nodes this is a single atomic bucket add —
        no xfer_lock needed: the lock exists to make the drain→credit
        TRANSFER atomic; depositing NEW tokens into a future bucket is one
        atomic op that no reader can observe half-done. The composite
        readers (``sn_stat_touched_sum``) and ``try_occupy_next``'s
        ``waiting`` probe may race a concurrent transfer by design — the
        same drift the reference's unsynchronized LeapArray readers accept.
        """
        now = _clock.now_ms() if now is None else now
        with self._lock:
            self.future.add(now + wait_ms, n)

    # -- read path ----------------------------------------------------------
    def _now(self, now: Optional[int]) -> int:
        return _clock.now_ms() if now is None else now

    def pass_qps(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        fast = self._fast
        if fast is not None:
            total = fast[0].sn_stat_touched_sum(
                fast[1], fast[2], fast[3], now, PASS
            )
            return total * 1000.0 / self.sec.interval_ms
        with self._lock:
            self._touch(now)
            return self.sec.qps(now, PASS)

    def occupied_pass_qps(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        fast = self._fast
        if fast is not None:
            # same xfer-locked composite read as pass_qps: the drain+credit
            # transfer can never be observed half-done (r4 advisor)
            total = fast[0].sn_stat_touched_sum(
                fast[1], fast[2], fast[3], now, OCCUPIED_PASS
            )
            return total * 1000.0 / self.sec.interval_ms
        with self._lock:
            self._touch(now)
            return self.sec.qps(now, OCCUPIED_PASS)

    def block_qps(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            return self.sec.qps(now, BLOCK)

    def total_qps(self, now: Optional[int] = None) -> float:
        return self.pass_qps(now) + self.block_qps(now)

    def success_qps(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            return self.sec.qps(now, SUCCESS)

    def exception_qps(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            return self.sec.qps(now, EXCEPTION)

    def avg_rt(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            succ = self.sec.sum(now, SUCCESS)
            if succ <= 0:
                return 0.0
            return self.sec.sum(now, RT) / succ

    def min_rt(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            return self.sec.min_ratio(now, RT, SUCCESS)

    def previous_pass_qps(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            return (
                self.sec.previous_bucket(now, PASS)
                * 1000.0
                / self.sec.bucket_ms
            )

    def total_pass_minute(self, now: Optional[int] = None) -> float:
        now = self._now(now)
        with self._lock:
            return self.minute.sum(now, PASS)

    def try_occupy_next(
        self, now: int, acquire: int, threshold: float
    ) -> int:
        """Can a prioritized request borrow from an upcoming window?

        Returns wait-ms (> 0) if the borrow succeeded, else ``OccupyTimeoutMs+1``
        meaning "cannot occupy" — mirrors ``StatisticNode.tryOccupyNext``
        (``StatisticNode.java:288``) which probes successive future windows
        within the occupy timeout.
        """
        with self._lock:
            max_wait = DEFAULT_OCCUPY_TIMEOUT_MS
            bucket_ms = self.sec.bucket_ms
            interval = self.sec.interval_ms
            # earliest future window start strictly after now
            first_wait = bucket_ms - (now % bucket_ms)
            wait = first_wait
            while wait <= max_wait and wait < interval:
                window_start = now + wait  # a bucket boundary
                # currently-valid passes that will have slid out of the
                # interval by window_start
                horizon = window_start - interval
                expired = 0.0
                for b in range(self.sec.n_buckets):
                    s = self.starts_at(b)
                    if s != NEVER and 0 <= now - s < interval and s <= horizon:
                        expired += self.sec.count_at(b, PASS)
                cur_pass = self.sec.sum(now, PASS)
                occupied = self.future.waiting(now)
                if cur_pass - expired + occupied + acquire <= threshold:
                    return int(wait)
                wait += bucket_ms
            return DEFAULT_OCCUPY_TIMEOUT_MS + 1

    def starts_at(self, b: int) -> int:
        return int(self.sec.start_at(b))


class DefaultNode(StatisticNode):
    """Per-(resource, context) node forming the invocation tree
    (``node/DefaultNode.java:41``)."""

    def __init__(self, resource: ResourceWrapper):
        super().__init__()
        self.resource = resource
        self.cluster_node: Optional["ClusterNode"] = None
        self.children: list = []
        self._child_lock = threading.Lock()

    def add_child(self, node: "DefaultNode") -> None:
        with self._child_lock:
            if node not in self.children:
                self.children.append(node)

    # DefaultNode mirrors every stat into its ClusterNode (DefaultNode.java:
    # increaseBlockQps etc. delegate to clusterNode) — the chain's
    # StatisticSlot drives both explicitly here for clarity.


class EntranceNode(DefaultNode):
    """Per-context root node (``node/EntranceNode.java:39``)."""


class ClusterNode(StatisticNode):
    """Per-resource global node + per-origin children
    (``node/ClusterNode.java:45``)."""

    def __init__(self, resource_name: str):
        super().__init__()
        self.resource_name = resource_name
        self._origin_lock = threading.Lock()
        self._origin_nodes: Dict[str, StatisticNode] = {}

    def get_or_create_origin_node(self, origin: str) -> StatisticNode:
        node = self._origin_nodes.get(origin)
        if node is None:
            with self._origin_lock:
                node = self._origin_nodes.get(origin)
                if node is None:
                    node = StatisticNode()
                    # copy-on-write in the reference (ClusterNode.java:100);
                    # dict assignment under lock is the host equivalent
                    self._origin_nodes[origin] = node
        return node

    @property
    def origin_nodes(self) -> Dict[str, StatisticNode]:
        return dict(self._origin_nodes)
