"""Metric log: per-second resource metrics in rolling files (the port's
copy of ``sentinel_tpu/metrics/log.py``, over the port's ``local.chain``
nodes).

Line format matches the reference's ``MetricNode.toString`` (what the
dashboard's ``MetricFetcher`` parses)::

    timestamp|yyyy-MM-dd HH:mm:ss|resource|passQps|blockQps|successQps|
    exceptionQps|rt|occupiedPassQps|concurrency|classification

Analogs: ``MetricWriter.java:47-92`` (50MB × 6 rolling files + ``.idx``
second→offset index), ``MetricSearcher.java:34``, ``MetricTimerListener.java:
34-59`` (the 1s aggregation task over ``ClusterBuilderSlot.clusterNodeMap``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log


@dataclass
class MetricNode:
    timestamp_ms: int
    resource: str
    pass_qps: float = 0.0
    block_qps: float = 0.0
    success_qps: float = 0.0
    exception_qps: float = 0.0
    rt: float = 0.0
    occupied_pass_qps: float = 0.0
    concurrency: int = 0
    classification: int = 0

    def to_line(self) -> str:
        ts = self.timestamp_ms // 1000 * 1000
        date = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts / 1000))
        res = self.resource.replace("|", "_")
        return (
            f"{ts}|{date}|{res}|{self.pass_qps:g}|{self.block_qps:g}|"
            f"{self.success_qps:g}|{self.exception_qps:g}|{self.rt:g}|"
            f"{self.occupied_pass_qps:g}|{self.concurrency}|{self.classification}"
        )

    @classmethod
    def from_line(cls, line: str) -> "MetricNode":
        p = line.rstrip("\n").split("|")
        return cls(
            timestamp_ms=int(p[0]),
            resource=p[2],
            pass_qps=float(p[3]),
            block_qps=float(p[4]),
            success_qps=float(p[5]),
            exception_qps=float(p[6]),
            rt=float(p[7]),
            occupied_pass_qps=float(p[8]),
            concurrency=int(p[9]),
            classification=int(p[10]) if len(p) > 10 else 0,
        )


def default_metric_dir() -> str:
    """Where metric logs live unless overridden (shared by the writer and the
    ``/metric`` command handler, which must read the same directory): the
    ``metrics`` folder of the port's log directory, which the stat logger
    also writes into (``csp.sentinel.log.dir``, else ``SENTINEL_LOG_DIR``,
    else ``~/logs/csp``)."""
    from sentinel_tpu_torch.metrics.stat_logger import default_stat_log_dir

    return os.path.join(default_stat_log_dir(), "metrics")


class MetricWriter:
    """Size-rolled metric files with a second→offset index."""

    def __init__(self, base_dir: Optional[str] = None,
                 single_file_size: Optional[int] = None,
                 total_file_count: Optional[int] = None):
        self.base_dir = base_dir or default_metric_dir()
        os.makedirs(self.base_dir, exist_ok=True)
        self.single_file_size = single_file_size or SentinelConfig.get_int(
            "csp.sentinel.metric.file.single.size", 50 * 1024 * 1024
        )
        self.total_file_count = total_file_count or SentinelConfig.get_int(
            "csp.sentinel.metric.file.total.count", 6
        )
        self.app = SentinelConfig.app_name()
        self._lock = threading.Lock()
        self._cur_path: Optional[str] = None
        self._cur_file = None
        self._cur_idx = None

    def _file_name(self, n: int) -> str:
        return os.path.join(self.base_dir, f"{self.app}-metrics.log.{n}")

    def _roll_if_needed(self) -> None:
        if self._cur_file is not None and self._cur_file.tell() < self.single_file_size:
            return
        if self._cur_file is not None:
            self._cur_file.close()
            self._cur_idx.close()
            # shift files: .N-1 ← .N (drop the oldest)
            for n in range(self.total_file_count - 1, 0, -1):
                src, dst = self._file_name(n - 1), self._file_name(n)
                if os.path.exists(src):
                    os.replace(src, dst)
                    if os.path.exists(src + ".idx"):
                        os.replace(src + ".idx", dst + ".idx")
        path = self._file_name(0)
        self._cur_path = path
        self._cur_file = open(path, "a", encoding="utf-8")
        self._cur_idx = open(path + ".idx", "a", encoding="utf-8")

    def write(self, nodes: List[MetricNode]) -> None:
        if not nodes:
            return
        with self._lock:
            self._roll_if_needed()
            sec = nodes[0].timestamp_ms // 1000
            self._cur_idx.write(f"{sec} {self._cur_file.tell()}\n")
            for node in nodes:
                self._cur_file.write(node.to_line() + "\n")
            self._cur_file.flush()
            self._cur_idx.flush()

    def close(self) -> None:
        with self._lock:
            if self._cur_file is not None:
                self._cur_file.close()
                self._cur_idx.close()
                self._cur_file = self._cur_idx = None


class MetricSearcher:
    """Reads metric lines in a time range across the rolling files
    (``MetricSearcher.find``; the ``/metric`` command's backend)."""

    def __init__(self, base_dir: str, app: str):
        self.base_dir = base_dir
        self.app = app

    @staticmethod
    def _seek_offset(idx_path: str, begin_ms: int) -> int:
        """Largest indexed offset whose second precedes ``begin_ms`` — the
        reference seeks the same way (``MetricSearcher.java``: binary-search
        the .idx, then read forward)."""
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
             identity: Optional[str] = None, max_lines: int = 12000) -> List[MetricNode]:
        out: List[MetricNode] = []
        n = 0
        while True:
            path = os.path.join(self.base_dir, f"{self.app}-metrics.log.{n}")
            if not os.path.exists(path):
                break
            n += 1
        for i in range(n - 1, -1, -1):  # oldest file first
            path = os.path.join(self.base_dir, f"{self.app}-metrics.log.{i}")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    f.seek(self._seek_offset(path + ".idx", begin_ms))
                    for line in f:
                        try:
                            node = MetricNode.from_line(line)
                        except (ValueError, IndexError):
                            continue
                        if node.timestamp_ms < begin_ms:
                            continue
                        if node.timestamp_ms > end_ms:
                            break  # lines are time-ordered within a file
                        if identity and node.resource != identity:
                            continue
                        out.append(node)
                        if len(out) >= max_lines:
                            return out
            except OSError:
                continue
        return out


class MetricTimer:
    """1-second aggregation task (``MetricTimerListener``): snapshots every
    resource's ClusterNode into metric lines."""

    def __init__(self, writer: Optional[MetricWriter] = None, interval_s: float = 1.0):
        self.writer = writer or MetricWriter()
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricTimer":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sentinel-metric-timer"
        )
        self._thread.start()
        return self

    def collect_once(self) -> List[MetricNode]:
        from sentinel_tpu_torch.local.chain import cluster_node_map

        now = _clock.now_ms()
        # aggregate the PREVIOUS full second (it is complete)
        ts = (now // 1000 - 1) * 1000
        read_at = ts + 999
        nodes = []
        for name, cn in cluster_node_map().items():
            node = MetricNode(
                timestamp_ms=ts,
                resource=name,
                pass_qps=cn.pass_qps(read_at),
                block_qps=cn.block_qps(read_at),
                success_qps=cn.success_qps(read_at),
                exception_qps=cn.exception_qps(read_at),
                rt=cn.avg_rt(read_at),
                occupied_pass_qps=cn.occupied_pass_qps(read_at),
                concurrency=cn.cur_thread_num,
            )
            if (node.pass_qps or node.block_qps or node.success_qps
                    or node.exception_qps):
                nodes.append(node)
        return nodes

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.writer.write(self.collect_once())
            except Exception as e:
                record_log.warning("metric aggregation failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self.writer.close()
