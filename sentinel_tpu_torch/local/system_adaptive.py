"""System-adaptive inbound protection (BBR-style) (the port's copy of
``sentinel_tpu/local/system_adaptive.py``).

Analog of ``slots/system/*`` — ``SystemSlot.java:33``,
``SystemRuleManager.java:242-340`` (qps / thread / rt / load-with-BBR / cpu
checks against the global inbound node) and ``SystemStatusListener.java:31-52``
(scheduled read of OS load + process CPU; here: lazy /proc sampling cached for
1s instead of a background thread).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import List

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.local.base import (
    EntryType,
    ORDER_SYSTEM_SLOT,
    SystemBlockException,
)
from sentinel_tpu_torch.local.chain import ProcessorSlot, entry_node, slot_registry


@dataclass
class SystemRule:
    """``SystemRule.java`` — any threshold < 0 is disabled."""

    highest_system_load: float = -1.0
    highest_cpu_usage: float = -1.0
    qps: float = -1.0
    avg_rt: float = -1.0
    max_thread: float = -1.0


class SystemStatusListener:
    """Lazy system status: 1-minute loadavg and process-CPU fraction, sampled
    at most once per second (the reference polls on a scheduler)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_sample_wall = 0.0
        self._load = -1.0
        self._cpu = -1.0
        self._last_proc = None  # (wall_s, cpu_s)

    def _sample(self) -> None:
        now = time.monotonic()
        if now - self._last_sample_wall < 1.0:
            return
        with self._lock:
            if now - self._last_sample_wall < 1.0:
                return
            self._last_sample_wall = now
            try:
                self._load = os.getloadavg()[0]
            except OSError:
                self._load = -1.0
            try:
                cpu_s = time.process_time()
                if self._last_proc is not None:
                    dw = now - self._last_proc[0]
                    dc = cpu_s - self._last_proc[1]
                    ncpu = os.cpu_count() or 1
                    self._cpu = max(0.0, min(1.0, dc / dw / ncpu)) if dw > 0 else -1.0
                self._last_proc = (now, cpu_s)
            except Exception:
                self._cpu = -1.0

    def current_load(self) -> float:
        self._sample()
        return self._load

    def current_cpu_usage(self) -> float:
        self._sample()
        return self._cpu


class SystemRuleManager:
    """Aggregates loaded rules into effective minima
    (``SystemRuleManager.loadSystemConf``)."""

    _lock = threading.RLock()
    _effective = SystemRule()
    _any_enabled = False
    status = SystemStatusListener()

    @classmethod
    def load_rules(cls, rules: List[SystemRule]) -> None:
        eff = SystemRule()
        any_enabled = False

        def merge(cur: float, new: float) -> float:
            if new < 0:
                return cur
            return new if cur < 0 else min(cur, new)

        for r in rules or []:
            eff.highest_system_load = merge(eff.highest_system_load, r.highest_system_load)
            eff.highest_cpu_usage = merge(eff.highest_cpu_usage, r.highest_cpu_usage)
            eff.qps = merge(eff.qps, r.qps)
            eff.avg_rt = merge(eff.avg_rt, r.avg_rt)
            eff.max_thread = merge(eff.max_thread, r.max_thread)
        any_enabled = any(
            v >= 0
            for v in (
                eff.highest_system_load,
                eff.highest_cpu_usage,
                eff.qps,
                eff.avg_rt,
                eff.max_thread,
            )
        )
        with cls._lock:
            cls._effective = eff
            cls._any_enabled = any_enabled

    @classmethod
    def register_property(cls, prop) -> None:
        prop.listen(lambda rules: cls.load_rules(rules or []))

    @classmethod
    def check_system(cls, resource, count: int) -> None:
        """``SystemRuleManager.checkSystem`` (``SystemRuleManager.java:290-340``):
        applies to inbound traffic only."""
        if not cls._any_enabled or resource.entry_type != EntryType.IN:
            return
        eff = cls._effective
        node = entry_node()
        now = _clock.now_ms()
        if eff.qps >= 0:
            # reference checkSystem uses ENTRY_NODE.passQps() alone
            # (SystemRuleManager.java:305); matured borrows already fold into
            # pass_qps via StatisticNode._touch
            if node.pass_qps(now) + count > eff.qps:
                raise SystemBlockException(resource.name, "qps")
        if eff.max_thread >= 0 and node.cur_thread_num + 1 > eff.max_thread:
            raise SystemBlockException(resource.name, "thread")
        if eff.avg_rt >= 0 and node.avg_rt(now) > eff.avg_rt:
            raise SystemBlockException(resource.name, "rt")
        if eff.highest_system_load >= 0:
            if cls.status.current_load() > eff.highest_system_load:
                if not cls._check_bbr(node, now):
                    raise SystemBlockException(resource.name, "load")
        if eff.highest_cpu_usage >= 0:
            if cls.status.current_cpu_usage() > eff.highest_cpu_usage:
                raise SystemBlockException(resource.name, "cpu")

    @classmethod
    def _check_bbr(cls, node, now: int) -> bool:
        """BBR gate (``SystemRuleManager.java:334-340``): under high load still
        admit while concurrency <= estimated BDP = maxSuccessQps * minRt."""
        cur_thread = node.cur_thread_num
        if cur_thread > 1:
            return cur_thread <= node.success_qps(now) * node.min_rt(now) / 1000.0
        return True

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._effective = SystemRule()
            cls._any_enabled = False


class SystemSlot(ProcessorSlot):
    """``SystemSlot.java:33``."""

    def entry(self, context, resource, node, count, prioritized, args):
        SystemRuleManager.check_system(resource, count)
        self.fire_entry(context, resource, node, count, prioritized, args)


slot_registry.register(SystemSlot, order=ORDER_SYSTEM_SLOT, name="SystemSlot")
