"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity over a slice of the window, reduced to the busy time (the union
of every device operation's interval), the operations by name, and the
idle gaps, each named by the host lane whose spans cover most of it.

Device timestamps come back on the host's wall clock in nanoseconds, the
clock of ``time.time_ns()``, which the cells' host spans use."""

from __future__ import annotations

import collections
import sys
import time
from typing import Dict, List, Tuple

TOP = 10


class DeviceTrace:
    def __init__(self, device: str):
        import torch

        self.torch = torch
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def prime(self) -> None:
        """Trace a few operations during set-up, before the program's
        threads start: the profiler's first start initialises its device
        tracing, which takes seconds and, begun under the running server,
        recorded nothing."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        with profile(activities=[ProfilerActivity.CUDA]):
            x = torch.ones(1024, device=self.device)
            x.mul_(2.0)
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        self.t1_ns = time.time_ns()
        self.prof.stop()
        self.events = self.device_events()

    def device_events(self) -> List[Tuple[str, int, int]]:
        """``(name, start_ns, end_ns)`` of every device operation, clipped
        to the traced slice."""
        out, seen = [], 0
        lo = hi = None
        kinds = collections.Counter()
        for e in self.prof.profiler.kineto_results.events():
            kinds[str(e.device_type())] += 1
            if str(e.device_type()) != "DeviceType.CUDA":
                continue
            seen += 1
            s, d = int(e.start_ns()), int(e.duration_ns())
            lo = s if lo is None else min(lo, s)
            hi = s + d if hi is None else max(hi, s + d)
            a, b = max(s, self.t0_ns), min(s + d, self.t1_ns)
            if b > a:
                out.append((e.name(), a, b))
        out.sort(key=lambda x: x[1])
        print(f"trace: {len(out)} of {seen} device operations in the slice "
              f"[{self.t0_ns}, {self.t1_ns}] (recorded from {lo} to {hi}; "
              f"events by device {dict(kinds)})",
              file=sys.stderr, flush=True)
        return out

    def summary(self, spans: List[Tuple[str, int, int]]) -> Dict:
        """``busy_s``, ``window_s``, the events, and the breakdown."""
        events = self.events
        busy, gaps = 0, []
        cur_a = cur_b = None
        edge = self.t0_ns
        for _n, a, b in events:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                gaps.append((edge if cur_b is None else cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
            gaps.append((cur_b, self.t1_ns))
        else:
            gaps.append((self.t0_ns, self.t1_ns))
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, a, b in events:
            by_name[n] += (b - a) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {
            "busy_s": busy / 1e9,
            "window_s": (self.t1_ns - self.t0_ns) / 1e9,
            "events": events,
            "t0_ns": self.t0_ns,
            "t1_ns": self.t1_ns,
            "breakdown": {
                "device_ops": [[n[:96], s] for n, s in top],
                "idle_gaps": [[lane_of(a, b, spans), (b - a) / 1e9]
                              for a, b in longest],
            },
        }


def lane_of(a: int, b: int, spans: List[Tuple[str, int, int]]) -> str:
    """The host lane whose spans cover most of ``[a, b)``, or ``idle``."""
    cover: Dict[str, int] = collections.defaultdict(int)
    for lane, s, e in spans:
        lo, hi = max(a, s), min(b, e)
        if hi > lo:
            cover[lane] += hi - lo
    if not cover:
        return "idle"
    return max(cover.items(), key=lambda kv: kv[1])[0]


def kernel_base(name: str) -> str:
    """A kernel's bare function name: ``void decide_kernel(Params)`` and
    ``(anonymous namespace)::cms_decide_kernel(param::Rows, ...)`` ->
    ``decide_kernel``, ``cms_decide_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].split(" ")[-1].split("::")[-1]
