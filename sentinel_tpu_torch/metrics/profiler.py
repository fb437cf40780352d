"""Opt-in ``torch.profiler`` control for a live server (the port's copy of
``sentinel_tpu/metrics/profiler.py``, which drives ``jax.profiler``).

``TokenServer``/``NativeTokenServer`` own one :class:`ProfilerHook` each so
the ``cluster/server/profiler`` command can start/stop a device trace on a
serving process without a restart (the always-on ``profile_dir`` /
``SENTINEL_PROFILE_DIR`` path stays — this is the on-demand variant).
One trace is active per process; the hook serializes start/stop and
reports a clean error when a trace is already running.

The hook also drives the host-side flight recorder (``sentinel_tpu_torch.trace``):
``start`` arms the rings at full sampling so every request in the profiled
window is traceable end-to-end, and ``stop`` writes the assembled spans as
``trace-spans-<ms>.json`` next to the Chrome trace (``trace-<ms>.json``,
host ops and, on a card, its kernels) — one command captures
BOTH the device timeline and the host pipeline stages that fed it. A window
where the device trace shows idle gaps and the span artifact shows frames
parked between ``enqueue`` and ``dispatch`` is the host starving the
device; without the span half that diagnosis needed a second tool.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.log import record_log


class ProfilerHook:
    def __init__(self, default_dir: Optional[str] = None):
        self._lock = threading.Lock()
        self.default_dir = default_dir
        self.trace_dir: Optional[str] = None
        self._was_armed = False
        self._prof = None

    @property
    def active(self) -> bool:
        return self.trace_dir is not None

    def start(self, trace_dir: Optional[str] = None) -> dict:
        from sentinel_tpu_torch.trace import ring as trace_ring

        with self._lock:
            if self.trace_dir is not None:
                return {
                    "error": f"already profiling to {self.trace_dir}",
                    "profiling": True, "dir": self.trace_dir,
                }
            target = trace_dir or self.default_dir
            if not target:
                return {"error": "trace dir required (dir= or profile_dir)"}
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            self._prof = prof
            self.trace_dir = target
            # an operator already arming a sampled recorder keeps it; the
            # profiled window itself records everything
            self._was_armed = trace_ring.ARMED
            trace_ring.arm(sample=1.0)
            record_log.info("profiler trace started → %s", target)
            return {"profiling": True, "dir": target}

    def stop(self) -> dict:
        from sentinel_tpu_torch.trace import ring as trace_ring
        from sentinel_tpu_torch.trace import spans as trace_spans

        with self._lock:
            if self.trace_dir is None:
                return {"error": "not profiling", "profiling": False}
            target, self.trace_dir = self.trace_dir, None
            prof, self._prof = self._prof, None

            spans_path: Optional[str] = None
            try:
                spans_path = trace_spans.write_artifact(
                    os.path.join(
                        target, f"trace-spans-{_clock.now_ms()}.json"
                    )
                )
            except Exception:
                record_log.exception("span artifact write failed")
            if not self._was_armed:
                trace_ring.disarm()
            try:
                prof.stop()
                prof.export_chrome_trace(
                    os.path.join(target, f"trace-{_clock.now_ms()}.json")
                )
            except Exception:
                record_log.exception("profiler stop failed")
                return {"error": "profiler stop failed", "dir": target,
                        "profiling": False, "spans": spans_path}
            record_log.info("profiler trace written → %s", target)
            return {"profiling": False, "dir": target, "spans": spans_path}

    def status(self) -> dict:
        return {"profiling": self.active, "dir": self.trace_dir}


_DEFAULT = ProfilerHook()


def default_hook() -> ProfilerHook:
    """Process-wide hook for the command surface when no token server is
    embedded (profiles whatever torch work this process runs)."""
    return _DEFAULT
