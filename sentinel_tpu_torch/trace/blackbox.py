"""Black-box post-mortem dumps.

The port's copy of ``sentinel_tpu/trace/blackbox.py``.

When something goes wrong on a serving node — the brownout ladder
escalates, a standby promotes itself, a MOVE aborts, or an operator asks —
the last N seconds of flight-recorder rings plus a full metrics snapshot
and the config fingerprint are dumped atomically to
``blackbox-<ts>.json``. The point is the flight-data-recorder property:
the evidence of WHY is captured at the moment of the event, not
reconstructed later from whatever the dashboards happened to retain.

Auto-dumps are opt-in (``configure(dir)`` or ``SENTINEL_BLACKBOX_DIR``)
and rate-limited so a flapping trigger can't fill a disk; ``dump()`` is
the unconditional operator path. Every trigger call is wrapped so a dump
failure can never take down the path that tripped it — a post-mortem
recorder that crashes the patient is worse than none.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.trace import ring as _R

_LOCK = threading.Lock()
_DIR: Optional[str] = os.environ.get("SENTINEL_BLACKBOX_DIR") or None
_WINDOW_S: float = 30.0
_MIN_INTERVAL_S: float = 5.0
_last_dump: float = 0.0
dumps_written: int = 0
last_path: Optional[str] = None


def configure(
    directory: Optional[str],
    window_s: float = 30.0,
    min_interval_s: float = 5.0,
) -> None:
    """Enable (or disable with None) automatic trigger dumps."""
    global _DIR, _WINDOW_S, _MIN_INTERVAL_S
    _DIR = directory
    _WINDOW_S = float(window_s)
    _MIN_INTERVAL_S = float(min_interval_s)


def enabled() -> bool:
    return _DIR is not None


def config_fingerprint() -> str:
    """Stable hash of the effective config layers (defaults + file +
    explicit sets) — two dumps with the same fingerprint ran the same
    knobs."""
    from sentinel_tpu_torch.core.config import SentinelConfig, _DEFAULTS

    with SentinelConfig._lock:
        merged = dict(_DEFAULTS)
        merged.update(SentinelConfig._file_props)
        merged.update(SentinelConfig._props)
    blob = json.dumps(merged, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _document(reason: str, window_s: Optional[float]) -> dict:
    from sentinel_tpu_torch.trace.spans import build_info
    from sentinel_tpu_torch.metrics.server import server_metrics
    from sentinel_tpu_torch.trace.slo import slo_plane

    win = _WINDOW_S if window_s is None else float(window_s)
    since = time.monotonic_ns() - int(win * 1e9)
    return {
        "schema": "sentinel-blackbox/1",
        "reason": reason,
        "wallTime": time.time(),
        "build": build_info(),
        "configFingerprint": config_fingerprint(),
        "windowSeconds": win,
        "trace": _R.status(),
        "events": _R.events(since_ns=since),
        # step spans that ended in the window, on the wall clock
        "clockAnchor": _R.clock_anchor(),
        "stepSpans": _R.spans(since_ns=since, wall=True),
        "metrics": server_metrics().snapshot(),
        "slo": slo_plane().snapshot(),
    }


def dump(
    reason: str,
    directory: Optional[str] = None,
    window_s: Optional[float] = None,
) -> str:
    """Write one dump unconditionally; returns the path. Atomic: readers
    never see a half-written file (tmp + rename in the same dir)."""
    global dumps_written, last_path
    target = directory or _DIR
    if not target:
        raise ValueError("no black-box directory configured")
    os.makedirs(target, exist_ok=True)
    doc = _document(reason, window_s)
    ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(
        target, f"blackbox-{ts}-{os.getpid()}-{dumps_written}.json"
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    with _LOCK:
        dumps_written += 1
        last_path = path
    record_log.warning("black-box dump (%s) → %s", reason, path)
    return path


def maybe_dump(reason: str) -> Optional[str]:
    """The trigger path (brownout escalation, promotion, MOVE abort):
    no-op unless configured, rate-limited, and NEVER raises into the
    caller — the serving path that tripped the trigger must not pay for a
    broken recorder."""
    global _last_dump
    if _DIR is None:
        return None
    now = time.monotonic()
    with _LOCK:
        if now - _last_dump < _MIN_INTERVAL_S:
            return None
        _last_dump = now
    try:
        return dump(reason)
    except Exception:
        record_log.exception("black-box dump (%s) failed", reason)
        return None


def reset_for_tests() -> None:
    global _DIR, _WINDOW_S, _MIN_INTERVAL_S, _last_dump, dumps_written
    global last_path
    _DIR = os.environ.get("SENTINEL_BLACKBOX_DIR") or None
    _WINDOW_S = 30.0
    _MIN_INTERVAL_S = 5.0
    _last_dump = 0.0
    dumps_written = 0
    last_path = None
