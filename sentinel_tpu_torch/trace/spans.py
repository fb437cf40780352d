"""Sampled end-to-end spans assembled on demand from the flight-recorder
rings.

The port's copy of ``sentinel_tpu/trace/spans.py``.

No wire change: the xid already rides every frame of every transport, so a
span is just "every ring event carrying this xid, time-ordered". Assembly
is a read-side join across ALL thread rings — intake shard, batcher,
device lane, reply lane each recorded their hop into their own ring, and
the xid stitches them back into one request timeline.

Spans are advisory by construction: a wrapped ring has already evicted the
oldest hops, and a thread that died mid-record leaves a torn tail. Both
show up as an *incomplete* span (``complete=False`` with the covered
stages listed), never as an exception — the completeness check is the
consumer's gate, not the assembler's.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from sentinel_tpu_torch.trace import ring as _R

# the client→reply contract: a complete span enters at the door and leaves
# through a reply (or an explicit shed refusal, which IS the reply)
_ENTRY_STAGE = "client_in"
_EXIT_STAGES = ("reply_out", "shed")


def assemble(xid: int) -> Optional[dict]:
    """Span for one xid, or None when no ring holds any event for it
    (unsampled xid, or the ring wrapped past it)."""
    evs = _R.events(xid=xid)
    if not evs:
        return None
    stages = [e["stage"] for e in evs]
    t0, t1 = evs[0]["t_ns"], evs[-1]["t_ns"]
    complete = _ENTRY_STAGE in stages and any(
        s in stages for s in _EXIT_STAGES
    )
    return {
        "xid": xid,
        "startNs": t0,
        "durationUs": round((t1 - t0) / 1_000.0, 3),
        "stages": stages,
        "complete": complete,
        "events": evs,
    }


def assemble_recent(limit: int = 64) -> List[dict]:
    """Spans for the most recently sampled xids (newest first)."""
    out = []
    for xid in _R.sampled_xids(limit=limit):
        sp = assemble(xid)
        if sp is not None:
            out.append(sp)
    return out


def completeness(spans: List[dict]) -> dict:
    """The trace-smoke gate: fraction of assembled spans covering
    client-in → reply-out."""
    total = len(spans)
    complete = sum(1 for s in spans if s["complete"])
    return {
        "spans": total,
        "complete": complete,
        "fraction": (complete / total) if total else None,
    }


def build_info() -> dict:
    """Identity labels stamped into span artifacts and black-box dumps, so
    a saved document names the build that produced it (the reference takes
    them from its Prometheus exporter, which the port has not yet)."""
    import torch

    from sentinel_tpu_torch.cluster.protocol import WIRE_REV

    return {
        "package": "sentinel_tpu_torch",
        "wire_rev": str(WIRE_REV),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
    }


def write_artifact(path: str, limit: int = 256) -> str:
    """Dump recent spans + completeness to a JSON artifact (the profiler
    hook's stop() product), with the step spans of the newest ``limit``
    steps on the wall clock (``time.time_ns()``; the Chrome trace the hook
    writes beside it is on it too, as ``baseTimeNanoseconds`` plus ``ts``)
    and the anchor that maps the rings' monotonic clock to it. Returns the
    written path."""
    spans = assemble_recent(limit=limit)
    doc = {
        "schema": "sentinel-trace-spans/1",
        "wallTime": time.time(),
        "build": build_info(),
        "trace": _R.status(),
        "completeness": completeness(spans),
        "spans": spans,
        "clockAnchor": _R.clock_anchor(),
        "stepSpans": _R.spans(wall=True, limit=limit),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)
    return path
