"""Always-on flight recorder: per-thread fixed-size struct rings.

The port's copy of ``sentinel_tpu/trace/ring.py``.

Every hop of the serving pipeline — both front doors, the batcher, the
device step boundary, the reply lanes, and the lease/hierarchy/MOVE control
paths — drops a tiny ``(t_ns, stage, xid, shard, aux)`` event into a ring
owned by the recording thread. The discipline mirrors ``chaos/``:

- **Disarmed (the default)** the entire subsystem is ONE module-attribute
  read and branch per hop (``if _TR.ARMED: ...``) — no lock, no call, no
  allocation. This is what keeps the trace-off overhead inside the ≤2%
  serve_smoke gate.
- **Armed** each hop appends one 24-byte row to a thread-local numpy struct
  ring (no lock: one writer per ring) and the write head wraps, so memory
  is fixed no matter how long the recorder runs. Data-plane events are
  further gated by an xid-hash sample (``sample_xid``), so arming at a low
  rate on a production server records a representative slice, not the
  firehose.

Rings are registered process-wide so :mod:`sentinel_tpu_torch.trace.spans` can
assemble per-xid spans across threads and :mod:`sentinel_tpu_torch.trace.blackbox`
can dump the last N seconds post-mortem. A ring whose thread died mid-write
is still readable — readers treat rows as advisory (torn tails drop out in
span assembly), never as a consistency contract.

Env arming (mirrors ``SENTINEL_CHAOS``): ``SENTINEL_TRACE=1`` arms at
import, ``SENTINEL_TRACE_SAMPLE=0.01`` sets the xid sample fraction.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# -- stage codes (aux meaning in parens) --------------------------------------
CLIENT_IN = 1    # frame decoded / pulled off a door (aux = rows)
ENQUEUE = 2      # frame handed to the batching queue (aux = queue depth)
DISPATCH = 3     # frame's batch entered the device dispatch (aux = batch rows)
DEVICE_IN = 4    # device step submitted (aggregate, xid=0; aux = rows)
DEVICE_OUT = 5   # device step materialized (aggregate, xid=0; aux = rows)
REPLY_OUT = 6    # frame's reply encoded + submitted to its door (aux = rows)
SHED = 7         # frame/rows refused (aux = shed-reason index)
FUSE = 8         # fusion ladder stacked frames (aggregate; aux = depth)
LEASE = 9        # lease grant/renew/return on the server (aux = tokens)
LEASE_LOCAL = 10  # client-local admission against a held lease (aux = n)
HIER = 11        # hierarchy share op (demand/grant/renew/return)
MOVE = 12        # MOVE begin/commit/abort (aux = phase: 0/1/2)
PROMOTE = 13     # standby promoted to primary
BROWNOUT = 14    # admission ladder escalated (aux = level)
SHM_POLL = 15    # shm ring door poll/doorbell activity (aux = frames)
OUTCOME = 16     # batched completion report ingested (aux = rows accepted)

STAGE_NAMES: Dict[int, str] = {
    CLIENT_IN: "client_in",
    ENQUEUE: "enqueue",
    DISPATCH: "dispatch",
    DEVICE_IN: "device_in",
    DEVICE_OUT: "device_out",
    REPLY_OUT: "reply_out",
    SHED: "shed",
    FUSE: "fuse",
    LEASE: "lease",
    LEASE_LOCAL: "lease_local",
    HIER: "hier",
    MOVE: "move",
    PROMOTE: "promote",
    BROWNOUT: "brownout",
    SHM_POLL: "shm_poll",
    OUTCOME: "outcome",
}

# one ring row: 24 bytes, fixed
_EVENT_DTYPE = np.dtype(
    [("t_ns", "<i8"), ("xid", "<i8"), ("stage", "<i2"), ("shard", "<i2"),
     ("aux", "<i4")]
)

DEFAULT_RING_EVENTS = 8192  # per thread; power of two (mask-wrapped)

# -- the armed flag: the ONLY thing hot paths read when tracing is off --------
ARMED: bool = False

# xid sampling: a data-plane xid is recorded iff hash(xid) < _SAMPLE_LIMIT.
# Fibonacci-hash the xid so adjacent xids (every client counts up) spread
# uniformly over the 32-bit range; limit = fraction × 2^32.
_HASH_MULT = 2654435761
_SAMPLE_LIMIT = 1 << 32  # sample everything by default
_SAMPLE_FRACTION = 1.0

_REG_LOCK = threading.Lock()
_RINGS: List["_ThreadRing"] = []
_TLS = threading.local()
_ARMED_AT_NS: Optional[int] = None


class _ThreadRing:
    """One thread's event ring. Single-writer; readers are advisory."""

    __slots__ = ("buf", "idx", "mask", "thread_name")

    def __init__(self, capacity: int, thread_name: str):
        self.buf = np.zeros(capacity, dtype=_EVENT_DTYPE)
        self.idx = 0  # monotonically increasing write head
        self.mask = capacity - 1
        self.thread_name = thread_name

    def write(self, t_ns: int, stage: int, xid: int, shard: int,
              aux: int) -> None:
        i = self.idx & self.mask
        row = self.buf[i]
        row["t_ns"] = t_ns
        row["xid"] = xid
        row["stage"] = stage
        row["shard"] = shard
        row["aux"] = aux
        self.idx += 1

    def rows(self) -> np.ndarray:
        """Valid rows, oldest→newest write order (advisory under a live
        writer; a torn tail shows as a t_ns=0 or stale row and is filtered
        by readers)."""
        n = min(self.idx, self.mask + 1)
        if n == 0:
            return self.buf[:0]
        if self.idx <= self.mask + 1:
            return self.buf[:n]
        head = self.idx & self.mask
        return np.concatenate([self.buf[head:], self.buf[:head]])


def _ring() -> _ThreadRing:
    r = getattr(_TLS, "ring", None)
    if r is None:
        r = _ThreadRing(DEFAULT_RING_EVENTS, threading.current_thread().name)
        _TLS.ring = r
        with _REG_LOCK:
            _RINGS.append(r)
    return r


# -- recording (call sites guard with `if ring.ARMED:`) -----------------------
def sample_xid(xid: int) -> bool:
    """True when this xid is inside the sampled slice."""
    return ((xid * _HASH_MULT) & 0xFFFFFFFF) < _SAMPLE_LIMIT


def record(stage: int, xid: int = 0, shard: int = 0, aux: int = 0) -> None:
    """Append one event. Data-plane events (xid != 0) honor the sample;
    control-plane events (xid == 0) always record while armed."""
    if xid and ((xid * _HASH_MULT) & 0xFFFFFFFF) >= _SAMPLE_LIMIT:
        return
    _ring().write(time.monotonic_ns(), stage, xid, shard, aux)


def record_many(stage: int, xids, shard: int = 0, aux: int = 0) -> None:
    """One event per sampled xid in ``xids`` (a batch hop touching many
    frames). Python-loop cost is paid only while armed and only for
    sampled xids."""
    r = _ring()
    t = time.monotonic_ns()
    lim = _SAMPLE_LIMIT
    for x in xids:
        x = int(x)
        if ((x * _HASH_MULT) & 0xFFFFFFFF) < lim:
            r.write(t, stage, x, shard, aux)


# -- arming -------------------------------------------------------------------
def arm(sample: float = 1.0) -> None:
    """Arm the recorder; ``sample`` is the fraction of xids recorded."""
    global ARMED, _SAMPLE_LIMIT, _SAMPLE_FRACTION, _ARMED_AT_NS
    sample = min(1.0, max(0.0, float(sample)))
    _SAMPLE_FRACTION = sample
    _SAMPLE_LIMIT = int(sample * (1 << 32))
    _ARMED_AT_NS = time.monotonic_ns()
    ARMED = True


def disarm() -> None:
    global ARMED
    ARMED = False


def status() -> dict:
    with _REG_LOCK:
        threads = [
            {"thread": r.thread_name,
             "events": int(min(r.idx, r.mask + 1)),
             "dropped": int(max(0, r.idx - (r.mask + 1)))}
            for r in _RINGS
        ]
    return {
        "armed": ARMED,
        "sample": _SAMPLE_FRACTION,
        "ringEvents": DEFAULT_RING_EVENTS,
        "threads": threads,
        "totalEvents": sum(t["events"] for t in threads),
    }


def reset_for_tests() -> None:
    """Disarm and drop every registered ring (tests/benches only — live
    threads re-register their ring on the next armed record)."""
    global _SAMPLE_LIMIT, _SAMPLE_FRACTION, _ARMED_AT_NS
    disarm()
    _SAMPLE_LIMIT = 1 << 32
    _SAMPLE_FRACTION = 1.0
    _ARMED_AT_NS = None
    with _REG_LOCK:
        _RINGS.clear()
    if getattr(_TLS, "ring", None) is not None:
        _TLS.ring = None


# -- reading ------------------------------------------------------------------
def events(
    xid: Optional[int] = None,
    since_ns: Optional[int] = None,
    stages: Optional[set] = None,
) -> List[dict]:
    """Snapshot matching events from EVERY ring (live or torn), sorted by
    time. Rows with t_ns == 0 (never written / torn tail) are dropped."""
    with _REG_LOCK:
        rings = list(_RINGS)
    out: List[dict] = []
    for r in rings:
        rows = r.rows()
        if rows.shape[0] == 0:
            continue
        keep = rows["t_ns"] > 0
        if since_ns is not None:
            keep &= rows["t_ns"] >= since_ns
        if xid is not None:
            keep &= rows["xid"] == xid
        for row in rows[keep]:
            st = int(row["stage"])
            if stages is not None and st not in stages:
                continue
            out.append({
                "t_ns": int(row["t_ns"]),
                "stage": STAGE_NAMES.get(st, str(st)),
                "xid": int(row["xid"]),
                "shard": int(row["shard"]),
                "aux": int(row["aux"]),
                "thread": r.thread_name,
            })
    out.sort(key=lambda e: e["t_ns"])
    return out


def sampled_xids(limit: int = 256) -> List[int]:
    """Distinct data-plane xids seen at client_in, newest first."""
    seen: Dict[int, int] = {}
    for e in events(stages={CLIENT_IN}):
        if e["xid"]:
            seen[e["xid"]] = e["t_ns"]
    ordered = sorted(seen, key=seen.get, reverse=True)
    return ordered[:limit]


def _env_arm() -> None:
    if os.environ.get("SENTINEL_TRACE", "") not in ("", "0"):
        try:
            frac = float(os.environ.get("SENTINEL_TRACE_SAMPLE", "1.0"))
        except ValueError:
            frac = 1.0
        arm(sample=frac)


_env_arm()
