"""Always-on flight recorder: per-thread fixed-size struct rings.

The port's copy of ``sentinel_tpu/trace/ring.py``, with step spans.

Every hop of the serving pipeline — both front doors, the batcher, the
reply lanes, and the lease/hierarchy/MOVE control paths — drops a tiny
point event ``(t_ns, stage, xid, shard, aux)`` into a ring owned by the
recording thread. The service step, the param step and the door's control
lane record **step spans** into the same rings: a row with a start and an
end, a span id, the id of the span that caused it (its parent, 0 for a
root) and a step id shared by every span of one device step or one
request. A point event is a row whose end equals its start and that has no
span id. The discipline mirrors ``chaos/``:

- **Disarmed (the default)** the entire subsystem is ONE module-attribute
  read and branch per hop or span boundary (``if _TR.ARMED: ...``) — no
  lock, no call, no clock read, no allocation. This is what keeps the
  trace-off overhead inside the ≤2% serve_smoke gate.
- **Armed** each hop appends one 56-byte row to a thread-local numpy struct
  ring (no lock: one writer per ring) and the write head wraps, so memory
  is fixed no matter how long the recorder runs. Data-plane events are
  further gated by an xid-hash sample (``sample_xid``), so arming at a low
  rate on a production server records a representative slice, not the
  firehose. Step spans are control-plane rows (xid 0) and are never
  sampled: ``arm(sample=0.0)`` records every step span and no per-frame
  event.

The step spans (``aux`` in parens):

- ``svc.dispatch``: one device step's dispatch in
  ``DefaultTokenService.dispatch_batch_arrays`` or ``_dispatch_fused``
  (rows; a fused step: its depth); its children ``svc.prep``, once per
  frame in ``_prep_cached`` (1 prep-cache hit, 0 miss), and
  ``svc.launch``, the launches under the service lock (rows);
- ``svc.burst``: an oversized burst, the parent of its ``svc.dispatch``
  spans (rows); each of those is a step of its own;
- ``svc.materialize``: a dispatch's materializer, a root with its
  dispatch's step id (rows); its children ``svc.d2h``, the verdict reads
  (rows), and ``svc.sinks``, ``_record_served`` (rows);
- ``door.control``: ``NativeTokenServer._handle_control_item`` for a
  control frame, taken to its reply handed to the door (message type);
  a PARAM_FLOW frame's ``param.prep`` (the lock taken to the call of
  ``param_decide``; values), ``param.launch`` (the upload of the
  request's staging block and that call; padded values) and ``param.sync``
  (the verdict read of ``request_params_token``; 0) are its children.

Rows carry ``time.monotonic_ns()``. ``arm`` takes one (monotonic, wall)
anchor pair, so :func:`spans` also returns them on the clock of
``time.time_ns()``: the clock a ``torch.profiler`` device trace comes back
on (in an exported Chrome trace, ``baseTimeNanoseconds`` plus ``ts`` in
µs), so a step span lines up with the device's idle gaps. The profiler
hook's ``trace-spans-<ms>.json``, ``cluster/server/trace?action=spans``
and a black-box dump carry the spans on that clock (``stepSpans``) and the
anchor (``clockAnchor``).

Rings are registered process-wide so :mod:`sentinel_tpu_torch.trace.spans` can
assemble per-xid spans across threads and :mod:`sentinel_tpu_torch.trace.blackbox`
can dump the last N seconds post-mortem. A ring whose thread died mid-write
is still readable — readers treat rows as advisory (torn tails drop out in
span assembly), never as a consistency contract.

Env arming (mirrors ``SENTINEL_CHAOS``): ``SENTINEL_TRACE=1`` arms at
import, ``SENTINEL_TRACE_SAMPLE=0.01`` sets the xid sample fraction.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# -- point-event stage codes (aux meaning in parens) --------------------------
CLIENT_IN = 1    # frame decoded / pulled off a door (aux = rows)
ENQUEUE = 2      # frame handed to the batching queue (aux = queue depth)
DISPATCH = 3     # frame's batch entered the device dispatch (aux = batch rows)
REPLY_OUT = 6    # frame's reply encoded + submitted to its door (aux = rows)
SHED = 7         # frame/rows refused (aux = shed-reason index)
LEASE = 9        # lease grant/renew/return on the server (aux = tokens)
LEASE_LOCAL = 10  # client-local admission against a held lease (aux = n)
HIER = 11        # hierarchy share op (demand/grant/renew/return)
MOVE = 12        # MOVE begin/commit/abort (aux = phase: 0/1/2)
PROMOTE = 13     # standby promoted to primary
BROWNOUT = 14    # admission ladder escalated (aux = level)
SHM_POLL = 15    # shm ring door poll/doorbell activity (aux = frames)
OUTCOME = 16     # batched completion report ingested (aux = rows accepted)

# -- step-span stage codes (aux meaning in parens) ----------------------------
SVC_DISPATCH = 20     # one device step's dispatch: prep + launch (rows;
#                       fused: depth)
SVC_PREP = 21         # one frame's host prep (1 = prep-cache hit, 0 = miss)
SVC_LAUNCH = 22       # the device step's launches, under the lock (rows)
SVC_MATERIALIZE = 23  # a dispatch's materializer: d2h + sinks (rows)
SVC_D2H = 24          # the verdict reads back to the host (rows)
SVC_SINKS = 25        # the served batch's host sinks (rows)
DOOR_CONTROL = 26     # one control-lane frame, taken to reply (message type)
PARAM_PREP = 27       # the param step's host prep, under the lock (values)
PARAM_LAUNCH = 28     # the param step's upload and launch (padded values)
PARAM_SYNC = 29       # the param verdict read (0)
SVC_BURST = 30        # an oversized burst's dispatches (rows)
# the stages whose spans enclose others: on the thread's stack while open
_PARENT_STAGES = frozenset(
    (SVC_DISPATCH, SVC_MATERIALIZE, DOOR_CONTROL, SVC_BURST))

STAGE_NAMES: Dict[int, str] = {
    CLIENT_IN: "client_in",
    ENQUEUE: "enqueue",
    DISPATCH: "dispatch",
    REPLY_OUT: "reply_out",
    SHED: "shed",
    LEASE: "lease",
    LEASE_LOCAL: "lease_local",
    HIER: "hier",
    MOVE: "move",
    PROMOTE: "promote",
    BROWNOUT: "brownout",
    SHM_POLL: "shm_poll",
    OUTCOME: "outcome",
    SVC_DISPATCH: "svc.dispatch",
    SVC_PREP: "svc.prep",
    SVC_LAUNCH: "svc.launch",
    SVC_MATERIALIZE: "svc.materialize",
    SVC_D2H: "svc.d2h",
    SVC_SINKS: "svc.sinks",
    DOOR_CONTROL: "door.control",
    PARAM_PREP: "param.prep",
    PARAM_LAUNCH: "param.launch",
    PARAM_SYNC: "param.sync",
    SVC_BURST: "svc.burst",
}

# one ring row: 56 bytes, fixed. ``span`` is 0 on a point event.
_EVENT_DTYPE = np.dtype(
    [("t_ns", "<i8"), ("t_end", "<i8"), ("xid", "<i8"), ("span", "<i8"),
     ("parent", "<i8"), ("step", "<i8"), ("stage", "<i2"), ("shard", "<i2"),
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
# (monotonic_ns, time_ns) taken back to back at the last arm
_ANCHOR: Optional[tuple] = None
# span and step ids; next() on a count is atomic under the GIL
_IDS = itertools.count(1)


class _ThreadRing:
    """One thread's event ring. Single-writer; readers are advisory."""

    __slots__ = ("buf", "idx", "mask", "thread_name")

    def __init__(self, capacity: int, thread_name: str):
        self.buf = np.zeros(capacity, dtype=_EVENT_DTYPE)
        self.idx = 0  # monotonically increasing write head
        self.mask = capacity - 1
        self.thread_name = thread_name

    def write(self, t_ns: int, t_end: int, xid: int, span: int, parent: int,
              step: int, stage: int, shard: int, aux: int) -> None:
        self.buf[self.idx & self.mask] = (
            t_ns, t_end, xid, span, parent, step, stage, shard, aux)
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


class _Span:
    """An open step span: what :func:`end` writes."""

    __slots__ = ("t0", "span", "parent", "step", "stage", "aux")

    def __init__(self, t0, span, parent, step, stage, aux):
        self.t0, self.span, self.parent = t0, span, parent
        self.step, self.stage, self.aux = step, stage, aux


def _stack() -> list:
    """This thread's open spans of a parent stage, innermost last."""
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


# -- recording (call sites guard with `if ring.ARMED:`) -----------------------
def sample_xid(xid: int) -> bool:
    """True when this xid is inside the sampled slice."""
    return ((xid * _HASH_MULT) & 0xFFFFFFFF) < _SAMPLE_LIMIT


def record(stage: int, xid: int = 0, shard: int = 0, aux: int = 0) -> None:
    """Append one point event. Data-plane events (xid != 0) honor the
    sample; control-plane events (xid == 0) always record while armed."""
    if xid and ((xid * _HASH_MULT) & 0xFFFFFFFF) >= _SAMPLE_LIMIT:
        return
    t = time.monotonic_ns()
    _ring().write(t, t, xid, 0, 0, 0, stage, shard, aux)


def record_many(stage: int, xids, shard: int = 0, aux: int = 0) -> None:
    """One point event per sampled xid in ``xids`` (a batch hop touching
    many frames). Python-loop cost is paid only while armed and only for
    sampled xids."""
    r = _ring()
    t = time.monotonic_ns()
    lim = _SAMPLE_LIMIT
    for x in xids:
        x = int(x)
        if ((x * _HASH_MULT) & 0xFFFFFFFF) < lim:
            r.write(t, t, x, 0, 0, 0, stage, shard, aux)


def begin(stage: int, aux: int = 0, step: int = 0) -> _Span:
    """Open a step span on this thread; returns what :func:`end` takes.
    Its parent is the thread's innermost open span of a parent stage
    (``svc.dispatch``, ``svc.burst``, ``svc.materialize``,
    ``door.control``; 0 when none); its step is ``step`` when given, else
    a new one for a ``svc.dispatch`` (each is one device step), else the
    parent's, else a new one.
    Call sites guard with ``sp = ring.begin(...) if ring.ARMED else None``
    and close with ``if sp is not None: ring.end(sp)``, so a span opened
    armed is always written and one opened disarmed never is. A span of a
    parent stage stays on the thread's stack until its end: where an
    exception can leave its function, its caller ends it in a
    ``finally``."""
    stack = _stack()
    span = next(_IDS)
    parent = stack[-1] if stack else None
    if not step:
        step = (parent.step if parent is not None and stage != SVC_DISPATCH
                else span)
    sp = _Span(time.monotonic_ns(), span,
               parent.span if parent is not None else 0, step, stage, aux)
    if stage in _PARENT_STAGES:
        stack.append(sp)
    return sp


def end(sp: _Span, aux: Optional[int] = None) -> None:
    """Close ``sp`` and write its row (``aux`` replaces the one given at
    :func:`begin`). Parent spans that an exception left open inside it
    leave the thread's stack with it, unwritten."""
    t = time.monotonic_ns()
    stack = _stack()
    if sp in stack:
        del stack[stack.index(sp):]
    _ring().write(sp.t0, t, 0, sp.span, sp.parent, sp.step, sp.stage, 0,
                  sp.aux if aux is None else aux)


def current_step() -> int:
    """The step id of this thread's innermost open span, or a new one:
    what the spans of one request share when they are siblings."""
    stack = _stack()
    return stack[-1].step if stack else next(_IDS)


# -- arming -------------------------------------------------------------------
def arm(sample: float = 1.0) -> None:
    """Arm the recorder; ``sample`` is the fraction of xids recorded."""
    global ARMED, _SAMPLE_LIMIT, _SAMPLE_FRACTION, _ARMED_AT_NS, _ANCHOR
    sample = min(1.0, max(0.0, float(sample)))
    _SAMPLE_FRACTION = sample
    _SAMPLE_LIMIT = int(sample * (1 << 32))
    m0 = time.monotonic_ns()
    wall = time.time_ns()
    m1 = time.monotonic_ns()
    _ANCHOR = ((m0 + m1) // 2, wall)
    _ARMED_AT_NS = m1
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
    global _SAMPLE_LIMIT, _SAMPLE_FRACTION, _ARMED_AT_NS, _ANCHOR
    disarm()
    _SAMPLE_LIMIT = 1 << 32
    _SAMPLE_FRACTION = 1.0
    _ARMED_AT_NS = None
    _ANCHOR = None
    with _REG_LOCK:
        _RINGS.clear()
    _TLS.ring = None
    _TLS.stack = None


# -- reading ------------------------------------------------------------------
def _snapshot() -> List[tuple]:
    """``(thread name, valid rows)`` of every ring, live or torn; rows
    with t_ns == 0 (never written / torn tail) dropped."""
    with _REG_LOCK:
        rings = list(_RINGS)
    out = []
    for r in rings:
        rows = r.rows()
        if rows.shape[0]:
            out.append((r.thread_name, rows[rows["t_ns"] > 0]))
    return out


def events(
    xid: Optional[int] = None,
    since_ns: Optional[int] = None,
    stages: Optional[set] = None,
) -> List[dict]:
    """Snapshot matching point events from EVERY ring, sorted by time
    (step spans: :func:`spans`)."""
    out: List[dict] = []
    for thread, rows in _snapshot():
        keep = rows["span"] == 0
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
                "thread": thread,
            })
    out.sort(key=lambda e: e["t_ns"])
    return out


def clock_anchor() -> Optional[dict]:
    """The (monotonic, wall) pair taken at the last arm, or None."""
    if _ANCHOR is None:
        return None
    return {"monotonicNs": _ANCHOR[0], "wallNs": _ANCHOR[1]}


def spans(since_ns: Optional[int] = None, wall: bool = False,
          limit: Optional[int] = None) -> List[dict]:
    """Every step span in the rings, sorted by start: ``stage``,
    ``startNs``, ``endNs``, ``span``, ``parent``, ``step``, ``aux``,
    ``thread``. Times are ``time.monotonic_ns()``, or with ``wall`` the
    clock of ``time.time_ns()`` by the last arm's anchor; ``since_ns``
    (monotonic) keeps the spans that ended at or after it, ``limit`` those
    of the newest ``limit`` step ids."""
    shift = 0
    if wall and _ANCHOR is not None:
        shift = _ANCHOR[1] - _ANCHOR[0]
    out: List[dict] = []
    for thread, rows in _snapshot():
        keep = rows["span"] != 0
        if since_ns is not None:
            keep &= rows["t_end"] >= since_ns
        for row in rows[keep].tolist():
            t0, t1, _xid, span, parent, step, st, _shard, aux = row
            out.append({
                "stage": STAGE_NAMES.get(st, str(st)),
                "startNs": t0 + shift,
                "endNs": t1 + shift,
                "span": span,
                "parent": parent,
                "step": step,
                "aux": aux,
                "thread": thread,
            })
    if limit is not None:
        newest = set(sorted({s["step"] for s in out})[::-1][:max(0, limit)])
        out = [s for s in out if s["step"] in newest]
    out.sort(key=lambda s: s["startNs"])
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
