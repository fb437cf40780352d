"""Binary wire protocol for the token RPC.

The port's copy of ``sentinel_tpu/cluster/protocol.py``: the same frames,
byte for byte. Batch frames are encoded and decoded with numpy only (the
C++ door decodes and encodes the data plane itself).

Same shape as the reference's netty codec (``sentinel-cluster-common-default``):
a 2-byte big-endian length prefix (``LengthFieldBasedFrameDecoder(1024,0,2,0,2)``,
``NettyTransportServer.java:73-101``), then::

    | xid: int32 | type: uint8 | data... |

Request types (``ClusterConstants.java:24-28``): PING=0, FLOW=1, PARAM_FLOW=2,
CONCURRENT_ACQUIRE=3, CONCURRENT_RELEASE=4.

Flow request data  = ``flow_id:int64, count:int32, priority:uint8``
(``FlowRequestDataWriter.java:35-37``); flow responses carry
``status:int8, remaining:int32, wait_ms:int32`` (the reference moves status in
the response envelope and ``remaining/waitInMs`` in data,
``FlowResponseDataWriter.java:31-32`` — flattened here).

Param-flow request data = flow request + ``n_params:uint8`` + per-param
``hash:int64`` (the token server sketches param *hashes*; raw values never cross
the wire — see SURVEY.md §5 long-context note).

Concurrent (cluster-semaphore) messages: CONCURRENT_ACQUIRE uses the flow
request layout; its response appends ``token_id:int64`` (the reference moves
the token id in ``ConcurrentFlowAcquireResponseData``). CONCURRENT_RELEASE
reuses the ``flow_id`` slot to carry the token id being released
(``ConcurrentFlowReleaseRequestData`` carries only ``tokenId``).

BATCH_FLOW (an extension, no reference analog): one frame carries N flow
requests and one response frame carries their N verdicts — the client-side
mirror of the server's micro-batcher. Request data = ``n:uint16`` +
n × ``(flow_id:int64, count:int32, priority:uint8)``; response data =
``n:uint16`` + n × ``(status:int8, remaining:int32, wait_ms:int32)``.
Verdict order matches request order. Encode/decode are vectorized (numpy
structured dtypes): per-request Python cost is what the batch frame
removes.

Codec rev 3 — replication frames (the reference's ``ha/replication.py``): a
primary token server streams state to warm standbys over the SAME wire as
the data plane (both front doors route the new type bytes to their control
planes; the C++ door forwards every non-data-plane type untouched, so no
native rebuild is needed):

- ``REPL_HELLO``: ``gen:int64, epoch_ms:int64, last_seq:int64`` + a UTF-8
  sender id — the primary's sync probe; the standby's REPL_ACK answer says
  whether it can take deltas for this (generation, epoch) or needs a full
  snapshot first.
- ``REPL_DELTA`` / ``REPL_SNAPSHOT``: a zlib blob (JSON document) CHUNKED
  across frames — ``gen:int64, seq:int64, idx:uint16, total:uint16`` +
  chunk bytes; a full snapshot easily exceeds the 2-byte frame cap, and
  chunking keeps replication inside MAX_FRAME instead of forking the
  length prefix. The standby acks once the last chunk lands.
- ``REPL_ACK``: ``code:uint8, gen:int64, seq:int64`` — OK / NEED_SNAPSHOT
  (resync) / NOT_STANDBY (promoted or misconfigured peer) / ERROR.

Codec rev 4 — live-rebalance frames (the reference's ``cluster/rebalance.py``):
a source token server hands one namespace's counter state to a live
destination over the same wire, two-phase:

- ``MOVE_BEGIN`` / ``MOVE_COMMIT`` / ``MOVE_ABORT``: ``epoch:int64`` +
  ``ns_len:uint16`` + namespace UTF-8 + peer-id UTF-8 — the control steps
  of the drain-and-move protocol. The destination answers each with a
  REPL_ACK (OK / ERROR), reusing the rev-3 ack frame.
- ``MOVE_STATE``: the namespace's exported counter document, chunked with
  the SAME ``(gen, seq, idx, total)`` layout as REPL_DELTA/REPL_SNAPSHOT
  (``encode_repl_blob`` accepts MOVE_STATE; ``ReplBlobAssembler``
  reassembles it) — the move channel inherits replication's framing,
  chaos instrumentation, and torn-stream detection.
- a ``MOVED`` (= 10) status on the single-request response path appends
  the new owner's ``host:port`` endpoint as a UTF-8 trailer; batch rows
  stay fixed-size and carry the shard-map epoch in ``remaining``.

Codec rev 5 — token-lease frames (client-local admission): the token
service grants a client a short-TTL slice of a flow's window; the client
admits locally from the lease and reports usage on renew/return. All
three request types share ONE fixed layout (simpler codec, one fuzz
surface)::

    | lease_id: int64 | flow_id: int64 | used: int32 | want: int32 |

- ``LEASE_GRANT``: ``lease_id``/``used`` are 0; ``want`` is the token
  count requested.
- ``LEASE_RENEW``: reports ``used`` tokens consumed from ``lease_id``
  since the last report (the server credits the unused remainder when
  provably still in-window) and asks for a fresh ``want``-token slice.
- ``LEASE_RETURN``: final usage report; ``want`` is 0.

Responses share one layout too: ``status:int8, lease_id:int64,
tokens:int32, ttl_ms:int32`` — ``status`` is a ``TokenStatus`` byte. OK
carries a live lease; NOT_LEASABLE (= 11) is the refusal (flow not
leasable, no headroom, lease revoked) telling the client to fall back to
per-request RPCs and back off leasing this flow; MOVED appends the new
owner's endpoint as the rev-4 UTF-8 trailer. Both doors route the lease
type bytes to the token service's host-side lease handler (the C++ door
forwards non-data-plane bytes untouched, so no native rebuild).

Rev-5 family, hierarchy tier — pods lease provisioned SHARES of a global
flow budget from the cluster's budget coordinator, exactly as clients
lease slices from a pod, one level up:

- ``SHARE_GRANT`` / ``SHARE_RENEW`` / ``SHARE_RETURN`` reuse the lease
  request AND response layouts byte for byte (``lease_id`` is the share
  id, ``want``/``tokens`` are share tokens, ``ttl_ms`` is the share TTL).
  Distinct type bytes — not a flag — because the coordinator runs
  co-located with a pod behind the SAME door: a LEASE_GRANT for global
  flow F is a client leasing from that pod's local window, a SHARE_GRANT
  for F is a pod leasing from the global ledger.
- ``DEMAND_REPORT`` carries a pod's per-tick observed demand:
  ``pod_len:uint16, n_entries:uint16`` + pod-id UTF-8 + ``n_entries`` ×
  ``(flow_id:int64, share_id:int64, rate_milli:int64)``. Rates ride as
  milli-tokens/s so sub-token arrival rates survive the integer wire.
  The coordinator answers with the shared lease-response frame
  (``tokens`` = entries accepted); NOT_LEASABLE means "no coordinator
  attached here" and the agent should walk its endpoint list.

Both doors route ``HIER_TYPES`` to the service's attached coordinator
(``service.hierarchy``); a standby answers STANDBY like any other
control op, so agent-side failover walks on.

Codec rev 6 — batched outcome reports (the completion-telemetry plane):
clients record per-entry completion (RT ms, success/exception) locally and
coalesce them into ONE fire-and-forget frame, piggy-backed in front of the
next request frame on the same connection (the shm door publishes it as its
own ring slot — one slot carries exactly one frame). Data =
``n:uint16`` + n × ``(flow_id:int64, rt_ms:int32, exc:uint8)``::

    | flow_id: int64 | rt_ms: int32 | exc: uint8 |

There is NO response frame: outcome telemetry is best-effort by design, so
the lease/request fast path stays at zero extra RPCs and a server that
predates rev 6 simply drops the unknown type byte. RT values are validated
server-side at this wire boundary (negative / oversized values are counted
into ``sentinel_outcome_dropped_total`` rather than scattered) — see
``OUTCOME_MAX_RT_MS`` below.

Codec rev 7 — PUSH frames (the server→client push control plane):
unsolicited server→client frames carried on the SAME connections the data
plane already holds (TCP streams and the shm ring's response lane). They
are the inverse of every frame above — the server originates them, the
client never answers — and they cut worst-case control staleness from
TTL/tick scale to one RTT. All five share one envelope::

    | xid: int32 | type: uint8 | stamp_ms: int64 | data... |

``xid`` is a server-assigned push sequence (clients treat it as opaque;
the staleness probe stamps known xids), ``stamp_ms`` is the server's wall
clock at emit time — the client-side apply records
``now_ms - stamp_ms`` into the ``sentinel_push_staleness_ms`` histogram.

- ``LEASE_REVOKE``: ``lease_id:int64, flow_id:int64, tokens:int32`` —
  the server recalled this lease (rule reload, MOVE drain, breaker flip
  on the leased flow). The client credits nothing back to the server
  (charge-at-grant means the server already reclaimed the unused slice);
  it drops the ``_FlowLease`` immediately so local admits stop now
  instead of at TTL expiry.
- ``BREAKER_FLIP``: ``flow_id:int64, state:int8, retry_after_ms:int32``
  — a device-resident breaker transition (CLOSED/OPEN/HALF_OPEN, the
  DEGRADE.md state codes). OPEN makes the client answer DEGRADED locally
  (with the pushed retry-after) until the clock expires; CLOSED clears
  the local clock.
- ``RULE_EPOCH_INVALIDATE``: ``epoch:int64`` — the server's rule state
  generation bumped (``load_rules``); every cached lease and lease
  backoff for that server is stale. Clients drop them and re-fetch.
- ``SHARD_MAP_PUSH``: a zlib-compressed ShardMap JSON doc (``to_doc``);
  the doc carries its own epoch and feeds the client's epoch-fenced
  ``apply_shard_map`` learn path — a stale push is a no-op by the same
  fence that already guards the polling path.
- ``BROWNOUT_ADVISORY``: ``level:int8, retry_ms:int32`` — the admission
  ladder escalated (SHED_LOW/DEGRADE). Failover clients treat it as an
  early walk hint instead of waiting to be refused.

Delivery is at-most-once and fire-and-forget: a push rides the reply lane
behind verdict writes (never blocking one), a full queue or dead
connection silently drops it, and EVERY pushed fact is re-derivable from
the polling path (lease TTL, breaker refusal, shard-map publish, OVERLOAD
answer) — push tightens the staleness bound, it never replaces the
fallback. Old clients skip unknown type bytes (the rev-7 reader contract;
pre-rev-7 readers dropped the connection, which is why the mixed-rev
fix ships in the same rev).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from sentinel_tpu_torch import chaos as _chaos

# codec revision this build speaks: 2 deadline trailer, 3 REPL, 4 MOVE,
# 5 LEASE + HIER share ops, 6 OUTCOME_REPORT, 7 PUSH control plane (the
# doc revisions above)
WIRE_REV = 7

# 2-byte big-endian length prefix caps a frame at 65535 bytes; single-request
# messages keep the reference's 1024-byte budget, BATCH_FLOW frames use the
# full range (~5000 requests/frame at 13 B each).
MAX_FRAME = 65535
MAX_SINGLE_FRAME = 1024
_HEAD = struct.Struct(">ib")  # xid, type
_FLOW_REQ = struct.Struct(">qib")  # flow_id, count, priority
_FLOW_RSP = struct.Struct(">bii")  # status, remaining, wait_ms
_LEN = struct.Struct(">H")
_BATCH_N = struct.Struct(">H")
# codec rev 2: an OPTIONAL uint32 deadline (relative ms budget) trailing a
# BATCH_FLOW request's rows. Back-compatible both ways: old frames simply
# lack the trailer (deadline 0 = none), and every decoder in the fleet —
# numpy (count=n), the native Python codec (sn_batch_decode_req) and the C++
# front door (parse_frames) — validates `len >= needed` and skips the whole
# frame by its length prefix, so trailing bytes pass through old servers
# untouched. Relative-not-absolute keeps clock skew out of the contract.
_DEADLINE = struct.Struct(">I")

# vectorized batch codecs: packed big-endian structured rows
BATCH_REQ_DTYPE = np.dtype([("flow_id", ">i8"), ("count", ">i4"), ("prio", "u1")])
BATCH_RSP_DTYPE = np.dtype([("status", "i1"), ("remaining", ">i4"), ("wait_ms", ">i4")])
MAX_BATCH_PER_FRAME = (MAX_FRAME - _HEAD.size - _BATCH_N.size) // BATCH_REQ_DTYPE.itemsize

# rev-6 outcome rows: (flow_id, rt_ms, exc) — same 13-byte shape discipline
# as BATCH_REQ_DTYPE so one frame coalesces ~5000 completions
OUTCOME_ROW_DTYPE = np.dtype([("flow_id", ">i8"), ("rt_ms", ">i4"), ("exc", "u1")])
MAX_OUTCOME_PER_FRAME = (MAX_FRAME - _HEAD.size - _BATCH_N.size) // OUTCOME_ROW_DTYPE.itemsize

# wire-boundary RT validation ceiling (ms). The reference clamps recorded RT
# at statisticMaxRt (SentinelConfig, 4900 ms default); we keep a wider valve
# for slow-dependency telemetry but anything above it is a bogus report —
# dropped and counted (reason="too_large"), never scattered into rt_sum.
# The floor of the valid range is 0; negative values drop (reason="negative")
# and non-integral garbage drops client-side before the int cast
# (reason="non_finite").
OUTCOME_MAX_RT_MS = 60_000


class MsgType(enum.IntEnum):
    PING = 0
    FLOW = 1
    PARAM_FLOW = 2
    CONCURRENT_ACQUIRE = 3
    CONCURRENT_RELEASE = 4
    BATCH_FLOW = 5
    # codec rev 3: primary → standby state replication (control plane)
    REPL_HELLO = 6
    REPL_DELTA = 7
    REPL_ACK = 8
    REPL_SNAPSHOT = 9
    # codec rev 4: live shard rebalancing (control plane)
    MOVE_BEGIN = 10
    MOVE_STATE = 11
    MOVE_COMMIT = 12
    MOVE_ABORT = 13
    # codec rev 5: client-local admission leases
    LEASE_GRANT = 14
    LEASE_RENEW = 15
    LEASE_RETURN = 16
    # rev-5 family, hierarchy tier: pods lease provisioned SHARES of a
    # global flow budget from the coordinator. Share ops reuse the lease
    # request/response structs byte for byte — a pod is just a lease
    # client with a long TTL — but carry their own type bytes so the
    # coordinator pod's door can tell a pod-share op from a client-lease
    # op on the same flow_id without any payload sniffing.
    DEMAND_REPORT = 17
    SHARE_GRANT = 18
    SHARE_RENEW = 19
    SHARE_RETURN = 20
    # codec rev 6: batched fire-and-forget completion telemetry
    OUTCOME_REPORT = 21
    # codec rev 7: unsolicited server→client PUSH control frames. The
    # server originates these on connections the data plane already
    # holds; the client never answers. At-most-once, fire-and-forget —
    # every pushed fact is re-derivable from the polling path.
    LEASE_REVOKE = 22
    BREAKER_FLIP = 23
    RULE_EPOCH_INVALIDATE = 24
    SHARD_MAP_PUSH = 25
    BROWNOUT_ADVISORY = 26


# front doors route these type bytes to the replication applier instead of
# decode_request (which rejects them — they are not request frames)
REPL_TYPES = frozenset(
    {MsgType.REPL_HELLO, MsgType.REPL_DELTA, MsgType.REPL_ACK,
     MsgType.REPL_SNAPSHOT}
)

# rev-4 move frames route to the server's MoveTarget the same way
MOVE_TYPES = frozenset(
    {MsgType.MOVE_BEGIN, MsgType.MOVE_STATE, MsgType.MOVE_COMMIT,
     MsgType.MOVE_ABORT}
)

# rev-5 lease frames route to the token service's host-side lease handler
# on both doors (cheap control-plane ops answered inline, never batched)
LEASE_TYPES = frozenset(
    {MsgType.LEASE_GRANT, MsgType.LEASE_RENEW, MsgType.LEASE_RETURN}
)

# hierarchy tier: pod-share ops reuse the lease frame layout but carry their
# own type bytes so the coordinator pod's door can separate them from client
# leases on the same flow
SHARE_TYPES = frozenset(
    {MsgType.SHARE_GRANT, MsgType.SHARE_RENEW, MsgType.SHARE_RETURN}
)

# everything both doors route to the attached hierarchy coordinator
HIER_TYPES = frozenset(SHARE_TYPES | {MsgType.DEMAND_REPORT})

# rev-6 outcome frames route to the token service's outcome ingester on both
# doors; fire-and-forget (no response is ever written for these)
OUTCOME_TYPES = frozenset({MsgType.OUTCOME_REPORT})

# rev-7 push frames: server→client only. Client readers dispatch these
# out-of-band (they never resolve a pending xid); the decision-plane
# request decoder REFUSES them — a client that sends one at a server is a
# protocol error and the door drops the connection.
PUSH_TYPES = frozenset(
    {MsgType.LEASE_REVOKE, MsgType.BREAKER_FLIP,
     MsgType.RULE_EPOCH_INVALIDATE, MsgType.SHARD_MAP_PUSH,
     MsgType.BROWNOUT_ADVISORY}
)

# every type byte this build speaks. Client readers SKIP (and count) a
# frame whose type is outside this set instead of dropping the connection —
# the forward-compat contract a mixed-rev fleet needs during rollout.
KNOWN_TYPES = frozenset(int(t) for t in MsgType)

# TokenStatus.MOVED — mirrored here as a bare int because this module must
# stay importable without the engine (socket-only processes); decode_response keys
# the endpoint trailer on it
MOVED_STATUS = 10
# TokenStatus.NOT_LEASABLE, mirrored for the same reason: the rev-5 lease
# refusal (flow not leasable / no headroom / lease revoked)
NOT_LEASABLE_STATUS = 11
# TokenStatus.DEGRADED, mirrored for the same reason: the circuit-breaker
# refusal (resource breaker OPEN; ``remaining`` carries retry-after ms)
DEGRADED_STATUS = 12


class ReplAck(enum.IntEnum):
    """REPL_ACK codes."""

    OK = 0
    NEED_SNAPSHOT = 1  # gen/epoch mismatch or no sync yet: full resync first
    NOT_STANDBY = 2  # peer is promoted (or never was a standby)
    ERROR = 3  # frame understood but apply failed; sender resyncs


_REPL_HELLO = struct.Struct(">qqq")  # gen, epoch_ms, last_seq
_REPL_ACK = struct.Struct(">Bqq")  # code, gen, seq
_REPL_CHUNK = struct.Struct(">qqHH")  # gen, seq, idx, total
# room left in one frame for a delta/snapshot chunk's bytes
REPL_CHUNK_BYTES = MAX_FRAME - _HEAD.size - _REPL_CHUNK.size
_MOVE_CTRL = struct.Struct(">qH")  # epoch, ns_len (namespace + peer follow)


@dataclass(frozen=True)
class FlowRequest:
    xid: int
    flow_id: int
    count: int = 1
    prioritized: bool = False
    msg_type: MsgType = MsgType.FLOW
    param_hashes: Tuple[int, ...] = ()


@dataclass(frozen=True)
class FlowResponse:
    xid: int
    msg_type: MsgType
    status: int
    remaining: int = 0
    wait_ms: int = 0
    token_id: int = 0  # CONCURRENT_ACQUIRE only
    endpoint: str = ""  # MOVED only: the new owner's "host:port"


@dataclass(frozen=True)
class Ping:
    """Connection handshake/keepalive. Carries the client's namespace as its
    payload — the reference binds the connection to a namespace group this
    way (``TokenServerHandler.handlePingRequest`` reads the namespace string
    from the request data and answers with the group's connected count)."""

    xid: int
    namespace: str = "default"


def encode_request(req) -> bytes:
    if isinstance(req, Ping):
        payload = _HEAD.pack(req.xid, MsgType.PING) + req.namespace.encode(
            "utf-8"
        )
    elif isinstance(req, FlowRequest):
        payload = _HEAD.pack(req.xid, req.msg_type) + _FLOW_REQ.pack(
            req.flow_id, req.count, 1 if req.prioritized else 0
        )
        if req.msg_type == MsgType.PARAM_FLOW:
            payload += struct.pack(">B", len(req.param_hashes))
            for h in req.param_hashes:
                payload += struct.pack(">q", h)
    else:
        raise TypeError(f"unknown request {req!r}")
    if len(payload) > MAX_SINGLE_FRAME:
        raise ValueError("frame too large")
    return _LEN.pack(len(payload)) + payload


def encode_batch_request(
    xid: int, flow_ids, counts=None, prios=None, deadline_ms=None
) -> bytes:
    """One BATCH_FLOW frame carrying N flow requests (numpy-vectorized).

    ``deadline_ms`` (> 0) appends the rev-2 relative-deadline trailer: the
    sender's remaining budget in ms. A deadline-aware server drops the frame
    once the budget is blown (the client has already timed out); old servers
    ignore the trailer entirely.
    """
    flow_ids = np.asarray(flow_ids, dtype=np.int64)
    n = flow_ids.shape[0]
    if n > MAX_BATCH_PER_FRAME:
        raise ValueError(f"batch of {n} exceeds {MAX_BATCH_PER_FRAME}/frame")
    rows = np.empty(n, dtype=BATCH_REQ_DTYPE)
    rows["flow_id"] = flow_ids
    rows["count"] = 1 if counts is None else np.asarray(counts, dtype=np.int32)
    rows["prio"] = 0 if prios is None else np.asarray(prios, dtype=np.uint8)
    tail = b""
    if deadline_ms:
        tail = _DEADLINE.pack(min(int(deadline_ms), 0xFFFFFFFF))
    payload_len = (
        _HEAD.size + _BATCH_N.size + n * BATCH_REQ_DTYPE.itemsize + len(tail)
    )
    return (
        _LEN.pack(payload_len)
        + _HEAD.pack(xid, MsgType.BATCH_FLOW)
        + _BATCH_N.pack(n)
        + rows.tobytes()
        + tail
    )


_NATIVE = None


def _native_codec():
    """The native batch codec (:mod:`sentinel_tpu_torch.native.lib`),
    built and loaded at the first BATCH_FLOW decode or encode, never at
    import. Unlike the reference, nothing falls back to numpy: a library
    that cannot be built or loaded raises here."""
    global _NATIVE
    if _NATIVE is None:
        from sentinel_tpu_torch.native import lib as native_lib

        native_lib.load()
        _NATIVE = native_lib
    return _NATIVE


def decode_batch_request(payload: bytes):
    """BATCH_FLOW payload → (xid, flow_ids int64[N], counts int32[N],
    prios bool[N]). Caller has already checked the type byte. The row loop
    runs in the native codec with the GIL released; a malformed frame
    raises ValueError."""
    return _native_codec().batch_decode_req(payload)


def decode_batch_request_into(payload, ids_out, counts_out, prios_out, at=0):
    """Zero-copy BATCH_FLOW request decode: write the frame's N rows
    straight into caller-owned arrays starting at index ``at`` and return
    ``(xid, n)``.

    This is the staging-buffer entry point: the native intake lanes hand
    preallocated (freelist-recycled) ``int64/int32/bool`` staging arrays and
    frames land in them directly — no per-frame intermediate ndarrays, no
    realloc per pull. Decoded values are bit-identical to
    :func:`decode_batch_request` (property-tested); the only difference is
    where the rows land. Raises ``ValueError`` on a truncated frame or when
    the rows would overflow the staging span — callers treat both as a
    protocol error on that connection.
    """
    xid, _ = _HEAD.unpack_from(payload, 0)
    (n,) = _BATCH_N.unpack_from(payload, _HEAD.size)
    off = _HEAD.size + _BATCH_N.size
    if len(payload) < off + n * BATCH_REQ_DTYPE.itemsize:
        raise ValueError(
            f"truncated batch frame: {n} rows declared, "
            f"{len(payload) - off} payload bytes"
        )
    if at + n > ids_out.shape[0]:
        raise ValueError(
            f"staging overflow: rows [{at}, {at + n}) exceed capacity "
            f"{ids_out.shape[0]}"
        )
    rows = np.frombuffer(payload, dtype=BATCH_REQ_DTYPE, count=n, offset=off)
    # casted assignment decodes the big-endian rows during the copy into the
    # native-endian staging arrays — one pass per column, no intermediates
    ids_out[at : at + n] = rows["flow_id"]
    counts_out[at : at + n] = rows["count"]
    prios_out[at : at + n] = rows["prio"]
    return xid, n


def encode_outcome_report(xid: int, flow_ids, rt_ms, excs) -> bytes:
    """One OUTCOME_REPORT frame carrying N completion rows (rev 6).

    Fire-and-forget: the server never answers. Callers coalesce buffered
    completions and prepend this frame to the next request frame (TCP) or
    publish it as its own ring slot (shm)."""
    flow_ids = np.asarray(flow_ids, dtype=np.int64)
    n = flow_ids.shape[0]
    if n > MAX_OUTCOME_PER_FRAME:
        raise ValueError(f"outcome batch of {n} exceeds {MAX_OUTCOME_PER_FRAME}/frame")
    rows = np.empty(n, dtype=OUTCOME_ROW_DTYPE)
    rows["flow_id"] = flow_ids
    rows["rt_ms"] = np.asarray(rt_ms, dtype=np.int32)
    rows["exc"] = np.asarray(excs, dtype=np.uint8)
    payload_len = _HEAD.size + _BATCH_N.size + n * OUTCOME_ROW_DTYPE.itemsize
    return (
        _LEN.pack(payload_len)
        + _HEAD.pack(xid, MsgType.OUTCOME_REPORT)
        + _BATCH_N.pack(n)
        + rows.tobytes()
    )


def decode_outcome_report(payload: bytes):
    """OUTCOME_REPORT payload → (xid, flow_ids int64[N], rt_ms int32[N],
    excs bool[N]). Caller has already checked the type byte. Raises
    ``ValueError`` on a truncated frame (treated as a protocol error on
    that connection, like a truncated batch frame)."""
    xid, _ = _HEAD.unpack_from(payload, 0)
    (n,) = _BATCH_N.unpack_from(payload, _HEAD.size)
    off = _HEAD.size + _BATCH_N.size
    if len(payload) < off + n * OUTCOME_ROW_DTYPE.itemsize:
        raise ValueError(
            f"truncated outcome frame: {n} rows declared, "
            f"{len(payload) - off} payload bytes"
        )
    rows = np.frombuffer(payload, dtype=OUTCOME_ROW_DTYPE, count=n, offset=off)
    return (
        xid,
        rows["flow_id"].astype(np.int64),
        rows["rt_ms"].astype(np.int32),
        rows["exc"].astype(bool),
    )


class StagingPool:
    """Thread-safe freelist of preallocated staging blocks.

    ``factory()`` builds one block (any object — the native server uses a
    bundle of pinned request/frame-metadata arrays; the fused dispatcher
    uses stacked ``[depth, batch]`` RequestBatch leaves). ``acquire`` pops a
    recycled block or builds a fresh one when the freelist is dry (burst
    absorption — the pool never blocks a lane); ``release`` returns a block
    for reuse, dropping it once ``capacity`` blocks are already parked so a
    transient burst doesn't pin its high-water memory forever.

    Counters: ``reused`` / ``built`` expose the recycle rate — a healthy
    steady state reuses nearly always (``built`` ≈ the concurrency depth).
    ``outstanding`` counts blocks acquired but not yet released — the
    leak detector: once a server's lanes quiesce it must equal the number
    of blocks lanes legitimately hold (one per intake lane), or a
    shed/abandon path lost a block.
    """

    def __init__(self, factory, capacity: int = 16):
        import threading

        self._factory = factory
        self.capacity = int(capacity)
        self._free: List[object] = []
        self._lock = threading.Lock()
        self.reused = 0
        self.built = 0
        self.outstanding = 0

    def acquire(self):
        with self._lock:
            self.outstanding += 1
            if self._free:
                self.reused += 1
                return self._free.pop()
            self.built += 1
        return self._factory()

    def release(self, block) -> None:
        if block is None:
            return
        with self._lock:
            # outstanding decrements even when the block is dropped past
            # capacity: the lifecycle audit tracks acquire/release pairing,
            # not freelist residency
            self.outstanding -= 1
            if len(self._free) < self.capacity:
                self._free.append(block)


def decode_batch_deadline(payload: bytes) -> int:
    """The rev-2 relative deadline (ms) trailing a BATCH_FLOW request, or 0
    when absent (rev-1 frame / no budget declared). Tolerant of malformed
    payloads — the full decode is where validity is judged."""
    try:
        (n,) = _BATCH_N.unpack_from(payload, _HEAD.size)
    except struct.error:
        return 0
    tail = _HEAD.size + _BATCH_N.size + n * BATCH_REQ_DTYPE.itemsize
    if len(payload) >= tail + _DEADLINE.size:
        return _DEADLINE.unpack_from(payload, tail)[0]
    return 0


def encode_batch_response(xid: int, status, remaining, wait_ms) -> bytes:
    """One BATCH_FLOW response frame (length prefix included), encoded by
    the native codec."""
    return _native_codec().batch_encode_rsp(xid, status, remaining, wait_ms)


def batch_responses_size(counts) -> int:
    """Exact byte size :func:`encode_batch_responses` needs for ``counts``
    (callers sizing reusable ``out=`` scatter buffers)."""
    counts = np.asarray(counts, dtype=np.int64)
    head = _HEAD.size + _BATCH_N.size
    return int(
        counts.shape[0] * (_LEN.size + head)
        + int(counts.sum()) * BATCH_RSP_DTYPE.itemsize
    )


def encode_batch_responses(xids, counts, status, remaining, wait_ms,
                           out=None):
    """F BATCH_FLOW response frames in ONE buffer — the vectorized reply
    path. ``counts[f]`` rows belong to frame f (``sum(counts)`` must equal
    ``len(status)``); the verdict arrays are concatenated in frame order.

    Scatter encode: with ``out=`` (a ``bytearray`` — e.g. one reusable
    per-writer buffer), the frames are laid directly into it (grown in
    place when too small) and a ``memoryview`` of the filled span is
    returned — zero allocation on the steady-state path. Without ``out``
    a fresh ``bytes`` is allocated and returned (the original behavior).

    Two encode paths, byte-identical (property-tested against each other):

    - **uniform counts** (every frame the same size — the closed-loop /
      fused steady state): ONE vectorized pass lays rows AND headers via a
      strided ``[F, frame_len]`` uint8 view; no per-frame Python at all.
    - **ragged counts**: one numpy pass for all rows, then a small F-loop
      packs the 9-byte headers.
    """
    xids = np.asarray(xids)
    counts = np.asarray(counts, dtype=np.int64)
    status = np.asarray(status, dtype=np.int8)
    F = xids.shape[0]
    total = int(counts.sum())
    if total != status.shape[0]:
        raise ValueError(
            f"frame counts sum to {total}, got {status.shape[0]} verdicts"
        )
    rows = np.empty(total, dtype=BATCH_RSP_DTYPE)
    rows["status"] = status
    rows["remaining"] = np.asarray(remaining, dtype=np.int32)
    rows["wait_ms"] = np.asarray(wait_ms, dtype=np.int32)
    isz = BATCH_RSP_DTYPE.itemsize
    head = _HEAD.size + _BATCH_N.size
    size = F * (_LEN.size + head) + total * isz
    if out is None:
        buf = bytearray(size)
    else:
        if len(out) < size:
            out.extend(bytes(size - len(out)))  # grow once, then steady
        buf = out
    uniform = F > 0 and int(counts.min()) == int(counts.max())
    if uniform and total:
        n = int(counts[0])
        plen = head + n * isz
        flen = _LEN.size + plen
        view = np.frombuffer(buf, np.uint8, count=F * flen).reshape(F, flen)
        view[:, 0] = plen >> 8
        view[:, 1] = plen & 0xFF
        view[:, 2:6] = (
            np.ascontiguousarray(xids, dtype=">i4")
            .view(np.uint8).reshape(F, 4)
        )
        view[:, 6] = int(MsgType.BATCH_FLOW)
        view[:, 7] = n >> 8
        view[:, 8] = n & 0xFF
        view[:, 9:] = rows.view(np.uint8).reshape(F, n * isz)
    else:
        blob = rows.tobytes()
        mv = memoryview(buf)
        off = 0
        row0 = 0
        for f in range(F):
            n = int(counts[f])
            _LEN.pack_into(buf, off, head + n * isz)
            _HEAD.pack_into(
                buf, off + _LEN.size, int(xids[f]), MsgType.BATCH_FLOW
            )
            _BATCH_N.pack_into(buf, off + _LEN.size + _HEAD.size, n)
            start = off + _LEN.size + head
            mv[start : start + n * isz] = blob[row0 * isz : (row0 + n) * isz]
            off = start + n * isz
            row0 += n
    if out is None:
        return bytes(buf)
    return memoryview(buf)[:size]


def decode_batch_response(payload: bytes):
    """BATCH_FLOW response payload → (xid, status int8[N], remaining int32[N],
    wait_ms int32[N])."""
    xid, _ = _HEAD.unpack_from(payload, 0)
    (n,) = _BATCH_N.unpack_from(payload, _HEAD.size)
    off = _HEAD.size + _BATCH_N.size
    rows = np.frombuffer(payload, dtype=BATCH_RSP_DTYPE, count=n, offset=off)
    return (
        xid,
        rows["status"].astype(np.int8),
        rows["remaining"].astype(np.int32),
        rows["wait_ms"].astype(np.int32),
    )


def peek_type(payload: bytes) -> int:
    """Message type byte without a full decode (IO-thread fast path)."""
    return payload[4]


def peek_xid(payload: bytes) -> int:
    """Frame xid without a full decode (error-ack paths)."""
    (xid,) = struct.unpack_from(">i", payload, 0)
    return xid


# -- codec rev 3: replication frames -----------------------------------------
def encode_repl_hello(
    xid: int, gen: int, epoch_ms: int, last_seq: int, sender_id: str = ""
) -> bytes:
    payload = (
        _HEAD.pack(xid, MsgType.REPL_HELLO)
        + _REPL_HELLO.pack(gen, epoch_ms, last_seq)
        + sender_id.encode("utf-8")[:256]
    )
    return _LEN.pack(len(payload)) + payload


def decode_repl_hello(payload: bytes):
    """REPL_HELLO payload → (xid, gen, epoch_ms, last_seq, sender_id)."""
    xid, _ = _HEAD.unpack_from(payload, 0)
    gen, epoch_ms, last_seq = _REPL_HELLO.unpack_from(payload, _HEAD.size)
    sender = payload[_HEAD.size + _REPL_HELLO.size :].decode(
        "utf-8", errors="replace"
    )
    return xid, gen, epoch_ms, last_seq, sender


def encode_repl_ack(xid: int, code: int, gen: int, seq: int) -> bytes:
    payload = _HEAD.pack(xid, MsgType.REPL_ACK) + _REPL_ACK.pack(
        int(code), gen, seq
    )
    return _LEN.pack(len(payload)) + payload


def decode_repl_ack(payload: bytes):
    """REPL_ACK payload → (xid, code, gen, seq)."""
    xid, _ = _HEAD.unpack_from(payload, 0)
    code, gen, seq = _REPL_ACK.unpack_from(payload, _HEAD.size)
    return xid, ReplAck(code), gen, seq


def encode_repl_blob(
    xid: int, msg_type: int, gen: int, seq: int, blob: bytes
) -> List[bytes]:
    """One replication document (already compressed) → its chunk frames.

    Every chunk carries (gen, seq, idx, total) so the standby can reassemble
    and DETECT a torn stream: a chunk whose (gen, seq) doesn't extend the
    in-progress assembly restarts it. Rev 4 reuses this codec for the move
    channel (``MOVE_STATE``: ``gen`` = source state generation, ``seq`` =
    move epoch). An empty blob still emits one chunk
    (total=1) — an empty delta is the sender's liveness heartbeat."""
    if msg_type not in (
        MsgType.REPL_DELTA, MsgType.REPL_SNAPSHOT, MsgType.MOVE_STATE
    ):
        raise ValueError(f"not a repl blob type: {msg_type}")
    total = max(1, -(-len(blob) // REPL_CHUNK_BYTES))
    if total > 0xFFFF:
        raise ValueError(f"repl blob needs {total} chunks (cap 65535)")
    frames = []
    for idx in range(total):
        chunk = blob[idx * REPL_CHUNK_BYTES : (idx + 1) * REPL_CHUNK_BYTES]
        payload = (
            _HEAD.pack(xid, msg_type)
            + _REPL_CHUNK.pack(gen, seq, idx, total)
            + chunk
        )
        frames.append(_LEN.pack(len(payload)) + payload)
    return frames


def decode_repl_chunk(payload: bytes):
    """REPL_DELTA/REPL_SNAPSHOT payload → (xid, gen, seq, idx, total,
    chunk bytes). Raises ``ValueError`` on a runt payload."""
    if len(payload) < _HEAD.size + _REPL_CHUNK.size:
        raise ValueError("runt repl chunk")
    xid, _ = _HEAD.unpack_from(payload, 0)
    gen, seq, idx, total = _REPL_CHUNK.unpack_from(payload, _HEAD.size)
    if total == 0 or idx >= total:
        raise ValueError(f"bad repl chunk index {idx}/{total}")
    return xid, gen, seq, idx, total, payload[_HEAD.size + _REPL_CHUNK.size :]


class ReplBlobAssembler:
    """Reassembles chunked replication blobs on the standby side.

    ``feed`` returns ``(msg_type, gen, seq, blob)`` once the last chunk of a
    document lands, else None. Out-of-order or interleaved chunks restart
    the assembly (the repl channel is one TCP stream per sender — a gap can
    only mean the stream was torn and resumed); a malformed chunk raises
    ``ValueError`` so the server can drop the connection."""

    def __init__(self):
        self._key = None  # (msg_type, gen, seq, total)
        self._parts: List[bytes] = []

    def feed(self, msg_type: int, payload: bytes):
        _xid, gen, seq, idx, total, chunk = decode_repl_chunk(payload)
        key = (int(msg_type), gen, seq, total)
        if idx == 0:
            self._key, self._parts = key, [chunk]
        elif self._key == key and idx == len(self._parts):
            self._parts.append(chunk)
        else:
            self._key, self._parts = None, []
            raise ValueError("torn repl chunk stream")
        if len(self._parts) == total:
            blob = b"".join(self._parts)
            self._key, self._parts = None, []
            return int(msg_type), gen, seq, blob
        return None


# -- codec rev 4: move control frames -----------------------------------------
def encode_move_ctrl(
    xid: int, msg_type: int, epoch: int, namespace: str, peer: str = ""
) -> bytes:
    """MOVE_BEGIN / MOVE_COMMIT / MOVE_ABORT frame: the move's shard-map
    epoch, the namespace being moved, and the sender's peer id (the source
    server's ``host:port`` — what redirected clients are steered AWAY from,
    logged on the destination for the crash matrix)."""
    if msg_type not in (
        MsgType.MOVE_BEGIN, MsgType.MOVE_COMMIT, MsgType.MOVE_ABORT
    ):
        raise ValueError(f"not a move control type: {msg_type}")
    ns = namespace.encode("utf-8")
    if len(ns) > 0xFFFF:
        raise ValueError("namespace too long")
    payload = (
        _HEAD.pack(xid, msg_type)
        + _MOVE_CTRL.pack(epoch, len(ns))
        + ns
        + peer.encode("utf-8")[:256]
    )
    if len(payload) > MAX_FRAME:
        raise ValueError("move control frame too large")
    return _LEN.pack(len(payload)) + payload


def decode_move_ctrl(payload: bytes):
    """MOVE_BEGIN/COMMIT/ABORT payload → (xid, epoch, namespace, peer).
    Raises ``ValueError`` on a runt or torn payload (the door drops the
    connection, same contract as ``decode_request``)."""
    if len(payload) < _HEAD.size + _MOVE_CTRL.size:
        raise ValueError("runt move control frame")
    xid, _ = _HEAD.unpack_from(payload, 0)
    epoch, ns_len = _MOVE_CTRL.unpack_from(payload, _HEAD.size)
    off = _HEAD.size + _MOVE_CTRL.size
    if len(payload) < off + ns_len:
        raise ValueError("torn move control frame")
    namespace = payload[off : off + ns_len].decode("utf-8", errors="replace")
    peer = payload[off + ns_len :].decode("utf-8", errors="replace")
    return xid, epoch, namespace, peer


# -- codec rev 5: lease frames ------------------------------------------------
_LEASE_REQ = struct.Struct(">qqii")  # lease_id, flow_id, used, want
_LEASE_RSP = struct.Struct(">bqii")  # status, lease_id, tokens, ttl_ms


@dataclass(frozen=True)
class LeaseResponse:
    """Decoded rev-5 lease answer (grant/renew/return share the layout)."""

    xid: int
    msg_type: MsgType
    status: int
    lease_id: int = 0
    tokens: int = 0
    ttl_ms: int = 0
    endpoint: str = ""  # MOVED only: the new owner's "host:port"


def encode_lease_request(
    xid: int, msg_type: int, flow_id: int, want: int,
    lease_id: int = 0, used: int = 0,
) -> bytes:
    """LEASE_GRANT / LEASE_RENEW / LEASE_RETURN request frame. The
    hierarchy tier's SHARE_* ops reuse the same layout (a pod is a lease
    client with a long TTL), so they encode through here too."""
    if msg_type not in LEASE_TYPES and msg_type not in SHARE_TYPES:
        raise ValueError(f"not a lease type: {msg_type}")
    payload = _HEAD.pack(xid, msg_type) + _LEASE_REQ.pack(
        lease_id, flow_id, used, want
    )
    return _LEN.pack(len(payload)) + payload


def decode_lease_request(payload: bytes):
    """Lease request payload → (xid, msg_type, lease_id, flow_id, used,
    want). Raises ``ValueError`` on a runt or torn payload (the door drops
    the connection, same contract as ``decode_request``)."""
    if len(payload) < _HEAD.size + _LEASE_REQ.size:
        raise ValueError("runt lease request frame")
    xid, mtype = _HEAD.unpack_from(payload, 0)
    if mtype not in LEASE_TYPES and mtype not in SHARE_TYPES:
        raise ValueError(f"not a lease type: {mtype}")
    lease_id, flow_id, used, want = _LEASE_REQ.unpack_from(payload, _HEAD.size)
    return xid, MsgType(mtype), lease_id, flow_id, used, want


def encode_lease_response(
    xid: int, msg_type: int, status: int, lease_id: int = 0,
    tokens: int = 0, ttl_ms: int = 0, endpoint: str = "",
) -> bytes:
    """Lease answer frame; a MOVED status appends the rev-4 endpoint
    trailer so a redirected client learns the new owner in one round
    trip."""
    payload = _HEAD.pack(xid, msg_type) + _LEASE_RSP.pack(
        int(status), lease_id, tokens, ttl_ms
    )
    if int(status) == MOVED_STATUS and endpoint:
        payload += endpoint.encode("utf-8")[:256]
    return _LEN.pack(len(payload)) + payload


def decode_lease_response(payload: bytes) -> LeaseResponse:
    """Lease answer payload → :class:`LeaseResponse`. Raises ``ValueError``
    on a runt payload (client readers degrade to a dropped connection)."""
    if len(payload) < _HEAD.size + _LEASE_RSP.size:
        raise ValueError("runt lease response frame")
    xid, mtype = _HEAD.unpack_from(payload, 0)
    status, lease_id, tokens, ttl_ms = _LEASE_RSP.unpack_from(
        payload, _HEAD.size
    )
    endpoint = ""
    off = _HEAD.size + _LEASE_RSP.size
    if status == MOVED_STATUS and len(payload) > off:
        endpoint = payload[off:].decode("utf-8", errors="replace")
    return LeaseResponse(
        xid, MsgType(mtype), status, lease_id, tokens, ttl_ms, endpoint
    )


# -- hierarchy tier: demand-report frames -------------------------------------
# A pod's share agent ships one DEMAND_REPORT per tick: the pod id plus one
# entry per globally-limited flow carrying the share it holds and the arrival
# rate it observed (milli-tokens/s, so sub-token rates survive the int wire).
# The coordinator answers with the shared lease-response frame (status +
# tokens = entries accepted) — no second response layout to fuzz.
_DEMAND_HEAD = struct.Struct(">HH")  # pod_len, n_entries
_DEMAND_ENTRY = struct.Struct(">qqq")  # flow_id, share_id, rate_milli
MAX_DEMAND_ENTRIES = (
    MAX_FRAME - _HEAD.size - _DEMAND_HEAD.size - 256
) // _DEMAND_ENTRY.size


def encode_demand_report(
    xid: int, pod_id: str, entries: List[Tuple[int, int, int]]
) -> bytes:
    """DEMAND_REPORT frame: ``entries`` is ``[(flow_id, share_id,
    rate_milli), ...]``."""
    pod = pod_id.encode("utf-8")[:256]
    if len(entries) > MAX_DEMAND_ENTRIES:
        raise ValueError(f"too many demand entries: {len(entries)}")
    payload = bytearray(_HEAD.pack(xid, MsgType.DEMAND_REPORT))
    payload += _DEMAND_HEAD.pack(len(pod), len(entries))
    payload += pod
    for flow_id, share_id, rate_milli in entries:
        payload += _DEMAND_ENTRY.pack(int(flow_id), int(share_id), int(rate_milli))
    return _LEN.pack(len(payload)) + bytes(payload)


def decode_demand_report(payload: bytes):
    """DEMAND_REPORT payload → ``(xid, pod_id, entries)``. Raises
    ``ValueError`` on ANY runt, torn, or mistyped payload — the door drops
    the connection, never a partial decode."""
    if len(payload) < _HEAD.size + _DEMAND_HEAD.size:
        raise ValueError("runt demand report frame")
    xid, mtype = _HEAD.unpack_from(payload, 0)
    if mtype != MsgType.DEMAND_REPORT:
        raise ValueError(f"not a demand report: {mtype}")
    pod_len, n_entries = _DEMAND_HEAD.unpack_from(payload, _HEAD.size)
    off = _HEAD.size + _DEMAND_HEAD.size
    need = off + pod_len + n_entries * _DEMAND_ENTRY.size
    if len(payload) != need:
        raise ValueError("torn demand report frame")
    pod_id = payload[off : off + pod_len].decode("utf-8", errors="replace")
    off += pod_len
    entries: List[Tuple[int, int, int]] = []
    for _ in range(n_entries):
        entries.append(_DEMAND_ENTRY.unpack_from(payload, off))
        off += _DEMAND_ENTRY.size
    return xid, pod_id, entries


# -- codec rev 7: push frames --------------------------------------------------
# Every push payload starts with the server's emit stamp (wall-clock ms) so
# the client-side apply can record end-to-end staleness; per-type data
# follows. Fixed layouts, runt checks raise ValueError only — the client
# reader SKIPS a malformed push (and counts it) instead of dropping the
# connection, because a push never gates a pending request.
_PUSH_STAMP = struct.Struct(">q")  # stamp_ms
_PUSH_REVOKE = struct.Struct(">qqqi")  # stamp_ms, lease_id, flow_id, tokens
_PUSH_BREAKER = struct.Struct(">qqbi")  # stamp_ms, flow_id, state, retry_ms
_PUSH_EPOCH = struct.Struct(">qq")  # stamp_ms, epoch
_PUSH_BROWNOUT = struct.Struct(">qbi")  # stamp_ms, level, retry_ms


@dataclass(frozen=True)
class PushFrame:
    """One decoded rev-7 push. Only the fields the ``msg_type`` defines are
    meaningful; the rest stay at their zero values."""

    xid: int
    msg_type: MsgType
    stamp_ms: int = 0
    lease_id: int = 0
    flow_id: int = 0
    tokens: int = 0
    state: int = 0
    retry_after_ms: int = 0
    epoch: int = 0
    level: int = 0
    doc: bytes = b""  # SHARD_MAP_PUSH only: zlib-compressed map JSON


def encode_push_lease_revoke(
    xid: int, stamp_ms: int, lease_id: int, flow_id: int, tokens: int
) -> bytes:
    payload = _HEAD.pack(xid, MsgType.LEASE_REVOKE) + _PUSH_REVOKE.pack(
        stamp_ms, lease_id, flow_id, tokens
    )
    return _LEN.pack(len(payload)) + payload


def encode_push_breaker_flip(
    xid: int, stamp_ms: int, flow_id: int, state: int, retry_after_ms: int
) -> bytes:
    payload = _HEAD.pack(xid, MsgType.BREAKER_FLIP) + _PUSH_BREAKER.pack(
        stamp_ms, flow_id, int(state), int(retry_after_ms)
    )
    return _LEN.pack(len(payload)) + payload


def encode_push_rule_epoch(xid: int, stamp_ms: int, epoch: int) -> bytes:
    payload = _HEAD.pack(xid, MsgType.RULE_EPOCH_INVALIDATE) + _PUSH_EPOCH.pack(
        stamp_ms, epoch
    )
    return _LEN.pack(len(payload)) + payload


def encode_push_shard_map(xid: int, stamp_ms: int, doc: bytes) -> bytes:
    """``doc`` is the zlib-compressed ShardMap JSON (``to_doc``). A map too
    big for one frame is refused here — the polling publish path still
    carries it; push is an accelerator, not the only channel."""
    payload = _HEAD.pack(xid, MsgType.SHARD_MAP_PUSH) + _PUSH_STAMP.pack(
        stamp_ms
    ) + doc
    if len(payload) > MAX_FRAME:
        raise ValueError("shard map push frame too large")
    return _LEN.pack(len(payload)) + payload


def encode_push_brownout(
    xid: int, stamp_ms: int, level: int, retry_ms: int
) -> bytes:
    payload = _HEAD.pack(xid, MsgType.BROWNOUT_ADVISORY) + _PUSH_BROWNOUT.pack(
        stamp_ms, int(level), int(retry_ms)
    )
    return _LEN.pack(len(payload)) + payload


def decode_push(payload: bytes) -> PushFrame:
    """Any rev-7 push payload → :class:`PushFrame`. Raises ``ValueError`` on
    a runt payload or a non-push type byte — and ONLY ValueError (the fuzz
    containment contract): client readers catch it, count the frame, and
    keep the connection."""
    if len(payload) < _HEAD.size:
        raise ValueError("runt push frame")
    xid, mtype = _HEAD.unpack_from(payload, 0)
    if mtype not in PUSH_TYPES:
        raise ValueError(f"not a push type: {mtype}")
    mtype = MsgType(mtype)
    off = _HEAD.size
    if mtype == MsgType.LEASE_REVOKE:
        if len(payload) < off + _PUSH_REVOKE.size:
            raise ValueError("runt lease revoke push")
        stamp, lease_id, flow_id, tokens = _PUSH_REVOKE.unpack_from(payload, off)
        return PushFrame(xid, mtype, stamp, lease_id=lease_id,
                         flow_id=flow_id, tokens=tokens)
    if mtype == MsgType.BREAKER_FLIP:
        if len(payload) < off + _PUSH_BREAKER.size:
            raise ValueError("runt breaker flip push")
        stamp, flow_id, state, retry = _PUSH_BREAKER.unpack_from(payload, off)
        return PushFrame(xid, mtype, stamp, flow_id=flow_id, state=state,
                         retry_after_ms=retry)
    if mtype == MsgType.RULE_EPOCH_INVALIDATE:
        if len(payload) < off + _PUSH_EPOCH.size:
            raise ValueError("runt rule epoch push")
        stamp, epoch = _PUSH_EPOCH.unpack_from(payload, off)
        return PushFrame(xid, mtype, stamp, epoch=epoch)
    if mtype == MsgType.BROWNOUT_ADVISORY:
        if len(payload) < off + _PUSH_BROWNOUT.size:
            raise ValueError("runt brownout push")
        stamp, level, retry = _PUSH_BROWNOUT.unpack_from(payload, off)
        return PushFrame(xid, mtype, stamp, level=level, retry_after_ms=retry)
    # SHARD_MAP_PUSH: stamp + opaque doc bytes (the doc may legitimately be
    # any length ≥ 0; an empty doc is a no-op push)
    if len(payload) < off + _PUSH_STAMP.size:
        raise ValueError("runt shard map push")
    (stamp,) = _PUSH_STAMP.unpack_from(payload, off)
    return PushFrame(xid, mtype, stamp, doc=payload[off + _PUSH_STAMP.size:])


def encode_response(rsp: FlowResponse) -> bytes:
    payload = _HEAD.pack(rsp.xid, rsp.msg_type) + _FLOW_RSP.pack(
        rsp.status, rsp.remaining, rsp.wait_ms
    )
    if rsp.msg_type == MsgType.CONCURRENT_ACQUIRE:
        payload += struct.pack(">q", rsp.token_id)
    elif rsp.status == MOVED_STATUS and rsp.endpoint:
        # rev 4: the redirect target rides as a UTF-8 trailer. Back-compat
        # both ways — a rev-3 decoder's unpack_from ignores trailing bytes,
        # and a rev-4 decoder only reads the trailer on a MOVED status.
        payload += rsp.endpoint.encode("utf-8")[:256]
    return _LEN.pack(len(payload)) + payload


def decode_request(payload: bytes):
    xid, mtype = _HEAD.unpack_from(payload, 0)
    mtype = MsgType(mtype)
    if mtype == MsgType.PING:
        ns = payload[_HEAD.size :].decode("utf-8", errors="replace")
        # lenient where the reference answers "bad" on a blank namespace:
        # an empty payload (older client) falls back to the default group
        return Ping(xid, ns or "default")
    if mtype in (MsgType.FLOW, MsgType.CONCURRENT_ACQUIRE, MsgType.CONCURRENT_RELEASE):
        flow_id, count, prio = _FLOW_REQ.unpack_from(payload, _HEAD.size)
        return FlowRequest(xid, flow_id, count, bool(prio), mtype)
    if mtype == MsgType.PARAM_FLOW:
        off = _HEAD.size
        flow_id, count, prio = _FLOW_REQ.unpack_from(payload, off)
        off += _FLOW_REQ.size
        (n,) = struct.unpack_from(">B", payload, off)
        off += 1
        hashes = struct.unpack_from(f">{n}q", payload, off) if n else ()
        return FlowRequest(xid, flow_id, count, bool(prio), mtype, tuple(hashes))
    raise ValueError(f"unknown message type {mtype}")


def decode_response(payload: bytes) -> FlowResponse:
    xid, mtype = _HEAD.unpack_from(payload, 0)
    mtype = MsgType(mtype)
    status, remaining, wait_ms = _FLOW_RSP.unpack_from(payload, _HEAD.size)
    token_id = 0
    endpoint = ""
    off = _HEAD.size + _FLOW_RSP.size
    if mtype == MsgType.CONCURRENT_ACQUIRE and len(payload) >= off + 8:
        (token_id,) = struct.unpack_from(">q", payload, off)
    elif status == MOVED_STATUS and len(payload) > off:
        endpoint = payload[off:].decode("utf-8", errors="replace")
    return FlowResponse(
        xid, mtype, status, remaining, wait_ms, token_id, endpoint
    )


class FrameReader:
    """Incremental length-prefixed frame splitter for a byte stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        if _chaos.ARMED:  # inbound bit-rot injection (frame_corrupt)
            data = _chaos.mangle("frame_corrupt", data)
        self._buf.extend(data)
        frames = []
        while True:
            if len(self._buf) < _LEN.size:
                break
            (n,) = _LEN.unpack_from(self._buf, 0)
            # a 2-byte length cannot exceed MAX_FRAME (65535), but a frame
            # too short for even a header is garbage — drop the connection
            if n < _HEAD.size:
                raise ValueError("runt frame")
            if len(self._buf) < _LEN.size + n:
                break
            frames.append(bytes(self._buf[_LEN.size : _LEN.size + n]))
            del self._buf[: _LEN.size + n]
        return frames
