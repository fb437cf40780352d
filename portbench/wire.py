"""The token server's wire, as a client speaks it: a frozen copy of the
framing in ``sentinel_tpu_torch/cluster/protocol.py`` (2-byte big-endian
length prefix; ``>ib`` xid and type; BATCH_FLOW rows ``>q>iu1`` in and
``i1>i>i`` out; PARAM_FLOW ``>qib`` then a ``>B`` count of ``>q`` value
hashes), so the load generator needs nothing of the program."""

from __future__ import annotations

import struct
from typing import List

import numpy as np

PING, PARAM_FLOW, BATCH_FLOW = 0, 2, 5
# server-to-client push frames (rev 7), never a reply to a request
PUSH_TYPES = frozenset(range(22, 27))
MAX_FRAME = 65535
_LEN = struct.Struct(">H")
_HEAD = struct.Struct(">ib")
_BATCH_N = struct.Struct(">H")
_FLOW_REQ = struct.Struct(">qib")
_FLOW_RSP = struct.Struct(">bii")
BATCH_REQ_DTYPE = np.dtype([("flow_id", ">i8"), ("count", ">i4"),
                            ("prio", "u1")])
BATCH_RSP_DTYPE = np.dtype([("status", "i1"), ("remaining", ">i4"),
                            ("wait_ms", ">i4")])
MAX_BATCH_PER_FRAME = ((MAX_FRAME - _HEAD.size - _BATCH_N.size)
                       // BATCH_REQ_DTYPE.itemsize)
# where a frame's xid sits, counted from its length prefix
XID_OFFSET = _LEN.size
BATCH_ROWS_OFFSET = _HEAD.size + _BATCH_N.size  # in a payload


def encode_batch_request(xid: int, flow_ids, counts, prios) -> bytes:
    n = len(flow_ids)
    if n > MAX_BATCH_PER_FRAME:
        raise ValueError(f"{n} rows exceed {MAX_BATCH_PER_FRAME} a frame")
    rows = np.empty(n, BATCH_REQ_DTYPE)
    rows["flow_id"] = flow_ids
    rows["count"] = counts
    rows["prio"] = np.asarray(prios, np.uint8)
    size = _HEAD.size + _BATCH_N.size + rows.nbytes
    return (_LEN.pack(size) + _HEAD.pack(xid, BATCH_FLOW) + _BATCH_N.pack(n)
            + rows.tobytes())


def encode_param_request(xid: int, flow_id: int, acquire: int,
                         hashes) -> bytes:
    payload = (_HEAD.pack(xid, PARAM_FLOW)
               + _FLOW_REQ.pack(flow_id, acquire, 0)
               + struct.pack(">B", len(hashes))
               + struct.pack(f">{len(hashes)}q", *hashes))
    return _LEN.pack(len(payload)) + payload


def encode_ping(xid: int, namespace: str = "default") -> bytes:
    payload = _HEAD.pack(xid, PING) + namespace.encode("utf-8")
    return _LEN.pack(len(payload)) + payload


def set_xid(frame: bytearray, xid: int) -> None:
    """Rewrite a pre-encoded frame's xid in place."""
    struct.pack_into(">i", frame, XID_OFFSET, xid)


def head(payload) -> tuple:
    """``(xid, type)`` of a payload."""
    return _HEAD.unpack_from(payload, 0)


def batch_rows(payload) -> np.ndarray:
    """A BATCH_FLOW reply's rows (``BATCH_RSP_DTYPE``), zero-copy."""
    (n,) = _BATCH_N.unpack_from(payload, _HEAD.size)
    return np.frombuffer(payload, BATCH_RSP_DTYPE, count=n,
                         offset=BATCH_ROWS_OFFSET)


def flow_response(payload) -> tuple:
    """``(status, remaining, wait_ms)`` of a single-request reply."""
    return _FLOW_RSP.unpack_from(payload, _HEAD.size)


def rows_bytes(status, remaining, wait) -> bytes:
    """Verdict rows in the reply's wire layout (for digests)."""
    rows = np.empty(len(status), BATCH_RSP_DTYPE)
    rows["status"], rows["remaining"] = status, remaining
    rows["wait_ms"] = wait
    return rows.tobytes()


class FrameReader:
    """Incremental splitter of a length-prefixed byte stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data) -> List[bytes]:
        buf = self._buf
        buf.extend(data)
        out, pos = [], 0
        while len(buf) - pos >= _LEN.size:
            (n,) = _LEN.unpack_from(buf, pos)
            if n < _HEAD.size:
                raise ValueError("runt frame")
            if len(buf) - pos < _LEN.size + n:
                break
            out.append(bytes(buf[pos + _LEN.size:pos + _LEN.size + n]))
            pos += _LEN.size + n
        del buf[:pos]
        return out
