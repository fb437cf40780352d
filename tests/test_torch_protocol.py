"""The port's wire codec (``sentinel_tpu_torch.cluster.protocol``) against
the reference's (``sentinel_tpu.cluster.protocol``).

For seeded frames of every ``MsgType``, the port's encoders give the same
bytes as the reference's, and each package's decoders read the other's
frames to equal values. For a seeded corpus of hostile payloads (runts,
truncations, flipped bytes, random bytes behind every type byte), both
codecs accept or reject the same inputs, and what they accept decodes to
equal values.
"""

import dataclasses
import enum

import numpy as np
import pytest

pytest.importorskip("torch")

from sentinel_tpu.cluster import protocol as JP  # noqa: E402

from sentinel_tpu_torch.cluster import protocol as TP  # noqa: E402

SEEDS = (0, 1, 2)


def norm(x):
    """A comparable form of a decoded value from either package."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, (tuple, list)):
        return tuple(norm(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def frames(P, seed):
    """``[(label, frame bytes or list of frames)]``: seeded frames of every
    MsgType, encoded with ``P``."""
    rng = np.random.default_rng(seed)
    M = P.MsgType
    i64 = lambda: int(rng.integers(-2**62, 2**62))  # noqa: E731
    i32 = lambda: int(rng.integers(-2**31, 2**31))  # noqa: E731
    n = int(rng.integers(0, 300))
    ids = rng.integers(-2**40, 2**40, n)
    cnt = rng.integers(-5, 2**20, n).astype(np.int32)
    pri = rng.integers(0, 2, n).astype(np.uint8)
    status = rng.integers(-128, 128, n).astype(np.int8)
    rem = rng.integers(-2**31, 2**31, n).astype(np.int32)
    wait = rng.integers(-2**31, 2**31, n).astype(np.int32)
    hashes = tuple(i64() for _ in range(int(rng.integers(0, 20))))
    blob = rng.bytes(int(rng.integers(0, 3 * P.REPL_CHUNK_BYTES)))
    out = [
        ("ping", P.encode_request(P.Ping(i32(), "ns-é" * int(rng.integers(
            0, 5))))),
        ("batch_req", P.encode_batch_request(i32(), ids, cnt, pri)),
        ("batch_req_deadline", P.encode_batch_request(
            i32(), ids, cnt, pri, deadline_ms=int(rng.integers(1, 10**6)))),
        ("batch_rsp", P.encode_batch_response(i32(), status, rem, wait)),
        ("batch_rsps", P.encode_batch_responses(
            np.array([i32(), i32()]), np.array([n // 2, n - n // 2]),
            status, rem, wait)),
        ("outcome", P.encode_outcome_report(
            i32(), ids, rem, rng.integers(0, 2, n).astype(bool))),
        ("repl_hello", P.encode_repl_hello(i32(), i64(), i64(), i64(),
                                           "primary:1")),
        ("repl_ack", P.encode_repl_ack(i32(), int(rng.integers(0, 4)),
                                       i64(), i64())),
        ("demand", P.encode_demand_report(
            i32(), "pod-a", [(i64(), i64(), i64()) for _ in range(
                int(rng.integers(0, 30)))])),
        ("push_revoke", P.encode_push_lease_revoke(
            i32(), i64(), i64(), i64(), i32())),
        ("push_flip", P.encode_push_breaker_flip(
            i32(), i64(), i64(), int(rng.integers(0, 3)), i32())),
        ("push_epoch", P.encode_push_rule_epoch(i32(), i64(), i64())),
        ("push_map", P.encode_push_shard_map(i32(), i64(), rng.bytes(50))),
        ("push_brownout", P.encode_push_brownout(
            i32(), i64(), int(rng.integers(0, 3)), i32())),
    ]
    for mt in (M.FLOW, M.PARAM_FLOW, M.CONCURRENT_ACQUIRE,
               M.CONCURRENT_RELEASE):
        out.append((f"req_{mt.name}", P.encode_request(P.FlowRequest(
            i32(), i64(), i32(), bool(rng.integers(0, 2)), mt,
            hashes if mt == M.PARAM_FLOW else ()))))
        for st in (0, 1, P.MOVED_STATUS, P.DEGRADED_STATUS):
            out.append((f"rsp_{mt.name}_{st}", P.encode_response(
                P.FlowResponse(i32(), mt, st, i32(), i32(), i64(),
                               "10.0.0.1:18730"))))
    for mt in (M.REPL_DELTA, M.REPL_SNAPSHOT, M.MOVE_STATE):
        out.append((f"blob_{mt.name}", P.encode_repl_blob(
            i32(), mt, i64(), i64(), blob)))
    for mt in (M.MOVE_BEGIN, M.MOVE_COMMIT, M.MOVE_ABORT):
        out.append((f"move_{mt.name}", P.encode_move_ctrl(
            i32(), mt, i64(), "ns-" + "x" * int(rng.integers(0, 40)),
            "10.0.0.2:1")))
    for mt in sorted(P.LEASE_TYPES | P.SHARE_TYPES):
        out.append((f"lease_req_{int(mt)}", P.encode_lease_request(
            i32(), mt, i64(), i32(), lease_id=i64(), used=i32())))
        for st in (0, P.NOT_LEASABLE_STATUS, P.MOVED_STATUS):
            out.append((f"lease_rsp_{int(mt)}_{st}", P.encode_lease_response(
                i32(), mt, st, i64(), i32(), i32(), "10.0.0.3:2")))
    return out


def _payloads(frame):
    for f in (frame if isinstance(frame, list) else [frame]):
        yield f[2:]


def test_every_msgtype_is_covered():
    seen = set()
    for _label, frame in frames(TP, 0):
        for payload in _payloads(frame):
            seen.add(TP.peek_type(payload))
    assert seen == {int(t) for t in TP.MsgType}
    assert [int(t) for t in TP.MsgType] == [int(t) for t in JP.MsgType]
    assert [t.name for t in TP.MsgType] == [t.name for t in JP.MsgType]


@pytest.mark.parametrize("seed", SEEDS)
def test_encoders_give_the_reference_bytes(seed):
    ref = frames(JP, seed)
    got = frames(TP, seed)
    assert [label for label, _ in got] == [label for label, _ in ref]
    for (label, a), (_, b) in zip(got, ref):
        assert a == b, label


def decoders(P):
    """``{type byte: decode function}`` for every payload a peer reads."""
    M = P.MsgType
    out = {}
    for mt in (M.PING, M.FLOW, M.PARAM_FLOW, M.CONCURRENT_ACQUIRE,
               M.CONCURRENT_RELEASE):
        out[int(mt)] = P.decode_request
    out[int(M.BATCH_FLOW)] = P.decode_batch_request
    out[int(M.OUTCOME_REPORT)] = P.decode_outcome_report
    out[int(M.REPL_HELLO)] = P.decode_repl_hello
    out[int(M.REPL_ACK)] = P.decode_repl_ack
    for mt in (M.REPL_DELTA, M.REPL_SNAPSHOT, M.MOVE_STATE):
        out[int(mt)] = P.decode_repl_chunk
    for mt in (M.MOVE_BEGIN, M.MOVE_COMMIT, M.MOVE_ABORT):
        out[int(mt)] = P.decode_move_ctrl
    for mt in P.LEASE_TYPES | P.SHARE_TYPES:
        out[int(mt)] = P.decode_lease_request
    out[int(M.DEMAND_REPORT)] = P.decode_demand_report
    for mt in P.PUSH_TYPES:
        out[int(mt)] = P.decode_push
    return out


# replies, read by clients: decoded by type byte, not by direction
def reply_decoders(P):
    M = P.MsgType
    out = {int(mt): P.decode_response for mt in (
        M.PING, M.FLOW, M.PARAM_FLOW, M.CONCURRENT_ACQUIRE,
        M.CONCURRENT_RELEASE)}
    out[int(M.BATCH_FLOW)] = P.decode_batch_response
    for mt in P.LEASE_TYPES | P.SHARE_TYPES:
        out[int(mt)] = P.decode_lease_response
    return out


def _cross_decode(label, payload, reply):
    j_dec = (reply_decoders if reply else decoders)(JP)
    t_dec = (reply_decoders if reply else decoders)(TP)
    mt = TP.peek_type(payload)
    if mt not in t_dec:
        return 0
    assert mt in j_dec, label
    assert norm(t_dec[mt](payload)) == norm(j_dec[mt](payload)), label
    return 1


@pytest.mark.parametrize("seed", SEEDS)
def test_each_package_reads_the_others_frames(seed):
    decoded = 0
    for encoder, other in ((TP, JP), (JP, TP)):
        for label, frame in frames(encoder, seed):
            reply = label.startswith(("rsp_", "batch_rsp", "lease_rsp"))
            for payload in _payloads(frame):
                if label == "batch_rsps":
                    # several frames in one buffer: split them first
                    for p in other.FrameReader().feed(frame):
                        decoded += _cross_decode(label, p, True)
                    break
                decoded += _cross_decode(label, payload, reply)
    assert decoded > 50


def _outcome(fn, payload):
    try:
        return ("ok", norm(fn(payload)))
    except Exception:  # a refusal; its class may differ (struct.error
        # from the numpy batch decode, ValueError from the reference's
        # native one)
        return ("raises",)


def hostile_payloads(seed, count=400):
    """Runts, truncations, flipped bytes and random bodies behind every
    type byte, around seeded valid frames."""
    rng = np.random.default_rng(1000 + seed)
    valid = [p for _l, f in frames(TP, seed) for p in _payloads(f)]
    out = []
    for _ in range(count):
        base = bytearray(valid[int(rng.integers(len(valid)))])
        kind = int(rng.integers(0, 4))
        if kind == 0 and len(base) > 1:  # truncate
            base = base[: int(rng.integers(0, len(base)))]
        elif kind == 1 and base:  # flip bytes
            for _ in range(int(rng.integers(1, 4))):
                base[int(rng.integers(len(base)))] ^= int(
                    rng.integers(1, 256))
        elif kind == 2:  # random body behind a real type byte
            base = bytearray(rng.bytes(4)) + bytes(
                [int(rng.integers(0, 30))]) + rng.bytes(
                int(rng.integers(0, 64)))
        else:  # a declared row count beyond the payload
            if len(base) >= 7:
                base[5:7] = int(rng.integers(1, 65536)).to_bytes(2, "big")
        out.append(bytes(base))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_hostile_bytes_accepted_or_rejected_alike(seed):
    j_dec, t_dec = decoders(JP), decoders(TP)
    j_rep, t_rep = reply_decoders(JP), reply_decoders(TP)
    accepted = rejected = 0
    for payload in hostile_payloads(seed):
        if len(payload) >= 5:
            mt = payload[4]
            for jd, td in ((j_dec, t_dec), (j_rep, t_rep)):
                if mt in td:
                    a = _outcome(td[mt], payload)
                    b = _outcome(jd[mt], payload)
                    assert a == b, (payload.hex(), mt)
                    accepted += a[0] == "ok"
                    rejected += a[0] == "raises"
        # the stream splitter: every frame cut, or the buffer refused
        stream = len(payload).to_bytes(2, "big") + payload
        a = _outcome(TP.FrameReader().feed, stream)
        b = _outcome(JP.FrameReader().feed, stream)
        assert a == b, payload.hex()
    assert accepted > 20 and rejected > 20
