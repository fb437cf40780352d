"""Seeded front-door workload over raw sockets, shared by ``chip_smoke.py``
(the port's ``NativeTokenServer`` on the card, held against a twin
``DefaultTokenService`` on the torch-ops cores) and
``tests/test_torch_server_native.py`` (the JAX package's door against the
port's on the CPU, reply bytes equal).

Imports numpy and the standard library only: the caller passes a
``protocol`` module ``P`` (either package's; their frames are the same
bytes) and, where it holds replies against a service, the service.

- :func:`lockstep_plan`: a seeded sequence of request steps: bounded-Zipf
  BATCH_FLOW pulls (a pull larger than a frame goes out as its chunk
  frames), FLOW and PARAM_FLOW requests, OUTCOME_REPORT frames (each
  followed by a PING, the barrier that shows the report was taken), lease
  grant / renew / return and CONCURRENT acquire / release, with the manual
  clock's advance before each step.
- :func:`run_lockstep`: sends the steps one frame at a time on one
  connection, each after the previous reply, so that every frame is its
  own device step; returns the reply payloads and, given a ``twin``
  service, holds every reply value for value against the twin's answer to
  the same call at the same clock.
- :func:`xid_probe`: pipelined BATCH_FLOW frames with distinct xids; every
  xid must come back exactly once with its row count.
- :func:`closed_loop`: clients in worker processes, each on its own
  connection, sending pulls back to back; served verdicts/s and client
  RTTs. :func:`param_rtt`: PARAM_FLOW frames one at a time.
- :class:`FrameDropProxy`: a TCP proxy in front of a door that drops the
  first client frame of one message type (the native door applies the
  chaos ``frame_drop`` point to data-plane pulls only, so a lost control
  frame is made here).
"""

from __future__ import annotations

import collections
import importlib
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

NAMESPACE = "default"
OUTCOME_INVALID_SHARE = 0.01
UNKNOWN_FLOW = 10**12  # an id no rule holds
ACQUIRE, RELEASE = "conc_acquire", "conc_release"


class RawConn:
    """One client connection speaking the length-prefixed wire with ``P``.
    Push frames (rev 7) that arrive between replies are kept apart."""

    def __init__(self, P, port: int, host: str = "127.0.0.1",
                 timeout_s: float = 60.0):
        self.P = P
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.reader = P.FrameReader()
        self.pending: collections.deque = collections.deque()
        self.pushes: List[bytes] = []

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv(self) -> bytes:
        """The next reply payload (push frames set aside)."""
        P = self.P
        while True:
            while self.pending:
                payload = self.pending.popleft()
                if P.peek_type(payload) in P.PUSH_TYPES:
                    self.pushes.append(payload)
                    continue
                return payload
            data = self.sock.recv(1 << 20)
            if not data:
                raise ConnectionError("the server closed the connection")
            self.pending.extend(self.reader.feed(data))

    def closed_by_peer(self, timeout_s: float = 5.0) -> bool:
        """True once the server has closed the connection (EOF)."""
        self.sock.settimeout(timeout_s)
        try:
            while True:
                data = self.sock.recv(1 << 16)
                if not data:
                    return True
        except (socket.timeout, ConnectionResetError):
            return False

    def ping(self, xid: int) -> int:
        """The handshake: joins the namespace's connection group; returns
        the group's connected count."""
        P = self.P
        self.send(P.encode_request(P.Ping(xid, NAMESPACE)))
        return P.decode_response(self.recv()).remaining

    def close(self) -> None:
        self.sock.close()


def chunks(n: int, max_frame: int) -> List[slice]:
    return [slice(i, min(i + max_frame, n)) for i in range(0, n, max_frame)]


def lockstep_plan(
    rng: np.random.Generator,
    zipf: Callable[[np.random.Generator, int], np.ndarray],
    flow_ids: np.ndarray,
    pull_sizes: Sequence[int],
    param_flows: Sequence[int],
    lease_flows: Sequence[int],
    conc_flows: Sequence[int],
    rounds: int,
    max_frame: int,
    advances_ms: Sequence[int],
    report_rows: int = 1024,
) -> List[dict]:
    """The seeded request steps (see the module docstring). ``zipf(rng,
    n)`` draws ``n`` ranks into ``flow_ids`` (rank 0 hottest); pulls with
    mixed acquires and prioritized rows alternate by round. Pulls and the
    report advance the clock by ``advances_ms`` in turn, the other steps by
    0-3 ms."""
    steps: List[dict] = []
    xid = 1000
    grants: List[int] = []  # step indices of lease grants not returned
    held: List[int] = []  # step indices of concurrent acquires not released

    def add(kind: str, advance: int = 0, **kw) -> int:
        nonlocal xid
        xid += 1
        steps.append(dict(kind=kind, xid=xid, advance_ms=advance, **kw))
        return len(steps) - 1

    adv = iter(np.resize(np.asarray(advances_ms, np.int64), 64 * rounds))

    def small() -> int:
        # control steps move the clock a little: a lease granted in one
        # round is still live at the next round's renewals or returns
        return int(rng.integers(0, 4))

    for r in range(rounds):
        pulled = []
        for n in pull_sizes:
            ids = np.asarray(flow_ids, np.int64)[zipf(rng, n)]
            counts = (np.ones(n, np.int32) if r % 2 == 0
                      else rng.integers(1, 3, n).astype(np.int32))
            prios = (rng.random(n) < 0.1).astype(np.uint8)
            for k, sl in enumerate(chunks(n, max_frame)):
                add("batch", int(next(adv)) if k == 0 else 0,
                    ids=ids[sl], counts=counts[sl], prios=prios[sl])
            pulled.append(ids)
        for _ in range(3):
            fid = int(np.asarray(flow_ids)[zipf(rng, 1)[0]])
            add("flow", small(), flow_id=fid,
                count=int(rng.integers(1, 3)), prio=bool(rng.random() < 0.2))
        for _ in range(3):
            add("param", small(),
                flow_id=int(param_flows[int(rng.integers(len(param_flows)))]),
                count=int(rng.integers(1, 3)),
                hashes=tuple(int(h) for h in rng.integers(
                    0, 40, int(rng.integers(1, 5))) * 7919 + 11))
        # a completion report of pulled rows, ~1% invalid; every 20th flow
        # is sick (75% of its calls slow, 60% failing), so breakers trip
        pool = np.concatenate(pulled)
        ids = rng.permutation(pool)[:report_rows]
        k = ids.size
        sick = ids % 20 == 0
        rts = np.where(sick, rng.integers(50, 250, k),
                       rng.integers(1, 100, k)).astype(np.int32)
        excs = rng.random(k) < np.where(sick, 0.6, 0.05)
        bad = rng.choice(k, size=max(1, int(k * OUTCOME_INVALID_SHARE)),
                         replace=False)
        for j, row in enumerate(bad):
            if j % 3 == 0:
                rts[row] = -int(rng.integers(1, 1000))
            elif j % 3 == 1:
                rts[row] = 60_000 + int(rng.integers(1, 10**6))
            else:
                ids[row] = UNKNOWN_FLOW + int(rng.integers(0, 1000))
        add("outcome", int(next(adv)), ids=ids, rts=rts, excs=excs)
        # leases: renew or return the open ones, grant more
        for g in list(grants):
            if rng.random() < 0.5:
                add("lease_renew", small(), ref=g,
                    used=int(rng.integers(0, 4)),
                    want=int(rng.integers(1, 8)))
            else:
                add("lease_return", small(), ref=g,
                    used=int(rng.integers(0, 4)))
                grants.remove(g)
        for fid in lease_flows:
            if rng.random() < 0.7:
                grants.append(add("lease_grant", small(),
                                  flow_id=int(fid),
                                  want=int(rng.integers(1, 16))))
        # concurrency: release about half the held permits, acquire more
        for h in list(held):
            if rng.random() < 0.5:
                add(RELEASE, small(), ref=h)
                held.remove(h)
        for fid in conc_flows:
            held.append(add(ACQUIRE, small(), flow_id=int(fid),
                            count=1, prio=False))
    return steps


def _frame(P, step: dict, refs: Dict[int, int]) -> bytes:
    kind = step["kind"]
    xid = step["xid"]
    if kind == "batch":
        return P.encode_batch_request(xid, step["ids"], step["counts"],
                                      step["prios"])
    if kind == "flow":
        return P.encode_request(P.FlowRequest(
            xid, step["flow_id"], step["count"], step["prio"],
            P.MsgType.FLOW))
    if kind == "param":
        return P.encode_request(P.FlowRequest(
            xid, step["flow_id"], step["count"], False,
            P.MsgType.PARAM_FLOW, step["hashes"]))
    if kind == "outcome":
        return P.encode_outcome_report(xid, step["ids"], step["rts"],
                                       step["excs"])
    if kind == "lease_grant":
        return P.encode_lease_request(xid, P.MsgType.LEASE_GRANT,
                                      step["flow_id"], step["want"])
    if kind in ("lease_renew", "lease_return"):
        lease_id, flow_id = refs[step["ref"]]
        mt = (P.MsgType.LEASE_RENEW if kind == "lease_renew"
              else P.MsgType.LEASE_RETURN)
        return P.encode_lease_request(
            xid, mt, flow_id, step.get("want", 0), lease_id=lease_id,
            used=step["used"])
    if kind == ACQUIRE:
        return P.encode_request(P.FlowRequest(
            xid, step["flow_id"], step["count"], step["prio"],
            P.MsgType.CONCURRENT_ACQUIRE))
    if kind == RELEASE:
        return P.encode_request(P.FlowRequest(
            xid, refs[step["ref"]], 1, False, P.MsgType.CONCURRENT_RELEASE))
    raise ValueError(kind)


def _decoded(P, kind: str, payload: bytes) -> tuple:
    if kind == "batch":
        _xid, st, rem, wt = P.decode_batch_response(payload)
        return st, rem, wt
    if kind.startswith("lease"):
        r = P.decode_lease_response(payload)
        return r.status, r.lease_id, r.tokens, r.ttl_ms
    r = P.decode_response(payload)
    if kind == ACQUIRE:
        return r.status, r.remaining, r.wait_ms, r.token_id
    return r.status, r.remaining, r.wait_ms


def _twin_answer(twin, step: dict, refs: Dict[int, int]) -> tuple:
    kind = step["kind"]
    if kind == "batch":
        return twin.request_batch_arrays(
            step["ids"], step["counts"], step["prios"].astype(bool))
    if kind == "flow":
        st, rem, wt = twin.request_batch_arrays(
            np.array([step["flow_id"]], np.int64),
            np.array([step["count"]], np.int32),
            np.array([step["prio"]], bool))
        return int(st[0]), int(rem[0]), int(wt[0])
    if kind == "param":
        r = twin.request_params_token(step["flow_id"], step["count"],
                                      step["hashes"])
        return int(r.status), int(r.remaining), int(r.wait_ms)
    if kind == "lease_grant":
        r = twin.lease_grant(step["flow_id"], step["want"])
    elif kind == "lease_renew":
        lease_id, flow_id = refs[step["ref"]]
        r = twin.lease_renew(lease_id, flow_id, step["used"], step["want"])
    elif kind == "lease_return":
        r = twin.lease_return(refs[step["ref"]][0], step["used"])
    elif kind == ACQUIRE:
        r = twin.request_concurrent_token(step["flow_id"], step["count"],
                                          step["prio"])
        return int(r.status), int(r.remaining), int(r.wait_ms), \
            int(r.token_id)
    elif kind == RELEASE:
        r = twin.release_concurrent_token(refs[step["ref"]])
        return int(r.status), 0, 0
    else:
        raise ValueError(kind)
    return int(r.status), int(r.lease_id), int(r.tokens), int(r.ttl_ms)


def _equal(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def run_lockstep(P, conn: RawConn, steps: List[dict],
                 advance: Callable[[int], None], twin=None,
                 on_step: Optional[Callable[[int, dict], None]] = None):
    """Drive ``steps`` through ``conn`` one frame at a time. Returns
    ``(replies, counts)``: every reply payload in order (an outcome step's
    is its PING barrier's), and the device steps and PARAM_FLOW frames the
    door served. With ``twin``, every reply must equal the twin's answer to
    the same call at the same clock, and each outcome report is fed to the
    twin too."""
    refs: Dict[int, object] = {}
    replies: List[bytes] = []
    counts = {"device_steps": 0, "param_frames": 0, "rows": 0}
    for i, step in enumerate(steps):
        advance(int(step["advance_ms"]))
        kind = step["kind"]
        conn.send(_frame(P, step, refs))
        if kind == "outcome":
            # fire-and-forget; the PING behind it on the same connection is
            # answered only after the control lane has taken the report
            conn.send(P.encode_request(P.Ping(step["xid"], NAMESPACE)))
            replies.append(conn.recv())
            if twin is not None:
                twin.report_outcomes(step["ids"], step["rts"],
                                     step["excs"], step["xid"])
            continue
        payload = conn.recv()
        replies.append(payload)
        if P.peek_xid(payload) != step["xid"]:
            raise AssertionError(
                f"step {i} ({kind}): reply xid {P.peek_xid(payload)} for "
                f"request xid {step['xid']}")
        got = _decoded(P, kind, payload)
        if kind == "batch":
            counts["device_steps"] += 1
            counts["rows"] += len(step["ids"])
        elif kind == "flow":
            counts["device_steps"] += 1
            counts["rows"] += 1
        elif kind == "param":
            counts["param_frames"] += 1
        if twin is not None:
            want = _twin_answer(twin, step, refs)
            if not _equal(tuple(got), tuple(want)):
                raise AssertionError(
                    f"step {i} ({kind}, xid {step['xid']}): door replied "
                    f"{got}, the twin service {want}")
        if kind == "lease_grant":
            refs[i] = (int(got[1]), step["flow_id"])
        elif kind == "lease_renew" and int(got[1]):
            # a renewal answers with the lease's id from now on
            refs[step["ref"]] = (int(got[1]), refs[step["ref"]][1])
        elif kind == ACQUIRE:
            refs[i] = int(got[3])
        if on_step is not None:
            on_step(i, step)
    return replies, counts


def xid_probe(P, port: int, flow_ids: np.ndarray, frames: int = 24,
              rows: int = 1024, seed: int = 7) -> dict:
    """Pipelined xid exactness: ``frames`` BATCH_FLOW frames with distinct
    xids on one connection, sent before any reply is read; every xid must
    come back in exactly one reply carrying its row count."""
    rng = np.random.default_rng(seed)
    conn = RawConn(P, port)
    sent = {}
    try:
        conn.ping(1)
        for k in range(frames):
            xid = 0x5EED0000 + k
            ids = np.asarray(flow_ids, np.int64)[
                rng.integers(0, len(flow_ids), rows)]
            sent[xid] = rows
            conn.send(P.encode_batch_request(xid, ids))
        got: Dict[int, List[int]] = {}
        for _ in range(frames):
            xid, st, _rem, _wt = P.decode_batch_response(conn.recv())
            got.setdefault(xid, []).append(len(st))
    finally:
        conn.close()
    bad = sorted(x for x in set(sent) | set(got)
                 if got.get(x) != [sent.get(x)])
    return {"frames_sent": frames, "frames_answered": sum(
        len(v) for v in got.values()), "xid_mismatches": [hex(x) for x in bad],
        "exact": not bad}


def worker_init(*modules: str) -> None:
    """A closed-loop worker's initializer: import what unpickling its
    arguments needs before the clock starts."""
    for name in modules:
        importlib.import_module(name)


def _client(args) -> dict:
    """One closed-loop client (run in a worker process): pulls back to back
    on its own connection from ``start`` (wall clock) for ``seconds``."""
    proto, port, flow_ids, zipf, rows, start, seconds, max_frame, seed = args
    P = importlib.import_module(proto)
    rng = np.random.default_rng(seed)
    lat: List[float] = []
    counts: collections.Counter = collections.Counter()
    conn = RawConn(P, port)
    try:
        conn.ping(1)
        time.sleep(max(0.0, start - time.time()))
        begin = time.time()
        deadline = time.perf_counter() + max(0.0, start + seconds - begin)
        xid = (seed & 0x3FF) << 20  # distinct per client, inside int32
        while time.perf_counter() < deadline:
            ids = flow_ids[zipf(rng, rows)]
            parts = chunks(rows, max_frame)
            frames = []
            for sl in parts:
                xid += 1
                frames.append((xid, sl.stop - sl.start))
            t0 = time.perf_counter()
            conn.send(b"".join(
                P.encode_batch_request(x, ids[sl])
                for (x, _), sl in zip(frames, parts)))
            # two reply lanes may answer a pull's frames in either order
            want = dict(frames)
            for _ in frames:
                rx, st, _rem, _wt = P.decode_batch_response(conn.recv())
                if want.pop(rx, None) != len(st):
                    raise AssertionError(
                        f"reply xid {rx} with {len(st)} rows does not "
                        f"answer a frame of this pull")
                vals, cnt = np.unique(st, return_counts=True)
                counts.update(dict(zip(vals.tolist(), cnt.tolist())))
            lat.append(time.perf_counter() - t0)
        error = None
    except Exception as exc:  # reported, and fails the caller's check
        error = repr(exc)
        begin = time.time()
    finally:
        conn.close()
    return {"lat": lat, "counts": dict(counts), "begin": begin,
            "end": time.time(), "error": error}


def closed_loop(P, port: int, flow_ids: np.ndarray,
                zipf: Callable[[np.random.Generator, int], np.ndarray],
                rows: int, seconds: float, clients: int, max_frame: int,
                pool, seed: int = 11) -> dict:
    """``clients`` clients, each in a worker process of ``pool`` (a
    ``spawn`` pool, so that the clients' Python shares no interpreter lock
    with the server's lanes) on its own connection, send ``rows``-row
    bounded-Zipf pulls back to back for ``seconds`` (a pull larger than a
    frame goes out as its chunk frames, pipelined, as a client library
    sends it). Returns the verdicts/s answered and served (decided on the
    device: all but the door's own OVERLOAD answers), the client RTT p50 /
    p99 of a pull in ms, the verdicts by status and the errors: a reply
    missing, a wrong xid or row count, a FAIL verdict or a client
    exception."""
    start = time.time() + 1.0  # every worker connected and waiting
    results = pool.map(_client, [
        (P.__name__, port, np.asarray(flow_ids, np.int64), zipf, rows, start,
         seconds, max_frame, seed + k) for k in range(clients)])
    fail, overload = 5, 8  # TokenStatus.FAIL, TokenStatus.OVERLOAD
    status_counts: collections.Counter = collections.Counter()
    for r in results:
        status_counts.update(r["counts"])
    errors = [f"client {k}: {r['error']}" for k, r in enumerate(results)
              if r["error"]]
    if status_counts.get(fail):
        errors.append(f"{status_counts[fail]} FAIL verdicts")
    wall = (max(r["end"] for r in results)
            - min(r["begin"] for r in results))
    a = np.concatenate([np.asarray(r["lat"], np.float64)
                        for r in results]) * 1e3
    answered = sum(status_counts.values())
    return {
        "rows": rows, "clients": clients, "pulls": int(a.size),
        "verdicts_per_s": answered / wall,
        "served_verdicts_per_s": (answered - status_counts[overload]) / wall,
        "rtt_p50_ms": float(np.percentile(a, 50)) if a.size else None,
        "rtt_p99_ms": float(np.percentile(a, 99)) if a.size else None,
        "statuses": {int(k): int(v) for k, v in sorted(status_counts.items())},
        "errors": errors,
    }


def param_rtt(P, port: int, param_flows: Sequence[int], requests: int,
              seed: int = 13) -> dict:
    """Client RTT of ``requests`` PARAM_FLOW frames (1-4 values each) sent
    one at a time on one connection: p50 / p99 in ms."""
    rng = np.random.default_rng(seed)
    conn = RawConn(P, port)
    lat = []
    try:
        conn.ping(1)
        for k in range(requests):
            fid = int(param_flows[int(rng.integers(len(param_flows)))])
            hashes = tuple(int(h) for h in rng.integers(
                0, 10**9, int(rng.integers(1, 5))))
            frame = P.encode_request(P.FlowRequest(
                100 + k, fid, 1, False, P.MsgType.PARAM_FLOW, hashes))
            t0 = time.perf_counter()
            conn.send(frame)
            rsp = P.decode_response(conn.recv())
            lat.append(time.perf_counter() - t0)
            if rsp.xid != 100 + k:
                raise AssertionError(f"param reply xid {rsp.xid}")
    finally:
        conn.close()
    a = np.array(lat) * 1e3
    return {"requests": requests, "rtt_p50_ms": float(np.percentile(a, 50)),
            "rtt_p99_ms": float(np.percentile(a, 99))}


class FrameDropProxy:
    """Listens on ``port`` (127.0.0.1, a free port) and forwards every
    connection to ``target_port``; in the client-to-server direction a
    length-prefixed frame whose type is ``drop_type`` is dropped when
    ``should()`` says so (a chaos point's ``should``), or, without
    ``should``, the first such frame of the proxy's life. ``dropped``
    counts the drops. ``close()`` stops the listener and every forwarded
    connection."""

    def __init__(self, P, target_port: int, drop_type: int,
                 host: str = "127.0.0.1",
                 should: Optional[Callable[[], bool]] = None):
        self.P = P
        self.should = should
        self.target = (host, int(target_port))
        self.drop_type = int(drop_type)
        self.dropped = 0
        self._lock = threading.Lock()
        self._socks: List[socket.socket] = []
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, 0))
        self._listen.listen(16)
        self.port = self._listen.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                client, _ = self._listen.accept()
                server = socket.create_connection(self.target)
            except OSError:
                return
            with self._lock:
                self._socks += [client, server]
            threading.Thread(target=self._pump, args=(client, server, True),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(server, client, False),
                             daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              filtered: bool) -> None:
        buf = b""
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                if not filtered:
                    dst.sendall(data)
                    continue
                buf += data
                while len(buf) >= 2:
                    (n,) = struct.unpack_from(">H", buf, 0)
                    if len(buf) < 2 + n:
                        break
                    frame, buf = buf[:2 + n], buf[2 + n:]
                    if self._drops(frame[2:]):
                        continue
                    dst.sendall(frame)
        except OSError:
            pass
        for sock in (src, dst):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _drops(self, payload: bytes) -> bool:
        if len(payload) < 5 or self.P.peek_type(payload) != self.drop_type:
            return False
        with self._lock:
            drop = (self.should() if self.should is not None
                    else not self.dropped)
            self.dropped += int(drop)
            return drop

    def close(self) -> None:
        self._listen.close()
        with self._lock:
            socks, self._socks = self._socks, []
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass
