"""The load generator: one process, one thread, a fixed number of requests
in flight over a few connections to the token server's front door.

Every frame it sends was encoded during set-up from the seed (the traffic
mix's pool); the pool is sent in order, cycled, and each frame's xid is
rewritten in place just before it goes out: the ``k``-th frame sent has
xid ``k + 1``, so frame ``(k % pool)`` of cycle ``k // pool``. A BATCH_FLOW
pull is ``frames_per_pull`` frames sent together; a PARAM_FLOW request is
one frame. Whenever a request is answered in full the next one goes out,
so the number in flight stays fixed (a closed loop).

Run as ``python loadgen.py`` with the job as one JSON line on standard
input (see :func:`main`). It answers ``ready`` once its connections are
open, starts sending at the ``go`` line, stops sending at ``t_end``
(``time.monotonic()``, shared with the caller), waits up to ``drain_s``
for every reply still due, and writes its results as a length-prefixed
pickle to standard output.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import pickle
import selectors
import socket
import struct
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import wire, workload  # noqa: E402

OVERLOAD, FAIL, STANDBY = 8, 5, 9


class Conn:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.reader = wire.FrameReader()
        self.out = collections.deque()

    def handshake(self) -> None:
        self.sock.sendall(wire.encode_ping(1))
        while True:
            for payload in self.reader.feed(self.sock.recv(1 << 16)):
                if wire.head(payload)[1] == wire.PING:
                    self.sock.setblocking(False)
                    return


class Generator:
    """The closed loop over pre-encoded frames (see the module docstring)."""

    def __init__(self, job: dict):
        t = job["traffic"]
        self.kind = t["kind"]
        seed = int(job["seed"])
        if self.kind == "batch_flow":
            pool = workload.flow_pool(t, int(job["max_flows"]), seed)
            self.frames = workload.encode_flow_pool(pool)
            self.per_request = pool.frames_per_pull
            self.rows = pool.ids.shape[1]
        else:
            rules = workload.param_rules(job["rules"])
            self.frames = workload.encode_param_pool(
                workload.param_pool(t, rules, seed))
            self.per_request = 1
            self.rows = 1
        self.n_pool = len(self.frames)
        self.inflight = int(t["inflight"])
        # the frames whose reply rows are kept whole: xid % mod == rem
        self.sample = (int(job["sample_mod"]), int(job["sample_rem"]))
        self.conns = [Conn(int(job["port"]))
                      for _ in range(int(t["connections"]))]
        self.sel = selectors.DefaultSelector()
        self.seq = 0  # frames sent
        # first xid -> [t_sent, frames left, device verdicts, refused]
        self.requests = {}
        self.xid_request = {}  # xid -> first xid of its request
        # xid -> (reply digest, refused whole) for flow, status for param
        self.answered = {}
        self.rows_of = {}  # sampled xid -> reply rows (bytes)
        self.duplicates = 0
        self.bad = []
        self.done = []  # (t_done, rtt_s, device rows, refused rows)

    def open(self) -> None:
        for c in self.conns:
            c.handshake()
            self.sel.register(c.sock, selectors.EVENT_READ, c)

    def _send_request(self, c: Conn, now: float) -> None:
        first = self.seq + 1
        parts = []
        for _ in range(self.per_request):
            self.seq += 1
            frame = self.frames[(self.seq - 1) % self.n_pool]
            wire.set_xid(frame, self.seq)
            parts.append(bytes(frame))
            self.xid_request[self.seq] = first
        self.requests[first] = [now, self.per_request, 0, 0]
        c.out.append(memoryview(b"".join(parts)))
        self._flush(c)

    def _flush(self, c: Conn) -> None:
        while c.out:
            buf = c.out[0]
            try:
                k = c.sock.send(buf)
            except BlockingIOError:
                k = 0
            if k < len(buf):
                c.out[0] = buf[k:]
                self.sel.modify(c.sock, selectors.EVENT_READ
                                | selectors.EVENT_WRITE, c)
                return
            c.out.popleft()
        self.sel.modify(c.sock, selectors.EVENT_READ, c)

    def _on_reply(self, c: Conn, payload: bytes, now: float) -> None:
        xid, mtype = wire.head(payload)
        if mtype in wire.PUSH_TYPES:
            return
        first = self.xid_request.pop(xid, None)
        if first is None:
            if xid in self.answered:
                self.duplicates += 1
            else:
                self.bad.append(f"reply xid {xid} answers no frame sent")
            return
        req = self.requests[first]
        if self.kind == "batch_flow":
            if mtype != wire.BATCH_FLOW:
                self.bad.append(f"xid {xid}: reply type {mtype}")
                return
            rows = wire.batch_rows(payload)
            if rows.shape[0] != self.rows:
                self.bad.append(f"xid {xid}: {rows.shape[0]} rows answered, "
                                f"{self.rows} sent")
            raw = payload[wire.BATCH_ROWS_OFFSET:]
            st = rows["status"]
            refused = int(np.count_nonzero((st == OVERLOAD) | (st == FAIL)
                                           | (st == STANDBY)))
            # the reply's digest, and whether the server decided none of it
            self.answered[xid] = (
                hashlib.blake2b(raw, digest_size=8).digest(),
                refused == rows.shape[0])
            if xid % self.sample[0] == self.sample[1]:
                self.rows_of[xid] = bytes(raw)
            req[2] += rows.shape[0] - refused
            req[3] += refused
        else:
            if mtype != wire.PARAM_FLOW:
                self.bad.append(f"xid {xid}: reply type {mtype}")
                return
            status = wire.flow_response(payload)[0]
            self.answered[xid] = status
            refused = int(status in (OVERLOAD, FAIL, STANDBY))
            req[2] += 1 - refused
            req[3] += refused
        req[1] -= 1
        if req[1] == 0:
            del self.requests[first]
            self.done.append((now, now - req[0], req[2], req[3]))

    def run(self, t_end: float, drain_s: float) -> None:
        sending = True
        next_conn = 0
        drain_end = t_end + drain_s
        while True:
            now = time.monotonic()
            if sending and now >= t_end:
                sending = False
            if sending:
                while len(self.requests) < self.inflight:
                    c = self.conns[next_conn % len(self.conns)]
                    next_conn += 1
                    self._send_request(c, now)
            elif not self.requests or now >= drain_end:
                return
            for key, ev in self.sel.select(timeout=0.05):
                c = key.data
                if ev & selectors.EVENT_WRITE:
                    self._flush(c)
                if ev & selectors.EVENT_READ:
                    try:
                        data = c.sock.recv(1 << 20)
                    except BlockingIOError:
                        continue
                    if not data:
                        self.bad.append("the server closed a connection")
                        self.sel.unregister(c.sock)
                        continue
                    t = time.monotonic()
                    for payload in c.reader.feed(data):
                        self._on_reply(c, payload, t)

    def results(self) -> dict:
        missing = sorted(self.xid_request)
        return dict(
            sent_frames=self.seq,
            done=np.asarray(self.done, np.float64).reshape(-1, 4),
            answered=self.answered,
            rows_of=self.rows_of,
            missing=missing,
            duplicates=self.duplicates,
            bad=self.bad[:20],
            n_bad=len(self.bad),
            rows_per_frame=self.rows,
        )

    def close(self) -> None:
        for c in self.conns:
            try:
                self.sel.unregister(c.sock)
            except (KeyError, ValueError):
                pass
            c.sock.close()
        self.sel.close()


def main() -> int:
    job = json.loads(sys.stdin.readline())
    gen = Generator(job)
    gen.open()
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        gen.close()
        return 1
    t_end = float(line[1])
    try:
        gen.run(t_end, float(job.get("drain_s", 60.0)))
    finally:
        gen.close()
    blob = pickle.dumps(gen.results(), protocol=pickle.HIGHEST_PROTOCOL)
    out = sys.stdout.buffer
    out.write(struct.pack(">Q", len(blob)))
    out.write(blob)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
