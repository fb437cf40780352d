"""The port's copy of ``sentinel_tpu/cluster/shm_client.py``.

Token client over the shared-memory ring front door (co-located).

``ShmTokenClient`` is ``TokenClient`` with the socket swapped for one
mmap'd SPSC ring pair (``native/src/sentinel_shm.cpp``): same xid
correlation, pending-promise map, pipelined batch chunking, deadline
stamping, reconnect backoff ladder and chaos hooks — the request methods
are inherited verbatim and only the transport layer (connect / send /
read loop / teardown) is replaced. A co-located sidecar (Envoy RLS, a
per-host agent) gets token verdicts without the TCP loopback's
syscall+copy tax: the steady state is two memcpys and zero syscalls per
batch (the futex doorbell only rings when the peer advertised it went to
sleep).

Teardown is the one structural difference from TCP: the native client
handle is freed by ``sn_shm_client_destroy``, so the reader thread —
which blocks inside ``sn_shm_client_recv`` — must be the thread that
closes it. ``close()``/``_drop_ring`` only *detach* the ring; the reader
notices within one recv timeout, closes the segment, and exits.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from sentinel_tpu_torch import chaos
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.client import (
    RECONNECT_JITTER,
    TokenClient,
    _count_recv,
    _count_unknown_frame,
)
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.native.lib import ShmRingClient

# reader poll granularity: only teardown latency, never a batching stall
# (the C recv spins/parks on the ring and returns the moment a response
# publishes; this bounds how long a detached reader lingers)
_READER_POLL_MS = 100


class ShmTokenClient(TokenClient):
    """``TokenClient`` API over one shm ring segment in ``shm_dir``.

    ``shm_dir`` must be the directory a ``NativeTokenServer(shm_dir=...)``
    door is serving on this host. Connection failures (no live door, door
    restarted) follow the TCP client's lazy-reconnect contract: requests
    return FAIL/None immediately and the next attempt re-creates a fresh
    segment under the same exponential backoff ladder.
    """

    def __init__(self, shm_dir: str, timeout_ms: int = 20,
                 namespace: str = "default", slot_payload: int = 65536,
                 n_slots: int = 16, spin_us: Optional[int] = None,
                 lease: bool = False, lease_want: int = 256,
                 lease_backoff_s: float = 0.1, wait_and_admit: bool = False):
        super().__init__(f"shm:{shm_dir}", -1, timeout_ms, namespace,
                         lease=lease, lease_want=lease_want,
                         lease_backoff_s=lease_backoff_s,
                         wait_and_admit=wait_and_admit)
        self.shm_dir = shm_dir
        self.slot_payload = slot_payload
        self.n_slots = n_slots
        self.spin_us = spin_us
        self._ring: Optional[ShmRingClient] = None

    # -- transport layer (everything above this rides the superclass) -------
    def _ensure_connected(self) -> bool:
        if self._ring is not None:
            return True
        with self._state_lock:
            if self._ring is not None:
                return True
            now = time.monotonic()
            if now - self._last_connect_attempt < self._reconnect_delay_s:
                return False
            self._last_connect_attempt = now
            try:
                # raises RuntimeError (propagated: permanent, the native
                # lib lacks the shm door) vs ConnectionRefusedError/OSError
                # (transient: no live server — backoff and retry)
                ring = ShmRingClient(
                    self.shm_dir, slot_payload=self.slot_payload,
                    n_slots=self.n_slots, spin_us=self.spin_us,
                )
            except OSError as e:
                self._consecutive_failures += 1
                k = min(self._consecutive_failures, 16)
                self._reconnect_delay_s = min(
                    self._reconnect_base_s * (2 ** (k - 1)),
                    self._reconnect_max_s,
                ) * (1.0 + RECONNECT_JITTER * random.random())
                if self._consecutive_failures <= 3:
                    record_log.warning(
                        "shm token door unreachable (%d consecutive): %s",
                        self._consecutive_failures, e,
                    )
                return False
            self._ring = ring
            self._consecutive_failures = 0
            self._reconnect_delay_s = 0.0
            self._reader = threading.Thread(
                target=self._read_loop, args=(ring,), daemon=True,
                name="sentinel-shm-client-reader",
            )
            self._reader.start()
        # handshake outside _state_lock (ping → _send → _ensure_connected
        # would re-enter); best-effort, same as the TCP client
        self.ping()
        return True

    def _drop_ring(self, ring: ShmRingClient) -> None:
        """Detach (never destroy — the reader owns the native handle's
        final close) and fail this ring's waiters so they fall back
        immediately; a request that already reattached waits on the new
        ring (the TCP client's ``_drop_connection``)."""
        with self._state_lock:
            was_active = self._ring is ring
            if was_active:
                self._ring = None
        if was_active:
            for pending in list(self._pending.values()):
                if pending.conn is ring:
                    pending.event.set()

    def close(self) -> None:
        try:
            self.flush_outcomes()  # best-effort, same as TCP
        except Exception:
            pass
        self._return_leases()  # best-effort conservation, same as TCP
        ring = self._ring
        if ring is not None:
            self._drop_ring(ring)
        reader = self._reader
        if reader is not None and reader is not threading.current_thread():
            # deterministic segment teardown for callers that check: the
            # reader notices the detach within one poll and unlinks
            reader.join(timeout=1.0)

    def _read_loop(self, ring: ShmRingClient) -> None:
        try:
            while True:
                try:
                    payload = ring.recv_payload(timeout_ms=_READER_POLL_MS)
                except (ConnectionResetError, OSError):
                    break  # server dropped the segment or died
                if self._ring is not ring:
                    break  # detached by close()/reconnect
                if payload is None:
                    continue
                if chaos.ARMED:  # inbound bit-rot injection
                    payload = chaos.mangle("frame_corrupt", payload)
                _count_recv(len(payload))
                try:
                    mtype = P.peek_type(payload)
                    if mtype in P.PUSH_TYPES:
                        # rev-7 push off the ring's response lane: applied
                        # out-of-band, never resolves a pending xid, and a
                        # malformed push is counted + skipped inside the
                        # handler — the segment survives
                        self._handle_push(bytes(payload))
                        continue
                    if mtype not in P.KNOWN_TYPES:
                        # a newer server's frame type: skip + count instead
                        # of dropping the segment (mixed-rev fleets)
                        _count_unknown_frame()
                        continue
                    if mtype == P.MsgType.BATCH_FLOW:
                        xid = int.from_bytes(payload[:4], "big", signed=True)
                        pending = self._pending.get(xid)
                        if pending is not None:
                            pending.response = bytes(payload)
                            pending.event.set()
                        continue
                    if mtype in P.LEASE_TYPES:
                        rsp = P.decode_lease_response(bytes(payload))
                    else:
                        rsp = P.decode_response(bytes(payload))
                except Exception:
                    # corrupt server bytes degrade to a dropped connection,
                    # never a dead reader with a traceback (TCP contract)
                    record_log.warning(
                        "malformed shm frame from server; dropping segment"
                    )
                    break
                pending = self._pending.get(rsp.xid)
                if pending is not None:
                    pending.response = rsp
                    pending.event.set()
        finally:
            self._drop_ring(ring)
            # sole closer of the native handle; under _send_lock so a
            # request thread that raced the detach finishes its in-flight
            # send before the mapping is freed (send_frame then raises on
            # the cleared handle instead of touching freed memory)
            with self._send_lock:
                ring.close()

    def _send_outcome_frames(self, frames) -> bool:
        """Rev-6 outcome frames over shm: one ring slot carries exactly ONE
        frame (``send_frame`` strips the whole buffer's 2-byte length
        prefix), so the TCP client's coalesced single-write is replaced by
        one slot per frame — still fire-and-forget, still zero round
        trips."""
        ok = True
        for f in frames:
            ok = self._send(f, piggyback=False) and ok
        return ok

    def _send(self, data: bytes, piggyback: bool = True,
              pending=None) -> bool:
        if piggyback and self._outcome_buf:
            # publish buffered outcomes as their own slots ahead of this
            # request frame (no prefix-concatenation on a ring transport)
            self._send_outcome_frames(self._drain_outcome_frames())
        if not self._ensure_connected():
            return False
        ring = self._ring
        if ring is None:
            return False
        if pending is not None:
            pending.conn = ring
        if chaos.ARMED:
            if chaos.should("conn_reset"):  # segment death mid-request
                self._drop_ring(ring)
                return False
            data = chaos.mangle("frame_corrupt", data)  # outbound bit rot
        try:
            with self._send_lock:
                # ring full past the request budget = backpressure, not
                # death: fail this request (caller falls back) but keep
                # the segment — the server is draining, just slower than
                # we produce
                return ring.send_frame(data, timeout_ms=self.timeout_ms)
        except (ConnectionResetError, OSError):
            self._drop_ring(ring)
            return False
