"""The port's copy of ``sentinel_tpu/cluster/client.py``.

Sync token client with xid-correlated responses, timeout and reconnect.

Analog of ``DefaultClusterTokenClient.java:45`` over
``NettyTransportClient.java:61``: an atomic xid generator, a pending-promise
map (``TokenClientPromiseHolder.java:30-50``), a hard request timeout
defaulting to the reference's 20ms (``ClusterConstants.java:44``), and
lazy reconnect with bounded exponential backoff + jitter (the reference's
fixed ``RECONNECT_DELAY_MS``, ``NettyTransportClient.java:67``, retried in
lockstep from every caller — the reconnect storm this ladder avoids).

The client is sync because its caller is the (sync) flow-checker hot path; a
background thread owns the socket read side.
"""

from __future__ import annotations

import itertools
import math
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from sentinel_tpu_torch import chaos
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.trace import ring as _TR

RECONNECT_DELAY_S = 2.0  # legacy cap alias; see the backoff ladder below

# reconnect backoff: first retry comes fast (a restarted server should be
# picked up quickly), repeated failures back off exponentially with jitter
# so a dead server isn't hammered by every request of every client in sync
# (NettyTransportClient's fixed RECONNECT_DELAY_MS caused exactly that storm)
RECONNECT_BASE_S = 0.1
RECONNECT_MAX_S = 30.0
RECONNECT_JITTER = 0.2

# process-wide client receive accounting (all TokenClient readers): bytes
# received off token-server sockets and growable-buffer expansions — the
# exporter renders these as sentinel_client_recv_bytes_total /
# sentinel_client_recv_buf_grows_total. unknown_frames counts frames whose
# type byte this build doesn't speak (a newer server's rev): rev-7 readers
# SKIP those instead of dropping the connection, and the count is the
# rollout canary (sentinel_client_unknown_frames_total).
_recv_lock = threading.Lock()
_recv_bytes = 0
_recv_buf_grows = 0
_unknown_frames = 0


def _count_recv(n: int, grows: int = 0) -> None:
    global _recv_bytes, _recv_buf_grows
    with _recv_lock:
        _recv_bytes += n
        _recv_buf_grows += grows


def _count_unknown_frame(n: int = 1) -> None:
    global _unknown_frames
    with _recv_lock:
        _unknown_frames += n


def client_recv_bytes_total() -> int:
    with _recv_lock:
        return _recv_bytes


def client_recv_buf_grows_total() -> int:
    with _recv_lock:
        return _recv_buf_grows


def client_unknown_frames_total() -> int:
    with _recv_lock:
        return _unknown_frames


def reset_client_metrics_for_tests() -> None:
    global _recv_bytes, _recv_buf_grows, _unknown_frames
    with _recv_lock:
        _recv_bytes = 0
        _recv_buf_grows = 0
        _unknown_frames = 0


class _Pending:
    # ``conn``: the connection the request went out on (a socket, or the
    # shm client's ring); only that connection's teardown may wake the
    # waiter without a response
    __slots__ = ("event", "response", "conn")

    def __init__(self):
        self.event = threading.Event()
        self.response: Optional[P.FlowResponse] = None
        self.conn = None


# client-side lease safety margin: stop admitting from a lease at 90% of
# its TTL so a verdict granted locally is never newer than the server's
# idea of the lease's life (clock-rate skew over a 500ms TTL is noise,
# but the margin also absorbs the renew RPC's latency)
_LEASE_EXPIRY_SAFETY = 0.9
# renew-ahead point: refresh at ~45% of TTL (or half the tokens spent,
# whichever comes first) so the replacement slice lands before exhaustion
_LEASE_RENEW_AT = 0.45

# wire rev 6: locally-recorded completion outcomes awaiting coalescence
# onto the next outbound frame. Bounded so a client that never sends again
# (idle, or stuck behind a dead server) holds a fixed amount of memory —
# the deque evicts the OLDEST outcome, keeping the freshest window of
# observations, and evictions are counted (dropped_overflow).
_OUTCOME_BUF_CAP = 8192


class _FlowLease:
    """One cached wire-rev-5 lease: the client-local admission budget for
    a flow. ``used`` only grows under the client's lease lock; the renew
    path retires the object from the cache *first* and reports that final
    ``used``, so tokens are never spent from a slice after its unused part
    was credited back (conservation, client side)."""

    __slots__ = ("lease_id", "tokens", "used", "expiry", "renew_at",
                 "renewing")

    def __init__(self, lease_id: int, tokens: int, used: int,
                 now: float, ttl_ms: int):
        self.lease_id = int(lease_id)
        self.tokens = int(tokens)
        self.used = int(used)
        self.expiry = now + ttl_ms * _LEASE_EXPIRY_SAFETY / 1000.0
        self.renew_at = now + ttl_ms * _LEASE_RENEW_AT / 1000.0
        self.renewing = False


class TokenClient(TokenService):
    def __init__(self, host: str, port: int, timeout_ms: int = 20,
                 namespace: str = "default", lease: bool = False,
                 lease_want: int = 256, lease_backoff_s: float = 0.1,
                 wait_and_admit: bool = False):
        self.host = host
        self.port = port
        self.timeout_ms = timeout_ms
        # declared to the server in the PING handshake; the server scopes
        # its connection counts (AVG_LOCAL scaling) by this group
        self.namespace = namespace
        self._xid = itertools.count(1)
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._reader: Optional[threading.Thread] = None
        self._last_connect_attempt = 0.0
        # consecutive failed connect attempts since the last success; drives
        # the reconnect backoff and is surfaced for HA health introspection
        self._consecutive_failures = 0
        self._reconnect_delay_s = 0.0
        self._reconnect_base_s = SentinelConfig.get_float(
            "sentinel.tpu.client.reconnect.base.s", RECONNECT_BASE_S
        )
        self._reconnect_max_s = SentinelConfig.get_float(
            "sentinel.tpu.client.reconnect.max.s", RECONNECT_MAX_S
        )
        # wire rev 5 client-local admission: when enabled, hot flows admit
        # from a cached short-TTL lease instead of one RPC per decision.
        # The first miss grants synchronously (that RPC replaces the
        # decision RPC 1:1); renew-ahead refreshes in the background; any
        # refusal (NOT_LEASABLE, NO_RULE, MOVED, transport failure) backs
        # the flow off and the caller falls back to the per-request path —
        # leasing can only remove RPCs, never verdicts.
        self.lease_enabled = bool(lease)
        self.lease_want = max(1, int(lease_want))
        self._lease_backoff_s = float(lease_backoff_s)
        self._lease_lock = threading.Lock()
        self._leases: Dict[int, _FlowLease] = {}
        self._lease_backoff: Dict[int, float] = {}  # flow → retry-after mono
        self._lease_inflight: set = set()  # flows with a grant/renew RPC out
        self._lease_counts = {
            "granted": 0, "renewed": 0, "returned": 0, "refused": 0,
            "expired": 0, "local_admits": 0, "wire_rows": 0,
        }
        self._rpcs = 0  # wire round trips (request/lease/ping/batch chunks)
        # wire rev 6 outcome feedback: completions recorded locally and
        # coalesced into OUTCOME_REPORT frames prepended to the next
        # outbound request frame (zero extra round trips — the report is
        # fire-and-forget, the server never answers it)
        self._outcome_lock = threading.Lock()
        self._outcome_buf: deque = deque(maxlen=_OUTCOME_BUF_CAP)
        self._outcome_counts = {
            "recorded": 0,   # record_outcome calls accepted into the buffer
            "sent": 0,       # rows shipped inside OUTCOME_REPORT frames
            "frames": 0,     # OUTCOME_REPORT frames shipped
            "dropped_overflow": 0,  # oldest rows evicted by the buffer cap
        }
        # opt-in pacing cooperation: a SHOULD_WAIT verdict with a wait hint
        # means the server already reserved the token at now+wait (paced
        # admission / priority occupy) — sleeping out the hint and reporting
        # OK needs no second RPC. Off by default: most callers want the
        # hint, not the blocking.
        self.wait_and_admit = bool(wait_and_admit)
        # wire rev 7 push state (all under _lease_lock): a pushed breaker
        # OPEN parks the flow behind a local DEGRADED clock — admits answer
        # DEGRADED with the pushed retry-after until it expires, so a
        # leased fast path stops within one RTT of the server-side flip
        # instead of at lease TTL. _push_counts tracks applies by kind;
        # _rule_epoch fences RULE_EPOCH_INVALIDATE replays.
        self._breaker_until: Dict[int, float] = {}  # flow → mono deadline
        self._rule_epoch = 0
        self._push_counts = {
            "lease_revoke": 0, "breaker_flip": 0, "rule_epoch_invalidate": 0,
            "shard_map_push": 0, "brownout_advisory": 0, "malformed": 0,
        }
        # out-of-band push listeners: routing subscribes shard-map docs,
        # failover subscribes brownout advisories. Callbacks run on the
        # reader thread — keep them cheap and never let them raise.
        self.on_shard_map: Optional[callable] = None
        self.on_brownout: Optional[callable] = None

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    # -- connection management ---------------------------------------------
    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        with self._state_lock:
            if self._sock is not None:
                return True
            now = time.monotonic()
            if now - self._last_connect_attempt < self._reconnect_delay_s:
                return False
            self._last_connect_attempt = now
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0
                )
                # create_connection leaves its connect timeout on the socket;
                # the reader must block indefinitely or idle periods kill the
                # connection with socket.timeout (an OSError)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = sock
                self._consecutive_failures = 0
                self._reconnect_delay_s = 0.0
            except OSError as e:
                self._consecutive_failures += 1
                # bounded exponential backoff with jitter: without it, every
                # request-carrying thread retries the dead address in
                # lockstep (connect timeout × request rate = a reconnect
                # storm). Only the first few failures log — the storm used
                # to flood the record log too.
                k = min(self._consecutive_failures, 16)
                self._reconnect_delay_s = min(
                    self._reconnect_base_s * (2 ** (k - 1)),
                    self._reconnect_max_s,
                ) * (1.0 + RECONNECT_JITTER * random.random())
                if self._consecutive_failures <= 3:
                    record_log.warning(
                        "token server unreachable (%d consecutive): %s",
                        self._consecutive_failures, e,
                    )
                return False
            self._reader = threading.Thread(
                target=self._read_loop, args=(sock,), daemon=True,
                name="sentinel-token-client-reader",
            )
            self._reader.start()
            handshake = True
        if handshake:
            # outside _state_lock (ping → _send → _ensure_connected would
            # re-enter it); best-effort — a lost handshake only delays the
            # server's connected-count update to the next keepalive
            self.ping()
        return True

    def _drop_connection(self, sock: socket.socket) -> None:
        with self._state_lock:
            was_active = self._sock is sock
            if was_active:
                self._sock = None
        try:
            # shutdown BEFORE close: the reader thread is blocked in recv on
            # this socket, and CPython defers the real fd close until that
            # call returns — without the shutdown no FIN ever reaches the
            # server and the connection lingers until the idle sweep
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        # Fail waiters so they fall back immediately instead of timing out —
        # but only those whose request went out on THIS connection. A
        # request that reconnected while this teardown ran (between the
        # clear of ``_sock`` above and this loop) waits on the new
        # connection and must not be woken without its response (the
        # reference wakes every waiter here).
        if was_active:
            for pending in list(self._pending.values()):
                if pending.conn is sock:
                    pending.event.set()

    def close(self) -> None:
        try:
            self.flush_outcomes()  # best-effort: don't strand observations
        except Exception:
            pass
        self._return_leases()  # best-effort: unused tokens go back early
        sock = self._sock
        if sock is not None:
            self._drop_connection(sock)

    def _read_loop(self, sock: socket.socket) -> None:
        # growable receive buffer, parsed in place: recv_into lands bytes
        # directly in the bytearray (no per-chunk bytes object), frames are
        # split by offset arithmetic (no per-feed copy/compact), and only
        # payloads that still have a waiter get copied out for the handoff.
        # The buffer doubles when a partial frame fills it (one max frame is
        # 2+65535 bytes, just over the initial 64KiB) and never shrinks —
        # its high-water mark is the deepest response burst seen.
        buf = bytearray(65536)
        view = memoryview(buf)
        r = w = 0  # parse offset / write offset into buf
        head = P._HEAD.size
        try:
            while True:
                if w == len(buf):
                    if r > 0:
                        # reclaim the consumed prefix before growing
                        view[: w - r] = view[r:w]
                        w -= r
                        r = 0
                    else:
                        grown = bytearray(2 * len(buf))
                        grown[:w] = buf
                        buf = grown
                        view = memoryview(buf)
                        _count_recv(0, grows=1)
                n = sock.recv_into(view[w:])
                if n == 0:
                    break
                if chaos.ARMED:  # inbound bit-rot injection (frame_corrupt)
                    data = chaos.mangle(
                        "frame_corrupt", bytes(view[w : w + n])
                    )
                    view[w : w + n] = data
                _count_recv(n)
                w += n
                while w - r >= 2:
                    ln = (buf[r] << 8) | buf[r + 1]
                    # a 2-byte length cannot exceed MAX_FRAME, but a frame
                    # too short for even a header is garbage — drop the
                    # connection (same contract as protocol.FrameReader)
                    if ln < head:
                        raise ValueError("runt frame")
                    if w - r < 2 + ln:
                        break
                    payload = view[r + 2 : r + 2 + ln]
                    r += 2 + ln
                    mtype = P.peek_type(payload)
                    if mtype in P.PUSH_TYPES:
                        # rev-7 push: dispatched out-of-band, never resolves
                        # a pending xid. A malformed push is skipped and
                        # counted — it can't strand a waiter, so it never
                        # justifies killing the connection.
                        self._handle_push(bytes(payload))
                        continue
                    if mtype not in P.KNOWN_TYPES:
                        # a newer server's frame type: skip + count instead
                        # of dropping the connection (mixed-rev fleets)
                        _count_unknown_frame()
                        continue
                    if mtype in P.LEASE_TYPES or mtype in P.HIER_TYPES:
                        rsp = P.decode_lease_response(bytes(payload))
                        pending = self._pending.get(rsp.xid)
                        if pending is not None:
                            pending.response = rsp
                            pending.event.set()
                        continue
                    if mtype == P.MsgType.BATCH_FLOW:
                        # copy + store the raw payload; the waiting thread
                        # decodes (spreads the vectorized decode across
                        # callers). Frames whose waiter already gave up
                        # skip even this copy.
                        xid = int.from_bytes(
                            payload[:4], "big", signed=True
                        )
                        pending = self._pending.get(xid)
                        if pending is not None:
                            pending.response = bytes(payload)
                            pending.event.set()
                        continue
                    rsp = P.decode_response(bytes(payload))
                    pending = self._pending.get(rsp.xid)
                    if pending is not None:
                        pending.response = rsp
                        pending.event.set()
                if r == w:
                    r = w = 0  # fully drained: rewind without compaction
        except OSError:
            pass
        except (ValueError, struct.error):
            # corrupt/truncated server bytes (runt frame, short response):
            # drop the connection gracefully — in-flight requests resolve
            # via _drop_connection below, and the reader thread must never
            # die with a traceback on hostile input
            record_log.warning("malformed frame from server; dropping connection")
        finally:
            self._drop_connection(sock)

    # -- wire rev 7: push dispatch ------------------------------------------
    def _handle_push(self, payload: bytes) -> None:
        """Apply one server push out-of-band (reader thread). Malformed
        pushes are counted and skipped — a push gates no pending request,
        so it never justifies dropping the connection."""
        try:
            push = P.decode_push(payload)
        except (ValueError, struct.error):
            with self._lease_lock:
                self._push_counts["malformed"] += 1
            return
        now = time.monotonic()
        if push.msg_type == P.MsgType.LEASE_REVOKE:
            with self._lease_lock:
                self._push_counts["lease_revoke"] += 1
                lease = self._leases.get(push.flow_id)
                if lease is not None and (
                    push.lease_id == 0 or lease.lease_id == push.lease_id
                ):
                    # stop local admits NOW (the server already reclaimed
                    # the unused slice — charge-at-grant) and hold off the
                    # regrant one backoff so a reload settles first
                    del self._leases[push.flow_id]
                    self._lease_counts["revoked"] = (
                        self._lease_counts.get("revoked", 0) + 1
                    )
                    self._lease_backoff[push.flow_id] = (
                        now + self._lease_backoff_s
                    )
        elif push.msg_type == P.MsgType.BREAKER_FLIP:
            with self._lease_lock:
                self._push_counts["breaker_flip"] += 1
                if push.state == 1:  # OPEN (DEGRADE.md state code)
                    # an OPEN without a pushed clock still parks the flow a
                    # bounded moment; the server's wire-path DEGRADED
                    # answers carry the authoritative retry-after
                    retry_ms = push.retry_after_ms if push.retry_after_ms > 0 else 1000
                    self._breaker_until[push.flow_id] = now + retry_ms / 1000.0
                    lease = self._leases.pop(push.flow_id, None)
                    if lease is not None:
                        self._lease_counts["revoked"] = (
                            self._lease_counts.get("revoked", 0) + 1
                        )
                    backoff = now + retry_ms / 1000.0
                    if backoff > self._lease_backoff.get(push.flow_id, 0.0):
                        self._lease_backoff[push.flow_id] = backoff
                else:
                    # CLOSED or HALF_OPEN: lift the local clock so requests
                    # reach the server again (HALF_OPEN needs wire traffic
                    # for its probe election)
                    self._breaker_until.pop(push.flow_id, None)
        elif push.msg_type == P.MsgType.RULE_EPOCH_INVALIDATE:
            with self._lease_lock:
                self._push_counts["rule_epoch_invalidate"] += 1
                if push.epoch > self._rule_epoch:
                    # every cached lease predates the new rule state:
                    # drop them (and stale backoffs) and re-fetch fresh
                    self._rule_epoch = push.epoch
                    self._leases.clear()
                    self._lease_backoff.clear()
        elif push.msg_type == P.MsgType.SHARD_MAP_PUSH:
            with self._lease_lock:
                self._push_counts["shard_map_push"] += 1
            cb = self.on_shard_map
            if cb is not None:
                try:
                    cb(push.doc)
                except Exception:
                    pass  # a listener bug must not kill the reader
        elif push.msg_type == P.MsgType.BROWNOUT_ADVISORY:
            with self._lease_lock:
                self._push_counts["brownout_advisory"] += 1
            cb = self.on_brownout
            if cb is not None:
                try:
                    cb(push.level, push.retry_after_ms)
                except Exception:
                    pass
        if push.stamp_ms > 0:
            # server-emit → client-apply staleness, off the frame's wall
            # stamp (clock skew makes cross-host samples advisory; the
            # drill's gates run co-located where the stamp is exact)
            try:
                from sentinel_tpu_torch.metrics.server import server_metrics

                server_metrics().record_push_staleness(
                    time.time() * 1000.0 - push.stamp_ms
                )
            except Exception:
                pass

    def _breaker_refusal(self, flow_id: int) -> Optional[TokenResult]:
        """A pushed breaker-OPEN clock still running answers DEGRADED
        locally (remaining carries the retry-after left, the wire
        convention) — the leased fast path stops admitting within one RTT
        of the server-side flip instead of at lease TTL."""
        with self._lease_lock:
            deadline = self._breaker_until.get(flow_id)
            if deadline is None:
                return None
            left_ms = int((deadline - time.monotonic()) * 1000.0)
            if left_ms <= 0:
                del self._breaker_until[flow_id]
                return None
        return TokenResult(TokenStatus.DEGRADED, left_ms, left_ms)

    def push_stats(self) -> Dict[str, int]:
        """Client-side push-apply counters (drill + test surface)."""
        with self._lease_lock:
            out = dict(self._push_counts)
            out["breaker_clocks"] = len(self._breaker_until)
            out["rule_epoch"] = self._rule_epoch
            return out

    # -- TokenService -------------------------------------------------------
    def request_token(self, flow_id, acquire=1, prioritized=False) -> TokenResult:
        if self._breaker_until:
            refusal = self._breaker_refusal(int(flow_id))
            if refusal is not None:
                return refusal
        if self.lease_enabled:
            local = self._lease_admit(int(flow_id), int(acquire))
            if local is not None:
                return local
        with self._lease_lock:
            self._lease_counts["wire_rows"] += 1
        rsp = self._roundtrip(
            P.FlowRequest(next(self._xid), flow_id, acquire, prioritized)
        )
        if rsp is None:
            return TokenResult(TokenStatus.FAIL)
        return self._maybe_wait(TokenResult(
            TokenStatus(rsp.status), rsp.remaining, rsp.wait_ms,
            endpoint=rsp.endpoint,
        ))

    def _maybe_wait(self, res: TokenResult) -> TokenResult:
        """``wait_and_admit`` resolution of a SHOULD_WAIT verdict: the
        server's charge already covers this request at ``now + wait_ms``,
        so sleeping out the hint IS the admission."""
        if (
            self.wait_and_admit
            and res.status == TokenStatus.SHOULD_WAIT
            and res.wait_ms > 0
        ):
            time.sleep(res.wait_ms / 1000.0)
            return TokenResult(
                TokenStatus.OK, res.remaining, res.wait_ms,
                endpoint=res.endpoint,
            )
        return res

    # -- wire rev 5: client-local admission ---------------------------------
    def _lease_admit(self, flow_id: int, acquire: int) -> Optional[TokenResult]:
        """Admit ``acquire`` tokens from the flow's cached lease, or try to
        obtain one (the grant/renew RPC replaces this decision's RPC 1:1).
        ``None`` means no usable lease — the caller takes the per-request
        wire path, so leasing never loses a verdict."""
        if acquire <= 0:
            return None
        now = time.monotonic()
        stale = None
        with self._lease_lock:
            lease = self._leases.get(flow_id)
            if lease is not None:
                if now >= lease.expiry:
                    del self._leases[flow_id]
                    self._lease_counts["expired"] += 1
                elif lease.used + acquire <= lease.tokens:
                    lease.used += acquire
                    self._lease_counts["local_admits"] += 1
                    kick = (
                        not lease.renewing
                        and (now >= lease.renew_at
                             or 2 * lease.used >= lease.tokens)
                    )
                    if kick:
                        lease.renewing = True
                    remaining = lease.tokens - lease.used
                    if kick:
                        self._spawn_renew(flow_id)
                    if _TR.ARMED:  # flight recorder: admitted wire-free
                        _TR.record(
                            _TR.LEASE_LOCAL, xid=flow_id, aux=acquire
                        )
                    return TokenResult(TokenStatus.OK, remaining)
                elif not lease.renewing:
                    # exhausted before the renew-ahead fired: retire it and
                    # renew inline below (credit + regrant, one RPC)
                    del self._leases[flow_id]
                    stale = lease
            if stale is None:
                if now < self._lease_backoff.get(flow_id, 0.0):
                    return None
                if flow_id in self._lease_inflight:
                    return None  # another thread is granting; go to wire
            self._lease_inflight.add(flow_id)
        try:
            if stale is not None:
                rsp = self._lease_roundtrip(
                    P.MsgType.LEASE_RENEW, flow_id,
                    want=max(acquire, self.lease_want),
                    lease_id=stale.lease_id, used=stale.used,
                )
                return self._install_lease(flow_id, rsp, acquire, "renewed")
            rsp = self._lease_roundtrip(
                P.MsgType.LEASE_GRANT, flow_id,
                want=max(acquire, self.lease_want),
            )
            return self._install_lease(flow_id, rsp, acquire, "granted")
        finally:
            with self._lease_lock:
                self._lease_inflight.discard(flow_id)

    def _install_lease(
        self, flow_id: int, rsp, acquire: int, stat: str
    ) -> Optional[TokenResult]:
        """Install a grant/renew response into the cache and admit
        ``acquire`` from it; ``None`` (fall back to wire) on refusal,
        transport failure, or a slice too small for this acquire."""
        now = time.monotonic()
        with self._lease_lock:
            if rsp is None or rsp.status != 0 or rsp.tokens <= 0:
                if rsp is not None:
                    self._lease_counts["refused"] += 1
                self._lease_backoff[flow_id] = now + self._lease_backoff_s
                return None
            self._lease_backoff.pop(flow_id, None)
            self._lease_counts[stat] += 1
            if acquire <= 0:
                # background renew: install the fresh slice, nothing to admit
                self._leases[flow_id] = _FlowLease(
                    rsp.lease_id, rsp.tokens, 0, now, rsp.ttl_ms
                )
                return None
            if rsp.tokens < acquire:
                # slice smaller than this acquire: keep it for smaller
                # acquires, decide this one over the wire
                self._leases[flow_id] = _FlowLease(
                    rsp.lease_id, rsp.tokens, 0, now, rsp.ttl_ms
                )
                return None
            self._leases[flow_id] = _FlowLease(
                rsp.lease_id, rsp.tokens, acquire, now, rsp.ttl_ms
            )
            self._lease_counts["local_admits"] += 1
            return TokenResult(TokenStatus.OK, rsp.tokens - acquire)

    def _spawn_renew(self, flow_id: int) -> None:
        threading.Thread(
            target=self._renew_flow, args=(flow_id,), daemon=True,
            name="sentinel-lease-renew",
        ).start()

    def _renew_flow(self, flow_id: int) -> None:
        """Background renew-ahead: retire the cached lease FIRST (so no
        token is spent from it after its unused part is reported), then
        credit + regrant in one RPC. While the RPC is in flight, admits
        for the flow fall back to the wire — a bounded, tiny window."""
        with self._lease_lock:
            lease = self._leases.pop(flow_id, None)
            if lease is None:
                return
            self._lease_inflight.add(flow_id)
        try:
            rsp = self._lease_roundtrip(
                P.MsgType.LEASE_RENEW, flow_id, want=self.lease_want,
                lease_id=lease.lease_id, used=lease.used,
            )
            self._install_lease(flow_id, rsp, 0, "renewed")
        finally:
            with self._lease_lock:
                self._lease_inflight.discard(flow_id)

    def _lease_roundtrip(
        self, msg_type, flow_id: int, want: int = 0,
        lease_id: int = 0, used: int = 0,
    ):
        """Correlated lease RPC; returns ``P.LeaseResponse`` or None."""
        xid = next(self._xid)
        pending = _Pending()
        self._pending[xid] = pending
        try:
            frame = P.encode_lease_request(
                xid, msg_type, flow_id, want, lease_id=lease_id, used=used
            )
            if not self._send(frame, pending=pending):
                return None
            self._count_rpc()
            if not pending.event.wait(self.timeout_ms / 1000.0):
                return None
            rsp = pending.response
            return rsp if isinstance(rsp, P.LeaseResponse) else None
        finally:
            self._pending.pop(xid, None)

    def _return_leases(self) -> None:
        """Best-effort LEASE_RETURN of every cached lease (close path):
        unused tokens go back instead of expiring with the window."""
        if not self.lease_enabled:
            return
        with self._lease_lock:
            leases = list(self._leases.items())
            self._leases.clear()
        for flow_id, lease in leases:
            rsp = self._lease_roundtrip(
                P.MsgType.LEASE_RETURN, flow_id,
                lease_id=lease.lease_id, used=lease.used,
            )
            if rsp is not None and rsp.status == 0:
                with self._lease_lock:
                    self._lease_counts["returned"] += 1

    def _count_rpc(self) -> None:
        with self._lease_lock:
            self._rpcs += 1

    def lease_stats(self) -> Dict[str, int]:
        """Client-side lease counters for the bench artifact: cumulative
        grant/renew/return/refusal counts, rows admitted locally vs sent
        over the wire, cached leases, and total wire round trips (the
        numerator of rpcs_per_decision)."""
        with self._lease_lock:
            out = dict(self._lease_counts)
            out["cached"] = len(self._leases)
            out["rpcs"] = self._rpcs
            return out

    # -- wire rev 6: completion outcome reporting ----------------------------
    def record_outcome(
        self, flow_id: int, rt_ms, exception: bool = False
    ) -> None:
        """Record one entry completion (response time in ms, exception
        flag) locally. Nothing goes on the wire here — buffered outcomes
        coalesce into one OUTCOME_REPORT frame prepended to the NEXT
        outbound request frame (or shipped by :meth:`flush_outcomes`), so
        the serve path never pays an extra round trip for telemetry."""
        try:
            r = float(rt_ms)
        except (TypeError, ValueError):
            r = float("nan")
        # NaN/inf can't ride an int32 wire row: park at -1 so the server's
        # wire-boundary validation drops + counts it rather than silently
        # wrapping; finite values clamp into int32 (the server enforces
        # the real OUTCOME_MAX_RT_MS ceiling and counts the overage)
        rt = int(min(r, float(2**31 - 1))) if math.isfinite(r) else -1
        with self._outcome_lock:
            if len(self._outcome_buf) == self._outcome_buf.maxlen:
                self._outcome_counts["dropped_overflow"] += 1
            self._outcome_buf.append(
                (int(flow_id), rt, bool(exception))
            )
            self._outcome_counts["recorded"] += 1

    def _drain_outcome_frames(self) -> List[bytes]:
        """Pull every buffered outcome and encode the coalesced
        OUTCOME_REPORT frame(s) — normally one; more only when a burst
        outgrew MAX_OUTCOME_PER_FRAME. Counters update on drain (the
        frames WILL be sent by the caller or the rows are lost with the
        connection, same contract as any fire-and-forget write)."""
        with self._outcome_lock:
            if not self._outcome_buf:
                return []
            rows = list(self._outcome_buf)
            self._outcome_buf.clear()
            self._outcome_counts["sent"] += len(rows)
        frames: List[bytes] = []
        step = P.MAX_OUTCOME_PER_FRAME
        for lo in range(0, len(rows), step):
            chunk = rows[lo:lo + step]
            frames.append(P.encode_outcome_report(
                next(self._xid),
                [c[0] for c in chunk],
                [c[1] for c in chunk],
                [c[2] for c in chunk],
            ))
        with self._outcome_lock:
            self._outcome_counts["frames"] += len(frames)
        return frames

    def _send_outcome_frames(self, frames: List[bytes]) -> bool:
        """Ship already-encoded outcome frames standalone. TCP coalesces
        them into one write; the shm subclass overrides (one ring slot
        carries exactly one frame)."""
        if not frames:
            return True
        return self._send(b"".join(frames), piggyback=False)

    def flush_outcomes(self) -> bool:
        """Force buffered outcomes onto the wire without waiting for the
        next request (idle clients, shutdown). True when nothing was
        pending or the write succeeded."""
        return self._send_outcome_frames(self._drain_outcome_frames())

    def outcome_stats(self) -> Dict[str, int]:
        """Client-side outcome counters: the reconciliation gate checks
        ``sent`` against the server's accepted totals."""
        with self._outcome_lock:
            out = dict(self._outcome_counts)
            out["buffered"] = len(self._outcome_buf)
            return out

    # -- hierarchy tier (pod share agent ↔ global budget coordinator) --------
    def share_op(
        self, msg_type, flow_id: int, want: int = 0,
        share_id: int = 0, used: int = 0,
    ):
        """SHARE_GRANT / SHARE_RENEW / SHARE_RETURN round trip; returns
        ``P.LeaseResponse`` or None. Shares ride the lease frame layout
        (``lease_id`` is the share id), so this is the lease roundtrip
        with a hierarchy type byte."""
        if msg_type not in P.SHARE_TYPES:
            raise ValueError(f"not a share type: {msg_type}")
        return self._lease_roundtrip(
            msg_type, flow_id, want, lease_id=share_id, used=used
        )

    def demand_report(self, pod_id: str, entries):
        """Ship one DEMAND_REPORT (``entries`` = ``[(flow_id, share_id,
        rate_milli), ...]``) and wait for the coordinator's ack; returns
        ``P.LeaseResponse`` (``tokens`` = entries accepted) or None."""
        xid = next(self._xid)
        pending = _Pending()
        self._pending[xid] = pending
        try:
            frame = P.encode_demand_report(xid, pod_id, entries)
            if not self._send(frame, pending=pending):
                return None
            self._count_rpc()
            if not pending.event.wait(self.timeout_ms / 1000.0):
                return None
            rsp = pending.response
            return rsp if isinstance(rsp, P.LeaseResponse) else None
        finally:
            self._pending.pop(xid, None)

    def request_params_token(self, flow_id, acquire, param_hashes) -> TokenResult:
        rsp = self._roundtrip(
            P.FlowRequest(
                next(self._xid), flow_id, acquire, False,
                P.MsgType.PARAM_FLOW, tuple(param_hashes),
            )
        )
        if rsp is None:
            return TokenResult(TokenStatus.FAIL)
        return TokenResult(
            TokenStatus(rsp.status), rsp.remaining, rsp.wait_ms,
            endpoint=rsp.endpoint,
        )

    def request_concurrent_token(self, flow_id, acquire=1, prioritized=False):
        rsp = self._roundtrip(
            P.FlowRequest(
                next(self._xid), flow_id, acquire, prioritized,
                P.MsgType.CONCURRENT_ACQUIRE,
            )
        )
        if rsp is None:
            return TokenResult(TokenStatus.FAIL)
        return TokenResult(
            TokenStatus(rsp.status), rsp.remaining, rsp.wait_ms, rsp.token_id
        )

    def release_concurrent_token(self, token_id):
        # the flow_id slot carries the token id on the wire (protocol docstring)
        rsp = self._roundtrip(
            P.FlowRequest(
                next(self._xid), token_id, 0, False, P.MsgType.CONCURRENT_RELEASE
            )
        )
        if rsp is None:
            return TokenResult(TokenStatus.FAIL)
        return TokenResult(TokenStatus(rsp.status))

    def request_batch_arrays(self, flow_ids, counts=None, prios=None,
                             timeout_ms: Optional[int] = None):
        """Array-in/array-out batched verdicts: (status int8[N], remaining
        int32[N], wait_ms int32[N]) in request order, or None on send
        failure/timeout.

        With leasing enabled, rows of a flow whose cached lease covers the
        flow's ENTIRE in-batch demand are admitted locally (zero wire
        bytes); only the rest ride BATCH_FLOW frames. Lease consumption is
        rolled back if the wire leg fails, so the None contract still means
        "nothing was admitted"."""
        import numpy as np

        if not self.lease_enabled:
            return self._wire_batch_arrays(flow_ids, counts, prios,
                                           timeout_ms)
        flow_ids = np.asarray(flow_ids, dtype=np.int64)
        n = flow_ids.shape[0]
        if n == 0:
            e = np.empty(0, np.int32)
            return np.empty(0, np.int8), e, e
        acq = (np.ones(n, np.int64) if counts is None
               else np.asarray(counts, np.int64))
        local = np.zeros(n, bool)
        remaining = np.zeros(n, np.int32)
        now = time.monotonic()
        taken = []  # (flow_id, amount, lease) for rollback
        kicks = []
        with self._lease_lock:
            for fid in np.unique(flow_ids):
                f = int(fid)
                lease = self._leases.get(f)
                if lease is None:
                    continue
                if now >= lease.expiry:
                    del self._leases[f]
                    self._lease_counts["expired"] += 1
                    continue
                rows = flow_ids == fid
                demand = int(acq[rows].sum())
                # all-or-nothing per flow: a partial cover would need
                # per-row splits; those rows just ride the wire this time
                if demand <= 0 or lease.used + demand > lease.tokens:
                    continue
                lease.used += demand
                taken.append((f, demand, lease))
                local[rows] = True
                remaining[rows] = lease.tokens - lease.used
                if not lease.renewing and (
                    now >= lease.renew_at or 2 * lease.used >= lease.tokens
                ):
                    lease.renewing = True
                    kicks.append(f)
            n_local = int(local.sum())
            self._lease_counts["local_admits"] += n_local
        for f in kicks:
            self._spawn_renew(f)
        if n_local == n:
            return (np.zeros(n, np.int8), remaining, np.zeros(n, np.int32))
        widx = np.nonzero(~local)[0]
        out = self._wire_batch_arrays(
            flow_ids[widx],
            None if counts is None else np.asarray(counts)[widx],
            None if prios is None else np.asarray(prios)[widx],
            timeout_ms,
        )
        if out is None:
            if taken:
                # un-admit the local rows: the caller retries the whole
                # batch elsewhere, so nothing may stay spent here
                with self._lease_lock:
                    for f, amount, lease in taken:
                        if self._leases.get(f) is lease:
                            lease.used -= amount
                    self._lease_counts["local_admits"] -= n_local
            return None
        if n_local == 0:
            return out
        status = np.zeros(n, np.int8)
        wait = np.zeros(n, np.int32)
        status[widx], remaining[widx], wait[widx] = out
        return status, remaining, wait

    def _wire_batch_arrays(self, flow_ids, counts=None, prios=None,
                           timeout_ms: Optional[int] = None):
        """The BATCH_FLOW wire path. Batches larger than one frame are
        **pipelined**: every chunk frame is sent before the first response
        is awaited, so the server's micro-batcher sees them back-to-back
        and a chunked batch costs one round trip, not one per chunk.
        """
        import numpy as np

        flow_ids = np.asarray(flow_ids, dtype=np.int64)
        n = flow_ids.shape[0]
        if n == 0:
            e = np.empty(0, np.int32)
            return np.empty(0, np.int8), e, e
        budget = (timeout_ms or self.timeout_ms) / 1000.0
        chunk = P.MAX_BATCH_PER_FRAME
        spans = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
        pendings = []
        try:
            for lo, hi in spans:
                xid = next(self._xid)
                pending = _Pending()
                self._pending[xid] = pending
                pendings.append((xid, pending, lo, hi))
                frame = P.encode_batch_request(
                    xid, flow_ids[lo:hi],
                    None if counts is None else counts[lo:hi],
                    None if prios is None else prios[lo:hi],
                    # declare the whole budget as the frame's deadline: a
                    # deadline-aware server sheds the frame instead of
                    # serving a verdict this client stopped waiting for
                    deadline_ms=max(1, int(budget * 1000)),
                )
                if not self._send(frame, pending=pending):
                    return None
                self._count_rpc()
            with self._lease_lock:
                self._lease_counts["wire_rows"] += n
            status = np.empty(n, np.int8)
            remaining = np.empty(n, np.int32)
            wait = np.empty(n, np.int32)
            deadline = time.monotonic() + budget
            for xid, pending, lo, hi in pendings:
                if not pending.event.wait(max(deadline - time.monotonic(), 0)):
                    return None
                payload = pending.response
                if not isinstance(payload, (bytes, bytearray)):
                    return None  # connection died mid-batch
                try:
                    _, st, rem, wt = P.decode_batch_response(payload)
                except Exception:
                    # truncated/malformed server frame degrades to the
                    # documented None contract, never an exception out of
                    # the caller (the local-fallback path handles None)
                    return None
                if st.shape[0] != hi - lo:
                    return None
                status[lo:hi] = st
                remaining[lo:hi] = rem
                wait[lo:hi] = wt
            return status, remaining, wait
        finally:
            for xid, _, _, _ in pendings:
                self._pending.pop(xid, None)

    def request_batch(self, requests) -> list:
        """List-of-(flow_id, acquire, prioritized) → List[TokenResult]
        (TokenService.request_batch over the wire)."""
        import numpy as np

        if not requests:
            return []
        n = len(requests)
        out = self.request_batch_arrays(
            np.fromiter((f for f, _, _ in requests), np.int64, n),
            np.fromiter((a for _, a, _ in requests), np.int32, n),
            np.fromiter((p for _, _, p in requests), bool, n),
        )
        if out is None:
            return [TokenResult(TokenStatus.FAIL)] * n
        status, remaining, wait = out
        return [
            TokenResult(TokenStatus(int(status[i])), int(remaining[i]),
                        int(wait[i]))
            for i in range(n)
        ]

    def ping(self, namespace: Optional[str] = None) -> bool:
        """Handshake/keepalive; declares a namespace this client serves
        (``TokenServerHandler.handlePingRequest``). One connection may
        declare several namespaces — each ping adds one group membership."""
        return self.ping_ex(namespace) is True

    def ping_ex(self, namespace: Optional[str] = None) -> Optional[bool]:
        """Ping that separates transport failure from the server's answer:
        ``None`` when no response arrived (dead host, timeout, send
        failure), else the server's verdict — status 0 means the namespace
        group accepted this connection. Failover health accounting charges
        an endpoint's breaker only for the ``None`` case."""
        rsp = self._roundtrip(
            P.Ping(next(self._xid), namespace or self.namespace)
        )
        if rsp is None:
            return None
        return rsp.status == 0

    def _roundtrip(self, req) -> Optional[P.FlowResponse]:
        """Correlated request/response: register pending, send, wait, pop."""
        pending = _Pending()
        self._pending[req.xid] = pending
        try:
            if not self._send(P.encode_request(req), pending=pending):
                return None
            self._count_rpc()
            if not pending.event.wait(self.timeout_ms / 1000.0):
                return None  # timeout → caller falls back (20ms budget blown)
            return pending.response
        finally:
            self._pending.pop(req.xid, None)

    def _send(self, data: bytes, piggyback: bool = True,
              pending: Optional[_Pending] = None) -> bool:
        if piggyback and self._outcome_buf:
            # rev-6 piggyback: buffered completion outcomes ride ahead of
            # this frame in the SAME sendall — one syscall, zero extra
            # round trips (the server never answers an OUTCOME_REPORT)
            frames = self._drain_outcome_frames()
            if frames:
                data = b"".join(frames) + data
        if not self._ensure_connected():
            return False
        sock = self._sock
        if sock is None:
            return False
        if pending is not None:
            pending.conn = sock
        if chaos.ARMED:
            if chaos.should("conn_reset"):  # RST mid-request
                self._drop_connection(sock)
                return False
            data = chaos.mangle("frame_corrupt", data)  # outbound bit rot
        try:
            with self._send_lock:
                sock.sendall(data)
            return True
        except OSError:
            self._drop_connection(sock)
            return False
