"""Server-side push hub: the wire-rev-7 server→client control plane.

The port's copy of ``sentinel_tpu/cluster/push.py``.

One :class:`PushHub` per front door. Connections register a *sink* — a
non-blocking, thread-safe "hand these bytes to this connection's reply
lane" callable (the asyncio door schedules ``writer.write`` on its loop;
the native door enqueues through the C++ plane's per-connection send,
which also covers shm ring connections) — and the hub broadcasts encoded
push frames to every live sink.

Delivery contract (docs/CLUSTER_HA.md "Push plane"):

- **at-most-once, fire-and-forget**: a sink that raises (closed socket,
  full ring) silently drops the frame and is counted in ``dropped``;
  nothing retries, nothing blocks, and no verdict write ever waits on a
  push — the sink primitives are the same non-blocking enqueues the reply
  lanes already use.
- **re-derivable**: every pushed fact has a polling fallback (lease TTL,
  breaker refusal on the wire path, shard-map publish, OVERLOAD answer),
  so a dark channel only widens staleness back to the rev-6 bounds —
  docs/ROBUSTNESS.md carries the push-on vs push-dark table.
- **disarmable**: ``enabled=False`` (the servers' ``push=`` knob) makes
  every emit a no-op; the drills run their push-dark phases through it.

Emitters stamp each frame with the server's wall clock (``stamp_ms``) so
the client-side apply can record end-to-end staleness, and with a hub-
local xid sequence the staleness probes key on.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict

from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.metrics.server import server_metrics as _SM

# metric/type-label names for the five push frame types
PUSH_TYPE_NAMES: Dict[int, str] = {
    int(P.MsgType.LEASE_REVOKE): "lease_revoke",
    int(P.MsgType.BREAKER_FLIP): "breaker_flip",
    int(P.MsgType.RULE_EPOCH_INVALIDATE): "rule_epoch_invalidate",
    int(P.MsgType.SHARD_MAP_PUSH): "shard_map_push",
    int(P.MsgType.BROWNOUT_ADVISORY): "brownout_advisory",
}


class PushHub:
    """Registry of per-connection push sinks + the five emitters."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._sinks: Dict[object, Callable[[bytes], None]] = {}
        self._xid = itertools.count(1)
        self._sent: Dict[str, int] = {}
        self._dropped = 0

    # -- sink lifecycle -----------------------------------------------------
    def attach(self, key, send_fn: Callable[[bytes], None]) -> None:
        """Register ``key``'s sink (most recent wins — a reconnect under
        the same key replaces the dead sink)."""
        with self._lock:
            self._sinks[key] = send_fn

    def detach(self, key) -> None:
        with self._lock:
            self._sinks.pop(key, None)

    def connections(self) -> int:
        with self._lock:
            return len(self._sinks)

    # -- broadcast core -----------------------------------------------------
    def _broadcast(self, frame: bytes, type_name: str) -> int:
        """Hand ``frame`` to every live sink; returns deliveries that did
        not raise. Never blocks, never raises."""
        if not self.enabled:
            return 0
        with self._lock:
            sinks = list(self._sinks.values())
        sent = 0
        dropped = 0
        for fn in sinks:
            try:
                fn(frame)
                sent += 1
            except Exception:
                dropped += 1
        if dropped:
            with self._lock:
                self._dropped += dropped
        if sent:
            with self._lock:
                self._sent[type_name] = self._sent.get(type_name, 0) + sent
            try:
                _SM().count_push_frame(type_name, sent)
            except Exception:
                pass
        return sent

    @staticmethod
    def _now_ms() -> int:
        return int(time.time() * 1000)

    # -- emitters -----------------------------------------------------------
    def push_lease_revoke(
        self, lease_id: int, flow_id: int, tokens: int = 0
    ) -> int:
        n = self._broadcast(
            P.encode_push_lease_revoke(
                next(self._xid), self._now_ms(), int(lease_id),
                int(flow_id), int(tokens),
            ),
            "lease_revoke",
        )
        if n:
            try:
                _SM().count_push_revocation()
            except Exception:
                pass
        return n

    def push_breaker_flip(
        self, flow_id: int, state: int, retry_after_ms: int = 0
    ) -> int:
        return self._broadcast(
            P.encode_push_breaker_flip(
                next(self._xid), self._now_ms(), int(flow_id), int(state),
                int(retry_after_ms),
            ),
            "breaker_flip",
        )

    def push_rule_epoch(self, epoch: int) -> int:
        return self._broadcast(
            P.encode_push_rule_epoch(
                next(self._xid), self._now_ms(), int(epoch)
            ),
            "rule_epoch_invalidate",
        )

    def push_shard_map(self, doc: bytes) -> int:
        """``doc`` is the zlib-compressed ShardMap JSON. A doc too big for
        one frame is dropped here (counted) — the polling publish path
        still carries it."""
        try:
            frame = P.encode_push_shard_map(
                next(self._xid), self._now_ms(), bytes(doc)
            )
        except ValueError:
            with self._lock:
                self._dropped += 1
            return 0
        return self._broadcast(frame, "shard_map_push")

    def push_brownout(self, level: int, retry_ms: int = 0) -> int:
        return self._broadcast(
            P.encode_push_brownout(
                next(self._xid), self._now_ms(), int(level), int(retry_ms)
            ),
            "brownout_advisory",
        )

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """The ``clusterServerStats`` ``push`` block's hub half."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "connections": len(self._sinks),
                "sent": dict(self._sent),
                "dropped": self._dropped,
            }
