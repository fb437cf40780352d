"""Warm-standby state replication: delta streaming over wire rev 3 (the
port's copy of ``sentinel_tpu/ha/replication.py``; the documents and frames
are the reference's, byte for byte, so a primary of either package streams
into a standby of either).

A snapshot bounds failover loss at snapshot granularity (default 30 s): a
SIGKILLed primary forgets everything since the last artifact, and the
promoted standby over-admits up to a full window per flow. Replication
shrinks that loss to ONE DELTA-SHIP INTERVAL: the primary keeps shipping
only the counter rows that changed (the slim twin's rows for the param
sketch), and the standby applies them behind its closed front door until
promotion.

Topology and protocol::

    primary                                      standby
    ──────────                                   ──────────
    ReplicationSender ── REPL_HELLO ──────────▶  front door ─▶ StandbyApplier
        │              ◀─ REPL_ACK(OK|NEED_SNAPSHOT) ─┘
        ├── REPL_SNAPSHOT chunks ─────────────▶  import_state (bootstrap /
        │              ◀─ REPL_ACK ──────────┘   generation resync)
        └── REPL_DELTA chunks (every tick) ───▶  apply_replication_delta
                       ◀─ REPL_ACK ──────────┘

- The sender speaks to the standby's ORDINARY front door (the native door
  routes rev-3 type bytes to the applier), so replication needs no extra
  port and inherits the door's chaos instrumentation.
- Deltas are generation-fenced: every rule reload bumps the token
  service's ``state_generation`` and invalidates slot-keyed rows, so the
  sender re-bootstraps the standby with a full snapshot on any gen change,
  NEED_SNAPSHOT ack, or reconnect. A delta the standby missed is covered by
  the next snapshot resync, and a delta applied twice sets the same
  absolute rows (ship state, not increments).
- The repl channel must survive chaos: ``conn_reset`` / ``lane_delay``
  probes fire in the sender's ship path when armed, and every failure mode
  funnels into "reconnect + snapshot resync", never a crashed thread.
- An un-promoted standby answers data-plane traffic with
  ``TokenStatus.STANDBY``; promotion is explicit (``promote()``) or
  automatic when the repl channel has been silent for ``promote_after_ms``
  (primary-death detection).

Metrics land on :mod:`sentinel_tpu_torch.metrics.ha`:
``sentinel_repl_deltas_total{event=}``, ``sentinel_repl_bytes_total``,
and the ``sentinel_repl_lag_ms`` gauge (capture → ACK age of the last
acked document).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch import chaos as _chaos
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.ha.snapshot import (
    _dec_array,
    _enc_array,
    decode_snapshot,
    encode_snapshot,
)
from sentinel_tpu_torch.metrics.ha import ha_metrics

DELTA_VERSION = 1
KEY_REPL_INTERVAL_MS = "sentinel.tpu.ha.repl.interval.ms"
KEY_PROMOTE_AFTER_MS = "sentinel.tpu.ha.repl.promote.after.ms"

# export_delta keys holding numpy arrays (everything else is JSON-native)
_ARRAY_KEYS = frozenset(
    {
        "flow_starts", "occupy_starts", "ns_starts", "param_starts",
        "flow_counts", "occupy_counts", "ns_counts", "param_counts",
        "param_slim",  # SF slim-twin rows: the param payload when slim is on
        # shaper clocks (raw engine-ms, same dirty-row keying as flow_counts)
        "shaping_lpt", "shaping_warm_tokens", "shaping_warm_filled",
        # completion-outcome columns (own dirty set: reporting cadence is
        # decoupled from the admission windows')
        "outcome_starts", "outcome_counts",
        # circuit-breaker columns (own dirty set: transitions happen only
        # on batched/reported rows, so touched∩breaker is exact)
        "breaker_state", "breaker_opened", "breaker_probe",
    }
)


# -- blob codecs --------------------------------------------------------------
def encode_delta_blob(delta: Dict[str, object]) -> bytes:
    """``export_delta()`` document → compressed wire blob."""
    doc: Dict[str, object] = {"version": DELTA_VERSION}
    for k, v in delta.items():
        doc[k] = _enc_array(v) if k in _ARRAY_KEYS else v
    return zlib.compress(json.dumps(doc, separators=(",", ":")).encode())


def decode_delta_blob(blob: bytes) -> Dict[str, object]:
    """Wire blob → the dict ``apply_replication_delta`` consumes. Raises
    ``ValueError`` on any malformed input (fuzz-safe: corrupt bytes must
    never kill the applier)."""
    try:
        doc = json.loads(zlib.decompress(blob).decode())
        if doc.pop("version", None) != DELTA_VERSION:
            raise ValueError("unsupported delta version")
        return {
            k: (_dec_array(v) if k in _ARRAY_KEYS else v)
            for k, v in doc.items()
        }
    except ValueError:
        raise
    except Exception as e:  # zlib.error, UnicodeDecodeError, KeyError, ...
        raise ValueError(f"malformed delta blob: {e}") from None


def encode_snapshot_blob(state: Dict[str, object]) -> bytes:
    """``export_state()`` capture → compressed full-sync wire blob."""
    return zlib.compress(
        json.dumps(encode_snapshot(state), separators=(",", ":")).encode()
    )


def decode_snapshot_blob(blob: bytes) -> Dict[str, object]:
    """Wire blob → the dict ``import_state`` consumes (fuzz-safe)."""
    try:
        return decode_snapshot(json.loads(zlib.decompress(blob).decode()))
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"malformed snapshot blob: {e}") from None


# -- primary side -------------------------------------------------------------
class _Link:
    """One standby's connection state. ``gen=-1`` + ``needs_snapshot`` make
    the first ship a full bootstrap; every failure path resets to that."""

    __slots__ = ("host", "port", "sock", "gen", "needs_snapshot", "promoted",
                 "buf")

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        self.sock: Optional[socket.socket] = None
        self.gen = -1
        self.needs_snapshot = True
        self.promoted = False  # standby answered NOT_STANDBY; stop shipping
        self.buf = b""

    def close(self) -> None:
        sock, self.sock = self.sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self.buf = b""
        self.needs_snapshot = True
        self.gen = -1

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"


class ReplicationSender:
    """Primary-side delta shipper: one daemon thread collects ONE delta per
    tick (``export_delta`` is destructive — collect once, ship to all) and
    streams it to every standby link, falling back to a full snapshot for
    any link that is fresh, acked NEED_SNAPSHOT, reconnected, or whose last
    shipped generation is stale. An idle tick still ships the starts-only
    heartbeat delta, which doubles as the standby's liveness signal (the
    applier's promotion watchdog resets on it)."""

    def __init__(
        self,
        service,
        standbys: Sequence,
        interval_ms: Optional[float] = None,
        sender_id: str = "",
        ack_timeout_s: float = 2.0,
    ):
        self.service = service
        self.interval_ms = float(
            interval_ms
            if interval_ms is not None
            else SentinelConfig.get_float(KEY_REPL_INTERVAL_MS, 250.0)
        )
        self.sender_id = sender_id
        self.ack_timeout_s = float(ack_timeout_s)
        self._links: List[_Link] = []
        for sb in standbys:
            if isinstance(sb, _Link):
                self._links.append(sb)
            elif isinstance(sb, str):
                host, _, port = sb.rpartition(":")
                self._links.append(_Link(host, int(port)))
            else:
                self._links.append(_Link(str(sb[0]), int(sb[1])))
        if not self._links:
            raise ValueError("at least one standby required")
        self._seq = 0
        self._xid = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_ship_ms: Optional[int] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicationSender":
        if self._thread is None:
            self.service.replication_enable()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sentinel-repl-sender", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        for link in self._links:
            link.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.ship_once()
            except Exception:
                # the tick must never kill the thread: any per-link failure
                # is already handled per link; this catches collect-side
                # surprises (e.g. a concurrent close)
                record_log.exception("replication tick failed")
                ha_metrics().count_repl("error")

    # -- one tick ------------------------------------------------------------
    def ship_once(self) -> int:
        """Collect one delta and ship to every live link. Returns the number
        of links that acked a document this tick (test/drill hook)."""
        delta = self.service.export_delta()
        delta_blob: Optional[bytes] = None
        snap_blob: Optional[bytes] = None
        snap_wall = 0
        acked = 0
        for link in self._links:
            if link.promoted:
                continue
            try:
                self._ensure_connected(link)
                if link.needs_snapshot or link.gen != delta["gen"]:
                    if snap_blob is None:
                        state = self.service.export_state()
                        snap_wall = int(state["wall_ms"])
                        snap_blob = encode_snapshot_blob(state)
                    self._ship(
                        link, P.MsgType.REPL_SNAPSHOT, int(delta["gen"]),
                        snap_blob,
                    )
                    # the snapshot captured at/after the delta, so it covers
                    # the delta's rows too — the delta is subsumed
                    link.gen = int(delta["gen"])
                    link.needs_snapshot = False
                    ha_metrics().count_repl("snapshot")
                    ha_metrics().set_repl_lag(
                        max(0, _clock.now_ms() - snap_wall)
                    )
                else:
                    if delta_blob is None:
                        delta_blob = encode_delta_blob(delta)
                    self._ship(
                        link, P.MsgType.REPL_DELTA, int(delta["gen"]),
                        delta_blob,
                    )
                    ha_metrics().count_repl("shipped")
                    ha_metrics().set_repl_lag(
                        max(0, _clock.now_ms() - int(delta["wall_ms"]))
                    )
                acked += 1
            except Exception as e:
                if link.sock is not None or not isinstance(e, OSError):
                    record_log.warning(
                        "replication to %s failed (%s); will reconnect",
                        link, e,
                    )
                link.close()
                ha_metrics().count_repl("reconnect")
        self.last_ship_ms = _clock.now_ms()
        return acked

    # -- link plumbing -------------------------------------------------------
    def _ensure_connected(self, link: _Link) -> None:
        if link.sock is not None:
            return
        sock = socket.create_connection(
            (link.host, link.port), timeout=self.ack_timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        link.sock = sock
        link.buf = b""
        # HELLO → the standby tells us whether it can extend our timeline
        self._xid += 1
        gen = self.service.state_generation()
        epoch = self.service._epoch_ms or 0
        sock.sendall(
            P.encode_repl_hello(
                self._xid, gen, int(epoch), self._seq, self.sender_id
            )
        )
        code, _g, _s = self._read_ack(link)
        if code == P.ReplAck.NOT_STANDBY:
            link.promoted = True
            record_log.warning("standby %s reports promoted; link idle", link)
            return
        link.needs_snapshot = code != P.ReplAck.OK
        link.gen = gen if code == P.ReplAck.OK else -1

    def _ship(self, link: _Link, mtype: int, gen: int, blob: bytes) -> None:
        self._seq += 1
        self._xid += 1
        seq = self._seq
        frames = P.encode_repl_blob(self._xid, mtype, gen, seq, blob)
        for frame in frames:
            if _chaos.ARMED:
                _chaos.maybe_sleep("lane_delay")
                if _chaos.should("conn_reset"):
                    raise ConnectionResetError("chaos: repl conn_reset")
            link.sock.sendall(frame)
        ha_metrics().add_repl_bytes(sum(len(f) for f in frames))
        code, _ack_gen, ack_seq = self._read_ack(link)
        if code == P.ReplAck.NOT_STANDBY:
            # carries seq=-1 (it answers any frame, not a document), so it
            # must be recognized before the seq-match check
            link.promoted = True
            record_log.warning("standby %s reports promoted; link idle", link)
            return
        if ack_seq != seq:
            raise ConnectionError(
                f"repl ack out of step (sent seq {seq}, acked {ack_seq})"
            )
        if code == P.ReplAck.OK:
            return
        if code == P.ReplAck.NEED_SNAPSHOT:
            link.needs_snapshot = True
            ha_metrics().count_repl("need_snapshot")
            return
        raise ConnectionError(f"standby {link} acked ERROR")

    def _read_ack(self, link: _Link) -> Tuple[int, int, int]:
        """Block for the next REPL_ACK frame on this link's socket. Frames
        of any other type on the repl channel are protocol violations and
        tear the link (handled by the caller's except path)."""
        while True:
            while len(link.buf) < 2:
                link.buf += self._recv(link)
            (length,) = struct.unpack_from(">H", link.buf, 0)
            while len(link.buf) < 2 + length:
                link.buf += self._recv(link)
            payload = link.buf[2 : 2 + length]
            link.buf = link.buf[2 + length :]
            if len(payload) < 5 or P.peek_type(payload) != P.MsgType.REPL_ACK:
                raise ConnectionError("non-ack frame on repl channel")
            _xid, code, gen, seq = P.decode_repl_ack(payload)
            return code, gen, seq

    def _recv(self, link: _Link) -> bytes:
        link.sock.settimeout(self.ack_timeout_s)
        data = link.sock.recv(65536)
        if not data:
            raise ConnectionError("repl link closed by standby")
        return data

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, object]:
        return {
            "intervalMs": self.interval_ms,
            "lastShipMs": self.last_ship_ms,
            "seq": self._seq,
            "links": [
                {
                    "standby": str(link),
                    "connected": link.sock is not None,
                    "gen": link.gen,
                    "needsSnapshot": link.needs_snapshot,
                    "promoted": link.promoted,
                }
                for link in self._links
            ],
        }


# -- standby side -------------------------------------------------------------
class StandbyApplier:
    """Applies replication documents into a standby's token service and
    owns the promotion decision.

    The front doors hand every rev-3 frame to a per-connection session
    (:meth:`connection`); the session reassembles chunked blobs and calls
    back into this shared applier, which serializes applies (the doors run
    on different threads/loops) and acks. Until :meth:`promote` flips the
    flag the doors refuse data-plane traffic with ``TokenStatus.STANDBY``;
    after it they serve, and any late repl frame is acked NOT_STANDBY so
    the old primary stops shipping.

    ``promote_after_ms > 0`` arms the primary-death watchdog: a daemon
    thread promotes automatically when no repl traffic (hello, delta, or
    snapshot chunk) has arrived for that long — counted from the LAST
    contact, and only once the primary has connected at least once. Death
    can't be detected for a primary never seen alive: a standby brought up
    ahead of its (slow-booting) primary must keep its door closed, not
    promote into a split brain the moment the boot outlasts the timer.
    A standby whose primary truly never appears stays refusing until an
    operator promotes it explicitly (``NativeTokenServer.promote``)."""

    def __init__(
        self,
        service,
        promote_after_ms: Optional[float] = None,
        on_promote: Optional[Callable[[str], None]] = None,
    ):
        self.service = service
        self.promote_after_ms = float(
            promote_after_ms
            if promote_after_ms is not None
            else SentinelConfig.get_float(KEY_PROMOTE_AFTER_MS, 0.0)
        )
        self.on_promote = on_promote
        self._promoted = threading.Event()
        self._lock = threading.Lock()  # serializes applies across doors
        self._last_contact_ms: Optional[int] = None
        self._started_ms: Optional[int] = None
        self._applied = 0
        self._snapshots = 0
        self._lag_ms = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StandbyApplier":
        self._started_ms = _clock.now_ms()
        if self.promote_after_ms > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watchdog, name="sentinel-standby-watchdog",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def _watchdog(self) -> None:
        poll_s = max(0.01, self.promote_after_ms / 4000.0)
        while not self._stop.wait(poll_s):
            if self._promoted.is_set():
                return
            with self._lock:
                base = self._last_contact_ms
            if base is None:  # primary never connected: nothing to detect
                continue
            if _clock.now_ms() - base >= self.promote_after_ms:
                self.promote(reason="primary_silent")
                return

    # -- promotion -----------------------------------------------------------
    @property
    def promoted(self) -> bool:
        return self._promoted.is_set()

    def promote(self, reason: str = "manual") -> bool:
        """Open the front door. Returns False when already promoted."""
        if self._promoted.is_set():
            return False
        self._promoted.set()
        ha_metrics().count_repl("promoted")
        record_log.warning(
            "standby promoted to primary (reason=%s, lag=%.0fms)",
            reason, self._lag_ms,
        )
        from sentinel_tpu_torch.trace import blackbox as _blackbox
        from sentinel_tpu_torch.trace import ring as _TR

        if _TR.ARMED:
            _TR.record(_TR.PROMOTE)
        # a promotion means the primary just died (or an operator thinks
        # it did) — freeze the evidence before the new primary's traffic
        # overwrites the rings
        _blackbox.maybe_dump(f"standby_promote:{reason}")
        if self.on_promote is not None:
            try:
                self.on_promote(reason)
            except Exception:
                record_log.exception("on_promote callback failed")
        return True

    # -- frame handling ------------------------------------------------------
    def connection(self) -> "ReplSession":
        """Per-connection session (chunk reassembly is per TCP stream)."""
        return ReplSession(self)

    def _touch(self) -> None:
        with self._lock:
            self._last_contact_ms = _clock.now_ms()

    def _apply(self, mtype: int, blob: bytes) -> int:
        """Decode + apply one reassembled document; returns the ack code.
        ``ValueError`` (malformed blob, epoch/rule mismatch) asks for a
        snapshot resync; anything else is ERROR (the sender tears the
        link and starts over — state is never half-applied: the service
        validates before mutating)."""
        try:
            if mtype == P.MsgType.REPL_SNAPSHOT:
                state = decode_snapshot_blob(blob)
                wall = int(state["wall_ms"])
                with self._lock:
                    self.service.import_state(state)
                    self._snapshots += 1
                    self._lag_ms = max(0, _clock.now_ms() - wall)
                ha_metrics().count_repl("snapshot")
            else:
                delta = decode_delta_blob(blob)
                wall = int(delta["wall_ms"])
                with self._lock:
                    self.service.apply_replication_delta(delta)
                    self._applied += 1
                    self._lag_ms = max(0, _clock.now_ms() - wall)
                ha_metrics().count_repl("applied")
            ha_metrics().set_repl_lag(self._lag_ms)
            return int(P.ReplAck.OK)
        except ValueError as e:
            record_log.warning("replication document refused: %s", e)
            ha_metrics().count_repl("need_snapshot")
            return int(P.ReplAck.NEED_SNAPSHOT)
        except Exception:
            record_log.exception("replication apply failed")
            ha_metrics().count_repl("error")
            return int(P.ReplAck.ERROR)

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "promoted": self.promoted,
                "promoteAfterMs": self.promote_after_ms,
                "lastContactMs": self._last_contact_ms,
                "deltasApplied": self._applied,
                "snapshotsApplied": self._snapshots,
                "lagMs": self._lag_ms,
            }


class ReplSession:
    """One repl connection's state behind a front door: the chunk
    reassembler plus the ack plumbing. ``handle(payload, send)`` consumes
    one rev-3 frame and writes any ack through ``send`` (the door-specific
    raw-bytes writer). Raises ``ValueError`` on a torn or malformed chunk
    stream so the door can drop the connection (same contract as
    ``decode_request``)."""

    def __init__(self, applier: StandbyApplier):
        self.applier = applier
        self._asm = P.ReplBlobAssembler()

    def handle(self, payload: bytes, send: Callable[[bytes], None]) -> None:
        mtype = P.peek_type(payload)
        if self.applier.promoted:
            # late frame from the deposed primary: tell it to stop
            send(P.encode_repl_ack(P.peek_xid(payload),
                                   P.ReplAck.NOT_STANDBY, -1, -1))
            return
        if mtype == P.MsgType.REPL_HELLO:
            xid, _gen, epoch, _seq, sender = P.decode_repl_hello(payload)
            self.applier._touch()
            local_epoch = self.applier.service._epoch_ms
            code = (
                P.ReplAck.OK
                if local_epoch is not None and int(epoch) == int(local_epoch)
                else P.ReplAck.NEED_SNAPSHOT
            )
            send(P.encode_repl_ack(xid, code, -1, -1))
            return
        if mtype == P.MsgType.REPL_ACK:
            return  # acks flow standby → primary only; ignore strays
        # chunked blob frame (REPL_DELTA / REPL_SNAPSHOT)
        self.applier._touch()
        done = self._asm.feed(mtype, payload)
        if done is None:
            return
        dtype, gen, seq, blob = done
        xid = P.peek_xid(payload)
        code = self.applier._apply(dtype, blob)
        send(P.encode_repl_ack(xid, code, gen, seq))
