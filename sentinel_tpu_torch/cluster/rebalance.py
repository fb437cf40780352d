"""Epoch-fenced live shard rebalancing (the port's copy of
``sentinel_tpu/cluster/rebalance.py``).

A namespace moves between two live token servers *under traffic* with zero
over-admission and zero lost tokens. Three pieces live here:

- :class:`ShardMap` — an epoch-numbered namespace→endpoint map published
  through the :class:`~sentinel_tpu_torch.core.property.DynamicProperty`
  plane (data sources push new maps; routing clients subscribe). Epochs are
  the fence: a client holding epoch *e* learns passively that it is stale
  when a ``MOVED`` verdict arrives carrying *e' > e* in its ``remaining``
  field, and never applies a map older than the one it holds.

- :class:`MoveCoordinator` — the source-side driver of the two-phase
  drain-and-move protocol on wire-rev-4 frames::

      source                               destination
        begin_move(ns)  (flows now answer MOVED, counters frozen)
        MOVE_BEGIN(epoch, ns)  ───────────▶  stage pending-begin
                        ◀─────────── REPL_ACK OK
        MOVE_STATE chunks (slim sums) ────▶  decode + STAGE (no mutation)
                        ◀─────────── REPL_ACK OK
        MOVE_COMMIT(epoch, ns) ───────────▶  import_namespace_state(doc)
                        ◀─────────── REPL_ACK OK
        (redirect tombstone stays until end_redirect)

  Any failure before the COMMIT ack — timeout, connection loss, chaos
  injection, a destination ERROR ack — runs the abort path: best-effort
  ``MOVE_ABORT`` plus ``service.abort_move(ns)``, which is lossless by
  construction because MOVED-masked requests never touched the counters.
  Crash matrix (who owns ``ns`` after a SIGKILL):

  ========================  ==========================================
  crash point               owner
  ========================  ==========================================
  source before COMMIT      source restart owns (dest staging expires)
  source after COMMIT sent  destination (it imported before acking)
  dest before COMMIT        source (ack timeout → abort_move restores)
  dest after COMMIT ack     destination (import completed before ack)
  ========================  ==========================================

  Exactly one owner in every row: the destination mutates state only at
  COMMIT, and the source frees its claim only on abort (restore) or
  ``end_redirect`` (release) — never both.

- :class:`MoveTarget` — the destination side, one
  :class:`MoveSession` per inbound connection behind the front door
  (the door routes ``MOVE_TYPES`` frames here exactly like rev-3 repl
  frames route to :class:`~sentinel_tpu_torch.ha.replication.ReplSession`).
  State is STAGED on ``MOVE_STATE`` and applied only on ``MOVE_COMMIT``;
  staging is discarded on abort, disconnect, or deadline expiry.

The shipped document is the *slim* representation — per-row live-window
sums, not ring buckets (SF-sketch's fat-update/slim-query split applied to
handoff): ring- and epoch-free, so the destination folds it into its own
current bucket regardless of clock skew, and typically ~100× smaller than
a full snapshot of the same rows. Blobs are byte-equal to the reference's
for the same document, so either package's coordinator moves a namespace
into either package's door.

Leases (wire rev 5) cross a move as "transfer the charge, recall the
lease": ``begin_move`` revokes the source's lease registry for the
namespace (renewals answer MOVED and fall back to per-request RPCs), while
the LEASED event column — the full delegated charge — rides ``flow_sums``
to the destination like any other window sum. The destination therefore
keeps counting every outstanding delegated token against the global limit
from its first imported window, and clients re-grant fresh leases there;
no lease survives a move, but no delegated token escapes accounting.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from sentinel_tpu_torch import chaos as _chaos
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.core.property import DynamicProperty
from sentinel_tpu_torch.engine.rules import (
    decode_degrade_rule as _dec_degrade,
    decode_rule as _decode_rule,
    encode_degrade_rule as _enc_degrade,
    encode_rule as _encode_rule,
)
from sentinel_tpu_torch.ha.snapshot import _dec_array, _enc_array
from sentinel_tpu_torch.metrics.ha import ha_metrics

MOVE_STATE_VERSION = 1


# -- shard map ----------------------------------------------------------------
@dataclass(frozen=True)
class ShardMap:
    """Epoch-numbered namespace→endpoint assignment. Immutable; every
    change is a NEW map with a strictly larger epoch, so "is this map
    newer" is one integer compare — the fence stale clients are measured
    against.

    ``global_flows`` is the hierarchy tier's section: flow_id (as str —
    the map is a JSON document) → the global budget coordinator's
    endpoint. It rides the SAME epoch fence, so coordinator failover,
    MOVE, and routing all agree on one monotonic version — a stale map
    can no more point an agent at a dead coordinator than it can point a
    client at a moved namespace."""

    epoch: int = 0
    endpoint_of: Mapping[str, str] = field(default_factory=dict)
    global_flows: Mapping[str, str] = field(default_factory=dict)

    def assign(self, namespace: str, endpoint: str) -> "ShardMap":
        """Next-epoch map with ``namespace`` moved to ``endpoint``."""
        m = dict(self.endpoint_of)
        m[namespace] = endpoint
        return ShardMap(self.epoch + 1, m, dict(self.global_flows))

    def assign_global(self, flow_id, endpoint: str) -> "ShardMap":
        """Next-epoch map with ``flow_id``'s global budget coordinator at
        ``endpoint`` (pass ``None``/empty to delist the flow)."""
        g = dict(self.global_flows)
        if endpoint:
            g[str(int(flow_id))] = str(endpoint)
        else:
            g.pop(str(int(flow_id)), None)
        return ShardMap(self.epoch + 1, dict(self.endpoint_of), g)

    def coordinator_of(self, flow_id) -> Optional[str]:
        return self.global_flows.get(str(int(flow_id)))

    def to_doc(self) -> Dict[str, object]:
        return {
            "epoch": int(self.epoch),
            "endpoints": dict(self.endpoint_of),
            "global_flows": dict(self.global_flows),
        }

    @staticmethod
    def from_doc(doc: Mapping[str, object]) -> "ShardMap":
        return ShardMap(
            int(doc["epoch"]),
            {str(k): str(v) for k, v in dict(doc["endpoints"]).items()},
            # absent in pre-hierarchy documents — back-compat default
            {
                str(k): str(v)
                for k, v in dict(doc.get("global_flows") or {}).items()
            },
        )


class ShardMapPublisher:
    """The property-plane head of the shard map: holds the current
    :class:`ShardMap` in a :class:`DynamicProperty` (so any existing data
    source can feed it and any listener — routing clients, dashboards —
    subscribes with the same API rules use) and enforces the epoch fence
    on publish: an older-or-equal epoch never overwrites a newer map."""

    def __init__(self, prop: Optional[DynamicProperty] = None):
        self.property: DynamicProperty = (
            prop if prop is not None else DynamicProperty(ShardMap())
        )
        if self.property.value is None:
            self.property.update_value(ShardMap())
        self._lock = threading.Lock()

    def current(self) -> ShardMap:
        return self.property.value or ShardMap()

    def publish(self, shard_map: ShardMap) -> bool:
        """Install ``shard_map`` if its epoch is newer. Returns False (and
        publishes nothing) for a stale or same-epoch map."""
        with self._lock:
            cur = self.current()
            if shard_map.epoch <= cur.epoch:
                return False
            return self.property.update_value(shard_map)

    def listen(self, fn: Callable[[Optional[ShardMap]], None]):
        return self.property.listen(fn)


# -- shard-map doc codec (rev-7 SHARD_MAP_PUSH payload) -----------------------
def encode_shard_map_doc(shard_map: ShardMap) -> bytes:
    """``ShardMap`` → compressed JSON blob for the SHARD_MAP_PUSH data
    section. Same zlib+JSON idiom as the move-state blob; the push frame
    treats it as opaque bytes."""
    return zlib.compress(
        json.dumps(shard_map.to_doc(), separators=(",", ":")).encode("utf-8")
    )


def decode_shard_map_doc(blob: bytes) -> ShardMap:
    """Inverse of :func:`encode_shard_map_doc`. Raises ValueError only, so
    client push dispatch can contain a torn or hostile payload without
    dropping the connection."""
    try:
        doc = json.loads(zlib.decompress(bytes(blob)).decode("utf-8"))
        return ShardMap.from_doc(doc)
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"bad shard map doc: {exc}") from exc


# -- move-state blob codec ----------------------------------------------------
def encode_move_state_blob(doc: Dict[str, object]) -> bytes:
    """``export_namespace_state()`` document → compressed wire blob (rules
    serialize with the ha.snapshot idiom, arrays with its base64+zlib
    codec)."""
    out: Dict[str, object] = {
        "version": MOVE_STATE_VERSION,
        "namespace": doc["namespace"],
        "wall_ms": int(doc["wall_ms"]),
        "interval_ms": int(doc["interval_ms"]),
        "rules": [_encode_rule(r) for r in doc["rules"]],
        "param_rules": [
            {
                "flow_id": r.flow_id,
                "count": r.count,
                "item_thresholds": [
                    [int(h), float(c)] for h, c in (r.item_thresholds or ())
                ],
                "namespace": r.namespace,
            }
            for r in doc["param_rules"]
        ],
        "flow_ids": [int(f) for f in doc["flow_ids"]],
        "flow_sums": _enc_array(doc["flow_sums"]),
        "occupy_sums": _enc_array(doc["occupy_sums"]),
        "ns_sum": _enc_array(doc["ns_sum"]),
        "param_fids": [int(f) for f in doc["param_fids"]],
        "param_sums": _enc_array(doc["param_sums"]),
    }
    # shaper clocks (relative-to-export-now; absent in pre-shaping exports)
    for k in (
        "shaping_lpt_rel", "shaping_warm_tokens", "shaping_warm_filled_rel"
    ):
        if k in doc:
            out[k] = _enc_array(doc[k])
    # the breaker plane: its rules, the moved flows' completion windows,
    # and the state columns with relative clocks (absent in pre-breaker
    # exports — the destination then starts those flows CLOSED/cold)
    if doc.get("degrade_rules"):
        out["degrade_rules"] = [_enc_degrade(d) for d in doc["degrade_rules"]]
    for k in (
        "outcome_sums", "breaker_state",
        "breaker_opened_rel", "breaker_probe_rel",
    ):
        if k in doc:
            out[k] = _enc_array(doc[k])
    return zlib.compress(json.dumps(out, separators=(",", ":")).encode())


def decode_move_state_blob(blob: bytes) -> Dict[str, object]:
    """Wire blob → the dict ``import_namespace_state`` consumes. Raises
    ``ValueError`` on any malformed input (fuzz-safe — corrupt bytes must
    never kill the destination door)."""
    from sentinel_tpu_torch.cluster.token_service import ClusterParamFlowRule

    try:
        out = json.loads(zlib.decompress(blob).decode())
        if out.pop("version", None) != MOVE_STATE_VERSION:
            raise ValueError("unsupported move-state version")
        return {
            "namespace": str(out["namespace"]),
            "wall_ms": int(out["wall_ms"]),
            "interval_ms": int(out["interval_ms"]),
            "rules": [_decode_rule(r) for r in out["rules"]],
            "param_rules": [
                ClusterParamFlowRule(
                    int(r["flow_id"]), float(r["count"]),
                    tuple(
                        (int(h), float(c)) for h, c in r["item_thresholds"]
                    ) or None,
                    str(r["namespace"]),
                )
                for r in out["param_rules"]
            ],
            "flow_ids": [int(f) for f in out["flow_ids"]],
            "flow_sums": _dec_array(out["flow_sums"]),
            "occupy_sums": _dec_array(out["occupy_sums"]),
            "ns_sum": _dec_array(out["ns_sum"]),
            "param_fids": [int(f) for f in out["param_fids"]],
            "param_sums": _dec_array(out["param_sums"]),
            **{
                k: _dec_array(out[k])
                for k in (
                    "shaping_lpt_rel",
                    "shaping_warm_tokens",
                    "shaping_warm_filled_rel",
                    "outcome_sums",
                    "breaker_state",
                    "breaker_opened_rel",
                    "breaker_probe_rel",
                )
                if k in out
            },
            **(
                {
                    "degrade_rules": [
                        _dec_degrade(d) for d in out["degrade_rules"]
                    ]
                }
                if "degrade_rules" in out else {}
            ),
        }
    except ValueError:
        raise
    except Exception as e:  # zlib.error, KeyError, TypeError, ...
        raise ValueError(f"malformed move-state blob: {e}") from None


# -- source side --------------------------------------------------------------
class MoveFailed(Exception):
    """The move aborted (source still owns the namespace). ``str()`` names
    the failing step — the drill and chaos tests assert on it."""


class MoveCoordinator:
    """Source-side driver of one-namespace-at-a-time live moves.

    Socket discipline mirrors :class:`~sentinel_tpu_torch.ha.replication
    .ReplicationSender`: one blocking TCP connection per move, TCP_NODELAY,
    every frame acked with REPL_ACK inside ``ack_timeout_s``, chaos
    ``lane_delay``/``conn_reset`` probes on every outbound frame. The
    optional ``on_step`` hook fires with ``"begin"`` / ``"state"`` /
    ``"commit"`` just before each protocol step's frames go out — the
    deterministic kill-point the chaos tests hang their injections on.
    """

    def __init__(
        self,
        service,
        self_endpoint: str = "",
        publisher: Optional[ShardMapPublisher] = None,
        ack_timeout_s: float = 5.0,
        on_step: Optional[Callable[[str], None]] = None,
    ):
        self.service = service
        self.self_endpoint = self_endpoint
        self.publisher = publisher
        self.ack_timeout_s = float(ack_timeout_s)
        self.on_step = on_step
        self._xid = 0
        self.last_error: Optional[str] = None

    # -- protocol steps ------------------------------------------------------
    def move_namespace(
        self,
        namespace: str,
        dest: str,
        epoch: Optional[int] = None,
    ) -> bool:
        """Drain-and-move ``namespace`` to ``dest`` ("host:port"). Returns
        True on commit (the destination owns the namespace; this side keeps
        answering MOVED until :meth:`release`), False on abort (this side
        still owns it, counters untouched — ``last_error`` says why).
        ``epoch`` defaults to the publisher's next epoch."""
        if epoch is None:
            if self.publisher is None:
                raise ValueError("epoch required without a publisher")
            epoch = self.publisher.current().epoch + 1
        begun_wall = _clock.now_ms()
        self.last_error = None
        sock: Optional[socket.socket] = None
        began = False
        try:
            host, _, port = dest.rpartition(":")
            sock = socket.create_connection(
                (host, int(port)), timeout=self.ack_timeout_s
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            buf = [b""]

            # step 1: BEGIN — freeze the namespace (flows answer MOVED from
            # this point; their counters stop moving) and reserve the claim
            # on the destination
            self._hook("begin")
            self.service.begin_move(namespace, dest, int(epoch))
            began = True
            ha_metrics().count_rebalance("begin")
            self._send(sock, P.encode_move_ctrl(
                self._next_xid(), P.MsgType.MOVE_BEGIN, int(epoch),
                namespace, self.self_endpoint,
            ))
            self._expect_ok(sock, buf, "begin")

            # step 2: STATE — ship the slim representation; the destination
            # stages it without mutating anything
            self._hook("state")
            doc = self.service.export_namespace_state(namespace)
            blob = encode_move_state_blob(doc)
            frames = P.encode_repl_blob(
                self._next_xid(), P.MsgType.MOVE_STATE,
                int(self.service.state_generation()), int(epoch), blob,
            )
            for frame in frames:
                self._send(sock, frame)
            ha_metrics().add_rebalance_state_bytes(
                sum(len(f) for f in frames)
            )
            self._expect_ok(sock, buf, "state")

            # step 3: COMMIT — the destination imports atomically before
            # acking; after this ack there is exactly one owner: them
            self._hook("commit")
            self._send(sock, P.encode_move_ctrl(
                self._next_xid(), P.MsgType.MOVE_COMMIT, int(epoch),
                namespace, self.self_endpoint,
            ))
            self._expect_ok(sock, buf, "commit")
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
            record_log.warning(
                "move of %r to %s aborted: %s", namespace, dest,
                self.last_error,
            )
            if began:
                self._abort(sock, namespace, int(epoch))
            self._close(sock)
            ha_metrics().count_rebalance("abort")
            return False
        self._close(sock)
        ha_metrics().count_rebalance("commit")
        ha_metrics().observe_move_ms(max(0, _clock.now_ms() - begun_wall))
        if self.publisher is not None:
            self.publisher.publish(
                self.publisher.current().assign(namespace, dest)
            )
        return True

    def release(self, namespace: str) -> None:
        """Drop the post-commit MOVED tombstone (and the namespace's rules)
        once clients have converged on the new owner."""
        self.service.end_redirect(namespace)

    # -- plumbing ------------------------------------------------------------
    def _hook(self, step: str) -> None:
        if self.on_step is not None:
            self.on_step(step)

    def _next_xid(self) -> int:
        self._xid += 1
        return self._xid

    def _send(self, sock: socket.socket, frame: bytes) -> None:
        if _chaos.ARMED:
            _chaos.maybe_sleep("lane_delay")
            if _chaos.should("conn_reset"):
                raise ConnectionResetError("chaos: move conn_reset")
        sock.sendall(frame)

    def _expect_ok(self, sock, buf: List[bytes], step: str) -> None:
        code = self._read_ack(sock, buf)
        if code != P.ReplAck.OK:
            raise MoveFailed(f"destination refused {step}: {code.name}")

    def _read_ack(self, sock: socket.socket, buf: List[bytes]) -> P.ReplAck:
        """Block for the next REPL_ACK on the move channel (same framing as
        the repl channel's ack read). Rev-7 push frames are skipped: a door
        that pushes to every connection sends the rule-epoch push of the
        destination's import down this channel before the COMMIT ack, and
        reading it as a failed step would abort a move that the
        destination has already committed (two owners)."""
        sock.settimeout(self.ack_timeout_s)
        data = buf[0]
        while True:
            if len(data) >= 2:
                (length,) = struct.unpack_from(">H", data, 0)
                if len(data) >= 2 + length:
                    payload = data[2 : 2 + length]
                    buf[0] = data = data[2 + length :]
                    if (len(payload) >= 5
                            and P.peek_type(payload) in P.PUSH_TYPES):
                        continue
                    if (
                        len(payload) < 5
                        or P.peek_type(payload) != P.MsgType.REPL_ACK
                    ):
                        raise ConnectionError(
                            "non-ack frame on move channel"
                        )
                    _xid, code, _gen, _seq = P.decode_repl_ack(payload)
                    return code
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("move channel closed by destination")
            data = buf[0] = buf[0] + chunk

    def _abort(self, sock, namespace: str, epoch: int) -> None:
        """Best-effort MOVE_ABORT + local restore. The local restore is the
        part that matters for ownership (it is unconditional); the wire
        abort just lets the destination free its staging early instead of
        waiting out the deadline."""
        try:
            if sock is not None:
                sock.sendall(P.encode_move_ctrl(
                    self._next_xid(), P.MsgType.MOVE_ABORT, epoch,
                    namespace, self.self_endpoint,
                ))
        except OSError:
            pass
        self.service.abort_move(namespace)

    @staticmethod
    def _close(sock) -> None:
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


# -- destination side ---------------------------------------------------------
class _Staged:
    """One staged (not yet committed) inbound move."""

    __slots__ = ("namespace", "epoch", "peer", "doc", "deadline_ms",
                 "session_id")

    def __init__(self, namespace, epoch, peer, deadline_ms, session_id):
        self.namespace = namespace
        self.epoch = int(epoch)
        self.peer = peer
        self.doc: Optional[Dict[str, object]] = None
        self.deadline_ms = deadline_ms
        self.session_id = session_id


class MoveTarget:
    """Destination-side move handler shared by both front doors.

    Staging discipline: ``MOVE_BEGIN`` reserves a claim, ``MOVE_STATE``
    attaches the decoded document, and ONLY ``MOVE_COMMIT`` mutates the
    service (``import_namespace_state`` validates before touching state, so
    a failed import leaves this side clean and acks ERROR — the source then
    aborts and keeps ownership). Staging dies three ways: an explicit
    ``MOVE_ABORT``, the connection closing (a SIGKILLed source must not
    leave a claim behind), or ``stage_ttl_ms`` expiring (belt and braces
    for a source that wedges without closing the socket)."""

    def __init__(self, service, stage_ttl_ms: float = 10_000.0):
        self.service = service
        self.stage_ttl_ms = float(stage_ttl_ms)
        self._lock = threading.Lock()
        self._staged: Dict[str, _Staged] = {}  # namespace → claim
        self._session_seq = 0

    def connection(self) -> "MoveSession":
        with self._lock:
            self._session_seq += 1
            return MoveSession(self, self._session_seq)

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {
                "staged": [
                    {"namespace": s.namespace, "epoch": s.epoch,
                     "peer": s.peer, "hasState": s.doc is not None}
                    for s in self._staged.values()
                ],
            }

    # -- protocol steps (called from sessions) -------------------------------
    def _sweep_locked(self) -> None:
        now = _clock.now_ms()
        for ns in [
            ns for ns, s in self._staged.items() if now >= s.deadline_ms
        ]:
            record_log.warning(
                "staged move of %r expired unclaimed; discarding", ns
            )
            del self._staged[ns]

    def _begin(self, session_id, namespace, epoch, peer) -> int:
        with self._lock:
            self._sweep_locked()
            cur = self._staged.get(namespace)
            if cur is not None and cur.session_id != session_id:
                # two sources claiming one namespace is a split brain —
                # refuse the newcomer, keep the live claim
                record_log.warning(
                    "refusing concurrent move claim on %r (held by %s)",
                    namespace, cur.peer,
                )
                return int(P.ReplAck.ERROR)
            self._staged[namespace] = _Staged(
                namespace, epoch, peer,
                _clock.now_ms() + self.stage_ttl_ms, session_id,
            )
        ha_metrics().count_rebalance("begin")
        return int(P.ReplAck.OK)

    def _stage(self, session_id, epoch, blob) -> int:
        try:
            doc = decode_move_state_blob(blob)
        except ValueError as e:
            record_log.warning("move-state blob refused: %s", e)
            return int(P.ReplAck.ERROR)
        with self._lock:
            self._sweep_locked()
            s = self._staged.get(doc["namespace"])
            if s is None or s.session_id != session_id or s.epoch != epoch:
                return int(P.ReplAck.ERROR)
            s.doc = doc
            s.deadline_ms = _clock.now_ms() + self.stage_ttl_ms
        return int(P.ReplAck.OK)

    def _commit(self, session_id, namespace, epoch) -> int:
        with self._lock:
            self._sweep_locked()
            s = self._staged.get(namespace)
            if (
                s is None or s.session_id != session_id
                or s.epoch != epoch or s.doc is None
            ):
                return int(P.ReplAck.ERROR)
            del self._staged[namespace]
            doc = s.doc
        try:
            self.service.import_namespace_state(doc)
        except Exception:
            record_log.exception("move import of %r failed", namespace)
            return int(P.ReplAck.ERROR)
        ha_metrics().count_rebalance("commit")
        return int(P.ReplAck.OK)

    def _abort(self, session_id, namespace) -> int:
        with self._lock:
            s = self._staged.get(namespace)
            if s is not None and s.session_id == session_id:
                del self._staged[namespace]
        ha_metrics().count_rebalance("abort")
        return int(P.ReplAck.OK)

    def _session_closed(self, session_id) -> None:
        with self._lock:
            for ns in [
                ns for ns, s in self._staged.items()
                if s.session_id == session_id
            ]:
                record_log.warning(
                    "move channel for %r closed before commit; discarding "
                    "staged state", ns,
                )
                del self._staged[ns]


class MoveSession:
    """One move connection's state behind a front door: the chunk
    reassembler plus ack plumbing, mirroring
    :class:`~sentinel_tpu_torch.ha.replication.ReplSession`. ``handle(payload,
    send)`` consumes one rev-4 frame; ``closed()`` must be called when the
    connection drops so staged state from a crashed source is discarded.
    Raises ``ValueError`` on a torn chunk stream (the door drops the
    connection, same contract as ``decode_request``)."""

    def __init__(self, target: MoveTarget, session_id: int):
        self.target = target
        self.session_id = session_id
        self._asm = P.ReplBlobAssembler()

    def handle(self, payload: bytes, send: Callable[[bytes], None]) -> None:
        mtype = P.peek_type(payload)
        if mtype == P.MsgType.MOVE_STATE:
            done = self._asm.feed(mtype, payload)
            if done is None:
                return
            _t, gen, epoch, blob = done
            code = self.target._stage(self.session_id, epoch, blob)
            send(P.encode_repl_ack(P.peek_xid(payload), code, gen, epoch))
            return
        xid, epoch, namespace, _peer = P.decode_move_ctrl(payload)
        if mtype == P.MsgType.MOVE_BEGIN:
            code = self.target._begin(self.session_id, namespace, epoch,
                                      _peer)
        elif mtype == P.MsgType.MOVE_COMMIT:
            code = self.target._commit(self.session_id, namespace, epoch)
        elif mtype == P.MsgType.MOVE_ABORT:
            code = self.target._abort(self.session_id, namespace)
        else:
            raise ValueError(f"unexpected frame on move channel: {mtype}")
        send(P.encode_repl_ack(xid, code, epoch, epoch))

    def closed(self) -> None:
        self.target._session_closed(self.session_id)
