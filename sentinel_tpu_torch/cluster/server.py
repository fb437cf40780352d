"""The port's copy of ``sentinel_tpu/cluster/server.py``, serving
``sentinel_tpu_torch``'s :class:`DefaultTokenService` on the card.

Token server transport: asyncio TCP front door(s) + micro-batcher.

Analog of ``NettyTransportServer.java:51`` + ``TokenServerHandler.java:39``,
re-shaped for the device data plane: instead of one decision per
channelRead, the handler enqueues requests and an **adaptive** batcher drains
everything queued into one device step the moment the device is free —
batches grow naturally with load (arrivals pile up behind the in-flight step)
and a lone request pays no batching delay. This is what turns the reference's 20ms RPC budget
(``ClusterConstants.java:44``) into sub-ms micro-batches with room to spare.

Two throughput mechanisms layered on top (round-3):

- **BATCH_FLOW frames**: one frame carries N requests (protocol.py), decoded
  to numpy arrays in one shot and answered with one vectorized response
  frame — per-request Python cost drops ~100×. Mirrors how the reference
  amortizes netty channel reads with its batched ``FlowRequestData`` writer,
  taken further because the device wants big batches anyway.
- **Multi-loop IO** (``n_loops > 1``): N acceptor/reader event loops share
  the listening port via SO_REUSEPORT, each with its own micro-batcher, all
  feeding one ``TokenService`` (whose lock covers only device dispatch).
  The asyncio analog of ``NettyTransportServer.java:73-101``'s boss/worker
  pools (workers = 2×cores).

The asyncio loops run on dedicated threads (``start()``/``stop()`` are
host-thread-safe). A flow batch is dispatched inline on the loop thread
(host prep and the asynchronous CUDA launches, under the service lock, so
several loops share one service and one stream safely); materializing its
verdicts waits for the device, so large steps do that on a worker thread and
the IO loop keeps pumping frames meanwhile.

The service is probed for no hook: it must have every method the door calls
(:class:`DefaultTokenService` does). ``metrics_port`` serves the process's
Prometheus exposition (``metrics.exporter``) on its own port, as the
reference door does.
"""

from __future__ import annotations

import asyncio
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch import chaos
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.connection import ConnectionManager
from sentinel_tpu_torch.cluster.token_service import TokenService
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.metrics.profiler import ProfilerHook
from sentinel_tpu_torch.metrics.server import server_metrics
from sentinel_tpu_torch.overload import AdmissionController, BrownoutLevel
from sentinel_tpu_torch.trace import ring as _TR
from sentinel_tpu_torch.trace.slo import slo_plane as _slo_plane

_SM = server_metrics()
_OVERLOAD = int(TokenStatus.OVERLOAD)
_STANDBY = int(TokenStatus.STANDBY)


class _BatchFrame:
    """A decoded BATCH_FLOW request frame awaiting its verdict slice."""

    __slots__ = ("xid", "flow_ids", "counts", "prios", "deadline_ms")

    def __init__(self, payload: bytes):
        self.xid, self.flow_ids, self.counts, self.prios = (
            P.decode_batch_request(payload)
        )
        # rev-2 relative deadline trailer (0 = none declared)
        self.deadline_ms = P.decode_batch_deadline(payload)


class _LoopWorker:
    """One event loop: acceptor + per-connection readers + micro-batcher."""

    def __init__(self, server: "TokenServer", index: int):
        self.server = server
        self.index = index
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.queue: Optional[asyncio.Queue] = None
        self.inflight = 0  # _process tasks alive (loop-thread only)
        self.thread: Optional[threading.Thread] = None
        self.aserver: Optional[asyncio.AbstractServer] = None
        self.started = threading.Event()
        self.start_error: Optional[BaseException] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.thread = threading.Thread(
            target=self._run, name=f"sentinel-token-server-{self.index}",
            daemon=True,
        )
        self.thread.start()

    def stop(self) -> None:
        loop = self.loop
        self.loop = None
        if loop is not None:
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass  # loop already stopped itself (failed bind) or closed
        if self.thread is not None:
            self.thread.join(timeout=5)
            self.thread = None
        self.started.clear()

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self.loop = loop
        self.queue = asyncio.Queue()
        loop.create_task(self._serve())
        loop.create_task(self._batcher())
        try:
            loop.run_forever()
        finally:
            if self.aserver is not None:
                self.aserver.close()
            tasks = asyncio.all_tasks(loop)
            for task in tasks:
                task.cancel()
            if tasks:
                try:
                    loop.run_until_complete(
                        asyncio.gather(*tasks, return_exceptions=True)
                    )
                except RuntimeError:
                    pass  # a concurrent stop() interrupted the drain
            loop.close()

    async def _serve(self) -> None:
        srv = self.server
        try:
            # SO_REUSEPORT spreads incoming connections across the workers'
            # listening sockets in the kernel — no user-space handoff
            self.aserver = await asyncio.start_server(
                self._on_connection, srv.host, srv.port,
                reuse_port=(srv.n_loops > 1),
            )
        except OSError as e:
            self.start_error = e
            self.started.set()
            asyncio.get_event_loop().stop()
            return
        addr = self.aserver.sockets[0].getsockname()
        srv.port = addr[1]  # resolve port 0 → actual (worker 0 binds first)
        if self.index == 0:
            record_log.info(
                "token server listening on %s:%d (%d loops)",
                addr[0], addr[1], srv.n_loops,
            )
        self.started.set()

    # -- per-connection reader ---------------------------------------------
    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        srv = self.server
        frames = P.FrameReader()
        peer = writer.get_extra_info("peername")
        address = f"{peer[0]}:{peer[1]}" if peer else repr(writer)
        repl_session = None  # per-connection rev-3 chunk reassembly, lazy
        move_session = None  # per-connection rev-4 move channel, lazy
        loop = asyncio.get_running_loop()
        srv.connections.attach_closer(
            address, lambda: loop.call_soon_threadsafe(writer.close)
        )
        # rev-7 push sink: emitters run on arbitrary threads (lease sweep,
        # breaker scan, brownout eval), so frames hop onto this loop and
        # ride the connection's reply lane via the same non-blocking
        # writer.write the verdict flushes use — a push never waits and
        # never blocks a verdict
        srv.push_hub.attach(
            address,
            lambda frame: loop.call_soon_threadsafe(writer.write, frame),
        )
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                try:
                    payloads = frames.feed(data)
                except ValueError:
                    record_log.warning("oversized frame from client; closing")
                    return
                for payload in payloads:
                    if chaos.ARMED and chaos.should("frame_drop"):
                        # the frame vanishes pre-decode; only the client's
                        # timeout resolves it (the invariant under test)
                        _SM.count_shed("chaos_drop", 1)
                        continue
                    mtype = P.peek_type(payload)
                    if mtype in P.REPL_TYPES:
                        # wire rev 3 (replication control plane): the
                        # primary's sender speaks to this door directly.
                        # Non-standby servers close — a repl frame here
                        # means a misconfigured sender.
                        if srv.applier is None:
                            record_log.warning(
                                "repl frame on non-standby server; closing"
                            )
                            return
                        if repl_session is None:
                            repl_session = srv.applier.connection()
                        try:
                            repl_session.handle(payload, writer.write)
                        except ValueError:
                            record_log.warning("torn repl stream; closing")
                            return
                        await writer.drain()
                        continue
                    if mtype in P.MOVE_TYPES:
                        # wire rev 4 (live-move control plane): a source
                        # server's MoveCoordinator drains a namespace into
                        # this one. Routed like the repl channel; the
                        # session discards staged state on disconnect.
                        if move_session is None:
                            # a move channel is no token client: keep the
                            # push plane off it, as the native door does
                            srv.push_hub.detach(address)
                            move_session = srv.move_target.connection()
                        try:
                            move_session.handle(payload, writer.write)
                        except ValueError:
                            record_log.warning("torn move stream; closing")
                            return
                        await writer.drain()
                        continue
                    if mtype in P.LEASE_TYPES:
                        # wire rev 5 (client-local admission): lease ops are
                        # control-plane-rare (one per TTL per hot flow), so
                        # they skip the micro-batch queue and run the
                        # service's host-side grant/renew/return directly —
                        # to_thread keeps the device fold off the event loop
                        try:
                            (xid, lmt, lease_id, lflow, used, want) = (
                                P.decode_lease_request(payload)
                            )
                        except Exception:
                            record_log.warning(
                                "bad lease frame from client; closing"
                            )
                            return
                        srv.connections.touch(address)
                        if _TR.ARMED:  # flight recorder: lease control hop
                            _TR.record(
                                _TR.LEASE, xid=xid, shard=self.index,
                                aux=want,
                            )
                        if srv.is_standby:
                            # proof-of-life refusal, same contract as the
                            # decision path: the client falls back to
                            # per-request RPCs and the failover layer never
                            # evicts this endpoint
                            writer.write(P.encode_lease_response(
                                xid, lmt, _STANDBY
                            ))
                            await writer.drain()
                            continue
                        if lmt == P.MsgType.LEASE_GRANT:
                            res = await asyncio.to_thread(
                                srv.service.lease_grant, lflow, want
                            )
                        elif lmt == P.MsgType.LEASE_RENEW:
                            res = await asyncio.to_thread(
                                srv.service.lease_renew,
                                lease_id, lflow, used, want,
                            )
                        else:
                            res = await asyncio.to_thread(
                                srv.service.lease_return, lease_id, used
                            )
                        writer.write(P.encode_lease_response(
                            xid, lmt, int(res.status),
                            lease_id=res.lease_id, tokens=res.tokens,
                            ttl_ms=res.ttl_ms, endpoint=res.endpoint,
                        ))
                        await writer.drain()
                        continue
                    if mtype in P.HIER_TYPES:
                        # hierarchy tier: pod share agents leasing from the
                        # co-located global budget coordinator. Control-
                        # plane-rare (one frame per agent tick); the
                        # coordinator is a host-side ledger, so to_thread
                        # keeps its lock wait off the event loop.
                        hier = srv.service.hierarchy
                        try:
                            if mtype == P.MsgType.DEMAND_REPORT:
                                xid, pod_id, entries = (
                                    P.decode_demand_report(payload)
                                )
                                hmt = P.MsgType.DEMAND_REPORT
                                args = (pod_id, entries)
                            else:
                                (xid, hmt, share_id, hflow, used, want) = (
                                    P.decode_lease_request(payload)
                                )
                                args = (share_id, hflow, used, want)
                        except Exception:
                            record_log.warning(
                                "bad hier frame from agent; closing"
                            )
                            return
                        srv.connections.touch(address)
                        if _TR.ARMED:  # flight recorder: hierarchy hop
                            _TR.record(_TR.HIER, xid=xid, shard=self.index)
                        if srv.is_standby:
                            writer.write(P.encode_lease_response(
                                xid, hmt, _STANDBY
                            ))
                            await writer.drain()
                            continue
                        if hier is None:
                            # no coordinator co-located here: refuse, the
                            # agent's failover walk tries the next endpoint
                            writer.write(P.encode_lease_response(
                                xid, hmt, P.NOT_LEASABLE_STATUS
                            ))
                            await writer.drain()
                            continue
                        if hmt == P.MsgType.DEMAND_REPORT:
                            res = await asyncio.to_thread(
                                hier.handle_demand_report, *args
                            )
                        elif hmt == P.MsgType.SHARE_GRANT:
                            res = await asyncio.to_thread(
                                hier.share_grant, args[1], args[3]
                            )
                        elif hmt == P.MsgType.SHARE_RENEW:
                            res = await asyncio.to_thread(
                                hier.share_renew,
                                args[0], args[1], args[2], args[3],
                            )
                        else:
                            res = await asyncio.to_thread(
                                hier.share_return, args[0], args[2]
                            )
                        writer.write(P.encode_lease_response(
                            xid, hmt, int(res.status),
                            lease_id=res.lease_id, tokens=res.tokens,
                            ttl_ms=res.ttl_ms, endpoint=res.endpoint,
                        ))
                        await writer.drain()
                        continue
                    if mtype in P.OUTCOME_TYPES:
                        # wire rev 6 (outcome feedback): a client's coalesced
                        # completion report, piggy-backed ahead of its next
                        # request frame. Fire-and-forget — NO response frame,
                        # so the lease/request fast path never waits on it.
                        try:
                            oxid, ofids, orts, oexcs = (
                                P.decode_outcome_report(payload)
                            )
                        except Exception:
                            record_log.warning("bad outcome frame; closing")
                            return
                        srv.connections.touch(address)
                        if srv.is_standby:
                            # outcome columns replicate from the primary;
                            # counting here would double on promotion
                            continue
                        await asyncio.to_thread(
                            srv.service.report_outcomes,
                            ofids, orts, oexcs, oxid,
                        )
                        continue
                    if mtype == P.MsgType.BATCH_FLOW:
                        # vectorized decode; no per-request Python objects
                        try:
                            item = _BatchFrame(payload)
                        except Exception:
                            record_log.warning("bad batch frame; closing")
                            return
                        srv.connections.touch(address)
                        k = len(item.flow_ids)
                        if _TR.ARMED:  # flight recorder: frame decoded
                            _TR.record(
                                _TR.CLIENT_IN, xid=item.xid,
                                shard=self.index, aux=k,
                            )
                        if srv.is_standby:
                            # redirect-style refusal: this node replicates
                            # from a live primary and must not double-count
                            # — the failover client walks on (STANDBY is
                            # proof of life, not failure)
                            writer.write(
                                P.encode_batch_response(
                                    item.xid,
                                    np.full(k, _STANDBY, np.int8),
                                    np.zeros(k, np.int32),
                                    np.zeros(k, np.int32),
                                )
                            )
                            await writer.drain()
                            continue
                        if (
                            srv.max_queue
                            and self.queue.qsize() >= srv.max_queue
                        ):
                            # queue full: an explicit OVERLOAD answer NOW
                            # beats silently queueing past the client's
                            # budget (the old failure mode: timeout + a
                            # mis-charged failover breaker)
                            _SM.count_shed("queue_full", k)
                            if _TR.ARMED:
                                _TR.record(
                                    _TR.SHED, xid=item.xid,
                                    shard=self.index, aux=k,
                                )
                            _slo_plane().record_shed_indexed(
                                *srv.service.namespace_index(item.flow_ids),
                                reason="queue_full",
                            )
                            writer.write(
                                P.encode_batch_response(
                                    item.xid,
                                    np.full(k, _OVERLOAD, np.int8),
                                    np.zeros(k, np.int32),
                                    np.full(
                                        k, srv.overload.retry_hint_ms,
                                        np.int32,
                                    ),
                                )
                            )
                            await writer.drain()
                            continue
                        deadline = (
                            loop.time() + item.deadline_ms / 1000.0
                            if item.deadline_ms
                            else None
                        )
                        srv.overload.note_enqueued(k)
                        if _TR.ARMED:  # flight recorder: queued for batch
                            _TR.record(
                                _TR.ENQUEUE, xid=item.xid,
                                shard=self.index, aux=self.queue.qsize(),
                            )
                        await self.queue.put(
                            (item, writer, loop.time(), deadline)
                        )
                        continue
                    try:
                        req = P.decode_request(payload)
                    except Exception:
                        record_log.warning("bad frame from client; closing")
                        return
                    if isinstance(req, P.Ping):
                        # handshake: bind this connection to its namespace
                        # group; answer with the group's connected count
                        # (TokenServerHandler.handlePingRequest). Also
                        # refreshes the connection's liveness for the idle
                        # sweep (ScanIdleConnectionTask analog).
                        count = srv.connections.add(req.namespace, address)
                        writer.write(
                            P.encode_response(
                                P.FlowResponse(
                                    req.xid, P.MsgType.PING, 0,
                                    remaining=count,
                                )
                            )
                        )
                        await writer.drain()
                    else:
                        srv.connections.touch(address)
                        if srv.is_standby:
                            writer.write(
                                P.encode_response(
                                    P.FlowResponse(
                                        req.xid, req.msg_type, _STANDBY,
                                        0, 0,
                                    )
                                )
                            )
                            await writer.drain()
                            continue
                        if (
                            srv.max_queue
                            and self.queue.qsize() >= srv.max_queue
                        ):
                            _SM.count_shed("queue_full", 1)
                            writer.write(
                                P.encode_response(
                                    P.FlowResponse(
                                        req.xid, req.msg_type, _OVERLOAD,
                                        0, srv.overload.retry_hint_ms,
                                    )
                                )
                            )
                            await writer.drain()
                            continue
                        srv.overload.note_enqueued(1)
                        await self.queue.put(
                            (req, writer, loop.time(), None)
                        )
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            if move_session is not None:
                # a source that died mid-move must not leave a staged
                # claim behind (crash matrix: dest discards, source owns)
                move_session.closed()
            srv.push_hub.detach(address)
            srv.connections.remove_address(address)
            try:
                writer.close()
            except Exception:
                pass

    # -- micro-batcher ------------------------------------------------------
    async def _batcher(self) -> None:
        """Adaptive micro-batching with bounded in-flight steps.

        While a device step is in flight, new arrivals pile up in the queue
        and the next iteration drains them all in one go — so batches grow
        naturally with load and a lone request under light load pays ZERO
        batching delay. A fixed collect window (``batch_window_ms > 0``) is
        still honored for callers that prefer bigger batches over tail
        latency.

        Up to ``srv.max_inflight`` batches are processed CONCURRENTLY
        (``_process`` runs as a task gated by a semaphore): with CUDA's async
        dispatch, batch k+1's host prep and dispatch overlap batch k's
        device execution and response encode — the device never waits for
        Python between steps. Responses are xid-correlated, so cross-batch
        completion order is free to vary.
        """
        srv = self.server
        sem = asyncio.Semaphore(max(1, srv.max_inflight))
        loop = asyncio.get_running_loop()
        while True:
            first = await self.queue.get()
            if chaos.ARMED:  # lane_delay: a descheduled batcher
                d = chaos.delay_s("lane_delay")
                if d:
                    await asyncio.sleep(d)
            # item = (request, writer, t_enqueued, abs_deadline | None)
            batch: List[Tuple[object, asyncio.StreamWriter, float, object]] = [
                first
            ]
            total = self._n_requests(first[0])
            while total < srv.max_batch:
                try:
                    item = self.queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                batch.append(item)
                total += self._n_requests(item[0])
            if srv.batch_window_ms > 0:
                deadline = (
                    asyncio.get_event_loop().time()
                    + srv.batch_window_ms / 1000.0
                )
                while total < srv.max_batch:
                    timeout = deadline - asyncio.get_event_loop().time()
                    if timeout <= 0:
                        break
                    try:
                        item = await asyncio.wait_for(
                            self.queue.get(), timeout=timeout
                        )
                    except asyncio.TimeoutError:
                        break
                    batch.append(item)
                    total += self._n_requests(item[0])
            # stage metrics: enqueue→drain wait per queue item (one frame =
            # one item, so this stays O(items), not O(requests)) + the batch
            # size distribution the adaptive batcher actually produced
            t_drain = loop.time()
            for queued_item in batch:
                _SM.queue_wait_ms.record(
                    (t_drain - queued_item[2]) * 1e3,
                    self._n_requests(queued_item[0]),
                )
            _SM.batch_size.record(total)
            await sem.acquire()
            self.inflight += 1
            task = loop.create_task(self._process(batch, total))

            def _done(_t):
                self.inflight -= 1
                sem.release()

            task.add_done_callback(_done)

    @staticmethod
    def _n_requests(item) -> int:
        if isinstance(item, _BatchFrame):
            return len(item.flow_ids)
        return 1

    async def _process(self, batch, total: int) -> None:
        try:
            await self._process_inner(batch)
        finally:
            # inflight accounting covers enqueue → answered/shed; the BBR
            # gate reads it as the pipeline's concurrency
            self.server.overload.note_done(total)

    async def _process_inner(self, batch) -> None:
        srv = self.server
        service = srv.service
        # deadline shed: a frame whose client budget is already blown gets
        # DROPPED, not served — the client stopped waiting, so a verdict
        # would only burn a device slot (and an OVERLOAD answer would race
        # a closed socket). Counted so the drop is never invisible.
        now = asyncio.get_running_loop().time()
        live = []
        for entry in batch:
            deadline = entry[3]
            if deadline is not None and now > deadline:
                _SM.count_shed("deadline", self._n_requests(entry[0]))
                continue
            live.append(entry)
        batch = live
        if not batch:
            return
        # split by kind: FLOW singles + BATCH_FLOW frames share one device
        # step; param requests go to the param sketch path; concurrent
        # acquire/release to the host-side semaphore path
        flow_singles: List[Tuple[int, P.FlowRequest]] = []
        batch_frames: List[Tuple[int, _BatchFrame]] = []
        for i, (item, _w, _t, _dl) in enumerate(batch):
            if isinstance(item, _BatchFrame):
                batch_frames.append((i, item))
            elif item.msg_type == P.MsgType.FLOW:
                flow_singles.append((i, item))

        results: Dict[int, Tuple[int, int, int, int]] = {}
        frame_slices: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        n_flow = len(flow_singles) + sum(
            len(f.flow_ids) for _, f in batch_frames
        )
        if n_flow:
            ids_parts, cnt_parts, prio_parts = [], [], []
            for _, f in batch_frames:
                ids_parts.append(f.flow_ids)
                cnt_parts.append(f.counts)
                prio_parts.append(f.prios)
            if flow_singles:
                ids_parts.append(
                    np.fromiter(
                        (r.flow_id for _, r in flow_singles), np.int64,
                        len(flow_singles),
                    )
                )
                cnt_parts.append(
                    np.fromiter(
                        (r.count for _, r in flow_singles), np.int32,
                        len(flow_singles),
                    )
                )
                prio_parts.append(
                    np.fromiter(
                        (r.prioritized for _, r in flow_singles), bool,
                        len(flow_singles),
                    )
                )
            flow_ids = ids_parts[0] if len(ids_parts) == 1 else np.concatenate(ids_parts)
            counts = cnt_parts[0] if len(cnt_parts) == 1 else np.concatenate(cnt_parts)
            prios = prio_parts[0] if len(prio_parts) == 1 else np.concatenate(prio_parts)
            # brownout gate (BBR admission, overload/admission.py): SHED_LOW
            # refuses the non-prioritized rows with OVERLOAD and serves the
            # rest; DEGRADE skips the device entirely and answers locally
            # (probabilistic pass / OVERLOAD). Shed rows are still ANSWERED
            # — one response frame per request frame, always.
            level = srv.overload.level()
            ns_fn = service.namespace_index
            if level >= BrownoutLevel.DEGRADE:
                shed = srv.overload.shed_mask(prios, level)
                status, remaining, wait = srv.overload.degrade_verdicts(shed)
                _SM.count_shed("degrade", int(shed.sum()))
                # per-tenant attribution: degrade answers locally, so the
                # verdict counters (and the SLO shed plane underneath)
                # resolve namespaces here instead of on the device path
                _SM.record_verdict_batch(status, *ns_fn(flow_ids))
                keep = None
            else:
                keep = None
                if level >= BrownoutLevel.SHED_LOW:
                    # tenant attribution up front so the shed is
                    # share-weighted when shares are configured
                    ns_pair = ns_fn(flow_ids)
                    m = srv.overload.shed_mask(
                        prios, level, ns_idx=ns_pair[0], ns_names=ns_pair[1]
                    )
                    if m.any():
                        keep = np.nonzero(~m)[0]
                        _SM.count_shed("brownout", n_flow - keep.size)
                        if ns_pair[0] is not None:
                            _slo_plane().record_shed_indexed(
                                ns_pair[0][m], ns_pair[1], reason="brownout"
                            )
                d_ids, d_cnts, d_prios = (
                    (flow_ids, counts, prios)
                    if keep is None
                    else (flow_ids[keep], counts[keep], prios[keep])
                )
                d_n = len(d_ids)
                if _TR.ARMED and batch_frames:
                    _TR.record_many(
                        _TR.DISPATCH, [f.xid for _i, f in batch_frames],
                        shard=self.index, aux=d_n,
                    )
                t_decide = time.perf_counter()
                try:
                    if d_n == 0:
                        status = np.empty(0, np.int8)
                        remaining = np.empty(0, np.int32)
                        wait = np.empty(0, np.int32)
                    else:
                        # dispatch INLINE on the loop thread: host prep and
                        # the asynchronous launches only, so device steps
                        # start in batch order even when several _process
                        # tasks are in flight. Materialization (blocks on
                        # the device) hops to a worker thread for large
                        # steps so the loop keeps pumping frames and the
                        # next batch's dispatch overlaps this step's
                        # execution.
                        materialize = service.dispatch_batch_arrays(
                            d_ids, d_cnts, d_prios
                        )
                        if d_n <= srv.inline_below and self.inflight == 1:
                            # small LONE step: the two executor hops of
                            # to_thread cost more than the step blocks the loop
                            # for. Only when nothing else is in flight — device
                            # state chains serially, so an inline materialize
                            # behind another task's large step would block the
                            # loop for the predecessor's duration too.
                            status, remaining, wait = materialize()
                        else:
                            status, remaining, wait = await asyncio.to_thread(
                                materialize
                            )
                except Exception:
                    record_log.exception("device step failed; failing batch")
                    status = np.full(d_n, int(TokenStatus.FAIL), np.int8)
                    remaining = np.zeros(d_n, np.int32)
                    wait = np.zeros(d_n, np.int32)
                _SM.decide_ms.record((time.perf_counter() - t_decide) * 1e3)
                if keep is not None:
                    # scatter the served subset back; shed rows answer
                    # OVERLOAD with the retry hint
                    st = np.full(n_flow, _OVERLOAD, np.int8)
                    rm = np.zeros(n_flow, np.int32)
                    wt = np.full(
                        n_flow, srv.overload.retry_hint_ms, np.int32
                    )
                    st[keep] = status
                    rm[keep] = remaining
                    wt[keep] = wait
                    status, remaining, wait = st, rm, wt
            off = 0
            for i, f in batch_frames:
                k = len(f.flow_ids)
                frame_slices[i] = (
                    status[off : off + k],
                    remaining[off : off + k],
                    wait[off : off + k],
                )
                off += k
            for j, (i, _) in enumerate(flow_singles):
                results[i] = (
                    int(status[off + j]), int(remaining[off + j]),
                    int(wait[off + j]), 0,
                )

        async def run_one(i: int, req) -> None:
            # overlapped thread hops: the service locks still serialize the
            # critical sections, but responses aren't head-of-line blocked
            try:
                if req.msg_type == P.MsgType.PARAM_FLOW:
                    r = await asyncio.to_thread(
                        service.request_params_token,
                        req.flow_id, req.count, req.param_hashes,
                    )
                    results[i] = (int(r.status), r.remaining, r.wait_ms, 0)
                elif req.msg_type == P.MsgType.CONCURRENT_ACQUIRE:
                    r = await asyncio.to_thread(
                        service.request_concurrent_token,
                        req.flow_id, req.count, req.prioritized,
                    )
                    results[i] = (int(r.status), r.remaining, r.wait_ms, r.token_id)
                elif req.msg_type == P.MsgType.CONCURRENT_RELEASE:
                    # flow_id slot carries the token id (protocol docstring)
                    r = await asyncio.to_thread(
                        service.release_concurrent_token, req.flow_id
                    )
                    results[i] = (int(r.status), 0, 0, 0)
            except Exception:
                record_log.exception("%s request failed", req.msg_type.name)
                results[i] = (int(TokenStatus.FAIL), 0, 0, 0)

        host_side = [
            (i, req)
            for i, (req, _w, _t, _dl) in enumerate(batch)
            if not isinstance(req, _BatchFrame)
            and req.msg_type != P.MsgType.FLOW
        ]
        is_host_side = {i for i, _ in host_side}

        async def write_out(indices) -> None:
            t_write = time.perf_counter()
            writers_to_drain = set()
            # batch frames group per writer: ONE vectorized multi-frame
            # encode (encode_batch_responses) and one socket write per
            # client instead of one of each per frame
            grouped: dict = {}  # writer → (xids, counts, verdict slices)
            for i in indices:
                item, writer, _t_enq, _dl = batch[i]
                try:
                    if isinstance(item, _BatchFrame):
                        sliced = frame_slices.get(i)
                        if sliced is None:  # only when the frame was empty
                            k = len(item.flow_ids)
                            sliced = (
                                np.full(k, int(TokenStatus.FAIL), np.int8),
                                np.zeros(k, np.int32),
                                np.zeros(k, np.int32),
                            )
                        g = grouped.setdefault(writer, ([], [], []))
                        g[0].append(item.xid)
                        g[1].append(len(sliced[0]))
                        g[2].append(sliced)
                    else:
                        st, remaining, wait, token_id = results.get(
                            i, (int(TokenStatus.FAIL), 0, 0, 0)
                        )
                        endpoint = ""
                        if st == int(TokenStatus.MOVED):
                            # rev 4: single responses carry the new owner
                            # as a UTF-8 trailer so a redirected client
                            # needs no shard-map fetch to follow
                            red = service.moved_redirect(item.flow_id)
                            endpoint = red[0] if red else ""
                        writer.write(
                            P.encode_response(
                                P.FlowResponse(
                                    item.xid, item.msg_type, st, remaining,
                                    wait, token_id, endpoint,
                                )
                            )
                        )
                        writers_to_drain.add(writer)
                        if _TR.ARMED:
                            _TR.record(
                                _TR.REPLY_OUT, xid=item.xid,
                                shard=self.index,
                            )
                except Exception:
                    pass
            for writer, (xids, counts, slices) in grouped.items():
                try:
                    # scatter encode into the connection's reused buffer
                    # (out=): the transport copies what it can't send
                    # synchronously before write() returns, so recycling
                    # the bytearray on the next flush is safe
                    buf = srv._writer_bufs.get(writer)
                    if buf is None:
                        buf = bytearray()
                        srv._writer_bufs[writer] = buf
                    writer.write(
                        P.encode_batch_responses(
                            xids, counts,
                            np.concatenate([s[0] for s in slices]),
                            np.concatenate([s[1] for s in slices]),
                            np.concatenate([s[2] for s in slices]),
                            out=buf,
                        )
                    )
                    writers_to_drain.add(writer)
                except Exception:
                    pass
            for writer in writers_to_drain:
                try:
                    await writer.drain()
                except Exception:
                    pass
            if _TR.ARMED and grouped:  # flight recorder: replies flushed
                for _w, (xids, counts, _s) in grouped.items():
                    _TR.record_many(
                        _TR.REPLY_OUT, xids, shard=self.index,
                    )
            _SM.write_ms.record((time.perf_counter() - t_write) * 1e3)

        # flow verdicts go out the moment they're materialized, CONCURRENT
        # with the host-side (param/concurrent) work — neither plane may
        # queue behind the other (a stalled flow client's drain must not
        # delay another client's CONCURRENT_RELEASE, and vice versa;
        # responses are xid-correlated, order-free)
        async def host_side_then_write() -> None:
            await asyncio.gather(*(run_one(i, req) for i, req in host_side))
            await write_out(is_host_side)

        flow_write = write_out(
            i for i in range(len(batch)) if i not in is_host_side
        )
        if host_side:
            await asyncio.gather(flow_write, host_side_then_write())
        else:
            await flow_write


class TokenServer:
    def __init__(
        self,
        service: TokenService,
        host: str = "127.0.0.1",
        port: int = 18730,
        batch_window_ms: float = 0.0,
        max_batch: int = 1024,
        inline_below: int = 64,
        n_loops: int = 1,
        max_inflight: int = 2,
        idle_ttl_s: Optional[float] = 600.0,
        profile_dir: Optional[str] = None,
        metrics_port: Optional[int] = None,
        snapshot_dir: Optional[str] = None,
        snapshot_period_s: Optional[float] = None,
        max_queue: int = 8192,
        overload: Optional[AdmissionController] = None,
        standby_of: Optional[str] = None,
        promote_after_ms: Optional[float] = None,
        replicate_to: Optional[Sequence] = None,
        repl_interval_ms: Optional[float] = None,
        push: bool = True,
    ):
        self.service = service
        self.host = host
        self.port = port
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        # per-loop bound on queued frames: at capacity the front door
        # answers OVERLOAD immediately instead of queueing past every
        # client's budget (0 disables the bound)
        self.max_queue = max(0, int(max_queue))
        # BBR-style admission gate + brownout ladder (overload/admission.py);
        # pass a configured controller to tune headroom, or one with
        # enabled=False to opt out
        self.overload = (
            overload if overload is not None else AdmissionController()
        )
        # flow batches at or under this size dispatch inline on the loop
        # thread (sub-ms step; executor hops would dominate); larger ones go
        # through to_thread so the IO loop keeps pumping during the step
        self.inline_below = inline_below
        self.n_loops = max(1, int(n_loops))
        # batches processed concurrently per loop (device pipelining depth);
        # 2 keeps one step executing while the next preps/dispatches
        self.max_inflight = max(1, int(max_inflight))
        self.idle_ttl_s = idle_ttl_s
        self._workers: List[_LoopWorker] = []
        # namespace-scoped connection groups (ConnectionManager.java:35);
        # counts feed the service's AVG_LOCAL threshold scaling
        self.connections = ConnectionManager(
            on_count_changed=self.service.connected_count_changed
        )
        self._idle_task = None
        # optional serving-loop profiling: a torch.profiler trace spanning
        # start()→stop() captures every device step the micro-batchers
        # dispatch.
        # Also honored from the env so an operator can profile a live
        # deployment without code changes.
        self.profile_dir = profile_dir or os.environ.get(
            "SENTINEL_PROFILE_DIR"
        ) or None
        # on-demand trace control for the cluster/server/profiler command;
        # start() opens an always-on trace through it when profile_dir is set
        self.profiler = ProfilerHook(default_dir=self.profile_dir)
        # optional standalone Prometheus endpoint (its own port); 0 picks an
        # ephemeral port, resolved at start()
        self.metrics_port = metrics_port
        self._metrics_exporter = None
        self._gauge_fns: Dict[str, object] = {}
        # HA state snapshots (ha.snapshot): with a directory
        # set, start() restores the newest artifact into a COLD service and
        # arms the periodic writer; stop() takes a final save. Honored from
        # the env too so an operator can arm it without code changes.
        self.snapshot_dir = snapshot_dir or os.environ.get(
            "SENTINEL_SNAPSHOT_DIR"
        ) or None
        self.snapshot_period_s = snapshot_period_s
        self._snapshots = None
        # warm-standby replication roles (ha.replication). standby_of= makes
        # this a STANDBY: the front door answers data-plane traffic with
        # TokenStatus.STANDBY until promoted, while rev-3 frames from the
        # primary named here (informational label) stream state in through
        # a StandbyApplier. replicate_to= makes this a PRIMARY shipping
        # deltas to the listed standby addresses. The roles compose — a
        # promoted standby can itself replicate onward — but a server is
        # normally one or the other.
        self.standby_of = standby_of
        self.promote_after_ms = promote_after_ms
        self.replicate_to = list(replicate_to) if replicate_to else None
        self.repl_interval_ms = repl_interval_ms
        self.applier = None  # StandbyApplier while in standby mode
        self.replicator = None  # ReplicationSender while primary
        # live-move destination side (cluster.rebalance): every server can
        # receive a namespace over the rev-4 move channel; staging only,
        # nothing mutates until MOVE_COMMIT
        from sentinel_tpu_torch.cluster.rebalance import MoveTarget

        self.move_target = MoveTarget(service)
        # per-connection scatter-encode buffers: encode_batch_responses
        # lays each writer's grouped verdict frames into its reused
        # bytearray (out=) instead of allocating a bytes blob per flush;
        # weak keys let a closed connection's buffer fall away with it
        import weakref

        self._writer_bufs = weakref.WeakKeyDictionary()
        # rev-7 push plane (cluster.push): per-connection sinks feed
        # unsolicited server→client frames down the same reply lanes the
        # verdict writes use. The hub attaches to the service so lease
        # revocations / breaker flips / rule-epoch bumps go out the moment
        # they happen, and to the admission gate so brownout transitions
        # ride along as advisories. push=False disarms every emit (the
        # drills' push-dark phases).
        from sentinel_tpu_torch.cluster.push import PushHub

        self.push_hub = PushHub(enabled=push)
        self.service.attach_push_hub(self.push_hub)
        self.overload.on_level_change = (
            lambda level, retry_ms: self.push_hub.push_brownout(
                level, retry_ms
            )
        )

    def tuning_kwargs(self) -> dict:
        """Operator-tunable constructor kwargs, for rebuilding this server on
        a port move (command or datasource driven) without silently resetting
        live tuning to defaults."""
        return dict(
            batch_window_ms=self.batch_window_ms,
            max_batch=self.max_batch,
            inline_below=self.inline_below,
            n_loops=self.n_loops,
            max_inflight=self.max_inflight,
            idle_ttl_s=self.idle_ttl_s,
            profile_dir=self.profile_dir,
            metrics_port=self.metrics_port,
            snapshot_dir=self.snapshot_dir,
            snapshot_period_s=self.snapshot_period_s,
            max_queue=self.max_queue,
            overload=self.overload,
            standby_of=self.standby_of,
            promote_after_ms=self.promote_after_ms,
            replicate_to=self.replicate_to,
            repl_interval_ms=self.repl_interval_ms,
            push=self.push_hub.enabled,
        )

    # -- warm-standby role ---------------------------------------------------
    @property
    def is_standby(self) -> bool:
        """True while the front door refuses data-plane traffic (standby
        mode, not yet promoted)."""
        applier = self.applier
        return applier is not None and not applier.promoted

    def promote(self, reason: str = "manual") -> bool:
        """Open the front door of a standby. Returns False when this server
        is not a standby or is already promoted."""
        if self.applier is None:
            return False
        return self.applier.promote(reason)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._workers:
            return
        # the port's wire codec is numpy: this door needs no native library
        self.service.warmup()  # build the decision steps before traffic
        if self.snapshot_dir:
            from sentinel_tpu_torch.ha.snapshot import restore_latest

            # only a COLD service restores (no rules loaded yet): a port
            # move reuses a live service whose in-memory state is newer
            # than any artifact on disk
            if not self.service.current_rules():
                restore_latest(self.service, self.snapshot_dir)
        self.service.reopen()  # re-arm sweeps a prior stop() released
        if self.standby_of is not None and self.applier is None:
            from sentinel_tpu_torch.ha.replication import StandbyApplier

            # armed BEFORE the listener: the first frame a standby sees may
            # be the primary's REPL_HELLO
            self.applier = StandbyApplier(
                self.service, promote_after_ms=self.promote_after_ms,
            ).start()
        if self.profile_dir:
            try:
                self.profiler.start(self.profile_dir)
            except Exception:
                record_log.exception("profiler start failed; serving anyway")
        if self.n_loops > 1 and not hasattr(socket, "SO_REUSEPORT"):
            record_log.warning("SO_REUSEPORT unavailable; forcing n_loops=1")
            self.n_loops = 1
        # workers start sequentially: worker 0 resolves port 0 → a real port
        # the rest bind with reuse_port
        for i in range(self.n_loops):
            worker = _LoopWorker(self, i)
            self._workers.append(worker)
            worker.start()
            ok = worker.started.wait(timeout=5)
            if worker.start_error is not None or not ok:
                err = worker.start_error
                # unwind ONLY what this failed start created — the caller's
                # service stays usable (its close() is for a started server)
                workers, self._workers = self._workers, []
                for w in workers:
                    w.stop()
                raise RuntimeError(f"token server failed to start: {err}") from err
        if self.idle_ttl_s:
            from sentinel_tpu_torch.cluster.connection import IdleConnectionSweeper

            self._idle_task = IdleConnectionSweeper(
                self.connections, ttl_s=self.idle_ttl_s
            )
            self._idle_task.start()
        # live gauges: scrape-time reads off the running workers (queue.qsize
        # is loop-thread-unsafe only for mutation; a racy read is fine for a
        # gauge). Registered per start() and torn down matched in stop() so
        # a replacement server's readers survive the old one's teardown.
        self._gauge_fns = {
            "queue_depth": lambda: sum(
                w.queue.qsize() for w in self._workers if w.queue is not None
            ),
            "inflight_batches": lambda: sum(
                w.inflight for w in self._workers
            ),
            "connections": lambda: sum(
                len(addrs) for addrs in self.connections.snapshot().values()
            ),
        }
        for name, fn in self._gauge_fns.items():
            _SM.register_gauge(name, fn)
        # hub half of the clusterServerStats `push` block (most recently
        # started door wins — same single-slot contract as the other
        # providers)
        _SM.register_push_provider(self.push_hub.stats)
        if self.metrics_port is not None:
            from sentinel_tpu_torch.metrics.exporter import PrometheusExporter

            self._metrics_exporter = PrometheusExporter(
                host="0.0.0.0", port=self.metrics_port
            ).start()
            self.metrics_port = self._metrics_exporter.port  # resolve port 0
        if self.snapshot_dir:
            from sentinel_tpu_torch.ha.snapshot import SnapshotManager

            self._snapshots = SnapshotManager(
                self.service, self.snapshot_dir,
                period_s=self.snapshot_period_s,
            ).start()
        if self.replicate_to:
            from sentinel_tpu_torch.ha.replication import ReplicationSender

            self.replicator = ReplicationSender(
                self.service, self.replicate_to,
                interval_ms=self.repl_interval_ms,
                sender_id=f"{self.host}:{self.port}",
            ).start()

    def stop(self) -> None:
        # replication teardown first: the sender must not race the service
        # close, and a standby's watchdog must not promote mid-shutdown
        if self.replicator is not None:
            self.replicator.stop()
            self.replicator = None
        if self.applier is not None:
            self.applier.stop()
            self.applier = None
        if self._snapshots is not None:
            # final save: the artifact a restarted primary (or a standby
            # picking up this node's directory) restores from
            self._snapshots.stop(final_save=True)
            self._snapshots = None
        if self.profiler.active:
            self.profiler.stop()
        if self._metrics_exporter is not None:
            self._metrics_exporter.stop()
            self._metrics_exporter = None
        for name, fn in self._gauge_fns.items():
            _SM.unregister_gauge(name, fn)
        self._gauge_fns = {}
        if self._idle_task is not None:
            self._idle_task.stop()
            self._idle_task = None
        workers, self._workers = self._workers, []
        for worker in workers:
            worker.stop()
        # symmetric with the warmup hook in start(): release the service's
        # background resources (concurrent-mode expiry sweeper). Embedded
        # users who keep the service alive re-arm it on the next rule load.
        self.service.close()
