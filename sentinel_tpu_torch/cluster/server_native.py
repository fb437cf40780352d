"""Native-front-door token server: C++ epoll data plane, Python device loop.

The port's copy of ``sentinel_tpu/cluster/server_native.py``, serving
``sentinel_tpu_torch``'s :class:`DefaultTokenService` on the card. The whole
per-frame path
(socket reads, length-prefixed framing, BATCH_FLOW/FLOW decode, verdict
frame encode, socket writes, idle reaping) lives in
``native/src/sentinel_frontdoor.cpp``; Python's serving loop is one blocking
``wait_batch`` → ``TokenService.request_batch_arrays`` → ``submit`` cycle
per DEVICE STEP, regardless of how many frames or connections fed it.
This is the netty-pipeline analog (``NettyTransportServer.java:73-101``):
the host's job is to keep the device fed.

Control-plane frames (PING handshake, PARAM_FLOW, CONCURRENT_*) and
open/close events surface through a low-rate poll thread so namespace
connection groups (AVG_LOCAL scaling) and the host-side paths stay exactly
as in the reference's asyncio server.

Serving pipeline: three decoupled lanes with bounded handoff queues,
instead of one thread doing wait→step→submit in series. The **intake
lane** pulls decoded frames from the C++ door and hands copies to the
**device lane**, which drains everything queued (bounded by
``fuse_depth`` pulls of host prep), concatenates it, and issues ONE
dispatch — the token service's fusion ladder then folds full engine
frames into one chained device step, so the fixed per-dispatch host
overhead is paid once per fused group. The CUDA launches are asynchronous
on the default stream, so ``n_dispatchers`` **reply lanes** block on the
verdicts (a device-to-host copy, which waits for the stream), slice them back per pull, and submit — so host-side prep and
reply encoding overlap device time instead of serializing behind it.
Fusion depth adapts to load by construction: an idle queue yields
single-frame dispatches (no added latency), a backed-up queue yields
deep fused steps (max amortization).

High availability, as in the reference door: ``snapshot_dir`` (or
``SENTINEL_SNAPSHOT_DIR``) restores the newest artifact into a cold service
at start and saves one every ``snapshot_period_s`` and at stop;
``replicate_to`` ships the service's dirty rows to warm standbys every
``repl_interval_ms``; ``standby_of`` makes this server a standby, which
applies the rev-3 REPL frames it receives and answers every data-plane and
control verdict ``STANDBY`` (PING still answers, OUTCOME_REPORT is
dropped) until :meth:`NativeTokenServer.promote`, or until its primary has
been silent for ``promote_after_ms``.

The service is probed for no hook: it must have every method the door
calls (:class:`DefaultTokenService` does). A feature of a slice not yet
ported is refused at construction with ``NotImplementedError``:
``metrics_port`` (the Prometheus exporter).

Live namespace moves, as in the reference door: rev-4 MOVE frames route to
the server's :class:`~sentinel_tpu_torch.cluster.rebalance.MoveTarget`, one
session per connection, which stages a moved-in namespace and imports it at
MOVE_COMMIT; a connection that closes, and ``stop()``, discard what its
session staged.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import List, Optional, Sequence

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

_SM = server_metrics()
_OVERLOAD = int(TokenStatus.OVERLOAD)
_STANDBY = int(TokenStatus.STANDBY)


def native_available() -> bool:
    """The reference's name for :func:`native.lib.available`: True once the
    library is built and loaded; a failed build or load raises."""
    from sentinel_tpu_torch.native import lib as native_lib

    return native_lib.available()


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to sentinel_tpu_torch yet (ROADMAP {item})"
    )


class NativeTokenServer:
    def __init__(
        self,
        service: TokenService,
        host: str = "127.0.0.1",
        port: int = 18730,
        max_batch: int = 16384,
        n_dispatchers: int = 2,
        fuse_depth: int = 4,
        max_device_inflight: int = 2,
        intake_shards: int = 1,
        intake_timeout_ms: int = 20,
        idle_ttl_s: Optional[float] = 600.0,
        arena_cap: int = 65536,
        profile_dir: Optional[str] = None,
        metrics_port: Optional[int] = None,
        snapshot_dir: Optional[str] = None,
        snapshot_period_s: Optional[float] = None,
        shed_age_ms: Optional[float] = 1000.0,
        drain_timeout_s: float = 10.0,
        overload: Optional[AdmissionController] = None,
        standby_of: Optional[str] = None,
        promote_after_ms: Optional[float] = None,
        replicate_to: Optional[Sequence] = None,
        repl_interval_ms: Optional[float] = None,
        shm_dir: Optional[str] = None,
        shm_spin_us: Optional[int] = None,
        push: bool = True,
    ):
        if metrics_port is not None:
            _refuse("metrics_port (the Prometheus exporter)", "item 8")
        from sentinel_tpu_torch.native import lib as native_lib

        native_lib.load()  # builds on first use; raises if it cannot
        self._Frontdoor = native_lib.Frontdoor
        # opt-in shared-memory ring door for co-located sidecar clients:
        # one extra intake lane pulls from the ring poller and drains into
        # the SAME dispatch semaphore, so the fusion ladder fuses the union
        # of TCP and shm bursts; replies scatter-encode straight into each
        # client's response ring (zero syscalls steady-state)
        self.shm_dir = shm_dir
        self.shm_spin_us = shm_spin_us
        self._shm_door = None
        if shm_dir is not None:
            self._ShmDoor = native_lib.ShmDoor
        self.service = service
        self.host = host
        self.port = port
        self.max_batch = max_batch
        self.n_dispatchers = max(1, int(n_dispatchers))
        # SO_REUSEPORT intake sharding: N doors bound to the SAME port, the
        # kernel hash-spreads connections across them, and each door gets a
        # dedicated intake thread with its own bounded handoff queue. The
        # single device lane drains the UNION of the shard queues, so the
        # fusion ladder still sees one merged burst — sharding multiplies
        # intake pull/decode bandwidth without forking the device pipeline.
        self.intake_shards = max(1, int(intake_shards))
        # fuse_depth bounds how many queued intake pulls the device lane
        # folds into one dispatch (each pull is itself up to max_batch
        # rows) — the host-prep budget of the adaptive frame fusion
        self.fuse_depth = max(1, int(fuse_depth))
        # double-buffering bound: fused groups dispatched but not yet
        # materialized. 2 overlaps the next group's host prep (queue
        # drain, concat, shed masks, staging) with the previous group's
        # device compute; higher depths only add verdict latency, since
        # dispatch order is already the state-chain order. 1 restores
        # the serialized lane.
        self.max_device_inflight = max(1, int(max_device_inflight))
        self._device_inflight = 0
        self._device_cv = threading.Condition()
        # intake poll granularity only — the C++ door wakes the waiter the
        # moment the first frame queues, so this never delays a ready frame
        self.intake_timeout_ms = max(1, int(intake_timeout_ms))
        self.idle_ttl_s = idle_ttl_s
        self.arena_cap = arena_cap
        # the C++ door strips the wire deadline before Python sees a pull,
        # so the native lanes shed by AGE instead: a pull older than this
        # when the device lane picks it up is answered OVERLOAD without a
        # dispatch (every client budget is long gone at 1s; None disables).
        # Also the bounded-wait budget for the intake→device handoff — a
        # full dispatch queue refuses (answers OVERLOAD) after this long
        # instead of blocking the intake lane forever.
        self.shed_age_ms = shed_age_ms
        # lane join budget in stop() before _abandon flips drops on
        self.drain_timeout_s = max(0.1, float(drain_timeout_s))
        # BBR-style admission gate + brownout ladder (overload/admission.py)
        self.overload = (
            overload if overload is not None else AdmissionController()
        )
        self._door = None  # door 0 (back-compat handle; owns self.port)
        self._doors: List = []
        self._threads: List[threading.Thread] = []
        self._lane_threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._intake_stop = threading.Event()
        self._abandon = threading.Event()  # give up lane drain (dead lane)
        self._shard_qs: List[queue.Queue] = []
        self._dispatch_sem: Optional[threading.Semaphore] = None
        self._dispatch_q: Optional[queue.Queue] = None  # alias: shard 0's q
        self._reply_q: Optional[queue.Queue] = None
        self._staging = None  # StagingPool of intake decode blocks
        self.connections = ConnectionManager(
            on_count_changed=service.connected_count_changed
        )
        self._addr_by_conn = {}  # (fd, gen) → address
        self._addr_lock = threading.Lock()
        # same observability surface as the asyncio front door: opt-in
        # profiler command target + optional standalone /metrics endpoint
        self.profile_dir = profile_dir
        self.profiler = ProfilerHook(default_dir=profile_dir)
        self._gauge_fns: dict = {}
        # HA state snapshots: restored into a cold service at start, saved
        # every snapshot_period_s and once more at stop
        self.snapshot_dir = snapshot_dir or os.environ.get(
            "SENTINEL_SNAPSHOT_DIR"
        ) or None
        self.snapshot_period_s = snapshot_period_s
        self._snapshots = None
        # warm-standby replication roles: standby_of= refuses data-plane
        # traffic with TokenStatus.STANDBY until promoted while rev-3
        # frames stream state in; replicate_to= ships deltas out
        self.standby_of = standby_of
        self.promote_after_ms = promote_after_ms
        self.replicate_to = list(replicate_to) if replicate_to else None
        self.repl_interval_ms = repl_interval_ms
        self.applier = None
        self.replicator = None
        self._repl_sessions: dict = {}  # (fd, gen) → ReplSession
        # rev-4 namespace-move channel (cluster.rebalance): one MoveSession
        # per inbound connection, the same lifecycle as _repl_sessions
        from sentinel_tpu_torch.cluster.rebalance import MoveTarget

        self.move_target = MoveTarget(service)
        self._move_sessions: dict = {}  # (fd, gen) → MoveSession
        # rev-7 push plane (cluster.push): sinks registered per (fd, gen)
        # at CTRL_OPEN hand encoded push frames to door.send — the same
        # non-blocking C++ send queue the control replies use, which also
        # covers shm ring connections (their door routes sends onto the
        # response lane). push=False disarms every emit.
        from sentinel_tpu_torch.cluster.push import PushHub

        self.push_hub = PushHub(enabled=push)
        service.attach_push_hub(self.push_hub)
        self.overload.on_level_change = (
            lambda level, retry_ms: self.push_hub.push_brownout(
                level, retry_ms
            )
        )

    def tuning_kwargs(self) -> dict:
        return dict(
            max_batch=self.max_batch,
            n_dispatchers=self.n_dispatchers,
            fuse_depth=self.fuse_depth,
            max_device_inflight=self.max_device_inflight,
            intake_shards=self.intake_shards,
            intake_timeout_ms=self.intake_timeout_ms,
            idle_ttl_s=self.idle_ttl_s,
            arena_cap=self.arena_cap,
            profile_dir=self.profile_dir,
            snapshot_dir=self.snapshot_dir,
            snapshot_period_s=self.snapshot_period_s,
            shed_age_ms=self.shed_age_ms,
            drain_timeout_s=self.drain_timeout_s,
            overload=self.overload,
            standby_of=self.standby_of,
            promote_after_ms=self.promote_after_ms,
            replicate_to=self.replicate_to,
            repl_interval_ms=self.repl_interval_ms,
            shm_dir=self.shm_dir,
            shm_spin_us=self.shm_spin_us,
            push=self.push_hub.enabled,
        )

    @property
    def is_standby(self) -> bool:
        """True while this server refuses data-plane traffic (unpromoted
        warm standby)."""
        return self.applier is not None and not self.applier.promoted

    def promote(self, reason: str = "manual") -> bool:
        """Promote a standby to serving. Returns True if the server was a
        standby and is now (or already was) promoted."""
        if self.applier is None:
            return False
        self.applier.promote(reason)
        return True

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._door is not None:
            return
        self.service.warmup()
        if self.snapshot_dir:
            from sentinel_tpu_torch.ha.snapshot import restore_latest

            if not self.service.current_rules():  # cold service only
                restore_latest(self.service, self.snapshot_dir)
        self.service.reopen()
        if self.standby_of is not None:
            # before the listener: the first control frame a standby sees
            # may be the primary's REPL_HELLO
            from sentinel_tpu_torch.ha.replication import StandbyApplier

            self.applier = StandbyApplier(
                self.service, promote_after_ms=self.promote_after_ms,
            ).start()
        self._stop.clear()
        self._intake_stop.clear()
        self._abandon.clear()
        # bounded handoffs: each shard's dispatch queue depth caps how far
        # its intake runs ahead of the device (their union IS the fusion
        # opportunity); reply queue depth caps device-step in-flight count.
        # The semaphore counts queued pulls across ALL shard queues so the
        # device lane blocks on one primitive instead of polling N queues.
        # the shm door (when enabled) is one more intake lane with its own
        # shard queue at index intake_shards — the device lane's union
        # drain and sentinel accounting see it as just another shard
        n_lanes = self.intake_shards + (1 if self.shm_dir is not None else 0)
        self._shard_qs = [
            queue.Queue(maxsize=max(2, 2 * self.fuse_depth))
            for _ in range(n_lanes)
        ]
        self._dispatch_q = self._shard_qs[0]
        self._dispatch_sem = threading.Semaphore(0)
        self._reply_q = queue.Queue(maxsize=max(2, 2 * self.n_dispatchers))
        # recycled intake decode blocks: the C++ arena memcpys each pull
        # straight into one of these (wait_batch_into) and the block rides
        # the pull through device prep and reply submit, then returns to
        # the pool — zero steady-state allocation on the intake path
        from sentinel_tpu_torch.cluster.protocol import StagingPool

        self._staging = StagingPool(
            self._alloc_staging_block,
            capacity=2 * self.fuse_depth + self.n_dispatchers
            + n_lanes + 2,
        )
        # door 0 binds the requested port (possibly 0 → ephemeral); the
        # remaining shards bind the LEARNED concrete port via SO_REUSEPORT
        # (set unconditionally in sn_fd_create) so the kernel spreads
        # accepted connections across the shard listeners
        doors = [self._Frontdoor(self.host, self.port,
                                 arena_cap=self.arena_cap)]
        self.port = doors[0].port
        for _ in range(1, self.intake_shards):
            doors.append(
                self._Frontdoor(self.host, self.port,
                                arena_cap=self.arena_cap)
            )
        if self.shm_dir is not None:
            kw = {}
            if self.shm_spin_us is not None:
                kw["spin_us"] = self.shm_spin_us
            self._shm_door = self._ShmDoor(
                self.shm_dir, arena_cap=self.arena_cap, **kw
            )
            doors.append(self._shm_door)  # control loop + stats cover it
        self._doors = doors
        self._door = doors[0]
        if self.idle_ttl_s:
            for d in doors:
                d.set_idle_ttl(int(self.idle_ttl_s * 1000))
        lanes = [
            threading.Thread(
                target=self._intake_loop,
                args=(i, doors[i], self._shard_qs[i]),
                name=f"sentinel-native-intake-{i}", daemon=True,
            )
            for i in range(self.intake_shards)
        ]
        if self._shm_door is not None:
            # shard index intake_shards: its pulls/occupancy surface under
            # the per-shard intake series like any TCP shard's
            lanes.append(
                threading.Thread(
                    target=self._intake_loop,
                    args=(self.intake_shards, self._shm_door,
                          self._shard_qs[self.intake_shards]),
                    name="sentinel-native-intake-shm", daemon=True,
                )
            )
        lanes.append(
            threading.Thread(
                target=self._device_loop, name="sentinel-native-device",
                daemon=True,
            )
        )
        lanes.extend(
            threading.Thread(
                target=self._reply_loop,
                name=f"sentinel-native-reply-{i}", daemon=True,
            )
            for i in range(self.n_dispatchers)
        )
        for t in lanes:
            t.start()
        self._lane_threads = lanes
        t = threading.Thread(
            target=self._control_loop, name="sentinel-native-control",
            daemon=True,
        )
        t.start()
        self._threads.append(t)
        if self.profile_dir:
            try:
                self.profiler.start(self.profile_dir)
            except Exception:
                record_log.exception("profiler start failed; serving anyway")
        # gauges: the native door keeps its own counters (stats()); surface
        # the in-flight depth and the namespace connection groups. The C++
        # plane owns the request queue, so queue_depth reads pending frames
        # when the door exports them, else 0.
        self._gauge_fns = {
            "queue_depth": lambda: float(
                (self.stats() or {}).get("pending_frames", 0)
            ),
            "dispatch_lane_depth": lambda: float(
                sum(q.qsize() for q in self._shard_qs)
            ),
            "reply_lane_depth": lambda: float(
                self._reply_q.qsize() if self._reply_q else 0
            ),
            "device_inflight": lambda: float(self._device_inflight),
            "connections": lambda: sum(
                len(addrs) for addrs in self.connections.snapshot().values()
            ),
        }
        if self._shm_door is not None:
            def _ring_occupancy(door=self._shm_door):
                try:
                    st = door.stats()
                except Exception:
                    return 0.0
                total = st.get("shm_req_slots_total", 0)
                return st.get("shm_req_slots_used", 0) / total if total else 0.0

            self._gauge_fns["shm_ring_occupancy"] = _ring_occupancy
            # counter series (sentinel_server_shm_{polls,doorbells,
            # ring_full}_total) render from the door's relaxed atomics via
            # this provider — each independently monotonic, no snapshot
            _SM.register_shm_provider(self._shm_stats_provider)
        for name, fn in self._gauge_fns.items():
            _SM.register_gauge(name, fn)
        # hub half of the clusterServerStats `push` block (single-slot
        # provider, same contract as the asyncio door's)
        _SM.register_push_provider(self.push_hub.stats)
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
        record_log.info(
            "native token server listening on %s:%d "
            "(%d intake shards, %d dispatchers)",
            self.host, self.port, self.intake_shards, self.n_dispatchers,
        )

    def _shm_stats_provider(self) -> dict:
        door = self._shm_door
        if door is None:
            return {}
        try:
            st = door.stats()
        except Exception:
            return {}
        return {
            "polls": st.get("shm_polls", 0),
            "doorbells": st.get("shm_doorbells", 0),
            "ring_full": st.get("shm_ring_full", 0),
            "segments": st.get("shm_segments", 0),
        }

    def _alloc_staging_block(self) -> dict:
        """One intake decode block: row arrays sized for the largest pull
        (``max_batch``, clamped so a max-size frame always fits) plus frame
        metadata. ``prios`` is the raw wire byte (what the C++ arena
        holds); ``prios_bool`` is its normalized boolean row, converted in
        place per pull so downstream masking (`~`, shed_mask) sees real
        booleans whatever byte a client sent."""
        rows = max(
            min(int(self.max_batch), int(self.arena_cap)),
            P.MAX_BATCH_PER_FRAME,
        )
        # frames per pull is bounded by rows except for degenerate 0-row
        # frames; the frame capacity below also CAPS how many frames one
        # wait_batch_into may take, so a smaller array just splits a
        # pathological all-empty-frame burst across pulls
        max_f = rows + 64
        return dict(
            ids=np.empty(rows, np.int64),
            counts=np.empty(rows, np.int32),
            prios=np.empty(rows, np.uint8),
            prios_bool=np.empty(rows, bool),
            f_fd=np.empty(max_f, np.int32),
            f_gen=np.empty(max_f, np.int32),
            f_xid=np.empty(max_f, np.int32),
            f_n=np.empty(max_f, np.int32),
            f_type=np.empty(max_f, np.uint8),
        )

    def stop(self) -> None:
        if self._door is None:
            return
        if self.replicator is not None:
            self.replicator.stop()
            self.replicator = None
        if self.applier is not None:
            self.applier.stop()
            self.applier = None
        self._repl_sessions.clear()
        for sess in self._move_sessions.values():
            sess.closed()  # discard any staged (uncommitted) move state
        self._move_sessions.clear()
        if self._snapshots is not None:
            self._snapshots.stop(final_save=True)
            self._snapshots = None
        if self.profiler.active:
            self.profiler.stop()
        for name, fn in self._gauge_fns.items():
            _SM.unregister_gauge(name, fn)
        self._gauge_fns = {}
        # drain shutdown, in lane order: stop intake first so every frame
        # already pulled still gets answered, then let the sentinel flow
        # intake → device → reply before the door closes. A wedged lane
        # can't deadlock stop(): after the join timeout we flip _abandon,
        # which turns every blocking lane handoff into a drop.
        self._intake_stop.set()
        for t in self._lane_threads:
            t.join(timeout=self.drain_timeout_s)
            if t.is_alive():
                self._abandon.set()
                t.join(timeout=2)
        self._lane_threads = []
        # staging-leak audit (abandoned shutdown): a dead or abandoned lane
        # can strand pulls inside the shard/reply queues — nobody will
        # answer them, but their staging blocks must still go back to the
        # pool or the freelist never quiesces. Lanes are joined, so a
        # nowait drain here sees every stranded item.
        pool = self._staging
        if pool is not None:
            stranded = []
            for q in self._shard_qs:
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not self._SENTINEL:
                        stranded.append(item)
            for pull in stranded:
                n = len(pull[0])
                self.overload.note_done(n)
                _SM.count_shed("lane_abandon", n)
                pool.release(pull[6])
            if self._reply_q is not None:
                while True:
                    try:
                        item = self._reply_q.get_nowait()
                    except queue.Empty:
                        break
                    if item is self._SENTINEL:
                        continue
                    pulls, lengths, _mat = item
                    self.overload.note_done(sum(lengths))
                    _SM.count_shed("lane_abandon", sum(lengths))
                    for p in pulls:
                        pool.release(p[6])
        self._stop.set()
        for d in self._doors:
            d.stop()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._shard_qs = []
        self._dispatch_sem = None
        self._dispatch_q = None
        self._reply_q = None
        self._staging = None
        self._doors = []
        self._door = None
        self._shm_door = None
        # the door closed every socket without emitting CTRL_CLOSE (the
        # control thread is already down), so deregister the clients here —
        # a restart would otherwise inherit phantom connections that keep
        # deflating AVG_LOCAL per-connection budgets
        for key in list(self._addr_by_conn):
            address = self._addr_by_conn.pop(key, None)
            if address is not None:
                self.connections.remove_address(address)
        self.service.close()

    # -- data plane ---------------------------------------------------------
    _SENTINEL = object()  # lane shutdown marker, flows intake→device→reply

    def _lane_put(
        self, q: queue.Queue, item, give_up_after_s: Optional[float] = None
    ) -> bool:
        """Blocking bounded-queue handoff (the lanes' backpressure). Never
        deadlocks shutdown: once ``_abandon`` is set (a lane died and its
        join timed out) the put gives up and drops instead. With
        ``give_up_after_s`` the put also refuses after that long against a
        full queue — the caller then answers OVERLOAD instead of wedging
        its lane (sentinel handoffs pass None and keep the forever
        semantics: a dropped sentinel would strand the downstream lane)."""
        deadline = (
            None if give_up_after_s is None
            else time.monotonic() + give_up_after_s
        )
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._abandon.is_set():
                    return False
                if deadline is not None and time.monotonic() >= deadline:
                    return False

    def _intake_loop(self, shard: int, door, q: queue.Queue) -> None:
        """Lane 1 (×``intake_shards``): pull decoded frames from this
        shard's C++ door straight into a recycled staging block, hand the
        block to the device lane. The door wakes ``wait_batch_into`` the
        moment the first frame queues — ``intake_timeout_ms`` is only the
        shutdown-poll granularity, never a batching stall.

        Zero-copy shape: the C++ IO thread memcpys its arena directly into
        the staging arrays (no thread-local bounce buffer, no per-pull
        ``np.array`` copies); the block travels with the pull and returns
        to the pool after the reply lane submits its verdicts. Pulls this
        lane answers itself (overload refusals, chaos drops) reuse
        the block immediately — ``sn_fd_submit`` copies synchronously."""
        pool = self._staging
        if self.intake_shards > 1:
            # best-effort shard→core pinning so each intake lane's cache
            # stays hot; harmless no-op on single-core or restricted hosts
            try:
                cpus = sorted(os.sched_getaffinity(0))
                if len(cpus) > 1:
                    os.sched_setaffinity(0, {cpus[shard % len(cpus)]})
            except (AttributeError, OSError):
                pass
        block = pool.acquire()
        try:
            while not self._intake_stop.is_set():
                try:
                    # max_batch bounds one pull (clamped to >= one max
                    # frame); the remainder stays queued for the next cycle
                    got = door.wait_batch_into(
                        block, timeout_ms=self.intake_timeout_ms,
                        max_n=self.max_batch,
                    )
                except Exception:
                    if self._stop.is_set() or self._intake_stop.is_set():
                        break
                    record_log.exception(
                        "native wait_batch failed; intake %d down", shard
                    )
                    break
                if got is None:
                    continue
                n, k = got
                if chaos.ARMED:
                    chaos.maybe_sleep("lane_delay")
                    if chaos.should("frame_drop"):
                        _SM.count_shed("chaos_drop", n)
                        continue
                t0 = time.perf_counter()
                # normalize the wire prio bytes into the block's boolean
                # row in place (clients send 0/1 but the wire admits any
                # byte; masking downstream needs real booleans)
                prios = np.not_equal(
                    block["prios"][:n], 0, out=block["prios_bool"][:n]
                )
                # the one host copy this path pays: C arena → staging
                # (13B/row + 17B/frame) plus the 1B/row bool normalize
                _SM.count_copy_bytes(n * 14 + k * 17)
                # pull = (rows..., frames, age stamp, owning door, block):
                # the age stamp is the shed-by-age deadline proxy (the C++
                # door strips the wire deadline); the door routes replies
                # and refusals back to the shard that owns the connection
                pull = (
                    block["ids"][:n], block["counts"][:n], prios,
                    (block["f_fd"][:k], block["f_gen"][:k],
                     block["f_xid"][:k], block["f_n"][:k],
                     block["f_type"][:k]),
                    time.monotonic(), door, block,
                )
                if _TR.ARMED:  # flight recorder: frames entered the host
                    if door is self._shm_door:
                        _TR.record(_TR.SHM_POLL, shard=shard, aux=n)
                    _TR.record_many(
                        _TR.CLIENT_IN, pull[3][2], shard=shard, aux=n
                    )
                if self.is_standby:
                    # unpromoted warm standby: the data plane is closed.
                    # Refuse the whole pull with STANDBY so a failover
                    # client walks on to the live primary (no retry hint:
                    # this is not backpressure)
                    _SM.count_shed("standby", n)
                    if _TR.ARMED:
                        _TR.record_many(
                            _TR.SHED, pull[3][2], shard=shard, aux=n
                        )
                    status = np.full(n, _STANDBY, np.int8)
                    _SM.record_verdict_batch(status, None, ())
                    try:
                        door.submit(
                            pull[3], status, np.zeros(n, np.int32),
                            np.zeros(n, np.int32),
                        )
                    except Exception:
                        if not self._stop.is_set():
                            record_log.exception(
                                "native standby submit failed"
                            )
                    continue
                _SM.batch_size.record(n)
                self.overload.note_enqueued(n)
                give_up = (
                    None if self.shed_age_ms is None
                    else self.shed_age_ms / 1000.0
                )
                if self._lane_put(q, pull, give_up_after_s=give_up):
                    self._dispatch_sem.release()
                    if _TR.ARMED:
                        _TR.record_many(
                            _TR.ENQUEUE, pull[3][2], shard=shard, aux=n
                        )
                    dt_ms = (time.perf_counter() - t0) * 1e3
                    _SM.intake_ms.record(dt_ms)
                    _SM.count_shard_pull(shard, n, dt_ms)
                    # the block now rides the pull; next cycle decodes
                    # into a fresh (usually recycled) one
                    block = pool.acquire()
                else:
                    # dispatch lane saturated past the age budget: refuse
                    # the whole pull explicitly rather than queue frames
                    # that will only expire — the clients get an immediate
                    # retry hint
                    self.overload.note_done(n)
                    _SM.count_shed("queue_full", n)
                    if _TR.ARMED:
                        _TR.record_many(
                            _TR.SHED, pull[3][2], shard=shard, aux=n
                        )
                    status = np.full(n, _OVERLOAD, np.int8)
                    wait = np.full(
                        n, self.overload.retry_hint_ms, np.int32
                    )
                    # per-tenant attribution: these rows never reach the
                    # device path, so resolve namespaces here (the SLO
                    # plane's shed accounting rides the verdict counters)
                    _SM.record_verdict_batch(
                        status, *self.service.namespace_index(pull[0])
                    )
                    try:
                        door.submit(
                            pull[3], status, np.zeros(n, np.int32), wait
                        )
                    except Exception:
                        if not self._stop.is_set():
                            record_log.exception(
                                "native overload submit failed"
                            )
        finally:
            pool.release(block)
            # sentinel handoff keeps the forever semantics; only a
            # successful put may release the semaphore (the device lane
            # trusts every release to have a queued item behind it)
            if self._lane_put(q, self._SENTINEL):
                self._dispatch_sem.release()

    # -- device pipelining ---------------------------------------------------
    def _acquire_device_permit(self) -> bool:
        """Block until a dispatch slot frees (``max_device_inflight``
        bound). Returns True when another fused group was already in
        flight — i.e. this group's host prep just ran overlapped with
        device compute that a depth-1 lane would have serialized behind.
        On abandoned shutdown the wait gives up and over-admits; the
        release path tolerates it."""
        with self._device_cv:
            while (
                self._device_inflight >= self.max_device_inflight
                and not self._abandon.is_set()
            ):
                self._device_cv.wait(timeout=0.1)
            overlapped = self._device_inflight > 0
            self._device_inflight += 1
            return overlapped

    def _release_device_permit(self) -> None:
        with self._device_cv:
            self._device_inflight = max(0, self._device_inflight - 1)
            self._device_cv.notify()

    def _tracked_dispatch(self, dispatch, ids, counts, prios):
        """Issue one device dispatch under the inflight bound.

        Returns ``(mat, release, overlapped)``: ``mat`` materializes the
        verdicts and releases the permit (exactly once, even if the
        materialize raises); ``release`` is the idempotent escape hatch
        for paths that never call ``mat`` (dispatch exception handled by
        the caller, abandoned-shutdown drop). ``overlapped`` reports
        whether the permit wait found earlier work still in flight."""
        overlapped = self._acquire_device_permit()
        done = [False]

        def release():
            if not done[0]:
                done[0] = True
                self._release_device_permit()

        try:
            inner = dispatch(ids, counts, prios)
        except Exception:
            release()
            raise

        def mat():
            try:
                return inner()
            finally:
                release()

        return mat, release, overlapped

    def _device_loop(self) -> None:
        """Lane 2: the only thread issuing device work — dispatch order IS
        state-chain order. Drains every queued pull (bounded by
        ``fuse_depth``), concatenates, and issues ONE dispatch; the token
        service's fusion ladder folds the full engine frames inside into a
        single chained device step. Dispatch returns before the device
        finishes (async), so this lane loops back to prep the next group
        while the reply lanes block on the verdicts. Up to
        ``max_device_inflight`` fused groups may be dispatched and not yet
        materialized — the permit wait applies backpressure beyond that,
        and the overlap the pipeline wins is accounted in
        ``overlap_saved_ms_total``.

        With intake sharding the drain is the UNION of the shard queues:
        the semaphore counts queued pulls across all of them, and a
        round-robin ``get_nowait`` scan fetches the item each acquired
        permit guarantees — so a burst split across N doors by the kernel
        still fuses into one device step. Shutdown ends after every
        shard's sentinel has been consumed."""
        qs = self._shard_qs
        sem = self._dispatch_sem
        n_shards = len(qs)
        done_shards = 0
        rr = 0
        service = self.service
        dispatch = service.dispatch_batch_arrays
        ns_fn = service.namespace_index

        def pop_next():
            # every sem permit has a queued item behind it and this lane
            # is the sole consumer, so one scan pass finds it; the spin
            # guard only matters if a lane died mid-shutdown
            nonlocal rr
            while True:
                for j in range(n_shards):
                    qi = (rr + j) % n_shards
                    try:
                        item = qs[qi].get_nowait()
                    except queue.Empty:
                        continue
                    rr = (qi + 1) % n_shards
                    return item
                if self._abandon.is_set():
                    return None

        try:
            while True:
                if not sem.acquire(timeout=0.5):
                    if self._abandon.is_set():
                        break
                    continue
                item = pop_next()
                if item is None:
                    break
                if item is self._SENTINEL:
                    done_shards += 1
                    if done_shards >= n_shards:
                        break
                    continue
                pulls = [item]
                # adaptive frame fusion: everything already queued joins
                # this dispatch. Idle queues → depth 1 (no added latency);
                # backlog → deep fused step (max amortization).
                stop_after = False
                while len(pulls) < self.fuse_depth:
                    if not sem.acquire(blocking=False):
                        break
                    nxt = pop_next()
                    if nxt is None:
                        break
                    if nxt is self._SENTINEL:
                        done_shards += 1
                        if done_shards >= n_shards:
                            stop_after = True  # all intake done; finish
                            break
                        continue
                    pulls.append(nxt)
                if len(pulls) == 1:
                    ids, counts, prios = item[0], item[1], item[2]
                else:
                    ids = np.concatenate([p[0] for p in pulls])
                    counts = np.concatenate([p[1] for p in pulls])
                    prios = np.concatenate([p[2] for p in pulls])
                    _SM.count_copy_bytes(
                        ids.nbytes + counts.nbytes + prios.nbytes
                    )
                lengths = [len(p[0]) for p in pulls]
                n_rows = len(ids)
                # deadline proxy: pulls older than shed_age_ms are answered
                # OVERLOAD without touching the device (row mask via repeat)
                shed = None
                n_deadline = 0
                if self.shed_age_ms is not None:
                    cutoff = time.monotonic() - self.shed_age_ms / 1000.0
                    expired = np.array(
                        [p[4] < cutoff for p in pulls], bool
                    )
                    if expired.any():
                        shed = np.repeat(expired, lengths)
                        n_deadline = int(shed.sum())
                level = self.overload.level()
                if _TR.ARMED:  # flight recorder: fused group dispatched
                    for p in pulls:
                        _TR.record_many(
                            _TR.DISPATCH, p[3][2], aux=len(pulls)
                        )
                t0 = time.perf_counter()
                permit_rel = None
                overlapped = False
                try:
                    if level >= BrownoutLevel.DEGRADE:
                        # brownout floor: no device dispatch at all; a BDP
                        # slice gets probabilistic local answers, the rest
                        # (and every expired row) OVERLOAD
                        deg = self.overload.shed_mask(prios, level)
                        if shed is not None:
                            deg = deg | shed
                        status, remaining, wait = (
                            self.overload.degrade_verdicts(deg)
                        )
                        if n_deadline:
                            _SM.count_shed("deadline", n_deadline)
                        _SM.count_shed(
                            "degrade", int(deg.sum()) - n_deadline
                        )
                        _SM.record_verdict_batch(status, *ns_fn(ids))
                        mat = (  # noqa: E731
                            lambda r=(status, remaining, wait): r
                        )
                    else:
                        mask = shed
                        if level >= BrownoutLevel.SHED_LOW:
                            # tenant attribution up front so the shed is
                            # share-weighted when shares are configured
                            ns_pair = ns_fn(ids)
                            m = self.overload.shed_mask(
                                prios, level,
                                ns_idx=ns_pair[0], ns_names=ns_pair[1],
                            )
                            mask = m if mask is None else (mask | m)
                            if not mask.any():
                                mask = None
                        if mask is None:
                            mat, permit_rel, overlapped = (
                                self._tracked_dispatch(
                                    dispatch, ids, counts, prios
                                )
                            )
                        else:
                            if n_deadline:
                                _SM.count_shed("deadline", n_deadline)
                            n_brown = int(mask.sum()) - n_deadline
                            if n_brown > 0:
                                _SM.count_shed("brownout", n_brown)
                            keep = np.nonzero(~mask)[0]
                            if keep.size:
                                inner, permit_rel, overlapped = (
                                    self._tracked_dispatch(
                                        dispatch, ids[keep],
                                        counts[keep], prios[keep],
                                    )
                                )
                            else:
                                inner = None
                            hint = self.overload.retry_hint_ms
                            n_shed = n_rows - int(keep.size)
                            _SM.record_verdict_batch(
                                np.full(n_shed, _OVERLOAD, np.int8),
                                *ns_fn(ids[mask]),
                            )

                            # scatter the dispatched slice back into full-
                            # width arrays so the reply lane's per-pull
                            # offsets stay valid
                            def mat(
                                inner=inner, keep=keep, n=n_rows, hint=hint
                            ):
                                status = np.full(n, _OVERLOAD, np.int8)
                                remaining = np.zeros(n, np.int32)
                                wait = np.full(n, hint, np.int32)
                                if inner is not None:
                                    st, rm, wt = inner()
                                    status[keep] = st
                                    remaining[keep] = rm
                                    wait[keep] = wt
                                return status, remaining, wait
                except Exception:
                    record_log.exception("device step failed; failing batch")
                    if permit_rel is not None:
                        permit_rel()
                    n = n_rows
                    mat = lambda n=n: (  # noqa: E731
                        np.full(n, int(TokenStatus.FAIL), np.int8),
                        np.zeros(n, np.int32),
                        np.zeros(n, np.int32),
                    )
                dt_ms = (time.perf_counter() - t0) * 1e3
                _SM.dispatch_ms.record(dt_ms)
                if overlapped:
                    # this group's whole dispatch arm ran while the prior
                    # group still computed — the pipelining win
                    _SM.count_overlap_saved_ms(dt_ms)
                if not self._lane_put(
                    self._reply_q, (pulls, lengths, mat)
                ):
                    # abandoned shutdown drop: nobody will materialize or
                    # answer these rows — account for them and park the
                    # staging blocks the reply lane would have returned
                    if permit_rel is not None:
                        permit_rel()
                    self.overload.note_done(n_rows)
                    _SM.count_shed("lane_abandon", n_rows)
                    if self._staging is not None:
                        for p in pulls:
                            self._staging.release(p[6])
                if stop_after:
                    break
        finally:
            # always propagate shutdown, even if this lane died — the
            # reply lanes must not block forever on an empty queue
            self._lane_put(self._reply_q, self._SENTINEL)

    def _reply_loop(self) -> None:
        """Lane 3 (×``n_dispatchers``): block on the async verdicts, slice
        them back per intake pull, submit to each pull's owning door. While
        one reply thread waits on device results the device lane keeps
        dispatching, and a second reply thread overlaps the next group's
        encode. Consecutive pulls from the same door collapse into one
        ``submit_many`` call — one outbox lock and one IO wakeup per run,
        with the C++ scatter encode grouping same-connection frames across
        pull boundaries. Once the verdicts are submitted (``sn_fd_submit``
        copies synchronously) the pulls' staging blocks go back to the
        intake pool."""
        rq = self._reply_q
        while True:
            item = rq.get()
            if item is self._SENTINEL:
                rq.put(item)  # release sibling reply lanes
                return
            pulls, lengths, mat = item
            t0 = time.perf_counter()
            try:
                status, remaining, wait = mat()
            except Exception:
                record_log.exception("materialize failed; failing batch")
                n = sum(lengths)
                status = np.full(n, int(TokenStatus.FAIL), np.int8)
                remaining = np.zeros(n, np.int32)
                wait = np.zeros(n, np.int32)
            t_write = time.perf_counter()
            _SM.decide_ms.record((t_write - t0) * 1e3)
            off = 0
            i = 0
            n_pulls = len(pulls)
            while i < n_pulls:
                door = pulls[i][5]
                frames_list = []
                span = 0
                j = i
                while j < n_pulls and pulls[j][5] is door:
                    frames_list.append(pulls[j][3])
                    span += lengths[j]
                    j += 1
                try:
                    # the C++ scatter encode carries (status, remaining,
                    # wait) only, so MOVED verdicts ship the shard-map
                    # epoch in ``remaining`` without the endpoint trailer
                    # the asyncio door appends — clients re-resolve the
                    # destination through the shard map on the epoch bump
                    door.submit_many(
                        frames_list,
                        status[off : off + span],
                        remaining[off : off + span],
                        wait[off : off + span],
                    )
                    if _TR.ARMED:  # flight recorder: replies on the wire
                        for fr in frames_list:
                            _TR.record_many(
                                _TR.REPLY_OUT, fr[2], aux=span
                            )
                except Exception:
                    if not self._stop.is_set():
                        record_log.exception("native submit failed")
                off += span
                i = j
            self.overload.note_done(off)
            _SM.write_ms.record((time.perf_counter() - t_write) * 1e3)
            pool = self._staging
            if pool is not None:
                for p in pulls:
                    pool.release(p[6])

    # -- control plane ------------------------------------------------------
    def _control_loop(self) -> None:
        # one poll thread covers every shard door: control traffic is
        # low-rate (handshakes, params, repl frames), and (fd, gen) keys
        # are globally unique across doors, so the session maps need no
        # per-door namespacing — only the REPLY must go out through the
        # door that owns the connection
        doors = list(self._doors)
        while not self._stop.is_set():
            got_any = False
            for door in doors:
                try:
                    item = door.next_control()
                except Exception:
                    if self._stop.is_set():
                        return
                    raise
                if item is None:
                    continue
                got_any = True
                self._handle_control_item(door, item)
            if not got_any:
                self._stop.wait(0.002)

    def _handle_control_item(self, door, item) -> None:
        kind, fd, gen, payload = item
        if kind == door.CTRL_OPEN:
            address = payload.decode("latin-1")
            with self._addr_lock:
                self._addr_by_conn[(fd, gen)] = address
            self.connections.attach_closer(
                address,
                lambda fd=fd, gen=gen, door=door: door.close_conn(fd, gen),
            )
            # rev-7 push sink: door.send enqueues on the C++ plane's
            # non-blocking per-connection send queue (encoded push frames
            # carry their length prefix, same as control replies)
            self.push_hub.attach(
                (fd, gen),
                lambda b, fd=fd, gen=gen, door=door: door.send(fd, gen, b),
            )
            return
        if kind == door.CTRL_CLOSE:
            self.push_hub.detach((fd, gen))
            with self._addr_lock:
                address = self._addr_by_conn.pop((fd, gen), None)
            if address:
                self.connections.remove_address(address)
            self._repl_sessions.pop((fd, gen), None)
            move_sess = self._move_sessions.pop((fd, gen), None)
            if move_sess is not None:
                # a source that dies mid-move never sent MOVE_COMMIT:
                # discarding its staged state leaves it the sole owner
                move_sess.closed()
            return
        # kind == CTRL_FRAME: a non-data-plane request
        with self._addr_lock:
            address = self._addr_by_conn.get((fd, gen), f"fd{fd}")
        # rev-3 replication frames ride the control lane but are not
        # requests (decode_request would reject their type bytes): route
        # them to the standby applier's per-connection session
        if len(payload) >= 5 and P.peek_type(payload) in P.REPL_TYPES:
            if self.applier is None:
                record_log.warning(
                    "repl frame on non-standby server; closing %s",
                    address,
                )
                door.close_conn(fd, gen)
                return
            sess = self._repl_sessions.get((fd, gen))
            if sess is None:
                sess = self.applier.connection()
                self._repl_sessions[(fd, gen)] = sess
            try:
                sess.handle(
                    payload,
                    lambda b, fd=fd, gen=gen, door=door: door.send(
                        fd, gen, b
                    ),
                )
            except ValueError:
                record_log.warning("torn repl stream; closing %s",
                                   address)
                self._repl_sessions.pop((fd, gen), None)
                door.close_conn(fd, gen)
            return
        # rev-4 namespace-move frames: the same control-lane treatment,
        # routed to the MoveTarget's per-connection session
        if len(payload) >= 5 and P.peek_type(payload) in P.MOVE_TYPES:
            sess = self._move_sessions.get((fd, gen))
            if sess is None:
                sess = self.move_target.connection()
                self._move_sessions[(fd, gen)] = sess
                # a move channel is no token client: the import's
                # rule-epoch push would reach the source before the
                # COMMIT ack, and a coordinator that reads it as a failed
                # step aborts a move this side has committed
                self.push_hub.detach((fd, gen))
            try:
                sess.handle(
                    payload,
                    lambda b, fd=fd, gen=gen, door=door: door.send(
                        fd, gen, b
                    ),
                )
            except ValueError:
                record_log.warning("torn move stream; closing %s",
                                   address)
                self._move_sessions.pop((fd, gen), None)
                sess.closed()
                door.close_conn(fd, gen)
            return
        # rev-5 lease frames ride the control lane too (one per TTL per hot
        # flow — never on the per-decision path, which is the whole point)
        if len(payload) >= 5 and P.peek_type(payload) in P.LEASE_TYPES:
            try:
                rsp_bytes = self._handle_lease(payload, address)
            except ValueError:
                record_log.warning("bad lease frame; closing %s", address)
                door.close_conn(fd, gen)
                return
            door.send(fd, gen, rsp_bytes)
            return
        # hierarchy-tier frames (pod share ops + demand reports): same
        # control-lane treatment, dispatched to the co-located coordinator
        if len(payload) >= 5 and P.peek_type(payload) in P.HIER_TYPES:
            try:
                rsp_bytes = self._handle_hier(payload, address)
            except ValueError:
                record_log.warning("bad hier frame; closing %s", address)
                door.close_conn(fd, gen)
                return
            door.send(fd, gen, rsp_bytes)
            return
        # rev-6 outcome reports: fire-and-forget (no door.send — the whole
        # point is zero extra round-trips on the lease fast path). Covers
        # both the TCP and shm doors: each routes non-data type bytes here.
        if len(payload) >= 5 and P.peek_type(payload) in P.OUTCOME_TYPES:
            try:
                oxid, ofids, orts, oexcs = P.decode_outcome_report(payload)
            except Exception:
                record_log.warning("bad outcome frame; closing %s", address)
                door.close_conn(fd, gen)
                return
            if self.is_standby:
                # outcome columns replicate from the primary; counting here
                # would double on promotion
                return
            self.service.report_outcomes(ofids, orts, oexcs, oxid)
            return
        try:
            req = P.decode_request(payload)
        except Exception:
            record_log.warning("bad control frame; closing %s", address)
            door.close_conn(fd, gen)
            return
        try:
            rsp = self._handle_control(req, address)
        except Exception:
            record_log.exception("%s control request failed",
                                 type(req).__name__)
            rsp = P.FlowResponse(
                req.xid, getattr(req, "msg_type", P.MsgType.PING),
                int(TokenStatus.FAIL),
            )
        door.send(fd, gen, P.encode_response(rsp))

    def _handle_lease(self, payload, address: str) -> bytes:
        """Wire rev 5: decode a lease request, run the service's host-side
        grant/renew/return, encode the reply. Raises ValueError on a torn
        frame (caller closes the connection — the containment contract)."""
        xid, lmt, lease_id, flow_id, used, want = (
            P.decode_lease_request(payload)
        )
        if _TR.ARMED:
            _TR.record(_TR.LEASE, xid=xid, aux=want)
        self.connections.touch(address)
        if self.is_standby:
            # proof-of-life refusal, same as the decision path: the client
            # falls back to per-request RPCs
            return P.encode_lease_response(xid, lmt, _STANDBY)
        service = self.service
        try:
            if lmt == P.MsgType.LEASE_GRANT:
                res = service.lease_grant(flow_id, want)
            elif lmt == P.MsgType.LEASE_RENEW:
                res = service.lease_renew(lease_id, flow_id, used, want)
            else:
                res = service.lease_return(lease_id, used)
        except Exception:
            record_log.exception("lease op failed")
            return P.encode_lease_response(
                xid, lmt, int(TokenStatus.FAIL)
            )
        return P.encode_lease_response(
            xid, lmt, int(res.status), lease_id=res.lease_id,
            tokens=res.tokens, ttl_ms=res.ttl_ms, endpoint=res.endpoint,
        )

    def _handle_hier(self, payload, address: str) -> bytes:
        """Hierarchy tier: decode a share op or demand report, run the
        co-located coordinator's ledger op, encode the (lease-layout)
        reply. With no coordinator attached (``service.hierarchy`` is None)
        every op is refused NOT_LEASABLE, so the agent's failover walk tries
        the next endpoint. Raises ValueError on a torn frame (caller
        closes)."""
        if P.peek_type(payload) == int(P.MsgType.DEMAND_REPORT):
            xid, pod_id, entries = P.decode_demand_report(payload)
            hmt = P.MsgType.DEMAND_REPORT
            args = None
        else:
            xid, hmt, share_id, flow_id, used, want = (
                P.decode_lease_request(payload)
            )
            args = (share_id, flow_id, used, want)
        if _TR.ARMED:
            _TR.record(_TR.HIER, xid=xid)
        self.connections.touch(address)
        if self.is_standby:
            return P.encode_lease_response(xid, hmt, _STANDBY)
        hier = self.service.hierarchy
        if hier is None:
            return P.encode_lease_response(xid, hmt, P.NOT_LEASABLE_STATUS)
        try:
            if hmt == P.MsgType.DEMAND_REPORT:
                res = hier.handle_demand_report(pod_id, entries)
            elif hmt == P.MsgType.SHARE_GRANT:
                res = hier.share_grant(args[1], args[3])
            elif hmt == P.MsgType.SHARE_RENEW:
                res = hier.share_renew(args[0], args[1], args[2], args[3])
            else:
                res = hier.share_return(args[0], args[2])
        except Exception:
            record_log.exception("hier op failed")
            return P.encode_lease_response(xid, hmt, int(TokenStatus.FAIL))
        return P.encode_lease_response(
            xid, hmt, int(res.status), lease_id=res.lease_id,
            tokens=res.tokens, ttl_ms=res.ttl_ms, endpoint=res.endpoint,
        )

    def _handle_control(self, req, address: str) -> P.FlowResponse:
        service = self.service
        if isinstance(req, P.Ping):
            count = self.connections.add(req.namespace, address)
            return P.FlowResponse(req.xid, P.MsgType.PING, 0, remaining=count)
        self.connections.touch(address)
        if self.is_standby:
            # control-lane verdicts get the same closed-door refusal as the
            # data plane (PING above still answers: standbys stay pingable)
            return P.FlowResponse(req.xid, req.msg_type, _STANDBY)
        if req.msg_type == P.MsgType.PARAM_FLOW:
            r = service.request_params_token(
                req.flow_id, req.count, req.param_hashes
            )
            return P.FlowResponse(
                req.xid, req.msg_type, int(r.status), r.remaining, r.wait_ms
            )
        if req.msg_type == P.MsgType.CONCURRENT_ACQUIRE:
            r = service.request_concurrent_token(
                req.flow_id, req.count, req.prioritized
            )
            return P.FlowResponse(
                req.xid, req.msg_type, int(r.status), r.remaining, r.wait_ms,
                r.token_id,
            )
        if req.msg_type == P.MsgType.CONCURRENT_RELEASE:
            r = service.release_concurrent_token(req.flow_id)
            return P.FlowResponse(req.xid, req.msg_type, int(r.status))
        return P.FlowResponse(req.xid, req.msg_type, int(TokenStatus.FAIL))

    def stats(self) -> dict:
        """Door counters, summed across the intake shards. Every summand
        is an independently monotonic relaxed atomic read without pausing
        the IO threads, so the result is NOT a consistent cross-counter
        snapshot — each key is its own monotonic series; derived deltas
        between two calls must be clamped at zero."""
        doors = list(self._doors)
        if not doors:
            return {}
        out: dict = {}
        for d in doors:
            for key, v in d.stats().items():
                out[key] = out.get(key, 0) + v
        return out
