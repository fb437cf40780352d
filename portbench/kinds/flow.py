"""The flow configuration kind: ``DefaultTokenService`` at the
configuration's engine sizes, its rules loaded; with a ``batch_flow`` mix
behind ``NativeTokenServer``, BATCH_FLOW pulls from the load generator,
and with a ``batch_flow_embedded`` mix called in this process.

Recorders the harness puts on the service (before the door starts, so its
device lane binds them): each top-level ``dispatch_batch_arrays`` keeps a
copy of the rows the door handed it and the engine milliseconds its device
steps read (``_engine_now``), in the order the one device lane issued
them. That is what the reference replays (``reference/flow.py``). With
tracing on, the dispatches, the materializes and the reply lanes' sends
are also kept as host spans for the trace's idle gaps.

With a ``batch_flow_embedded`` mix there is no door: the embedded token
server's caller (:class:`EmbeddedLoad`), one thread of this process, calls
``dispatch_batch_arrays`` with the pool's pulls and materializes each
pull the mix's ``behind`` dispatches later; ``check`` then holds every
answer it materialized against the reference (``pulls_wrong``,
``rows_wrong`` over every row, ``pulls_unanswered``, ``pulls_undecided``).

With the door, ``check`` holds every frame the door answered against the
reference:

- ``frames_wrong``: frames the server decided whose reply (status,
  remaining, wait of every row, by digest) differs from the reference's;
- ``rows_wrong``: rows that differ, over the seeded sample of frames whose
  replies the load generator kept whole;
- ``frames_unanswered``: frames sent and never answered, answered twice,
  or answered with the wrong xid, type or row count;
- ``frames_undecided``: frames answered with verdicts that the server
  never decided, rows it decided that match no frame sent, and dispatches
  whose engine-clock reads are not one a device step.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from portbench import wire, workload

SAMPLE_MOD = 64
# the recorder's rows are copied into buffers reserved (and touched) in
# set-up for this many rows a second of warm-up and window, so that the
# copy in the timed path takes no page faults; beyond, it allocates
RESERVE_ROWS_PER_S = 4_000_000


class RowLog:
    """Append-only ids / acquires / prios, in reserved buffers."""

    def __init__(self, rows: int):
        self.ids = np.empty(rows, np.int64)
        self.acq = np.empty(rows, np.int32)
        self.prios = np.empty(rows, bool)
        for a in (self.ids, self.acq, self.prios):
            a.fill(0)  # touch every page now
        self.used = 0

    def add(self, ids, acq, prios):
        n = len(ids)
        a, b = self.used, self.used + n
        if b > self.ids.size:
            return (np.array(ids, np.int64), np.array(acq, np.int32),
                    np.array(prios, bool))
        self.used = b
        self.ids[a:b], self.acq[a:b], self.prios[a:b] = ids, acq, prios
        return self.ids[a:b], self.acq[a:b], self.prios[a:b]


def state_leaves(state) -> List[torch.Tensor]:
    """Every tensor of the program's (nested) state tuple."""
    out = []
    for leaf in state:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, tuple):
            out.extend(state_leaves(leaf))
    return out


LIMITS = {"frames_wrong": 0, "rows_wrong": 0, "frames_unanswered": 0,
          "frames_undecided": 0}
EMBEDDED_LIMITS = {"pulls_wrong": 0, "rows_wrong": 0, "pulls_unanswered": 0,
                   "pulls_undecided": 0}
FAIL, OVERLOAD = 5, 8
# how long stopping the embedded caller may take (its last steps drain)
STOP_S = 60.0


class EmbeddedLoad:
    """The embedded token server's caller: one thread of this process calls
    ``dispatch_batch_arrays`` with the pool's pulls, in the seed's order and
    cycled, and materializes each ``behind`` dispatches after it went out.
    The interface of :class:`portbench.harness.LoadGen`."""

    def __init__(self, svc, pool, behind: int):
        self.svc, self.behind = svc, int(behind)
        self.ids = pool.ids.reshape(-1, pool.ids.shape[1]
                                    * pool.frames_per_pull)
        self.acq = pool.acquire.reshape(self.ids.shape)
        self.prios = pool.prios.reshape(self.ids.shape)
        self.done = []  # (t_done, rtt_s, device rows, refused rows)
        self.answers = []  # (pull, status, remaining, wait) in send order
        self.sent = 0
        self.error = None
        self.stopping = False
        self.thread = None

    def go(self, t_end: float) -> None:
        self.thread = threading.Thread(target=self._run, args=(t_end,),
                                       name="portbench-embedded", daemon=True)
        self.thread.start()

    def _run(self, t_end: float) -> None:
        pending = collections.deque()
        try:
            while time.monotonic() < t_end and not self.stopping:
                j = self.sent % self.ids.shape[0]
                t = time.monotonic()
                pending.append((t, j, self.svc.dispatch_batch_arrays(
                    self.ids[j], self.acq[j], self.prios[j])))
                self.sent += 1
                if len(pending) > self.behind:
                    self._finish(*pending.popleft())
            while pending:
                self._finish(*pending.popleft())
        except BaseException as exc:  # the harness reports it, no result
            self.error = exc

    def _finish(self, t: float, j: int, materialize) -> None:
        status, remaining, wait = materialize()
        now = time.monotonic()
        refused = int(np.count_nonzero((status == FAIL)
                                       | (status == OVERLOAD)))
        self.done.append((now, now - t, status.size - refused, refused))
        self.answers.append((j, status, remaining, wait))

    def results(self) -> dict:
        from portbench.harness import RunError

        self.thread.join(timeout=STOP_S)
        if self.thread.is_alive() or self.error is not None:
            raise RunError(f"the embedded caller failed: {self.error!r}")
        return dict(sent_frames=self.sent,
                    done=np.asarray(self.done, np.float64).reshape(-1, 4),
                    answers=self.answers, missing=[],
                    rows_per_frame=self.ids.shape[1])

    def kill(self) -> None:
        self.stopping = True
        if self.thread is not None:
            self.thread.join(timeout=STOP_S)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tracing: bool = False, plant: Optional[str] = None,
                 seconds: float = 0.0):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.rows = RowLog(int(RESERVE_ROWS_PER_S
                               * (float(traffic["warmup_s"]) + seconds + 2)))
        self.device = torch.device(device)
        self.tracing = tracing
        self.plant = plant
        self.svc = self.server = None
        self.log = []  # (ids, acq, prios, nows, t_start_ns)
        self.spans: List[Tuple[str, int, int]] = []
        self.stopped = False
        self.embedded = traffic.get("kind") == "batch_flow_embedded"

    # -- the program under test -------------------------------------------
    def start(self) -> int:
        from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
        from sentinel_tpu_torch.cluster.token_service import (
            DefaultTokenService,
        )
        from sentinel_tpu_torch.engine import (
            ClusterFlowRule,
            EngineConfig,
            ThresholdMode,
        )

        cfg = EngineConfig(**self.config["engine"])
        svc = DefaultTokenService(
            cfg, device=self.device,
            fuse_depths=tuple(self.config["service"]["fuse_depths"]))
        cols = workload.flow_rules(self.config["rules"], cfg.max_flows)
        mode = ThresholdMode[self.config["rules"]["mode"]]
        svc.load_rules(
            [ClusterFlowRule(flow_id=int(f), count=float(c), mode=mode,
                             namespace=ns, control_behavior=int(b))
             for f, c, ns, b in zip(cols.flow_id, cols.count, cols.namespace,
                                    cols.behavior)],
            ns_max_qps=float(self.config["service"]["ns_max_qps"]))
        self.svc = svc
        self._plant(svc)
        self._record(svc)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.embedded:
            svc.warmup()
            return 0
        door = dict(self.config["door"])
        overload = door.pop("overload", None)
        if overload is not None:
            from sentinel_tpu_torch.overload import (
                AdmissionController,
                OverloadConfig,
            )

            door["overload"] = AdmissionController(OverloadConfig(**overload))
        self.server = NativeTokenServer(svc, port=0, idle_ttl_s=None, **door)
        self.server.start()
        if self.tracing:
            self._trace_replies()
        return self.server.port

    def _record(self, svc) -> None:
        tls = threading.local()
        orig_now, orig_dispatch = svc._engine_now, svc.dispatch_batch_arrays
        log, spans, tracing = self.log, self.spans, self.tracing
        rows = self.rows

        def engine_now():
            v = orig_now()
            sink = getattr(tls, "sink", None)
            if sink is not None:
                sink.append(v)
            return v

        def dispatch(flow_ids, acquires=None, prios=None):
            if getattr(tls, "sink", None) is not None:  # the service's own
                return orig_dispatch(flow_ids, acquires, prios)
            rec = (*rows.add(flow_ids, 1 if acquires is None else acquires,
                             False if prios is None else prios),
                   [], time.time_ns())
            tls.sink = rec[3]
            try:
                mat = orig_dispatch(flow_ids, acquires, prios)
            finally:
                tls.sink = None
            log.append(rec)
            if not tracing:
                return mat
            spans.append(("dispatch", rec[4], time.time_ns()))

            def materialize():
                t = time.time_ns()
                try:
                    return mat()
                finally:
                    spans.append(("materialize", t, time.time_ns()))

            return materialize

        svc._engine_now = engine_now
        svc.dispatch_batch_arrays = dispatch

    def _trace_replies(self) -> None:
        spans = self.spans
        for door in self.server._doors:
            orig = door.submit_many

            def submit_many(*a, _orig=orig, **kw):
                t = time.time_ns()
                try:
                    return _orig(*a, **kw)
                finally:
                    spans.append(("reply", t, time.time_ns()))

            door.submit_many = submit_many

    def _plant(self, svc) -> None:
        """A fault in the timed path, for the tests that show the check
        fails it: the state left as it was after every step, half of each
        dispatch's rows decided and their answers reused for the rest, or
        one answer altered where it is produced."""
        if self.plant is None:
            return
        if self.plant == "state_unchanged":
            orig = svc._run_step

            def run_step(step, batch, now):
                saved = [t.clone() for t in state_leaves(svc._state)]
                out = orig(step, batch, now)
                for t, s in zip(state_leaves(svc._state), saved):
                    t.copy_(s)
                return out

            svc._run_step = run_step
            return
        orig_dispatch = svc.dispatch_batch_arrays
        if self.plant == "half_batch":
            def dispatch(ids, acq=None, pr=None):
                h = max(1, len(ids) // 2)
                mat = orig_dispatch(ids[:h], None if acq is None else acq[:h],
                                    None if pr is None else pr[:h])
                n = len(ids)
                return lambda: tuple(np.resize(v, n) for v in mat())
        elif self.plant == "answer_altered":
            def dispatch(ids, acq=None, pr=None):
                mat = orig_dispatch(ids, acq, pr)

                def altered():
                    status, rem, wait = (np.array(v) for v in mat())
                    status[len(status) // 3] ^= 1
                    return status, rem, wait

                return altered
        else:
            raise ValueError(f"unknown fault {self.plant!r}")
        svc.dispatch_batch_arrays = dispatch

    def load(self, port: int, drain_s: float, cpu):
        """The cell's load: the embedded caller, or the load generator
        process against the door."""
        if self.embedded:
            return EmbeddedLoad(
                self.svc, workload.flow_pool(
                    self.traffic, self.config["engine"]["max_flows"],
                    self.seed), self.traffic["behind"])
        from portbench.harness import LoadGen

        return LoadGen(self.loadgen_job(port, drain_s), cpu)

    def loadgen_job(self, port: int, drain_s: float) -> dict:
        rng = workload.rng_for(self.seed, "sample")
        return dict(traffic=self.traffic, seed=self.seed, port=port,
                    max_flows=self.config["engine"]["max_flows"],
                    drain_s=drain_s, sample_mod=SAMPLE_MOD,
                    sample_rem=int(rng.integers(SAMPLE_MOD)))

    def snapshot(self) -> dict:
        from sentinel_tpu_torch.metrics.server import server_metrics

        sm = server_metrics()
        return dict(
            dispatch_ms_sum=sm.dispatch_ms.sum,
            dispatch_ms_count=sm.dispatch_ms.count,
            decide_ms_sum=sm.decide_ms.sum,
            decide_ms_count=sm.decide_ms.count,
            fused_depth_sum=sm.fused_depth.sum,
            fused_depth_count=sm.fused_depth.count,
            shed=sm.shed_total,
        )

    def memory_peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def host_spans(self) -> List[Tuple[str, int, int]]:
        return list(self.spans)

    def stop(self) -> None:
        if self.stopped:
            return
        self.stopped = True
        if self.server is not None:
            self.server.stop()
        self.server = self.svc = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def reference(self, control: Optional[str] = None):
        """The plain reference over the configuration's rules; with
        ``control`` ("state_unchanged"), the control: every write of the
        model dropped."""
        from portbench.reference.flow import FlowModel, FlowReplay

        eng = self.config["engine"]
        cols = workload.flow_rules(self.config["rules"], eng["max_flows"])
        if self.config["rules"]["mode"] != "GLOBAL":
            raise ValueError("the reference models GLOBAL thresholds")
        model = FlowModel(eng, cols.count, cols.behavior, cols.namespace,
                          float(self.config["service"]["ns_max_qps"]))
        if control is not None:
            if control != "state_unchanged":
                raise ValueError(f"unknown control {control!r}")
            model.frozen = True
        return FlowReplay(model, cols.flow_id, eng["batch_size"],
                          self.config["service"]["fuse_depths"])

    def check(self, lg: dict, control: Optional[str] = None) -> dict:
        """The comparison (module docstring). With ``control``, the control
        (the reference with every write dropped) stands in
        for the program's answers."""
        if self.embedded:
            return self._check_embedded(lg, control)
        pool = workload.flow_pool(self.traffic,
                                  self.config["engine"]["max_flows"],
                                  self.seed)
        per = pool.ids.shape[1]
        n_pool = pool.ids.shape[0]
        key_of = {workload.frame_key(pool.ids[j]): j for j in range(n_pool)}
        ref = self.reference()
        ctl = self.reference(control) if control else None
        seen = np.zeros(n_pool, np.int64)
        answered, rows_of = lg["answered"], lg["rows_of"]
        decided = set()
        frames_wrong = rows_wrong = undecided = 0
        dispatch_frames = []  # (t_start_ns, first, last frame stat index)
        for ids, acq, pr, nows, t_ns in self.log:
            n = ids.shape[0]
            if len(nows) != ref.steps_of(n):
                undecided += 1  # not one clock read a device step
                continue
            first = len(ref.stats)
            status, rem, wait = ref.dispatch(ids, acq, pr, iter(nows))
            dispatch_frames.append((t_ns, first, len(ref.stats)))
            if ctl is not None:
                got = ctl.dispatch(ids, acq, pr, iter(nows))
            for c in range(0, n - n % per, per):
                j = key_of.get(workload.frame_key(ids[c:c + per]))
                if (j is None or not (acq[c:c + per] == pool.acquire[j]).all()
                        or not (pr[c:c + per] == pool.prios[j]).all()):
                    undecided += 1
                    continue
                # this frame's next send that the door did not refuse whole
                # (a refused send never reached a dispatch)
                while answered.get(int(seen[j]) * n_pool + j + 1,
                                   (None, False))[1]:
                    seen[j] += 1
                xid = int(seen[j]) * n_pool + j + 1
                seen[j] += 1
                decided.add(xid)
                sl = slice(c, c + per)
                want = wire.rows_bytes(status[sl], rem[sl], wait[sl])
                if ctl is not None:
                    have = wire.rows_bytes(got[0][sl], got[1][sl], got[2][sl])
                    reply = (hashlib.blake2b(have, digest_size=8).digest(),
                             False)
                else:
                    have = rows_of.get(xid)
                    reply = answered.get(xid)
                if reply is None:
                    continue  # never answered: counted below
                if reply[0] != hashlib.blake2b(want,
                                               digest_size=8).digest():
                    frames_wrong += 1
                if have is not None and xid in rows_of:
                    a = np.frombuffer(have, wire.BATCH_RSP_DTYPE)
                    b = np.frombuffer(want, wire.BATCH_RSP_DTYPE)
                    rows_wrong += int(np.count_nonzero(a != b))
            undecided += (n % per) and 1
        undecided += sum(1 for xid, (_d, refused) in answered.items()
                         if xid not in decided and not refused)
        unanswered = len(lg["missing"]) + lg["duplicates"] + lg["n_bad"]
        values = dict(frames_wrong=frames_wrong, rows_wrong=rows_wrong,
                      frames_unanswered=unanswered,
                      frames_undecided=undecided)
        return {
            "checks": [(k, values[k], LIMITS[k]) for k in LIMITS],
            # what the decide byte model reads (readers.decide_roofline)
            "frame_stats": ref.stats,
            "dispatch_frames": dispatch_frames,
            "n_buckets": self.config["engine"]["n_buckets"],
            "max_flows": self.config["engine"]["max_flows"],
        }

    def _check_embedded(self, lg: dict, control: Optional[str]) -> dict:
        """Every answer the embedded caller materialized, row by row,
        against the reference's replay of the same dispatches."""
        ref = self.reference()
        ctl = self.reference(control) if control else None
        answers = lg["answers"]
        pulls = workload.flow_pool(self.traffic,
                                   self.config["engine"]["max_flows"],
                                   self.seed).ids
        pulls = pulls.reshape(-1, lg["rows_per_frame"])
        wrong = rows_wrong = undecided = 0
        dispatch_frames = []
        for k, (ids, acq, pr, nows, t_ns) in enumerate(self.log):
            n = ids.shape[0]
            if (k >= len(answers) or len(nows) != ref.steps_of(n)
                    or not np.array_equal(ids, pulls[answers[k][0]])):
                undecided += 1  # not the pull sent, or not a read a step
                continue
            first = len(ref.stats)
            want = ref.dispatch(ids, acq, pr, iter(nows))
            dispatch_frames.append((t_ns, first, len(ref.stats)))
            got = (ctl.dispatch(ids, acq, pr, iter(nows)) if ctl is not None
                   else answers[k][1:])
            bad = np.zeros(n, bool)
            for a, b in zip(got, want):
                bad |= np.asarray(a) != b
            rows_wrong += int(np.count_nonzero(bad))
            wrong += bool(bad.any())
        values = dict(pulls_wrong=wrong, rows_wrong=rows_wrong,
                      pulls_unanswered=max(0, len(self.log) - len(answers)),
                      pulls_undecided=undecided
                      + max(0, len(answers) - len(self.log)))
        return {
            "checks": [(k, values[k], EMBEDDED_LIMITS[k])
                       for k in EMBEDDED_LIMITS],
            "frame_stats": ref.stats,
            "dispatch_frames": dispatch_frames,
            "n_buckets": self.config["engine"]["n_buckets"],
            "max_flows": self.config["engine"]["max_flows"],
        }
