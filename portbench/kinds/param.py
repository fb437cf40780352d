"""The hot-param configuration kind: ``DefaultTokenService`` with the
configuration's ``ParamConfig`` and param rules, behind
``NativeTokenServer``; PARAM_FLOW requests from the load generator reach
the door's control lane, one ``request_params_token`` each.

The recorder the harness puts on the door (``_handle_control``, before it
starts) keeps each request's xid, flow, acquire and value hashes and the
engine milliseconds its param step read, in the order the control lane
served them: what the reference replays. With tracing on, each request is
also a ``control`` host span.

``check`` holds every request the door answered against the reference:

- ``requests_wrong``: requests whose reply status differs from the
  reference's;
- ``requests_unanswered``: requests sent and never answered, answered
  twice, or answered with the wrong xid or type;
- ``requests_undecided``: requests answered with a verdict that the door
  never served, or served with other contents than were sent.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import List, Optional, Tuple

import torch

from portbench import workload

PARAM_FLOW = 2
OVERLOAD, FAIL, STANDBY = 8, 5, 9
LIMITS = {"requests_wrong": 0, "requests_unanswered": 0,
          "requests_undecided": 0}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tracing: bool = False, plant: Optional[str] = None,
                 seconds: float = 0.0):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.tracing = tracing
        self.plant = plant
        self.svc = self.server = None
        self.log = []  # (xid, flow, acquire, hashes, nows, t_ns)
        self.spans: List[Tuple[str, int, int]] = []
        self.stopped = False
        self.rules = workload.param_rules(config["rules"])

    def start(self) -> int:
        from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
        from sentinel_tpu_torch.cluster.token_service import (
            ClusterParamFlowRule,
            DefaultTokenService,
        )
        from sentinel_tpu_torch.engine import EngineConfig
        from sentinel_tpu_torch.engine.param import ParamConfig

        svc = DefaultTokenService(
            EngineConfig(**self.config["engine"]),
            param_config=ParamConfig(**self.config["param"]),
            device=self.device)
        svc.load_param_rules([
            ClusterParamFlowRule(r.flow_id, r.count,
                                 tuple(sorted(r.items.items())))
            for r in self.rules])
        self.svc = svc
        self._plant(svc)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.server = NativeTokenServer(svc, port=0, idle_ttl_s=None,
                                        **self.config["door"])
        self._record(svc, self.server)
        self.server.start()
        return self.server.port

    def _record(self, svc, server) -> None:
        tls = threading.local()
        orig_now, orig_control = svc._engine_now, server._handle_control
        log, spans, tracing = self.log, self.spans, self.tracing

        def engine_now():
            v = orig_now()
            sink = getattr(tls, "sink", None)
            if sink is not None:
                sink.append(v)
            return v

        def handle_control(req, address):
            if getattr(req, "msg_type", None) != PARAM_FLOW:
                return orig_control(req, address)
            nows: List[int] = []
            t = time.time_ns()
            tls.sink = nows
            try:
                return orig_control(req, address)
            finally:
                tls.sink = None
                log.append((req.xid, req.flow_id, req.count,
                            tuple(req.param_hashes), nows, t))
                if tracing:
                    spans.append(("control", t, time.time_ns()))

        svc._engine_now = engine_now
        server._handle_control = handle_control

    def _plant(self, svc) -> None:
        """A fault in the timed path (see ``kinds/flow.py``): the sketch
        left as it was after every request, half of each request's values
        judged, or one answer in seven altered where it is produced."""
        if self.plant is None:
            return
        orig = svc.request_params_token
        if self.plant == "state_unchanged":
            def request(flow_id, acquire, hashes):
                saved = [t.clone() for t in svc._param_state]
                try:
                    r = orig(flow_id, acquire, hashes)
                    int(r.status)  # the verdict read waits for the step
                    return r
                finally:
                    for t, s in zip(svc._param_state, saved):
                        t.copy_(s)
        elif self.plant == "half_batch":
            def request(flow_id, acquire, hashes):
                hashes = list(hashes)
                keep = max(1, len(hashes) // 2)
                return orig(flow_id, acquire, hashes[:keep])
        elif self.plant == "answer_altered":
            from sentinel_tpu_torch.cluster.token_service import TokenResult
            from sentinel_tpu_torch.engine.decide import TokenStatus

            def request(flow_id, acquire, hashes):
                r = orig(flow_id, acquire, hashes)
                if int(flow_id) % 7:
                    return r
                flip = (TokenStatus.BLOCKED if r.status == TokenStatus.OK
                        else TokenStatus.OK)
                return TokenResult(flip, r.remaining, r.wait_ms)
        else:
            raise ValueError(f"unknown fault {self.plant!r}")
        svc.request_params_token = request

    def load(self, port: int, drain_s: float, cpu):
        """The load generator process against the door."""
        from portbench.harness import LoadGen

        return LoadGen(self.loadgen_job(port, drain_s), cpu)

    def loadgen_job(self, port: int, drain_s: float) -> dict:
        return dict(traffic=self.traffic, seed=self.seed, port=port,
                    rules=self.config["rules"], drain_s=drain_s,
                    sample_mod=1, sample_rem=0)

    def snapshot(self) -> dict:
        return {}

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

    def reference(self, control: Optional[str] = None):
        """The plain reference over the configuration's param rules; with
        ``control`` ("state_unchanged"), the control: every write of the
        model dropped."""
        from portbench.reference.param import ParamModel

        model = ParamModel(self.config["param"],
                           [(r.flow_id, r.count, r.items)
                            for r in self.rules])
        if control is not None:
            if control != "state_unchanged":
                raise ValueError(f"unknown control {control!r}")
            model.frozen = True
        return model

    def check(self, lg: dict, control: Optional[str] = None) -> dict:
        """The comparison (module docstring). With ``control``, the control
        (the reference with that guarantee broken) stands in for the
        program's answers."""
        pool = workload.param_pool(self.traffic, self.rules, self.seed)
        ref = self.reference()
        ctl = self.reference(control) if control else None
        answered = lg["answered"]
        served = set()
        wrong = undecided = 0
        steps = []  # (t_ns, padded rows, admitted values) a served request
        for xid, fid, acq, hashes, nows, t_ns in self.log:
            want = pool[(xid - 1) % len(pool)]
            if (xid < 1 or xid in served or fid != want.flow_id
                    or acq != want.acquire or hashes != want.hashes
                    or len(nows) != (1 if hashes else 0)):
                undecided += 1
                continue
            served.add(xid)
            status, admit = ref.request(fid, acq, hashes,
                                        nows[0] if nows else 0)
            steps.append((t_ns, max(8, 1 << (len(hashes) - 1).bit_length()),
                          int(admit.sum())))
            got = (ctl.request(fid, acq, hashes, nows[0] if nows else 0)[0]
                   if ctl is not None else answered.get(xid))
            if got is not None and int(got) != status:
                wrong += 1
        undecided += sum(1 for xid, st in answered.items()
                         if xid not in served
                         and st not in (OVERLOAD, FAIL, STANDBY))
        values = dict(
            requests_wrong=wrong,
            requests_unanswered=(len(lg["missing"]) + lg["duplicates"]
                                 + lg["n_bad"]),
            requests_undecided=undecided)
        return {"checks": [(k, values[k], LIMITS[k]) for k in LIMITS],
                "steps": steps}
