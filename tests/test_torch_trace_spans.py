"""Step spans of the port's flight recorder (``sentinel_tpu_torch.trace.ring``)
inside the service step, the param step and the native door's control lane,
on the CPU.

- Disarmed, a dispatch writes no row; armed at sample 0, a dispatch and its
  materializer write the ``svc.*`` tree (one step id, children inside their
  parents, the prep span's aux the prep cache's hit or miss), and so do the
  fused path and an oversized burst (a ``svc.burst`` over its device steps,
  no stage nested in itself).
- The param step's three spans share one step; through the door they are
  children of the ``door.control`` span of their frame.
- Spans map onto the wall clock by the anchor taken at ``arm``; the ring
  size is fixed; the operator's documents carry the spans and the anchor,
  the trace command as many steps as its ``limit``; the old
  device-boundary stages are gone.
"""

import json
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from torch_door_check import RawConn  # noqa: E402
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests,
)
from sentinel_tpu_torch.trace import blackbox, ring  # noqa: E402
from sentinel_tpu_torch.trace import spans as trace_spans  # noqa: E402

CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=256)
PARAM_FLOW = 1000
SVC = ("svc.dispatch", "svc.prep", "svc.launch", "svc.materialize",
       "svc.d2h", "svc.sinks")


@pytest.fixture(autouse=True)
def clean_ring():
    reset_server_metrics_for_tests()  # also resets the recorder
    yield
    ring.reset_for_tests()
    reset_server_metrics_for_tests()


def _service():
    svc = DefaultTokenService(
        CFG, device="cpu",
        param_config=ParamConfig(max_param_rules=16, width=128))
    svc.load_rules([ClusterFlowRule(flow_id=f, count=1e6,
                                    mode=ThresholdMode.GLOBAL)
                    for f in range(1, 40)])
    svc.load_param_rules([ClusterParamFlowRule(PARAM_FLOW, 100.0)])
    return svc


def _pull(n, seed=7):
    return np.random.default_rng(seed).integers(1, 40, n).astype(np.int64)


def _by_id(spans):
    return {s["span"]: s for s in spans}


def _inside(child, parent):
    return (parent["startNs"] <= child["startNs"] <= child["endNs"]
            <= parent["endNs"])


def _tree_ok(spans):
    """Every child lies inside its parent and shares its step, but a
    ``svc.dispatch``, which starts a step of its own."""
    ids = _by_id(spans)
    for s in spans:
        if s["parent"]:
            p = ids[s["parent"]]
            assert _inside(s, p), (s, p)
            assert (s["step"] != p["step"]) == (s["stage"] == "svc.dispatch")


def test_disarmed_dispatch_writes_no_row():
    svc = _service()
    svc.dispatch_batch_arrays(_pull(100))()
    svc.request_params_token(PARAM_FLOW, 1, [11, 12])
    assert ring.status()["totalEvents"] == 0
    assert ring.spans() == [] and ring.events() == []


def test_dispatch_and_materialize_write_the_span_tree():
    svc = _service()
    ids = _pull(200)
    svc.dispatch_batch_arrays(ids)()  # warm: the first prep misses
    ring.arm(sample=0.0)
    svc.dispatch_batch_arrays(ids)()  # the same pull: the prep cache hits
    svc.dispatch_batch_arrays(_pull(200, seed=8))()  # a new pull misses
    ring.disarm()
    spans = ring.spans()
    assert sorted(s["stage"] for s in spans) == sorted(SVC * 2)
    _tree_ok(spans)
    steps = sorted({s["step"] for s in spans})
    assert len(steps) == 2
    for step, hit in zip(steps, (1, 0)):
        mine = {s["stage"]: s for s in spans if s["step"] == step}
        assert set(mine) == set(SVC)
        disp, mat = mine["svc.dispatch"], mine["svc.materialize"]
        assert disp["parent"] == 0 and mat["parent"] == 0
        assert disp["aux"] == 200 and mat["aux"] == 200
        for child in ("svc.prep", "svc.launch"):
            assert mine[child]["parent"] == disp["span"]
        for child in ("svc.d2h", "svc.sinks"):
            assert mine[child]["parent"] == mat["span"]
        assert mine["svc.prep"]["aux"] == hit
        assert mine["svc.launch"]["aux"] == 200
        assert disp["endNs"] <= mat["startNs"]


def _no_stage_in_itself(spans):
    """No span has an ancestor of its own stage."""
    ids = _by_id(spans)
    for s in spans:
        p = ids.get(s["parent"])
        while p is not None:
            assert p["stage"] != s["stage"], (s, p)
            p = ids.get(p["parent"])


def test_fused_step_and_oversized_burst():
    """612 rows at batch 256: a fused depth-2 step and one 100-row chunk,
    each a step of its own under one ``svc.burst``; each materializes as
    a root with its own step id."""
    svc = _service()
    ring.arm(sample=0.0)
    status, _rem, _wait = svc.dispatch_batch_arrays(_pull(612))()
    ring.disarm()
    assert status.shape == (612,)
    spans = ring.spans()
    _tree_ok(spans)
    _no_stage_in_itself(spans)
    assert len({s["step"] for s in spans}) == 3  # the burst, two steps
    roots = [s for s in spans if s["parent"] == 0]
    assert sorted((s["stage"], s["aux"]) for s in roots) == [
        ("svc.burst", 612), ("svc.materialize", 100),
        ("svc.materialize", 512)]
    burst = next(s for s in roots if s["stage"] == "svc.burst")
    inner = [s for s in spans if s["stage"] == "svc.dispatch"]
    assert all(s["parent"] == burst["span"] for s in inner)
    assert sorted(s["aux"] for s in inner) == [2, 100]  # depth 2; 100 rows
    fused = next(s for s in inner if s["aux"] == 2)
    kids = [s for s in spans if s["parent"] == fused["span"]]
    assert sorted(s["stage"] for s in kids) == [
        "svc.launch", "svc.prep", "svc.prep"]  # one prep a frame
    assert next(s for s in kids if s["stage"] == "svc.launch")["aux"] == 512
    for d in inner:
        (m,) = [s for s in roots if s["stage"] == "svc.materialize"
                and s["step"] == d["step"]]
        assert m["aux"] == (512 if d is fused else 100)
        assert sorted(s["stage"] for s in spans
                      if s["parent"] == m["span"]) == ["svc.d2h", "svc.sinks"]


def test_a_four_frame_pull_is_one_fused_step_counted_once():
    """The native door's shape, a pull of 4 x ``batch_size`` rows: one
    ``svc.burst`` over one depth-4 ``svc.dispatch``, and one
    ``svc.materialize``; a reader of ``svc.dispatch`` sees each device step
    once."""
    svc = _service()
    ring.arm(sample=0.0)
    for seed in (1, 2):
        svc.dispatch_batch_arrays(_pull(4 * CFG.batch_size, seed))()
    ring.disarm()
    spans = ring.spans()
    _tree_ok(spans)
    _no_stage_in_itself(spans)
    counts = {}
    for s in spans:
        counts[s["stage"]] = counts.get(s["stage"], 0) + 1
    assert counts == {"svc.burst": 2, "svc.dispatch": 2, "svc.prep": 8,
                      "svc.launch": 2, "svc.materialize": 2, "svc.d2h": 2,
                      "svc.sinks": 2}
    disp = [s for s in spans if s["stage"] == "svc.dispatch"]
    assert [s["aux"] for s in disp] == [4, 4]
    for d in disp:
        mine = {s["stage"] for s in spans if s["step"] == d["step"]}
        assert mine == set(SVC)


def test_param_step_spans_share_one_step():
    svc = _service()
    ring.arm(sample=0.0)
    svc.request_params_token(PARAM_FLOW, 1, [11, 12, 13])
    svc.request_params_token(4242, 1, [11])  # no rule: prep only
    ring.disarm()
    spans = ring.spans()
    first = [s for s in spans if s["step"] == spans[0]["step"]]
    assert [(s["stage"], s["aux"]) for s in first] == [
        ("param.prep", 3), ("param.launch", 8), ("param.sync", 0)]
    assert all(s["parent"] == 0 for s in first)
    assert first[0]["endNs"] <= first[1]["startNs"]
    assert first[1]["endNs"] <= first[2]["startNs"]
    rest = [s for s in spans if s["step"] != spans[0]["step"]]
    assert [s["stage"] for s in rest] == ["param.prep"]


@pytest.fixture(scope="module")
def cxx():
    from sentinel_tpu_torch.cluster.server_native import native_available

    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    assert native_available()


def test_door_control_span_parents_the_param_step(cxx):
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer

    server = NativeTokenServer(_service(), port=0, idle_ttl_s=None)
    server.start()
    try:
        conn = RawConn(P, server.port, timeout_s=10.0)
        try:
            conn.ping(1)
            ring.arm(sample=0.0)
            conn.send(P.encode_request(P.FlowRequest(
                7, PARAM_FLOW, 1, False, P.MsgType.PARAM_FLOW, (5, 6))))
            assert P.decode_response(conn.recv()).xid == 7
            deadline = time.monotonic() + 5.0
            while (not any(s["stage"] == "door.control"
                           for s in ring.spans())
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            conn.close()
    finally:
        ring.disarm()
        server.stop()
    spans = ring.spans()
    door = [s for s in spans if s["stage"] == "door.control"]
    assert len(door) == 1 and door[0]["aux"] == int(P.MsgType.PARAM_FLOW)
    kids = [s for s in spans if s["parent"] == door[0]["span"]]
    assert [s["stage"] for s in kids] == [
        "param.prep", "param.launch", "param.sync"]
    _tree_ok(spans)
    # sample 0: no per-frame xid event
    assert not [e for e in ring.events() if e["xid"]]


def test_spans_land_on_the_wall_clock():
    ring.arm(sample=0.0)
    w0, m0 = time.time_ns(), time.monotonic_ns()
    sp = ring.begin(ring.SVC_DISPATCH, 5)
    time.sleep(0.02)
    ring.end(sp)
    m1, w1 = time.monotonic_ns(), time.time_ns()
    (mono,) = ring.spans()
    (wall,) = ring.spans(wall=True)
    assert m0 <= mono["startNs"] < mono["endNs"] <= m1
    assert w0 <= wall["startNs"] < wall["endNs"] <= w1
    assert wall["endNs"] - wall["startNs"] == mono["endNs"] - mono["startNs"]
    assert mono["endNs"] - mono["startNs"] >= 20_000_000
    anchor = ring.clock_anchor()
    assert wall["startNs"] - mono["startNs"] == (
        anchor["wallNs"] - anchor["monotonicNs"])


def test_sample_zero_keeps_spans_in_a_fixed_ring():
    size = ring.DEFAULT_RING_EVENTS
    ring.arm(sample=0.0)
    assert ring.status()["ringEvents"] == size
    ring.record(ring.CLIENT_IN, xid=77)  # sampled out
    ring.record(ring.BROWNOUT, aux=2)  # control plane: recorded
    assert [e["stage"] for e in ring.events()] == ["brownout"]
    for _ in range(size + 8):
        ring.end(ring.begin(ring.SVC_PREP, 1))
    st = ring.status()
    assert st["ringEvents"] == size and st["totalEvents"] == size
    assert st["threads"][0]["dropped"] == 9
    assert ring.events() == []  # wrapped out
    assert len(ring.spans()) == size


def test_an_exception_inside_a_span_leaves_the_stack_clean():
    ring.arm(sample=0.0)
    outer = ring.begin(ring.SVC_MATERIALIZE)
    ring.begin(ring.SVC_DISPATCH)  # never ended (an exception passed it)
    ring.begin(ring.SVC_D2H)  # a leaf, never ended
    ring.end(outer)
    after = ring.begin(ring.SVC_DISPATCH)
    ring.end(after)
    spans = ring.spans()
    assert [s["stage"] for s in spans] == ["svc.materialize", "svc.dispatch"]
    assert spans[1]["parent"] == 0 and spans[1]["step"] != spans[0]["step"]


class _Boom(RuntimeError):
    pass


def test_a_failed_dispatch_or_frame_leaves_no_span_open(monkeypatch):
    """A step that raises (its caller carries on, as the door's lanes do)
    still writes its spans, and the next step is a root of its own."""
    svc = _service()
    ring.arm(sample=0.0)

    def boom(*_a):
        raise _Boom()

    monkeypatch.setattr(svc, "_run_step", boom)
    for n in (100, 612):  # a plain step, a burst
        with pytest.raises(_Boom):
            svc.dispatch_batch_arrays(_pull(n))
    monkeypatch.undo()
    mat = svc.dispatch_batch_arrays(_pull(100))
    monkeypatch.setattr(svc, "_record_served", boom)
    with pytest.raises(_Boom):
        mat()
    monkeypatch.undo()
    svc.dispatch_batch_arrays(_pull(100))()
    ring.disarm()
    spans = ring.spans()
    roots = [s for s in spans if s["parent"] == 0]
    assert [(s["stage"], s["aux"]) for s in roots] == [
        ("svc.dispatch", 100), ("svc.burst", 612), ("svc.dispatch", 100),
        ("svc.materialize", 100), ("svc.dispatch", 100),
        ("svc.materialize", 100)]
    assert len({s["step"] for s in roots}) == 4
    last = [s for s in spans if s["step"] == roots[-1]["step"]]
    assert sorted(s["stage"] for s in last) == sorted(SVC)
    _tree_ok(last)


def test_operator_documents_carry_step_spans_and_the_anchor(tmp_path):
    from sentinel_tpu_torch.transport import handlers as H

    svc = _service()
    ring.arm(sample=1.0)
    ring.record(ring.CLIENT_IN, xid=77)
    ring.record(ring.REPLY_OUT, xid=77)
    svc.dispatch_batch_arrays(_pull(50))()
    anchor = ring.clock_anchor()
    path = trace_spans.write_artifact(str(tmp_path / "trace-spans-1.json"))
    doc = json.load(open(path))
    assert doc["schema"] == "sentinel-trace-spans/1"
    assert doc["clockAnchor"] == anchor
    assert sorted(s["stage"] for s in doc["stepSpans"]) == sorted(SVC)
    assert doc["completeness"]["complete"] == 1
    box = json.load(open(blackbox.dump("test", directory=str(tmp_path))))
    assert box["schema"] == "sentinel-blackbox/1"
    assert box["clockAnchor"] == anchor
    assert sorted(s["stage"] for s in box["stepSpans"]) == sorted(SVC)
    assert {e["stage"] for e in box["events"]} == {"client_in", "reply_out"}
    out = H.cmd_cluster_server_trace({"action": "spans"}, "")
    assert out["clockAnchor"] == anchor
    assert out["stepSpans"] == doc["stepSpans"]
    assert out["completeness"]["spans"] == 1
    # ``limit`` bounds the step spans too: the newest steps only
    svc.dispatch_batch_arrays(_pull(60))()
    assert len({s["step"] for s in ring.spans()}) == 2
    out = H.cmd_cluster_server_trace({"action": "spans", "limit": "1"}, "")
    assert sorted(s["stage"] for s in out["stepSpans"]) == sorted(SVC)
    assert {s["aux"] for s in out["stepSpans"]
            if s["stage"] == "svc.dispatch"} == {60}


def test_no_device_boundary_stages_remain():
    svc = _service()
    ring.arm(sample=1.0)
    svc.dispatch_batch_arrays(_pull(612))()
    svc.request_params_token(PARAM_FLOW, 1, [11])
    names = ({e["stage"] for e in ring.events()}
             | {s["stage"] for s in ring.spans()})
    assert not names & {"device_in", "device_out", "fuse"}
    assert not set(ring.STAGE_NAMES.values()) & {
        "device_in", "device_out", "fuse"}
    for code in ("DEVICE_IN", "DEVICE_OUT", "FUSE"):
        assert not hasattr(ring, code)
