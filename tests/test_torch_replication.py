"""Warm-standby replication across packages (``sentinel_tpu_torch.ha.
replication`` and the port service's ``export_delta`` /
``apply_replication_delta`` against the JAX package's).

- Codecs: after the same seeded stream, the delta blobs (flow, namespace,
  outcome, breaker and param rows; the slim twin's rows and the fat rows;
  both sketches) and the REPL hello, ack and chunk frames are byte-equal
  between the packages; the port's decoders refuse the reference's garbage
  cases.
- Deltas across packages: a JAX primary's stream applied to a JAX and a
  port standby, and a port primary's to the same pair; each standby loaded
  its rules reversed, so every row is remapped. After each apply the
  standbys are bit-identical and their per-flow rows equal the primary's;
  after the stream their next verdicts equal each other's and the
  primary's. A SALSA standby fed fat rows is among them.
- The reference's fences: the generation bump on a reload, an epoch
  mismatch, an unknown flow / namespace / param rule (refused before
  anything mutates), the idle heartbeat, slim delta bytes at least 4x under
  fat ones, and exported rows that later steps do not rewrite.
- Over the wire, both ways: a JAX ``NativeTokenServer(replicate_to=...)``
  streams into a port ``NativeTokenServer(standby_of=...)``, and a port
  primary into a JAX standby. Before promotion the standby answers STANDBY
  on BATCH_FLOW, FLOW, PARAM_FLOW, lease and CONCURRENT frames, still
  answers PING and drops OUTCOME_REPORT; after the primary stops it is
  promoted (by hand, or by its watchdog) and serves the verdicts the
  stopped primary's service gives in process.
- The door's ``__init__`` signature is the reference's.

Every comparison is bitwise; the clocks are both packages' ``ManualClock``.
"""

import inspect
import os
import random
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster import protocol as JP  # noqa: E402
from sentinel_tpu.cluster.server_native import (  # noqa: E402
    NativeTokenServer as JNativeTokenServer,
)
from sentinel_tpu.ha import replication as JR  # noqa: E402
from sentinel_tpu.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as j_reset_metrics,
)

import torch_door_check as DK  # noqa: E402
import torch_outcome_check as OC  # noqa: E402
from sentinel_tpu_torch import interop  # noqa: E402
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.ha import replication as TR  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
)
from torch_ha_check import (  # noqa: E402
    JAX,
    KINDS,
    PARAM_FLOWS,
    PORT,
    assert_flow_rows_equal,
    assert_standbys_equal,
    manual_clocks,
    same,
    traffic,
    zipf,
)
from torch_parity import assert_arrays_equal  # noqa: E402
from torch_repl_check import (  # noqa: E402
    param_delta_bytes,
    param_rows_diff,
    standby_refusals,
)

SEED = 0xB10B
REPL = {"jax": JR, "port": TR}
PROTO = {"jax": JP, "port": P}
DOOR = {"jax": JNativeTokenServer, "port": NativeTokenServer}
OTHER = {"jax": "port", "port": "jax"}
# the watchdog's silence bound on the manual clock: above the sum of the
# serve phase's clock advances (5 x at most 260 ms), so the primary's ticks,
# which run on the system clock, cannot fall that far behind it
PROMOTE_AFTER_MS = 2000
# (sketch, slim_width): the slim twin's rows, or fat rows
VARIANTS = {"cms-slim": ("cms", 256), "cms-fat": ("cms", 0),
            "salsa-slim": ("salsa", 256), "salsa-fat": ("salsa", 0)}


@pytest.fixture
def clocks():
    with manual_clocks() as pair:
        yield pair


def _bootstrap(primary, standbys):
    """Each standby restores the primary's snapshot blob with its own
    package's decoder."""
    blob = REPL[_kind(primary)].encode_snapshot_blob(primary.export_state())
    for s in standbys:
        s.import_state(REPL[_kind(s)].decode_snapshot_blob(blob))


def _kind(svc):
    return "jax" if type(svc).__module__.startswith("sentinel_tpu.") \
        else "port"


def _assert_param_rows_equal(primary, standby, field, label):
    bad = param_rows_diff(primary, standby, field)
    assert not bad, f"{label}: {bad}"


# -- codecs ------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_delta_blobs_are_byte_equal(variant, clocks):
    sketch, slim = VARIANTS[variant]
    services = [KINDS[k].make(sketch=sketch, slim_width=slim)
                for k in ("jax", "port")]
    for s in services:
        s.replication_enable()
    rng = np.random.default_rng(SEED)
    keys = set()
    for tick in range(6):
        traffic(services, clocks, rng, rounds=2,
                check=lambda kind, outs: same(outs))
        if tick == 3:  # a reload mid-stream: a new generation, rows reset
            for s, kind in zip(services, (JAX, PORT)):
                s.load_param_rules([kind.param_rule(flow_id=f, count=2.0)
                                    for f in PARAM_FLOWS[:2]])
        deltas = [s.export_delta() for s in services]
        keys |= set(deltas[1])
        assert JR.encode_delta_blob(deltas[0]) == TR.encode_delta_blob(
            deltas[1]), f"tick {tick}"
    param_key = "param_slim" if slim else "param_counts"
    assert keys >= {"flow_ids", "ns_names", "outcome_fids", "breaker_fids",
                    "param_fids", param_key}, keys


@pytest.mark.parametrize("size", [0, 1000, 200_000])
def test_repl_frames_are_byte_equal(size):
    blob = bytes(random.Random(SEED + size).randrange(256)
                 for _ in range(size))
    assert P.encode_repl_hello(7, 3, 1234, 56, "10.0.0.1:9000") == \
        JP.encode_repl_hello(7, 3, 1234, 56, "10.0.0.1:9000")
    for code in P.ReplAck:
        assert P.encode_repl_ack(9, code, 4, 100) == JP.encode_repl_ack(
            9, int(code), 4, 100)
    frames = P.encode_repl_blob(5, P.MsgType.REPL_DELTA, 2, 11, blob)
    assert frames == JP.encode_repl_blob(5, JP.MsgType.REPL_DELTA, 2, 11,
                                         blob)
    asm, out = P.ReplBlobAssembler(), None
    for f in frames:
        out = asm.feed(P.peek_type(f[2:]), f[2:])
    assert out == (P.MsgType.REPL_DELTA, 2, 11, blob)


def test_blob_decoders_refuse_garbage():
    rng = random.Random(SEED)
    import json
    import zlib

    bad = [b"", *(os.urandom(rng.randrange(1, 4096)) for _ in range(20)),
           zlib.compress(b"not json"),
           zlib.compress(json.dumps({"version": 99}).encode())]
    for blob in bad:
        for decode in (TR.decode_delta_blob, TR.decode_snapshot_blob):
            with pytest.raises(ValueError):
                decode(blob)
    # a torn chunk stream (a skipped chunk) is refused, and the assembler
    # takes a fresh blob afterwards
    frames = P.encode_repl_blob(1, P.MsgType.REPL_DELTA, 1, 1, bytes(200_000))
    asm = P.ReplBlobAssembler()
    asm.feed(P.peek_type(frames[0][2:]), frames[0][2:])
    with pytest.raises(ValueError):
        asm.feed(P.peek_type(frames[2][2:]), frames[2][2:])
    out = None
    for f in P.encode_repl_blob(2, P.MsgType.REPL_DELTA, 1, 2, b"ok"):
        out = asm.feed(P.peek_type(f[2:]), f[2:])
    assert out[3] == b"ok"


# -- deltas across packages --------------------------------------------------
@pytest.mark.parametrize("variant", ["cms-slim", "salsa-fat"])
@pytest.mark.parametrize("primary_kind", ["jax", "port"])
def test_delta_stream_across_packages(primary_kind, variant, clocks):
    sketch, slim = VARIANTS[variant]
    primary = KINDS[primary_kind].make(sketch=sketch, slim_width=slim)
    primary.replication_enable()
    rng = np.random.default_rng(SEED + 1)
    traffic([primary], clocks, rng, rounds=3, check=lambda k, o: None)
    js = JAX.make(order=-1, sketch=sketch, slim_width=slim)
    ts = PORT.make(order=-1, sketch=sketch, slim_width=slim)
    assert ts._index.slot_of != primary._index.slot_of
    _bootstrap(primary, (js, ts))
    primary.export_delta()  # the snapshot subsumes what is dirty so far
    codec = REPL[primary_kind]
    seen = set()
    for tick in range(4):
        traffic([primary], clocks, rng, rounds=2, check=lambda k, o: None)
        blob = codec.encode_delta_blob(primary.export_delta())
        for s in (js, ts):
            s.apply_replication_delta(REPL[_kind(s)].decode_delta_blob(blob))
        delta = TR.decode_delta_blob(blob)
        seen |= set(delta)
        label = f"{primary_kind} primary, tick {tick}"
        assert_standbys_equal(js, ts, label)
        assert_flow_rows_equal(primary, ts, label)
        _assert_param_rows_equal(primary, ts, "slim" if slim else "counts",
                                 label)
    assert {"flow_ids", "outcome_fids", "breaker_fids", "param_fids"} <= seen

    def check(kind, outs):
        # the standbys agree with each other on everything; with fat rows
        # (or on pulls and reports) also with the primary; a slim standby
        # serves fat plus slim, the safe direction
        if kind == "param" and slim:
            same(outs[1:])
        else:
            same(outs)
        assert_standbys_equal(js, ts, f"after a {kind}")

    traffic([primary, js, ts], clocks, rng, rounds=3, check=check)


def test_generation_bumps_on_reload_and_drops_dirty_rows(clocks):
    for kind in (JAX, PORT):
        svc = kind.make()
        svc.replication_enable()
        gen0 = svc.state_generation()
        svc.request_batch_arrays(np.arange(10, dtype=np.int64))
        svc.load_rules([kind.rule(flow_id=2, count=10.0)])
        assert svc.state_generation() == gen0 + 1
        delta = svc.export_delta()
        assert delta["gen"] == gen0 + 1 and "flow_ids" not in delta
        svc.load_param_rules([])
        assert svc.export_delta()["gen"] == gen0 + 2


def _standby_pair(clocks):
    primary = PORT.make()
    primary.replication_enable()
    traffic([primary], clocks, np.random.default_rng(SEED), rounds=2,
            check=lambda k, o: None)
    standby = PORT.make(order=-1)
    _bootstrap(primary, [standby])
    return primary, standby


@pytest.mark.parametrize("fault", ["epoch", "flow", "namespace",
                                   "param_rule"])
def test_refused_delta_mutates_nothing(fault, clocks):
    primary, standby = _standby_pair(clocks)
    for c in clocks:
        c.advance(700)  # the delta rotates columns as well
    traffic([primary], clocks, np.random.default_rng(SEED + 2), rounds=1,
            check=lambda k, o: None)
    delta = primary.export_delta()
    if fault == "epoch":
        delta["epoch_ms"] += 1
        match = "epoch mismatch"
    elif fault == "flow":
        delta["breaker_fids"] = [*delta["breaker_fids"][:-1], 10**9]
        match = "unknown flow"
    elif fault == "namespace":
        delta["ns_names"] = [*delta["ns_names"][:-1], "elsewhere"]
        match = "unknown namespace"
    else:
        delta["param_fids"] = [*delta["param_fids"][:-1], 10**9]
        match = "unknown param rule"
    before = interop.state_to_numpy(standby._state)
    pbefore = interop.param_state_to_numpy(standby._param_state)
    with pytest.raises(ValueError, match=match):
        standby.apply_replication_delta(delta)
    after = interop.state_to_numpy(standby._state)
    pafter = interop.param_state_to_numpy(standby._param_state)
    for key in before:
        assert_arrays_equal(before[key], after[key], key)
    for key in pbefore:
        assert_arrays_equal(pbefore[key], pafter[key], f"param.{key}")


def test_idle_tick_ships_a_heartbeat(clocks):
    services = [k.make() for k in (JAX, PORT)]
    for s in services:
        s.replication_enable()
    standby = PORT.make(order=-1)
    _bootstrap(services[1], [standby])
    services[0].export_state()  # pins the JAX service's epoch alike
    for c in clocks:
        c.advance(1500)
    deltas = [s.export_delta() for s in services]
    assert not any(k.endswith(("_ids", "_fids", "_names"))
                   for k in deltas[1])
    blob = TR.encode_delta_blob(deltas[1])
    assert JR.encode_delta_blob(deltas[0]) == blob
    standby.apply_replication_delta(TR.decode_delta_blob(blob))
    assert_flow_rows_equal(services[1], standby, "after a heartbeat")


def test_slim_delta_bytes_are_4x_under_fat():
    """The reference's gate (``benchmarks/ha_drill.py::
    measure_param_delta_bytes``, copied as ``torch_repl_check.
    param_delta_bytes``): identical traffic and dirty slots, and the slim
    twin's delta blob at least 4x under the fat rows' blob."""
    sizes = param_delta_bytes("cpu")
    assert sizes["ratio"] >= 4.0, sizes


def test_slim_delta_bytes_do_not_depend_on_host_speed(monkeypatch):
    """The gate's bytes on a slow host: 40 ms added to every request (on
    the system clock the window rolled mid-stream and the ratio fell from
    7.8 to 4.66) give the same byte counts as an unslowed run."""
    fast = param_delta_bytes("cpu")
    served = DefaultTokenService.request_params_token

    def slow(self, *args, **kwargs):
        time.sleep(0.040)
        return served(self, *args, **kwargs)

    monkeypatch.setattr(DefaultTokenService, "request_params_token", slow)
    assert param_delta_bytes("cpu") == fast


def test_exported_rows_are_copies(clocks):
    svc = PORT.make()
    svc.replication_enable()
    ids = np.repeat(np.arange(8, dtype=np.int64), 3)
    svc.request_batch_arrays(ids)
    svc.request_params_token(2, 1, [1, 2])
    delta = svc.export_delta()
    kept = {k: np.array(v) for k, v in delta.items()
            if isinstance(v, np.ndarray)}
    for c in clocks:
        c.advance(600)  # a roll: the later steps rewrite every column
    svc.request_batch_arrays(ids)
    svc.request_params_token(2, 1, [1, 2])
    for key, arr in kept.items():
        assert_arrays_equal(arr, delta[key], key)
    with pytest.raises(RuntimeError, match="not enabled"):
        PORT.make(rules=False).export_delta()


# -- over the wire -----------------------------------------------------------
def _wait(predicate, what, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _serve(W, port, svc, clocks, rng, rounds, twin=None):
    """Pulls, PARAM_FLOW frames and reports through a door; with ``twin``,
    each verdict must equal the twin service's, called in process at the
    same clock."""
    conn = DK.RawConn(W, port)
    xid = 10
    try:
        conn.ping(1)
        for _ in range(rounds):
            ids = zipf(rng, 100)
            xid += 1
            conn.send(W.encode_batch_request(xid, ids))
            _x, st, rem, wt = W.decode_batch_response(conn.recv())
            if twin is not None:
                same([(st, rem, wt), twin.request_batch_arrays(ids)])
            fid = int(rng.choice(PARAM_FLOWS))
            hashes = [int(h) for h in rng.integers(0, 6, 3)]
            xid += 1
            conn.send(W.encode_request(W.FlowRequest(
                xid, fid, 1, False, W.MsgType.PARAM_FLOW, hashes)))
            r = W.decode_response(conn.recv())
            if twin is not None:
                assert r.status == int(
                    twin.request_params_token(fid, 1, hashes).status)
            fl, rt, exc = OC.report_rows(rng, ids[st == OC.OK], 60)
            xid += 1
            conn.send(W.encode_outcome_report(xid, fl, rt, exc))
            conn.ping(xid + 1)  # barrier: the report was ingested
            xid += 1
            if twin is not None:
                twin.report_outcomes(fl, rt, exc)
            ms = int(rng.integers(60, 260))
            for c in clocks:
                c.advance(ms)
    finally:
        conn.close()


@pytest.fixture(scope="module")
def cxx():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native doors")


@pytest.mark.parametrize("promotion", ["manual", "watchdog"])
@pytest.mark.parametrize("primary_kind", ["jax", "port"])
def test_replication_over_the_wire(primary_kind, promotion, cxx, clocks):
    t_reset_metrics()
    j_reset_metrics()
    sb_kind = OTHER[primary_kind]
    standby_svc = KINDS[sb_kind].make(rules=False, slim_width=0)
    standby = DOOR[sb_kind](
        standby_svc, port=0, idle_ttl_s=None, standby_of="primary",
        promote_after_ms=PROMOTE_AFTER_MS if promotion == "watchdog"
        else None)
    standby.start()  # warms up, which pins the standby's engine epoch
    for c in clocks:
        # another epoch for the primary: its HELLO then asks for the
        # snapshot bootstrap (a standby on the primary's timeline takes
        # deltas at once)
        c.advance(5)
    primary_svc = KINDS[primary_kind].make(slim_width=0)
    primary = None
    try:
        assert standby.is_standby
        primary = DOOR[primary_kind](
            primary_svc, port=0, idle_ttl_s=None,
            replicate_to=[("127.0.0.1", standby.port)], repl_interval_ms=20)
        primary.start()
        _wait(lambda: standby.applier.status()["snapshotsApplied"] >= 1,
              "no snapshot bootstrap")
        W = PROTO[sb_kind]
        conn = DK.RawConn(W, standby.port)
        try:
            standby_refusals(W, conn, standby_svc, np.arange(1, 9),
                             PARAM_FLOWS[0], 3)
        finally:
            conn.close()
        rng = np.random.default_rng(SEED + 3)
        _serve(PROTO[primary_kind], primary.port, primary_svc, clocks, rng,
               rounds=5)
        # two more documents: one whole export after the last frame
        applied = standby.applier.status()["deltasApplied"]
        _wait(lambda: standby.applier.status()["deltasApplied"]
              >= applied + 2, "the standby stopped applying deltas")
        primary.stop()
        assert_flow_rows_equal(primary_svc, standby_svc, "replicated")
        _assert_param_rows_equal(primary_svc, standby_svc, "counts",
                                 "replicated")
        assert standby.is_standby
        if promotion == "manual":
            assert standby.promote(reason="test")
        else:
            for c in clocks:
                c.advance(PROMOTE_AFTER_MS + 100)
            _wait(lambda: not standby.is_standby, "the watchdog never "
                  "promoted", timeout_s=5.0)
        _serve(PROTO[sb_kind], standby.port, standby_svc, clocks, rng,
               rounds=3, twin=primary_svc)
        # a deposed primary's late frame is told to stop
        conn = DK.RawConn(W, standby.port)
        try:
            conn.send(W.encode_repl_hello(99, 1, 0, 0, "late"))
            _xid, code, _g, _s = W.decode_repl_ack(conn.recv())
            assert code == W.ReplAck.NOT_STANDBY
        finally:
            conn.close()
    finally:
        if primary is not None:
            primary.stop()
        standby.stop()


# -- housekeeping ------------------------------------------------------------
def test_door_signature_is_the_reference():
    ref = inspect.signature(JNativeTokenServer.__init__).parameters
    got = inspect.signature(NativeTokenServer.__init__).parameters
    assert list(got) == list(ref)
    for name, p in ref.items():
        assert got[name].default == p.default, name
        assert got[name].kind == p.kind, name
