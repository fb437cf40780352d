"""Live namespace moves in the port (``sentinel_tpu_torch.cluster.
rebalance`` and the service's MOVE calls) against the JAX package's.

The cases of the reference's ``tests/test_rebalance.py`` (l.62-445) on the
port, at the reference's ``_CFG`` on both packages' ``ManualClock``:

- the shard map and its epoch fence; the MOVE_STATE codec and its garbage
  cases;
- ``begin_move``'s mask with a lossless ``abort_move``, export and import of
  window sums, the param move for both sketches with bit-equal next
  verdicts, ``MoveTarget`` staging without mutation; each in lockstep on a
  JAX and a port service, every result compared bitwise;
- through two port ``NativeTokenServer``s: a live move, the kill at each
  protocol step (one owner, bit-equal counters), a dropped MOVE_BEGIN's or
  MOVE_STATE's abort and retry, and a commit under a device stall that the
  port's ``RoutingTokenClient`` follows.

Across packages: MOVE_STATE blobs byte-equal and export documents equal leaf
by leaf after one seeded stream (``torch_ha_check``), both sketches; a JAX
``MoveCoordinator`` moving into a port door and a port one into a JAX door,
with equal sums and next verdicts; and a grouped and a fused pull in which
the hottest flow's namespace is moving.
"""

import threading
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster import rebalance as JRB  # noqa: E402
from sentinel_tpu.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu.cluster.server_native import (  # noqa: E402
    NativeTokenServer as JNativeTokenServer,
)
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine import TokenStatus as JStatus  # noqa: E402
from sentinel_tpu.engine.param import ParamConfig as JParamConfig  # noqa: E402
from sentinel_tpu.engine.rules import (  # noqa: E402
    ThresholdMode as JTM,
    encode_degrade_rule as j_enc_degrade,
    encode_rule as j_enc_rule,
)
from sentinel_tpu.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as j_reset_metrics,
)

from sentinel_tpu_torch import chaos  # noqa: E402
from sentinel_tpu_torch.cluster import rebalance as RB  # noqa: E402
from sentinel_tpu_torch.cluster.rebalance import (  # noqa: E402
    MoveCoordinator,
    MoveTarget,
    ShardMap,
    ShardMapPublisher,
    decode_move_state_blob,
    encode_move_state_blob,
)
from sentinel_tpu_torch.cluster.client import (  # noqa: E402
    TokenClient as TTokenClient,
)
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.server_native import (  # noqa: E402
    NativeTokenServer,
    native_available,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.engine import ClusterFlowRule  # noqa: E402
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.engine.rules import (  # noqa: E402
    ThresholdMode,
    encode_degrade_rule,
    encode_rule,
)
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
)
import torch_door_check as DK  # noqa: E402
from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from torch_ha_check import JAX, PORT, manual_clocks, traffic  # noqa: E402
from torch_parity import assert_arrays_equal  # noqa: E402

# the reference's geometry: a wide, slow-rotating window, so that natural
# expiry never perturbs a bit-equality assertion
_KW = dict(max_flows=64, max_namespaces=8, batch_size=64, bucket_ms=5000,
           n_buckets=2)
_CFG = EngineConfig(**_KW)
_JCFG = JConfig(**_KW)
SEED = 0x5EB


@pytest.fixture
def clocks():
    with manual_clocks() as pair:
        yield pair


def _pair(**pkw):
    """A JAX and a port service at ``_CFG`` (``pkw``: the param config)."""
    jp = {"param_config": JParamConfig(**pkw)} if pkw else {}
    tp = {"param_config": ParamConfig(**pkw)} if pkw else {}
    return (JService(_JCFG._replace(decide_impl="xla"), **jp),
            DefaultTokenService(_CFG, device="cpu", **tp))


def _rules(fid, qps, ns):
    return (JRule(fid, qps, JTM.GLOBAL, ns),
            ClusterFlowRule(fid, qps, ThresholdMode.GLOBAL, ns))


def _sums(doc):
    """An export document's ``{flow_id: row sum}``."""
    rows = np.asarray(doc["flow_sums"], dtype=np.float64)
    return {fid: float(rows[i].sum())
            for i, fid in enumerate(doc["flow_ids"])}


def _result(r):
    return (int(r.status), int(r.remaining), int(r.wait_ms), r.endpoint)


def assert_docs_equal(jdoc, tdoc, skip=()):
    """Two export documents (either package's), leaf by leaf: rules by
    their codec dicts, arrays bitwise with the dtype."""
    assert set(jdoc) == set(tdoc), set(jdoc) ^ set(tdoc)
    for key in jdoc:
        if key in skip:
            continue
        a, b = jdoc[key], tdoc[key]
        if key == "rules":
            assert [_rule_doc(r) for r in a] == [_rule_doc(r) for r in b]
        elif key == "degrade_rules":
            assert [_degrade_doc(r) for r in a] == [
                _degrade_doc(r) for r in b]
        elif key == "param_rules":
            assert [_param_doc(r) for r in a] == [_param_doc(r) for r in b]
        elif isinstance(a, np.ndarray):
            assert_arrays_equal(a, b, key)
        else:
            assert a == b, key


def _rule_doc(r):
    return (j_enc_rule if type(r).__module__.startswith("sentinel_tpu.")
            else encode_rule)(r)


def _degrade_doc(r):
    return (j_enc_degrade if type(r).__module__.startswith("sentinel_tpu.")
            else encode_degrade_rule)(r)


def _param_doc(r):
    return (int(r.flow_id), float(r.count),
            tuple(r.item_thresholds or ()), r.namespace)


# -- shard map and codec -----------------------------------------------------
def test_shard_map_assign_bumps_epoch_and_roundtrips():
    m0 = ShardMap()
    m1 = m0.assign("ns-a", "10.0.0.1:1111")
    m2 = m1.assign("ns-b", "10.0.0.2:2222").assign_global(7, "10.0.0.3:3")
    assert (m0.epoch, m1.epoch, m2.epoch) == (0, 1, 3)
    assert m1.endpoint_of == {"ns-a": "10.0.0.1:1111"}  # m0 untouched
    assert not m0.endpoint_of
    back = ShardMap.from_doc(m2.to_doc())
    assert back.epoch == 3 and dict(back.endpoint_of) == dict(m2.endpoint_of)
    assert back.coordinator_of(7) == "10.0.0.3:3"
    # the documents and the push blobs are the reference's
    j2 = JRB.ShardMap().assign("ns-a", "10.0.0.1:1111").assign(
        "ns-b", "10.0.0.2:2222").assign_global(7, "10.0.0.3:3")
    assert m2.to_doc() == j2.to_doc()
    blob = RB.encode_shard_map_doc(m2)
    assert blob == JRB.encode_shard_map_doc(j2)
    assert RB.decode_shard_map_doc(blob) == m2
    with pytest.raises(ValueError):
        RB.decode_shard_map_doc(b"garbage")


def test_shard_map_publisher_fences_stale_epochs():
    pub = ShardMapPublisher()
    seen = []
    pub.listen(lambda m: seen.append(m.epoch if m else None))
    assert pub.publish(ShardMap(2, {"a": "h:1"}))
    assert not pub.publish(ShardMap(2, {"a": "h:9"}))  # same epoch
    assert not pub.publish(ShardMap(1, {"a": "h:9"}))  # older
    assert pub.current().epoch == 2
    assert pub.current().endpoint_of["a"] == "h:1"
    assert 2 in seen and seen.count(2) == 1


def test_move_state_blob_roundtrip():
    def doc(rule, param_rule):
        return {
            "namespace": "codec",
            "wall_ms": 123456,
            "interval_ms": 1000,
            "rules": [rule(5, 10.0, "codec")],
            "param_rules": [param_rule(6, 4.0, ((2, 8.0),), "codec")],
            "flow_ids": [5],
            "flow_sums": np.array([3.0], np.float32),
            "occupy_sums": np.array([1.0], np.float32),
            "ns_sum": np.array([4.0], np.float32),
            "param_fids": [6],
            "param_sums": np.arange(6, dtype=np.float32).reshape(2, 3),
        }

    tdoc = doc(lambda f, q, n: _rules(f, q, n)[1], ClusterParamFlowRule)
    blob = encode_move_state_blob(tdoc)
    assert blob == JRB.encode_move_state_blob(
        doc(lambda f, q, n: _rules(f, q, n)[0], JParamRule))
    out = decode_move_state_blob(blob)
    assert out["namespace"] == "codec"
    assert out["wall_ms"] == 123456 and out["interval_ms"] == 1000
    assert out["rules"] == tdoc["rules"]
    assert out["param_rules"] == tdoc["param_rules"]
    assert out["flow_ids"] == [5] and out["param_fids"] == [6]
    for key in ("flow_sums", "occupy_sums", "ns_sum", "param_sums"):
        assert_arrays_equal(out[key], tdoc[key], key)


@pytest.mark.parametrize(
    "blob",
    [
        b"",
        b"not even zlib",
        zlib.compress(b"not json"),
        zlib.compress(b'{"version": 99}'),  # wrong version
        zlib.compress(b'{"version": 1, "namespace": "x"}'),  # missing keys
    ],
)
def test_move_state_blob_rejects_malformed(blob):
    with pytest.raises(ValueError):
        decode_move_state_blob(blob)


# -- the service: MOVED mask, lossless abort, export / import -----------------
def test_begin_move_masks_flows_and_abort_is_lossless(clocks):
    services = _pair()
    for s, r in zip(services, _rules(11, 100.0, "mv")):
        s.load_namespace_rules("mv", [r])
    for _ in range(5):
        assert all(s.request_token(11).ok for s in services)
    docs0 = [s.export_namespace_state("mv") for s in services]
    assert_docs_equal(*docs0)
    outs = []
    for s in services:
        s.begin_move("mv", "10.0.0.9:1234", 3)
        r = s.request_token(11)
        assert r.status == TokenStatus.MOVED
        assert r.remaining == 3  # the shard-map epoch rides remaining
        assert r.endpoint == "10.0.0.9:1234"
        assert s.moved_redirect(11) == ("10.0.0.9:1234", 3)
        assert s.moving_namespaces() == {"mv": ("10.0.0.9:1234", 3)}
        assert s.metrics_snapshot()[11]["moved_epoch"] == 3.0
        # a lease grant on a moving namespace answers MOVED too
        lease = s.lease_grant(11, 4)
        assert (int(lease.status), lease.tokens, lease.endpoint) == (
            int(TokenStatus.MOVED), 3, "10.0.0.9:1234")
        # an idempotent re-begin to the same destination (a retry) ...
        s.begin_move("mv", "10.0.0.9:1234", 3)
        # ... but a second claimant is a split brain
        with pytest.raises(ValueError):
            s.begin_move("mv", "10.9.9.9:1", 4)
        outs.append(_result(r))
        s.abort_move("mv")
    assert outs[0] == outs[1]
    docs1 = [s.export_namespace_state("mv") for s in services]
    for d0, d1 in zip(docs0, docs1):
        assert_arrays_equal(d0["flow_sums"], d1["flow_sums"], "flow_sums")
        assert_arrays_equal(d0["ns_sum"], d1["ns_sum"], "ns_sum")
    for s in services:
        assert s.moved_redirect(11) is None
        assert s.request_token(11).ok
        assert "moved_epoch" not in s.metrics_snapshot()[11]


def test_export_import_preserves_window_sums(clocks):
    services = _pair()
    for s, r in zip(services, _rules(21, 100.0, "xp")):
        s.load_namespace_rules("xp", [r])
    for _ in range(7):
        assert all(s.request_token(21).ok for s in services)
    docs = [s.export_namespace_state("xp") for s in services]
    assert_docs_equal(*docs)
    others = _pair()
    for o, d in zip(others, docs):
        o.import_namespace_state(d)
    got = [o.export_namespace_state("xp") for o in others]
    assert_docs_equal(*got)
    assert [r.flow_id for r in got[1]["rules"]] == [21]
    assert _sums(got[1])[21] == _sums(docs[1])[21] >= 7.0
    assert_arrays_equal(got[1]["ns_sum"], docs[1]["ns_sum"], "ns_sum")
    # the destination continues the window: the next verdicts agree
    for _ in range(100):
        assert _result(others[0].request_token(21)) == _result(
            others[1].request_token(21))


@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_param_sketch_move_blob_roundtrip_bit_equal_verdict(sketch, clocks):
    """The param plane moves through the real blob codec and folds into the
    destination so that its next verdicts equal the source's, merged SALSA
    pairs included; the port's documents, blobs and destination planes
    equal the reference's."""
    from sentinel_tpu_torch import interop

    kw = dict(max_param_rules=8, depth=2, width=32, sketch=sketch,
              impl="jax")
    srcs, dsts = _pair(**kw), _pair(**kw)
    for s, rule in zip(srcs, (JParamRule, ClusterParamFlowRule)):
        s.load_namespace_param_rules(
            "pm", [rule(flow_id=61, count=1e9, namespace="pm")])
    rng = np.random.default_rng(0x5A15A)
    vals = rng.integers(-2 ** 63, 2 ** 63 - 1, size=16, dtype=np.int64)
    stream = vals[rng.integers(0, 16, size=400)]
    for off in range(0, 400, 50):
        for s in srcs:
            s.request_params_token(
                61, 1024, [int(h) for h in stream[off:off + 50]])
    if sketch == "salsa":
        assert int(srcs[1]._param_state.merges.sum()) > 0, (
            "stream too cold to exercise the merge path")
    docs = [s.export_namespace_state("pm") for s in srcs]
    assert_docs_equal(*docs)
    blobs = [JRB.encode_move_state_blob(docs[0]),
             encode_move_state_blob(docs[1])]
    assert blobs[0] == blobs[1]
    dsts[0].import_namespace_state(JRB.decode_move_state_blob(blobs[0]))
    dsts[1].import_namespace_state(decode_move_state_blob(blobs[1]))
    jp = interop.param_state_to_numpy(dsts[0]._param_state)
    tp = interop.param_state_to_numpy(dsts[1]._param_state)
    for key in jp:
        assert_arrays_equal(jp[key], tp[key], f"param.{key}")
    for value in (int(stream[0]), int(vals[-1])):
        results = [_result(s.request_params_token(61, 1, [value]))
                   for s in (*srcs, *dsts)]
        assert len(set(results)) == 1, results


def test_move_target_stages_without_mutating(clocks):
    """MOVE_STATE only stages; a closed session discards the claim and the
    service never sees the document."""
    src = DefaultTokenService(_CFG, device="cpu")
    src.load_namespace_rules("st", [_rules(31, 50.0, "st")[1]])
    svc = DefaultTokenService(_CFG, device="cpu")
    target = MoveTarget(svc)
    sess = target.connection()
    assert target._begin(sess.session_id, "st", 7, "peer:1") == 0  # OK
    assert target._stage(sess.session_id, 7, encode_move_state_blob(
        src.export_namespace_state("st"))) == 0
    assert target.status()["staged"][0]["hasState"]
    # another session may not claim it, nor stage or commit for it
    other = target.connection()
    assert target._begin(other.session_id, "st", 7, "peer:2") != 0
    assert target._commit(other.session_id, "st", 7) != 0
    sess.closed()  # the connection drops before the commit
    assert not target.status()["staged"]
    assert not svc.export_namespace_state("st")["rules"]
    assert not svc.current_rules()


def test_hottest_flow_moving_in_grouped_and_fused_pulls(clocks):
    """A Zipf pull whose hottest flow's namespace is moving, grouped and
    fused (four frames): the masked rows answer MOVED with the epoch and
    count nothing, every other row's verdict and every counter equal the
    reference's."""
    from torch_ha_check import zipf

    services = [JAX.make(), PORT.make()]
    rng = np.random.default_rng(SEED)
    for s in services:
        s._fuse_depths = (4,)  # the kit's services do not fuse
        # flow 0, the Zipf-hottest, is in "ns1" (flow_id % 3 == 0)
        s.begin_move("ns1", "10.0.0.7:7", 9)
    docs0 = [s.export_namespace_state("ns1") for s in services]
    for n in (100, 4 * 128):
        ids = zipf(rng, n)
        assert (ids == 0).sum() == max(np.bincount(ids))
        outs = [s.request_batch_arrays(ids) for s in services]
        for a, b in zip(*outs):
            assert_arrays_equal(a, b, f"pull of {n}")
        moved = (ids % 3 == 0) & (ids < 60)
        assert (outs[1][0][moved] == int(TokenStatus.MOVED)).all()
        assert (outs[1][1][moved] == 9).all()
        assert not (outs[1][0][~moved] == int(TokenStatus.MOVED)).any()
        for c in clocks:
            c.advance(130)
    docs1 = [s.export_namespace_state("ns1") for s in services]
    for d0, d1 in zip(docs0, docs1):
        for key in ("flow_sums", "occupy_sums", "ns_sum"):
            assert_arrays_equal(d0[key], d1[key], key)
    assert_docs_equal(*docs1)


# -- across packages ---------------------------------------------------------
@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_move_state_blobs_are_byte_equal(sketch, clocks):
    """After one seeded stream (pulls, reports with breakers, param
    requests, shaped flows), each namespace's export document is equal leaf
    by leaf and its MOVE_STATE blob byte-equal between the packages."""
    services = [JAX.make(sketch=sketch), PORT.make(sketch=sketch)]
    traffic(services, clocks, np.random.default_rng(SEED), rounds=6,
            check=lambda kind, outs: None)
    for ns in ("default", "ns1"):
        docs = [s.export_namespace_state(ns) for s in services]
        assert_docs_equal(*docs)
        assert len(docs[1]["flow_ids"]) and len(docs[1]["param_fids"])
        assert JRB.encode_move_state_blob(docs[0]) == \
            encode_move_state_blob(docs[1]), ns


@pytest.fixture
def cxx():
    import shutil

    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    assert native_available()


@pytest.fixture
def clean_metrics():
    t_reset_metrics()
    j_reset_metrics()
    yield
    t_reset_metrics()
    j_reset_metrics()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_move_across_packages(direction, cxx, clean_metrics, clocks):
    """A JAX ``MoveCoordinator`` moves "ns1" of the seeded stream's service
    into a port door, and a port one into a JAX door. The destination's
    document equals the source's (its sums are the source's last), and its
    next verdicts equal those of a service of the source's package that
    imported the same blob in process."""
    src_kind, dst_kind = ((JAX, PORT) if direction == "jax-to-port"
                          else (PORT, JAX))
    coord_mod = JRB if src_kind is JAX else RB
    door_cls = NativeTokenServer if dst_kind is PORT else JNativeTokenServer
    src = src_kind.make()
    traffic([src], clocks, np.random.default_rng(SEED), rounds=4,
            check=lambda kind, outs: None)
    doc0 = src.export_namespace_state("ns1")
    blob = coord_mod.encode_move_state_blob(doc0)
    twin = src_kind.make(rules=False)
    twin.import_namespace_state(coord_mod.decode_move_state_blob(blob))
    dst = dst_kind.make(rules=False)
    server = door_cls(dst, host="127.0.0.1", port=0, idle_ttl_s=None)
    server.start()
    try:
        coord = coord_mod.MoveCoordinator(src, self_endpoint="src:1")
        assert coord.move_namespace("ns1", f"127.0.0.1:{server.port}",
                                    epoch=5), coord.last_error
        assert src.moving_namespaces()["ns1"][1] == 5
    finally:
        server.stop()
    got = dst.export_namespace_state("ns1")
    assert_docs_equal(doc0, got)
    assert_docs_equal(twin.export_namespace_state("ns1"), got)
    from torch_ha_check import zipf

    rng = np.random.default_rng(SEED + 1)
    moved = np.asarray(doc0["flow_ids"], np.int64)
    for _ in range(3):
        ids = moved[zipf(rng, 100) % moved.size]
        a, b = (twin.request_batch_arrays(ids),
                dst.request_batch_arrays(ids))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        fid = int(doc0["param_fids"][0])
        assert int(twin.request_params_token(fid, 1, [1, 2]).status) == \
            int(dst.request_params_token(fid, 1, [1, 2]).status)
        for c in clocks:
            c.advance(170)
    src.abort_move("ns1")  # the source serves the namespace again
    assert not src.moving_namespaces()


# -- the port's asyncio door as a move source and destination ----------------
_DOORS = {"asyncio": TokenServer, "native": NativeTokenServer}


@pytest.mark.parametrize("doors", ["asyncio-asyncio", "asyncio-native",
                                   "native-asyncio"])
def test_live_move_through_the_asyncio_door(doors, clean_metrics, clocks):
    """The port's ``TokenServer`` as a move's source and destination (the
    reference's own moves run through its asyncio door): a port
    ``MoveCoordinator`` moves a namespace with a spent window while a
    client of the destination is connected, so the destination's push hub
    sends the import's rule-epoch push; the commit goes through, the
    destination owns the window, and a stale client of the source is
    redirected (the asyncio door names the new owner in the reply)."""
    src_door, dst_door = doors.split("-")
    fid = 101
    svc_src = DefaultTokenService(_CFG, device="cpu")
    svc_dst = DefaultTokenService(_CFG, device="cpu")
    svc_src.load_namespace_rules("w1", [_rules(fid, 100.0, "w1")[1]])
    srv_src = _DOORS[src_door](svc_src, host="127.0.0.1", port=0,
                               idle_ttl_s=None)
    srv_dst = _DOORS[dst_door](svc_dst, host="127.0.0.1", port=0,
                               idle_ttl_s=None)
    srv_src.start()
    srv_dst.start()
    src_ep = f"127.0.0.1:{srv_src.port}"
    dst_ep = f"127.0.0.1:{srv_dst.port}"
    watcher = TTokenClient("127.0.0.1", srv_dst.port, timeout_ms=5000)
    c = TTokenClient("127.0.0.1", srv_src.port, timeout_ms=5000,
                     namespace="w1")
    try:
        assert watcher.ping()
        assert srv_dst.push_hub in svc_dst._push_hubs
        for _ in range(5):
            assert c.request_token(fid).ok
        doc0 = svc_src.export_namespace_state("w1")
        pub = ShardMapPublisher()
        coord = MoveCoordinator(svc_src, self_endpoint=src_ep,
                                publisher=pub)
        assert coord.move_namespace("w1", dst_ep), coord.last_error
        assert pub.current().endpoint_of["w1"] == dst_ep
        deadline = time.monotonic() + 5.0
        while not watcher.push_stats()["rule_epoch_invalidate"]:
            assert time.monotonic() < deadline, "no rule-epoch push"
            time.sleep(0.01)
        assert srv_dst.push_hub.stats()["sent"]["rule_epoch_invalidate"] >= 1
        r = c.request_token(fid)
        assert r.status == TokenStatus.MOVED
        assert r.remaining == pub.current().epoch
        # the asyncio door ships the new owner as the reply's trailer
        assert r.endpoint == (dst_ep if src_door == "asyncio" else "")
        got = svc_dst.export_namespace_state("w1")
        assert_docs_equal(doc0, got)
        c2 = TTokenClient("127.0.0.1", srv_dst.port, timeout_ms=5000,
                          namespace="w1")
        try:
            assert c2.request_token(fid).status == TokenStatus.OK
        finally:
            c2.close()
        assert not srv_dst.move_target.status()["staged"]
    finally:
        c.close()
        watcher.close()
        srv_src.stop()
        srv_dst.stop()


def test_jax_coordinator_moves_into_the_asyncio_door(clean_metrics, clocks):
    """A JAX ``MoveCoordinator`` moves a namespace of the seeded stream's
    service into the port's asyncio door: the destination's document equals
    the source's."""
    src = JAX.make()
    traffic([src], clocks, np.random.default_rng(SEED), rounds=3,
            check=lambda kind, outs: None)
    doc0 = src.export_namespace_state("ns1")
    dst = PORT.make(rules=False)
    server = TokenServer(dst, host="127.0.0.1", port=0, idle_ttl_s=None)
    server.start()
    try:
        coord = JRB.MoveCoordinator(src, self_endpoint="src:1")
        assert coord.move_namespace("ns1", f"127.0.0.1:{server.port}",
                                    epoch=5), coord.last_error
    finally:
        server.stop()
    assert_docs_equal(doc0, dst.export_namespace_state("ns1"))


# -- two live port doors -----------------------------------------------------
@pytest.fixture(scope="module")
def fleet():
    with manual_clocks():
        svc_src = DefaultTokenService(_CFG, device="cpu")
        svc_dst = DefaultTokenService(_CFG, device="cpu")
        srv_src = NativeTokenServer(svc_src, host="127.0.0.1", port=0,
                                    idle_ttl_s=None)
        srv_dst = NativeTokenServer(svc_dst, host="127.0.0.1", port=0,
                                    idle_ttl_s=None)
        srv_src.start()
        srv_dst.start()
        f = type("Fleet", (), dict(
            svc_src=svc_src, svc_dst=svc_dst, srv_src=srv_src,
            srv_dst=srv_dst, src_ep=f"127.0.0.1:{srv_src.port}",
            dst_ep=f"127.0.0.1:{srv_dst.port}"))
        try:
            yield f
        finally:
            chaos.disarm()  # a failed test must not leak chaos
            srv_src.stop()
            srv_dst.stop()


def _no_staged_claim(server, timeout_s=5.0):
    """The destination's staging empties: the source's MOVE_ABORT, or its
    closed connection, reaches the door's control lane a moment later."""
    deadline = time.monotonic() + timeout_s
    while server.move_target.status()["staged"]:
        assert time.monotonic() < deadline, server.move_target.status()
        time.sleep(0.01)


def _client(ep, ns):
    host, _, port = ep.rpartition(":")
    return TokenClient(host, int(port), timeout_ms=2000, namespace=ns)


def test_live_move_hands_off_counters_and_redirects(fleet):
    fid = 101
    fleet.svc_src.load_namespace_rules("w1", [_rules(fid, 100.0, "w1")[1]])
    pub = ShardMapPublisher()
    coord = MoveCoordinator(fleet.svc_src, self_endpoint=fleet.src_ep,
                            publisher=pub)
    c = _client(fleet.src_ep, "w1")
    try:
        for _ in range(5):
            assert c.request_token(fid).ok
        doc0 = fleet.svc_src.export_namespace_state("w1")
        assert coord.move_namespace("w1", fleet.dst_ep), coord.last_error
        assert pub.current().endpoint_of["w1"] == fleet.dst_ep
        # a stale client: the source answers MOVED with the new epoch (the
        # native door ships no endpoint trailer; the shard map names it)
        r = c.request_token(fid)
        assert r.status == JStatus.MOVED
        assert r.remaining == pub.current().epoch
        # the destination owns the namespace with the spent window
        got = fleet.svc_dst.export_namespace_state("w1")
        assert_docs_equal(doc0, got)
        assert _sums(got)[fid] >= 5.0
        c2 = _client(pub.current().endpoint_of["w1"], "w1")
        try:
            assert c2.request_token(fid).status == JStatus.OK
        finally:
            c2.close()
        coord.release("w1")
        assert c.request_token(fid).status == JStatus.NO_RULE_EXISTS
    finally:
        c.close()


@pytest.mark.parametrize("step", ["begin", "state", "commit"])
def test_move_killed_at_each_step_leaves_one_owner(fleet, step):
    """The connection dies at each protocol step: the move fails, the source
    is the sole owner with bit-equal counters, the destination stages
    nothing, and a request issued while the namespace is frozen resolves
    MOVED."""
    fid = {"begin": 111, "state": 112, "commit": 113}[step]
    ns = f"s_{step}"
    fleet.svc_src.load_namespace_rules(ns, [_rules(fid, 100.0, ns)[1]])
    c = _client(fleet.src_ep, ns)
    inflight = []

    def hook(s):
        if s == step:
            if s != "begin":  # frozen from begin_move on: probe the mask
                inflight.append(c.request_token(fid))
            raise ConnectionResetError(f"chaos: killed at {s}")

    pub = ShardMapPublisher()
    coord = MoveCoordinator(fleet.svc_src, self_endpoint=fleet.src_ep,
                            publisher=pub, on_step=hook)
    try:
        for _ in range(3):
            assert c.request_token(fid).ok
        doc0 = fleet.svc_src.export_namespace_state(ns)
        assert not coord.move_namespace(ns, fleet.dst_ep)
        assert "ConnectionResetError" in coord.last_error
        doc1 = fleet.svc_src.export_namespace_state(ns)
        assert_docs_equal(doc0, doc1)
        assert not fleet.svc_dst.export_namespace_state(ns)["rules"]
        _no_staged_claim(fleet.srv_dst)
        assert pub.current().epoch == 0  # a failed move publishes nothing
        if step != "begin":
            assert [r.status for r in inflight] == [JStatus.MOVED]
        assert not fleet.svc_src.moving_namespaces()
        assert c.request_token(fid).status == JStatus.OK
    finally:
        c.close()


@pytest.mark.parametrize("lost", ["MOVE_BEGIN", "MOVE_STATE"])
def test_move_aborts_on_dropped_frame_then_retries_clean(fleet, lost):
    """chaos ``frame_drop`` eats a MOVE_BEGIN or a MOVE_STATE frame (in a
    proxy in front of the destination door: the native door applies the
    point to data-plane pulls only): the ack timeout aborts the move
    losslessly, the destination stages nothing, and a clean retry on the
    same coordinator commits."""
    fid, ns = {"MOVE_BEGIN": (103, "w3"), "MOVE_STATE": (105, "w5")}[lost]
    fleet.svc_src.load_namespace_rules(ns, [_rules(fid, 100.0, ns)[1]])
    c = _client(fleet.src_ep, ns)
    coord = MoveCoordinator(fleet.svc_src, self_endpoint=fleet.src_ep,
                            publisher=ShardMapPublisher(), ack_timeout_s=0.5)
    proxy = DK.FrameDropProxy(P, fleet.srv_dst.port, P.MsgType[lost],
                              should=lambda: chaos.should("frame_drop"))
    via = f"127.0.0.1:{proxy.port}"
    try:
        for _ in range(2):
            assert c.request_token(fid).ok
        doc0 = fleet.svc_src.export_namespace_state(ns)
        chaos.arm("frame_drop:n=1", seed=11)
        try:
            ok = coord.move_namespace(ns, via)
            dropped = chaos.fired().get("frame_drop", 0)
        finally:
            chaos.disarm()
        assert not ok and dropped == 1 and proxy.dropped == 1
        assert "timed out" in coord.last_error
        assert_docs_equal(doc0, fleet.svc_src.export_namespace_state(ns))
        assert not fleet.svc_dst.export_namespace_state(ns)["rules"]
        _no_staged_claim(fleet.srv_dst)
        assert c.request_token(fid).status == JStatus.OK
        assert coord.move_namespace(ns, via), coord.last_error
        assert _sums(fleet.svc_dst.export_namespace_state(ns))[fid] > 0
        coord.release(ns)
    finally:
        proxy.close()
        c.close()


def test_move_commits_under_device_stall_with_live_traffic(fleet):
    """A stalling device mid-move: every concurrent request through the
    port's ``RoutingTokenClient`` resolves (no raise) without the router
    degrading to its local fallback, the move commits, the router
    converges on the destination within one epoch bump (it learns the move
    from the MOVED answer or the published shard map), and a direct client
    of the destination is answered OK."""
    from sentinel_tpu_torch.cluster.routing import RoutingTokenClient
    from sentinel_tpu_torch.metrics.ha import ha_metrics
    from sentinel_tpu_torch.ha import (
        FallbackAction,
        FallbackRule,
        LocalFallbackPolicy,
    )

    fid, ns = 104, "w4"
    fleet.svc_src.load_namespace_rules(ns, [_rules(fid, 1000.0, ns)[1]])
    pub = ShardMapPublisher()
    coord = MoveCoordinator(fleet.svc_src, self_endpoint=fleet.src_ep,
                            publisher=pub)
    policy = LocalFallbackPolicy([FallbackRule(fid, FallbackAction.BLOCK)])
    host_s, _, port_s = fleet.src_ep.rpartition(":")
    host_d, _, port_d = fleet.dst_ep.rpartition(":")
    rc = RoutingTokenClient(
        timeout_ms=2000,
        namespace_of={fid: ns},
        pod_of={ns: fleet.src_ep},
        endpoints={
            fleet.src_ep: (host_s, int(port_s)),
            fleet.dst_ep: (host_d, int(port_d)),
        },
        fallback=policy,
        shard_maps=pub,
    )
    epoch0 = rc.epoch
    move = {}

    def mover():
        move["ok"] = coord.move_namespace(ns, fleet.dst_ep)

    c = _client(fleet.src_ep, ns)
    c2 = _client(fleet.dst_ep, ns)
    try:
        assert rc.request_token(fid).ok
        degraded0 = ha_metrics().fallback_totals().get("moved_degraded", 0)
        chaos.arm("device_stall:ms=50,n=8", seed=3)
        t = threading.Thread(target=mover)
        t.start()
        raised, statuses = 0, []
        for _ in range(30):
            try:
                statuses.append(rc.request_token(fid).status)
            except Exception:
                raised += 1
            time.sleep(0.01)
        t.join(timeout=30)
        chaos.disarm()
        assert move.get("ok"), coord.last_error
        assert raised == 0 and len(statuses) == 30
        assert set(statuses) <= {JStatus.OK, JStatus.BLOCKED,
                                 JStatus.NO_RULE_EXISTS}
        # no answer came from the local fallback: a destination that raised
        # or answered MOVED again would have been degraded to BLOCKED
        assert (ha_metrics().fallback_totals().get("moved_degraded", 0)
                == degraded0)
        assert policy.stats()["blocked"] == 0
        assert pub.current().epoch == 1
        assert rc.epoch - epoch0 == 1  # converged within ONE epoch bump
        assert rc._state.pod_of[ns] == fleet.dst_ep
        assert rc.request_token(fid).status == JStatus.OK
        # a client that did not follow still gets the redirect
        r = c.request_token(fid)
        assert (r.status, r.remaining) == (JStatus.MOVED, 1)
        assert c2.request_token(fid).status == JStatus.OK
        assert _sums(fleet.svc_dst.export_namespace_state(ns))[fid] > 0
        coord.release(ns)
    finally:
        chaos.disarm()
        c.close()
        c2.close()
        rc.close()
