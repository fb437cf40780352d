"""The port's hot-param path against the reference.

The same seeded numpy stream (``tests/torch_param_check.py``: Zipf values,
padded and no-rule rows, prefix-only rejections, a saturating block) goes
through the reference's ``param_decide`` and the port's, for both sketches,
with and without the slim twin, over steps that roll both ring buckets and
merge SALSA pairs; admit, estimate and every ``ParamState`` leaf must be
bit-identical. The reference is held as it is compiled (its cores are
jitted), through its XLA core and through its Pallas kernels in interpret
mode. The service's ``request_params_token`` is held against the reference
service over a stream with item overrides, a reload and an epoch rebase.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule as JParamRule,
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine import param as JP  # noqa: E402
from sentinel_tpu.sketch.slim import slim_indices as j_slim_indices  # noqa: E402

from sentinel_tpu_torch import interop  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine import param as TP  # noqa: E402
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda  # noqa: E402
from sentinel_tpu_torch.sketch.slim import slim_indices  # noqa: E402
import torch_param_check as PC  # noqa: E402
from torch_parity import assert_arrays_equal  # noqa: E402

SMALL = dict(max_param_rules=8, width=128)
START_MS = 1_700_000_000_000
EKW = dict(max_flows=16, max_namespaces=4, batch_size=16)


def _configs(sketch, j_impl="jax", t_impl="jax"):
    return (JP.ParamConfig(sketch=sketch, impl=j_impl, **SMALL),
            TP.ParamConfig(sketch=sketch, impl=t_impl, **SMALL))


def _standby_state(jcfg, rng):
    """A state whose slim twin is authoritative and live at the first step
    (as on a standby fed by deltas), so the slim estimate is not zero."""
    st = {k: np.asarray(v) for k, v in
          interop.param_state_to_numpy(JP.make_param_state(jcfg)).items()}
    st["starts"] = np.array([PC.T0_MS - PC.T0_MS % 500, PC.T0_MS - 540],
                            np.int32)
    hi = 40 if jcfg.sketch == "cms" else 30
    st["counts"] = rng.integers(0, hi, st["counts"].shape).astype(
        st["counts"].dtype)
    st["slim"] = rng.integers(0, 30, st["slim"].shape).astype(np.int32)
    st["slim_auth"] = np.array([True, True])
    return st


def _assert_param_states_equal(j_state, t_state, label):
    ref = interop.param_state_to_numpy(j_state)
    got = interop.param_state_to_numpy(t_state)
    for key in ref:
        assert_arrays_equal(ref[key], got[key], f"{label}: {key}")


def _run_both(jcfg, tcfg, batches, nows, j_state, slim, hashes_of):
    t_state = interop.param_state_from_numpy(
        interop.param_state_to_numpy(j_state), "cpu")
    merges = 0
    for k, (cols, now) in enumerate(zip(batches, nows)):
        sj = st = None
        if slim:
            hs = hashes_of(cols)
            sj = jnp.asarray(j_slim_indices(jcfg, hs))
            st = torch.as_tensor(slim_indices(tcfg, hs))
        j_state, ja, je = JP.param_decide(
            jcfg, j_state, *(jnp.asarray(cols[f]) for f in
                             ("rule_slot", "idx", "acquire", "threshold",
                              "valid")),
            jnp.int32(now), idx_slim=sj)
        t_state, ta, te = TP.param_decide(
            tcfg, t_state, *(torch.as_tensor(cols[f]) for f in
                             ("rule_slot", "idx", "acquire", "threshold",
                              "valid")),
            now, idx_slim=st)
        label = f"{tcfg.sketch} step {k}"
        assert_arrays_equal(ja, ta, f"{label}: admit")
        assert_arrays_equal(je, te, f"{label}: estimate")
        _assert_param_states_equal(j_state, t_state, label)
        merges = int(np.asarray(j_state.merges).sum())
    return merges


def _hashes_of(cols):
    # any stable per-row value hash works for the twin's indices
    return cols["idx"][:, 0].astype(np.int64) * 1_000_003 + cols["rule_slot"]


@pytest.mark.parametrize("t_impl", ["jax", "pallas"])
@pytest.mark.parametrize("slim", [False, True])
@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_param_decide_matches_reference(sketch, slim, t_impl):
    """``impl="pallas"`` on CPU tensors goes through the kernels' wrappers,
    which run their plain versions there."""
    jcfg, tcfg = _configs(sketch, t_impl=t_impl)
    rng = np.random.default_rng(17)
    batches, nows = PC.kernel_batches(tcfg, 64, seed=3)
    j_state = JP.make_param_state(jcfg)
    if slim:
        d = _standby_state(jcfg, rng)
        j_state = JP.ParamState(**{k: jnp.asarray(v) for k, v in d.items()})
    merges = _run_both(jcfg, tcfg, batches, nows, j_state, slim, _hashes_of)
    if sketch == "salsa":
        assert merges > 0


@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_param_decide_matches_pallas_interpret(sketch):
    """The reference's Pallas kernels (interpret mode) on the same stream."""
    jcfg, tcfg = _configs(sketch, j_impl="pallas", t_impl="pallas")
    batches, nows = PC.kernel_batches(tcfg, 32, seed=5)
    merges = _run_both(jcfg, tcfg, batches, nows, JP.make_param_state(jcfg),
                       False, _hashes_of)
    if sketch == "salsa":
        assert merges > 0


def test_cpu_wrappers_run_plain_and_do_not_count():
    before = (dict(cms_cuda.LAUNCHES), dict(salsa_cuda.LAUNCHES))
    for sketch in ("cms", "salsa"):
        cfg = TP.ParamConfig(sketch=sketch, **SMALL)
        batches, nows = PC.kernel_batches(cfg, 64, seed=9)
        r = PC.check_param_steps(cfg, TP.make_param_state(cfg, device="cpu"),
                                 batches, nows)
        assert not r.mismatches and r.max_abs_err == 0.0
        assert r.reached == set(PC.coverage_for(sketch)), r.reached
        assert r.admitted > 0 and r.blocked > 0
    assert (dict(cms_cuda.LAUNCHES), dict(salsa_cuda.LAUNCHES)) == before


def _colliding_rows(W, P):
    """Two depth-2 (slot, idx) rows with distinct index tuples whose 32-bit
    prefix keys collide: sort every (slot, idx[0]) head of the key and take
    two heads closer than W. (At the service's P=256, W=2048 the heads lie
    at least W apart, so in-range rows never collide there.)"""
    m = np.int64(-1640531527)
    s, a = np.meshgrid(np.arange(P, dtype=np.int64),
                       np.arange(W, dtype=np.int64), indexing="ij")
    head = ((s * m + a) & 0xFFFFFFFF) * (m & 0xFFFFFFFF) & 0xFFFFFFFF
    head = head.ravel()
    order = np.argsort(head, kind="stable")
    gaps = np.diff(head[order])
    k = int(np.nonzero((gaps > 0) & (gaps < W))[0][0])
    lo, hi = order[k], order[k + 1]
    gap = int(gaps[k])
    # head[lo] + b_lo == head[hi] + b_hi  (mod 2^32), with b_lo = gap
    row_lo = (int(lo // W), int(lo % W), gap)
    row_hi = (int(hi // W), int(hi % W), 0)
    return row_lo, row_hi


def test_key_mix_wraps_and_collisions_share_a_budget():
    # keys that overflow int32, against a Python-int reference and XLA
    rng = np.random.default_rng(2)
    slot = rng.integers(0, 2**31 - 1, 512).astype(np.int32)
    idx = rng.integers(0, 2**31 - 1, (512, 3)).astype(np.int32)
    got = cms_cuda.mix_keys(torch.as_tensor(slot), torch.as_tensor(idx))

    def wrap(x):
        return ((x + 2**31) % 2**32) - 2**31

    want = []
    for s, row in zip(slot.tolist(), idx.tolist()):
        k = s
        for v in row:
            k = wrap(k * -1640531527 + v)
        want.append(k)
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.int32))

    @jax.jit
    def j_mix(s, ix):
        k = s
        for d in range(ix.shape[1]):
            k = k * jnp.int32(-1640531527) + ix[:, d]
        return k

    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_mix(jnp.asarray(slot), jnp.asarray(idx))))

    # distinct values whose keys collide share one in-batch budget
    P, W = 16, 65536
    row_lo, row_hi = _colliding_rows(W, P)
    assert row_lo != row_hi
    jcfg = JP.ParamConfig(max_param_rules=P, width=W, impl="jax")
    tcfg = TP.ParamConfig(max_param_rules=P, width=W, impl="jax")
    cols = dict(
        rule_slot=np.array([row_lo[0], row_hi[0]], np.int32),
        idx=np.array([row_lo[1:], row_hi[1:]], np.int32),
        acquire=np.array([2, 2], np.int32),
        threshold=np.array([3.0, 3.0], np.float32),
        valid=np.array([True, True]),
    )
    j_keys = np.asarray(j_mix(jnp.asarray(cols["rule_slot"]),
                              jnp.asarray(cols["idx"])))
    assert j_keys[0] == j_keys[1]
    _, ja, _ = JP.param_decide(jcfg, JP.make_param_state(jcfg),
                               *(jnp.asarray(cols[f]) for f in cols),
                               jnp.int32(1000))
    _, ta, _ = TP.param_decide(tcfg, TP.make_param_state(tcfg, "cpu"),
                               *(torch.as_tensor(cols[f]) for f in cols),
                               1000)
    assert np.asarray(ja).tolist() == [True, False]
    assert ta.tolist() == [True, False]


def test_resolve_param_impl():
    assert TP.resolve_param_impl("auto", "cpu") == "jax"
    assert TP.resolve_param_impl("auto", torch.device("cuda")) == "pallas"
    assert TP.resolve_param_impl("jax", torch.device("cuda")) == "jax"
    assert TP.resolve_param_impl("pallas", "cpu") == "pallas"
    with pytest.raises(ValueError):
        TP.resolve_param_impl("xla", "cpu")
    cfg = TP.ParamConfig(**SMALL)
    one = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        TP.param_decide(cfg._replace(sketch="nope"),
                        TP.make_param_state(cfg, "cpu"), one,
                        torch.zeros((1, 2), dtype=torch.int32), one,
                        torch.zeros((1,)), torch.ones((1,), dtype=torch.bool),
                        0)


def test_hash_indices_match_reference():
    h = np.random.default_rng(4).integers(-(2**63), 2**63 - 1, 1000,
                                          dtype=np.int64)
    for depth, width, salt in ((2, 2048, 0), (3, 4096, 0), (2, 256, 64)):
        np.testing.assert_array_equal(
            TP.hash_indices(h, depth, width, salt),
            JP.hash_indices(h, depth, width, salt))


def test_param_interop_round_trip():
    jcfg, tcfg = _configs("salsa")
    batches, nows = PC.kernel_batches(tcfg, 32, seed=1)
    j_state = JP.make_param_state(jcfg)
    for cols, now in zip(batches[:3], nows[:3]):
        j_state, _, _ = JP.param_decide(
            jcfg, j_state, *(jnp.asarray(cols[f]) for f in
                             ("rule_slot", "idx", "acquire", "threshold",
                              "valid")), jnp.int32(now))
    d = interop.param_state_to_numpy(j_state)
    assert sorted(d) == sorted(["starts", "counts", "slim", "slim_auth",
                                "merges"])
    t_state = interop.param_state_from_numpy(d, "cpu")
    back = interop.param_state_to_numpy(t_state)
    for k in d:
        assert back[k].dtype == d[k].dtype
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def test_no_card_means_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TP.make_param_state(TP.ParamConfig())
    with pytest.raises(RuntimeError):
        DefaultTokenService(EngineConfig(**EKW),
                            param_config=TP.ParamConfig(**SMALL))


# -- the service -------------------------------------------------------------
@pytest.fixture
def clocks():
    jc, tc = j_clock.ManualClock(START_MS), t_clock.ManualClock(START_MS)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    yield jc, tc
    j_clock.set_clock(prev_j)
    t_clock.set_clock(prev_t)


def _services(sketch, P=16):
    pk = dict(max_param_rules=P, width=128, sketch=sketch)
    jsvc = JService(JConfig(**EKW), JP.ParamConfig(impl="jax", **pk))
    tsvc = DefaultTokenService(EngineConfig(**EKW), TP.ParamConfig(**pk),
                               device="cpu")
    return jsvc, tsvc


def _load(jsvc, tsvc, specs, namespace=None):
    j_rules = [JParamRule(s.flow_id, s.count, s.item_thresholds)
               for s in specs]
    t_rules = [ClusterParamFlowRule(s.flow_id, s.count, s.item_thresholds)
               for s in specs]
    if namespace is None:
        jsvc.load_param_rules(j_rules)
        tsvc.load_param_rules(t_rules)
    else:
        jsvc.load_namespace_param_rules(namespace, j_rules)
        tsvc.load_namespace_param_rules(namespace, t_rules)


def _serve(jsvc, tsvc, jc, tc, stream, label, advances=(1, 3, 7, 40)):
    seen = set()
    for i, (fid, acq, hashes) in enumerate(stream):
        js = jsvc.request_params_token(fid, acq, hashes)
        ts = tsvc.request_params_token(fid, acq, hashes)
        assert int(js.status) == int(ts.status), f"{label} request {i}"
        seen.add(ts.status)
        step = advances[i % len(advances)]
        jc.advance(step)
        tc.advance(step)
    _assert_param_states_equal(jsvc._param_state, tsvc._param_state, label)
    return seen


@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_request_params_token_matches_reference(sketch, clocks):
    jc, tc = clocks
    rng = np.random.default_rng(23)
    jsvc, tsvc = _services(sketch)
    specs = PC.service_rule_specs(12, rng)
    _load(jsvc, tsvc, specs)
    seen = _serve(jsvc, tsvc, jc, tc, PC.service_stream(specs, rng, 160),
                  "before reload")
    # the reload frees every fifth rule's slot and reuses the freed slots
    reload = PC.reload_specs(specs, rng, n_new=3)
    _load(jsvc, tsvc, reload)
    assert {f: e[0] for f, e in jsvc._param_rules.items()} == \
        {f: e[0] for f, e in tsvc._param_rules.items()}
    _assert_param_states_equal(jsvc._param_state, tsvc._param_state,
                               "reload")
    seen |= _serve(jsvc, tsvc, jc, tc, PC.service_stream(reload, rng, 120),
                   "after reload")
    # an epoch rebase: both services shift the sketch's starts
    jump = DefaultTokenService._REBASE_AFTER_MS + 5_000
    jc.advance(jump)
    tc.advance(jump)
    seen |= _serve(jsvc, tsvc, jc, tc, PC.service_stream(reload, rng, 60),
                   "after rebase")
    assert tsvc._epoch_ms == jsvc._epoch_ms
    assert {TokenStatus.OK, TokenStatus.BLOCKED} <= seen
    # unknown flows and empty value lists answer without a step
    assert tsvc.request_params_token(1, 1, [5]).status == \
        TokenStatus.NO_RULE_EXISTS
    assert tsvc.request_params_token(reload[0].flow_id, 1, []).ok


def test_namespace_param_rules(clocks):
    jc, tc = clocks
    jsvc, tsvc = _services("cms")
    rng = np.random.default_rng(1)
    specs = PC.service_rule_specs(6, rng)
    _load(jsvc, tsvc, specs[:4])
    _load(jsvc, tsvc, specs[4:], namespace="ns2")
    for svc in (jsvc, tsvc):
        assert {r.flow_id for r in svc.current_param_rules("ns2")} == \
            {s.flow_id for s in specs[4:]}
        assert len(svc.current_param_rules()) == 6
    assert {f: e[0] for f, e in jsvc._param_rules.items()} == \
        {f: e[0] for f, e in tsvc._param_rules.items()}
    _serve(jsvc, tsvc, jc, tc, PC.service_stream(specs, rng, 40), "ns")


def test_partial_load_rejected_atomically(clocks):
    tsvc = DefaultTokenService(EngineConfig(**EKW),
                               TP.ParamConfig(max_param_rules=2, width=128),
                               device="cpu")
    tsvc.load_param_rules([ClusterParamFlowRule(flow_id=1, count=1.0),
                           ClusterParamFlowRule(flow_id=2, count=1.0)])
    with pytest.raises(ValueError, match="capacity"):
        tsvc.load_param_rules(
            [ClusterParamFlowRule(flow_id=i, count=1.0) for i in (3, 4, 5)]
        )
    assert set(tsvc._param_rules) == {1, 2}


def test_param_state_survives_epoch_rebase(clocks):
    jc, tc = clocks
    tsvc = DefaultTokenService(EngineConfig(**EKW),
                               TP.ParamConfig(max_param_rules=4, width=128),
                               device="cpu")
    tsvc.load_param_rules([ClusterParamFlowRule(flow_id=3, count=2.0)])
    h = 77
    assert tsvc.request_params_token(3, 1, [h]).status == TokenStatus.OK
    tc.advance(13 * 24 * 3600 * 1000)  # past the rebase horizon
    tsvc.request_token(999)  # the flow path rebases the epoch
    starts = tsvc._param_state.starts
    assert int(starts.max()) <= 60_000 and bool((starts == TP.NEVER).any())
    assert tsvc.request_params_token(3, 1, [h]).status == TokenStatus.OK
    assert tsvc.request_params_token(3, 1, [h]).status == TokenStatus.OK
    assert tsvc.request_params_token(3, 1, [h]).status == \
        TokenStatus.BLOCKED


def test_warmup_leaves_param_state_untouched(clocks):
    tsvc = DefaultTokenService(EngineConfig(**EKW),
                               TP.ParamConfig(sketch="salsa", **SMALL),
                               device="cpu", fuse_depths=(2,))
    before = interop.param_state_to_numpy(tsvc._param_state)
    tsvc.warmup()
    after = interop.param_state_to_numpy(tsvc._param_state)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
