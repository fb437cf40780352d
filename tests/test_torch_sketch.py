"""The port's sketch helpers against the reference (``sentinel_tpu.sketch``):
the SALSA pair codec, the host decoder, the current-bucket estimate and the
slim twin's pre- and post-step, on seeded planes that hold merged,
saturating and plain pairs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sentinel_tpu import sketch as j_sketch  # noqa: E402
from sentinel_tpu.engine import param as JP  # noqa: E402
from sentinel_tpu.sketch import salsa as j_salsa  # noqa: E402
from sentinel_tpu.sketch import slim as j_slim  # noqa: E402

from sentinel_tpu_torch import interop, sketch  # noqa: E402
from sentinel_tpu_torch.engine import param as TP  # noqa: E402
from sentinel_tpu_torch.sketch import salsa, slim  # noqa: E402
from torch_parity import assert_arrays_equal  # noqa: E402


def _plane(rng, shape, merged_share=0.3):
    """Valid int16 SALSA cells: unmerged pairs at or below SAT (some near
    it) and merged pairs (a negative high half)."""
    P, W2 = shape[:-1], shape[-1]
    w = W2 // 2
    lo = rng.integers(0, salsa.SAT + 1, P + (w,))
    hi = rng.integers(0, salsa.SAT + 1, P + (w,))
    merged = rng.random(P + (w,)) < merged_share
    mval = rng.integers(salsa.SAT, salsa.MERGE_CEIL, P + (w,))
    lo = np.where(merged, mval % salsa.CAP, lo)
    hi = np.where(merged, -(mval // salsa.CAP) - 1, hi)
    cells = np.empty(shape, np.int16)
    cells[..., 0::2] = lo
    cells[..., 1::2] = hi
    return cells


def test_constants_match_reference():
    for name in ("LOGCAP", "CAP", "SAT", "MERGE_CEIL"):
        assert getattr(salsa, name) == getattr(j_salsa, name), name
    assert slim.SLIM_SALT == j_slim.SLIM_SALT
    assert sketch.VARIANTS == j_sketch.VARIANTS


@pytest.mark.parametrize("seed", range(3))
def test_decode_encode_plane_match_reference(seed):
    rng = np.random.default_rng(seed)
    cells = _plane(rng, (4, 2, 64))
    j_dec, j_m = j_salsa.decode_plane(jnp.asarray(cells))
    t_dec, t_m = salsa.decode_plane(torch.as_tensor(cells))
    assert_arrays_equal(j_dec, t_dec, "decode")
    assert_arrays_equal(j_m, t_m, "merged")
    # adds that push unmerged cells past SAT and merged ones past the ceiling
    add = rng.integers(0, 3 * salsa.SAT, np.asarray(j_dec).shape)
    add[rng.random(add.shape) < 0.7] = 0
    add[..., 0::2][np.asarray(j_m)] += salsa.MERGE_CEIL // 4
    dec = (np.asarray(j_dec) + add).astype(np.int32)
    j_cells, j_new = j_salsa.encode_plane(jnp.asarray(dec), j_m)
    t_cells, t_new = salsa.encode_plane(torch.as_tensor(dec), t_m)
    assert_arrays_equal(j_cells, t_cells, "encode")
    assert_arrays_equal(j_new, t_new, "newly merged")
    assert int(t_new.sum()) > 0
    # decode(encode(x)) round-trips the unmerged pairs it did not merge
    again, _ = salsa.decode_plane(t_cells)
    keep = ~(t_m | t_new)
    assert torch.equal(again[..., 0::2][keep],
                       torch.as_tensor(dec)[..., 0::2][keep])
    np.testing.assert_array_equal(
        salsa.decode_cells_np(cells), j_salsa.decode_cells_np(cells))


@pytest.mark.parametrize("sketch_name", ["cms", "salsa"])
def test_gather_current_estimate_matches_reference(sketch_name):
    rng = np.random.default_rng(8)
    jcfg = JP.ParamConfig(max_param_rules=6, width=64, sketch=sketch_name)
    tcfg = TP.ParamConfig(max_param_rules=6, width=64, sketch=sketch_name)
    shape = (6, 2, 2, jcfg.cell_width)
    counts = (_plane(rng, shape) if sketch_name == "salsa"
              else rng.integers(0, 1000, shape).astype(np.int32))
    slot = rng.integers(-1, 6, 40).astype(np.int32)
    idx = rng.integers(0, jcfg.cell_width, (40, 2)).astype(np.int32)
    for cur in (0, 1):
        want = j_sketch.gather_current_estimate(
            jcfg, jnp.asarray(counts), jnp.asarray(slot), jnp.asarray(idx),
            cur)
        got = sketch.gather_current_estimate(
            tcfg, torch.as_tensor(counts), torch.as_tensor(slot),
            torch.as_tensor(idx), cur)
        assert_arrays_equal(want, got, f"cur={cur}")


@pytest.mark.parametrize("now", [20_040, 20_600, 21_700])
def test_slim_steps_match_reference(now):
    """Pre-step (roll, authority, estimate) and post-step (scatter-max) on a
    standby-like state, at a same-bucket step, a roll and a long gap."""
    rng = np.random.default_rng(now)
    jcfg = JP.ParamConfig(max_param_rules=5, width=64, slim_width=32)
    tcfg = TP.ParamConfig(max_param_rules=5, width=64, slim_width=32)
    st = {k: np.asarray(v) for k, v in interop.param_state_to_numpy(
        JP.make_param_state(jcfg)).items()}
    st["starts"] = np.array([20_000, 19_500], np.int32)
    st["counts"] = rng.integers(0, 90, st["counts"].shape).astype(np.int32)
    st["slim"] = rng.integers(0, 60, st["slim"].shape).astype(np.int32)
    st["slim_auth"] = np.array([True, True])
    j_state = JP.ParamState(**{k: jnp.asarray(v) for k, v in st.items()})
    t_state = interop.param_state_from_numpy(st, "cpu")
    hashes = rng.integers(0, 2**40, 30).astype(np.int64)
    slot = rng.integers(-1, 5, 30).astype(np.int32)
    valid = rng.random(30) < 0.8
    idx = JP.hash_indices(hashes, 2, 64)
    idx_s = j_slim.slim_indices(jcfg, hashes)
    np.testing.assert_array_equal(idx_s, slim.slim_indices(tcfg, hashes))

    j_sl, j_auth, j_est = j_slim.slim_prestep(
        jcfg, j_state, jnp.asarray(slot), jnp.asarray(idx_s), jnp.int32(now))
    t_est = slim.slim_prestep(tcfg, t_state, torch.as_tensor(slot),
                              torch.as_tensor(idx_s), now)
    assert_arrays_equal(j_est, t_est, "est_slim")
    assert_arrays_equal(j_sl, t_state.slim, "slim after prestep")
    assert_arrays_equal(j_auth, t_state.slim_auth, "slim_auth")
    if now == 20_040:
        assert int(t_est.sum()) > 0

    j_state = j_state._replace(slim=j_sl, slim_auth=j_auth)
    j_sl2 = j_slim.slim_poststep(
        jcfg, j_state, jnp.asarray(slot), jnp.asarray(idx),
        jnp.asarray(idx_s), jnp.asarray(valid), jnp.int32(now))
    slim.slim_poststep(tcfg, t_state, torch.as_tensor(slot),
                       torch.as_tensor(idx), torch.as_tensor(idx_s),
                       torch.as_tensor(valid), now)
    assert_arrays_equal(j_sl2, t_state.slim, "slim after poststep")


_ROW_FIELDS = ("rule_slot", "idx", "acquire", "threshold", "valid")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("start", ["zeros", "reference"])
def test_encode_is_identity_on_untouched_pairs(start, seed):
    """What the touched-pairs-only CUDA kernel rests on: over seeded SALSA
    streams, from zeros or from a state the jitted reference produced
    (brought over with ``interop``), through rolls and merges, the plain
    version's whole-plane re-encode changes no pair that no admitted row
    addressed."""
    import torch_param_check as PC

    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda

    kw = dict(max_param_rules=8, width=128, sketch="salsa")
    jcfg, tcfg = JP.ParamConfig(**kw), TP.ParamConfig(**kw)
    batches, nows = PC.kernel_batches(tcfg, 64, seed=seed)
    state = TP.make_param_state(tcfg, device="cpu")
    if start == "reference":
        j_state = JP.make_param_state(jcfg)
        for cols, now in zip(batches[:4], nows[:4]):
            j_state, _, _ = j_salsa.salsa_decide_jax(
                jcfg, j_state, *(jnp.asarray(cols[f]) for f in _ROW_FIELDS),
                jnp.int32(now))
        assert int(np.asarray(j_state.merges).sum()) > 0
        state = interop.param_state_from_numpy(
            interop.param_state_to_numpy(j_state), "cpu")
        batches, nows = batches[4:], nows[4:]
    kept_merged = kept_nonzero = 0
    first = len(PC.STEP_OFFSETS_MS) - len(nows)
    for k, (cols, now) in enumerate(zip(batches, nows), start=first):
        if k in (1, 4, 6):  # a step in the bucket the step before wrote
            # leave the hot slot alone: its merged pair must keep its bits
            cols = dict(cols, valid=cols["valid"]
                        & (cols["rule_slot"] != PC.HOT_SLOT))
        c = PC.to_device(cols, "cpu")
        plane0 = PC.current_plane_after_roll(tcfg, state, now)
        admit, _ = salsa_cuda.salsa_decide_update_plain(
            state.counts, state.starts, state.merges,
            *(c[f] for f in _ROW_FIELDS), now, tcfg.bucket_ms)
        cur = cms_cuda.ring(now, tcfg.bucket_ms, tcfg.n_buckets)[0]
        plane1 = state.counts[:, cur]
        assert PC.untouched_pairs_equal(plane0, plane1, c, admit)
        # the check covered merged and counting pairs, not only zeros
        same = (plane0 == plane1).view(8, tcfg.depth, -1, 2).all(dim=3)
        pairs = plane0.view(8, tcfg.depth, -1, 2)
        kept_merged += int((same & (pairs[..., 1] < 0)).sum())
        kept_nonzero += int((same & (pairs != 0).any(dim=3)).sum())
    assert kept_merged > 0 and kept_nonzero > kept_merged
    assert int(state.merges.sum()) > 0


def test_reference_cores_differ_on_out_of_range_rows():
    """An observation the port's notes record (ROADMAP §C): for rows whose
    slot or cell index lies outside the sketch, the reference's XLA core
    clamps the gather (a non-zero estimate) while its Pallas kernel
    estimates 0; both drop the scatter of an out-of-range slot. In-range
    rows agree. The reference's callers never pass such rows, and the
    port's kernels treat them as not live."""
    cfg = JP.ParamConfig(max_param_rules=4, width=16, sketch="salsa")
    rng = np.random.default_rng(0)
    st = JP.make_param_state(cfg)
    counts = rng.integers(1, 50, st.counts.shape).astype(np.int16)
    st = st._replace(counts=jnp.asarray(counts),
                     starts=jnp.asarray(np.array([20_000, 19_500], np.int32)))
    slot = np.array([0, 4, 7, 2], np.int32)  # 4 and 7: past the last slot
    idx = np.array([[1, 2], [1, 2], [3, 4], [5, 6]], np.int32)
    args = (jnp.asarray(slot), jnp.asarray(idx),
            jnp.asarray(np.full(4, 2, np.int32)),
            jnp.asarray(np.full(4, 1e6, np.float32)),
            jnp.asarray(np.ones(4, bool)), 20_040)
    s_x, _, est_x = j_salsa.salsa_decide_jax(cfg, st, *args)
    s_p, _, est_p = j_salsa.salsa_decide_pallas(cfg, st, *args)
    est_x, est_p = np.asarray(est_x), np.asarray(est_p)
    assert est_x[0] == est_p[0] and est_x[3] == est_p[3]
    assert (est_x[1:3] > 0).all() and (est_p[1:3] == 0).all()
    np.testing.assert_array_equal(np.asarray(s_x.counts),
                                  np.asarray(s_p.counts))
    changed = np.argwhere(np.asarray(s_x.counts) != counts)
    assert set(changed[:, 0]) == {0, 2}  # only the in-range rows' slots


def _fold_state(rng, cfg, sketch_name, now, stale):
    """A live param state (numpy leaves) whose current bucket is current,
    or stale (a bucket a whole window old)."""
    st = {k: np.asarray(v) for k, v in interop.param_state_to_numpy(
        JP.make_param_state(JP.ParamConfig(**cfg._asdict()))).items()}
    shape = st["counts"].shape
    st["counts"] = (_plane(rng, shape) if sketch_name == "salsa"
                    else rng.integers(0, 1000, shape).astype(np.int32))
    cur = (now // cfg.bucket_ms) % cfg.n_buckets
    aligned = now - now % cfg.bucket_ms
    st["starts"] = np.array([aligned - cfg.bucket_ms] * cfg.n_buckets,
                            np.int32)
    st["starts"][cur] = aligned - (cfg.interval_ms if stale else 0)
    st["slim"] = rng.integers(0, 60, st["slim"].shape).astype(np.int32)
    st["slim_auth"] = np.ones(cfg.n_buckets, bool)
    st["merges"] = rng.integers(0, 5, shape[0]).astype(np.int32)
    return st


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("sketch_name", ["cms", "salsa"])
def test_fold_param_sums_matches_reference(sketch_name, stale):
    """The MOVE import's fold of decoded window sums into the current
    bucket: every leaf equal to the reference's, a stale bucket rotated
    first (fat and slim columns zeroed, authority dropped), SALSA adds in
    decoded space with merges on saturation counted. A folded SALSA plane
    equals its own re-encode: the precondition of the touched-pairs-only
    kernel (beside ``test_encode_is_identity_on_untouched_pairs``)."""
    rng = np.random.default_rng(31 + stale)
    tcfg = TP.ParamConfig(max_param_rules=6, width=64, sketch=sketch_name)
    jcfg = JP.ParamConfig(**tcfg._asdict())
    now = 41_730
    st = _fold_state(rng, tcfg, sketch_name, now, stale)
    j_state = JP.ParamState(**{k: jnp.asarray(v) for k, v in st.items()})
    t_state = interop.param_state_from_numpy(st, "cpu")
    rows = np.array([4, 1, 2], np.int64)
    sums = rng.integers(0, 3 * salsa.SAT, (3, 2, tcfg.cell_width))
    sums[rng.random(sums.shape) < 0.6] = 0
    sums[0, 0, :8] = salsa.MERGE_CEIL // 3  # past the merged ceiling
    j_out = j_sketch.fold_param_sums(jcfg, j_state, now, rows, sums)
    t_out = sketch.fold_param_sums(tcfg, t_state, now, rows, sums)
    assert t_out is t_state  # in place
    want = interop.param_state_to_numpy(j_out)
    got = interop.param_state_to_numpy(t_state)
    for key in want:
        assert_arrays_equal(want[key], got[key], key)
    cur = (now // tcfg.bucket_ms) % tcfg.n_buckets
    assert bool(got["slim_auth"][cur]) is not stale
    if sketch_name == "salsa":
        assert (got["merges"] > st["merges"]).any()
        dec, merged = salsa.decode_plane(t_state.counts)
        again, newly = salsa.encode_plane(dec, merged)
        assert torch.equal(again, t_state.counts)
        assert not bool(newly.any())
    # no rows: only the rotation
    t2 = interop.param_state_from_numpy(st, "cpu")
    j2 = j_sketch.fold_param_sums(jcfg, JP.ParamState(
        **{k: jnp.asarray(v) for k, v in st.items()}), now, [], None)
    sketch.fold_param_sums(tcfg, t2, now, [], None)
    for key, v in interop.param_state_to_numpy(j2).items():
        assert_arrays_equal(v, interop.param_state_to_numpy(t2)[key], key)


@pytest.mark.parametrize("sketch_name", ["cms", "salsa"])
@pytest.mark.parametrize("slim_width", [32, 0])
def test_decoded_counts_and_stats_match_reference(sketch_name, slim_width):
    rng = np.random.default_rng(5)
    tcfg = TP.ParamConfig(max_param_rules=6, width=64, sketch=sketch_name,
                          slim_width=slim_width)
    jcfg = JP.ParamConfig(**tcfg._asdict())
    st = _fold_state(rng, tcfg, sketch_name, 10_000, False)
    j_state = JP.ParamState(**{k: jnp.asarray(v) for k, v in st.items()})
    t_state = interop.param_state_from_numpy(st, "cpu")
    want = j_sketch.decoded_counts_np(jcfg, j_state.counts)
    assert_arrays_equal(want, sketch.decoded_counts_np(tcfg, t_state.counts),
                        "decoded from a tensor")
    assert_arrays_equal(want, sketch.decoded_counts_np(tcfg, st["counts"]),
                        "decoded from an array")
    assert sketch.sketch_stats(tcfg, t_state) == j_sketch.sketch_stats(
        jcfg, j_state)
