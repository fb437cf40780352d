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
