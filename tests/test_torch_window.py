"""The port's sliding windows against ``sentinel_tpu.stats.window``.

Seeded streams of adds (including out-of-range and negative resource ids,
which the reference drops or wraps), rolls, future-window charges, column
adds and rebases go through both modules; every read and the state leaves
must be equal after each step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.stats import window as JW  # noqa: E402

from sentinel_tpu_torch.stats import window as TW  # noqa: E402
from torch_parity import assert_arrays_equal  # noqa: E402

SPEC_J = JW.WindowSpec(bucket_ms=100, n_buckets=10)
SPEC_T = TW.WindowSpec(bucket_ms=100, n_buckets=10)
R, C = 48, 6


def _pair():
    j = JW.make_window(SPEC_J, R, C)
    t = TW.make_window(SPEC_T, R, C, device="cpu")
    return j, t


def _check(j, t, label):
    assert_arrays_equal(j.starts, t.starts, f"{label}: starts")
    assert_arrays_equal(j.counts, t.counts, f"{label}: counts")


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


@pytest.mark.parametrize("seed", range(4))
def test_add_roll_future_stream(seed):
    rng = np.random.default_rng(seed)
    j, t = _pair()
    now = 5_000 + int(rng.integers(0, 1000))
    for step in range(18):
        k = 32  # one shape: the reference's eager scatters compile once
        ids = rng.integers(-R - 3, R + 3, size=k).astype(np.int32)
        ch = rng.integers(0, C, size=k).astype(np.int32)
        vals = rng.integers(0, 5, size=k).astype(np.int32)
        valid = rng.random(k) < 0.8
        op = step % 4
        if op == 0:
            j = JW.add_events(SPEC_J, j, jnp.int32(now), jnp.asarray(ids),
                              jnp.asarray(ch), jnp.asarray(vals),
                              jnp.asarray(valid))
            TW.add_events(SPEC_T, t, now, _t(ids), _t(ch), _t(vals),
                          _t(valid, torch.bool))
        elif op == 1:
            rows = rng.integers(0, 4, size=(k, 3)).astype(np.int32)
            chans = (0, 2, 5)
            j = JW.add_event_rows(SPEC_J, j, jnp.int32(now), jnp.asarray(ids),
                                  jnp.asarray(rows), channels=chans)
            TW.add_event_rows(SPEC_T, t, now, _t(ids), _t(rows),
                              channels=chans)
        elif op == 2:
            wait = rng.integers(-50, 1_300, size=k).astype(np.int32)
            j = JW.add_future(SPEC_J, j, jnp.int32(now), jnp.asarray(wait),
                              jnp.asarray(ids), jnp.asarray(ch),
                              jnp.asarray(vals), jnp.asarray(valid))
            TW.add_future(SPEC_T, t, now, _t(wait), _t(ids), _t(ch),
                          _t(vals), _t(valid, torch.bool))
        else:
            deltas = rng.integers(0, 3, size=R).astype(np.float32)
            j = JW.add_column(SPEC_J, j, jnp.int32(now), jnp.asarray(deltas),
                              channel=3)
            TW.add_column(SPEC_T, t, now, torch.as_tensor(deltas),
                          channel=3)
        label = f"seed={seed} step={step}"
        _check(j, t, label)
        ids_in = np.arange(R, dtype=np.int32)
        ch_r = step % C  # one channel per step keeps the eager calls few
        assert_arrays_equal(JW.window_sum(SPEC_J, j, now, ch_r),
                            TW.window_sum(SPEC_T, t, now, ch_r), label)
        assert_arrays_equal(
            JW.window_sum_at(SPEC_J, j, now, ch_r, jnp.asarray(ids_in)),
            TW.window_sum_at(SPEC_T, t, now, ch_r, _t(ids_in)), label)
        assert_arrays_equal(JW.future_sum(SPEC_J, j, now, ch_r),
                            TW.future_sum(SPEC_T, t, now, ch_r), label)
        assert_arrays_equal(
            JW.future_sum_at(SPEC_J, j, now, ch_r, jnp.asarray(ids_in)),
            TW.future_sum_at(SPEC_T, t, now, ch_r, _t(ids_in)), label)
        assert_arrays_equal(JW.window_sum_all(SPEC_J, j, now),
                            TW.window_sum_all(SPEC_T, t, now), label)
        assert_arrays_equal(JW.valid_mask(SPEC_J, j, now),
                            TW.valid_mask(SPEC_T, t, now), label)
        assert_arrays_equal(JW.future_valid_mask(SPEC_J, j, now),
                            TW.future_valid_mask(SPEC_T, t, now), label)
        r = rng.random()
        now += int(rng.integers(1, 90) if r < 0.6
                   else rng.integers(100, 400) if r < 0.9
                   else rng.integers(1_000, 2_500))


def test_roll_and_bucket_index_negative_time():
    """Floor semantics of // and % for engine times around zero."""
    j, t = _pair()
    for now in (-250, -100, -1, 0, 1, 99, 100, 1_999):
        idx_j, start_j = JW.bucket_index(SPEC_J, now)
        assert TW.bucket_index(SPEC_T, now) == (int(idx_j), int(start_j))
        j = JW.roll(SPEC_J, j, jnp.int32(now))
        TW.roll(SPEC_T, t, now)
        _check(j, t, f"roll now={now}")


def test_rebase_keeps_never():
    j, t = _pair()
    for now in (300, 450, 1_210):
        ids = np.array([1, 2, 3], np.int32)
        j = JW.add_events(SPEC_J, j, jnp.int32(now), jnp.asarray(ids),
                          jnp.zeros(3, jnp.int32), jnp.ones(3, jnp.int32))
        TW.add_events(SPEC_T, t, now, _t(ids), _t(np.zeros(3)),
                      _t(np.ones(3)))
    j = JW.rebase(j, 1_000)
    TW.rebase(t, 1_000)
    _check(j, t, "rebase")
    assert int((t.starts == TW.NEVER).sum()) > 0


def test_masked_set_and_max_match_drop_scatters():
    rng = np.random.default_rng(3)
    F = 16
    for _ in range(20):
        k = 24
        ids = rng.integers(-F - 2, F + 2, size=k).astype(np.int32)
        mask = rng.random(k) < 0.5
        vals_i = rng.integers(-100, 100, size=k).astype(np.int32)
        base = rng.integers(-50, 50, size=F).astype(np.int32)
        # rows of one slot carry one value: the callers' contract
        per_slot = rng.integers(-100, 100, size=F).astype(np.int32)
        vals_s = per_slot[np.where(ids < 0, ids + F, ids) % F]
        scat = jnp.where(jnp.asarray(mask), jnp.asarray(ids), F + 7)
        ref_set = jnp.asarray(base).at[scat].set(jnp.asarray(vals_s),
                                                 mode="drop")
        ref_max = jnp.asarray(base).at[scat].max(jnp.asarray(vals_i),
                                                 mode="drop")
        got_set = TW.masked_set_(torch.as_tensor(base.copy()), _t(ids),
                                 _t(vals_s), _t(mask, torch.bool))
        got_max = TW.masked_max_(torch.as_tensor(base.copy()), _t(ids),
                                 _t(vals_i), _t(mask, torch.bool))
        assert_arrays_equal(ref_set, got_set, "masked set")
        assert_arrays_equal(ref_max, got_max, "masked max")
