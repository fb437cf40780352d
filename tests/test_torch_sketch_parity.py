"""The port's sketch parity harness (``sentinel_tpu_torch.sketch.parity``)
and the slim twin's host queries (``sketch.slim.slim_estimate_np`` /
``slim_query_np``) against the JAX package's.

The reference's ``tests/test_sketch_parity.py`` on the port's copy: the
vectorized hash indices against the seed's loop, one-sidedness (no variant
undercounts, on either core), SALSA's saturation merges, SALSA's effective
cardinality gain (``slow``, as in the reference), the slim twin within 2x of
the fat sketch, the twin composing around the fat core, merge counters on
the metrics plane, a dead provider, and the two cores bitwise equal. On the
CPU, ``impl="pallas"`` takes the kernels' wrappers, which run their plain
versions on CPU tensors.

Across packages: the same seeded streams give bitwise-equal states and
equal reports (the JAX package on its XLA core), both sketches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.engine.param import (  # noqa: E402
    ParamConfig as JParamConfig,
)
from sentinel_tpu.sketch import parity as JP  # noqa: E402
from sentinel_tpu.sketch.slim import slim_query_np as j_slim_query  # noqa

from sentinel_tpu_torch.engine.param import (  # noqa: E402
    ParamConfig,
    hash_indices,
)
from sentinel_tpu_torch.sketch import VARIANTS, sketch_stats  # noqa: E402
from sentinel_tpu_torch.sketch import parity as P  # noqa: E402
from sentinel_tpu_torch.sketch.slim import (  # noqa: E402
    SLIM_SALT,
    slim_estimate_np,
    slim_query_np,
)
from torch_parity import assert_arrays_equal  # noqa: E402

SEED = P.DEFAULT_SEED
CPU = "cpu"


def _cfg(sketch, impl="jax", **kw):
    kw.setdefault("max_param_rules", 8)
    kw.setdefault("depth", 2)
    kw.setdefault("width", 512)
    return ParamConfig(sketch=sketch, impl=impl, **kw)


def _hash_indices_loop(value_hashes, depth, width, salt=0):
    """The seed's per-depth host loop, kept verbatim as the reference."""
    mix = np.uint64(0x9E3779B97F4A7C15)
    fin1 = np.uint64(0xBF58476D1CE4E5B9)
    fin2 = np.uint64(0x94D049BB133111EB)
    h = value_hashes.astype(np.uint64)
    out = np.empty((h.shape[0], depth), np.int32)
    with np.errstate(over="ignore"):
        for d in range(depth):
            x = h + np.uint64(salt + d + 1) * mix
            x = (x ^ (x >> np.uint64(30))) * fin1
            x = (x ^ (x >> np.uint64(27))) * fin2
            x = x ^ (x >> np.uint64(31))
            out[:, d] = (x % np.uint64(width)).astype(np.int32)
    return out


@pytest.mark.parametrize("depth,width,salt", [
    (1, 16, 0), (2, 2048, 0), (4, 4096, 0), (2, 256, SLIM_SALT),
])
def test_hash_indices_vectorized_matches_loop(depth, width, salt):
    rng = np.random.default_rng(SEED)
    h = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64)
    h[:3] = (0, -1, 2 ** 63 - 1)  # edge values
    np.testing.assert_array_equal(
        hash_indices(h, depth, width, salt=salt),
        _hash_indices_loop(h, depth, width, salt=salt),
    )


@pytest.mark.parametrize("sketch", VARIANTS)
def test_no_undercount_jax(sketch):
    rep = P.stream_report(_cfg(sketch), n_keys=256, n_events=8192,
                          seed=SEED, device=CPU)
    assert rep["undercounts"] == 0
    assert rep["slim"]["undercounts"] == 0


@pytest.mark.parametrize("sketch", VARIANTS)
def test_no_undercount_pallas_interpret(sketch):
    rep = P.stream_report(
        _cfg(sketch, impl="pallas", width=128),
        n_keys=64, n_events=1024, batch=256, seed=SEED, with_slim=False,
        device=CPU,
    )
    assert rep["undercounts"] == 0


def test_salsa_saturation_merge_never_undercounts():
    """Few keys hammered hard enough to saturate int16 cells: the merge
    path keeps the one-sided guarantee."""
    rep = P.stream_report(
        _cfg("salsa", width=16), n_keys=8, n_events=4096, acquire=64,
        seed=SEED, with_slim=False, device=CPU,
    )
    assert rep["undercounts"] == 0
    assert rep["errCdf"]["max"] >= 0


@pytest.mark.slow
def test_salsa_effective_cardinality_gain():
    """At equal bytes (int32 width-W vs int16 width-2W), SALSA holds
    ≥1.8× the key cardinality within the p90 error budget."""
    base = dict(width=128, depth=2, max_param_rules=4)
    k_cms = P.effective_cardinality(
        ParamConfig(sketch="cms", impl="jax", **base), device=CPU)
    k_salsa = P.effective_cardinality(
        ParamConfig(sketch="salsa", impl="jax", **base), device=CPU)
    assert k_salsa / k_cms >= 1.8, (k_cms, k_salsa)


def test_slim_error_within_2x_of_fat():
    """On a stream the slim geometry can hold, the twin's p90 overestimate
    stays within 2× of the fat sketch's (with a 2-count floor)."""
    cfg = _cfg("cms", width=512, slim_depth=2, slim_width=256)
    rep = P.stream_report(cfg, n_keys=128, n_events=4096, seed=SEED,
                          device=CPU)
    fat_p90 = rep["errCdf"]["p90"]
    slim_p90 = rep["slim"]["errCdf"]["p90"]
    assert rep["slim"]["undercounts"] == 0
    assert slim_p90 <= max(2.0 * fat_p90, 2.0), (fat_p90, slim_p90)


def test_slim_disabled_matches_enabled_fat_bitwise():
    """The twin composes AROUND the fat core: maintaining it changes not
    one bit of the fat sketch."""
    cfg_on = _cfg("cms", slim_depth=2, slim_width=256)
    cfg_off = _cfg("cms", slim_depth=0, slim_width=0)
    hashes, _ = P.zipf_stream(64, 2048, seed=SEED)
    s_on = P.run_stream(cfg_on, hashes, device=CPU)
    s_off = P.run_stream(cfg_off, hashes, device=CPU)
    assert torch.equal(s_on.counts, s_off.counts)


def test_salsa_merges_counted_and_rendered():
    from sentinel_tpu_torch.metrics.server import (
        reset_server_metrics_for_tests,
        server_metrics,
    )

    cfg = _cfg("salsa", width=16)
    hashes, _ = P.zipf_stream(8, 2048, seed=SEED)
    state = P.run_stream(cfg, hashes, acquire=64, maintain_slim=False,
                         device=CPU)
    stats = sketch_stats(cfg, state)
    assert stats["variant"] == "salsa"
    assert stats["mergesTotal"] > 0
    assert stats["mergesBySlot"].get(0, 0) == stats["mergesTotal"]
    assert stats["fatBytes"] == state.counts.numel() * 2

    sm = server_metrics()
    try:
        sm.register_sketch_provider(lambda: stats)
        body = sm.render()
        assert (
            f'sentinel_sketch_merges_total{{slot="0"}} '
            f'{stats["mergesTotal"]}'
        ) in body
        assert "sentinel_sketch_fat_bytes_total" in body
        assert "sentinel_sketch_slim_bytes_total" in body
        assert sm.snapshot()["sketch"]["mergesTotal"] == stats["mergesTotal"]
    finally:
        reset_server_metrics_for_tests()


def test_sketch_provider_survives_dead_service():
    from sentinel_tpu_torch.metrics.server import (
        reset_server_metrics_for_tests,
        server_metrics,
    )

    sm = server_metrics()
    try:
        sm.register_sketch_provider(lambda: (_ for _ in ()).throw(
            RuntimeError("service gone")))
        assert sm.sketch_stats() == {}
        assert "sentinel_sketch_merges_total" in sm.render()
    finally:
        reset_server_metrics_for_tests()


@pytest.mark.parametrize("sketch", VARIANTS)
def test_jax_and_pallas_agree_bitwise(sketch):
    cfg_j = _cfg(sketch, impl="jax", width=128)
    cfg_p = _cfg(sketch, impl="pallas", width=128)
    hashes, _ = P.zipf_stream(32, 512, seed=SEED)
    s_j = P.run_stream(cfg_j, hashes, batch=256, maintain_slim=False,
                       device=CPU)
    s_p = P.run_stream(cfg_p, hashes, batch=256, maintain_slim=False,
                       device=CPU)
    assert torch.equal(s_j.counts, s_p.counts)
    assert torch.equal(s_j.merges, s_p.merges)


# -- across packages ----------------------------------------------------------
def test_streams_and_keys_are_the_reference():
    for n_keys, n_events, alpha, seed in ((64, 2048, 1.1, SEED),
                                          (1000, 5000, 1.05, 3)):
        np.testing.assert_array_equal(P.key_hashes(n_keys, seed),
                                      JP.key_hashes(n_keys, seed))
        h, ids = P.zipf_stream(n_keys, n_events, alpha, seed)
        jh, jids = JP.zipf_stream(n_keys, n_events, alpha, seed)
        np.testing.assert_array_equal(h, jh)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(P.exact_counts(ids, n_keys, 3),
                                      JP.exact_counts(jids, n_keys, 3))


@pytest.mark.parametrize("sketch", VARIANTS)
def test_run_stream_state_and_report_equal_the_reference(sketch):
    kw = dict(max_param_rules=4, depth=2, width=256, slim_width=128)
    cfg = ParamConfig(sketch=sketch, impl="jax", **kw)
    jcfg = JParamConfig(sketch=sketch, impl="jax", **kw)
    hashes, _ = P.zipf_stream(300, 3000, seed=SEED)
    state = P.run_stream(cfg, hashes, acquire=3, batch=256, slot=1,
                         device=CPU)
    jstate = JP.run_stream(jcfg, hashes, acquire=3, batch=256, slot=1)
    for leaf in ("starts", "counts", "slim", "slim_auth", "merges"):
        assert_arrays_equal(np.asarray(getattr(jstate, leaf)),
                            getattr(state, leaf), leaf)
    keys = P.key_hashes(300)
    np.testing.assert_array_equal(P.query_np(cfg, state, 1, keys, 1000),
                                  JP.query_np(jcfg, jstate, 1, keys, 1000))
    np.testing.assert_array_equal(
        slim_query_np(cfg, state, 1, keys, 1000),
        j_slim_query(jcfg, jstate, 1, keys, 1000))
    idx, starts, slim, live = slim_estimate_np(cfg, state, keys, 1000)
    assert idx.shape == (300, 2) and slim.shape == (4, 2, 2, 128)
    assert live.tolist() == (starts == 1000).tolist()
    rep = P.stream_report(cfg, n_keys=200, n_events=4000, batch=512,
                          device=CPU)
    jrep = JP.stream_report(jcfg, n_keys=200, n_events=4000, batch=512)
    assert rep == jrep
