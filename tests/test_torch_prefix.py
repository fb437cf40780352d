"""The port's segment prefixes and batch-axis scans against the reference
(``sentinel_tpu.engine.prefix``, ``sentinel_tpu.ops.prefix_pallas`` and
``sentinel_tpu.ops.scan_mm``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.engine.prefix import segment_prefix_builder as j_builder  # noqa: E402
from sentinel_tpu.ops import scan_mm  # noqa: E402
from sentinel_tpu.ops.prefix_pallas import segment_prefix_pallas  # noqa: E402

from sentinel_tpu_torch.engine.prefix import segment_prefix_builder  # noqa: E402
from sentinel_tpu_torch.ops import cms_cuda, prefix_cuda, scan  # noqa: E402
import torch_kernel_check as DC  # noqa: E402
from torch_parity import assert_arrays_equal  # noqa: E402


def _keys(rng, n, grouped):
    keys = rng.integers(0, max(2, n // 6), size=n).astype(np.int32)
    return np.sort(keys) if grouped else keys


@pytest.mark.parametrize("impl", ["grouped", "matmul", "sort", "auto"])
@pytest.mark.parametrize("n", [64, 256])
def test_segment_prefix_parity(impl, n):
    rng = np.random.default_rng(n + len(impl))
    keys = _keys(rng, n, grouped=impl == "grouped")
    jp = j_builder(jnp.asarray(keys), impl)
    tp = segment_prefix_builder(torch.as_tensor(keys), impl)
    for _ in range(4):
        contrib = rng.integers(0, 7, size=n).astype(np.float32)
        contrib[rng.random(n) < 0.3] = 0.0
        assert_arrays_equal(jp(jnp.asarray(contrib)),
                            tp(torch.as_tensor(contrib)), impl)
        # and against the definition
        want = np.array([
            contrib[:i][keys[:i] == keys[i]].sum() for i in range(n)
        ], np.float32)
        np.testing.assert_array_equal(
            tp(torch.as_tensor(contrib)).numpy(), want
        )


def test_prefix_pallas_not_ported_yet():
    """"pallas" selects the ported kernel's wrapper (its plain version on
    CPU tensors, which launches nothing); unknown names raise."""
    keys = torch.tensor([3, 1, 3, 3, 1], dtype=torch.int32)
    before = dict(prefix_cuda.LAUNCHES)
    got = segment_prefix_builder(keys, "pallas")(torch.tensor(
        [1.0, 2.0, 4.0, 8.0, 16.0]))
    assert got.tolist() == [0.0, 0.0, 1.0, 5.0, 2.0]
    assert prefix_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        segment_prefix_builder(torch.zeros(8, dtype=torch.int32), "nope")


@pytest.mark.parametrize("n", [1, 7, 256, 700, 2100])
def test_prefix_pallas_matches_interpret_kernel(n):
    """The cases of tests/test_ops_pallas.py: the reference's tiled kernel
    in interpret mode against the port's, on integer contributions."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(1, n // 3), size=n).astype(np.int32)
    contrib = rng.integers(0, 5, size=n).astype(np.float32)
    want = segment_prefix_pallas(jnp.asarray(keys), jnp.asarray(contrib),
                                 interpret=True)
    got = segment_prefix_builder(torch.as_tensor(keys), "pallas")(
        torch.as_tensor(contrib))
    assert_arrays_equal(want, got, f"n={n}")
    assert_arrays_equal(
        want, prefix_cuda.segment_prefix_plain(torch.as_tensor(keys),
                                               torch.as_tensor(contrib)),
        f"plain n={n}")


@pytest.mark.parametrize("shape", [(1,), (127,), (128,), (300,), (300, 4)])
def test_scan_parity(shape):
    """The cases of tests/test_ops_scan.py: blocked_cumsum / cummax."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 50, size=shape).astype(np.float32)
    assert_arrays_equal(scan_mm.blocked_cumsum(jnp.asarray(x)),
                        scan.blocked_cumsum(torch.as_tensor(x)), "cumsum")
    if len(shape) == 1:
        y = rng.integers(-40, 40, size=shape).astype(np.float32)
        assert_arrays_equal(scan_mm.blocked_cummax(jnp.asarray(y)),
                            scan.blocked_cummax(torch.as_tensor(y)),
                            "cummax")


@pytest.mark.parametrize("shape", DC.PREFIX_KEY_SHAPES)
@pytest.mark.parametrize("n", [1, 2, 33, 300])
def test_plan_apply_match_mask_and_reference(n, shape):
    """The plan and apply (their plain versions here) against the mask form
    and the reference's tiled kernel in interpret mode, on every key shape
    the kernels are held on: one key, a key per row, keys equal in their
    low 8 or 16 bits, negative keys with the int32 extremes."""
    rng = np.random.default_rng(n)
    keys = DC.prefix_key_shapes(rng, n)[shape]
    contrib = rng.integers(0, 5, size=n).astype(np.float32)
    k, c = torch.as_tensor(keys), torch.as_tensor(contrib)
    plan = prefix_cuda.segment_prefix_plan(k)
    got = prefix_cuda.segment_prefix_apply(plan, c)
    assert torch.equal(got, prefix_cuda.segment_prefix_plain(k, c))
    want = segment_prefix_pallas(jnp.asarray(keys), jnp.asarray(contrib),
                                 interpret=True)
    assert_arrays_equal(want, got, f"{shape} n={n}")


@pytest.mark.parametrize("shape", DC.PREFIX_KEY_SHAPES)
@pytest.mark.parametrize("n", [1, 257])
def test_plan_is_a_stable_grouping(n, shape):
    """The plan's contract, which the kernel's is held to bitwise: a
    permutation sorted by the key's bits as unsigned, rows of one key in
    batch order, bit 31 set exactly where the key changes."""
    keys = DC.prefix_key_shapes(np.random.default_rng(7), n)[shape]
    order = prefix_cuda.segment_prefix_plan(torch.as_tensor(keys)).order
    p = order.numpy().astype(np.int64)
    rows, head = p & 0x7FFFFFFF, p < 0
    assert sorted(rows.tolist()) == list(range(n))
    bits = keys.astype(np.int64) & 0xFFFFFFFF
    sorted_bits = bits[rows]
    assert np.all(sorted_bits[1:] >= sorted_bits[:-1])
    same = sorted_bits[1:] == sorted_bits[:-1]
    assert np.all(rows[1:][same] > rows[:-1][same])  # stable
    assert head[0] and np.array_equal(head[1:], ~same)


def test_pallas_builder_plans_once(monkeypatch):
    """"pallas" plans once per builder (one sort per key vector) and
    applies once per call; it equals "sort"."""
    rng = np.random.default_rng(3)
    keys = torch.as_tensor(DC.ZipfIds(64)(rng, 500).astype(np.int32))
    plan_fn, apply_fn = (prefix_cuda.segment_prefix_plan,
                         prefix_cuda.segment_prefix_apply)
    calls = {"plan": 0, "apply": 0}

    def plan(k):
        calls["plan"] += 1
        return plan_fn(k)

    def apply(p, c):
        calls["apply"] += 1
        return apply_fn(p, c)

    monkeypatch.setattr(prefix_cuda, "segment_prefix_plan", plan)
    monkeypatch.setattr(prefix_cuda, "segment_prefix_apply", apply)
    pallas = segment_prefix_builder(keys, "pallas")
    sort = segment_prefix_builder(keys, "sort")
    for _ in range(5):
        c = torch.as_tensor(rng.integers(0, 4, 500).astype(np.float32))
        assert torch.equal(pallas(c), sort(c))
    assert calls == {"plan": 1, "apply": 5}


def _mask_admission(key, live, est, acquire, threshold):
    acq = acquire.to(torch.int32)
    admit = live
    for _ in range(cms_cuda.REFINE_ITERS):
        prefix = prefix_cuda.segment_prefix_plain(
            key, torch.where(admit, acq, 0))
        admit = live & (est.to(torch.float32) + prefix
                        + acq.to(torch.float32) <= threshold)
    return admit


@pytest.mark.parametrize("shape", DC.PREFIX_KEY_SHAPES)
def test_admit_rows_matches_mask_admission(shape):
    """The param kernels' admission (one sort, then a segmented scan a pass)
    as its plain version writes it, against the same greedy passes over the
    same-key mask, on the prefix kernels' key shapes: the two agree row for
    row, and some rows are rejected by the in-batch prefix alone."""
    n = 600
    rng = np.random.default_rng(11)
    key = torch.as_tensor(DC.prefix_key_shapes(rng, n)[shape])
    live = torch.as_tensor(rng.random(n) < 0.9)
    est = torch.as_tensor(rng.integers(0, 20, n).astype(np.int32))
    acquire = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32))
    threshold = torch.as_tensor(rng.integers(10, 40, n).astype(np.float32))
    got = cms_cuda.admit_rows(key, live, est, acquire, threshold)
    assert torch.equal(got, _mask_admission(key, live, est, acquire,
                                            threshold))
    alone = live & (est.to(torch.float32) + acquire.to(torch.float32)
                    <= threshold)
    assert bool(got.any())
    if shape != "distinct":
        assert bool((alone & ~got).any())
