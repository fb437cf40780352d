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
from sentinel_tpu_torch.ops import prefix_cuda, scan  # noqa: E402
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
