"""The port's segment prefixes and batch-axis scans against the reference
(``sentinel_tpu.engine.prefix`` and ``sentinel_tpu.ops.scan_mm``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.engine.prefix import segment_prefix_builder as j_builder  # noqa: E402
from sentinel_tpu.ops import scan_mm  # noqa: E402

from sentinel_tpu_torch.engine.prefix import segment_prefix_builder  # noqa: E402
from sentinel_tpu_torch.ops import scan  # noqa: E402
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
    with pytest.raises(NotImplementedError):
        segment_prefix_builder(torch.zeros(8, dtype=torch.int32), "pallas")
    with pytest.raises(ValueError):
        segment_prefix_builder(torch.zeros(8, dtype=torch.int32), "nope")


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
