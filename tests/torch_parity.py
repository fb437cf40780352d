"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The same seeded numpy inputs go to the JAX package (the reference) and to
its port in ``sentinel_tpu_torch``; results are compared with ``==`` on raw
arrays, never ``allclose``: every summed value is an integer-valued float32
below 2^24, so any difference is a semantic drift, not float noise.
"""

from __future__ import annotations

import numpy as np

from sentinel_tpu_torch import interop

CPU = "cpu"


def to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_arrays_equal(a, b, label):
    a, b = to_np(a), to_np(b)
    assert a.dtype == b.dtype, f"{label}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{label}: shape {a.shape} vs {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=label)


def assert_states_equal(jax_state, torch_state, label):
    ref = interop.state_to_numpy(jax_state)
    got = interop.state_to_numpy(torch_state)
    assert ref.keys() == got.keys()
    for key in ref:
        assert_arrays_equal(ref[key], got[key], f"{label}: {key}")


def assert_verdicts_equal(jax_v, torch_v, label):
    for field in ("status", "wait_ms", "remaining"):
        assert_arrays_equal(
            getattr(jax_v, field), getattr(torch_v, field),
            f"{label}: verdict {field}",
        )


def port_state_of(jax_state):
    """The port's state holding the reference state's exact leaves."""
    return interop.state_from_numpy(interop.state_to_numpy(jax_state), CPU)


def port_rules_of(jax_table):
    return interop.rules_from_numpy(interop.rules_to_numpy(jax_table), CPU)
