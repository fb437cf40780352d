"""PyTorch + CUDA port of the cluster token server's flow decision and
hot-param path.

``sentinel_tpu`` (JAX, Pallas on TPU) is the reference; this package is its
twin for one NVIDIA Hopper GPU. Module paths mirror the reference, so the
counterpart of ``sentinel_tpu/engine/param.py`` is
``sentinel_tpu_torch/engine/param.py``. The exceptions are the TPU kernels:
each ``sentinel_tpu/ops/<name>_pallas.py`` (decide, cms, salsa, prefix)
becomes a wrapper ``sentinel_tpu_torch/ops/<name>_cuda.py`` plus the
hand-written CUDA source ``sentinel_tpu_torch/csrc/<name>.cu``.

Conventions:

- State and rules are ``NamedTuple``\\ s of tensors with the reference's field
  names and dtypes; functions take tensors and an explicit ``device``.
- Entry points (``make_state``, ``build_rule_table``, ``make_param_state``,
  ``DefaultTokenService``) place tensors on ``cuda`` unless the caller passes
  ``device="cpu"``. With no card present they raise; they never fall back to
  the CPU.
- JAX buffer donation becomes an in-place update of the state tensors.
- The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
  ``sentinel_tpu``.
"""

__version__ = "0.1.0"  # the reference's (sentinel_tpu/__init__.py)
