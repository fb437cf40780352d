"""Kernels of the port and their plain PyTorch versions.

``decide_cuda``, ``cms_cuda``, ``salsa_cuda`` and ``prefix_cuda`` hold the
wrappers of the hand-written CUDA kernels (sources in
``sentinel_tpu_torch/csrc/``) beside their plain versions; ``scan`` the
batch-axis cumulative ops.
Kernels are built and loaded at first use, never at import.
"""
