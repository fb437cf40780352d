"""Kernels of the port and their plain PyTorch versions.

``decide_cuda`` holds the hand-written CUDA decide kernel's wrapper (source
in ``sentinel_tpu_torch/csrc/``); ``scan`` the batch-axis cumulative ops.
Kernels are built and loaded at first use, never at import.
"""
