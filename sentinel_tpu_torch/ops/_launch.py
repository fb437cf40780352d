"""Argument checks shared by the kernels' wrappers: a launch takes only the
device, dtype, shape and layout its C interface expects, and raises on
anything else before a pointer reaches the kernel."""

from __future__ import annotations

import torch


def check(fn: str, name: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{fn}: {name} has shape {tuple(t.shape)}, not {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def stream_of(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C handle."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(fn: str, err: int) -> None:
    """A C entry point returns ``cudaGetLastError()`` after its launches."""
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
