"""Sliding-window counters as tensors (port of ``sentinel_tpu.stats``)."""

from sentinel_tpu_torch.stats.window import (
    NEVER,
    WindowSpec,
    WindowState,
    add_events,
    bucket_index,
    make_window,
    roll,
    window_sum,
    window_sum_all,
)
from sentinel_tpu_torch.stats.events import Event

__all__ = [
    "Event",
    "NEVER",
    "WindowSpec",
    "WindowState",
    "add_events",
    "bucket_index",
    "make_window",
    "roll",
    "window_sum",
    "window_sum_all",
]
