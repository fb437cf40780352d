"""Metric event channels (the port's copy of ``sentinel_tpu/stats/events.py``).

Analog of ``sentinel-core/.../slots/statistic/MetricEvent.java:21-38``
({PASS, BLOCK, EXCEPTION, SUCCESS, RT, OCCUPIED_PASS}). RT is stored in a
separate float32 tensor (sums of milliseconds overflow int32 at high QPS),
so the integer channel list here has five entries.
"""

from __future__ import annotations

import enum


class Event(enum.IntEnum):
    PASS = 0
    BLOCK = 1
    EXCEPTION = 2
    SUCCESS = 3
    OCCUPIED_PASS = 4


N_EVENTS = len(Event)
