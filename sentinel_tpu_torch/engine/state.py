"""Engine state: all mutable counters as one ``NamedTuple`` of tensors (port
of ``sentinel_tpu/engine/state.py``, same planes, field names and dtypes).

Device state at the serving size (``max_flows=100_000``, 10 buckets): flow
plane ``[F, 10, 6]`` i32 24 MB, occupy ``[F, 10, 1]`` i32 4 MB, outcome
``[F, 10, 16]`` i32 64 MB, plus the ``[F]`` shaping and breaker columns.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device
from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.stats.window import (
    NEVER,
    WindowSpec,
    WindowState,
    make_window,
)


class ClusterEvent(enum.IntEnum):
    """``ClusterFlowEvent`` columns of the flow plane. PASS counts tokens,
    PASS_REQUEST counts RPCs; LEASED counts tokens pre-paid to client
    leases and is read with PASS by admission."""

    PASS = 0
    PASS_REQUEST = 1
    BLOCK = 2
    BLOCK_REQUEST = 3
    OCCUPIED_PASS = 4
    LEASED = 5


N_CLUSTER_EVENTS = len(ClusterEvent)


class OutcomeChannel(enum.IntEnum):
    """Completion-outcome channels of the per-flow outcome window; channels
    ``RT_HIST0 ..`` are a log2-bucketed RT histogram."""

    RT_SUM = 0
    COMPLETE = 1
    EXCEPTION = 2
    SLOW = 3
    RT_HIST0 = 4


N_RT_BUCKETS = 12
N_OUTCOME_CHANNELS = int(OutcomeChannel.RT_HIST0) + N_RT_BUCKETS

# Upper edge (ms) of each RT histogram cell, 2^(j+1) - 1; the last cell is
# open-ended. Host-side p99 reads walk this table.
RT_BUCKET_UPPER_MS = tuple(
    (1 << (j + 1)) - 1 for j in range(N_RT_BUCKETS - 1)
) + (float("inf"),)


class ShapingState(NamedTuple):
    """Per-flow traffic-shaper clocks. ``NEVER`` marks a slot whose shaper
    has not run yet."""

    lpt: torch.Tensor  # int32 [F] — latest passed time (pacing), engine ms
    warm_tokens: torch.Tensor  # float32 [F] — warmup stored tokens
    warm_filled: torch.Tensor  # int32 [F] — last warmup sync second


# circuit-breaker states (AbstractCircuitBreaker.State)
BR_CLOSED = 0
BR_OPEN = 1
BR_HALF_OPEN = 2


class BreakerState(NamedTuple):
    """Per-flow circuit-breaker columns; ``opened_ms`` doubles as the stats
    fence and ``probe_ms`` is the HALF_OPEN probe ticket."""

    state: torch.Tensor  # int8 [F]
    opened_ms: torch.Tensor  # int32 [F]
    probe_ms: torch.Tensor  # int32 [F]


class EngineState(NamedTuple):
    flow: WindowState  # [F, B, E] current windows
    occupy: WindowState  # [F, B, 1] future (borrowed) windows
    ns: WindowState  # [NS, B, 1] namespace request qps guard
    shaping: ShapingState  # [F] per-flow shaper clocks
    outcome: WindowState  # [F, B, N_OUTCOME_CHANNELS] completion outcomes
    breaker: BreakerState  # [F] per-flow circuit-breaker columns


def flow_spec(config: EngineConfig) -> WindowSpec:
    return WindowSpec(bucket_ms=config.bucket_ms, n_buckets=config.n_buckets)


def make_shaping(n_flows: int, device=None) -> ShapingState:
    return ShapingState(
        lpt=torch.full((n_flows,), NEVER, dtype=torch.int32, device=device),
        warm_tokens=torch.zeros((n_flows,), dtype=torch.float32,
                                device=device),
        warm_filled=torch.full((n_flows,), NEVER, dtype=torch.int32,
                               device=device),
    )


def make_breaker(n_flows: int, device=None) -> BreakerState:
    return BreakerState(
        state=torch.zeros((n_flows,), dtype=torch.int8, device=device),
        opened_ms=torch.full((n_flows,), NEVER, dtype=torch.int32,
                             device=device),
        probe_ms=torch.full((n_flows,), NEVER, dtype=torch.int32,
                            device=device),
    )


def make_state(config: EngineConfig, device: DeviceLike = None) -> EngineState:
    """Fresh engine state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    spec = flow_spec(config)
    return EngineState(
        flow=make_window(spec, config.max_flows, N_CLUSTER_EVENTS,
                         device=dev),
        occupy=make_window(spec, config.max_flows, 1, device=dev),
        ns=make_window(spec, config.max_namespaces, 1, device=dev),
        shaping=make_shaping(config.max_flows, device=dev),
        outcome=make_window(spec, config.max_flows, N_OUTCOME_CHANNELS,
                            device=dev),
        breaker=make_breaker(config.max_flows, device=dev),
    )


def clone_state(state: EngineState) -> EngineState:
    """A deep copy (the port's stand-in for JAX's immutable inputs)."""
    return EngineState(*(
        type(plane)(*(leaf.clone() for leaf in plane)) for plane in state
    ))


def state_nbytes(state: EngineState) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for plane in state for leaf in plane)
