"""Carry state and rules across to and from numpy.

The dicts hold one numpy array per leaf, keyed by the reference pytree's
field path: ``flow.counts``, ``shaping.lpt``, ``breaker.state`` for an
``EngineState``; ``valid``, ``count``, ``br_strategy`` for a ``RuleTable``
(a ``br_*`` key is absent when the table has no degrade rules). The same
layout comes out of any ``NamedTuple`` tree whose leaves numpy can read, so
a JAX ``EngineState`` flattens to an identical dict and both packages can
step the same state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device
from sentinel_tpu_torch.engine.rules import RuleTable
from sentinel_tpu_torch.engine.state import (
    BreakerState,
    EngineState,
    ShapingState,
)
from sentinel_tpu_torch.stats.window import WindowState

_PLANES = {
    "flow": WindowState,
    "occupy": WindowState,
    "ns": WindowState,
    "shaping": ShapingState,
    "outcome": WindowState,
    "breaker": BreakerState,
}


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """``{"flow.counts": ..., ...}`` for a port or reference state."""
    return {
        f"{plane}.{field}": np.array(_np(getattr(getattr(state, plane),
                                                 field)))
        for plane, cls in _PLANES.items()
        for field in cls._fields
    }


def state_from_numpy(d: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> EngineState:
    """An :class:`EngineState` on ``device`` (``cuda`` unless told
    otherwise) from a :func:`state_to_numpy` dict; dtypes are kept."""
    dev = resolve_device(device)
    return EngineState(**{
        plane: cls(**{
            field: torch.as_tensor(np.array(d[f"{plane}.{field}"]),
                                   device=dev)
            for field in cls._fields
        })
        for plane, cls in _PLANES.items()
    })


def rules_to_numpy(rules) -> Dict[str, np.ndarray]:
    """``{"valid": ..., ...}`` for a port or reference rule table."""
    return {
        field: np.array(_np(getattr(rules, field)))
        for field in RuleTable._fields
        if getattr(rules, field) is not None
    }


def rules_from_numpy(d: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> RuleTable:
    dev = resolve_device(device)
    return RuleTable(**{
        field: (torch.as_tensor(np.array(d[field]), device=dev)
                if field in d else None)
        for field in RuleTable._fields
    })
