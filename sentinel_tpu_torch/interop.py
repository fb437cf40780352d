"""Carry state and rules across to and from numpy.

The dicts hold one numpy array per leaf, keyed by the reference pytree's
field path: ``flow.counts``, ``shaping.lpt``, ``breaker.state`` for an
``EngineState``; ``valid``, ``count``, ``br_strategy`` for a ``RuleTable``
(a ``br_*`` key is absent when the table has no degrade rules); ``starts``,
``counts``, ``slim``, ``slim_auth``, ``merges`` for a ``ParamState`` (the
``param`` block of the reference service's state export). The same layout
comes out of any ``NamedTuple`` tree whose leaves numpy can read, so a JAX
``EngineState`` or ``ParamState`` flattens to an identical dict and both
packages can step the same state.

Rules cross by field name: :func:`port_rule` turns any object with a rule's
fields (the reference's dataclasses in a state export) into the port's rule
of that kind.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import numpy as np
import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device
from sentinel_tpu_torch.engine.param import ParamState
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


def param_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """``{"starts": ..., "counts": ..., ...}`` for a port or reference
    param state."""
    return {field: np.array(_np(getattr(state, field)))
            for field in ParamState._fields}


def param_state_from_numpy(d: Dict[str, np.ndarray],
                           device: DeviceLike = None) -> ParamState:
    """A :class:`ParamState` on ``device`` (``cuda`` unless told otherwise)
    from a :func:`param_state_to_numpy` dict; dtypes are kept."""
    dev = resolve_device(device)
    return ParamState(**{
        field: torch.as_tensor(np.array(d[field]), device=dev)
        for field in ParamState._fields
    })


_CASTS = {"int": int, "float": float, "str": str}


def port_rule(rule, kind):
    """The port's rule dataclass ``kind`` (``ClusterFlowRule``,
    ``DegradeRule``, ``ClusterParamFlowRule``, ...) built from any object
    that has its fields, read by name: enum fields take the port's enum of
    the same value, plain int / float / str fields are cast, others are
    kept. A field the object lacks keeps ``kind``'s default."""
    vals = {}
    for f in dataclasses.fields(kind):
        if not hasattr(rule, f.name):
            continue
        v = getattr(rule, f.name)
        if isinstance(f.default, enum.Enum):
            v = type(f.default)(int(v))
        elif f.type in _CASTS:
            v = _CASTS[f.type](v)
        vals[f.name] = v
    return kind(**vals)
