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

A leaf may be sharded: a JAX array sharded over a mesh reads whole through
``np.asarray``, as does a port ``parallel.sharding.ShardedTensor``; and
:func:`state_from_numpy` / :func:`rules_from_numpy` place their result on a
port mesh when given one.

Rules cross by field name: :func:`port_rule` turns any object with a rule's
fields (the reference's dataclasses in a state export) into the port's rule
of that kind.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
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


def _device_of(device: DeviceLike, mesh) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        raise ValueError("mesh and device are exclusive")
    return mesh[0]


def state_from_numpy(d: Dict[str, np.ndarray],
                     device: DeviceLike = None, mesh=None) -> EngineState:
    """An :class:`EngineState` on ``device`` (``cuda`` unless told
    otherwise) from a :func:`state_to_numpy` dict; dtypes are kept. With a
    ``mesh`` (a ``parallel.FlowMesh``, exclusive with ``device``) the state
    comes back sharded over it."""
    dev = _device_of(device, mesh)
    state = EngineState(**{
        plane: cls(**{
            field: torch.as_tensor(np.array(d[f"{plane}.{field}"]),
                                   device=dev)
            for field in cls._fields
        })
        for plane, cls in _PLANES.items()
    })
    if mesh is None:
        return state
    from sentinel_tpu_torch.parallel.sharding import shard_state

    return shard_state(state, mesh)


def rules_to_numpy(rules) -> Dict[str, np.ndarray]:
    """``{"valid": ..., ...}`` for a port or reference rule table."""
    return {
        field: np.array(_np(getattr(rules, field)))
        for field in RuleTable._fields
        if getattr(rules, field) is not None
    }


def rules_from_numpy(d: Dict[str, np.ndarray],
                     device: DeviceLike = None, mesh=None) -> RuleTable:
    """A :class:`RuleTable` from a :func:`rules_to_numpy` dict, on
    ``device`` or sharded over ``mesh``."""
    dev = _device_of(device, mesh)
    table = RuleTable(**{
        field: (torch.as_tensor(np.array(d[field]), device=dev)
                if field in d else None)
        for field in RuleTable._fields
    })
    if mesh is None:
        return table
    from sentinel_tpu_torch.parallel.sharding import shard_rules

    return shard_rules(table, mesh)


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


@functools.lru_cache(maxsize=None)
def _field_plan(kind):
    """``(name, cast)`` per field of ``kind``: the port's enum for an enum
    field, ``int`` / ``float`` / ``str`` for a plain one, else None."""
    plan = []
    for f in dataclasses.fields(kind):
        if isinstance(f.default, enum.Enum):
            plan.append((f.name, type(f.default)))
        else:
            plan.append((f.name, _CASTS.get(f.type)))
    return tuple(plan)


def port_rule(rule, kind):
    """The port's rule dataclass ``kind`` (``ClusterFlowRule``,
    ``DegradeRule``, ``ClusterParamFlowRule``, ...) built from any object
    that has its fields, read by name: enum fields take the port's enum of
    the same value, plain int / float / str fields are cast, others are
    kept. A field the object lacks keeps ``kind``'s default. A rule that is
    already a ``kind`` (frozen) comes back as is."""
    if type(rule) is kind:
        return rule
    vals = {}
    for name, cast in _field_plan(kind):
        if not hasattr(rule, name):
            continue
        v = getattr(rule, name)
        if cast is not None:
            v = cast(int(v)) if issubclass(cast, enum.Enum) else cast(v)
        vals[name] = v
    return kind(**vals)
