"""Rules as padded tensors (port of ``sentinel_tpu/engine/rules.py``).

The host keeps the ``flow_id → slot`` assignment (stable across reloads for
unchanged rules, so window history survives a rule update); the device sees
fixed-shape columns. The numpy builder is the reference's, line for line;
only the final conversion goes to tensors.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device
from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.stats.window import NEVER


class ThresholdMode(enum.IntEnum):
    # AVG_LOCAL multiplies the per-client count by the connected-client
    # count (ClusterFlowChecker.java:43-47); GLOBAL uses count as-is.
    AVG_LOCAL = 0
    GLOBAL = 1


class DegradeStrategy(enum.IntEnum):
    SLOW_REQUEST_RATIO = 0
    ERROR_RATIO = 1
    ERROR_COUNT = 2


class ControlBehavior(enum.IntEnum):
    DEFAULT = 0
    WARM_UP = 1
    RATE_LIMITER = 2
    WARM_UP_RATE_LIMITER = 3


@dataclass(frozen=True)
class ClusterFlowRule:
    """Host-side cluster rule (``FlowRule`` + ``ClusterFlowConfig``
    subset); defaults match the reference."""

    flow_id: int
    count: float
    mode: ThresholdMode = ThresholdMode.AVG_LOCAL
    namespace: str = "default"
    control_behavior: int = 0
    warm_up_period_sec: int = 10
    cold_factor: int = 3
    max_queueing_time_ms: int = 500


@dataclass(frozen=True)
class DegradeRule:
    """Host-side circuit-breaker rule (``DegradeRule.java`` subset)."""

    flow_id: int
    strategy: DegradeStrategy = DegradeStrategy.SLOW_REQUEST_RATIO
    threshold: float = 1.0
    slow_rt_ms: int = 1000
    min_request_amount: int = 5
    stat_interval_ms: int = 1000
    recovery_timeout_ms: int = 5000
    namespace: str = "default"


# br_slow_rt_ms default for slots without a breaker rule
NO_SLOW_RT_MS = 2**30 - 1

# admission threshold for breaker-only slots (no ClusterFlowRule)
UNLIMITED_COUNT = 1e9


class RuleTable(NamedTuple):
    """Tensors shaped ``[max_flows]`` (+ ``[max_namespaces]``), same fields
    and dtypes as the reference. The six ``br_*`` columns are ``None`` when
    the table carries no degrade rules."""

    valid: torch.Tensor  # bool
    count: torch.Tensor  # float32
    mode: torch.Tensor  # int8 — ThresholdMode
    namespace_id: torch.Tensor  # int32
    ns_max_qps: torch.Tensor  # float32 [NS]
    ns_connected: torch.Tensor  # int32 [NS]
    behavior: torch.Tensor  # int8 — ControlBehavior
    warning_token: torch.Tensor  # float32
    max_token: torch.Tensor  # float32
    slope: torch.Tensor  # float32
    cold_count: torch.Tensor  # float32
    max_queue_ms: torch.Tensor  # int32
    br_strategy: Optional[torch.Tensor]  # int8, -1 = none
    br_threshold: Optional[torch.Tensor]  # float32
    br_slow_rt_ms: Optional[torch.Tensor]  # int32
    br_min_request: Optional[torch.Tensor]  # int32
    br_stat_ms: Optional[torch.Tensor]  # int32
    br_recovery_ms: Optional[torch.Tensor]  # int32


class RuleIndex:
    """Host-side flow_id → slot assignment (stable across reloads)."""

    def __init__(self, config: EngineConfig):
        self.config = config
        self._lock = threading.RLock()
        self.slot_of: Dict[int, int] = {}
        self.ns_of: Dict[str, int] = {}
        self._free = list(range(config.max_flows - 1, -1, -1))
        # slots freed by a reload still hold the removed flow's history;
        # drain_pending_clear zeroes them before reuse
        self.pending_clear: List[int] = []

    def namespace_slot(self, namespace: str) -> int:
        with self._lock:
            ns = self.ns_of.get(namespace)
            if ns is None:
                if len(self.ns_of) >= self.config.max_namespaces:
                    raise ValueError("namespace capacity exceeded")
                ns = self.ns_of[namespace] = len(self.ns_of)
            return ns

    def assign(self, flow_id: int) -> int:
        with self._lock:
            slot = self.slot_of.get(flow_id)
            if slot is None:
                if not self._free:
                    raise ValueError("flow rule capacity exceeded")
                slot = self._free.pop()
                self.slot_of[flow_id] = slot
            return slot

    def release_missing(self, live_flow_ids) -> List[int]:
        """Free slots whose flow_id is no longer present; returns them."""
        live = set(live_flow_ids)
        freed = []
        with self._lock:
            for fid in list(self.slot_of):
                if fid not in live:
                    slot = self.slot_of.pop(fid)
                    self._free.append(slot)
                    freed.append(slot)
            self.pending_clear.extend(freed)
        return freed

    def lookup(self, flow_id: int) -> int:
        """Slot for a flow_id, or -1 (-> NO_RULE verdict)."""
        return self.slot_of.get(flow_id, -1)


def build_rule_columns(
    config: EngineConfig,
    rules: List[ClusterFlowRule],
    index: Optional[RuleIndex] = None,
    ns_max_qps: float = 30_000.0,
    connected: Optional[Dict[str, int]] = None,
    degrade_rules: Optional[List[DegradeRule]] = None,
) -> tuple:
    """The reference's numpy builder: ``(columns dict, index)``, where the
    dict holds one numpy array per :class:`RuleTable` field (``None`` for
    the ``br_*`` fields when no degrade rules are given)."""
    degrade_rules = degrade_rules or []
    index = index or RuleIndex(config)
    index.release_missing(
        {r.flow_id for r in rules} | {d.flow_id for d in degrade_rules}
    )

    valid = np.zeros(config.max_flows, dtype=bool)
    count = np.zeros(config.max_flows, dtype=np.float32)
    mode = np.zeros(config.max_flows, dtype=np.int8)
    namespace_id = np.zeros(config.max_flows, dtype=np.int32)
    ns_max = np.full(config.max_namespaces, float(ns_max_qps), dtype=np.float32)
    ns_conn = np.ones(config.max_namespaces, dtype=np.int32)
    behavior = np.zeros(config.max_flows, dtype=np.int8)
    warning_token = np.zeros(config.max_flows, dtype=np.float32)
    max_token = np.zeros(config.max_flows, dtype=np.float32)
    slope = np.zeros(config.max_flows, dtype=np.float32)
    cold_count = np.zeros(config.max_flows, dtype=np.float32)
    max_queue_ms = np.zeros(config.max_flows, dtype=np.int32)
    br_strategy = np.full(config.max_flows, -1, dtype=np.int8)
    br_threshold = np.zeros(config.max_flows, dtype=np.float32)
    br_slow_rt = np.full(config.max_flows, NO_SLOW_RT_MS, dtype=np.int32)
    br_min_request = np.zeros(config.max_flows, dtype=np.int32)
    br_stat_ms = np.zeros(config.max_flows, dtype=np.int32)
    br_recovery_ms = np.zeros(config.max_flows, dtype=np.int32)
    # a pacing queue longer than the occupy ring can cover is clamped
    queue_cap_ms = (config.n_buckets - 1) * config.bucket_ms
    for rule in rules:
        slot = index.assign(rule.flow_id)
        ns = index.namespace_slot(rule.namespace)
        valid[slot] = True
        count[slot] = rule.count
        mode[slot] = int(rule.mode)
        namespace_id[slot] = ns
        beh = int(rule.control_behavior)
        behavior[slot] = beh
        if beh in (int(ControlBehavior.WARM_UP),
                   int(ControlBehavior.WARM_UP_RATE_LIMITER)):
            # WarmUpController.construct(): warningToken, maxToken, slope
            c = max(float(rule.count), 1e-6)
            cold = max(2, int(rule.cold_factor))
            period = max(1, int(rule.warm_up_period_sec))
            warn = int(period * c / (cold - 1))
            warning_token[slot] = warn
            max_token[slot] = int(warn + 2.0 * period * c / (1.0 + cold))
            slope[slot] = (cold - 1.0) / c / max(1, max_token[slot] - warn)
            cold_count[slot] = int(c) // cold
        if beh in (int(ControlBehavior.RATE_LIMITER),
                   int(ControlBehavior.WARM_UP_RATE_LIMITER)):
            max_queue_ms[slot] = min(
                int(rule.max_queueing_time_ms), queue_cap_ms
            )
    interval_ms = config.n_buckets * config.bucket_ms
    for d in degrade_rules:
        slot = index.assign(d.flow_id)
        if not valid[slot]:
            # breaker-only flow: only the breaker gates it
            valid[slot] = True
            count[slot] = UNLIMITED_COUNT
            mode[slot] = int(ThresholdMode.GLOBAL)
            namespace_id[slot] = index.namespace_slot(d.namespace)
        br_strategy[slot] = int(d.strategy)
        br_threshold[slot] = float(d.threshold)
        if int(d.strategy) == int(DegradeStrategy.SLOW_REQUEST_RATIO):
            br_slow_rt[slot] = max(0, int(d.slow_rt_ms))
        br_min_request[slot] = max(1, int(d.min_request_amount))
        br_stat_ms[slot] = int(
            np.clip(int(d.stat_interval_ms), config.bucket_ms, interval_ms)
        )
        br_recovery_ms[slot] = max(1, int(d.recovery_timeout_ms))
    for ns_name, n in (connected or {}).items():
        ns_conn[index.namespace_slot(ns_name)] = max(1, int(n))
    has_br = bool(degrade_rules)
    cols = dict(
        valid=valid, count=count, mode=mode, namespace_id=namespace_id,
        ns_max_qps=ns_max, ns_connected=ns_conn, behavior=behavior,
        warning_token=warning_token, max_token=max_token, slope=slope,
        cold_count=cold_count, max_queue_ms=max_queue_ms,
        br_strategy=br_strategy if has_br else None,
        br_threshold=br_threshold if has_br else None,
        br_slow_rt_ms=br_slow_rt if has_br else None,
        br_min_request=br_min_request if has_br else None,
        br_stat_ms=br_stat_ms if has_br else None,
        br_recovery_ms=br_recovery_ms if has_br else None,
    )
    return cols, index


def table_from_columns(cols: Dict[str, Optional[np.ndarray]],
                       device=None) -> RuleTable:
    """Numpy columns → :class:`RuleTable` on ``device`` (dtypes kept)."""
    return RuleTable(**{
        name: (None if cols.get(name) is None
               else torch.as_tensor(np.asarray(cols[name]), device=device))
        for name in RuleTable._fields
    })


def build_rule_table(
    config: EngineConfig,
    rules: List[ClusterFlowRule],
    index: Optional[RuleIndex] = None,
    ns_max_qps: float = 30_000.0,
    connected: Optional[Dict[str, int]] = None,
    degrade_rules: Optional[List[DegradeRule]] = None,
    device: DeviceLike = None,
) -> tuple:
    """Build/refresh the rule table on ``device`` (``cuda`` unless told
    otherwise). Returns ``(table, index)``. After a rebuild, call
    ``drain_pending_clear(index, state)``."""
    dev = resolve_device(device)
    cols, index = build_rule_columns(
        config, rules, index=index, ns_max_qps=ns_max_qps,
        connected=connected, degrade_rules=degrade_rules,
    )
    return table_from_columns(cols, device=dev), index


def encode_rule(rule: ClusterFlowRule) -> dict:
    """The wire/blob dict shape shared by snapshots and MOVE blobs. Shaping
    keys are emitted only when non-default, so pre-shaping payloads stay
    byte-identical for plain rules (and old decoders keep working)."""
    d = {
        "flow_id": int(rule.flow_id),
        "count": float(rule.count),
        "mode": int(rule.mode),
        "namespace": rule.namespace,
    }
    if int(rule.control_behavior) != 0:
        d["behavior"] = int(rule.control_behavior)
        d["warmupSec"] = int(rule.warm_up_period_sec)
        d["coldFactor"] = int(rule.cold_factor)
        d["maxQueueMs"] = int(rule.max_queueing_time_ms)
    return d


def decode_rule(d: dict) -> ClusterFlowRule:
    """Inverse of :func:`encode_rule`; tolerant of payloads written before
    the shaping fields existed."""
    return ClusterFlowRule(
        flow_id=int(d["flow_id"]),
        count=float(d["count"]),
        mode=ThresholdMode(int(d["mode"])),
        namespace=str(d["namespace"]),
        control_behavior=int(d.get("behavior", 0)),
        warm_up_period_sec=int(d.get("warmupSec", 10)),
        cold_factor=int(d.get("coldFactor", 3)),
        max_queueing_time_ms=int(d.get("maxQueueMs", 500)),
    )


def encode_degrade_rule(rule: DegradeRule) -> dict:
    """Wire/blob dict for a DegradeRule — shared by snapshots and MOVE
    blobs, same emit-only-non-default discipline as :func:`encode_rule`."""
    d = {
        "flow_id": int(rule.flow_id),
        "strategy": int(rule.strategy),
        "threshold": float(rule.threshold),
        "minRequest": int(rule.min_request_amount),
        "statMs": int(rule.stat_interval_ms),
        "recoveryMs": int(rule.recovery_timeout_ms),
        "namespace": rule.namespace,
    }
    if int(rule.strategy) == int(DegradeStrategy.SLOW_REQUEST_RATIO):
        d["slowRtMs"] = int(rule.slow_rt_ms)
    return d


def decode_degrade_rule(d: dict) -> DegradeRule:
    return DegradeRule(
        flow_id=int(d["flow_id"]),
        strategy=DegradeStrategy(int(d["strategy"])),
        threshold=float(d["threshold"]),
        slow_rt_ms=int(d.get("slowRtMs", 1000)),
        min_request_amount=int(d.get("minRequest", 5)),
        stat_interval_ms=int(d.get("statMs", 1000)),
        recovery_timeout_ms=int(d.get("recoveryMs", 5000)),
        namespace=str(d.get("namespace", "default")),
    )


def drain_pending_clear(index: RuleIndex, state):
    """Zero the history of slots freed by rule reloads, in place; returns
    the same state. Idempotent; call after every ``build_rule_table``."""
    with index._lock:
        slots, index.pending_clear = index.pending_clear, []
    if not slots:
        return state
    idx = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                          device=state.flow.counts.device)
    state.flow.counts[idx] = 0
    state.occupy.counts[idx] = 0
    # a reused slot starts cold: pacing unset, warmup bucket full on sync
    state.shaping.lpt[idx] = NEVER
    state.shaping.warm_tokens[idx] = 0.0
    state.shaping.warm_filled[idx] = NEVER
    state.outcome.counts[idx] = 0
    state.breaker.state[idx] = 0
    state.breaker.opened_ms[idx] = NEVER
    state.breaker.probe_ms[idx] = NEVER
    return state
