"""The token service (port of ``sentinel_tpu/cluster/token_service.py``).

``DefaultTokenService`` owns the device state and rule table and the host's
``flow_id → slot`` index, and serializes device steps with a lock. The
serving path is the reference's:

- host prep outside the lock: slot lookup, a stable sort that groups
  same-flow requests (memoized by :class:`_PrepCache`), padding to the
  smallest serve bucket (64 / 256 / 1024 / … / ``batch_size``);
- the device step under the lock: ``decide_donating`` (the CUDA kernel on a
  card), or ``decide_fused_donating`` for runs of full frames of an
  oversized pull (greedy largest-fit over the fuse ladder, e.g. 8 / 4 / 2);
- verdict materialization outside the lock, back in request order; a pull
  that answered DEGRADED scans the breaker column for transitions.

Also ported: the hot-param path (``load_param_rules``,
``request_params_token``: the CUDA CMS or SALSA kernel on a card, the
torch-ops core with ``ParamConfig(impl="jax")``); rule management with
namespaces and degrade (circuit-breaker) rules; completion reports
(``report_outcomes``, the outcome step on the service's device) and their
reads (``outcome_stats``, ``breaker_stats``, ``metrics_snapshot``); token
leases (the LEASED column); cluster concurrency (host-only,
:mod:`cluster.concurrent`); and the HA snapshot (``export_state`` /
``import_state``, the reference's dict layout, so either package restores
the other's capture).

Later slices: replication deltas, namespace export/import and MOVE (the
MOVING set is always empty here), the hierarchy tier, push, and the host
metric and trace planes. Where the reference feeds those, the code below
leaves a comment marked ``seam``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch import interop
from sentinel_tpu_torch._device import DeviceLike, resolve_device
from sentinel_tpu_torch.cluster.concurrent import (
    ConcurrencyManager,
    ExpiryTask,
)
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.engine.config import EngineConfig
from sentinel_tpu_torch.engine.decide import (
    TokenStatus,
    decide_donating,
    decide_fused_donating,
    make_batch,
    make_batch_into,
    alloc_fused_batch,
)
from sentinel_tpu_torch.engine.param import (
    NEVER as PARAM_NEVER,
    ParamConfig,
    hash_indices,
    make_param_state,
    param_decide,
)
from sentinel_tpu_torch.engine.outcome import outcome_step_donating
from sentinel_tpu_torch.engine.rules import (
    ClusterFlowRule,
    DegradeRule,
    ThresholdMode,
    build_rule_table,
    drain_pending_clear,
)
from sentinel_tpu_torch.engine.state import (
    N_CLUSTER_EVENTS,
    N_RT_BUCKETS,
    RT_BUCKET_UPPER_MS,
    BreakerState,
    ClusterEvent,
    OutcomeChannel,
    ShapingState,
    flow_spec,
    make_state,
)
from sentinel_tpu_torch.stats import window as W
from sentinel_tpu_torch.stats.window import NEVER, rebase

# The wire's ceiling on a reported RT (the reference's
# ``protocol.OUTCOME_MAX_RT_MS``): a larger report would poison the window's
# RT sum and is dropped as ``too_large``.
OUTCOME_MAX_RT_MS = 60_000


class _PrepCache:
    """Bounded LRU memo of the host-side batch prep (slot lookup, grouping
    argsort, padded batch), keyed by the exact request-vector bytes and the
    lookup snapshot identity; hits are verified by content."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._map: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, snap_keys, cap: int, flow_ids, acq, pr):
        key = (
            id(snap_keys), cap, hash(flow_ids.tobytes()),
            hash(acq.tobytes()), hash(pr.tobytes()),
        )
        with self._lock:
            hit = self._map.get(key)
            if hit is not None:
                self._map.move_to_end(key)
        if hit is not None:
            c_ids, c_acq, c_pr, slots, order, batch = hit
            if (
                np.array_equal(c_ids, flow_ids)
                and np.array_equal(c_acq, acq)
                and np.array_equal(c_pr, pr)
            ):
                return key, (slots, order, batch)
        return key, None

    def put(self, key, flow_ids, acq, pr, slots, order, batch) -> None:
        entry = (
            np.array(flow_ids), np.array(acq), np.array(pr),
            slots, order, batch,
        )
        with self._lock:
            self._map[key] = entry
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)


@dataclass(frozen=True)
class ClusterParamFlowRule:
    """Cluster hot-param rule (``ParamFlowRule`` + ``ClusterFlowConfig``):
    a per-value QPS threshold, with per-item overrides keyed by the value's
    stable 64-bit hash (the ``ParamFlowItem`` analog)."""

    flow_id: int
    count: float
    item_thresholds: Optional[Tuple[Tuple[int, float], ...]] = None
    namespace: str = "default"


@dataclass(frozen=True)
class TokenResult:
    """``TokenResult.java``: status, remaining and wait hint, plus the token
    id in concurrent mode and, for MOVED, the new owner's endpoint."""

    status: TokenStatus
    remaining: int = 0
    wait_ms: int = 0
    token_id: int = 0
    endpoint: str = ""

    @property
    def ok(self) -> bool:
        # RELEASE_OK is the success status of a concurrent release
        return self.status in (TokenStatus.OK, TokenStatus.RELEASE_OK)

    @property
    def retry_after_ms(self) -> int:
        """DEGRADED only: ms until the flow's breaker admits a recovery
        probe (``remaining`` carries it on the wire). 0 otherwise."""
        return (
            int(self.remaining)
            if self.status == TokenStatus.DEGRADED else 0
        )


class TokenService:
    """The SPI: local flow checkers and the transport both speak this."""

    def request_token(
        self, flow_id: int, acquire: int = 1, prioritized: bool = False
    ) -> TokenResult:
        raise NotImplementedError

    def request_params_token(
        self, flow_id: int, acquire: int, param_hashes: Sequence[int]
    ) -> TokenResult:
        raise NotImplementedError

    def request_batch(
        self, requests: Sequence[Tuple[int, int, bool]]
    ) -> List[TokenResult]:
        """Vectorized form: a list of (flow_id, acquire, prioritized)."""
        return [self.request_token(f, a, p) for f, a, p in requests]

    def request_batch_arrays(self, flow_ids, acquires=None, prios=None):
        """Array form: (status int8[N], remaining int32[N], wait_ms
        int32[N]) in request order, by way of ``request_batch``."""
        n = len(flow_ids)
        results = self.request_batch([
            (
                int(flow_ids[i]),
                1 if acquires is None else int(acquires[i]),
                False if prios is None else bool(prios[i]),
            )
            for i in range(n)
        ])
        status = np.fromiter((int(r.status) for r in results), np.int8, n)
        remaining = np.fromiter((r.remaining for r in results), np.int32, n)
        wait = np.fromiter((r.wait_ms for r in results), np.int32, n)
        return status, remaining, wait

    def request_concurrent_token(
        self, flow_id: int, acquire: int = 1, prioritized: bool = False
    ) -> TokenResult:
        """Cluster-semaphore acquire (``ConcurrentClusterFlowChecker``)."""
        raise NotImplementedError

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        raise NotImplementedError


@dataclass(frozen=True)
class LeaseResult:
    """Outcome of a lease operation (grant / renew / return).

    OK carries a live lease (``lease_id`` / ``tokens`` / ``ttl_ms``);
    NOT_LEASABLE means admit per request instead (no headroom, a shaped or
    breaker-guarded flow, or leasing disabled); NO_RULE_EXISTS and MOVED
    mean what they mean on the decision path."""

    status: int
    lease_id: int = 0
    tokens: int = 0
    ttl_ms: int = 0
    endpoint: str = ""

    @property
    def ok(self) -> bool:
        return int(self.status) == int(TokenStatus.OK)


class _Lease:
    """One outstanding lease: a host registry entry only. The token charge
    lives in the flow window's LEASED column; the registry lets renew and
    return credit unused tokens back and bounds crash over-admission by
    ``outstanding_leases()``. Not part of snapshots: a restored service
    starts with an empty registry, and the charge keeps the limit
    conservative."""

    __slots__ = ("lease_id", "flow_id", "slot", "tokens", "granted_ms",
                 "expiry_ms")

    def __init__(self, lease_id, flow_id, slot, tokens, granted_ms,
                 expiry_ms):
        self.lease_id = int(lease_id)
        self.flow_id = int(flow_id)
        self.slot = int(slot)
        self.tokens = int(tokens)
        self.granted_ms = int(granted_ms)
        self.expiry_ms = int(expiry_ms)


class DefaultTokenService(TokenService):
    """Engine-backed token service.

    ``device`` defaults to ``cuda``; the tests pass ``device="cpu"``. The
    step updates the state tensors in place (the port of the reference's
    buffer donation); the lock makes the service the state's only user.
    """

    # int32 engine-ms wraps after ~24.8 days; re-base well before that
    _REBASE_AFTER_MS = 2**30

    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        param_config: Optional[ParamConfig] = None,
        device: DeviceLike = None,
        serve_buckets: Optional[Sequence[int]] = None,
        fuse_depths: Optional[Sequence[int]] = (8, 4, 2),
        lease_ttl_ms: int = 500,
        lease_fraction: float = 0.5,
    ):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        if serve_buckets is None:
            buckets = set()
            b = 64
            while b < self.config.batch_size:
                buckets.add(b)
                b *= 4
            buckets.add(self.config.batch_size)
        else:
            buckets = {
                min(int(b), self.config.batch_size) for b in serve_buckets
            }
            buckets.add(self.config.batch_size)
        self._serve_buckets = sorted(buckets)
        self._fuse_depths = tuple(sorted(
            {int(d) for d in (fuse_depths or ()) if int(d) >= 2},
            reverse=True,
        ))
        self._steps: Dict[Tuple[int, bool], object] = {}
        self._fused_steps: Dict[Tuple[int, bool], object] = {}
        self._prep_cache = _PrepCache()
        self._lock = threading.Lock()
        self._state = make_state(self.config, device=self.device)
        self._table, self._index = build_rule_table(
            self.config, [], device=self.device
        )
        self._lookup = (np.empty(0, np.int64), np.empty(0, np.int32))
        # slot → namespace row (names, int32[max_flows], -1 = no rule), for
        # the per-namespace verdict and outcome counters of the metric plane
        self._ns_snapshot: Tuple[Tuple[str, ...], np.ndarray] = (
            (), np.full(self.config.max_flows, -1, np.int32),
        )
        self._epoch_ms: Optional[int] = None
        self._connected: Dict[str, int] = {}
        self._ns_max_qps = 30_000.0
        # outer mutex for rule read-modify-write sequences (a namespace
        # replacement merges the current rules, then loads); reentrant
        self._rules_mutex = threading.RLock()
        self._rules_by_ns: Dict[str, Dict[int, ClusterFlowRule]] = {}
        self._rule_of: Dict[int, ClusterFlowRule] = {}
        # circuit breakers: the source rules (compiled into the br_*
        # columns on every load_rules), the slots that carry one, and the
        # host mirror of the breaker state column the transition scan diffs
        self._degrade_rules_src: Dict[int, DegradeRule] = {}
        self._has_breakers = False
        self._breaker_slots: set = set()
        self._breaker_prev: Optional[np.ndarray] = None
        self._breaker_scan_ts = 0.0
        # namespaces served explicitly, unioned with those of loaded rules
        self.namespace_set: set = set()
        # MOVE's namespace → (endpoint, epoch); a later slice fills it
        self._moving: Dict[str, Tuple[str, int]] = {}
        # concurrent (semaphore) mode, host-side by design
        self.concurrency = ConcurrencyManager()
        self._expiry: Optional[ExpiryTask] = None
        # token leases: a grant charges its slice into the LEASED column at
        # once; lease_fraction caps a grant at that share of the current
        # headroom (<= 0 disables leasing), lease_ttl_ms bounds a crashed
        # client's admitted-but-unreported slice
        self.lease_ttl_ms = max(1, int(lease_ttl_ms))
        self.lease_fraction = float(lease_fraction)
        self._leases: Dict[int, _Lease] = {}
        self._lease_seq = itertools.count(1)
        self._lease_stats = {
            "granted": 0, "renewed": 0, "returned": 0, "revoked": 0,
        }
        # completion reports: the in-place outcome step (built on the first
        # report) and the ingest counters, mutated under self._lock
        self._outcome_step = None
        self._outcome_counts: Dict[str, object] = {
            "reported": 0, "exceptions": 0, "rt_sum_ms": 0, "batches": 0,
            "dropped": {},  # reason -> rows
        }
        # hot-param sketch path (ClusterParamFlowChecker analog)
        self.param_config = param_config or ParamConfig()
        self._param_state = make_param_state(self.param_config,
                                             device=self.device)
        self._param_rules: Dict[int, Tuple[int, float, Dict[int, float]]] = {}
        self._param_free = list(
            range(self.param_config.max_param_rules - 1, -1, -1)
        )
        self._param_rules_src: Dict[int, ClusterParamFlowRule] = {}

    @staticmethod
    def _prep_batch(cfg, slots, acq, pr):
        """``(order, batch)``; order is None when slots arrived sorted."""
        sorted_already = bool((slots[:-1] <= slots[1:]).all())
        if sorted_already:
            return None, make_batch(cfg, slots, acq, pr)
        order = np.argsort(slots, kind="stable")
        return order, make_batch(cfg, slots[order], acq[order], pr[order])

    def _step_fn(self, bucket: int, uniform: bool):
        """The in-place device step for one (shape bucket, uniform)
        variant, cached per variant."""
        key = (bucket, uniform)
        step = self._steps.get(key)
        if step is None:
            cfg = self.config._replace(batch_size=bucket)
            step = self._steps[key] = decide_donating(
                cfg, grouped=True, uniform=uniform
            )
        return step

    def _fused_step_fn(self, depth: int, uniform: bool):
        """The chained ``depth``-frame step (full ``batch_size`` frames)."""
        key = (depth, uniform)
        step = self._fused_steps.get(key)
        if step is None:
            step = self._fused_steps[key] = decide_fused_donating(
                self.config, depth, grouped=True, uniform=uniform
            )
        return step

    def _prep_cached(self, lookup_snap, cfg, bucket, flow_ids, acq, pr):
        key, hit = self._prep_cache.get(
            lookup_snap[0], bucket, flow_ids, acq, pr
        )
        if hit is not None:
            return hit
        slots = self._lookup_from(lookup_snap, flow_ids)
        order, batch = self._prep_batch(cfg, slots, acq, pr)
        self._prep_cache.put(key, flow_ids, acq, pr, slots, order, batch)
        return slots, order, batch

    # -- rule management (ClusterFlowRuleManager analog) --------------------
    def load_rules(
        self,
        rules: List[ClusterFlowRule],
        ns_max_qps: Optional[float] = None,
        connected: Optional[Dict[str, int]] = None,
    ) -> None:
        with self._rules_mutex, self._lock:
            if ns_max_qps is not None:
                self._ns_max_qps = ns_max_qps
            if connected is not None:
                self._connected.update(connected)
            by_ns: Dict[str, Dict[int, ClusterFlowRule]] = {}
            for r in rules:
                by_ns.setdefault(r.namespace, {})[r.flow_id] = r
            self._rules_by_ns = by_ns
            self._rule_of = {r.flow_id: r for r in rules}
            degrade = list(self._degrade_rules_src.values())
            self._table, self._index = build_rule_table(
                self.config, rules, index=self._index,
                ns_max_qps=self._ns_max_qps, connected=self._connected,
                degrade_rules=degrade, device=self.device,
            )
            # slots may have moved, so the transition mirror starts afresh
            self._has_breakers = bool(degrade)
            self._breaker_slots = {
                self._index.slot_of[d.flow_id] for d in degrade
                if d.flow_id in self._index.slot_of
            }
            self._breaker_prev = None
            # slots freed by the reload are zeroed before reuse
            drain_pending_clear(self._index, self._state)
            items = sorted(self._index.slot_of.items())
            self._lookup = (
                np.fromiter((k for k, _ in items), np.int64, len(items)),
                np.fromiter((v for _, v in items), np.int32, len(items)),
            )
            n_ns = max(self._index.ns_of.values(), default=-1) + 1
            ns_names = [""] * n_ns
            for ns_name, row in self._index.ns_of.items():
                ns_names[row] = ns_name
            slot_ns = np.full(self.config.max_flows, -1, np.int32)
            for r in rules:
                slot_ns[self._index.slot_of[r.flow_id]] = (
                    self._index.ns_of[r.namespace]
                )
            self._ns_snapshot = (tuple(ns_names), slot_ns)
            # leases pin flow_id → slot: re-resolve them, and revoke those
            # whose rule is gone (their LEASED charge expires with the
            # window, the conservative direction)
            dead = [lease for lease in self._leases.values()
                    if lease.flow_id not in self._index.slot_of]
            for lease in self._leases.values():
                lease.slot = self._index.slot_of.get(lease.flow_id,
                                                     lease.slot)
            for lease in dead:
                del self._leases[lease.lease_id]
            self._lease_stats["revoked"] += len(dead)
        # seam: the push plane recalls the dead leases and announces the
        # new rule epoch here

    def load_namespace_rules(
        self, namespace: str, rules: List[ClusterFlowRule]
    ) -> None:
        """Replace ONE namespace's flow rules, keeping every other
        namespace's (``ClusterFlowRuleManager.loadRules(namespace,
        rules)``)."""
        fixed = [
            r if r.namespace == namespace
            else dataclasses.replace(r, namespace=namespace)
            for r in rules
        ]
        with self._rules_mutex:
            with self._lock:
                merged = {
                    ns: dict(m) for ns, m in self._rules_by_ns.items()
                    if ns != namespace
                }
                if fixed:
                    merged[namespace] = {r.flow_id: r for r in fixed}
                flat = [r for m in merged.values() for r in m.values()]
            self.load_rules(flat)

    def current_rules(
        self, namespace: Optional[str] = None
    ) -> List[ClusterFlowRule]:
        with self._lock:
            if namespace is not None:
                return list(self._rules_by_ns.get(namespace, {}).values())
            return [
                r for m in self._rules_by_ns.values() for r in m.values()
            ]

    # -- degrade (circuit-breaker) rules (DegradeRuleManager analog) --------
    def load_degrade_rules(self, rules: List[DegradeRule]) -> None:
        """Replace the whole degrade-rule set. The rules compile into the
        ``br_*`` columns beside the flow rules; a breaker-only flow gets an
        unlimited slot so the gate still sees it. Breaker state survives
        for flows whose rule persists (slots are sticky). A removed
        breaker-only flow frees its slot, which ``drain_pending_clear``
        resets; a flow that keeps its flow rule keeps its breaker columns,
        unread until a degrade rule names it again (the reference's
        behaviour)."""
        with self._rules_mutex:
            with self._lock:
                self._degrade_rules_src = {r.flow_id: r for r in rules}
            self.load_rules(self.current_rules())

    def load_namespace_degrade_rules(
        self, namespace: str, rules: List[DegradeRule]
    ) -> None:
        """Replace ONE namespace's degrade rules, keeping the others."""
        fixed = [
            r if r.namespace == namespace
            else dataclasses.replace(r, namespace=namespace)
            for r in rules
        ]
        with self._rules_mutex:
            with self._lock:
                keep = [
                    r for r in self._degrade_rules_src.values()
                    if r.namespace != namespace
                ]
            self.load_degrade_rules(keep + fixed)

    def current_degrade_rules(
        self, namespace: Optional[str] = None
    ) -> List[DegradeRule]:
        with self._lock:
            rules = list(self._degrade_rules_src.values())
        if namespace is not None:
            rules = [r for r in rules if r.namespace == namespace]
        return rules

    def served_namespaces(self) -> List[str]:
        """Explicit namespace set ∪ namespaces with loaded rules."""
        with self._lock:
            return sorted(self.namespace_set | set(self._rules_by_ns))

    def set_max_allowed_qps(self, qps: float) -> None:
        """``ServerFlowConfig.maxAllowedQps`` update: rebuilds the
        namespace guard's row of the rule table."""
        with self._rules_mutex:
            self.load_rules(self.current_rules(), ns_max_qps=float(qps))

    def config_snapshot(self) -> Dict[str, object]:
        """Flow-config view (the cluster/server/fetchConfig shape)."""
        spec = flow_spec(self.config)
        return {
            "exceedCount": self.config.exceed_count,
            "maxOccupyRatio": self.config.max_occupy_ratio,
            "intervalMs": spec.interval_ms,
            "sampleCount": self.config.n_buckets,
            "maxAllowedQps": self._ns_max_qps,
            "maxFlows": self.config.max_flows,
            "batchSize": self.config.batch_size,
            "namespaceSet": self.served_namespaces(),
        }

    def connected_count_changed(self, namespace: str, n: int) -> None:
        """``ConnectionManager`` callback: AVG_LOCAL thresholds scale with
        it. Counts persist across reloads; a namespace no rule uses is
        remembered host-side and applied on the next load."""
        self.concurrency.set_connected_count(max(1, int(n)), namespace)
        with self._lock:
            self._connected[namespace] = max(1, int(n))
            ns = self._index.ns_of.get(namespace)
            if ns is None:
                return
            conn = self._table.ns_connected.clone()
            conn[ns] = max(1, int(n))
            self._table = self._table._replace(ns_connected=conn)

    # -- time ---------------------------------------------------------------
    def _engine_now(self) -> int:
        """Engine-relative int32 ms; re-bases the epoch (and shifts every
        engine-ms column in place) long before int32 wraparound. Callers
        hold ``self._lock``."""
        wall = _clock.now_ms()
        if self._epoch_ms is None:
            self._epoch_ms = wall - 1  # keep engine time strictly positive
        now = wall - self._epoch_ms
        if now > self._REBASE_AFTER_MS:
            delta = now - 60_000  # keep the last minute addressable
            st = self._state
            for ws in (st.flow, st.occupy, st.ns, st.outcome):
                rebase(ws, delta)
            for col in (st.shaping.lpt, st.shaping.warm_filled,
                        st.breaker.opened_ms, st.breaker.probe_ms):
                col.copy_(torch.where(col == NEVER, col, col - delta))
            # the param sketch's starts are engine-ms too
            pst = self._param_state.starts
            pst.copy_(torch.where(pst == PARAM_NEVER, pst, pst - delta))
            self._epoch_ms += delta
            now -= delta
        return now

    # -- decision path ------------------------------------------------------
    def warmup(self) -> None:
        """Run every serving variant once on a throwaway state, so the first
        real request pays no kernel build or allocator growth."""
        with self._lock:
            now = self._engine_now()
            ws = make_state(self.config, device=self.device)
            for bucket in self._serve_buckets:
                cfg = self.config._replace(batch_size=bucket)
                batch = make_batch(cfg, [-1])
                for uniform in (True, False):
                    ws, _ = self._step_fn(bucket, uniform)(
                        ws, self._table, batch, now
                    )
            base = make_batch(self.config, [-1])
            for fdepth in self._fuse_depths:
                stacked = type(base)(
                    *(np.stack([leaf] * fdepth) for leaf in base)
                )
                ws, _ = self._fused_step_fn(fdepth, True)(
                    ws, self._table, stacked, now
                )
            # the param step at request_params_token's smallest padded
            # shape, on a throwaway sketch (nothing valid)
            pc = self.param_config
            n_pad = 8
            idx = hash_indices(np.zeros(1, np.int64), pc.depth,
                               pc.cell_width)
            idx_slim = None
            if pc.slim_enabled:
                from sentinel_tpu_torch.sketch.slim import slim_indices

                si = slim_indices(pc, np.zeros(1, np.int64))
                idx_slim = self._dev(np.broadcast_to(si, (n_pad, si.shape[1])))
            dev = self.device
            param_decide(
                pc,
                make_param_state(pc, device=dev),
                torch.zeros((n_pad,), dtype=torch.int32, device=dev),
                self._dev(np.broadcast_to(idx, (n_pad, idx.shape[1]))),
                torch.zeros((n_pad,), dtype=torch.int32, device=dev),
                torch.zeros((n_pad,), dtype=torch.float32, device=dev),
                torch.zeros((n_pad,), dtype=torch.bool, device=dev),
                now,
                idx_slim=idx_slim,
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def request_token(self, flow_id, acquire=1, prioritized=False) -> TokenResult:
        return self.request_batch([(flow_id, acquire, prioritized)])[0]

    def lookup_slots(self, flow_ids: np.ndarray) -> np.ndarray:
        """Vectorized flow_id → slot (-1 when no rule); lock-free."""
        return self._lookup_from(self._lookup, flow_ids)

    @staticmethod
    def _lookup_from(snapshot, flow_ids: np.ndarray) -> np.ndarray:
        keys, slots = snapshot
        if keys.size == 0:
            return np.full(flow_ids.shape, -1, np.int32)
        pos = np.searchsorted(keys, flow_ids)
        pos = np.minimum(pos, keys.size - 1)
        return np.where(keys[pos] == flow_ids, slots[pos], -1).astype(np.int32)

    def request_batch_arrays(
        self,
        flow_ids: np.ndarray,
        acquires: Optional[np.ndarray] = None,
        prios: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(status int8[N], remaining int32[N], wait_ms int32[N]) in request
        order: dispatch + materialize in one call."""
        return self.dispatch_batch_arrays(flow_ids, acquires, prios)()

    def dispatch_batch_arrays(
        self,
        flow_ids: np.ndarray,
        acquires: Optional[np.ndarray] = None,
        prios: Optional[np.ndarray] = None,
    ):
        """Serving hot path, phase 1: host prep + device step. Returns a
        zero-arg materializer yielding ``(status, remaining, wait)`` in
        request order. The lock covers only the device step; the CUDA
        launches are asynchronous, so a caller may dispatch the next batch
        before materializing this one."""
        flow_ids = np.asarray(flow_ids, np.int64)
        n = flow_ids.shape[0]
        if n == 0:
            def _empty():
                empty32 = np.empty(0, np.int32)
                return np.empty(0, np.int8), empty32, empty32

            return _empty
        acq = (
            np.ones(n, np.int32) if acquires is None
            else np.asarray(acquires, np.int32)
        )
        pr = np.zeros(n, bool) if prios is None else np.asarray(prios, bool)
        cap = self.config.batch_size
        if n > cap:
            return self._dispatch_oversized(flow_ids, acq, pr, n, cap)
        # -- host prep, outside the lock --
        lookup_snap = self._lookup
        uniform = bool(acq.min() == acq.max())
        bucket = next(b for b in self._serve_buckets if n <= b)
        cfg = self.config._replace(batch_size=bucket)
        slots, order, batch = self._prep_cached(
            lookup_snap, cfg, bucket, flow_ids, acq, pr
        )
        step = self._step_fn(bucket, uniform)
        # -- device step: the only serialized section --
        with self._lock:
            if self._lookup is not lookup_snap:
                # rules reloaded between prep and step: redo the prep
                slots = self._lookup_from(self._lookup, flow_ids)
                order, batch = self._prep_batch(cfg, slots, acq, pr)
            now = self._engine_now()
            self._state, verdicts = step(
                self._state, self._table, batch, now
            )

        def _materialize():
            status_sorted = verdicts.status[:n].cpu().numpy()
            remaining_sorted = verdicts.remaining[:n].cpu().numpy()
            wait_sorted = verdicts.wait_ms[:n].cpu().numpy()
            if order is None:
                status = np.array(status_sorted)
                self._scan_if_degraded(status)
                return (status, np.array(remaining_sorted, np.int32),
                        np.array(wait_sorted, np.int32))
            status = np.empty(n, status_sorted.dtype)
            remaining = np.empty(n, np.int32)
            wait = np.empty(n, np.int32)
            status[order] = status_sorted
            remaining[order] = remaining_sorted
            wait[order] = wait_sorted
            self._scan_if_degraded(status)
            return status, remaining, wait

        return _materialize

    def _dispatch_oversized(self, flow_ids, acq, pr, n, cap):
        """Split an oversized burst into ``cap``-sized frames; runs of full
        frames fold into fused chained steps (greedy largest-fit over the
        fuse ladder), the rest take the per-chunk path. Every dispatch is
        issued before any chunk materializes."""
        mats = []
        pos = 0
        ladder = self._fuse_depths
        while ladder and (n - pos) // cap >= ladder[-1]:
            depth = next(
                (d for d in ladder if d <= (n - pos) // cap), None
            )
            if depth is None:
                break
            end = pos + depth * cap
            mats.append(
                self._dispatch_fused(
                    flow_ids[pos:end], acq[pos:end], pr[pos:end], depth, cap
                )
            )
            pos = end
        for i in range(pos, n, cap):
            mats.append(
                self.dispatch_batch_arrays(
                    flow_ids[i : i + cap], acq[i : i + cap], pr[i : i + cap]
                )
            )

        def _concat():
            parts = [m() for m in mats]
            return tuple(np.concatenate(ps) for ps in zip(*parts))

        return _concat

    def _dispatch_fused(self, flow_ids, acq, pr, depth, cap):
        """``depth`` consecutive full frames as one chained step at one
        shared ``now``; returns a request-order materializer."""
        lookup_snap = self._lookup
        uniform = bool(acq.min() == acq.max())
        cfg = self.config
        block = alloc_fused_batch(cfg, depth)
        preps = []
        for f in range(depth):
            sl = slice(f * cap, (f + 1) * cap)
            prep = self._prep_cached(
                lookup_snap, cfg, cap, flow_ids[sl], acq[sl], pr[sl]
            )
            preps.append(prep)
            b = prep[2]
            block.flow_slot[f] = b.flow_slot
            block.acquire[f] = b.acquire
            block.prioritized[f] = b.prioritized
            block.valid[f] = b.valid
        step = self._fused_step_fn(depth, uniform)
        with self._lock:
            if self._lookup is not lookup_snap:
                preps = []
                for f in range(depth):
                    sl = slice(f * cap, (f + 1) * cap)
                    slots_f = self._lookup_from(self._lookup, flow_ids[sl])
                    if bool((slots_f[:-1] <= slots_f[1:]).all()):
                        order_f = None
                        make_batch_into(block, f, slots_f, acq[sl], pr[sl])
                    else:
                        order_f = np.argsort(slots_f, kind="stable")
                        make_batch_into(
                            block, f, slots_f[order_f], acq[sl][order_f],
                            pr[sl][order_f],
                        )
                    preps.append((slots_f, order_f, None))
            now = self._engine_now()
            self._state, verdicts = step(
                self._state, self._table, block, now
            )

        def _materialize():
            status_all = verdicts.status.cpu().numpy()
            remaining_all = verdicts.remaining.cpu().numpy()
            wait_all = verdicts.wait_ms.cpu().numpy()
            total = depth * cap
            status = np.empty(total, status_all.dtype)
            remaining = np.empty(total, np.int32)
            wait = np.empty(total, np.int32)
            for f, (_slots_f, order_f, _b) in enumerate(preps):
                dst = slice(f * cap, (f + 1) * cap)
                if order_f is None:
                    status[dst] = status_all[f]
                    remaining[dst] = remaining_all[f]
                    wait[dst] = wait_all[f]
                else:
                    status[dst][order_f] = status_all[f]
                    remaining[dst][order_f] = remaining_all[f]
                    wait[dst][order_f] = wait_all[f]
            self._scan_if_degraded(status)
            return status, remaining, wait

        return _materialize

    def _scan_if_degraded(self, status: np.ndarray) -> None:
        """A materialized pull that answered DEGRADED saw breaker activity:
        fold the device's transitions into the host mirror (rate-limited)."""
        if (status == int(TokenStatus.DEGRADED)).any():
            self._breaker_scan()

    def request_batch(self, requests) -> List[TokenResult]:
        if not requests:
            return []
        n = len(requests)
        flow_ids = np.fromiter((f for f, _, _ in requests), np.int64, n)
        acquires = np.fromiter((a for _, a, _ in requests), np.int32, n)
        prios = np.fromiter((p for _, _, p in requests), bool, n)
        status, remaining, wait = self.request_batch_arrays(
            flow_ids, acquires, prios
        )
        return [
            TokenResult(TokenStatus(int(status[i])), int(remaining[i]),
                        int(wait[i]))
            for i in range(n)
        ]

    # -- hot-param path -------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def load_param_rules(self, rules: List[ClusterParamFlowRule]) -> None:
        """``ClusterParamFlowRuleManager`` analog: slots stay stable across
        reloads, and a freed slot's sketch row is cleared."""
        with self._rules_mutex, self._lock:
            live = {r.flow_id for r in rules}
            # check capacity before mutating, so a failed load leaves the
            # rule set as it was
            n_new = len({r.flow_id for r in rules
                         if r.flow_id not in self._param_rules})
            n_freed = sum(1 for fid in self._param_rules if fid not in live)
            if n_new > len(self._param_free) + n_freed:
                raise ValueError(
                    f"param rule capacity exceeded: need {n_new} new slots, "
                    f"have {len(self._param_free) + n_freed}"
                )
            st = self._param_state
            for fid in list(self._param_rules):
                if fid not in live:
                    slot, _, _ = self._param_rules.pop(fid)
                    self._param_free.append(slot)
                    # the whole row: fat cells (zeroed SALSA cells are
                    # unmerged), the slim twin row and the merge counter
                    st.counts[slot].zero_()
                    st.slim[slot].zero_()
                    st.merges[slot] = 0
            for rule in rules:
                existing = self._param_rules.get(rule.flow_id)
                slot = existing[0] if existing else None
                if slot is None:
                    if not self._param_free:
                        raise ValueError("param rule capacity exceeded")
                    slot = self._param_free.pop()
                items = dict(rule.item_thresholds or ())
                self._param_rules[rule.flow_id] = (slot, rule.count, items)
            self._param_rules_src = {r.flow_id: r for r in rules}

    def load_namespace_param_rules(
        self, namespace: str, rules: List[ClusterParamFlowRule]
    ) -> None:
        """Replace one namespace's param rules, keeping the others."""
        fixed = [
            r if r.namespace == namespace
            else ClusterParamFlowRule(r.flow_id, r.count, r.item_thresholds,
                                      namespace)
            for r in rules
        ]
        with self._rules_mutex:
            with self._lock:
                keep = [
                    r for r in self._param_rules_src.values()
                    if r.namespace != namespace
                ]
            self.load_param_rules(keep + fixed)

    def current_param_rules(
        self, namespace: Optional[str] = None
    ) -> List[ClusterParamFlowRule]:
        with self._lock:
            rules = list(self._param_rules_src.values())
        if namespace is not None:
            rules = [r for r in rules if r.namespace == namespace]
        return rules

    def request_params_token(self, flow_id, acquire,
                             param_hashes) -> TokenResult:
        """Windowed-sketch per-value admission. All values of the request
        are judged together and any blocked value blocks it (reference
        ``ClusterParamFlowChecker``); the admitted values' counts stand on
        a mixed verdict (a conservative overcount)."""
        if not param_hashes:
            return TokenResult(TokenStatus.OK)
        pc = self.param_config
        with self._lock:
            entry = self._param_rules.get(int(flow_id))
            if entry is None:
                return TokenResult(TokenStatus.NO_RULE_EXISTS)
            slot, count, items = entry
            hashes = np.asarray(list(param_hashes), dtype=np.int64)
            idx = hash_indices(hashes, pc.depth, pc.cell_width)
            n = hashes.shape[0]
            # pad to a power of two >= 8, the reference's compiled shapes
            n_pad = max(8, 1 << (n - 1).bit_length())
            pad = n_pad - n
            idx = np.pad(idx, ((0, pad), (0, 0)))
            idx_slim = None
            if pc.slim_enabled:
                from sentinel_tpu_torch.sketch.slim import slim_indices

                idx_slim = self._dev(np.pad(slim_indices(pc, hashes),
                                            ((0, pad), (0, 0))))
            thresholds = np.array(
                [items.get(int(h), count) for h in hashes], dtype=np.float32
            )
            thresholds = np.pad(thresholds, (0, pad))
            valid = np.zeros(n_pad, dtype=bool)
            valid[:n] = True
            now = self._engine_now()
            dev = self.device
            _, admit, _est = param_decide(
                pc,
                self._param_state,
                torch.full((n_pad,), slot, dtype=torch.int32, device=dev),
                self._dev(idx),
                torch.full((n_pad,), int(acquire), dtype=torch.int32,
                           device=dev),
                self._dev(thresholds),
                self._dev(valid),
                now,
                idx_slim=idx_slim,
            )
        if bool(admit[:n].all()):
            return TokenResult(TokenStatus.OK)
        return TokenResult(TokenStatus.BLOCKED)

    # -- concurrent (semaphore) mode ----------------------------------------
    def load_concurrent_rules(self, rules) -> None:
        self.concurrency.load_rules(rules)
        # the acquire-path sweep is bounded (64 entries), so permits held by
        # crashed clients behind long-TTL live tokens need the background
        # sweep (RegularExpireStrategy analog)
        if rules and self._expiry is None:
            self._expiry = ExpiryTask(self.concurrency)
            self._expiry.start()

    def close(self) -> None:
        if self._expiry is not None:
            self._expiry.stop()
            self._expiry = None

    def reopen(self) -> None:
        """Re-arm the background sweep after :meth:`close`, when the
        service is put back behind a transport."""
        if self._expiry is None and self.concurrency.has_rules():
            self._expiry = ExpiryTask(self.concurrency)
            self._expiry.start()

    def request_concurrent_token(self, flow_id, acquire=1, prioritized=False):
        r = self.concurrency.acquire(flow_id, acquire, prioritized)
        return TokenResult(r.status, r.remaining, 0, r.token_id)

    def release_concurrent_token(self, token_id):
        return TokenResult(self.concurrency.release(token_id))

    # -- token leases (client-local admission) -------------------------------
    def _sweep_leases_locked(self, now: int) -> None:
        """Drop leases past their TTL. Their LEASED charge stays in the flow
        window and expires with it: a crashed client causes under-admission
        for up to one window, never over-admission. Caller holds
        ``self._lock``."""
        dead = [lease for lease in self._leases.values()
                if now >= lease.expiry_ms]
        for lease in dead:
            del self._leases[lease.lease_id]
        self._lease_stats["revoked"] += len(dead)
        # seam: the push plane recalls the expired leases here

    def _credit_lease_locked(self, lease: _Lease, used: int) -> None:
        """Credit a lease's unused tokens back into the exact ring bucket
        its grant charged, and only while that bucket's start stamp proves
        it still holds the grant's epoch (one device read); otherwise the
        credit is dropped and the tokens expire with the window, so the
        LEASED sum never goes net negative. Caller holds ``self._lock``."""
        unused = lease.tokens - max(0, int(used))
        if unused <= 0:
            return
        spec = flow_spec(self.config)
        idx, aligned = W.bucket_index(spec, lease.granted_ms)
        ws = self._state.flow
        if int(ws.starts[idx]) != aligned:
            return
        ws.counts[lease.slot, idx, int(ClusterEvent.LEASED)].sub_(unused)

    @staticmethod
    def _fold_into_current(ws, spec, now: int, rows, sums):
        """Add per-row event sums into the CURRENT ring bucket of ``ws``, in
        place, rolling that column first when its start is stale (what the
        next write's roll would do, checked on the device), so the fold
        cannot resurrect a dead bucket's counts."""
        W.roll(spec, ws, now)
        idx, _ = W.bucket_index(spec, now)
        if rows is not None and len(rows):
            dev = ws.counts.device
            ws.counts[:, idx].index_add_(
                0,
                torch.as_tensor(np.asarray(rows, np.int64), device=dev),
                torch.as_tensor(np.asarray(sums), dtype=ws.counts.dtype,
                                device=dev),
            )
        return ws

    def _lease_admit_locked(
        self, flow_id: int, want: int, now: int, stat: str
    ) -> LeaseResult:
        """Grant core: a slice of the flow's current headroom (threshold
        less PASS, LEASED and matured borrows, what the decide step reads;
        one device read), charged into the LEASED column and registered.
        Caller holds ``self._lock`` and has swept."""
        flow_id = int(flow_id)
        rule = self._rule_of.get(flow_id)
        if rule is None:
            return LeaseResult(int(TokenStatus.NO_RULE_EXISTS))
        mv = self._moving.get(rule.namespace)
        if mv is not None:
            return LeaseResult(
                int(TokenStatus.MOVED), tokens=int(mv[1]), endpoint=mv[0]
            )
        want = int(want)
        if want <= 0 or self.lease_fraction <= 0.0:
            return LeaseResult(int(TokenStatus.NOT_LEASABLE))
        if int(rule.control_behavior) != 0:
            # a client-local slice would bypass warmup and pacing
            return LeaseResult(int(TokenStatus.NOT_LEASABLE))
        if self._has_breakers and flow_id in self._degrade_rules_src:
            # a slice would keep admitting for a TTL after the breaker
            # opens, and its traffic would never see DEGRADED
            return LeaseResult(int(TokenStatus.NOT_LEASABLE))
        slot = self._index.slot_of.get(flow_id)
        if slot is None:
            return LeaseResult(int(TokenStatus.NO_RULE_EXISTS))
        spec = flow_spec(self.config)
        st = self._state
        ids = torch.tensor([slot], dtype=torch.int64, device=self.device)
        occupied = float((
            W.window_sum_at(spec, st.flow, now, int(ClusterEvent.PASS), ids)
            + W.window_sum_at(spec, st.flow, now, int(ClusterEvent.LEASED),
                              ids)
            + W.window_sum_at(spec, st.occupy, now, 0, ids)
        )[0])
        factor = (
            max(1, int(self._connected.get(rule.namespace, 1)))
            if rule.mode == ThresholdMode.AVG_LOCAL else 1
        )
        threshold = (
            float(rule.count) * factor * self.config.exceed_count
            * (spec.interval_ms / 1000.0)
        )
        grant = min(want, int((threshold - occupied) * self.lease_fraction))
        if grant < 1:
            return LeaseResult(int(TokenStatus.NOT_LEASABLE))
        row = [0] * N_CLUSTER_EVENTS
        row[int(ClusterEvent.LEASED)] = grant
        self._fold_into_current(st.flow, spec, now, [slot], [row])
        lease_id = next(self._lease_seq)
        self._leases[lease_id] = _Lease(
            lease_id, flow_id, slot, grant, now, now + self.lease_ttl_ms
        )
        self._lease_stats[stat] += 1
        return LeaseResult(
            int(TokenStatus.OK), lease_id=lease_id, tokens=grant,
            ttl_ms=self.lease_ttl_ms,
        )

    def lease_grant(self, flow_id: int, want: int) -> LeaseResult:
        """Grant a short-TTL local-admission slice of ``flow_id``'s window:
        up to ``want`` tokens, capped at ``lease_fraction`` of the current
        headroom, pre-paid into the LEASED column."""
        with self._lock:
            now = self._engine_now()
            self._sweep_leases_locked(now)
            return self._lease_admit_locked(flow_id, want, now, "granted")

    def lease_renew(
        self, lease_id: int, flow_id: int, used: int, want: int
    ) -> LeaseResult:
        """Credit the old lease's unused tokens and grant a fresh slice, in
        one step. An unknown ``lease_id`` (expired, revoked, or granted
        before a failover) makes a credit-less grant."""
        with self._lock:
            now = self._engine_now()
            self._sweep_leases_locked(now)
            lease = self._leases.get(int(lease_id))
            if lease is not None and lease.flow_id == int(flow_id):
                del self._leases[int(lease_id)]
                self._credit_lease_locked(lease, used)
            return self._lease_admit_locked(flow_id, want, now, "renewed")

    def lease_return(self, lease_id: int, used: int) -> LeaseResult:
        """Give a lease back early, crediting its unused tokens. Returning
        an expired, revoked or unknown lease is OK."""
        with self._lock:
            now = self._engine_now()
            self._sweep_leases_locked(now)
            lease = self._leases.pop(int(lease_id), None)
            if lease is not None:
                self._credit_lease_locked(lease, used)
                self._lease_stats["returned"] += 1
        return LeaseResult(int(TokenStatus.OK))

    def outstanding_leases(self) -> int:
        """Tokens delegated on live leases: the bound on crash
        over-admission."""
        with self._lock:
            self._sweep_leases_locked(self._engine_now())
            return sum(lease.tokens for lease in self._leases.values())

    def lease_stats(self) -> Dict[str, int]:
        """Cumulative granted / renewed / returned / revoked (TTL expiry and
        reload drops) plus the live leases and their tokens."""
        with self._lock:
            if self._leases:
                self._sweep_leases_locked(self._engine_now())
            out = dict(self._lease_stats)
            out["outstanding"] = len(self._leases)
            out["outstanding_tokens"] = sum(
                lease.tokens for lease in self._leases.values()
            )
            return out

    # -- state snapshot / restore (HA) ----------------------------------------
    def export_state(self) -> Dict[str, object]:
        """Device→host capture of what a warm standby needs to resume
        counting: rule sources, slot assignments, every state plane, the
        param sketch and the engine epoch, as numpy copies under the
        reference's keys and dtypes (the hierarchy tier's ``hier`` block is
        a later slice)."""

        def _np(t: torch.Tensor) -> np.ndarray:
            return t.detach().cpu().numpy().copy()

        def _win(ws) -> Dict[str, np.ndarray]:
            return {"starts": _np(ws.starts), "counts": _np(ws.counts)}

        with self._rules_mutex, self._lock:
            now = self._engine_now()  # pins the epoch, runs a due rebase
            st = self._state
            return {
                "engine_now": int(now),
                "epoch_ms": int(self._epoch_ms),
                "wall_ms": int(_clock.now_ms()),
                "ns_max_qps": float(self._ns_max_qps),
                "connected": dict(self._connected),
                "namespace_set": sorted(self.namespace_set),
                "rules": [
                    r for m in self._rules_by_ns.values() for r in m.values()
                ],
                "param_rules": list(self._param_rules_src.values()),
                "degrade_rules": list(self._degrade_rules_src.values()),
                "slot_of": dict(self._index.slot_of),
                "ns_of": dict(self._index.ns_of),
                "param_slot_of": {
                    fid: slot
                    for fid, (slot, _, _) in self._param_rules.items()
                },
                "flow": _win(st.flow),
                "occupy": _win(st.occupy),
                "ns": _win(st.ns),
                "outcome": _win(st.outcome),
                "shaping": {f: _np(getattr(st.shaping, f))
                            for f in ShapingState._fields},
                "breaker": {f: _np(getattr(st.breaker, f))
                            for f in BreakerState._fields},
                "param": interop.param_state_to_numpy(self._param_state),
            }

    def import_state(self, state: Dict[str, object]) -> None:
        """Restore an :meth:`export_state` capture (of either package) into
        this service.

        Slot assignments are not trusted: the rules reload through the
        normal path, then rows move old slot → new slot by flow_id,
        namespace and param rule. Window starts and the engine epoch carry
        over verbatim. Rules are read by field name (``interop.port_rule``),
        so the reference's rule classes restore too. A geometry mismatch
        raises ``ValueError`` before anything mutates. The SALSA kernel's
        add buffer stays all zero: the sketch is written in place."""

        def _check(name: str, got, want: torch.Tensor) -> np.ndarray:
            arr = np.asarray(got)
            if arr.shape != tuple(want.shape):
                raise ValueError(
                    f"snapshot geometry mismatch: {name} {arr.shape} "
                    f"!= {tuple(want.shape)}"
                )
            return arr

        cur, pst = self._state, self._param_state
        with self._rules_mutex:
            with self._lock:
                win = {
                    plane: (
                        _check(f"{plane}.counts", state[plane]["counts"],
                               getattr(cur, plane).counts),
                        _check(f"{plane}.starts", state[plane]["starts"],
                               getattr(cur, plane).starts),
                    )
                    for plane in ("flow", "occupy", "ns")
                }
                p_c = _check("param.counts", state["param"]["counts"],
                             pst.counts)
                p_s = _check("param.starts", state["param"]["starts"],
                             pst.starts)
                p_slim = state["param"].get("slim")
                if p_slim is not None:
                    p_slim = _check("param.slim", p_slim, pst.slim)
                p_auth = state["param"].get("slim_auth")
                p_merges = state["param"].get("merges")
                # snapshots from before the shaping, outcome and breaker
                # planes restore those cold
                shaping_doc = state.get("shaping")
                breaker_doc = state.get("breaker")
                outcome_doc = state.get("outcome")
                if outcome_doc is not None:
                    win["outcome"] = (
                        _check("outcome.counts", outcome_doc["counts"],
                               cur.outcome.counts),
                        _check("outcome.starts", outcome_doc["starts"],
                               cur.outcome.starts),
                    )
                rules = [interop.port_rule(r, ClusterFlowRule)
                         for r in state["rules"]]
                param_rules = [interop.port_rule(r, ClusterParamFlowRule)
                               for r in state["param_rules"]]
                # degrade rules go in first, so the reloaded table carries
                # the br_* columns the restored breaker state refers to
                self._degrade_rules_src = {
                    d.flow_id: d for d in (
                        interop.port_rule(r, DegradeRule)
                        for r in state.get("degrade_rules", ())
                    )
                }
            self.load_rules(
                rules,
                ns_max_qps=float(state["ns_max_qps"]),
                connected=dict(state["connected"]),
            )
            self.load_param_rules(param_rules)
            with self._lock:
                self.namespace_set |= set(state["namespace_set"])
                new, old = _remap(self._index.slot_of, state["slot_of"])
                dev = self.device

                def put(dst: torch.Tensor, src, rows_new, rows_old, fill):
                    out = np.full(tuple(dst.shape), fill,
                                  np.asarray(src).dtype)
                    out[rows_new] = np.asarray(src)[rows_old]
                    dst.copy_(torch.as_tensor(out, device=dev))

                for plane, (counts, starts) in win.items():
                    ws = getattr(cur, plane)
                    rows = ((new, old) if plane != "ns" else _remap(
                        self._index.ns_of, state["ns_of"]))
                    put(ws.counts, counts, *rows, 0)
                    ws.starts.copy_(torch.as_tensor(np.array(starts),
                                                    device=dev))
                if outcome_doc is None:
                    cur.outcome.counts.zero_()
                for plane, doc, fills in (
                    ("shaping", shaping_doc,
                     {"lpt": NEVER, "warm_tokens": 0.0,
                      "warm_filled": NEVER}),
                    ("breaker", breaker_doc,
                     {"state": 0, "opened_ms": NEVER, "probe_ms": NEVER}),
                ):
                    cols = getattr(cur, plane)
                    for field, fill in fills.items():
                        dst = getattr(cols, field)
                        if doc is None:
                            dst.fill_(fill)
                        else:
                            put(dst, doc[field], new, old, fill)
                # the transition mirror restarts from CLOSED, so a restored
                # open breaker surfaces as a closed→open edge
                self._breaker_prev = None
                pnew, pold = _remap(
                    {fid: slot for fid, (slot, _, _)
                     in self._param_rules.items()},
                    state["param_slot_of"],
                )
                put(pst.counts, p_c, pnew, pold, 0)
                if p_slim is None:
                    pst.slim.zero_()
                else:
                    put(pst.slim, p_slim, pnew, pold, 0)
                if p_merges is None:
                    pst.merges.zero_()
                else:
                    put(pst.merges, p_merges, pnew, pold, 0)
                if p_auth is None:
                    pst.slim_auth.zero_()
                else:
                    pst.slim_auth.copy_(torch.as_tensor(
                        np.array(p_auth, bool), device=dev))
                pst.starts.copy_(torch.as_tensor(np.array(p_s), device=dev))
                self._epoch_ms = int(state["epoch_ms"])

    # -- reads of the flow and outcome planes ---------------------------------
    def metrics_snapshot(self) -> Dict[int, Dict[str, float]]:
        """Per-flow windowed rates from the flow and outcome planes (two
        device reads). The reference also stamps ``moved_epoch`` on flows of
        a namespace that is moving; MOVE is not ported, so that never
        applies here."""
        with self._lock:
            now = self._engine_now()
            spec = flow_spec(self.config)
            sums = W.window_sum_all(spec, self._state.flow, now).cpu().numpy()
            osums = W.window_sum_all(spec, self._state.outcome,
                                     now).cpu().numpy()
            interval_s = spec.interval_ms / 1000.0
            out = {}
            for fid, slot in self._index.slot_of.items():
                n_complete = float(osums[slot, OutcomeChannel.COMPLETE])
                rt_sum = float(osums[slot, OutcomeChannel.RT_SUM])
                out[fid] = {
                    "pass_qps": float(sums[slot, ClusterEvent.PASS])
                    / interval_s,
                    "block_qps": float(sums[slot, ClusterEvent.BLOCK])
                    / interval_s,
                    "pass_req_qps": float(sums[slot,
                                               ClusterEvent.PASS_REQUEST])
                    / interval_s,
                    "leased_tokens": float(sums[slot, ClusterEvent.LEASED]),
                    "success_qps": n_complete / interval_s,
                    "exception_qps": (
                        float(osums[slot, OutcomeChannel.EXCEPTION])
                        / interval_s
                    ),
                    "rt_avg_ms": rt_sum / n_complete if n_complete else 0.0,
                }
            return out

    # -- completion reports (OUTCOME_REPORT) ----------------------------------
    def report_outcomes(self, flow_ids, rt_ms, exceptions, xid: int = 0) -> int:
        """Ingest one batch of completion reports: validate at the wire
        boundary, then scatter the accepted rows into the per-flow outcome
        window with the outcome step on the service's device (with the
        breaker columns when degrade rules are loaded: the SLOW channel and
        HALF_OPEN probe resolution). Returns the rows accepted.

        Dropped rows are counted by reason: ``non_finite`` (a non-finite
        float RT), ``negative`` (RT < 0), ``too_large`` (RT above
        ``OUTCOME_MAX_RT_MS``), ``unknown_flow`` (no rule slot). ``xid`` is
        the frame's id, for the trace plane (a later slice)."""
        flow_ids = np.asarray(flow_ids, np.int64).reshape(-1)
        k = int(flow_ids.shape[0])
        rt_in = np.asarray(rt_ms).reshape(-1)
        exc_in = np.asarray(exceptions).reshape(-1).astype(bool)
        if rt_in.shape[0] != k or exc_in.shape[0] != k:
            raise ValueError("outcome report arrays must share one length")
        if rt_in.dtype.kind == "f":
            finite = np.isfinite(rt_in)
            rt = np.where(finite, rt_in, -1.0).astype(np.int64)
        else:
            finite = np.ones(k, bool)
            rt = rt_in.astype(np.int64)
        negative = finite & (rt < 0)
        too_large = finite & (rt > OUTCOME_MAX_RT_MS)
        slots = self.lookup_slots(flow_ids)
        unknown = slots < 0
        valid = finite & ~negative & ~too_large & ~unknown
        n_ok = int(valid.sum())
        drops = (
            ("non_finite", int((~finite).sum())),
            ("negative", int(negative.sum())),
            ("too_large", int((too_large & ~negative).sum())),
            ("unknown_flow",
             int((unknown & finite & ~negative & ~too_large).sum())),
        )
        # pad to a x4 ladder from 64, the reference's compiled shapes; the
        # four columns travel in one host-to-device copy
        cap = 64
        while cap < k:
            cap *= 4
        cols = np.zeros((4, cap), np.int32)
        cols[0, :k] = np.where(valid, slots, 0)
        cols[1, :k] = np.where(valid, rt, 0)
        cols[2, :k] = exc_in & valid
        cols[3, :k] = valid
        with self._lock:
            dropped = self._outcome_counts["dropped"]
            for reason, n in drops:
                if n:
                    dropped[reason] = dropped.get(reason, 0) + n
            self._outcome_counts["batches"] += 1
            if n_ok:
                if self._outcome_step is None:
                    self._outcome_step = outcome_step_donating(self.config)
                now = self._engine_now()
                slots_d, rt_d, exc_d, valid_d = self._dev(cols)
                args = (self._state, slots_d, rt_d, exc_d, valid_d.bool(),
                        now)
                if self._has_breakers:
                    args += (self._table.br_strategy,
                             self._table.br_slow_rt_ms)
                self._state = self._outcome_step(*args)
                self._outcome_counts["reported"] += n_ok
                self._outcome_counts["exceptions"] += int(
                    (exc_in & valid).sum())
                self._outcome_counts["rt_sum_ms"] += int(rt[valid].sum())
        # seam: the per-namespace fan-out of the accepted rows (timeline,
        # SLO burn, flight recorder, stat log) goes here, by
        # self._ns_snapshot
        return n_ok

    def outcome_stats(self) -> Dict[str, object]:
        """The outcome plane on the host: the ingest counters plus each
        active flow's windowed completion and exception rates, mean RT and
        the histogram's p99 cell edge (one device read of the window
        sums)."""
        with self._lock:
            c = self._outcome_counts
            out: Dict[str, object] = {
                "reported": int(c["reported"]),
                "exceptions": int(c["exceptions"]),
                "rt_sum_ms": int(c["rt_sum_ms"]),
                "batches": int(c["batches"]),
                "dropped": dict(c["dropped"]),
            }
            if not self._index.slot_of:
                out["flows"] = {}
                return out
            now = self._engine_now()
            spec = flow_spec(self.config)
            sums = W.window_sum_all(spec, self._state.outcome,
                                    now).cpu().numpy()
            interval_s = spec.interval_ms / 1000.0
            h0 = int(OutcomeChannel.RT_HIST0)
            flows: Dict[int, Dict[str, float]] = {}
            # idle flows stay off the scrape surface
            keys, key_slots = self._lookup
            busy = (sums[key_slots, OutcomeChannel.COMPLETE] != 0) | (
                sums[key_slots, OutcomeChannel.EXCEPTION] != 0)
            for fid, slot in zip(keys[busy].tolist(),
                                 key_slots[busy].tolist()):
                complete = int(sums[slot, OutcomeChannel.COMPLETE])
                exc = int(sums[slot, OutcomeChannel.EXCEPTION])
                rt_sum = float(sums[slot, OutcomeChannel.RT_SUM])
                hist = sums[slot, h0: h0 + N_RT_BUCKETS]
                total = int(hist.sum())
                if total:
                    target = -(-99 * total // 100)  # ceil(0.99 * total)
                    b = int(np.searchsorted(np.cumsum(hist), target))
                    edge = RT_BUCKET_UPPER_MS[min(b, N_RT_BUCKETS - 1)]
                    p99 = (
                        float(edge) if edge != float("inf")
                        else float((1 << N_RT_BUCKETS) - 1)
                    )
                else:
                    p99 = 0.0
                flows[int(fid)] = {
                    "complete_qps": complete / interval_s,
                    "exception_qps": exc / interval_s,
                    "rt_avg_ms": rt_sum / complete if complete else 0.0,
                    "rt_p99_ms": p99,
                }
            out["flows"] = flows
            return out

    # -- circuit-breaker observability ----------------------------------------
    _BR_STATE_NAMES = ("closed", "open", "half_open")

    def _breaker_scan(
        self, force: bool = False
    ) -> Dict[Tuple[int, int], int]:
        """Diff the device's breaker state column (one ``[F]`` int8 read)
        against the host mirror and return the observed edges,
        ``{(from, to): count}``. At most once a second unless ``force``
        (then ``{}`` between scans); transitions happen on the device, so a
        breaker that opens and recovers between two scans shows its net
        edge. The first scan after a reload or restore diffs against
        CLOSED."""
        if not self._has_breakers:
            return {}
        edges: Dict[Tuple[int, int], int] = {}
        with self._lock:
            now_s = time.monotonic()
            if not force and now_s - self._breaker_scan_ts < 1.0:
                return edges
            self._breaker_scan_ts = now_s
            st = self._state.breaker.state.cpu().numpy().copy()
            prev = self._breaker_prev
            self._breaker_prev = st
            if prev is None:
                prev = np.zeros_like(st)
            for s in np.nonzero(st != prev)[0].tolist():
                if s in self._breaker_slots:  # else a dropped rule's row
                    key = (int(prev[s]), int(st[s]))
                    edges[key] = edges.get(key, 0) + 1
        # seam: the edges feed the transition counters, the clients' push
        # (breaker flips) and, on a trip to OPEN, the blackbox dump here
        return edges

    def breaker_stats(self) -> Dict[str, object]:
        """Per-flow breaker state (read from the device columns) with clock
        ages. Scans for transitions first."""
        if not self._has_breakers:
            return {}
        self._breaker_scan(force=True)
        names = self._BR_STATE_NAMES
        with self._lock:
            br = self._state.breaker
            st = br.state.cpu().numpy()
            opened = br.opened_ms.cpu().numpy()
            probe = br.probe_ms.cpu().numpy()
            now = self._engine_now()
            flows: Dict[int, Dict[str, object]] = {}
            for fid, rule in self._degrade_rules_src.items():
                slot = self._index.slot_of.get(fid)
                if slot is None:
                    continue
                code = int(st[slot])
                entry: Dict[str, object] = {
                    "state": names[code] if code < 3 else str(code),
                    "state_code": code,
                    "strategy": int(rule.strategy),
                }
                if int(opened[slot]) != NEVER:
                    entry["since_transition_ms"] = now - int(opened[slot])
                if int(probe[slot]) != NEVER:
                    entry["probe_age_ms"] = now - int(probe[slot])
                flows[int(fid)] = entry
            return {"rules": len(self._degrade_rules_src), "flows": flows}


def _remap(new_of: Dict, old_of: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """``(new rows, old rows)`` of the keys both maps hold: a snapshot's
    rows move to this service's slots by flow_id (or namespace, or param
    rule)."""
    pairs = [(new, old_of[key]) for key, new in new_of.items()
             if key in old_of]
    rows = np.array(pairs, np.int64).reshape(-1, 2)
    return rows[:, 0], rows[:, 1]
