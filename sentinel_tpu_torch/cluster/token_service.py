"""The token service's decision path (port of the decision half of
``sentinel_tpu/cluster/token_service.py``).

``DefaultTokenService`` owns the device state and rule table and the host's
``flow_id → slot`` index, and serializes device steps with a lock. The
serving path is the reference's:

- host prep outside the lock: slot lookup, a stable sort that groups
  same-flow requests (memoized by :class:`_PrepCache`), padding to the
  smallest serve bucket (64 / 256 / 1024 / … / ``batch_size``);
- the device step under the lock: ``decide_donating`` (the CUDA kernel on a
  card), or ``decide_fused_donating`` for runs of full frames of an
  oversized pull (greedy largest-fit over the fuse ladder, e.g. 8 / 4 / 2);
- verdict materialization outside the lock, back in request order.

The hot-param path (``load_param_rules``, ``request_params_token``) steps
the param sketch through ``engine.param.param_decide``: the CUDA CMS or
SALSA kernel on a card, the torch-ops core with ``ParamConfig(impl="jax")``.

Leases, HA export/replication, rebalance (MOVED), outcome reports, push,
metrics and trace hooks are later slices.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch._device import DeviceLike, resolve_device
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
from sentinel_tpu_torch.engine.rules import (
    ClusterFlowRule,
    build_rule_table,
    drain_pending_clear,
)
from sentinel_tpu_torch.engine.state import make_state
from sentinel_tpu_torch.stats.window import NEVER, rebase


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
    """``TokenResult.java`` — status + remaining + wait hint."""

    status: TokenStatus
    remaining: int = 0
    wait_ms: int = 0

    @property
    def ok(self) -> bool:
        return self.status == TokenStatus.OK


class DefaultTokenService:
    """Engine-backed token service: the flow decision and hot-param paths.

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
        self._epoch_ms: Optional[int] = None
        self._connected: Dict[str, int] = {}
        self._ns_max_qps = 30_000.0
        # hot-param sketch path (ClusterParamFlowChecker analog)
        self._rules_mutex = threading.RLock()
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

    # -- rule management ----------------------------------------------------
    def load_rules(
        self,
        rules: List[ClusterFlowRule],
        ns_max_qps: Optional[float] = None,
        connected: Optional[Dict[str, int]] = None,
    ) -> None:
        with self._lock:
            if ns_max_qps is not None:
                self._ns_max_qps = ns_max_qps
            if connected is not None:
                self._connected.update(connected)
            self._table, self._index = build_rule_table(
                self.config, rules, index=self._index,
                ns_max_qps=self._ns_max_qps, connected=self._connected,
                device=self.device,
            )
            # slots freed by the reload are zeroed before reuse
            drain_pending_clear(self._index, self._state)
            items = sorted(self._index.slot_of.items())
            self._lookup = (
                np.fromiter((k for k, _ in items), np.int64, len(items)),
                np.fromiter((v for _, v in items), np.int32, len(items)),
            )

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
                return (np.array(status_sorted),
                        np.array(remaining_sorted, np.int32),
                        np.array(wait_sorted, np.int32))
            status = np.empty(n, status_sorted.dtype)
            remaining = np.empty(n, np.int32)
            wait = np.empty(n, np.int32)
            status[order] = status_sorted
            remaining[order] = remaining_sorted
            wait[order] = wait_sorted
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
            return status, remaining, wait

        return _materialize

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
