"""Cluster-wide concurrency (semaphore) flow control: the port's own copy
of ``sentinel_tpu/cluster/concurrent.py`` (host-only; the port imports
nothing of the JAX package).

Analog of the reference's concurrent token mode
(``sentinel-cluster-server-default``):

- ``CurrentConcurrencyManager.java:37-95`` — per-flowId ``nowCalls`` counter;
- ``ConcurrentClusterFlowChecker.java:48-74`` — synchronized check+add with
  ``concurrencyLevel = count × (GLOBAL ? 1 : connectedCount)``;
- ``TokenCacheNodeManager.java:28-71`` — issued token-id cache
  (ConcurrentLinkedHashMap in the reference; an insertion-ordered dict here,
  which is the same structure — tokens expire in issue order because every
  token of one rule shares a TTL);
- ``RegularExpireStrategy`` — background/amortized sweep of expired tokens so
  a crashed client cannot leak permits forever.

This path is host-side by design: acquire/release is a keyed mutable cache
with TTLs and sub-microsecond critical sections — there are no FLOPs to ship
to the device, and a device round-trip per release would only add latency. The
single host lock replaces the reference's per-structure synchronization.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.engine.decide import TokenStatus
from sentinel_tpu_torch.engine.rules import ThresholdMode

DEFAULT_RESOURCE_TIMEOUT_MS = 2_000  # ClusterFlowConfig#resourceTimeout default
_SWEEP_PER_ACQUIRE = 64  # amortized RegularExpireStrategy budget per acquire


@dataclass(frozen=True)
class ConcurrentFlowRule:
    """Concurrency-mode cluster rule: at most ``concurrency_level`` permits
    held at once across the cluster (× connected clients when AVG_LOCAL)."""

    flow_id: int
    concurrency_level: int
    mode: ThresholdMode = ThresholdMode.GLOBAL
    resource_timeout_ms: int = DEFAULT_RESOURCE_TIMEOUT_MS
    namespace: str = "default"  # AVG_LOCAL scales by this namespace's clients


@dataclass
class TokenCacheNode:
    """``TokenCacheNode.java`` — one issued permit."""

    token_id: int
    flow_id: int
    acquire: int
    expire_at_ms: int


@dataclass(frozen=True)
class AcquireResult:
    status: TokenStatus
    token_id: int = 0
    remaining: int = 0


class ConcurrencyManager:
    """Owns ``nowCalls`` per flow + the issued-token cache.

    Single-writer under one lock (the reference stripes this across an
    AtomicInteger per flow, a synchronized checker, and a concurrent map —
    host mutation stays single-writer)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[int, ConcurrentFlowRule] = {}
        self._now_calls: Dict[int, int] = {}
        self._tokens: Dict[int, TokenCacheNode] = {}  # insertion-ordered
        self._ids = itertools.count(1)
        self._connected: Dict[str, int] = {}  # namespace → client count

    # -- config -------------------------------------------------------------
    def load_rules(self, rules: List[ConcurrentFlowRule]) -> None:
        with self._lock:
            self._rules = {r.flow_id: r for r in rules}
            # permits for deleted rules drain naturally via release/expiry

    def has_rules(self) -> bool:
        with self._lock:
            return bool(self._rules)

    def set_connected_count(self, n: int, namespace: str = "default") -> None:
        """ConnectionManager callback, scoped per namespace
        (``ConnectionManager.java:30-58``)."""
        with self._lock:
            self._connected[namespace] = max(1, int(n))

    # -- introspection --------------------------------------------------------
    def now_calls(self, flow_id: int) -> int:
        with self._lock:
            return self._now_calls.get(int(flow_id), 0)

    def token_count(self) -> int:
        with self._lock:
            return len(self._tokens)

    # -- hot path -------------------------------------------------------------
    def acquire(
        self,
        flow_id: int,
        acquire: int = 1,
        prioritized: bool = False,
        now_ms: Optional[int] = None,
    ) -> AcquireResult:
        """``ConcurrentClusterFlowChecker.acquireConcurrentToken``: admit iff
        ``nowCalls + acquire ≤ level``; on pass, issue a cached token id."""
        flow_id = int(flow_id)
        now = _clock.now_ms() if now_ms is None else int(now_ms)
        with self._lock:
            self._sweep_locked(now, _SWEEP_PER_ACQUIRE)
            rule = self._rules.get(flow_id)
            if rule is None:
                return AcquireResult(TokenStatus.NO_RULE_EXISTS)
            if acquire <= 0:
                return AcquireResult(TokenStatus.FAIL)
            level = rule.concurrency_level * (
                1
                if rule.mode == ThresholdMode.GLOBAL
                else self._connected.get(rule.namespace, 1)
            )
            held = self._now_calls.get(flow_id, 0)
            if held + acquire > level:
                return AcquireResult(
                    TokenStatus.BLOCKED, remaining=max(0, level - held)
                )
            self._now_calls[flow_id] = held + acquire
            token_id = next(self._ids)
            self._tokens[token_id] = TokenCacheNode(
                token_id, flow_id, acquire, now + rule.resource_timeout_ms
            )
            return AcquireResult(
                TokenStatus.OK, token_id, max(0, level - held - acquire)
            )

    def release(self, token_id: int) -> TokenStatus:
        """``ConcurrentClusterFlowChecker.releaseConcurrentToken``: idempotent —
        a token already released (or expired by the sweeper) reports
        ALREADY_RELEASE rather than double-decrementing."""
        with self._lock:
            node = self._tokens.pop(int(token_id), None)
            if node is None:
                return TokenStatus.ALREADY_RELEASE
            self._dec_locked(node)
            return TokenStatus.RELEASE_OK

    # -- expiry (RegularExpireStrategy analog) --------------------------------
    def expire(self, now_ms: Optional[int] = None,
               limit: Optional[int] = None) -> int:
        """Sweep expired tokens; returns the number reclaimed. ``limit``
        bounds entries *inspected* (hot-path callers); the background task
        passes None for a full scan — issue order only clusters expired
        tokens at the front per rule, so short-TTL tokens stuck behind a
        long-TTL rule's live permits need the unbounded sweep."""
        now = _clock.now_ms() if now_ms is None else int(now_ms)
        with self._lock:
            return self._sweep_locked(
                now, len(self._tokens) if limit is None else limit
            )

    def _sweep_locked(self, now: int, limit: int) -> int:
        # `limit` bounds entries *inspected*, not reclaimed, so an acquire-path
        # sweep is O(limit) even when nothing is expired (50k live permits must
        # not put a full-dict scan inside the hot-path critical section)
        expired = []
        for inspected, (token_id, node) in enumerate(self._tokens.items()):
            if inspected >= limit:
                break
            if node.expire_at_ms <= now:
                expired.append(token_id)
        for token_id in expired:
            self._dec_locked(self._tokens.pop(token_id))
        return len(expired)

    def _dec_locked(self, node: TokenCacheNode) -> None:
        held = self._now_calls.get(node.flow_id, 0) - node.acquire
        if held > 0:
            self._now_calls[node.flow_id] = held
        else:
            self._now_calls.pop(node.flow_id, None)


class ExpiryTask:
    """Background sweep thread (``RegularExpireStrategy`` analog)."""

    def __init__(self, manager: ConcurrencyManager, interval_s: float = 0.5):
        self._manager = manager
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="sentinel-concurrent-expiry", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            if thread.is_alive():
                # still draining a long sweep: leave the stop event set so it
                # exits at its next wait; a re-start would duplicate sweepers
                return
            self._thread = None
        self._stop.clear()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._manager.expire()
