"""The port's copy of ``sentinel_tpu/cluster/hierarchy.py``.

Hierarchical global limits: pods lease provisioned shares of a global
flow budget, so a fleet-wide limit holds with ZERO per-decision cross-pod
traffic (ROADMAP item 3, SURVEY §7 step 5).

The trick is the wire-rev-5 lease machinery applied one level up::

    clients ──(LEASE_*)──▶ pod ──(SHARE_*/DEMAND_REPORT)──▶ coordinator
             local admit        slow DCN tier, ~100ms ticks

- :class:`GlobalBudgetCoordinator` runs co-located with any pod (attached
  via ``service.attach_hierarchy``; both front doors route ``HIER_TYPES``
  frames to it). It owns one ledger entry per global flow — the budget,
  every pod's live share, reported demand — and a reconciliation loop that
  water-fills share targets over reported arrival rates with hysteresis
  against share thrash. Targets ship as renew-time regrants: the
  coordinator never pushes, pods pull on their own tick.
- :class:`PodShareAgent` runs inside every pod. The pod loads the global
  rule at its FULL budget ``G``; each tick the agent reports observed
  demand (PASS + BLOCK rates — blocked tokens count, so a squeezed pod
  still registers demand), renews its share ``S``, and pins
  ``G − S`` tokens as a LEASED-column hold
  (``service.set_share_hold``) — local headroom becomes exactly the share
  and the decision hot path is UNTOUCHED (the device kernel already reads
  LEASED; psum'd limits, snapshots, deltas, and MOVE carry the hold like
  any lease charge).

Failure containment, by construction:

- Coordinator unreachable → the agent keeps re-topping its LAST-granted
  share ("degrade to last share"). Worst-case fleet over-admission is
  Σ outstanding pod shares — the same invariant the lease drill gates,
  one level up — and only until shares next converge.
- Pod dies → its share expires with the share TTL and reconciliation
  hands the tokens to the surviving pods' demand.
- Coordinator pod fails over → the ledger piggybacks on the replication
  stream (``export_delta["hier"]``), so the promoted standby's attached
  coordinator resumes with every share intact; agents walk their endpoint
  list through their client's ``share_op`` to find it.
- MOVE of a globally-limited namespace → the hold's LEASED charge rides
  the window-sum export (lossless), the registries drop, and the
  destination's own agent re-tops from ITS share on the next tick.

This module touches no device state: the coordinator is a plain host-side
ledger (dict + lock — shares are control-plane state at agent
tick rate, not decision rate) and the agent only needs the socket
clients. Shares are CAPACITY provisioning, not consumables: a share is
never "used up", it is re-leased every tick at whatever the water-fill
says, so ``used`` rides as 0 on the share frames.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.cluster import protocol as P

log = logging.getLogger(__name__)

# TokenStatus mirrors (this module imports no engine code)
_OK = 0
_FAIL = 5
_NOT_LEASABLE = int(P.NOT_LEASABLE_STATUS)


@dataclass(frozen=True)
class GlobalFlowBudget:
    """One globally-limited flow: ``count`` tokens/s fleet-wide, enforced
    over a ``window_s`` sliding window (match the pods' engine window).
    ``budget_tokens`` — the water-filled pool — is ``count × window_s``."""

    flow_id: int
    count: float
    window_s: float = 1.0
    namespace: str = "default"

    @property
    def budget_tokens(self) -> int:
        return max(0, int(self.count * self.window_s))


def water_fill(budget: int, demands: Dict[str, float], floor: int = 0):
    """Classic water-filling of ``budget`` tokens over per-pod ``demands``
    (token units), with a per-pod ``floor`` (min-share: a pod whose demand
    collapses keeps a toehold, so a demand flip doesn't need a grant round
    trip before ANY traffic passes). Conserves the budget exactly:
    returned shares are integers summing to ``budget`` (when any pod
    exists). Under-demanded slack is split equally — idle headroom parks
    with every pod, absorbing spikes one tick sooner.
    """
    pods = sorted(demands)
    n = len(pods)
    out: Dict[str, int] = {}
    if n == 0 or budget <= 0:
        return {p: 0 for p in pods}
    floor = max(0, int(floor))
    if floor * n >= budget:
        # budget can't cover the floors: degenerate equal split
        share = budget // n
        out = {p: share for p in pods}
        for p in pods[: budget - share * n]:
            out[p] += 1
        return out
    free = float(budget - floor * n)
    want = {p: max(0.0, float(demands[p]) - floor) for p in pods}
    total = sum(want.values())
    if total <= free:
        slack = (free - total) / n
        level_of = {p: floor + want[p] + slack for p in pods}
    else:
        # raise the fill level until the free pool is spent
        vals = sorted(want.values())
        prev = spent = 0.0
        level = vals[-1]
        for i, v in enumerate(vals):
            width = n - i
            need = (v - prev) * width
            if spent + need >= free:
                level = prev + (free - spent) / width
                break
            spent += need
            prev = v
        level_of = {p: floor + min(want[p], level) for p in pods}
    # integerize conserving the total: floors first, largest remainders win
    ints = {p: int(level_of[p]) for p in pods}
    rem = budget - sum(ints.values())
    for p in sorted(pods, key=lambda q: (level_of[q] - ints[q], q),
                    reverse=True):
        if rem <= 0:
            break
        ints[p] += 1
        rem -= 1
    return ints


@dataclass
class ShareResult:
    """Outcome of a share op — duck-compatible with the lease-result shape
    the doors encode (status / lease_id / tokens / ttl_ms / endpoint)."""

    status: int
    lease_id: int = 0  # the share id (lease frame field name)
    tokens: int = 0
    ttl_ms: int = 0
    endpoint: str = ""


class _Share:
    __slots__ = ("share_id", "flow_id", "pod_id", "tokens", "granted_ms",
                 "expiry_ms")

    def __init__(self, share_id, flow_id, pod_id, tokens, granted_ms,
                 expiry_ms):
        self.share_id = share_id
        self.flow_id = flow_id
        self.pod_id = pod_id  # None until a demand report labels it
        self.tokens = tokens
        self.granted_ms = granted_ms
        self.expiry_ms = expiry_ms


class _FlowLedger:
    __slots__ = ("budget", "shares", "targets", "demand")

    def __init__(self, budget: GlobalFlowBudget):
        self.budget = budget
        self.shares: Dict[int, _Share] = {}
        self.targets: Dict[str, int] = {}
        # pod_id → (rate tokens/s, reported_at_ms)
        self.demand: Dict[str, Tuple[float, int]] = {}


class GlobalBudgetCoordinator:
    """The global budget ledger + reconciliation loop.

    Invariant (enforced arithmetically, never trusted to timing):
    for every flow, Σ live share tokens ≤ ``budget_tokens``. Grants and
    renews draw from ``budget − Σ live``; a renew drops the old share
    FIRST, so a pod's regrant can always reclaim at least its own tokens.

    Pod identity is learned, not declared: grants are anonymous until the
    pod's next demand report carries the share id, which labels the share
    with the pod — keeping the grant path stateless for the agent (crash
    → new share, old one expires with its TTL).
    """

    def __init__(
        self,
        budgets,
        share_ttl_ms: int = 5000,
        reconcile_ms: int = 100,
        hysteresis: float = 0.10,
        min_share_frac: float = 0.05,
    ):
        self._flows: Dict[int, _FlowLedger] = {
            int(b.flow_id): _FlowLedger(b) for b in budgets
        }
        self.share_ttl_ms = max(1, int(share_ttl_ms))
        self.reconcile_ms = max(1, int(reconcile_ms))
        self.hysteresis = max(0.0, float(hysteresis))
        self.min_share_frac = max(0.0, float(min_share_frac))
        self._lock = threading.Lock()
        self._seq = 1
        self._stats = {
            "share_grants": 0, "share_renews": 0, "share_returns": 0,
            "reconciles": 0, "demand_reports": 0, "share_expired": 0,
        }
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- ledger primitives (caller holds self._lock) -------------------------
    def _sweep_locked(self, led: _FlowLedger, now: int) -> None:
        dead = [sid for sid, s in led.shares.items() if now >= s.expiry_ms]
        for sid in dead:
            del led.shares[sid]
        self._stats["share_expired"] += len(dead)

    @staticmethod
    def _live_locked(led: _FlowLedger) -> int:
        return sum(s.tokens for s in led.shares.values())

    def _grant_locked(
        self, led: _FlowLedger, pod_id: Optional[str], want: int, now: int,
        stat: str,
    ) -> ShareResult:
        free = led.budget.budget_tokens - self._live_locked(led)
        target = led.targets.get(pod_id) if pod_id is not None else None
        grant = min(int(want), free)
        if target is not None:
            grant = min(grant, target)
        grant = max(0, grant)
        self._stats[stat] += 1
        if grant <= 0:
            # an authoritative zero: the pod holds no share right now (all
            # budget is out on other pods' shares, or its target is 0).
            # OK-with-zero-tokens, not NOT_LEASABLE — the agent must pin
            # the full budget as hold, not degrade to its last share.
            return ShareResult(_OK, lease_id=0, tokens=0,
                               ttl_ms=self.share_ttl_ms)
        sid = self._seq
        self._seq += 1
        led.shares[sid] = _Share(
            sid, led.budget.flow_id, pod_id, grant, now,
            now + self.share_ttl_ms,
        )
        return ShareResult(_OK, lease_id=sid, tokens=grant,
                           ttl_ms=self.share_ttl_ms)

    # -- wire-facing ops (doors dispatch HIER_TYPES here) --------------------
    def share_grant(self, flow_id: int, want: int) -> ShareResult:
        with self._lock:
            led = self._flows.get(int(flow_id))
            if led is None:
                return ShareResult(_NOT_LEASABLE)
            now = _clock.now_ms()
            self._sweep_locked(led, now)
            return self._grant_locked(led, None, want, now, "share_grants")

    def share_renew(
        self, share_id: int, flow_id: int, used: int, want: int
    ) -> ShareResult:
        """Drop the old share (tokens return to the pool), regrant at
        ``min(want, target, free)``. An unknown share id (expired, or a
        promoted coordinator that never saw it) degrades to a plain grant
        — no handshake after failover. ``used`` is ignored: shares are
        capacity, not consumables."""
        with self._lock:
            led = self._flows.get(int(flow_id))
            if led is None:
                return ShareResult(_NOT_LEASABLE)
            now = _clock.now_ms()
            self._sweep_locked(led, now)
            old = led.shares.pop(int(share_id), None)
            pod_id = old.pod_id if old is not None else None
            return self._grant_locked(led, pod_id, want, now, "share_renews")

    def share_return(self, share_id: int, used: int) -> ShareResult:
        """Give a share back early (pod drain/shutdown). Idempotent."""
        with self._lock:
            for led in self._flows.values():
                if led.shares.pop(int(share_id), None) is not None:
                    self._stats["share_returns"] += 1
                    break
            return ShareResult(_OK)

    def handle_demand_report(self, pod_id: str, entries) -> ShareResult:
        """Record per-pod observed demand and label shares with their pod.
        Returns an ack whose ``tokens`` is the number of entries accepted
        (entries naming unknown flows are skipped, not errors — rules roll
        out pod by pod)."""
        accepted = 0
        with self._lock:
            now = _clock.now_ms()
            for flow_id, share_id, rate_milli in entries:
                led = self._flows.get(int(flow_id))
                if led is None:
                    continue
                led.demand[str(pod_id)] = (
                    max(0.0, float(rate_milli) / 1000.0), now
                )
                share = led.shares.get(int(share_id))
                if share is not None and share.pod_id is None:
                    share.pod_id = str(pod_id)
                accepted += 1
            self._stats["demand_reports"] += 1
        return ShareResult(_OK, tokens=accepted)

    # -- reconciliation ------------------------------------------------------
    def reconcile_once(self) -> Dict[int, Dict[str, int]]:
        """One water-fill pass: demand rates → share targets per pod, with
        hysteresis (a target moves only when the change exceeds
        ``hysteresis × budget`` — share thrash costs a regrant round trip
        and a hold rewrite on every pod, so small demand noise shouldn't).
        Demand entries older than 2× the share TTL age out (a dead pod
        stops attracting budget). Returns the new target map per flow."""
        out: Dict[int, Dict[str, int]] = {}
        with self._lock:
            now = _clock.now_ms()
            stale_ms = 2 * self.share_ttl_ms
            for fid, led in self._flows.items():
                led.demand = {
                    p: (r, t) for p, (r, t) in led.demand.items()
                    if now - t < stale_ms
                }
                budget = led.budget.budget_tokens
                if not led.demand:
                    led.targets = {}
                    out[fid] = {}
                    continue
                window_s = max(1e-9, led.budget.window_s)
                demand_tokens = {
                    p: r * window_s for p, (r, t) in led.demand.items()
                }
                floor = int(self.min_share_frac * budget)
                fresh = water_fill(budget, demand_tokens, floor)
                hyst = self.hysteresis * budget
                targets = {}
                for p, t in fresh.items():
                    old = led.targets.get(p)
                    targets[p] = (
                        old if old is not None and abs(t - old) <= hyst
                        else t
                    )
                # hysteresis keeps old targets; never let the kept sum
                # exceed the budget (scale down proportionally if it would)
                total = sum(targets.values())
                if total > budget and total > 0:
                    scale = budget / total
                    targets = {p: int(t * scale) for p, t in targets.items()}
                led.targets = targets
                out[fid] = dict(targets)
            self._stats["reconciles"] += 1
        return out

    def start(self) -> "GlobalBudgetCoordinator":
        """Run :meth:`reconcile_once` every ``reconcile_ms`` on a daemon
        thread (the DCN-tier loop — deliberately slow; see docs/PERF.md
        for the sizing rule)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.reconcile_ms / 1000.0):
                try:
                    self.reconcile_once()
                except Exception:  # pragma: no cover - loop must survive
                    log.exception("hierarchy reconcile failed")

        self._thread = threading.Thread(
            target=_run, name="hier-reconcile", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    # -- introspection -------------------------------------------------------
    def outstanding_shares(self) -> int:
        """Σ live share tokens across every flow — the fleet's worst-case
        over-admission while the coordinator is dark (each pod keeps
        admitting at its last-granted share). The hier drill gates against
        exactly this number at SIGKILL time."""
        with self._lock:
            now = _clock.now_ms()
            total = 0
            for led in self._flows.values():
                self._sweep_locked(led, now)
                total += self._live_locked(led)
            return total

    def budget_of(self, flow_id: int) -> int:
        with self._lock:
            led = self._flows.get(int(flow_id))
            return led.budget.budget_tokens if led is not None else 0

    def budgets(self) -> Dict[int, int]:
        with self._lock:
            return {
                fid: led.budget.budget_tokens
                for fid, led in self._flows.items()
            }

    def stats(self) -> Dict[str, object]:
        with self._lock:
            now = _clock.now_ms()
            share_tokens: Dict[int, int] = {}
            n_shares = 0
            for fid, led in self._flows.items():
                self._sweep_locked(led, now)
                share_tokens[fid] = self._live_locked(led)
                n_shares += len(led.shares)
            out: Dict[str, object] = dict(self._stats)
            out["outstanding_shares"] = n_shares
            out["outstanding_share_tokens"] = sum(share_tokens.values())
            out["share_tokens"] = share_tokens
            out["budget_tokens"] = {
                fid: led.budget.budget_tokens
                for fid, led in self._flows.items()
            }
            out["targets"] = {
                fid: dict(led.targets) for fid, led in self._flows.items()
            }
            return out

    # -- standby piggyback (rides the replication stream as JSON) ------------
    def export_doc(self) -> Dict[str, object]:
        with self._lock:
            return {
                "seq": self._seq,
                "flows": {
                    str(fid): {
                        "targets": dict(led.targets),
                        "demand": {
                            p: [r, t] for p, (r, t) in led.demand.items()
                        },
                        "shares": {
                            str(s.share_id): {
                                "pod": s.pod_id,
                                "tokens": int(s.tokens),
                                "granted_ms": int(s.granted_ms),
                                "expiry_ms": int(s.expiry_ms),
                            }
                            for s in led.shares.values()
                        },
                    }
                    for fid, led in self._flows.items()
                },
            }

    def import_doc(self, doc: Dict[str, object]) -> None:
        """Land a primary's ledger into THIS (standby) coordinator. Flows
        this coordinator wasn't configured with are ignored (budget config
        is deployment state, not replicated state)."""
        with self._lock:
            self._seq = max(self._seq, int(doc.get("seq", 1)))
            for fid_s, fdoc in (doc.get("flows") or {}).items():
                led = self._flows.get(int(fid_s))
                if led is None:
                    continue
                led.targets = {
                    str(p): int(t)
                    for p, t in (fdoc.get("targets") or {}).items()
                }
                led.demand = {
                    str(p): (float(v[0]), int(v[1]))
                    for p, v in (fdoc.get("demand") or {}).items()
                }
                led.shares = {}
                for sid_s, sdoc in (fdoc.get("shares") or {}).items():
                    sid = int(sid_s)
                    led.shares[sid] = _Share(
                        sid, int(fid_s),
                        sdoc.get("pod"), int(sdoc["tokens"]),
                        int(sdoc["granted_ms"]), int(sdoc["expiry_ms"]),
                    )


class PodShareAgent:
    """The pod-side half: one control-plane tick loop that (1) reports the
    pod's observed demand, (2) renews its share of every global flow, and
    (3) pins ``window_budget − share`` as the LEASED hold so local
    headroom equals the share. Decision-path cost: ZERO — nothing here
    runs per request, and the tick's wire work is a handful of frames
    every ``tick_ms``.

    ``endpoints`` is the coordinator endpoint list (primary + standbys);
    the agent walks it via :class:`~sentinel_tpu_torch.ha.failover.
    FailoverTokenClient` share ops, so coordinator failover needs no agent
    config change. ``client_cls(endpoints, timeout_ms=, deadline_ms=)``
    replaces that client: it needs ``share_op``, ``demand_report`` and
    ``close``. ``update_endpoints`` follows the shard map's
    ``global_flows`` section, epoch-fenced like every other route."""

    def __init__(
        self,
        service,
        endpoints: List[str],
        pod_id: str,
        flows,
        tick_ms: int = 100,
        timeout_ms: int = 50,
        deadline_ms: int = 200,
        client_cls=None,
    ):
        if client_cls is None:
            from sentinel_tpu_torch.ha.failover import FailoverTokenClient
            client_cls = FailoverTokenClient
        self._client_cls = client_cls
        self.service = service
        self.pod_id = str(pod_id)
        self.tick_ms = max(1, int(tick_ms))
        self.timeout_ms = max(1, int(timeout_ms))
        self.deadline_ms = max(self.timeout_ms, int(deadline_ms))
        self._flow_ids = [int(getattr(b, "flow_id", b)) for b in flows]
        self._lock = threading.Lock()
        self._endpoints = list(endpoints)
        self._epoch = -1
        self._client = self._make_client(self._endpoints)
        # per-flow: last-granted (share_id, tokens); tokens survives
        # coordinator silence — degrade-to-last-share
        self._shares: Dict[int, Tuple[int, int]] = {
            fid: (0, 0) for fid in self._flow_ids
        }
        self._stats = {
            "agent_ticks": 0, "agent_rpcs": 0, "agent_report_fail": 0,
            "agent_renew_fail": 0, "agent_degraded": 0,
        }
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        service.attach_share_agent(self)

    @staticmethod
    def _parse_endpoint(ep):
        if isinstance(ep, (tuple, list)):
            return (str(ep[0]), int(ep[1]))
        host, _, port = str(ep).rpartition(":")
        return (host, int(port))

    def _make_client(self, endpoints: List[str]):
        return self._client_cls(
            [self._parse_endpoint(e) for e in endpoints],
            timeout_ms=self.timeout_ms, deadline_ms=self.deadline_ms,
        )

    def update_endpoints(self, endpoints: List[str], epoch: int) -> bool:
        """Follow a shard-map ``global_flows`` update. Epoch-fenced: a
        stale map (epoch ≤ last applied) is a no-op, same contract as
        routing. Returns True when the client was rebuilt."""
        with self._lock:
            if int(epoch) <= self._epoch:
                return False
            self._epoch = int(epoch)
            if list(endpoints) == self._endpoints:
                return True
            old, self._client = self._client, self._make_client(
                list(endpoints)
            )
            self._endpoints = list(endpoints)
        try:
            old.close()
        except Exception:  # pragma: no cover - retired client teardown
            pass
        return True

    def apply_shard_map(self, shard_map) -> None:
        """Convenience hook for ``ShardMapPublisher.listen``: pull this
        agent's coordinator endpoints out of the map's ``global_flows``
        section (all this agent's flows share one coordinator; the first
        mapped flow wins)."""
        gf = getattr(shard_map, "global_flows", None) or {}
        for fid in self._flow_ids:
            ep = gf.get(str(fid)) or gf.get(fid)
            if ep:
                self.update_endpoints([ep], int(shard_map.epoch))
                return

    # -- the tick ------------------------------------------------------------
    def tick(self) -> None:
        """One control-plane pass: demand report → share renew → hold
        re-top. Each step tolerates coordinator silence independently; the
        hold re-top ALWAYS runs (it is what keeps a rotated-out hold
        pinned, whether or not the coordinator answered)."""
        with self._lock:
            client = self._client
        rates = self.service.demand_rates(self._flow_ids)
        entries = [
            (fid, self._shares.get(fid, (0, 0))[0],
             int(rates.get(fid, 0.0) * 1000))
            for fid in self._flow_ids
        ]
        self._stats["agent_rpcs"] += 1
        ack = client.demand_report(self.pod_id, entries)
        if ack is None:
            self._stats["agent_report_fail"] += 1
        degraded = 0
        for fid in self._flow_ids:
            share_id, last = self._shares.get(fid, (0, 0))
            budget = int(self.service.window_budget(fid))
            self._stats["agent_rpcs"] += 1
            rsp = client.share_op(
                P.MsgType.SHARE_RENEW if share_id
                else P.MsgType.SHARE_GRANT,
                fid, want=budget, share_id=share_id,
            )
            if rsp is not None and int(rsp.status) == _OK:
                self._shares[fid] = (int(rsp.lease_id), int(rsp.tokens))
            elif rsp is not None and int(rsp.status) == _NOT_LEASABLE:
                # authoritative refusal (flow not budgeted there): keep the
                # last share — config may be mid-rollout
                self._stats["agent_renew_fail"] += 1
                degraded = 1
            else:
                # coordinator dark: DEGRADE TO LAST SHARE. The old share id
                # is kept so the next successful renew reclaims it (and the
                # coordinator's ledger still counts it until TTL — which is
                # exactly what bounds fleet over-admission while dark).
                self._stats["agent_renew_fail"] += 1
                degraded = 1
            _, share = self._shares.get(fid, (0, 0))
            self.service.set_share_hold(fid, max(0, budget - share))
        self._stats["agent_degraded"] = degraded
        self._stats["agent_ticks"] += 1

    def start(self) -> "PodShareAgent":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.tick_ms / 1000.0):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - loop must survive
                    log.exception("share agent tick failed")

        self._thread = threading.Thread(
            target=_run, name="hier-share-agent", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, return_shares: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        if return_shares:
            with self._lock:
                client = self._client
            for fid, (share_id, _) in list(self._shares.items()):
                if share_id:
                    try:
                        client.share_op(
                            P.MsgType.SHARE_RETURN, fid, share_id=share_id
                        )
                    except Exception:  # pragma: no cover - best effort
                        pass
                self._shares[fid] = (0, 0)

    def close(self) -> None:
        self.stop()
        with self._lock:
            try:
                self._client.close()
            except Exception:  # pragma: no cover
                pass

    def shares(self) -> Dict[int, int]:
        """flow_id → last-granted share tokens."""
        return {fid: s for fid, (_, s) in self._shares.items()}

    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self._stats)
        out["share_tokens"] = self.shares()
        return out


# -- coordinator auto-election (rev-7: no configured single point) -----------
# The leader lock lives in the shard map's ``global_flows`` section under a
# key no flow id can collide with (flow keys are ``str(int(...))``;
# ``coordinator_of`` lookups therefore never read it). The lock value names
# the holder, its endpoint, and a wall-clock deadline — a lease, renewed by
# the leader and claimable by anyone after expiry. Claims are arbitrated by
# the SAME epoch fence MOVE uses: every claim is a next-epoch map through
# ``ShardMapPublisher.publish``, which admits exactly one map per epoch, so
# two pods racing for an expired lock can't both win — the loser's publish
# returns False and it stays a follower.
COORD_LOCK_KEY = "coordinator_lock"


def encode_coord_lock(pod_id: str, endpoint: str, deadline_ms: int) -> str:
    return f"{pod_id}|{endpoint}|{int(deadline_ms)}"


def decode_coord_lock(text) -> Optional[Tuple[str, str, int]]:
    """``(pod_id, endpoint, deadline_ms)`` or None for absent/malformed."""
    try:
        pod_id, endpoint, deadline = str(text).split("|")
        return pod_id, endpoint, int(deadline)
    except (ValueError, AttributeError):
        return None


class CoordinatorElection:
    """Auto-elects which pod hosts the :class:`GlobalBudgetCoordinator`.

    One instance per pod, ticking against a shared
    :class:`~sentinel_tpu_torch.cluster.rebalance.ShardMapPublisher`. The
    winner constructs and attaches a coordinator (``service.attach_hierarchy``),
    publishes a map whose ``global_flows`` points every budgeted flow at
    its own endpoint, and broadcasts that map as a ``SHARD_MAP_PUSH`` on
    every attached hub so agents and routing clients cut over within one
    RTT instead of a poll interval. A deposed or expired leader detaches.

    Failover needs no handshake: a freshly-elected coordinator starts with
    an empty ledger, agents' renews carry unknown share ids and degrade to
    plain grants (:meth:`GlobalBudgetCoordinator.share_renew`), and until
    then each pod admits at its last-granted share — the same
    Σ-outstanding-shares bound that holds while a coordinator is dark.
    """

    def __init__(
        self,
        service,
        publisher,
        pod_id: str,
        endpoint: str,
        budgets,
        lock_ttl_ms: int = 3000,
        tick_ms: int = 500,
        share_ttl_ms: int = 5000,
        reconcile_ms: int = 100,
        coordinator_factory=None,
        push_hubs=(),
    ):
        self.service = service
        self.publisher = publisher
        self.pod_id = str(pod_id)
        self.endpoint = str(endpoint)
        self.budgets = list(budgets)
        self.lock_ttl_ms = max(1, int(lock_ttl_ms))
        self.tick_ms = max(1, int(tick_ms))
        self._factory = coordinator_factory or (
            lambda: GlobalBudgetCoordinator(
                self.budgets, share_ttl_ms=share_ttl_ms,
                reconcile_ms=reconcile_ms,
            )
        )
        self.push_hubs = list(push_hubs)
        self.coordinator: Optional[GlobalBudgetCoordinator] = None
        self.is_leader = False
        self._lock = threading.Lock()
        self._stats = {
            "elections_won": 0, "lock_renewals": 0, "depositions": 0,
            "claim_lost": 0,
        }
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lock plumbing -------------------------------------------------------
    def _current_lock(self, shard_map, now: int):
        """The LIVE lock holder tuple, or None (absent/expired/torn)."""
        lock = decode_coord_lock(
            (shard_map.global_flows or {}).get(COORD_LOCK_KEY)
        )
        if lock is None or now >= lock[2]:
            return None
        return lock

    def _publish_claim(self, shard_map, now: int) -> bool:
        """Next-epoch map: our lock + every budgeted flow pointed at our
        endpoint. The publisher's epoch fence arbitrates racing claims."""
        g = dict(shard_map.global_flows or {})
        g[COORD_LOCK_KEY] = encode_coord_lock(
            self.pod_id, self.endpoint, now + self.lock_ttl_ms
        )
        for b in self.budgets:
            g[str(int(b.flow_id))] = self.endpoint
        nxt = type(shard_map)(
            int(shard_map.epoch) + 1, dict(shard_map.endpoint_of), g
        )
        return bool(self.publisher.publish(nxt))

    def _push_map(self) -> None:
        """Broadcast the published map on every hub (SHARD_MAP_PUSH) so
        live clients learn the election outcome within one RTT. Best
        effort — the publisher's listener plane is the polling fallback."""
        if not self.push_hubs:
            return
        from sentinel_tpu_torch.cluster.rebalance import encode_shard_map_doc

        try:
            doc = encode_shard_map_doc(self.publisher.current())
        except Exception:  # pragma: no cover - doc encode must not kill tick
            return
        for hub in self.push_hubs:
            try:
                hub.push_shard_map(doc)
            except Exception:
                pass

    # -- leadership transitions ---------------------------------------------
    def _ensure_leader(self) -> None:
        with self._lock:
            if self.is_leader:
                return
            self.coordinator = self._factory()
            self.is_leader = True
            self._stats["elections_won"] += 1
        self.service.attach_hierarchy(self.coordinator)
        log.info("pod %s won coordinator election (%s)",
                 self.pod_id, self.endpoint)
        self._push_map()

    def _ensure_follower(self) -> None:
        with self._lock:
            if not self.is_leader:
                return
            coord, self.coordinator = self.coordinator, None
            self.is_leader = False
            self._stats["depositions"] += 1
        if self.service.hierarchy is coord:
            self.service.hierarchy = None
        if coord is not None:
            coord.stop()
        log.info("pod %s deposed as coordinator", self.pod_id)

    # -- the tick ------------------------------------------------------------
    def tick(self) -> bool:
        """One election pass; returns True while this pod leads. A live
        foreign lock → follow. Our lock → renew when less than half the
        TTL remains (each renewal is a next-epoch publish). Absent or
        expired lock → claim; the epoch fence picks exactly one winner."""
        now = _clock.now_ms()
        shard_map = self.publisher.current()
        lock = self._current_lock(shard_map, now)
        if lock is not None and lock[0] != self.pod_id:
            self._ensure_follower()
            return False
        if lock is not None:
            # ours and live: renew before it can lapse mid-tick-period
            if lock[2] - now < self.lock_ttl_ms / 2:
                if self._publish_claim(shard_map, now):
                    self._stats["lock_renewals"] += 1
            self._ensure_leader()
            return True
        if self._publish_claim(shard_map, now):
            self._ensure_leader()
            return True
        # lost the race to a concurrent claimant; learn the winner next tick
        self._stats["claim_lost"] += 1
        self._ensure_follower()
        return False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "CoordinatorElection":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.tick_ms / 1000.0):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - loop must survive
                    log.exception("coordinator election tick failed")

        self._thread = threading.Thread(
            target=_run, name="hier-election", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """Graceful exit: stop ticking, step down, and (by default) publish
        a lock release so the next claimant needn't wait out the TTL."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        was_leader = self.is_leader
        self._ensure_follower()
        if release and was_leader:
            shard_map = self.publisher.current()
            lock = decode_coord_lock(
                (shard_map.global_flows or {}).get(COORD_LOCK_KEY)
            )
            if lock is not None and lock[0] == self.pod_id:
                g = dict(shard_map.global_flows)
                g.pop(COORD_LOCK_KEY, None)
                self.publisher.publish(type(shard_map)(
                    int(shard_map.epoch) + 1,
                    dict(shard_map.endpoint_of), g,
                ))
                self._push_map()

    def hard_stop(self) -> None:
        """Drill stand-in for SIGKILL: the pod vanishes WITHOUT releasing
        the lock or detaching anything cleanly — survivors must wait out
        the lock TTL, exactly like a real crash."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        coord = self.coordinator
        if coord is not None:
            coord.stop()

    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self._stats)
        out["is_leader"] = self.is_leader
        out["pod_id"] = self.pod_id
        return out
