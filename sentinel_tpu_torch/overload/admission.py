"""BBR-style admission control with a brownout ladder for the token server.

The port's copy of ``sentinel_tpu/overload/admission.py``.

The reference protects a node with ``SystemSlot``'s BBR gate
(``SystemRuleManager.java:334-340``, mirrored in
``local/system_adaptive.py:_check_bbr``): under pressure, keep admitting
while ``concurrency <= maxSuccessQps * minRt``. That inequality is Little's
law — the left side is work in the system, the right side is the
bandwidth-delay product (BDP) the pipeline can actually hold. Anything
beyond the BDP only sits in queues, inflating every request's latency
without adding throughput, which is precisely the state an overloaded
token server must refuse instead of absorb.

This module applies the same estimator to the *serving pipeline* using the
signals :mod:`sentinel_tpu_torch.metrics.server` already collects:

- **throughput** — the windowed verdicts/sec rate (``verdict_rate``),
- **minRt** — the decide-stage p50 (``decide_ms`` histogram), floored so a
  sub-100µs CPU step can't collapse the BDP to zero,
- **concurrency** — requests admitted by the front door and not yet
  answered, counted by the server via ``note_enqueued``/``note_done``.

The verdict is a **brownout level**, re-evaluated at most every
``recheck_ms`` so the hot path never pays for the histogramming:

``NORMAL``
    inflight within ``headroom_shed × BDP`` — admit everything.
``SHED_LOW``
    inflight beyond it — shed the lowest-priority rows first (answered
    with ``OVERLOAD`` + a retry hint), prioritized rows still reach the
    device. The reference's priority semantics, applied to survival.
``DEGRADE``
    inflight beyond ``headroom_degrade × BDP`` — the device is no longer
    consulted at all; the server answers locally, admitting a probabilistic
    fraction (``BDP / inflight``) with ``OK`` and refusing the rest with
    ``OVERLOAD``. Cheap, bounded, and it keeps the answer rate pinned to
    what the pipeline can actually sustain until the backlog drains.

Every decision is an *answer*, never silence — the client-side failover
breaker treats ``OVERLOAD`` as "alive, back off" (``ha/failover.py``), so a
browning-out server is not evicted from rotation.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.metrics.server import ServerMetrics, server_metrics

KEY_ENABLED = "sentinel.tpu.overload.enabled"
KEY_HEADROOM_SHED = "sentinel.tpu.overload.headroom.shed"
KEY_HEADROOM_DEGRADE = "sentinel.tpu.overload.headroom.degrade"
KEY_MIN_BDP = "sentinel.tpu.overload.min.bdp"
KEY_RECHECK_MS = "sentinel.tpu.overload.recheck.ms"
KEY_SUSTAIN_MS = "sentinel.tpu.overload.sustain.ms"
# per-namespace guaranteed shares for weighted shedding, e.g.
# "tenant-a=0.25,tenant-b=0.25" (fractions of each shed batch)
KEY_SHARES = "sentinel.tpu.overload.shares"


def parse_shares(spec: str) -> Dict[str, float]:
    """``"a=0.25,b=0.5"`` → ``{"a": 0.25, "b": 0.5}``; malformed entries
    are dropped, negatives clamped to 0 (a bad knob must not crash the
    door's shed path)."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if not name:
            continue
        try:
            out[name] = max(0.0, float(val))
        except ValueError:
            continue
    return out


class BrownoutLevel(enum.IntEnum):
    NORMAL = 0
    SHED_LOW = 1  # shed non-prioritized rows, serve the rest
    DEGRADE = 2  # probabilistic local answers, no device dispatch


@dataclass
class OverloadConfig:
    """Knobs for the admission controller (all config-overridable).

    The defaults are deliberately conservative: a closed-loop client fleet
    in steady state sits at inflight ≈ 1–4 × BDP (pipelining), so the shed
    ladder only engages on a genuine open-loop backlog.
    """

    enabled: bool = True
    headroom_shed: float = 8.0
    headroom_degrade: float = 32.0
    # BDP floor in requests: below this the estimator has too little signal
    # (cold server, idle rate window) to justify shedding anything
    min_bdp: float = 1024.0
    # decide-p50 floor: a sub-50µs CPU step must not zero the BDP
    min_rt_floor_ms: float = 0.05
    recheck_ms: float = 25.0
    # the over-threshold condition must hold THIS long before the ladder
    # escalates: a healthy pipeline absorbing a burst spikes past the BDP
    # headroom for tens of ms while draining fine — only a backlog that
    # *stays* means the pipeline is genuinely behind
    sustain_ms: float = 500.0
    # wait_ms hint carried on OVERLOAD verdicts (client backoff guidance)
    retry_hint_ms: int = 5
    # rebalance advisories: when sustained pressure engages the ladder, name
    # the hottest namespaces (by verdict rate since the last advisory) so an
    # operator — or an automated rebalancer — knows what to move off this
    # server. Rate-limited; 0 disables.
    advise_top_n: int = 3
    advise_interval_ms: float = 5_000.0
    # per-namespace guaranteed shares (fraction of each shed batch a tenant
    # keeps before the ladder touches it); empty → legacy whole-class shed.
    # Tenants absent from the map get ``ns_default_share``.
    ns_shares: Dict[str, float] = field(default_factory=dict)
    ns_default_share: float = 0.0

    @classmethod
    def from_config(cls) -> "OverloadConfig":
        return cls(
            enabled=SentinelConfig.get_bool(KEY_ENABLED, True),
            headroom_shed=SentinelConfig.get_float(KEY_HEADROOM_SHED, 8.0),
            headroom_degrade=SentinelConfig.get_float(
                KEY_HEADROOM_DEGRADE, 32.0
            ),
            min_bdp=SentinelConfig.get_float(KEY_MIN_BDP, 1024.0),
            recheck_ms=SentinelConfig.get_float(KEY_RECHECK_MS, 25.0),
            sustain_ms=SentinelConfig.get_float(KEY_SUSTAIN_MS, 500.0),
            ns_shares=parse_shares(SentinelConfig.get(KEY_SHARES, "") or ""),
        )


class AdmissionController:
    """BBR admission gate shared by a server's front-door lanes.

    Thread-safe; one instance per server (both front doors construct a
    default one). The level read is a cached attribute outside the
    re-evaluation window, so per-batch cost is O(1).
    """

    def __init__(
        self,
        config: Optional[OverloadConfig] = None,
        metrics: Optional[ServerMetrics] = None,
        seed: Optional[int] = None,
    ):
        self.config = config or OverloadConfig.from_config()
        self._m = metrics if metrics is not None else server_metrics()
        self._lock = threading.Lock()
        self._inflight = 0
        self._level = BrownoutLevel.NORMAL
        self._admit_frac = 1.0
        self._next_eval = 0.0
        self._over_since: Optional[float] = None
        self._rng = random.Random(seed)
        # rebalance advisories (cluster.rebalance): last advice emitted, a
        # baseline of per-namespace verdict totals to diff rates against,
        # and an optional listener (e.g. a controller that triggers a move)
        self.last_advice: Optional[dict] = None
        self.on_advice = None
        self._ns_baseline: dict = {}
        self._next_advise = 0.0
        # brownout level-change listener (rev-7 push plane): called with
        # (level_int, retry_hint_ms) on EVERY transition — escalations so
        # clients can pre-back-off before their next refusal, recoveries
        # so they stop. Same contract as on_advice: best-effort, must not
        # raise into the gate.
        self.on_level_change = None

    # -- inflight accounting (front doors call these) -----------------------
    def note_enqueued(self, n: int) -> None:
        with self._lock:
            self._inflight += int(n)

    def note_done(self, n: int) -> None:
        with self._lock:
            self._inflight -= int(n)
            if self._inflight < 0:  # lost accounting must not wedge shedding
                self._inflight = 0

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def retry_hint_ms(self) -> int:
        return self.config.retry_hint_ms

    # -- the gate -----------------------------------------------------------
    def level(self, now: Optional[float] = None) -> BrownoutLevel:
        if not self.config.enabled:
            return BrownoutLevel.NORMAL
        if now is None:
            now = time.monotonic()
        if now >= self._next_eval:  # racy read is fine; eval is idempotent
            self._evaluate(now)
        return self._level

    def _evaluate(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            self._next_eval = now + cfg.recheck_ms / 1000.0
            inflight = self._inflight
        bdp = self.estimated_bdp()
        if inflight > bdp * cfg.headroom_degrade:
            level = BrownoutLevel.DEGRADE
        elif inflight > bdp * cfg.headroom_shed:
            level = BrownoutLevel.SHED_LOW
        else:
            level = BrownoutLevel.NORMAL
        # escalation needs SUSTAINED pressure (a draining burst recovers
        # before the window elapses); recovery is immediate
        if level is BrownoutLevel.NORMAL:
            self._over_since = None
        else:
            if self._over_since is None:
                self._over_since = now
            if (now - self._over_since) * 1000.0 < cfg.sustain_ms:
                level = BrownoutLevel.NORMAL
        with self._lock:
            prev = self._level
            self._level = level
            self._admit_frac = (
                min(1.0, bdp / inflight) if inflight > 0 else 1.0
            )
        if level is not BrownoutLevel.NORMAL:
            # the ladder engaged on SUSTAINED pressure: this server is
            # genuinely behind, so advise which namespaces to move away
            self._maybe_advise(now, level)
            if level.value > prev.value:
                # escalation: freeze the flight-recorder evidence while
                # the window leading INTO the brownout is still in the
                # rings
                from sentinel_tpu_torch.trace import blackbox as _blackbox
                from sentinel_tpu_torch.trace import ring as _TR

                if _TR.ARMED:
                    _TR.record(_TR.BROWNOUT, aux=int(level.value))
                _blackbox.maybe_dump(f"brownout:{level.name.lower()}")
        if level is not prev:
            listener = self.on_level_change
            if listener is not None:
                try:
                    listener(int(level), self.config.retry_hint_ms)
                except Exception:
                    pass

    def _maybe_advise(self, now: float, level: BrownoutLevel) -> None:
        """Emit a ``rebalance-advise`` event naming the hottest namespaces
        (by verdict rate since the last advisory). Rate-limited to
        ``advise_interval_ms``; consumed via :attr:`last_advice`, the
        optional :attr:`on_advice` listener, and the HA metrics surface."""
        cfg = self.config
        if cfg.advise_top_n <= 0 or now < self._next_advise:
            return
        self._next_advise = now + cfg.advise_interval_ms / 1000.0
        totals = self._m.verdict_totals_by_namespace()
        baseline, self._ns_baseline = self._ns_baseline, totals
        rates = sorted(
            (
                (ns, count - baseline.get(ns, 0))
                for ns, count in totals.items()
            ),
            key=lambda kv: kv[1], reverse=True,
        )
        hottest = [
            {"namespace": ns, "verdicts": int(delta)}
            for ns, delta in rates[: cfg.advise_top_n]
            if delta > 0
        ]
        if not hottest:
            return
        advice = {
            "level": level.name,
            "namespaces": hottest,
            "monotonicMs": int(now * 1000.0),
        }
        self.last_advice = advice
        from sentinel_tpu_torch.core.log import record_log
        from sentinel_tpu_torch.metrics.ha import ha_metrics

        ha_metrics().count_rebalance("advise")
        record_log.warning(
            "rebalance-advise: sustained %s pressure; hottest namespaces %s",
            level.name,
            ", ".join(
                f"{e['namespace']}={e['verdicts']}" for e in hottest
            ),
        )
        listener = self.on_advice
        if listener is not None:
            try:
                listener(advice)
            except Exception:
                record_log.exception("rebalance-advise listener failed")

    def estimated_bdp(self) -> float:
        """max(rate × minRt, floor) — requests the pipeline can hold."""
        cfg = self.config
        rate = self._m.verdict_rate()
        min_rt = max(
            self._m.decide_ms.snapshot()["p50"] or 0.0, cfg.min_rt_floor_ms
        )
        return max(rate * min_rt / 1000.0, cfg.min_bdp)

    # -- brownout verdict helpers ------------------------------------------
    def set_shares(self, shares: Optional[Dict[str, float]]) -> None:
        """Install (or clear) per-namespace guaranteed shares for weighted
        ``SHED_LOW`` shedding. Scenario/ops entry point — rule loading
        does not set shares implicitly."""
        self.config.ns_shares = dict(shares) if shares else {}

    def shed_mask(self, prios, level: BrownoutLevel,
                  ns_idx=None, ns_names=()) -> np.ndarray:
        """bool[N] — True rows are refused with OVERLOAD at this level.

        ``SHED_LOW`` sheds the non-prioritized rows — *weighted by tenant
        share* when shares are configured and the caller supplies the
        batch's ``(ns_idx, ns_names)`` attribution (the
        ``TokenService.namespace_index`` shape both doors already
        compute): each tenant keeps a guaranteed ``ceil(share × N)`` rows
        of the batch; only its most recent non-prioritized rows beyond
        that are shed, and prioritized rows are never shed at this level,
        so a single flooding tenant browns itself out while in-share
        tenants ride through (the fairness gate's mechanism). Without
        shares (or without attribution) the legacy whole-class shed
        applies. ``DEGRADE`` sheds a random ``1 - admit_frac`` of ALL
        rows; the survivors get a local (device-free) answer from
        :meth:`degrade_verdicts`.
        """
        prios = np.asarray(prios, dtype=bool)
        if level == BrownoutLevel.SHED_LOW:
            shares = self.config.ns_shares
            if shares and ns_idx is not None and len(ns_names):
                return self._weighted_shed(
                    prios, np.asarray(ns_idx), tuple(ns_names), shares
                )
            return ~prios
        if level == BrownoutLevel.DEGRADE:
            with self._lock:
                frac = self._admit_frac
                if frac >= 1.0:
                    return np.zeros(prios.shape[0], dtype=bool)
                draws = np.array(
                    [self._rng.random() for _ in range(prios.shape[0])]
                )
            return draws >= frac
        return np.zeros(prios.shape[0], dtype=bool)

    def _weighted_shed(
        self,
        prios: np.ndarray,
        ns_idx: np.ndarray,
        ns_names,
        shares: Dict[str, float],
    ) -> np.ndarray:
        """Share-weighted SHED_LOW: per tenant, shed only the non-prio
        rows beyond ``ceil(share × N)``, newest-first (the tail of the
        batch arrived last; shedding it keeps the served prefix FIFO).
        Rows with no rule (``ns_idx < 0``) and tenants absent from the
        share map get ``ns_default_share`` (0 by default → legacy
        whole-class shed for them)."""
        n = prios.shape[0]
        shed = np.zeros(n, dtype=bool)
        default = self.config.ns_default_share
        for j in range(-1, len(ns_names)):
            rows = np.nonzero(ns_idx == j)[0]
            if rows.size == 0:
                continue
            share = shares.get(ns_names[j], default) if j >= 0 else default
            guaranteed = int(np.ceil(max(0.0, share) * n))
            excess = rows.size - guaranteed
            if excess <= 0:
                continue
            cand = rows[~prios[rows]]  # prioritized rows never shed here
            k = min(excess, cand.size)
            if k > 0:
                shed[cand[-k:]] = True
        return shed

    def degrade_verdicts(self, shed: np.ndarray):
        """(status, remaining, wait_ms) for a fully-local DEGRADE answer:
        admitted rows pass, shed rows get OVERLOAD + the retry hint."""
        from sentinel_tpu_torch.engine.decide import TokenStatus

        n = shed.shape[0]
        status = np.where(
            shed, np.int8(int(TokenStatus.OVERLOAD)), np.int8(int(TokenStatus.OK))
        ).astype(np.int8)
        remaining = np.zeros(n, np.int32)
        wait = np.where(shed, np.int32(self.config.retry_hint_ms), np.int32(0)).astype(
            np.int32
        )
        return status, remaining, wait

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "level": int(self._level),
                "levelName": self._level.name,
                "inflight": self._inflight,
                "admitFrac": round(self._admit_frac, 4),
                "estimatedBdp": round(self.estimated_bdp(), 1),
                "enabled": self.config.enabled,
                "nsShares": dict(self.config.ns_shares),
                "lastAdvice": self.last_advice,
            }
