"""The flow side of the plain reference: Sentinel's cluster flow check as a
NumPy model, replayed over what a run served.

The model is written from the upstream semantics:

- ``LeapArray``: a ring of ``n_buckets`` buckets of ``bucket_ms`` with one
  start a bucket. A bucket counts while ``0 <= now - start < interval``; a
  bucket taken for a new start is cleared first (:class:`Ring`).
- ``GlobalRequestLimiter.tryPass``: a request of a namespace passes while
  the namespace's window count + 1 <= ``maxAllowedQps`` x interval s, and a
  passed request is counted. A request refused here is TOO_MANY_REQUEST.
- ``ClusterFlowChecker.acquireClusterToken``: a request passes while the
  flow's window PASS + acquire <= count x ``exceedCount`` x interval s
  (GLOBAL threshold mode), and its acquire is counted as PASS.
- ``WarmUpController``: ``warningToken``, ``maxToken``, ``slope`` and the
  cold rate ``count / coldFactor`` from the rule; stored tokens refill at
  ``count`` a second while below ``warningToken`` (or above it while the
  pass rate is under the cold rate), lose what passed, and at or above
  ``warningToken`` the rate is ``1 / (above x slope + 1 / count)``.
- ``RateLimiterController``: each request costs ``1000 x acquire / rate``
  ms after the latest passed time; it passes at once if that lies in the
  past (the latest passed time becomes now), waits if it lies within the
  queue, and is refused beyond.

Where the port states a choice of its own, the model takes it:

- a step's requests all read one engine millisecond and see the state as
  the step found it plus the step's earlier requests; the service takes a
  frame's rows in the order of their rule slots (slots in rule load order),
  a flow's rows in arrival order;
- a paced request that waits is counted in the occupy ring's bucket that
  holds ``now + wait`` (one to ``n_buckets - 1`` buckets ahead), and the
  threshold check counts that ring's matured buckets with PASS; the queue
  is capped at ``(n_buckets - 1) x bucket_ms``;
- the warm-up curve runs in float32: tokens are floats, synced once a
  second from the current window's pass rate, the rate's denominator is one
  fused multiply-add and no ``nextUp`` follows; ``slope`` is stored as the
  float32 quotient of float32 operands; a paced cost is rounded half to
  even;
- an admitted request's ``remaining`` is the threshold less the window,
  the flow's earlier admissions in the step and its own acquire, truncated;
  blocked and paced answers carry 0.

Out of the model, because no cell sends them: prioritized requests (the
occupy borrow), mixed acquires within one step (the port refines those
iteratively), AVG_LOCAL thresholds over more than one connected client,
breakers and leases. The model refuses a step that needs them.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

NEVER = -(2**30)
OK, BLOCKED, SHOULD_WAIT, NO_RULE_EXISTS, TOO_MANY_REQUEST = 0, 1, 2, 3, 4
WARM_UP, RATE_LIMITER, WARM_UP_RATE_LIMITER = 1, 2, 3
F32 = np.float32


class Ring:
    """A ``LeapArray`` over ``rows`` resources: ``counts[rows, n_buckets]``
    and one start a bucket, shared by the rows."""

    def __init__(self, rows: int, bucket_ms: int, n_buckets: int):
        self.bucket_ms, self.n = bucket_ms, n_buckets
        self.interval = bucket_ms * n_buckets
        self.counts = np.zeros((rows, n_buckets), np.int64)
        self.starts = np.full(n_buckets, NEVER, np.int64)

    def sums(self, now: int, rows: np.ndarray) -> np.ndarray:
        """Each of ``rows``' count over the buckets inside the window."""
        age = now - self.starts
        inside = ((age >= 0) & (age < self.interval)).astype(np.int64)
        return self.counts[rows] @ inside

    def add(self, start: int, rows: np.ndarray, values) -> None:
        """Count ``values`` at ``rows`` in the bucket that starts at
        ``start``."""
        i = (start // self.bucket_ms) % self.n
        if self.starts[i] != start:
            self.counts[:, i] = 0
            self.starts[i] = start
        np.add.at(self.counts[:, i], rows, values)


def earlier_same(keys: np.ndarray) -> np.ndarray:
    """For each position, how many earlier positions hold the same key."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    pos = np.arange(k.size)
    first = np.ones(k.size, bool)
    first[1:] = k[1:] != k[:-1]
    out = np.empty(k.size, np.int64)
    out[order] = pos - np.maximum.accumulate(np.where(first, pos, 0))
    return out


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` of float32 operands with one rounding to float32: the
    float64 product is exact, and the float64 sum rounded to odd rounds
    correctly to float32 (Boldo and Melquiond)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(F32)


class FlowModel:
    """The token server's flow decisions over rule slots ``0..F-1``.

    ``count``, ``behavior`` and ``namespace`` are the rules' columns in load
    order (the slot is the position); warm-up and pacing take Sentinel's
    defaults (warm-up 10 s, cold factor 3, queue 500 ms), as the
    configuration's rules do."""

    def __init__(self, engine: dict, count, behavior, namespace,
                 ns_max_qps: float, exceed_count: float = 1.0,
                 warm_up_s: int = 10, cold_factor: int = 3,
                 max_queue_ms: int = 500):
        bucket, nb = int(engine["bucket_ms"]), int(engine["n_buckets"])
        self.bucket_ms, self.n_buckets = bucket, nb
        self.interval_s = F32(bucket * nb / 1000.0)
        self.per_s = F32(1000.0 / (bucket * nb))
        f = len(count)
        self.count = np.asarray(count, F32)
        self.behavior = np.asarray(behavior, np.int64)
        _, self.ns_of = np.unique(np.asarray(namespace), return_inverse=True)
        self.ns_budget = float(F32(ns_max_qps) * self.interval_s)
        self.exceed = F32(exceed_count)
        c = np.maximum(self.count.astype(np.float64), 1e-6)
        warn = np.floor(warm_up_s * c / (cold_factor - 1))
        max_tok = np.floor(warn + 2.0 * warm_up_s * c / (1.0 + cold_factor))
        self.warn = warn.astype(F32)
        self.max_token = max_tok.astype(F32)
        self.slope = (((cold_factor - 1.0) / c).astype(F32)
                      / np.maximum(1, self.max_token - self.warn)).astype(F32)
        self.cold = (np.floor(c) // cold_factor).astype(F32)
        self.max_queue = F32(min(max_queue_ms, (nb - 1) * bucket))
        self.flow = Ring(f, bucket, nb)  # PASS
        self.occupy = Ring(f, bucket, nb)  # paced requests that wait
        self.ns = Ring(int(self.ns_of.max()) + 1 if f else 1, bucket, nb)
        self.tokens = np.zeros(f, F32)
        self.filled = np.full(f, NEVER, np.int64)
        self.latest = np.full(f, NEVER, np.int64)
        # the control: every write dropped, so no window, queue, token
        # store or namespace counter ever moves
        self.frozen = False

    def _warm_up(self, flows, passed, now: int) -> np.ndarray:
        """The warm-up rate of ``flows`` at ``now``, syncing their stored
        tokens once a second."""
        cnt = self.count[flows]
        cnt_safe = np.maximum(cnt, F32(1e-6))
        warn, tok = self.warn[flows], self.tokens[flows]
        pass_qps = passed.astype(F32) * self.per_s
        sec = now - now % 1000
        refill = (tok < warn) | ((tok > warn)
                                 & (pass_qps < self.cold[flows]))
        elapsed = (sec - self.filled[flows]).astype(F32)
        cooled = np.minimum(
            tok + np.where(refill, elapsed * cnt_safe * F32(0.001), F32(0)),
            self.max_token[flows])
        sync = sec > self.filled[flows]
        tok = np.where(sync, np.maximum(cooled - pass_qps, F32(0)), tok)
        if not self.frozen:
            self.tokens[flows[sync]] = tok[sync]
            self.filled[flows[sync]] = sec
        above = np.maximum(tok - warn, F32(0))
        rate = F32(1) / fma32(above, self.slope[flows], F32(1) / cnt_safe)
        return np.where(tok >= warn, rate, cnt).astype(F32)

    def frame(self, slot: np.ndarray, acq: np.ndarray, prio: np.ndarray,
              now: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decide one engine frame, its rows in the service's order (``-1``
        for no rule): ``(status, remaining, wait)``."""
        n = slot.size
        status = np.full(n, NO_RULE_EXISTS, np.int8)
        remaining = np.zeros(n, np.int32)
        wait = np.zeros(n, np.int32)
        rows = np.flatnonzero(slot >= 0)
        if rows.size == 0:
            return status, remaining, wait
        if prio[rows].any():
            raise NotImplementedError("prioritized requests are not modelled")
        a = int(acq[rows[0]])
        if (acq[rows] != a).any():
            raise NotImplementedError("mixed acquires in one step")
        s = slot[rows]
        bucket_start = now - now % self.bucket_ms

        # the namespace guard, in the service's row order
        ns = self.ns_of[s]
        already = self.ns.sums(now, np.arange(self.ns.counts.shape[0]))
        ok = already[ns] + earlier_same(ns) + 1 <= self.ns_budget
        status[rows] = TOO_MANY_REQUEST
        rows, s = rows[ok], s[ok]

        flows, inv = np.unique(s, return_inverse=True)
        rank = earlier_same(s)  # the flow's earlier requests in the step
        passed = self.flow.sums(now, flows) + self.occupy.sums(now, flows)
        beh = self.behavior[flows]
        qps = self.count[flows].copy()
        warm = (beh == WARM_UP) | (beh == WARM_UP_RATE_LIMITER)
        if warm.any():
            qps[warm] = self._warm_up(flows[warm], passed[warm], now)
        rate = qps * self.exceed
        threshold = rate * self.interval_s
        paced = ((beh == RATE_LIMITER) | (beh == WARM_UP_RATE_LIMITER))[inv]

        # the window check
        thr, p = threshold[inv], passed[inv]
        admit = ~paced & (p + rank * a + a <= thr.astype(np.float64))
        left = ((thr - p.astype(F32)) - (rank * a).astype(F32)) - F32(a)
        remaining[rows] = np.where(
            admit, np.clip(left, F32(0), F32(2**30)).astype(np.int32), 0)

        # pacing: the flow's queue after its earlier requests in the step
        cost = np.round(F32(1000 * a) / np.maximum(rate, F32(1e-6)))
        since = np.maximum(self.latest[flows] - now, -(2**20)).astype(F32)
        c = cost[inv]
        due = np.maximum(since, -cost)[inv] + (rank.astype(F32) * c + c)
        queued = paced & (due <= self.max_queue)
        waits = np.maximum(due, F32(0)).astype(np.int64)
        now_ok = queued & (waits == 0)
        later = queued & (waits > 0)

        status[rows] = np.where(admit | now_ok, OK,
                                np.where(later, SHOULD_WAIT, BLOCKED))
        wait[rows] = np.where(later, waits, 0)
        if self.frozen:
            return status, remaining, wait

        np.maximum.at(self.latest, s[queued],
                      np.round(due[queued]).astype(np.int64) + now)
        passing = admit | now_ok
        self.flow.add(bucket_start, s[passing], a)
        ahead = np.clip((now + waits[later] - bucket_start) // self.bucket_ms,
                        1, self.n_buckets - 1)
        for k in np.unique(ahead):
            self.occupy.add(bucket_start + int(k) * self.bucket_ms,
                            s[later][ahead == k], a)
        self.ns.add(bucket_start, ns[ok], 1)
        return status, remaining, wait


def serve_buckets(batch_size: int) -> List[int]:
    """The service's padded frame sizes: 64, 256, 1024, ... below
    ``batch_size``, and ``batch_size``."""
    out, b = [], 64
    while b < batch_size:
        out.append(b)
        b *= 4
    return sorted(set(out) | {batch_size})


class FlowReplay:
    """What a run's one device lane issued, dispatch by dispatch, through
    :class:`FlowModel`, with the service's batching: a dispatch above one
    engine frame folds greedily over the fuse ladder into chains of full
    frames that share one engine ms; the rest go one frame at a time, each
    padded to the smallest serve bucket that holds it. Rows are mapped to
    rule slots by the rules' load order."""

    def __init__(self, model: FlowModel, flow_ids: np.ndarray,
                 batch_size: int, fuse_depths: Sequence[int]):
        self.model = model
        self.batch_size = int(batch_size)
        self.buckets = serve_buckets(self.batch_size)
        self.ladder = tuple(sorted({int(d) for d in fuse_depths if d >= 2},
                                   reverse=True))
        flow_ids = np.asarray(flow_ids, np.int64)
        if flow_ids.size and (flow_ids.min() < 0
                              or flow_ids.max() > 16 * flow_ids.size):
            raise ValueError("the replay's lookup wants small flow ids")
        self.slot_of = np.full(int(flow_ids.max()) + 1 if flow_ids.size
                               else 0, -1, np.int64)
        self.slot_of[flow_ids] = np.arange(flow_ids.size)
        # per engine frame decided: (rows touched, segment tails, whether
        # the window rolled, padded rows), the decide byte model's inputs
        self.stats: List[Tuple[int, int, bool, int]] = []
        self._last_bucket = None

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        inside = (ids >= 0) & (ids < self.slot_of.size)
        return np.where(inside, self.slot_of[np.where(inside, ids, 0)], -1)

    def _note(self, slots_sorted: np.ndarray, n_cap: int, now: int) -> None:
        """The frame's byte-model inputs: distinct flow rows read (padding
        and no-rule rows read slot 0) and distinct flows (one tail each)."""
        live = slots_sorted[slots_sorted >= 0]
        tails = int(live.size and 1 + np.count_nonzero(live[1:] != live[:-1]))
        touched = tails + int(live.size < n_cap
                              and not (live.size and live[0] == 0))
        idx = (now // self.model.bucket_ms) % self.model.n_buckets
        rolled = self._last_bucket is not None and idx != self._last_bucket
        self._last_bucket = idx
        self.stats.append((touched, tails, bool(rolled), int(n_cap)))

    def _frame(self, ids, acq, prio, n_cap: int, now: int):
        slots = self.lookup(ids)
        order = np.argsort(slots, kind="stable")
        self._note(slots[order], n_cap, now)
        out = self.model.frame(slots[order], acq[order], prio[order], now)
        back = []
        for v in out:
            r = np.empty_like(v)
            r[order] = v
            back.append(r)
        return back

    def _split(self, n: int):
        """``(start, depth)`` of each fused chain, then ``(start, 1)`` of
        each single frame, as the service splits ``n`` rows."""
        cap, pos = self.batch_size, 0
        if n > cap:
            while self.ladder and (n - pos) // cap >= self.ladder[-1]:
                depth = next(d for d in self.ladder if d <= (n - pos) // cap)
                yield pos, depth
                pos += depth * cap
        for i in range(pos, n, cap):
            yield i, 1

    def steps_of(self, n: int) -> int:
        """Device steps (engine clock reads) a dispatch of ``n`` rows
        takes."""
        return sum(1 for _ in self._split(n))

    def dispatch(self, ids: np.ndarray, acq: np.ndarray, prio: np.ndarray,
                 nows: Iterator[int]) -> Tuple[np.ndarray, ...]:
        """``(status int8, remaining int32, wait int32)`` in request order
        for one dispatch; ``nows`` yields each device step's engine ms."""
        cap, parts = self.batch_size, []
        for start, depth in self._split(ids.shape[0]):
            now = int(next(nows))
            if depth > 1:
                for f in range(start, start + depth * cap, cap):
                    sl = slice(f, f + cap)
                    parts.append(self._frame(ids[sl], acq[sl], prio[sl],
                                             cap, now))
                continue
            sl = slice(start, min(start + cap, ids.shape[0]))
            m = sl.stop - sl.start
            bucket = next(b for b in self.buckets if m <= b)
            parts.append(self._frame(ids[sl], acq[sl], prio[sl], bucket, now))
        return tuple(np.concatenate(p) for p in zip(*parts))
