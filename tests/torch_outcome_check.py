"""Seeded completion-report and circuit-breaker workload, shared by
``chip_smoke.py`` (the CUDA-kernel service against the torch-ops service at
100k flows) and ``tests/test_torch_breaker_service.py`` (the JAX service
against the port's at a small size).

Everything is made from a ``numpy.random.Generator`` and plain numpy; the
callers build each package's rule objects from the specs here.

- :func:`degrade_specs`: a breaker on every 10th flow id, strategies cycling
  SLOW_REQUEST_RATIO (threshold 0.5, ``slow_rt_ms`` 100), ERROR_RATIO (0.5)
  and ERROR_COUNT (20), each with ``min_request_amount`` 5,
  ``stat_interval_ms`` 1000 and ``recovery_timeout_ms`` 1000 (the
  reference's ``DegradeRule`` fields, with a short recovery so that cycles
  fit a run).
- :func:`is_sick`: a third of the breaker flows report mostly slow RTs and
  exceptions, so they trip, get probed, and their probes close or reopen.
- :func:`report_rows`: a report batch made of the rows a pull admitted,
  with about 1% invalid rows (negative, above the 60 s ceiling, an unknown
  flow, non-finite).
- :func:`drive`: the interleaved stream of pulls and reports over services
  that must agree, on manual clocks; :class:`BreakerEdges` counts the
  breaker transitions seen between consecutive ``breaker_stats()``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

BREAKER_EVERY = 10
SLOW_RT_MS = 100
RECOVERY_MS = 1000
# DegradeStrategy values, the same in both packages
SLOW_REQUEST_RATIO, ERROR_RATIO, ERROR_COUNT = 0, 1, 2
UNKNOWN_FLOW_BASE = 10**9  # ids no rule holds
OUTCOME_MAX_RT_MS = 60_000

OK = 0  # TokenStatus.OK


def degrade_specs(flow_ids: Sequence[int],
                  namespace_of: Callable[[int], str]) -> List[dict]:
    """Degrade-rule fields for every 10th flow id, by keyword."""
    specs = []
    for fid in flow_ids:
        if fid % BREAKER_EVERY:
            continue
        strategy = (fid // BREAKER_EVERY) % 3
        specs.append(dict(
            flow_id=int(fid),
            strategy=strategy,
            threshold=20.0 if strategy == ERROR_COUNT else 0.5,
            slow_rt_ms=SLOW_RT_MS,
            min_request_amount=5,
            stat_interval_ms=1000,
            recovery_timeout_ms=RECOVERY_MS,
            namespace=namespace_of(int(fid)),
        ))
    return specs


def is_sick(flow_ids: np.ndarray) -> np.ndarray:
    """A third of the breaker flows (every third breaker, by id)."""
    flow_ids = np.asarray(flow_ids, np.int64)
    return (flow_ids % BREAKER_EVERY == 0) & (
        (flow_ids // (BREAKER_EVERY * 3)) % 3 == 0)


def report_rows(rng: np.random.Generator, admitted: np.ndarray, n: int):
    """``(flow_ids int64[n], rt_ms float64[n], exceptions bool[n])``.

    Rows are the admitted ones in a random order, repeated to fill ``n``
    (every admitted request completes once before any twice, so an elected
    probe is reported whenever ``n`` covers the pull). Healthy flows answer
    in 1-89 ms with 2% exceptions; sick flows in 20-199 ms (55% above the
    100 ms cutoff) with 55% exceptions, above the 0.5 ratios, so they trip,
    and about half their probes close. About 1% of rows (at least one) are
    invalid, cycling negative, too large, unknown flow and non-finite."""
    admitted = np.asarray(admitted, np.int64)
    if admitted.size == 0:
        admitted = np.array([UNKNOWN_FLOW_BASE], np.int64)
    ids = np.resize(rng.permutation(admitted), n)
    sick = is_sick(ids)
    rt = np.where(sick, rng.integers(20, 200, n),
                  rng.integers(1, 90, n)).astype(np.float64)
    exc = np.where(sick, rng.random(n) < 0.55, rng.random(n) < 0.02)
    bad = rng.choice(n, size=max(1, n // 100), replace=False)
    for j, row in enumerate(bad):
        kind = j % 4
        if kind == 0:
            rt[row] = -float(rng.integers(1, 1000))
        elif kind == 1:
            rt[row] = float(OUTCOME_MAX_RT_MS + rng.integers(1, 10**6))
        elif kind == 2:
            ids[row] = UNKNOWN_FLOW_BASE + int(rng.integers(0, 1000))
        else:
            rt[row] = (np.nan, np.inf, -np.inf)[int(rng.integers(0, 3))]
    return ids, rt, exc


class BreakerEdges:
    """Transitions between consecutive ``breaker_stats()`` snapshots, per
    flow: ``trips`` CLOSED→OPEN, ``probes`` OPEN→HALF_OPEN (an elected
    probe), ``closes`` HALF_OPEN→CLOSED, ``reopens`` HALF_OPEN→OPEN. A
    pull moves a breaker at most one step (a trip or a probe election) and
    a report only resolves probes, so a snapshot after every operation sees
    every edge."""

    NAMES = {(0, 1): "trips", (1, 2): "probes", (2, 0): "closes",
             (2, 1): "reopens"}

    def __init__(self):
        self.prev: Dict[int, int] = {}
        self.counts = dict.fromkeys(self.NAMES.values(), 0)

    def update(self, stats: dict) -> None:
        cur = {fid: e["state_code"]
               for fid, e in stats.get("flows", {}).items()}
        for fid, code in cur.items():
            name = self.NAMES.get((self.prev.get(fid, 0), code))
            if name is not None:
                self.counts[name] += 1
        self.prev = cur

    def require(self, trips=3, probes=3, closes=1, reopens=1) -> None:
        want = dict(trips=trips, probes=probes, closes=closes,
                    reopens=reopens)
        short = {k: (self.counts[k], v) for k, v in want.items()
                 if self.counts[k] < v}
        if short:
            raise AssertionError(
                f"the stream saw too few breaker transitions "
                f"(seen, needed): {short}")


def drive(services: Sequence, advance: Callable[[int], None],
          rng: np.random.Generator, draw_ids: Callable, plan: Sequence,
          advances_ms: Sequence[int], rounds: int,
          check_op: Callable, check_round: Callable) -> None:
    """Run ``rounds`` rounds of ``plan`` against every service.

    ``plan`` holds ``("pull", n)`` and ``("report", n)`` steps; a pull
    larger than the services' batch takes their fused path. Odd rounds pull
    with mixed acquires. A report draws from the rows the last pull
    admitted (on the first service). After each step
    ``check_op(kind, round, step, n, outs)`` gets every service's result,
    then the clocks move by the next of ``advances_ms`` (cycled);
    ``check_round(round)`` ends each round."""
    admitted = np.empty(0, np.int64)
    adv = 0
    for r in range(rounds):
        for i, (kind, n) in enumerate(plan):
            if kind == "pull":
                ids = draw_ids(rng, n)
                acq = (None if r % 2 == 0
                       else rng.integers(1, 3, n).astype(np.int32))
                outs = [s.request_batch_arrays(ids, acq) for s in services]
                admitted = ids[outs[0][0] == OK]
            else:
                fl, rt, exc = report_rows(rng, admitted, n)
                outs = [s.report_outcomes(fl, rt, exc) for s in services]
            check_op(kind, r, i, n, outs)
            advance(advances_ms[adv % len(advances_ms)])
            adv += 1
        check_round(r)


def verdicts_equal(outs: Sequence[Tuple[np.ndarray, ...]]) -> bool:
    first = outs[0]
    return all(
        all(np.array_equal(a, b) for a, b in zip(first, o)) for o in outs[1:]
    )
