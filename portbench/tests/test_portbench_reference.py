"""The plain reference's models against Sentinel's semantics, one rule at a
time: the window check, the namespace guard, the pacing queue against a
request-by-request ``RateLimiterController``, the warm-up constants and
cold rate, and the sketch's shared budget."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

import portbench_small  # noqa: F401  (the repo's root on the path)
from portbench.reference.flow import (
    BLOCKED,
    OK,
    SHOULD_WAIT,
    TOO_MANY_REQUEST,
    FlowModel,
    fma32,
)
from portbench.reference.param import ParamModel, sketch_cells

ENGINE = {"bucket_ms": 100, "n_buckets": 10}


def model(counts, behaviors, namespaces, ns_max_qps=1e9):
    return FlowModel(ENGINE, np.asarray(counts, float), behaviors,
                     namespaces, ns_max_qps)


def decide(m, slots, now, acquire=1):
    slots = np.asarray(slots, np.int64)
    return m.frame(slots, np.full(slots.size, acquire, np.int32),
                   np.zeros(slots.size, bool), now)


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    a, b, c = (rng.random(2000).astype(np.float32) * 100 for _ in range(3))
    got = fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        # the float32 nearest the exact value: no other float32 is closer
        lo, hi = np.nextafter(g, np.float32(-np.inf)), \
            np.nextafter(g, np.float32(np.inf))
        err = abs(Fraction(float(g)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)


@pytest.mark.parametrize("already", [0, 3, 5, 9])
def test_window_check_admits_to_the_count(already):
    m = model([5], [0], ["a"])
    m.flow.add(1000, np.zeros(already, np.int64), 1)
    status, remaining, _ = decide(m, [0] * 8, 1050)
    k = max(0, 5 - already)
    assert (status[:k] == OK).all() and (status[k:] == BLOCKED).all()
    assert remaining[:k].tolist() == [5 - already - i - 1 for i in range(k)]
    # the bucket leaves the 1 s window: the flow admits afresh
    status, _, _ = decide(m, [0] * 8, 2100)
    assert (status[:5] == OK).all() and (status[5:] == BLOCKED).all()


def test_namespace_guard_counts_in_the_services_order():
    m = model([100, 100, 100, 100], [0] * 4, ["a", "a", "a", "b"],
              ns_max_qps=4)
    status, _, _ = decide(m, [0, 0, 1, 1, 2, 2, 3], 500)
    assert status.tolist() == [OK] * 4 + [TOO_MANY_REQUEST] * 2 + [OK]
    status, _, _ = decide(m, [2], 600)  # the namespace's window is full
    assert status.tolist() == [TOO_MANY_REQUEST]


def rate_limiter(latest, now, cost, max_queue, n):
    """``RateLimiterController.canPass``, one request at a time."""
    out = []
    for _ in range(n):
        expected = latest + cost
        if expected <= now:
            latest = now
            out.append((OK, 0))
            continue
        wait = expected - now
        if wait > max_queue:
            out.append((BLOCKED, 0))
            continue
        latest += cost
        out.append((SHOULD_WAIT if wait > 0 else OK, wait))
    return out


@pytest.mark.parametrize("count,latest_ago", [(100, 10_000), (7, 10_000),
                                              (50, 30), (50, -400),
                                              (199, 0)])
def test_pacing_matches_the_rate_limiter(count, latest_ago):
    m = model([count], [2], ["a"])
    now = 20_000
    m.latest[0] = now - latest_ago
    status, _, wait = decide(m, [0] * 64, now)
    cost = round(1000 / count)
    want = rate_limiter(now - latest_ago, now, cost, 500, 64)
    assert list(zip(status.tolist(), wait.tolist())) == want


def test_warm_up_constants_and_cold_rate():
    counts = np.arange(1, 501, dtype=float)
    m = model(counts, [1] * counts.size, ["a"] * counts.size)
    # WarmUpController's constructor, in Java's integer arithmetic
    warn = [int(10 * c) // 2 for c in counts]
    assert m.warn.tolist() == warn
    assert m.max_token.tolist() == [w + int(20 * c / 4.0)
                                    for w, c in zip(warn, counts)]
    # from a cold start the stored tokens fill to maxToken and the rate
    # is count / coldFactor
    flows = np.arange(counts.size)
    rate = m._warm_up(flows, np.zeros(counts.size, np.int64), 5_000)
    np.testing.assert_allclose(rate, counts / 3, rtol=1e-5)
    assert (m.tokens == m.max_token).all()


def test_sketch_values_share_cells_and_budget():
    rules = [(7, 4.0, {}), (8, 4.0, {})]
    m = ParamModel({"bucket_ms": 100, "n_buckets": 10, "depth": 2,
                    "width": 64}, rules)
    h = 123456789
    # one value twice in a request: one budget of 4, taken in order
    status, admit = m.request(7, 3, [h, h], 1000)
    assert status == BLOCKED and admit.tolist() == [True, False]
    status, admit = m.request(7, 1, [h], 1100)
    assert status == OK and admit.tolist() == [True]
    status, _ = m.request(7, 1, [h], 1200)
    assert status == BLOCKED  # 3 + 1 counted: the window holds 4
    # another rule's sketch is its own; the window lets the counts go
    assert m.request(8, 4, [h], 1200)[0] == OK
    assert m.request(7, 4, [h], 2150)[0] == OK
    cells = sketch_cells(np.array([h, h + 1]), 2, 64)
    assert cells.shape == (2, 2) and (cells >= 0).all() and (cells < 64).all()
