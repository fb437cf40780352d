"""The port's outcome step against the reference ``engine/outcome.py``.

``rt_bucket`` on every power-of-two edge, negatives, the int32 extremes and
10k seeded int32 values; ``_outcome_core`` with and without the breaker
columns over report batches of 1 / 64 / 300 / 1024 rows (duplicate slots,
invalid rows, valid rows whose slot lies out of range, padding) on a state
whose breakers hold live HALF_OPEN probes, over steps that roll the ring
across two windows. Every state leaf must be bit-identical after every
step; no tolerance.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine import make_state as j_make_state  # noqa: E402
from sentinel_tpu.engine.outcome import (  # noqa: E402
    _outcome_core as j_outcome_core,
    rt_bucket as j_rt_bucket,
)
from sentinel_tpu.engine.state import (  # noqa: E402
    BreakerState as JBreakerState,
    EngineState as JEngineState,
    ShapingState as JShapingState,
)
from sentinel_tpu.stats.window import WindowState as JWindowState  # noqa: E402

from sentinel_tpu_torch.engine import EngineConfig, outcome  # noqa: E402
from sentinel_tpu_torch.engine.rules import NO_SLOW_RT_MS  # noqa: E402
from sentinel_tpu_torch.engine.state import (  # noqa: E402
    BR_CLOSED,
    BR_HALF_OPEN,
    BR_OPEN,
    N_RT_BUCKETS,
    RT_BUCKET_UPPER_MS,
)
from sentinel_tpu_torch.stats.window import NEVER  # noqa: E402
from torch_parity import (  # noqa: E402
    assert_arrays_equal,
    assert_states_equal,
    port_state_of,
    to_np,
)

F = 256
KW = dict(max_flows=F, max_namespaces=4, batch_size=256)
JCFG = JConfig(**KW)
CFG = EngineConfig(**KW)
# steps 40 ms past a second: same bucket, rolls, and a jump past a whole
# window, so the ring rolls onto written columns twice
NOWS = (1_040, 1_090, 1_230, 1_980, 2_110, 3_350)
REPORT_SIZES = (1, 64, 300, 1024)


def _rt_edges():
    vals = [0, -1, -2, 1, 2, 3, 2**31 - 1, -(2**31), 2**31 - 2]
    for k in range(32):
        for d in (-2, -1, 0, 1):
            v = (1 << k) + d
            if -(2**31) <= v < 2**31:
                vals.append(v)
    return np.array(vals, np.int32)


def test_rt_bucket_edges_and_extremes():
    x = _rt_edges()
    got = outcome.rt_bucket(torch.as_tensor(x))
    assert got.dtype == torch.int32
    assert_arrays_equal(j_rt_bucket(jnp.asarray(x)), got, "rt_bucket edges")
    # the host table's edges: rt == 2^(j+1) - 1 is the last rt of cell j
    for j, edge in enumerate(RT_BUCKET_UPPER_MS[:-1]):
        cells = outcome.rt_bucket(torch.tensor([edge - 1, edge],
                                               dtype=torch.int32))
        assert cells.tolist() == [j, min(j + 1, N_RT_BUCKETS - 1)]


def test_rt_bucket_seeded_int32():
    rng = np.random.default_rng(11)
    x = rng.integers(-(2**31), 2**31, 10_000, dtype=np.int64).astype(
        np.int32)
    assert_arrays_equal(j_rt_bucket(jnp.asarray(x)),
                        outcome.rt_bucket(torch.as_tensor(x)),
                        "rt_bucket seeded")


def _jax_state_of(d):
    def win(p):
        return JWindowState(jnp.asarray(d[f"{p}.starts"]),
                            jnp.asarray(d[f"{p}.counts"]))

    return JEngineState(
        flow=win("flow"), occupy=win("occupy"), ns=win("ns"),
        shaping=JShapingState(*(jnp.asarray(d[f"shaping.{f}"])
                                for f in JShapingState._fields)),
        outcome=win("outcome"),
        breaker=JBreakerState(*(jnp.asarray(d[f"breaker.{f}"])
                                for f in JBreakerState._fields)),
    )


def _state_with_probes(rng):
    """A fresh state whose breakers are CLOSED, OPEN, HALF_OPEN with a live
    probe ticket, and HALF_OPEN with no ticket."""
    from sentinel_tpu_torch import interop

    d = interop.state_to_numpy(j_make_state(JCFG))
    kind = rng.integers(0, 4, F)
    d["breaker.state"] = np.where(
        kind == 0, BR_CLOSED, np.where(kind == 1, BR_OPEN, BR_HALF_OPEN)
    ).astype(np.int8)
    d["breaker.opened_ms"] = np.where(kind > 0, 500, NEVER).astype(np.int32)
    d["breaker.probe_ms"] = np.where(kind == 2, 900, NEVER).astype(np.int32)
    return d


def _breaker_columns(rng):
    strategy = rng.integers(-1, 3, F).astype(np.int8)
    slow = np.where(strategy == 0, rng.integers(20, 200, F),
                    NO_SLOW_RT_MS).astype(np.int32)
    return strategy, slow


def _report(rng, k):
    """A report batch: duplicate slots, invalid rows with garbage slots,
    valid rows whose slot lies outside ``[0, F)``, and padding."""
    slots = rng.integers(0, 64, k).astype(np.int32)  # many duplicates
    rt = rng.integers(0, 400, k).astype(np.int32)
    exc = (rng.random(k) < 0.3).astype(np.int32)
    valid = rng.random(k) < 0.9
    if k >= 8:
        odd = rng.choice(k, size=max(4, k // 20), replace=False)
        slots[odd] = rng.choice(
            [F, F + 7, -1, -3, -F - 1, 10**6], size=odd.size)
        valid[odd[: odd.size // 2]] = True
        valid[-max(1, k // 10):] = False  # a padded tail
        rt[-1] = 2**31 - 1
    return slots, rt, exc, valid


@pytest.mark.parametrize("breakers", [False, True])
@pytest.mark.parametrize("k", REPORT_SIZES)
def test_outcome_core_matches_reference(k, breakers):
    rng = np.random.default_rng(100 + k + breakers)
    d = _state_with_probes(rng)
    j_state = _jax_state_of(d)
    t_state = port_state_of(j_state)
    strategy, slow = _breaker_columns(rng)
    j_br = (jnp.asarray(strategy), jnp.asarray(slow)) if breakers else ()
    t_br = ((torch.as_tensor(strategy), torch.as_tensor(slow))
            if breakers else ())
    j_step = jax.jit(partial(j_outcome_core, JCFG))
    t_step = outcome.outcome_step_donating(CFG)
    resolved = {BR_CLOSED: 0, BR_OPEN: 0}
    for s, now in enumerate(NOWS):
        slots, rt, exc, valid = _report(rng, k)
        before = to_np(t_state.breaker.state).copy()
        j_state = j_step(j_state, jnp.asarray(slots), jnp.asarray(rt),
                         jnp.asarray(exc), jnp.asarray(valid),
                         jnp.int32(now), *j_br)
        out = t_step(t_state, torch.as_tensor(slots), torch.as_tensor(rt),
                     torch.as_tensor(exc), torch.as_tensor(valid), now,
                     *t_br)
        assert out is t_state  # in place
        assert_states_equal(j_state, t_state, f"k={k} step={s}")
        after = to_np(t_state.breaker.state)
        for code in resolved:
            resolved[code] += int(((before == BR_HALF_OPEN)
                                   & (after == code)).sum())
    if breakers and k >= 64:
        # the probes were really resolved, both ways
        assert resolved[BR_CLOSED] > 0 and resolved[BR_OPEN] > 0, resolved
    if not breakers:
        assert_arrays_equal(d["breaker.state"], t_state.breaker.state,
                            "the 6-argument form leaves breakers alone")


def test_one_scatter_counts_every_channel():
    """A hand-checked report: sums per channel, SLOW against the cutoff,
    the histogram cell, and a masked row that adds nothing."""
    t_state = port_state_of(j_make_state(JCFG))
    strategy = np.full(F, -1, np.int8)
    slow = np.full(F, NO_SLOW_RT_MS, np.int32)
    strategy[5], slow[5] = 0, 100
    step = outcome.outcome_step_donating(CFG)
    step(t_state, torch.tensor([5, 5, 7, 5]), torch.tensor([150, 3, 50, 9]),
         torch.tensor([1, 0, 1, 1]), torch.tensor([True, True, True, False]),
         1_000, torch.as_tensor(strategy), torch.as_tensor(slow))
    c = to_np(t_state.outcome.counts)[:, 0]  # bucket of t=1000
    assert c[5, :4].tolist() == [153, 2, 1, 1]  # RT_SUM, COMPLETE, EXC, SLOW
    assert c[7, :4].tolist() == [50, 1, 1, 0]
    assert c[5, 4:].tolist() == [0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0]
    assert int(c.sum()) == 153 + 2 + 1 + 1 + 2 + 50 + 1 + 1 + 1
