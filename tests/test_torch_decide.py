"""The port's decide step against the reference ``_decide_core``.

Seeded mixed streams (every control behavior, prioritized occupy,
namespace-guard crossings, breakers fed by seeded outcome planes, idle gaps
and rolls) go through JAX ``decide`` (XLA pipeline) and the port's
``_decide_core`` / kernel step; verdicts and every state leaf must be
bit-identical. The kernel module's plain path is also held against the
reference megakernel ``decide_core_pallas`` in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from sentinel_tpu.engine import (  # noqa: E402
    ClusterFlowRule as JRule,
    DegradeRule as JDegrade,
    EngineConfig as JConfig,
    build_rule_table as j_build,
    decide as j_decide,
    make_batch as j_make_batch,
    make_state as j_make_state,
)
from sentinel_tpu.engine.rules import (  # noqa: E402
    ControlBehavior as JCB,
    DegradeStrategy as JDS,
    ThresholdMode as JTM,
)
from sentinel_tpu.ops.decide_pallas import decide_core_pallas  # noqa: E402

from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine import decide as D  # noqa: E402
from sentinel_tpu_torch.engine.state import (  # noqa: E402
    N_OUTCOME_CHANNELS,
    OutcomeChannel,
)
from sentinel_tpu_torch.ops import decide_cuda  # noqa: E402
from torch_parity import (  # noqa: E402
    assert_states_equal,
    assert_verdicts_equal,
    port_rules_of,
    port_state_of,
)

KW = dict(max_flows=32, max_namespaces=4, batch_size=64)
JCFG = JConfig(decide_impl="xla", **KW)
CFG = EngineConfig(decide_impl="xla", **KW)
G = JTM.GLOBAL


def _rules():
    return [
        JRule(flow_id=0, count=6.0, mode=G),
        JRule(flow_id=1, count=50.0, mode=G),
        JRule(flow_id=2, count=5.0),  # AVG_LOCAL
        JRule(flow_id=3, count=40.0, mode=G, control_behavior=JCB.WARM_UP),
        JRule(flow_id=4, count=25.0, mode=G,
              control_behavior=JCB.RATE_LIMITER, max_queueing_time_ms=300),
        JRule(flow_id=5, count=30.0, mode=G,
              control_behavior=JCB.WARM_UP_RATE_LIMITER,
              max_queueing_time_ms=200),
        JRule(flow_id=6, count=9.0, mode=G, namespace="tight"),
        JRule(flow_id=7, count=7.0, mode=G, namespace="tight"),
        # 1000 / 16 = 62.5 ms a token: pacing costs land on rounding ties
        JRule(flow_id=8, count=16.0, mode=G,
              control_behavior=JCB.RATE_LIMITER, max_queueing_time_ms=400),
    ]


def _degrade():
    return [
        JDegrade(1, JDS.ERROR_RATIO, threshold=0.2, min_request_amount=5,
                 stat_interval_ms=1000, recovery_timeout_ms=300),
        JDegrade(4, JDS.SLOW_REQUEST_RATIO, threshold=0.3, slow_rt_ms=40,
                 min_request_amount=5, stat_interval_ms=1000,
                 recovery_timeout_ms=400),
        JDegrade(6, JDS.ERROR_COUNT, threshold=3.0, min_request_amount=1,
                 stat_interval_ms=800, recovery_timeout_ms=350,
                 namespace="tight"),
    ]


def _tables(breakers=False):
    table, index = j_build(
        JCFG, _rules(), ns_max_qps=30_000.0,
        connected={"default": 3, "tight": 2},
        degrade_rules=_degrade() if breakers else None,
    )
    tight = index.namespace_slot("tight")
    table = table._replace(ns_max_qps=table.ns_max_qps.at[tight].set(12.0))
    return table, port_rules_of(table)


def _stream(rng, steps, uniform, grouped=True, n_max=None):
    """Seeded request stream: unknown flows, prioritized rows, mixed
    acquires, mostly intra-bucket advances, some rolls, rare long gaps."""
    now = 10_000
    n_max = n_max or JCFG.batch_size - 3
    for _ in range(steps):
        n = int(rng.integers(4, n_max))
        slots = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 29], size=n).astype(
            np.int32
        )
        if grouped:
            slots.sort()
        acq = (np.ones(n, np.int32) if uniform
               else rng.integers(1, 4, size=n).astype(np.int32))
        prio = rng.random(n) < 0.3
        yield now, (slots, acq, prio)
        r = rng.random()
        now += int(
            rng.integers(5, 60) if r < 0.7
            else rng.integers(100, 350) if r < 0.95
            else rng.integers(1_500, 2_600)
        )


def _seed_outcomes(rng, jstate, now):
    """A seeded outcome plane (completions, exceptions, slow calls) on the
    guarded flows, so breakers trip and re-arm inside the stream."""
    counts = np.zeros(np.asarray(jstate.outcome.counts).shape, np.int32)
    for slot in (1, 4, 6):
        for b in range(counts.shape[1]):
            total = int(rng.integers(0, 12))
            counts[slot, b, int(OutcomeChannel.COMPLETE)] = total
            counts[slot, b, int(OutcomeChannel.EXCEPTION)] = int(
                rng.integers(0, total + 1))
            counts[slot, b, int(OutcomeChannel.SLOW)] = int(
                rng.integers(0, total + 1))
    starts = (now - now % 100) - 100 * np.arange(counts.shape[1])[::-1]
    starts = np.roll(starts.astype(np.int32), (now // 100) % 10 + 1)
    assert counts.shape[2] == N_OUTCOME_CHANNELS
    return jstate._replace(outcome=jstate.outcome._replace(
        counts=jax.numpy.asarray(counts), starts=jax.numpy.asarray(starts)
    ))


def _run_stream(seed, uniform, grouped, breakers, core, steps=8):
    rng = np.random.default_rng(seed)
    jtable, ttable = _tables(breakers)
    jst = j_make_state(JCFG)
    if breakers:
        jst = _seed_outcomes(rng, jst, 10_000)
    tst = port_state_of(jst)
    degraded = 0
    for i, (now, (slots, acq, prio)) in enumerate(
        _stream(rng, steps, uniform, grouped)
    ):
        jb = j_make_batch(JCFG, slots, acq, prio)
        tb = D.make_batch(CFG, slots, acq, prio)
        for leaf_j, leaf_t in zip(jb, tb):
            np.testing.assert_array_equal(leaf_j, leaf_t)
        jst, jv = j_decide(JCFG, jst, jtable, jb, now, grouped=grouped,
                           uniform=uniform)
        tst, tv = core(CFG, tst, ttable, tb, now, grouped=grouped,
                       uniform=uniform)
        label = f"seed={seed} step={i}"
        assert_verdicts_equal(jv, tv, label)
        assert_states_equal(jst, tst, label)
        degraded += int((np.asarray(jv.status) == 12).sum())
    return degraded


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize(
    "uniform,grouped",
    [(True, True), (False, True), (False, False)],
    ids=["grouped-uniform", "grouped-mixed", "nongrouped"],
)
def test_decide_core_stream_parity(seed, uniform, grouped):
    _run_stream(seed, uniform, grouped, breakers=False, core=D._decide_core)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("grouped", [True, False])
def test_decide_core_breaker_parity(seed, grouped):
    degraded = _run_stream(0xBEA + seed, False, grouped, breakers=True,
                           core=D._decide_core, steps=10)
    assert degraded > 0  # the seeded outcome plane trips breakers


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("breakers", [False, True])
def test_kernel_step_plain_path_parity(seed, uniform, breakers):
    """The kernel's step (prologue + plain rows + epilogue) on CPU tensors
    against the reference XLA pipeline."""
    _run_stream(seed + 40, uniform, True, breakers,
                core=decide_cuda.decide_core_kernel)


def test_prioritized_occupy_parity():
    """Saturate flow 0, then prioritized rows borrow the next window
    (SHOULD_WAIT + future-window charge), then the borrow matures."""
    jtable, ttable = _tables()
    jst = j_make_state(JCFG)
    tst = port_state_of(jst)
    waits = None
    for now, slots, prio in (
        (50_000, np.zeros(6, np.int32), None),
        (50_950, np.zeros(4, np.int32), np.ones(4, bool)),
        (51_010, np.zeros(8, np.int32), None),
    ):
        jb = j_make_batch(JCFG, slots, None, prio)
        tb = D.make_batch(CFG, slots, None, prio)
        jst, jv = j_decide(JCFG, jst, jtable, jb, now, grouped=True)
        tst, tv = decide_cuda.decide_core_kernel(CFG, tst, ttable, tb, now,
                                                 grouped=True)
        assert_verdicts_equal(jv, tv, f"occupy now={now}")
        assert_states_equal(jst, tst, f"occupy now={now}")
        if prio is not None:
            waits = np.asarray(jv.wait_ms)[:4]
    assert (waits > 0).any()


@pytest.mark.parametrize("depth", [2, 4])
def test_fused_depth_matches_sequential(depth):
    """decide_fused_donating over `depth` stacked frames equals `depth`
    sequential reference steps at one shared now."""
    jtable, ttable = _tables()
    rng = np.random.default_rng(100 + depth)
    frames = [f for _, f in _stream(rng, depth, uniform=False)]
    now = 12_345
    jst = j_make_state(JCFG)
    tst = port_state_of(jst)
    jvs = []
    for slots, acq, prio in frames:
        jst, jv = j_decide(JCFG, jst, jtable,
                           j_make_batch(JCFG, slots, acq, prio), now,
                           grouped=True)
        jvs.append(jv)
    block = D.alloc_fused_batch(CFG, depth)
    for k, (slots, acq, prio) in enumerate(frames):
        D.make_batch_into(block, k, slots, acq, prio)
    cfg = CFG._replace(decide_impl="pallas")  # plain rows on CPU tensors
    step = D.decide_fused_donating(cfg, depth, grouped=True)
    tst, tv = step(tst, ttable, block, now)
    for k, jv in enumerate(jvs):
        assert_verdicts_equal(
            jv, D.VerdictBatch(*(leaf[k] for leaf in tv)), f"frame {k}"
        )
    assert_states_equal(jst, tst, f"fused depth={depth}")


@pytest.mark.parametrize("uniform", [True, False])
def test_plain_rows_match_pallas_interpret(uniform):
    """The kernel module's plain path against the reference megakernel in
    interpret mode (as the reference's own tests run it), F=32, N=64."""
    jtable, ttable = _tables()
    pcfg = JCFG._replace(decide_impl="pallas")
    rng = np.random.default_rng(7 + int(uniform))
    jst = j_make_state(pcfg)
    tst = port_state_of(jst)
    step = jax.jit(
        lambda st, tb, b, now: decide_core_pallas(
            pcfg, st, tb, b, now, grouped=True, uniform=uniform
        )
    )
    for i, (now, (slots, acq, prio)) in enumerate(
        _stream(rng, 3, uniform)
    ):
        jb = j_make_batch(pcfg, slots, acq, prio)
        jst, jv = step(jst, jtable, jb, now)
        tst, tv = decide_cuda.decide_core_kernel(
            CFG, tst, ttable, D.make_batch(CFG, slots, acq, prio), now,
            grouped=True, uniform=uniform,
        )
        assert_verdicts_equal(jv, tv, f"pallas step={i}")
        assert_states_equal(jst, tst, f"pallas step={i}")


def test_decide_is_pure_and_donating_is_in_place():
    jtable, ttable = _tables()
    tst = port_state_of(j_make_state(JCFG))
    before = tst.flow.counts.clone()
    batch = D.make_batch(CFG, np.zeros(3, np.int32))
    st2, _ = D.decide(CFG, tst, ttable, batch, 20_000, grouped=True)
    assert torch.equal(tst.flow.counts, before)
    assert int(st2.flow.counts.sum()) > 0
    step = D.decide_donating(CFG, grouped=True)
    st3, _ = step(tst, ttable, batch, 20_000)
    assert st3.flow.counts is tst.flow.counts
    assert torch.equal(st3.flow.counts, st2.flow.counts)


def test_even_refine_iters_rejected():
    jtable, ttable = _tables()
    cfg = CFG._replace(admission_refine_iters=2)
    tst = port_state_of(j_make_state(JCFG))
    with pytest.raises(ValueError):
        D._decide_core(cfg, tst, ttable,
                       D.make_batch(cfg, [0]), 1000, grouped=True)


def test_warmup_curve_matches_compiled_reference():
    """The warmup curve on 8192 random rows against the reference's
    ``_warmup_curve`` under ``jax.jit``, where XLA turns `/ 1000.0` into a
    reciprocal multiply and contracts `above * slope + 1 / cnt` into an
    FMA; the port writes both out (ROADMAP §C)."""
    from sentinel_tpu.engine.decide import _warmup_curve as j_curve
    from sentinel_tpu.engine.state import flow_spec as j_spec

    rng = np.random.default_rng(11)
    n = 8192
    cnt = rng.integers(1, 400, n).astype(np.float32)
    cols = dict(
        passed=rng.integers(0, 300, n).astype(np.float32),
        cnt=cnt,
        cnt_safe=np.maximum(cnt, np.float32(1e-6)),
        warn=rng.integers(0, 2000, n).astype(np.float32),
        max_token=rng.integers(100, 4000, n).astype(np.float32),
        slope=(rng.random(n) * 1e-3).astype(np.float32),
        cold_count=rng.integers(0, 100, n).astype(np.float32),
        filled=(95_000 - rng.integers(0, 40_000, n)).astype(np.int32),
        tokens=(rng.random(n) * 4000).astype(np.float32),
        warm_rows=rng.random(n) < 0.9,
    )
    now = 100_123
    ref = jax.jit(lambda c: j_curve(j_spec(JCFG), now, **c))(cols)
    got = D._warmup_curve(D.flow_spec(CFG), now,
                          **{k: torch.as_tensor(v) for k, v in cols.items()})
    for name, r, g in zip(("qps", "tokens_new", "do_sync"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(12)
    a = (rng.standard_normal(20_000) * 1e3).astype(np.float32)
    b = (rng.standard_normal(20_000) * 1e-3).astype(np.float32)
    c = rng.standard_normal(20_000).astype(np.float32)
    # exact reference through Python fractions on a sample
    from fractions import Fraction

    got = D.fma_f32(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(c)).numpy()
    for i in range(0, 20_000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        lo = np.float32(float(exact))  # nearest double, then float32
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                          int(np.float32(x).view(np.int32))
                                          & 1))
        assert got[i] == best, i


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(100, 110))
@pytest.mark.parametrize("breakers", [False, True])
def test_decide_parity_battery(seed, breakers):
    """Longer seeded streams over both backends of the port (not tier-1)."""
    for core, grouped in ((D._decide_core, False),
                          (decide_cuda.decide_core_kernel, True)):
        for uniform in (True, False):
            _run_stream(seed, uniform, grouped, breakers, core=core,
                        steps=20)
