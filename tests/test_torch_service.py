"""The port's token service (``device="cpu"``) against the reference
``DefaultTokenService``: both on manual clocks set to the same millisecond,
the same rules, the same pulls — a 64-row pull, full-bucket pulls, and an
oversized pull that takes the fused path — must answer the same status,
remaining and wait, and end in the same state. Also: the state round-trip
through ``interop``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.rules import (  # noqa: E402
    ControlBehavior as JCB,
    ThresholdMode as JTM,
)

from sentinel_tpu_torch import interop  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
    TokenResult,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    ControlBehavior,
    EngineConfig,
    ThresholdMode,
)
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from torch_parity import assert_states_equal  # noqa: E402

KW = dict(max_flows=256, max_namespaces=4, batch_size=256)
START_MS = 1_700_000_000_000


def _rule_specs(rng, n_flows=120):
    specs = []
    for fid in range(n_flows):
        beh = int(rng.choice([0, 0, 0, 1, 2, 3]))
        specs.append(dict(
            flow_id=1000 + fid,
            count=float(rng.integers(5, 60)),
            mode=int(rng.integers(0, 2)),
            namespace="default" if fid % 5 else "ns1",
            control_behavior=beh,
            max_queueing_time_ms=int(rng.integers(100, 600)),
        ))
    return specs


@pytest.fixture
def clocks():
    jc, tc = j_clock.ManualClock(START_MS), t_clock.ManualClock(START_MS)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    yield jc, tc
    j_clock.set_clock(prev_j)
    t_clock.set_clock(prev_t)


def _services(rng):
    specs = _rule_specs(rng)
    jsvc = JService(JConfig(decide_impl="xla", **KW), fuse_depths=(2,))
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu",
                               fuse_depths=(2,))
    connected = {"default": 2, "ns1": 3}
    jsvc.load_rules(
        [JRule(**{**s, "mode": JTM(s["mode"]),
                  "control_behavior": JCB(s["control_behavior"])})
         for s in specs], connected=connected)
    tsvc.load_rules(
        [ClusterFlowRule(**{**s, "mode": ThresholdMode(s["mode"]),
                            "control_behavior": ControlBehavior(
                                s["control_behavior"])})
         for s in specs], connected=connected)
    return jsvc, tsvc


def _pull(rng, n):
    # bounded Zipf over the loaded flows plus a few unknown ids
    ranks = np.minimum(rng.zipf(1.3, size=n), 130) - 1
    ids = (1000 + ranks).astype(np.int64)
    acq = rng.integers(1, 3, size=n).astype(np.int32)
    prio = rng.random(n) < 0.2
    return ids, acq, prio


@pytest.mark.parametrize("seed", range(2))
def test_service_pulls_match_reference(seed, clocks):
    jc, tc = clocks
    rng = np.random.default_rng(seed)
    jsvc, tsvc = _services(rng)
    sizes = [64, 200, 256, 600, 40, 256 * 4 + 30]
    for i, n in enumerate(sizes):
        ids, acq, prio = _pull(rng, n)
        uniform = i % 2 == 0
        a = None if uniform else acq
        js, jr, jw = jsvc.request_batch_arrays(ids, a, prio)
        ts, tr, tw = tsvc.request_batch_arrays(ids, a, prio)
        label = f"seed={seed} pull={i} n={n}"
        np.testing.assert_array_equal(js, ts, err_msg=label + " status")
        np.testing.assert_array_equal(jr, tr, err_msg=label + " remaining")
        np.testing.assert_array_equal(jw, tw, err_msg=label + " wait")
        assert ts.dtype == np.int8 and ts.shape == (n,)
        assert_states_equal(jsvc._state, tsvc._state, label)
        step = int(rng.integers(20, 400))
        jc.advance(step)
        tc.advance(step)
    assert (ts == int(TokenStatus.OK)).any()


def test_request_token_and_batch(clocks):
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu")
    tsvc.load_rules([ClusterFlowRule(flow_id=7, count=2.0,
                                     mode=ThresholdMode.GLOBAL)])
    r = tsvc.request_token(7)
    assert isinstance(r, TokenResult) and r.ok and r.remaining == 1
    res = tsvc.request_batch([(7, 1, False), (7, 1, False), (8, 1, False)])
    assert [x.status for x in res] == [
        TokenStatus.OK, TokenStatus.BLOCKED, TokenStatus.NO_RULE_EXISTS,
    ]
    assert tsvc.request_batch([]) == []
    empty = tsvc.request_batch_arrays(np.empty(0, np.int64))
    assert all(x.shape == (0,) for x in empty)


def test_reload_frees_and_clears_slots(clocks):
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu")
    tsvc.load_rules([ClusterFlowRule(flow_id=1, count=100.0),
                     ClusterFlowRule(flow_id=2, count=100.0)])
    tsvc.request_batch_arrays(np.array([1, 1, 2], np.int64))
    slot2 = int(tsvc.lookup_slots(np.array([2]))[0])
    assert int(tsvc._state.flow.counts[slot2].sum()) > 0
    tsvc.load_rules([ClusterFlowRule(flow_id=1, count=100.0)])
    assert tsvc.lookup_slots(np.array([2]))[0] == -1
    assert int(tsvc._state.flow.counts[slot2].sum()) == 0


def test_warmup_leaves_state_untouched(clocks):
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu",
                               fuse_depths=(2,))
    tsvc.load_rules([ClusterFlowRule(flow_id=1, count=5.0)])
    before = interop.state_to_numpy(tsvc._state)
    tsvc.warmup()
    after = interop.state_to_numpy(tsvc._state)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)


def test_engine_now_rebase(clocks):
    jc, tc = clocks
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu")
    tsvc.load_rules([ClusterFlowRule(flow_id=1, count=5.0)])
    tsvc.request_batch_arrays(np.array([1, 1], np.int64))
    tc.advance(DefaultTokenService._REBASE_AFTER_MS + 10)
    with tsvc._lock:
        now = tsvc._engine_now()
    assert now == 60_000
    starts = tsvc._state.flow.starts
    assert int(starts.max()) <= now


def test_interop_state_round_trip(clocks):
    jc, tc = clocks
    rng = np.random.default_rng(5)
    jsvc, tsvc = _services(rng)
    ids, acq, prio = _pull(rng, 200)
    jsvc.request_batch_arrays(ids, acq, prio)
    # reference state → numpy → port state, then a step on both
    d = interop.state_to_numpy(jsvc._state)
    tsvc._state = interop.state_from_numpy(d, "cpu")
    tsvc._epoch_ms = jsvc._epoch_ms  # the engine clock travels with it
    assert_states_equal(jsvc._state, tsvc._state, "import")
    back = interop.state_to_numpy(tsvc._state)
    assert back.keys() == d.keys()
    for k in d:
        assert back[k].dtype == d[k].dtype
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    jc.advance(30)
    tc.advance(30)
    ids, acq, prio = _pull(rng, 150)
    js, jr, jw = jsvc.request_batch_arrays(ids, acq, prio)
    ts, tr, tw = tsvc.request_batch_arrays(ids, acq, prio)
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jr, tr)
    np.testing.assert_array_equal(jw, tw)
    rules = interop.rules_to_numpy(tsvc._table)
    assert "br_strategy" not in rules
    table = interop.rules_from_numpy(rules, "cpu")
    assert table.br_strategy is None
    assert torch.equal(table.count, tsvc._table.count)


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        DefaultTokenService(EngineConfig(**KW))
