"""The port's flow mesh (``sentinel_tpu_torch.parallel``) on ``[cpu] * 8``.

The reference's ``tests/test_sharding.py`` (18 cases) rerun against the
port, then the cross-package parity: the same numpy-seeded stream through
the JAX ``make_sharded_decide`` on the conftest's 8-virtual-device mesh and
through the port's 8-shard mesh, grouped and ungrouped, plain and fused
(depth 2 and 4), with and without degrade rules, verdicts and every state
leaf bitwise equal; snapshots crossing between the packages and between mesh
shapes; a shard that raises; and the copy path of a mesh of several devices
(forced on the CPU).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import DegradeRule as JDegrade  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine import build_rule_table as j_build  # noqa: E402
from sentinel_tpu.engine import make_batch as j_make_batch  # noqa: E402
from sentinel_tpu.engine import make_state as j_make_state  # noqa: E402
from sentinel_tpu.engine.rules import (  # noqa: E402
    ControlBehavior as JCB,
    DegradeStrategy as JDS,
    ThresholdMode as JTM,
)
from sentinel_tpu.engine.state import (  # noqa: E402
    BreakerState as JBreaker,
    EngineState as JState,
    ShapingState as JShaping,
)
from sentinel_tpu.parallel import (  # noqa: E402
    make_flow_mesh as j_make_mesh,
    make_sharded_decide as j_sharded,
    shard_rules as j_shard_rules,
    shard_state as j_shard_state,
)
from sentinel_tpu.stats.window import WindowState as JWindow  # noqa: E402

import torch_ha_check as H  # noqa: E402
import torch_repl_check as R  # noqa: E402
from sentinel_tpu_torch import interop  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import (  # noqa: E402
    ClusterFlowRule,
    ControlBehavior,
    DegradeRule,
    EngineConfig,
    build_rule_table,
    make_state,
)
from sentinel_tpu_torch.engine.decide import (  # noqa: E402
    RequestBatch,
    TokenStatus,
    decide,
    decide_donating,
    make_batch,
)
from sentinel_tpu_torch.engine.param import ParamConfig  # noqa: E402
from sentinel_tpu_torch.engine.rules import (  # noqa: E402
    DegradeStrategy,
    ThresholdMode,
)
from sentinel_tpu_torch.parallel import (  # noqa: E402
    make_flow_mesh,
    make_sharded_decide,
    shard_rules,
    shard_state,
)
from sentinel_tpu_torch.parallel import sharding as S  # noqa: E402
from torch_parity import (  # noqa: E402
    assert_arrays_equal,
    assert_states_equal,
    assert_verdicts_equal,
)

CPU = torch.device("cpu")
CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=64)
G = ThresholdMode.GLOBAL


@pytest.fixture(scope="module")
def mesh():
    return make_flow_mesh([CPU] * 8)


@pytest.fixture
def port_clock():
    mc = t_clock.ManualClock(1_700_000_000_000)
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


def _build(num_rules=20, count=5.0, cfg=CFG):
    rules = [
        ClusterFlowRule(flow_id=i, count=count + (i % 3), mode=G)
        for i in range(num_rules)
    ]
    table, index = build_rule_table(cfg, rules, device=CPU)
    return rules, table, index


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# The reference's tests/test_sharding.py, against the port
# ---------------------------------------------------------------------------


class TestShardedParity:
    @pytest.mark.parametrize("seed", range(3))
    def test_verdict_parity_with_single_device(self, mesh, seed):
        rules, table, index = _build()
        sharded_step = make_sharded_decide(CFG, mesh)

        state_1 = make_state(CFG, device=CPU)
        state_8 = shard_state(make_state(CFG, device=CPU), mesh)
        table_8 = shard_rules(table, mesh)

        rng = np.random.default_rng(seed)
        now = 10_000
        for step in range(6):
            now += int(rng.integers(20, 400))
            flows = rng.integers(-1, 20, size=48)
            slots = [index.lookup(int(f)) if f >= 0 else -1 for f in flows]
            prio = rng.random(48) < 0.2
            batch = make_batch(CFG, slots, prioritized=prio.tolist())
            state_1, v1 = decide(CFG, state_1, table, batch, now)
            state_8, v8 = sharded_step(state_8, table_8, batch, now)
            assert_verdicts_equal(v1, v8, f"step {step}")

    def test_parity_with_ns_guard_boundary_crossing(self, mesh):
        rules = [
            ClusterFlowRule(
                flow_id=i, count=1e9, mode=G, namespace=f"ns{i % 3}"
            )
            for i in range(12)
        ]
        table, index = build_rule_table(CFG, rules, ns_max_qps=7.0,
                                        device=CPU)
        sharded_step = make_sharded_decide(CFG, mesh)
        state_1 = make_state(CFG, device=CPU)
        state_8 = shard_state(make_state(CFG, device=CPU), mesh)
        table_8 = shard_rules(table, mesh)
        rng = np.random.default_rng(7)
        now = 10_000
        saw_crossing = False
        for step in range(5):
            now += int(rng.integers(20, 300))
            flows = rng.integers(0, 12, size=48)
            slots = [index.lookup(int(f)) for f in flows]
            batch = make_batch(CFG, slots)
            state_1, v1 = decide(CFG, state_1, table, batch, now)
            state_8, v8 = sharded_step(state_8, table_8, batch, now)
            assert_verdicts_equal(v1, v8, f"step {step} under ns guard")
            st = v1.status.numpy()[:48]
            ns_of = np.asarray([int(f) % 3 for f in flows])
            for ns in range(3):
                sel = st[ns_of == ns]
                saw_crossing |= bool(
                    (sel == TokenStatus.OK).any()
                    and (sel == TokenStatus.TOO_MANY_REQUEST).any()
                )
        assert saw_crossing, "scenario never hit the precise (crossing) arm"

    def test_state_actually_sharded(self, mesh):
        state = shard_state(make_state(CFG, device=CPU), mesh)
        shards = state.flow.counts.shards
        assert len(shards) == 8
        assert shards[0].shape[0] == CFG.max_flows // 8

    def test_occupy_starts_stay_replicated_after_borrow(self, mesh):
        rules, table, index = _build(num_rules=4, count=3.0)
        sharded_step = make_sharded_decide(CFG, mesh)
        state = shard_state(make_state(CFG, device=CPU), mesh)
        table_8 = shard_rules(table, mesh)
        slot = index.lookup(0)
        state, _ = sharded_step(
            state, table_8, make_batch(CFG, [slot] * 3), 10_050
        )
        state, v = sharded_step(
            state, table_8,
            make_batch(CFG, [slot], prioritized=[True]), 10_950,
        )
        assert int(v.status[0]) == TokenStatus.SHOULD_WAIT
        starts_shards = [s.numpy() for s in state.occupy.starts.shards]
        for s in starts_shards[1:]:
            np.testing.assert_array_equal(starts_shards[0], s)

    def test_uneven_mesh_rejected(self, mesh):
        bad = EngineConfig(max_flows=60, max_namespaces=4, batch_size=16)
        with pytest.raises(ValueError, match="divisible"):
            make_sharded_decide(bad, mesh)

    def test_cross_shard_budget_enforced(self, mesh):
        rules, table, index = _build(num_rules=16, count=2.0)
        sharded_step = make_sharded_decide(CFG, mesh)
        state = shard_state(make_state(CFG, device=CPU), mesh)
        table_8 = shard_rules(table, mesh)
        slots = [index.lookup(i % 16) for i in range(64)]
        batch = make_batch(CFG, slots)
        state, v = sharded_step(state, table_8, batch, 10_000)
        st = v.status.numpy()
        ok_per_flow = {}
        for i in range(64):
            f = i % 16
            ok_per_flow[f] = ok_per_flow.get(f, 0) + (st[i] == TokenStatus.OK)
        for f in range(16):
            assert ok_per_flow[f] == 2 + (f % 3)


class TestShardedDonationAndFusion:
    def test_sharded_step_donates_state(self, mesh):
        """The port's donation is an in-place update: the returned state is
        the input's tensors; without ``donate`` the input is left as it
        was."""
        rules, table, index = _build()
        step = make_sharded_decide(CFG, mesh, donate=True)
        state = shard_state(make_state(CFG, device=CPU), mesh)
        table_8 = shard_rules(table, mesh)
        batch = make_batch(CFG, [index.lookup(0)] * 4)
        ptrs = [p.data_ptr() for p in state.flow.counts.shards]
        new_state, _ = step(state, table_8, batch, 10_000)
        assert new_state.flow.counts is state.flow.counts
        assert [p.data_ptr() for p in new_state.flow.counts.shards] == ptrs
        assert int(_np(state.flow.counts).sum()) > 0
        assert len(new_state.flow.counts.shards) == 8
        pure = make_sharded_decide(CFG, mesh)
        before = _np(new_state.flow.counts).copy()
        after, _ = pure(new_state, table_8, batch, 10_000)
        np.testing.assert_array_equal(_np(new_state.flow.counts), before)
        assert int(_np(after.flow.counts).sum()) > int(before.sum())

    @pytest.mark.parametrize("depth", [2, 4])
    def test_fused_sharded_bit_identical_per_frame(self, mesh, depth):
        rules, table, index = _build(num_rules=16, count=6.0)
        table_8 = shard_rules(table, mesh)
        plain = make_sharded_decide(CFG, mesh, grouped=True, uniform=True)
        fused = make_sharded_decide(
            CFG, mesh, grouped=True, uniform=True, donate=True, depth=depth
        )
        rng = np.random.default_rng(11)
        frames = []
        for _ in range(depth):
            slots = np.sort(np.asarray(
                [index.lookup(int(f))
                 for f in rng.integers(0, 16, CFG.batch_size)], np.int32,
            ))
            frames.append(make_batch(CFG, slots))
        seq_state = shard_state(make_state(CFG, device=CPU), mesh)
        seq_verdicts = []
        for b in frames:
            seq_state, v = plain(seq_state, table_8, b, 10_000)
            seq_verdicts.append(v)
        stacked = RequestBatch(*(
            np.stack([getattr(b, k) for b in frames])
            for k in RequestBatch._fields
        ))
        fused_state = shard_state(make_state(CFG, device=CPU), mesh)
        out_state, fv = fused(fused_state, table_8, stacked, 10_000)
        assert out_state.flow.counts is fused_state.flow.counts  # donated
        for f in range(depth):
            for leaf in ("status", "wait_ms", "remaining"):
                np.testing.assert_array_equal(
                    getattr(seq_verdicts[f], leaf).numpy(),
                    getattr(fv, leaf)[f].numpy(),
                    err_msg=f"fused frame {f} {leaf} diverged",
                )
        np.testing.assert_array_equal(_np(out_state.flow.counts),
                                      _np(seq_state.flow.counts))

    def test_host_rows_gathers_sharded_and_replicated(self, mesh):
        state = shard_state(make_state(CFG, device=CPU), mesh)
        ramp = torch.arange(64, dtype=torch.int32)[:, None, None]
        state.flow.counts.assign_(state.flow.counts.full() + ramp)
        rows = np.asarray([0, 7, 8, 33, 63], np.int32)  # spans 4 shards
        got = S.host_rows(state.flow.counts, rows)
        np.testing.assert_array_equal(got, _np(state.flow.counts)[rows])
        got_s = S.host_rows(state.flow.starts, np.asarray([0, 1], np.int32))
        np.testing.assert_array_equal(got_s, _np(state.flow.starts)[:2])


class TestShardedSnapshotRoundTrip:
    def _primed(self, mesh):
        svc = (DefaultTokenService(CFG, device=CPU) if mesh is None
               else DefaultTokenService(CFG, mesh=mesh))
        svc.load_rules(
            [ClusterFlowRule(flow_id=i, count=1e9, mode=G) for i in range(16)]
        )
        ids = np.tile(np.arange(16, dtype=np.int64), 8)
        svc.request_batch_arrays(ids)
        return svc

    @staticmethod
    def _standby(standby_devices, **kw):
        if standby_devices == 1:
            return DefaultTokenService(CFG, device=CPU, **kw)
        return DefaultTokenService(
            CFG, mesh=make_flow_mesh([CPU] * standby_devices), **kw
        )

    @pytest.mark.parametrize("standby_devices", [1, 4])
    def test_mesh_snapshot_onto_different_mesh_shape(
        self, mesh, standby_devices
    ):
        svc = self._primed(mesh)
        snap = svc.export_state()
        standby = self._standby(standby_devices)
        standby.import_state(snap)
        np.testing.assert_array_equal(_np(standby._state.flow.counts),
                                      _np(svc._state.flow.counts))
        np.testing.assert_array_equal(_np(standby._state.ns.counts),
                                      _np(svc._state.ns.counts))
        if standby_devices != 1:
            assert (len(standby._mesh_state.sharded.flow.counts.shards)
                    == standby_devices)
        ids = np.tile(np.arange(16, dtype=np.int64), 4)
        s_p, r_p, w_p = svc.request_batch_arrays(ids)
        s_s, r_s, w_s = standby.request_batch_arrays(ids)
        np.testing.assert_array_equal(s_p, s_s)
        np.testing.assert_array_equal(r_p, r_s)
        svc.close()
        standby.close()

    def test_single_shard_snapshot_onto_mesh(self, mesh):
        svc = self._primed(None)
        snap = svc.export_state()
        standby = DefaultTokenService(CFG, mesh=mesh)
        standby.import_state(snap)
        np.testing.assert_array_equal(_np(standby._state.flow.counts),
                                      _np(svc._state.flow.counts))
        assert len(standby._mesh_state.sharded.flow.counts.shards) == 8
        svc.close()
        standby.close()

    @pytest.mark.parametrize("standby_devices", [1, 4])
    def test_param_sketch_state_survives_snapshot(
        self, mesh, standby_devices, port_clock
    ):
        pc = ParamConfig(
            max_param_rules=8, depth=2, width=32, sketch="salsa", impl="jax"
        )
        svc = DefaultTokenService(CFG, mesh=mesh, param_config=pc)
        svc.load_param_rules([ClusterParamFlowRule(flow_id=3, count=1e9)])
        rng = np.random.default_rng(3)
        vals = rng.integers(-2 ** 63, 2 ** 63 - 1, size=16, dtype=np.int64)
        stream = vals[rng.integers(0, 16, size=600)]
        for off in range(0, 600, 50):
            svc.request_params_token(
                3, 1024, [int(h) for h in stream[off:off + 50]]
            )
        assert int(svc._param_state.merges.sum()) > 0, (
            "stream too cold to exercise the merge path"
        )
        snap = svc.export_state()
        standby = self._standby(standby_devices, param_config=pc)
        standby.import_state(snap)
        for field in ("starts", "counts", "slim", "slim_auth", "merges"):
            np.testing.assert_array_equal(
                _np(getattr(standby._param_state, field)),
                _np(getattr(svc._param_state, field)),
                err_msg=field,
            )
        hot, cold = int(stream[0]), int(vals[-1])
        for value in (hot, cold):
            r_p = svc.request_params_token(3, 1, [value])
            r_s = standby.request_params_token(3, 1, [value])
            assert (r_p.status, r_p.remaining) == (r_s.status, r_s.remaining)
        svc.close()
        standby.close()


class TestMeshBackedService:
    def test_serves_and_enforces_over_mesh(self, mesh):
        svc = DefaultTokenService(CFG, mesh=mesh)
        svc.load_rules(
            [ClusterFlowRule(flow_id=i, count=3.0, mode=G) for i in range(16)]
        )
        svc.warmup()
        res = svc.request_batch([(1, 1, False)] * 5)
        statuses = [r.status for r in res]
        assert statuses.count(TokenStatus.OK) == 3, statuses
        assert statuses.count(TokenStatus.BLOCKED) == 2, statuses
        assert svc.request_token(99).status == TokenStatus.NO_RULE_EXISTS
        snap = svc.metrics_snapshot()
        assert snap[1]["pass_qps"] > 0
        assert len(svc._mesh_state.sharded.flow.counts.shards) == 8
        svc.close()

    def test_fusion_ladder_active_under_mesh(self, mesh):
        from sentinel_tpu_torch.metrics.server import server_metrics

        rules = [
            ClusterFlowRule(flow_id=i, count=1e9, mode=G) for i in range(16)
        ]
        svc8 = DefaultTokenService(CFG, mesh=mesh, fuse_depths=(4, 2))
        svc8.load_rules(rules, ns_max_qps=1e12)
        svc8.warmup()
        svc1 = DefaultTokenService(CFG, device=CPU, fuse_depths=(4, 2))
        svc1.load_rules(rules, ns_max_qps=1e12)
        svc1.warmup()
        before = server_metrics().fused_frames_total
        ids = np.tile(np.arange(16, dtype=np.int64), (5 * CFG.batch_size) // 16)
        s8, r8, w8 = svc8.request_batch_arrays(ids)
        assert server_metrics().fused_frames_total - before >= 4
        s1, r1, w1 = svc1.request_batch_arrays(ids)
        np.testing.assert_array_equal(s8, s1)
        np.testing.assert_array_equal(r8, r1)
        np.testing.assert_array_equal(w8, w1)
        svc8.close()
        svc1.close()

    def test_rule_reload_keeps_serving(self, mesh):
        svc = DefaultTokenService(CFG, mesh=mesh)
        svc.load_rules([ClusterFlowRule(flow_id=1, count=1e9, mode=G)])
        svc.warmup()
        assert svc.request_token(1).status == TokenStatus.OK
        svc.load_rules(
            [ClusterFlowRule(flow_id=f, count=1e9, mode=G) for f in (1, 2)]
        )
        assert svc.request_token(2).status == TokenStatus.OK
        assert svc.request_token(1).status == TokenStatus.OK
        svc.close()


class TestMegakernelStateContract:
    """The kernel's core (``decide_impl="pallas"``; on CPU tensors its plain
    version) as a drop-in for the torch-ops pipeline under the mesh."""

    def _sorted_batch(self, index, rng, n_rules=16):
        slots = np.sort(np.asarray(
            [index.lookup(int(f))
             for f in rng.integers(0, n_rules, CFG.batch_size)], np.int32,
        ))
        return make_batch(CFG, slots)

    def test_sharded_donation_holds_under_pallas_step(self, mesh):
        cfg = CFG._replace(decide_impl="pallas")
        rules, table, index = _build(num_rules=16)
        step = make_sharded_decide(
            cfg, mesh, grouped=True, uniform=True, donate=True
        )
        state = shard_state(make_state(cfg, device=CPU), mesh)
        table_8 = shard_rules(table, mesh)
        batch = self._sorted_batch(index, np.random.default_rng(5))
        ptrs = [p.data_ptr() for p in state.flow.counts.shards]
        new_state, _ = step(state, table_8, batch, 10_000)
        assert [p.data_ptr() for p in new_state.flow.counts.shards] == ptrs
        assert new_state.occupy.counts is state.occupy.counts
        assert len(new_state.flow.counts.shards) == 8

    def test_single_shard_donation_holds_under_pallas_step(self):
        cfg = CFG._replace(decide_impl="pallas")
        rules, table, index = _build(num_rules=16)
        step = decide_donating(cfg, grouped=True, uniform=True)
        state = make_state(cfg, device=CPU)
        ptr = state.flow.counts.data_ptr()
        batch = self._sorted_batch(index, np.random.default_rng(6))
        new_state, _ = step(state, table, batch, 10_000)
        assert new_state.flow.counts.data_ptr() == ptr
        assert int(new_state.flow.counts.sum()) > 0

    def test_sharded_state_bytes_identical_across_impls(self, mesh):
        rules, table, index = _build(num_rules=16, count=6.0)
        table_8 = shard_rules(table, mesh)
        rng = np.random.default_rng(7)
        batches = [self._sorted_batch(index, rng) for _ in range(4)]
        finals = {}
        for impl in ("xla", "pallas"):
            cfg = CFG._replace(decide_impl=impl)
            step = make_sharded_decide(cfg, mesh, grouped=True, uniform=True)
            st = shard_state(make_state(cfg, device=CPU), mesh)
            for i, b in enumerate(batches):
                st, _ = step(st, table_8, b, 10_000 + 37 * i)
            finals[impl] = interop.state_to_numpy(st)
        for key, leaf_x in finals["xla"].items():
            assert_arrays_equal(leaf_x, finals["pallas"][key], key)


# ---------------------------------------------------------------------------
# Cross-package parity: the JAX 8-device mesh against the port's 8 shards
# ---------------------------------------------------------------------------

PKW = dict(max_flows=64, max_namespaces=4, batch_size=64)
N_FLOWS = 40
NOW0 = 20_000


def _flow_specs(n_flows=N_FLOWS):
    rng = np.random.default_rng(0x5A4D)
    return [dict(
        flow_id=100 + i,
        count=float(rng.integers(2, 12)),
        mode=int(rng.integers(0, 2)),
        namespace=f"ns{i % 3}",
        control_behavior=int(rng.choice([0, 0, 0, 1, 2, 3])),
        max_queueing_time_ms=int(rng.integers(100, 600)),
    ) for i in range(n_flows)]


def _degrade_specs():
    return [dict(
        flow_id=100 + i,
        strategy=i % 3,
        threshold=3.0 if i % 3 == 2 else 0.4,
        slow_rt_ms=50,
        min_request_amount=3,
        stat_interval_ms=1000,
        recovery_timeout_ms=300,
        namespace=f"ns{i % 3}",
    ) for i in range(0, N_FLOWS, 3)]


def _tables(degrade: bool, n_flows=N_FLOWS):
    flows = _flow_specs(n_flows)
    degr = _degrade_specs() if degrade else []
    j_table, j_index = j_build(
        JConfig(**PKW),
        [JRule(**{**f, "mode": JTM(f["mode"]),
                  "control_behavior": JCB(f["control_behavior"])})
         for f in flows],
        ns_max_qps=40.0,
        degrade_rules=[JDegrade(**{**d, "strategy": JDS(d["strategy"])})
                       for d in degr],
    )
    t_table, t_index = build_rule_table(
        EngineConfig(**PKW),
        [ClusterFlowRule(**{**f, "mode": ThresholdMode(f["mode"]),
                            "control_behavior": ControlBehavior(
                                f["control_behavior"])})
         for f in flows],
        ns_max_qps=40.0,
        degrade_rules=[DegradeRule(**{**d,
                                      "strategy": DegradeStrategy(
                                          d["strategy"])})
                       for d in degr],
        device=CPU,
    )
    assert dict(j_index.slot_of) == dict(t_index.slot_of)
    return j_table, t_table, t_index


def _initial_state(degrade: bool):
    """A numpy state dict: cold, or with a recent outcome window and a mix
    of breaker states, so that the breakers trip, wait, probe and re-arm."""
    d = interop.state_to_numpy(j_make_state(JConfig(**PKW)))
    if not degrade:
        return d
    rng = np.random.default_rng(0xB4EA)
    bucket, nb = 100, d["outcome.starts"].shape[0]
    cur = NOW0 - NOW0 % bucket
    for k in range(nb):
        start = cur - k * bucket
        d["outcome.starts"][(start // bucket) % nb] = start
    counts = d["outcome.counts"]
    complete = rng.integers(0, 6, counts.shape[:2])
    counts[:, :, 0] = complete
    counts[:, :, 1] = rng.integers(0, 1 + complete)
    counts[:, :, 2] = rng.integers(0, 1 + complete)
    d["breaker.state"][:] = rng.integers(0, 3, d["breaker.state"].shape)
    d["breaker.opened_ms"][:] = NOW0 - rng.integers(0, 600,
                                                    d["breaker.opened_ms"].shape)
    d["breaker.probe_ms"][:] = NOW0 - rng.integers(0, 600,
                                                   d["breaker.probe_ms"].shape)
    return d


_J_PLANES = {"flow": JWindow, "occupy": JWindow, "ns": JWindow,
             "shaping": JShaping, "outcome": JWindow, "breaker": JBreaker}


def _jax_state(d):
    return JState(**{
        plane: cls(**{f: jnp.asarray(d[f"{plane}.{f}"]) for f in cls._fields})
        for plane, cls in _J_PLANES.items()
    })


def _stream(index, grouped: bool, depth, seed: int, steps: int):
    """``steps`` device calls: batches (``depth`` stacked frames when
    fused) of Zipf flows with unknown flows and, ungrouped, mixed acquires
    and prioritized rows."""
    rng = np.random.default_rng(seed)
    frames = 1 if depth is None else depth
    w = np.arange(1, N_FLOWS + 4, dtype=np.float64) ** -1.1
    cdf = np.cumsum(w / w.sum())
    calls, now = [], NOW0
    for _ in range(steps):
        now += int(rng.integers(40, 260))
        batches = []
        for _f in range(frames):
            n = int(rng.integers(20, PKW["batch_size"] + 1))
            k = np.minimum(np.searchsorted(cdf, rng.random(n)), N_FLOWS + 2)
            slots = np.asarray([index.lookup(100 + int(i)) if i < N_FLOWS
                                else -1 for i in k], np.int32)
            if grouped:
                slots = np.sort(slots)
                batches.append(dict(slots=slots, acq=None, prio=None))
            else:
                batches.append(dict(
                    slots=slots,
                    acq=rng.integers(1, 4, n).astype(np.int32),
                    prio=rng.random(n) < 0.2,
                ))
        calls.append((now, batches))
    return calls


def _batch(make, cfg, b):
    return make(cfg, b["slots"], b["acq"],
                None if b["prio"] is None else b["prio"].tolist())


def _stack(batches):
    return type(batches[0])(*(
        np.stack([np.asarray(getattr(b, k)) for b in batches])
        for k in batches[0]._fields
    ))


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return j_make_mesh()


_J_RUNS = {}


def _jax_run(jax_mesh, grouped, depth, degrade):
    """The JAX mesh's verdicts and final state for one stream (cached: the
    port's impls are held against the same run)."""
    key = (grouped, depth, degrade)
    if key not in _J_RUNS:
        j_table, _t_table, index = _tables(degrade)
        jcfg = JConfig(**PKW)
        step = j_sharded(jcfg, jax_mesh, grouped=grouped, uniform=grouped,
                         depth=depth)
        st = j_shard_state(_jax_state(_initial_state(degrade)), jax_mesh)
        tb = j_shard_rules(j_table, jax_mesh)
        verdicts = []
        for now, batches in _stream(index, grouped, depth, 11, 5):
            bs = [_batch(j_make_batch, jcfg, b) for b in batches]
            b = bs[0] if depth is None else _stack(bs)
            st, v = step(st, tb, b, jnp.int32(now))
            verdicts.append(jax.tree.map(np.asarray, v))
        _J_RUNS[key] = (verdicts, interop.state_to_numpy(st))
    return _J_RUNS[key]


@pytest.mark.parametrize("degrade", [False, True], ids=["plain", "degrade"])
@pytest.mark.parametrize("depth", [None, 2, 4], ids=["d1", "d2", "d4"])
@pytest.mark.parametrize("grouped,impl", [
    (False, "xla"), (True, "xla"), (True, "pallas"),
], ids=["ungrouped", "grouped", "grouped-kernel"])
def test_port_mesh_matches_jax_mesh(mesh, jax_mesh, grouped, impl, depth,
                                    degrade):
    """The same seeded stream through the JAX 8-device mesh and the port's
    8-shard mesh: every verdict and every state leaf bitwise equal."""
    j_verdicts, j_final = _jax_run(jax_mesh, grouped, depth, degrade)
    j_table, t_table, index = _tables(degrade)
    cfg = EngineConfig(**PKW, decide_impl=impl)
    step = make_sharded_decide(cfg, mesh, grouped=grouped, uniform=grouped,
                               donate=True, depth=depth)
    st = interop.state_from_numpy(_initial_state(degrade), mesh=mesh)
    # the table crosses from the JAX mesh's sharded arrays to the port's
    tb = interop.rules_from_numpy(
        interop.rules_to_numpy(j_shard_rules(j_table, jax_mesh)), mesh=mesh)
    assert_arrays_equal(np.asarray(tb.count), t_table.count, "rules")
    statuses = set()
    for k, (now, batches) in enumerate(_stream(index, grouped, depth, 11, 5)):
        bs = [_batch(make_batch, cfg, b) for b in batches]
        b = bs[0] if depth is None else _stack(bs)
        st, v = step(st, tb, b, now)
        assert_verdicts_equal(j_verdicts[k], v, f"call {k}")
        statuses |= set(v.status.numpy().ravel().tolist())
    got = interop.state_to_numpy(st)
    for key, ref in j_final.items():
        assert_arrays_equal(ref, got[key], key)
    assert {TokenStatus.OK, TokenStatus.BLOCKED} <= statuses
    if degrade:
        assert TokenStatus.DEGRADED in statuses


# ---------------------------------------------------------------------------
# Each shard decides only its own rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots,rows,runs,n_runs", [
    # sorted, with unknown flows first and padding last: one run a shard
    ([-1, -1, 0, 1, 1, 9, 17, 30, -1, -1],
     [[2, 3, 4], [5], [6], [7]], [[0, 0, 0], [1], [2], [3]], 4),
    # shard 1 owns no row
    ([0, 0, 3, 16, 24, 31, -1],
     [[0, 1, 2], [], [3], [4, 5]], [[0, 0, 0], [], [1], [2, 2]], 3),
    # interleaved, and a slot beyond the table
    ([9, 0, 1, 9, 40, 25, 2, 8],
     [[1, 2, 6], [0, 3, 7], [], [5]], [[1, 1, 4], [0, 2, 5], [], [3]], 6),
], ids=["sorted", "empty-shard", "interleaved"])
def test_split_rows_gives_each_shard_its_own_rows(slots, rows, runs, n_runs):
    split = S.split_rows(np.asarray(slots, np.int32), 8, 4)
    assert split.n_runs == n_runs
    assert split.rows.dtype == split.runs.dtype == np.int64
    for s in range(4):
        lo, hi = split.cuts[s], split.cuts[s + 1]
        for got, want in ((split.rows[lo:hi], rows[s]),
                          (split.runs[lo:hi], runs[s])):
            np.testing.assert_array_equal(got, np.asarray(want, np.int64),
                                          err_msg=str(s))


N_ALL = PKW["max_flows"]  # a rule in every slot: every shard owns flows
F_LOCAL = N_ALL // 8


def _owned_stream(index, grouped: bool, empty_shard, seed: int):
    """Three batches over all 64 flows, unknown flows and padding, with
    acquires and prioritized rows when ungrouped. ``empty_shard`` owns rows
    of the first batch only; the second comes one window later, into the
    bucket those rows were counted in, so the empty shard's step must
    still roll its window."""
    rng = np.random.default_rng(seed)
    every = list(range(N_ALL))
    rest = [f for f in every
            if index.lookup(100 + f) // F_LOCAL != empty_shard]
    calls, now = [], NOW0
    for k in range(3):
        if k == 1 and empty_shard is not None:
            now += EngineConfig(**PKW).interval_ms
        else:
            now += int(rng.integers(40, 260))
        flows = every if k == 0 else rest
        n = int(rng.integers(40, PKW["batch_size"]))
        pick = rng.integers(0, len(flows) + 2, n)
        slots = np.asarray([index.lookup(100 + flows[i]) if i < len(flows)
                            else -1 for i in pick], np.int32)
        if grouped:
            calls.append((now, dict(slots=np.sort(slots), acq=None,
                                    prio=None)))
        else:
            calls.append((now, dict(
                slots=slots, acq=rng.integers(1, 4, n).astype(np.int32),
                prio=rng.random(n) < 0.2)))
    return calls


def _recorder(monkeypatch, impl, seen):
    """Record the global slots of every row each shard's decide sees: under
    the kernel's core through its plain version (one call a launch), else
    through the core itself."""
    from sentinel_tpu_torch.ops import decide_cuda as K

    if impl == "pallas":
        plain = K.decide_rows_plain

        def rows_plain(config, flow_counts, *args, **kwargs):
            seen.append((flow_counts.data_ptr(), args[4]["safe_slot"]))
            return plain(config, flow_counts, *args, **kwargs)

        monkeypatch.setattr(K, "decide_rows_plain", rows_plain)
        return
    real = S._core_for

    def core_for(config, grouped, device):
        core = real(config, grouped, device)

        def recording(config, state, rules, batch, now, **kw):
            local = torch.as_tensor(batch.flow_slot) - kw["axis"].rank * (
                rules.valid.shape[0])
            seen.append((state.flow.counts.data_ptr(), local))
            return core(config, state, rules, batch, now, **kw)

        return recording

    monkeypatch.setattr(S, "_core_for", core_for)


@pytest.mark.parametrize("empty_shard", [None, 2],
                         ids=["every-shard", "shard-2-empty"])
@pytest.mark.parametrize("grouped,impl", [
    (False, "xla"), (True, "xla"), (True, "pallas"),
], ids=["ungrouped", "grouped", "grouped-kernel"])
def test_each_shard_decides_only_its_own_rows(mesh, jax_mesh, monkeypatch,
                                               grouped, impl, empty_shard):
    """With a rule in every slot, each shard's decide sees exactly the
    batch's rows in its slot range, in batch order (none for a shard that
    owns no row: under the kernel's core its launch only rolls the
    window); the verdicts and every state leaf equal the JAX 8-device
    mesh's."""
    j_table, _t_table, index = _tables(False, n_flows=N_ALL)
    calls = _owned_stream(index, grouped, empty_shard, 23)
    jcfg = JConfig(**PKW)
    j_step = j_sharded(jcfg, jax_mesh, grouped=grouped, uniform=grouped)
    j_st = j_shard_state(_jax_state(_initial_state(False)), jax_mesh)
    j_tb = j_shard_rules(j_table, jax_mesh)

    cfg = EngineConfig(**PKW, decide_impl=impl)
    step = make_sharded_decide(cfg, mesh, grouped=grouped, uniform=grouped,
                               donate=True)
    st = interop.state_from_numpy(_initial_state(False), mesh=mesh)
    tb = interop.rules_from_numpy(interop.rules_to_numpy(j_tb), mesh=mesh)
    rank_of = {p.data_ptr(): r for r, p in enumerate(st.flow.counts.parts)}
    seen = []
    _recorder(monkeypatch, impl, seen)
    for k, (now, b) in enumerate(calls):
        j_st, jv = j_step(j_st, j_tb, _batch(j_make_batch, jcfg, b),
                          jnp.int32(now))
        seen.clear()
        st, v = step(st, tb, _batch(make_batch, cfg, b), now)
        assert_verdicts_equal(jax.tree.map(np.asarray, jv), v, f"call {k}")
        got = {}
        for ptr, local in seen:
            assert rank_of[ptr] not in got, "two decides on one shard"
            got[rank_of[ptr]] = local.numpy() + rank_of[ptr] * F_LOCAL
        slots = b["slots"]
        assert sorted(got) == list(range(8)), f"call {k}: {sorted(got)}"
        for r in range(8):
            want = slots[(slots >= r * F_LOCAL) & (slots < (r + 1) * F_LOCAL)]
            np.testing.assert_array_equal(got[r], want,
                                          err_msg=f"call {k} shard {r}")
            assert (want.shape[0] == 0) == (r == empty_shard and k > 0), (
                k, r)
        owned = sum(g.shape[0] for g in got.values())
        assert owned == int((slots >= 0).sum()) < PKW["batch_size"]
    want_state = interop.state_to_numpy(j_st)
    got_state = interop.state_to_numpy(st)
    for key, ref in want_state.items():
        assert_arrays_equal(ref, got_state[key], key)


# ---------------------------------------------------------------------------
# Snapshots across packages and mesh shapes
# ---------------------------------------------------------------------------

_PLANE_KEYS = ("flow", "occupy", "ns", "outcome", "shaping", "breaker",
               "param")


def _same(_label, results):
    H.same(results)


def _assert_rows_equal(primary, standby, label):
    """Every flow, namespace and param row, matched by flow id and name:
    a restore reloads the rules, so the slots may differ."""
    bad = R.flow_rows_diff(primary, standby)
    for field in ("counts", "slim"):
        bad += R.param_rows_diff(primary, standby, field)
    assert not bad, f"{label}: {bad}"


def _assert_docs_equal(a, b, label):
    """Two snapshot documents equal in every key."""
    assert sorted(a) == sorted(b), label
    for key in a:
        x, y = a[key], b[key]
        if key in _PLANE_KEYS:
            assert sorted(x) == sorted(y), f"{label}: {key}"
            for f in x:
                assert_arrays_equal(x[f], y[f], f"{label}: {key}.{f}")
        else:
            assert x == y, f"{label}: {key}"


def _jax_service(devices):
    cfg = JConfig(decide_impl="xla", **H.KW)
    mesh = None if devices is None else j_make_mesh(jax.devices()[:devices])
    return JService(cfg, param_config=H.JAX.pconfig(**H.PKW), mesh=mesh,
                    fuse_depths=())


def _port_service(devices):
    kw = (dict(device=CPU) if devices is None
          else dict(mesh=make_flow_mesh([CPU] * devices)))
    return DefaultTokenService(EngineConfig(**H.KW),
                               param_config=ParamConfig(**H.PKW),
                               fuse_depths=(), **kw)


def _load(kind, svc):
    k = H.KINDS[kind]
    svc.load_rules([k.rule(**{**r, "mode": k.mode(r["mode"]),
                              "control_behavior": k.behavior(
                                  r["control_behavior"])})
                    for r in H.FLOW])
    svc.load_degrade_rules([k.degrade(**{**d, "strategy": k.strategy(
        d["strategy"])}) for d in H.DEGRADE])
    svc.load_param_rules([k.param_rule(**p) for p in H.PARAM])


@pytest.mark.parametrize("source", ["jax", "port"])
def test_snapshot_crosses_packages_and_mesh_shapes(source):
    """A primary on an 8-shard mesh of one package; its snapshot restores
    into the other package's services of 8, 2 and no shards. Every
    standby's rows equal the primary's, the port standbys' own snapshots
    equal each other in every key, and the next pulls, reports and param
    requests agree everywhere."""
    make_primary = _jax_service if source == "jax" else _port_service
    make_standby = _port_service if source == "jax" else _jax_service
    with H.manual_clocks() as clocks:
        primary = make_primary(8)
        _load(source, primary)
        rng = np.random.default_rng(0x5EED)
        H.traffic([primary], clocks, rng, 4, lambda *_: None)
        snap = primary.export_state()
        standbys = []
        for devices in (8, 2, None):
            s = make_standby(devices)
            s.import_state(snap)
            standbys.append(s)
        for devices, s in zip((8, 2, None), standbys):
            _assert_rows_equal(primary, s, f"standby on {devices}")
        docs = [s.export_state() for s in standbys]
        if source == "jax":
            # the port's standbys on 8, 2 and no shards
            for doc in docs[1:]:
                _assert_docs_equal(docs[0], doc, "port documents")
        H.traffic([primary, *standbys], clocks, rng, 3, _same)
        for s in (primary, *standbys):
            s.close()


# ---------------------------------------------------------------------------
# Failure, and a mesh of several devices
# ---------------------------------------------------------------------------


def test_a_shard_that_raises_fails_the_step_and_frees_every_thread(
    mesh, monkeypatch
):
    """Shard 5 raises at its third collective (psum or pmax), mid-step:
    the step raises that error, every other shard leaves its barrier, and
    the mesh serves the next step."""
    rules, table, index = _build()
    step = make_sharded_decide(CFG, mesh, donate=True)
    state = shard_state(make_state(CFG, device=CPU), mesh)
    table_8 = shard_rules(table, mesh)
    batch = make_batch(CFG, [index.lookup(i % 20) for i in range(40)])
    real = S._run_shard

    def run_shard(fn, rank, coll):
        if rank != 5:
            return real(fn, rank, coll)
        calls = [0]

        def failing(r, ax):
            def counted(collective):
                def call(t):
                    calls[0] += 1
                    if calls[0] == 3:
                        raise RuntimeError("shard 5 failed")
                    return collective(t)

                return call

            return fn(r, ax._replace(psum=counted(ax.psum),
                                     pmax=counted(ax.pmax)))

        return real(failing, rank, coll)

    monkeypatch.setattr(S, "_run_shard", run_shard)
    out = {}

    def run():
        try:
            step(state, table_8, batch, 10_000)
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "a shard is still blocked"
    assert isinstance(out.get("error"), RuntimeError), out
    assert "shard 5 failed" in str(out["error"])
    monkeypatch.setattr(S, "_run_shard", real)
    _, v1 = decide(CFG, make_state(CFG, device=CPU), table, batch, 10_000)
    _, v8 = step(shard_state(make_state(CFG, device=CPU), mesh), table_8,
                 batch, 10_000)
    assert_verdicts_equal(v1, v8, "after the failed step")


@pytest.fixture
def several_devices(monkeypatch):
    """The copy path of a mesh whose shards sit on different devices: on
    the CPU every shard is ``cpu``, so the view sharing is switched off."""
    monkeypatch.setattr(S.FlowMesh, "single_device", property(lambda s: False))


def test_mesh_of_several_devices_keeps_parity(several_devices):
    mesh4 = make_flow_mesh([CPU] * 4)
    rules, table, index = _build()
    state = shard_state(make_state(CFG, device=CPU), mesh4)
    assert state.flow.counts.base is None
    step = make_sharded_decide(CFG, mesh4, donate=True)
    table_4 = shard_rules(table, mesh4)
    ref = make_state(CFG, device=CPU)
    rng = np.random.default_rng(5)
    now = 10_000
    for k in range(4):
        now += int(rng.integers(20, 400))
        slots = [index.lookup(int(f)) if f >= 0 else -1
                 for f in rng.integers(-1, 20, size=48)]
        batch = make_batch(CFG, slots, prioritized=(rng.random(48) < 0.2)
                           .tolist())
        ref, v1 = decide(CFG, ref, table, batch, now)
        state, v4 = step(state, table_4, batch, now)
        assert_verdicts_equal(v1, v4, f"step {k}")
    assert_states_equal(ref, state, "several devices")


def test_service_on_several_devices_writes_host_changes_back(
    several_devices, port_clock
):
    """Host code writes through the gathered view (a reload's slot clear, a
    snapshot import, reports); the next step sees it, and the service
    answers as a service with no mesh does."""
    with H.manual_clocks() as clocks:
        svcs = [_port_service(4), _port_service(None)]
        for s in svcs:
            _load("port", s)
        rng = np.random.default_rng(9)
        H.traffic(svcs, clocks, rng, 3, _same)
        standby = _port_service(4)
        standby.import_state(svcs[1].export_state())
        _assert_rows_equal(svcs[1], standby, "import")
        H.traffic([*svcs, standby], clocks, rng, 3, _same)
        assert_states_equal(svcs[1]._state, svcs[0]._state, "services")
        for s in (*svcs, standby):
            s.close()
