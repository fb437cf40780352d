"""The port's local engine (``sentinel_tpu_torch.local``) on the CPU.

- The reference's ``tests/test_local_engine.py`` (every class),
  ``tests/test_async_entry.py`` and
  ``tests/test_stat_logger.py::TestBlockLogWiring`` on the port's engine,
  each case once with the native library's windows and once with the numpy
  ``HostWindow`` (``local.stat._NATIVE``, which ``SENTINEL_TPU_NATIVE=0``
  sets at import), on the port's ``ManualClock``.
- ``stable_param_hash`` (``core/hashing.py``) equal to the reference's over
  seeded values of every type it accepts: the param branch sends these
  hashes to the token server.
- ``NativeWindow`` against ``HostWindow`` op for op on a seeded sequence,
  and a failed build of the native library raising at the first window
  instead of falling back to numpy.
"""

import importlib
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from sentinel_tpu.core.hashing import stable_param_hash as j_hash  # noqa: E402

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
import sentinel_tpu_torch.local as sentinel  # noqa: E402
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.core.config import SentinelConfig  # noqa: E402
from sentinel_tpu_torch.core.hashing import stable_param_hash  # noqa: E402
from sentinel_tpu_torch.local import (  # noqa: E402
    AuthorityRule,
    AuthorityRuleManager,
    AuthorityStrategy,
    BlockException,
    CircuitBreakerState,
    ControlBehavior,
    DegradeException,
    DegradeGrade,
    DegradeRule,
    DegradeRuleManager,
    EntryType,
    FlowException,
    FlowGrade,
    FlowRule,
    FlowRuleManager,
    SystemBlockException,
    SystemRule,
    SystemRuleManager,
)
from sentinel_tpu_torch.local import chain as chain_mod  # noqa: E402
from sentinel_tpu_torch.local import context as ctx_mod  # noqa: E402
from sentinel_tpu_torch.local import stat  # noqa: E402
from sentinel_tpu_torch.local.chain import (  # noqa: E402
    get_cluster_node,
    reset_cluster_nodes_for_tests,
)
from sentinel_tpu_torch.local.flow import (  # noqa: E402
    RateLimiterController,
    WarmUpController,
)
from sentinel_tpu_torch.local.stat import StatisticNode  # noqa: E402
from sentinel_tpu_torch.metrics.stat_logger import (  # noqa: E402
    LOG_DIR_KEY,
    reset_registry_for_tests,
    stat_logger,
)
from sentinel_tpu_torch.native import lib as native_lib  # noqa: E402

# ``local.sph`` the module: the package's ``sph`` is the function
sph_mod = importlib.import_module("sentinel_tpu_torch.local.sph")
async_entry, entry, sph = sph_mod.async_entry, sph_mod.entry, sph_mod.sph


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` (the suite's fixture installs the JAX
    package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture(autouse=True, params=["native", "host"])
def windows(request, monkeypatch):
    """Every case once on the native library's windows, once on numpy's."""
    monkeypatch.setattr(stat, "_NATIVE", request.param == "native")
    return request.param


@pytest.fixture
def clean_engine(manual_clock):
    sentinel.reset_for_tests()
    yield manual_clock
    sentinel.reset_for_tests()


def hammer(resource, n, origin="", entry_type=EntryType.OUT, prioritized=False):
    """Issue n entries; return (passed, blocked)."""
    ok = blocked = 0
    for _ in range(n):
        if origin:
            sentinel.enter_context("ctx_" + origin, origin)
        try:
            with sentinel.entry(resource, entry_type=entry_type, prioritized=prioritized):
                ok += 1
        except BlockException:
            blocked += 1
        finally:
            if origin:
                sentinel.exit_context()
    return ok, blocked


@pytest.mark.usefixtures("clean_engine")
class TestEntryBasics:
    def test_pass_through_without_rules(self, manual_clock):
        ok, blocked = hammer("free", 50)
        assert (ok, blocked) == (50, 0)

    def test_statistics_recorded(self, manual_clock):
        for _ in range(7):
            with sentinel.entry("stat_res"):
                manual_clock.sleep(10)
        cn = chain_mod.get_cluster_node("stat_res")
        assert cn is not None
        assert cn.sec.sum(manual_clock.now_ms(), 0) == 7  # PASS
        assert cn.avg_rt() == pytest.approx(10.0)
        assert cn.cur_thread_num == 0

    def test_business_exception_traced(self, manual_clock):
        with pytest.raises(ValueError):
            with sentinel.entry("exc_res"):
                raise ValueError("boom")
        cn = chain_mod.get_cluster_node("exc_res")
        assert cn.exception_qps() > 0

    def test_try_entry_returns_none_on_block(self, manual_clock):
        FlowRuleManager.load_rules([FlowRule(resource="t", count=0)])
        assert sentinel.try_entry("t") is None
        e = sentinel.try_entry("unlimited")
        assert e is not None
        e.exit()

    def test_nested_entries_link_tree(self, manual_clock):
        with sentinel.entry("parent") as p:
            with sentinel.entry("child") as c:
                assert c.parent is p
        ctx = sentinel.enter_context()
        assert ctx.cur_entry is None


@pytest.mark.usefixtures("clean_engine")
class TestFlowQps:
    def test_demo_basic_qps20(self, manual_clock):
        # sentinel-demo-basic parity: single FlowRule QPS=20 on "HelloWorld"
        FlowRuleManager.load_rules([FlowRule(resource="HelloWorld", count=20)])
        ok, blocked = hammer("HelloWorld", 100)
        assert ok == 20 and blocked == 80
        # next second: fresh window
        manual_clock.sleep(1000)
        ok2, _ = hammer("HelloWorld", 30)
        assert ok2 == 20

    def test_thread_grade(self, manual_clock):
        FlowRuleManager.load_rules(
            [FlowRule(resource="conc", count=2, grade=FlowGrade.THREAD)]
        )
        e1 = sentinel.entry("conc")
        e2 = sentinel.entry("conc")
        with pytest.raises(FlowException):
            sentinel.entry("conc")
        e1.exit()
        e3 = sentinel.entry("conc")  # capacity released
        e3.exit()
        e2.exit()

    def test_origin_specific_limit(self, manual_clock):
        # origin-specific rule tighter than default
        FlowRuleManager.load_rules(
            [
                FlowRule(resource="api", count=2, limit_app="appA"),
                FlowRule(resource="api", count=10),
            ]
        )
        okA, blockedA = hammer("api", 5, origin="appA")
        assert okA == 2 and blockedA == 3
        okB, blockedB = hammer("api", 5, origin="appB")
        assert okB == 5

    def test_limit_app_other(self, manual_clock):
        FlowRuleManager.load_rules(
            [
                FlowRule(resource="api2", count=100, limit_app="appA"),
                FlowRule(resource="api2", count=1, limit_app="other"),
            ]
        )
        okA, _ = hammer("api2", 5, origin="appA")
        assert okA == 5  # appA exempt from 'other'
        okB, blockedB = hammer("api2", 5, origin="appB")
        assert okB == 1 and blockedB == 4

    def test_relate_strategy(self, manual_clock):
        # writes throttle reads: rule on "read" relates to "write" traffic
        FlowRuleManager.load_rules(
            [
                FlowRule(
                    resource="read",
                    count=0,
                    strategy=sentinel.FlowStrategy.RELATE,
                    ref_resource="write",
                )
            ]
        )
        hammer("write", 3)  # builds write's cluster node traffic
        ok, blocked = hammer("read", 3)
        assert blocked == 3  # write qps (3) > 0 → read fully throttled

    def test_malformed_rule_does_not_abort_batch(self, manual_clock):
        # regression: WARM_UP with count=0 must not kill the whole load
        FlowRuleManager.load_rules(
            [
                FlowRule(resource="good", count=5),
                FlowRule(
                    resource="bad",
                    count=0,
                    control_behavior=ControlBehavior.WARM_UP,
                ),
            ]
        )
        assert len(FlowRuleManager.get_rules("good")) == 1
        assert FlowRuleManager.get_rules("bad") == []

    def test_identical_republish_keeps_controller_state(self, manual_clock):
        # regression: _rater must not participate in rule equality, so a
        # polling datasource republishing the same config is a no-op
        from sentinel_tpu_torch.core.property import DynamicProperty

        prop = DynamicProperty()
        FlowRuleManager.register_property(prop)
        prop.update_value([FlowRule(resource="poll", count=5)])
        rater1 = FlowRuleManager.get_rules("poll")[0]._rater
        changed = prop.update_value([FlowRule(resource="poll", count=5)])
        assert changed is False
        assert FlowRuleManager.get_rules("poll")[0]._rater is rater1

    def test_out_of_order_exit_uses_child_count(self, manual_clock):
        p = sentinel.entry("oo_parent")
        c = sentinel.entry("oo_child", count=5)
        p.exit()  # repairs stack, exiting child with its own count
        cn = chain_mod.get_cluster_node("oo_child")
        assert cn.sec.sum(manual_clock.now_ms(), 3) == 5  # SUCCESS == count

    def test_rule_reload_resets_state(self, manual_clock):
        FlowRuleManager.load_rules([FlowRule(resource="r", count=1)])
        assert hammer("r", 2) == (1, 1)
        FlowRuleManager.load_rules([FlowRule(resource="r", count=100)])
        ok, _ = hammer("r", 50)
        assert ok == 50


@pytest.mark.usefixtures("clean_engine")
class TestRateLimiterController:
    def test_paces_requests(self, manual_clock):
        ctl = RateLimiterController(count=10, max_queueing_time_ms=1000)
        node = StatisticNode()
        t0 = manual_clock.now_ms()
        for _ in range(5):
            assert ctl.can_pass(node, 1)
        # 5 requests at 10/s → last one scheduled 400ms after first
        assert manual_clock.now_ms() - t0 == pytest.approx(400, abs=1)

    def test_rejects_beyond_queue(self, manual_clock):
        ctl = RateLimiterController(count=1, max_queueing_time_ms=500)
        node = StatisticNode()
        assert ctl.can_pass(node, 1)
        assert not ctl.can_pass(node, 1)  # next token 1000ms away > 500ms queue

    def test_integrated_behavior(self, manual_clock):
        FlowRuleManager.load_rules(
            [
                FlowRule(
                    resource="paced",
                    count=100,
                    control_behavior=ControlBehavior.RATE_LIMITER,
                    max_queueing_time_ms=10_000,
                )
            ]
        )
        t0 = manual_clock.now_ms()
        ok, blocked = hammer("paced", 50)
        assert ok == 50 and blocked == 0
        assert manual_clock.now_ms() - t0 >= 480  # ~10ms spacing


class _StubNode:
    """Node with directly controlled rates — the reference's
    WarmUpControllerTest does exactly this with Mockito mocks."""

    def __init__(self):
        self.pq = 0.0
        self.ppq = 0.0

    def pass_qps(self, now=None):
        return self.pq

    def previous_pass_qps(self, now=None):
        return self.ppq


@pytest.mark.usefixtures("clean_engine")
class TestWarmUpController:
    def test_cold_start_admits_cold_rate(self, manual_clock):
        # count=100, cold factor 3 → warning=500, max=1000, cold rate ~33 qps
        ctl = WarmUpController(count=100, warm_up_period_sec=10, cold_factor=3)
        ctl._stored_tokens = ctl.max_token
        ctl._last_filled_ms = manual_clock.now_ms() - manual_clock.now_ms() % 1000
        node = _StubNode()
        node.pq, node.ppq = 0.0, 0.0
        # cold: admissible qps along the curve at full bucket ≈ count/coldFactor
        assert ctl.can_pass(node, 1)
        node.pq = 33.0  # 33 + 1 > 33.33 → over the cold rate
        assert not ctl.can_pass(node, 1)
        node.pq = 30.0
        assert ctl.can_pass(node, 1)

    def test_sustained_demand_warms_to_full_rate(self, manual_clock):
        ctl = WarmUpController(count=100, warm_up_period_sec=10, cold_factor=3)
        ctl._stored_tokens = ctl.max_token
        ctl._last_filled_ms = manual_clock.now_ms() - manual_clock.now_ms() % 1000
        node = _StubNode()
        admitted_qps = []
        for sec in range(20):
            manual_clock.sleep_second()
            # sustained traffic at the currently-admitted rate
            node.ppq = admitted_qps[-1] if admitted_qps else 33.0
            # find the highest qps the controller admits this second
            lo = 0
            for q in range(1, 140):
                node.pq = float(q - 1)
                if ctl.can_pass(node, 1):
                    lo = q
                else:
                    break
            admitted_qps.append(float(lo))
        assert admitted_qps[0] <= 40  # cold
        assert admitted_qps[-1] >= 95  # fully warmed
        assert admitted_qps == sorted(admitted_qps)  # monotone warming
        # stored tokens drained below the warning line
        assert ctl._stored_tokens < ctl.warning_token


@pytest.mark.usefixtures("clean_engine")
class TestCircuitBreakers:
    def test_error_count_trips_and_recovers(self, manual_clock):
        DegradeRuleManager.load_rules(
            [
                DegradeRule(
                    resource="cb",
                    grade=DegradeGrade.ERROR_COUNT,
                    count=5,
                    time_window_sec=2,
                    min_request_amount=5,
                )
            ]
        )
        # 5 failing calls trip the breaker
        for _ in range(5):
            try:
                with sentinel.entry("cb"):
                    raise RuntimeError("down")
            except RuntimeError:
                pass
        with pytest.raises(DegradeException):
            sentinel.entry("cb")
        cb = DegradeRuleManager.get_breakers("cb")[0]
        assert cb.state == CircuitBreakerState.OPEN

        # before the window: still open
        manual_clock.sleep(1000)
        with pytest.raises(DegradeException):
            sentinel.entry("cb")
        # after recovery timeout: one probe allowed (half-open)
        manual_clock.sleep(1500)
        with sentinel.entry("cb"):
            pass  # probe succeeds
        assert cb.state == CircuitBreakerState.CLOSED
        with sentinel.entry("cb"):
            pass

    def test_half_open_failure_reopens(self, manual_clock):
        DegradeRuleManager.load_rules(
            [
                DegradeRule(
                    resource="cb2",
                    grade=DegradeGrade.ERROR_RATIO,
                    count=0.5,
                    time_window_sec=1,
                    min_request_amount=4,
                )
            ]
        )
        for i in range(4):
            try:
                with sentinel.entry("cb2"):
                    raise RuntimeError("x")
            except RuntimeError:
                pass
        cb = DegradeRuleManager.get_breakers("cb2")[0]
        assert cb.state == CircuitBreakerState.OPEN
        manual_clock.sleep(1100)
        # probe fails → reopen
        try:
            with sentinel.entry("cb2"):
                raise RuntimeError("still down")
        except RuntimeError:
            pass
        assert cb.state == CircuitBreakerState.OPEN
        with pytest.raises(DegradeException):
            sentinel.entry("cb2")

    def test_slow_ratio_trips(self, manual_clock):
        DegradeRuleManager.load_rules(
            [
                DegradeRule(
                    resource="slow",
                    grade=DegradeGrade.SLOW_REQUEST_RATIO,
                    count=50,  # max RT ms
                    slow_ratio_threshold=0.5,
                    time_window_sec=5,
                    min_request_amount=5,
                )
            ]
        )
        for _ in range(5):
            with sentinel.entry("slow"):
                manual_clock.sleep(100)  # 100ms > 50ms → slow
        with pytest.raises(DegradeException):
            sentinel.entry("slow")

    def test_observer_notified(self, manual_clock):
        events = []
        sentinel.register_state_change_observer(
            lambda res, prev, new, rule: events.append((res, prev, new))
        )
        DegradeRuleManager.load_rules(
            [
                DegradeRule(
                    resource="obs",
                    grade=DegradeGrade.ERROR_COUNT,
                    count=1,
                    time_window_sec=1,
                    min_request_amount=1,
                )
            ]
        )
        try:
            with sentinel.entry("obs"):
                raise RuntimeError("e")
        except RuntimeError:
            pass
        assert events and events[0][2] == CircuitBreakerState.OPEN
        from sentinel_tpu_torch.local.degrade import clear_state_change_observers

        clear_state_change_observers()


@pytest.mark.usefixtures("clean_engine")
class TestSystemAdaptive:
    def test_inbound_qps_guard(self, manual_clock):
        SystemRuleManager.load_rules([SystemRule(qps=10)])
        ok, blocked = hammer("ingress", 30, entry_type=EntryType.IN)
        assert ok == 10 and blocked == 20
        # outbound traffic unaffected
        ok_out, blocked_out = hammer("egress", 30)
        assert ok_out == 30

    def test_thread_guard(self, manual_clock):
        SystemRuleManager.load_rules([SystemRule(max_thread=1)])
        e1 = sentinel.entry("in1", entry_type=EntryType.IN)
        with pytest.raises(SystemBlockException):
            sentinel.entry("in2", entry_type=EntryType.IN)
        e1.exit()
        e2 = sentinel.entry("in2", entry_type=EntryType.IN)
        e2.exit()


@pytest.mark.usefixtures("clean_engine")
class TestAuthority:
    def test_white_list(self, manual_clock):
        AuthorityRuleManager.load_rules(
            [AuthorityRule(resource="svc", limit_app="appA,appB")]
        )
        assert hammer("svc", 1, origin="appA") == (1, 0)
        assert hammer("svc", 1, origin="appC") == (0, 1)
        # no origin → pass
        assert hammer("svc", 1) == (1, 0)

    def test_black_list(self, manual_clock):
        AuthorityRuleManager.load_rules(
            [
                AuthorityRule(
                    resource="svc2",
                    limit_app="bad",
                    strategy=AuthorityStrategy.BLACK,
                )
            ]
        )
        assert hammer("svc2", 1, origin="bad") == (0, 1)
        assert hammer("svc2", 1, origin="good") == (1, 0)


@pytest.mark.usefixtures("clean_engine")
class TestPriorityOccupy:
    def test_prioritized_request_borrows_future_window(self, manual_clock):
        FlowRuleManager.load_rules([FlowRule(resource="prio", count=10)])
        ok, _ = hammer("prio", 10)
        assert ok == 10
        # prioritized occupy only helps when current passes expire within the
        # occupy timeout: advance into the next bucket so they are near expiry
        manual_clock.sleep(600)
        # non-prioritized request still rejected (passes still in window)
        with pytest.raises(FlowException):
            sentinel.entry("prio")
        # prioritized request borrows the upcoming window: waits, then passes
        t0 = manual_clock.now_ms()
        with sentinel.entry("prio", prioritized=True):
            pass
        assert manual_clock.now_ms() - t0 == 400  # waited to the window start
        cn = chain_mod.get_cluster_node("prio")
        assert cn.occupied_pass_qps() > 0


@pytest.fixture
def clean_async(manual_clock):
    manual_clock.set_ms(10_000)
    yield
    FlowRuleManager.reset_for_tests()
    reset_cluster_nodes_for_tests()
    sph().reset_for_tests()
    ctx_mod.reset_for_tests()


@pytest.mark.usefixtures("clean_async")
class TestAsyncEntry:
    def test_out_of_order_completion_keeps_stats_straight(self, manual_clock):
        a = async_entry("rpc-a")
        b = async_entry("rpc-b")
        # caller's stack is clean: a plain sync entry nests normally
        with entry("sync-work"):
            pass
        node_a = get_cluster_node("rpc-a")
        node_b = get_cluster_node("rpc-b")
        assert node_a.cur_thread_num == 1 and node_b.cur_thread_num == 1
        manual_clock.sleep(50)
        a.exit()  # A completes first — B must stay live
        assert node_a.cur_thread_num == 0
        assert node_b.cur_thread_num == 1
        assert not b._exited
        manual_clock.sleep(100)
        b.exit()
        assert node_b.cur_thread_num == 0
        # RT covers each call's real duration
        assert node_a.avg_rt() == pytest.approx(50.0)
        assert node_b.avg_rt() == pytest.approx(150.0)

    def test_foreign_thread_completion_preserves_caller_context(self):
        ctx_mod.enter("caller_ctx")
        e = async_entry("bg-op")
        marker = {}

        def completer():
            ctx_mod.enter("worker_ctx")
            e.exit()
            # the worker's own context must survive the foreign exit
            marker["worker_ctx"] = ctx_mod.get_context().name
            ctx_mod.exit()

        t = threading.Thread(target=completer)
        t.start()
        t.join()
        assert marker["worker_ctx"] == "worker_ctx"
        assert ctx_mod.get_context().name == "caller_ctx"
        ctx_mod.exit()

    def test_error_traced_on_late_completion(self):
        e = async_entry("failing-rpc")
        e.trace(RuntimeError("downstream died"))
        e.exit()
        node = get_cluster_node("failing-rpc")
        assert node.exception_qps() > 0


class TestBlockLogWiring:
    def test_blocks_land_in_stat_log(self, manual_clock, tmp_path):
        # the port's stat logs follow the ``csp.sentinel.log.dir`` property
        # (``torch_parity`` points it at a temporary directory)
        prev = SentinelConfig.get(LOG_DIR_KEY)
        SentinelConfig.set(LOG_DIR_KEY, str(tmp_path))
        reset_registry_for_tests()
        reset_cluster_nodes_for_tests()
        FlowRuleManager.load_rules([FlowRule(resource="api", count=0.0)])
        try:
            with pytest.raises(BlockException):
                with sentinel.entry("api"):
                    pass
            stat_logger("sentinel-block-record").flush()
            text = (tmp_path / "sentinel-block-record.log").read_text()
            assert "api,-,FlowException" in text
        finally:
            FlowRuleManager.load_rules([])
            reset_cluster_nodes_for_tests()
            reset_registry_for_tests()
            SentinelConfig.set(LOG_DIR_KEY, prev)


def _hash_values(rng: np.random.Generator) -> list:
    ints = [int(x) for x in rng.integers(-2**62, 2**62, 40)]
    return (
        ints
        + [float(x) for x in rng.normal(0, 1e6, 20)] + [0.0, -0.0, 1.5e300]
        + ["".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(n)))
           for n in rng.integers(0, 24, 20)] + [""]
        + [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
           for n in rng.integers(0, 24, 20)] + [b""]
        + [True, False, None]
        + [tuple(ints[:3]), (1, "1", b"1"), frozenset(), [1, 2]]
    )


class TestStableParamHash:
    def test_equal_to_the_reference_for_every_type(self):
        values = _hash_values(np.random.default_rng(11))
        kinds = {type(v) for v in values}
        assert {int, float, str, bytes, bool, type(None), tuple} <= kinds
        for v in values:
            assert stable_param_hash(v) == j_hash(v), repr(v)
            assert 0 <= stable_param_hash(v) < 2**63

    def test_types_never_share_a_hash(self):
        assert len({stable_param_hash(v) for v in (1, "1", b"1", 1.0,
                                                   True)}) == 5


class TestNativeWindow:
    def test_equal_to_host_window_op_for_op(self):
        rng = np.random.default_rng(3)
        nw = native_lib.NativeWindow(500, 2, stat.N_CHAN)
        hw = stat.HostWindow(500, 2, stat.N_CHAN)
        now = 1_000_000
        for _ in range(400):
            now += int(rng.integers(0, 300))
            chan = int(rng.integers(0, stat.N_CHAN))
            n = float(rng.integers(1, 4))
            nw.add(now, chan, n)
            hw.add(now, chan, n)
            for c in range(stat.N_CHAN):
                assert nw.sum(now, c) == hw.sum(now, c)
                assert nw.previous_bucket(now, c) == hw.previous_bucket(
                    now, c)
            assert nw.snapshot(now) == hw.snapshot(now)
            assert nw.min_ratio(now, stat.RT, stat.SUCCESS) == \
                hw.min_ratio(now, stat.RT, stat.SUCCESS)
            for b in range(2):
                assert nw.start_at(b) == hw.start_at(b)
                assert nw.count_at(b, chan) == hw.count_at(b, chan)

    def test_future_ops_equal_to_future_window(self):
        rng = np.random.default_rng(4)
        nf = stat._NativeFutureWindow(native_lib.NativeWindow(500, 2, 1))
        hf = stat.FutureWindow(500, 2)
        now = 2_000_000
        for _ in range(300):
            now += int(rng.integers(0, 400))
            ahead = int(rng.integers(1, 1000))
            n = float(rng.integers(1, 3))
            nf.add(now + ahead, n)
            hf.add(now + ahead, n)
            assert nf.waiting(now) == hf.waiting(now)
            if rng.random() < 0.3:
                assert nf.take_matured(now) == hf.take_matured(now)

    def test_failed_build_raises_at_the_first_window(self, monkeypatch):
        from sentinel_tpu_torch.native import build as native_build

        def broken():
            raise RuntimeError("g++: no such file")

        monkeypatch.setattr(native_lib, "_lib", None)
        monkeypatch.setattr(native_build, "build", broken)
        monkeypatch.setattr(stat, "_NATIVE", True)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            StatisticNode()
        monkeypatch.setattr(stat, "_NATIVE", False)
        assert isinstance(StatisticNode().sec, stat.HostWindow)
