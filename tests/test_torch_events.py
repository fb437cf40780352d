"""The port's metric event channels (``sentinel_tpu_torch.stats.events``),
``stats.window.avg_qps`` and ``engine.rules.RuleIndex.lookup`` against the
JAX package's.

The ``Event`` cases of the reference's ``tests/test_window.py`` (adds and
sums by channel, the slide, the ring's reuse, an idle gap, duplicate rows,
padding, future windows on ``OCCUPIED_PASS``) run on both packages; every
read must be equal, and the values the reference's cases assert.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.rules import RuleIndex as JRuleIndex  # noqa: E402
from sentinel_tpu.stats import Event as JStatsEvent  # noqa: E402
from sentinel_tpu.stats import window as JW  # noqa: E402
from sentinel_tpu.stats.events import Event as JEvent  # noqa: E402
from sentinel_tpu.stats.events import N_EVENTS as J_N_EVENTS  # noqa: E402

from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.rules import RuleIndex  # noqa: E402
from sentinel_tpu_torch.stats import Event as StatsEvent  # noqa: E402
from sentinel_tpu_torch.stats import window as TW  # noqa: E402
from sentinel_tpu_torch.stats.events import N_EVENTS, Event  # noqa: E402
from torch_parity import assert_arrays_equal  # noqa: E402

SPEC_J = JW.WindowSpec(bucket_ms=500, n_buckets=2)
SPEC_T = TW.WindowSpec(bucket_ms=500, n_buckets=2)
R = 8


def test_event_channels_are_the_reference():
    assert [(e.name, int(e)) for e in Event] == [
        (e.name, int(e)) for e in JEvent]
    assert N_EVENTS == J_N_EVENTS == 5
    assert StatsEvent is Event and JStatsEvent is JEvent
    import sentinel_tpu_torch.stats as S

    assert "Event" in S.__all__


class Pair:
    """One window in each package, driven with the same calls."""

    def __init__(self):
        self.j = JW.make_window(SPEC_J, R, J_N_EVENTS)
        self.t = TW.make_window(SPEC_T, R, N_EVENTS, device="cpu")

    def add(self, now, res, chan, val, valid=None):
        self.j = JW.add_events(
            SPEC_J, self.j, jnp.int32(now), jnp.array(res, jnp.int32),
            jnp.array([int(c) for c in chan], jnp.int32),
            jnp.array(val, jnp.int32),
            valid=None if valid is None else jnp.array(valid))
        TW.add_events(
            SPEC_T, self.t, now, torch.tensor(res, dtype=torch.int32),
            torch.tensor([int(c) for c in chan], dtype=torch.int32),
            torch.tensor(val, dtype=torch.int32),
            valid=None if valid is None else torch.tensor(valid))

    def add_pass(self, now, res, n=1):
        self.add(now, [res], [Event.PASS], [n])

    def add_future(self, now, wait, res, val, valid=None):
        self.j = JW.add_future(
            SPEC_J, self.j, jnp.int32(now),
            wait_ms=jnp.array([wait], jnp.int32),
            resource_ids=jnp.array([res], jnp.int32),
            channel_ids=jnp.array([JEvent.OCCUPIED_PASS], jnp.int32),
            values=jnp.array([val], jnp.int32),
            valid=None if valid is None else jnp.array([valid]))
        TW.add_future(
            SPEC_T, self.t, now,
            wait_ms=torch.tensor([wait], dtype=torch.int32),
            resource_ids=torch.tensor([res], dtype=torch.int32),
            channel_ids=torch.tensor([int(Event.OCCUPIED_PASS)],
                                     dtype=torch.int32),
            values=torch.tensor([val], dtype=torch.int32),
            valid=None if valid is None else torch.tensor([valid]))

    def sum(self, now, chan=Event.PASS):
        a = np.asarray(JW.window_sum(SPEC_J, self.j, jnp.int32(now),
                                     int(chan)))
        b = TW.window_sum(SPEC_T, self.t, now, int(chan))
        assert_arrays_equal(a, b, f"window_sum({now}, {chan!r})")
        return b.numpy()

    def future(self, now, chan=Event.OCCUPIED_PASS):
        a = np.asarray(JW.future_sum(SPEC_J, self.j, jnp.int32(now),
                                     int(chan)))
        b = TW.future_sum(SPEC_T, self.t, now, int(chan))
        assert_arrays_equal(a, b, f"future_sum({now}, {chan!r})")
        return b.numpy()


class TestAddAndSum:
    def test_counts_within_interval(self):
        w = Pair()
        w.add_pass(10_000, res=3, n=2)
        w.add_pass(10_100, res=3)
        assert w.sum(10_100)[3] == 3
        assert w.sum(10_100)[0] == 0

    def test_window_slides_off(self):
        w = Pair()
        w.add_pass(10_000, res=1, n=5)
        assert w.sum(10_900)[1] == 5
        assert w.sum(11_500)[1] == 0

    def test_two_buckets_both_count(self):
        w = Pair()
        w.add_pass(10_000, res=0, n=1)
        w.add_pass(10_600, res=0, n=2)
        assert w.sum(10_999)[0] == 3

    def test_stale_slot_reset_on_reuse(self):
        w = Pair()
        w.add_pass(10_000, res=2, n=7)
        w.add_pass(11_000, res=2, n=1)
        assert w.sum(11_000)[2] == 1

    def test_idle_gap_masked_on_read(self):
        w = Pair()
        w.add_pass(10_000, res=2, n=7)
        assert w.sum(60_000)[2] == 0

    def test_batched_duplicate_accumulation(self):
        w = Pair()
        w.add(20_000, [5, 5, 5, 1],
              [Event.PASS, Event.PASS, Event.BLOCK, Event.PASS], [1, 2, 4, 8])
        assert w.sum(20_000)[5] == 3
        assert w.sum(20_000, Event.BLOCK)[5] == 4
        assert w.sum(20_000)[1] == 8

    def test_valid_mask_respects_padding(self):
        w = Pair()
        w.add(20_000, [5, 5], [Event.PASS, Event.PASS], [1, 100],
              valid=[True, False])
        assert w.sum(20_000)[5] == 1


class TestFutureWindows:
    def test_add_future_and_sum(self):
        w = Pair()
        w.add_future(10_000, 500, res=4, val=2)
        assert w.future(10_000)[4] == 2
        assert w.future(10_500)[4] == 0
        assert w.sum(10_500, Event.OCCUPIED_PASS)[4] == 2

    def test_invalid_rows_do_not_reset_live_buckets(self):
        w = Pair()
        w.add_pass(10_000, res=1, n=5)
        w.add_future(10_000, SPEC_T.interval_ms, res=1, val=3, valid=False)
        assert w.sum(10_000)[1] == 5

    def test_wait_clamped_to_ring_capacity(self):
        w = Pair()
        w.add_pass(10_000, res=1, n=5)
        w.add_future(10_000, 10 * SPEC_T.interval_ms, res=1, val=3)
        assert w.sum(10_000)[1] == 5
        assert w.future(10_000)[1] == 3


@pytest.mark.parametrize("bucket_ms,n_buckets", [(500, 2), (100, 10),
                                                 (1000, 1), (250, 3)])
def test_avg_qps_is_the_compiled_reference(bucket_ms, n_buckets):
    import jax

    rng = np.random.default_rng(bucket_ms)
    total = rng.integers(-2**31, 2**31 - 1, size=257).astype(np.int32)
    total[:4] = (0, 1, 2**24 + 1, -(2**31))
    spec_j = JW.WindowSpec(bucket_ms=bucket_ms, n_buckets=n_buckets)
    spec_t = TW.WindowSpec(bucket_ms=bucket_ms, n_buckets=n_buckets)
    want = np.asarray(jax.jit(lambda t: JW.avg_qps(spec_j, t))(total))
    assert_arrays_equal(want, np.asarray(JW.avg_qps(spec_j, total)),
                        "eager vs jitted reference")
    got = TW.avg_qps(spec_t, torch.from_numpy(total))
    assert_arrays_equal(want, got, "avg_qps")


def test_rule_index_lookup_is_the_reference():
    cfg = dict(max_flows=16, max_namespaces=2, batch_size=8)
    j, t = JRuleIndex(JConfig(**cfg)), RuleIndex(EngineConfig(**cfg))
    ids = [7, 2**62 + 5, -3, 2**63 - 1, 11]
    for fid in ids:
        assert j.assign(fid) == t.assign(fid)
    j.release_missing(ids[1:4])
    t.release_missing(ids[1:4])
    for fid in ids + [99, 0]:
        assert t.lookup(fid) == j.lookup(fid), fid
    assert t.lookup(7) == -1 and t.lookup(2**63 - 1) >= 0
