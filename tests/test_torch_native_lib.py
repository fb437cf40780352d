"""The port's native library binding (``sentinel_tpu_torch.native.lib``)
beyond the doors and the window: the hot-param token buckets, the pacers,
the BATCH_FLOW codec, ``available`` / ``shm_available``, and the wire
codec's use of it (``cluster.protocol._native_codec``).

The reference's ``tests/test_native.py`` classes ``TestTokenBucketParity``,
``TestPacerParity``, ``TestBatchCodecParity`` and ``TestHammer`` on the
port's library (built from ``native/src`` into the port's build directory),
held against the port's own Python versions of the same rules
(``local.param``, ``local.flow``); the codec's bytes and arrays also equal
the JAX package's numpy layout. Where the reference answers None or False
for a library that is missing, the port raises: pinned by the last tests.
"""

import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler",
)

from sentinel_tpu.cluster import protocol as JP  # noqa: E402

from sentinel_tpu_torch.cluster import protocol as P  # noqa: E402
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402


@pytest.fixture(scope="module")
def native():
    from sentinel_tpu_torch.native import lib

    assert lib.available() is True
    assert lib.shm_available() is True
    return lib


@pytest.fixture
def manual_clock():
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


class TestTokenBucketParity:
    def test_semantics(self, native):
        tb = native.NativeTokenBuckets(4)
        # threshold 5/s, burst 2 → cap 7; first acquire of 3 passes (7-3=4)
        assert tb.try_acquire(0, now=1000, acquire=3, count=5, burst=2,
                              interval_ms=1000)
        assert tb.try_acquire(0, now=1000, acquire=4, count=5, burst=2,
                              interval_ms=1000)
        # bucket empty now
        assert not tb.try_acquire(0, now=1000, acquire=1, count=5, burst=2,
                                  interval_ms=1000)
        # 400ms later: refill 0.4*5 = 2 tokens
        assert tb.try_acquire(0, now=1400, acquire=2, count=5, burst=2,
                              interval_ms=1000)
        assert not tb.try_acquire(0, now=1400, acquire=1, count=5, burst=2,
                                  interval_ms=1000)
        # oversized first acquire on a fresh slot blocks and empties
        assert not tb.try_acquire(1, now=0, acquire=100, count=5, burst=2,
                                  interval_ms=1000)
        assert not tb.try_acquire(1, now=0, acquire=1, count=5, burst=2,
                                  interval_ms=1000)
        tb.reset(1)
        assert tb.try_acquire(1, now=0, acquire=7, count=5, burst=2,
                              interval_ms=1000)

    def test_matches_python_param_bucket(self, native, manual_clock):
        """Drive the port's Python param-flow token bucket and the native
        one with the same schedule; admissions must agree."""
        from sentinel_tpu_torch.local.param import (
            ParamFlowRule,
            _check_qps,
            _RuleState,
        )

        rule = ParamFlowRule(resource="r", param_idx=0, count=10,
                             burst_count=3, duration_sec=1)
        st = _RuleState()
        tb = native.NativeTokenBuckets(1)
        rng = np.random.default_rng(1)
        now = 0
        for _ in range(300):
            now += int(rng.integers(0, 120))
            manual_clock.set_ms(now)
            acq = int(rng.integers(1, 4))
            py = _check_qps(rule, st, "v", acq)
            nat = tb.try_acquire(0, now=now, acquire=acq, count=10, burst=3,
                                 interval_ms=1000)
            assert py == nat, f"divergence at now={now} acq={acq}"


class TestPacerParity:
    def test_matches_python_rate_limiter(self, native, manual_clock):
        from sentinel_tpu_torch.local.flow import RateLimiterController

        rl = RateLimiterController(count=10, max_queueing_time_ms=500)
        pacer = native.NativePacerArray(1)
        rng = np.random.default_rng(2)
        now = 0
        for _ in range(200):
            now += int(rng.integers(0, 150))
            manual_clock.set_ms(now)
            py = rl.can_pass(None, 1)
            wait = pacer.try_pass(0, now=now, acquire=1, count_per_sec=10,
                                  max_queue_ms=500)
            assert py == (wait >= 0), f"divergence at now={now}"

    def test_blocked_when_queue_full(self, native):
        pacer = native.NativePacerArray(1)
        assert pacer.try_pass(0, now=0, acquire=1, count_per_sec=1,
                              max_queue_ms=100) == 0
        # next would wait 1000ms > 100ms budget
        assert pacer.try_pass(0, now=1, acquire=1, count_per_sec=1,
                              max_queue_ms=100) == -1
        pacer.reset(0)
        assert pacer.try_pass(0, now=1, acquire=1, count_per_sec=1,
                              max_queue_ms=100) == 0


class TestHammer:
    def test_concurrent_adds_lose_nothing(self, native):
        from sentinel_tpu_torch.local.stat import N_CHAN

        nw = native.NativeWindow(10_000, 4, N_CHAN)  # wide window: no expiry
        n_threads, per_thread = 8, 20_000

        def work():
            for i in range(per_thread):
                nw.add(5_000, i % N_CHAN, 1.0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(nw.snapshot(5_000)) == n_threads * per_thread

    def test_statistic_node_uses_native_when_enabled(self, native,
                                                     monkeypatch):
        import sentinel_tpu_torch.local.stat as stat

        monkeypatch.setattr(stat, "_NATIVE", True)
        node = stat.StatisticNode()
        assert type(node.sec).__name__ == "NativeWindow"
        node.add_pass(2, now=100)
        node.add_rt_and_success(20.0, 1, now=100)
        assert node.pass_qps(now=100) == pytest.approx(2.0)
        assert node.avg_rt(now=100) == pytest.approx(20.0)
        assert node.min_rt(now=100) == pytest.approx(20.0)
        node.add_occupied_pass(1, wait_ms=500, now=100)
        assert node.try_occupy_next(100, 1, threshold=10.0) <= 500


def _numpy_rsp(xid, st, rem, wt):
    """The reference's numpy layout of a BATCH_FLOW response frame."""
    n = st.shape[0]
    rows = np.empty(n, dtype=JP.BATCH_RSP_DTYPE)
    rows["status"] = st
    rows["remaining"] = rem
    rows["wait_ms"] = wt
    return (
        JP._LEN.pack(JP._HEAD.size + 2 + n * 9)
        + JP._HEAD.pack(xid, JP.MsgType.BATCH_FLOW)
        + JP._BATCH_N.pack(n)
        + rows.tobytes()
    )


def _numpy_req(payload):
    """The reference's numpy decode of a BATCH_FLOW request payload."""
    xid, _ = JP._HEAD.unpack_from(payload, 0)
    (n,) = JP._BATCH_N.unpack_from(payload, JP._HEAD.size)
    off = JP._HEAD.size + JP._BATCH_N.size
    rows = np.frombuffer(payload, dtype=JP.BATCH_REQ_DTYPE, count=n,
                         offset=off)
    return (xid, rows["flow_id"].astype(np.int64),
            rows["count"].astype(np.int32), rows["prio"].astype(bool))


def _same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


class TestBatchCodecParity:
    """The native wire codec is bit-identical with the numpy codec."""

    def test_decode_req_matches_numpy(self, native):
        rng = np.random.default_rng(0)
        ids = rng.integers(-(2**62), 2**62, size=257)
        cnt = rng.integers(1, 100, size=257).astype(np.int32)
        pri = rng.integers(0, 2, size=257).astype(bool)
        payload = P.encode_batch_request(42, ids, cnt, pri)[2:]
        nx, ni, nc, npr = native.batch_decode_req(payload)
        assert nx == 42
        np.testing.assert_array_equal(ni, ids)
        np.testing.assert_array_equal(nc, cnt)
        np.testing.assert_array_equal(npr, pri)
        _same(native.batch_decode_req(payload), _numpy_req(payload))

    def test_decode_req_rejects_truncated(self, native):
        payload = P.encode_batch_request(1, np.arange(4, dtype=np.int64))[2:]
        with pytest.raises(ValueError):
            native.batch_decode_req(payload[:-5])
        with pytest.raises(ValueError):
            P.decode_batch_request(payload[:-5])

    def test_encode_rsp_matches_numpy(self, native):
        rng = np.random.default_rng(1)
        st = rng.integers(-2, 5, size=300).astype(np.int8)
        rem = rng.integers(0, 2**31 - 1, size=300).astype(np.int32)
        wt = rng.integers(0, 10_000, size=300).astype(np.int32)
        expect = _numpy_rsp(7, st, rem, wt)
        assert native.batch_encode_rsp(7, st, rem, wt) == expect
        assert P.encode_batch_response(7, st, rem, wt) == expect


@pytest.mark.parametrize("seed", range(4))
def test_protocol_batch_codec_equals_the_numpy_path(seed):
    """Through ``protocol``: every row count 0-600 a seed draws (deadline
    trailers included) decodes to the numpy path's arrays, and every reply
    encodes to its bytes."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        n = int(rng.integers(0, 600))
        ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
        cnt = rng.integers(-5, 2**20, size=n).astype(np.int32)
        pri = rng.integers(0, 2, size=n).astype(np.uint8)
        xid = int(rng.integers(-2**31, 2**31))
        deadline = int(rng.integers(0, 2)) * int(rng.integers(1, 10**6))
        payload = P.encode_batch_request(xid, ids, cnt, pri,
                                         deadline_ms=deadline)[2:]
        _same(P.decode_batch_request(payload), _numpy_req(payload))
        st = rng.integers(-128, 128, size=n).astype(np.int8)
        rem = rng.integers(-2**31, 2**31, size=n).astype(np.int32)
        wt = rng.integers(-2**31, 2**31, size=n).astype(np.int32)
        assert P.encode_batch_response(xid, st, rem, wt) == _numpy_rsp(
            xid, st, rem, wt)


_NO_LIBRARY = """
import sys
sys.path.insert(0, {repo!r})
import sentinel_tpu_torch.native.build as B
import sentinel_tpu_torch.cluster.protocol as P
import numpy as np

def broken():
    raise RuntimeError("native build failed: no compiler")

B.build = broken
payload = P.encode_batch_request(3, np.arange(4, dtype=np.int64))[2:]
for call in (lambda: P.decode_batch_request(payload),
             lambda: P.encode_batch_response(3, np.zeros(1, np.int8),
                                             np.zeros(1, np.int32),
                                             np.zeros(1, np.int32)),
             P._native_codec):
    try:
        call()
    except RuntimeError as exc:
        assert "no compiler" in str(exc), exc
    else:
        raise AssertionError("the codec answered without its library")
import sentinel_tpu_torch.native.lib as L
try:
    L.available()
except RuntimeError:
    pass
else:
    raise AssertionError("available() answered without its library")
assert 'sentinel_tpu_torch.native.lib' in sys.modules
print("raised")
"""


def test_native_codec_raises_when_the_library_cannot_load():
    repo = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run(
        [sys.executable, "-I", "-c", _NO_LIBRARY.format(repo=repo)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "raised"


def test_protocol_import_does_not_build_the_library():
    repo = __file__.rsplit("/tests/", 1)[0]
    code = (f"import sys\nsys.path.insert(0, {repo!r})\n"
            "import sentinel_tpu_torch.cluster.protocol as P\n"
            "assert P._NATIVE is None\n"
            "assert 'sentinel_tpu_torch.native.lib' not in sys.modules\n"
            "assert 'sentinel_tpu_torch.native.build' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
