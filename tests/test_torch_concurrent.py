"""Cluster concurrency (semaphore mode) through the port's token service
against the reference's: a seeded stream of acquires, releases (double
releases included) and clock advances that expire held permits, on manual
clocks set to the same millisecond. Every result, every flow's held count
and the token cache size must be equal. The background sweep is stopped
(``close``) so that expiry runs at the stream's own points, then ``reopen``
re-arms it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule as JConcRule,
)
from sentinel_tpu.cluster.token_service import (  # noqa: E402
    DefaultTokenService as JService,
)
from sentinel_tpu.core import clock as j_clock  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402
from sentinel_tpu.engine.rules import ThresholdMode as JTM  # noqa: E402

from sentinel_tpu_torch import interop  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from sentinel_tpu_torch.cluster.concurrent import (  # noqa: E402
    ConcurrentFlowRule,
)
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402

KW = dict(max_flows=32, max_namespaces=2, batch_size=64)
START_MS = 1_700_000_000_000


def _rules():
    return [JConcRule(flow_id=fid, concurrency_level=2 + fid % 4,
                      mode=JTM(fid % 2), resource_timeout_ms=150 + 50 * fid,
                      namespace="default" if fid % 3 else "ns1")
            for fid in range(1, 7)]


@pytest.mark.parametrize("seed", range(2))
def test_concurrency_stream_matches_reference(seed):
    jc, tc = j_clock.ManualClock(START_MS), t_clock.ManualClock(START_MS)
    prev_j, prev_t = j_clock.set_clock(jc), t_clock.set_clock(tc)
    jsvc = JService(JConfig(**KW))
    tsvc = DefaultTokenService(EngineConfig(**KW), device="cpu")
    try:
        jrules = _rules()
        jsvc.load_concurrent_rules(jrules)
        # the reference's rule objects, read by field name
        tsvc.load_concurrent_rules(
            [interop.port_rule(r, ConcurrentFlowRule) for r in jrules])
        for s in (jsvc, tsvc):
            s.close()
            s.connected_count_changed("default", 3)
        assert tsvc._expiry is None
        rng = np.random.default_rng(seed)
        held = []
        for step in range(400):
            op = rng.random()
            if op < 0.55 or not held:
                fid, acq = int(rng.integers(0, 8)), int(rng.integers(0, 3))
                j = jsvc.request_concurrent_token(fid, acq)
                t = tsvc.request_concurrent_token(fid, acq)
                assert (int(j.status), j.remaining, j.token_id) == (
                    int(t.status), t.remaining, t.token_id), step
                if t.ok:
                    held.append(t.token_id)
            elif op < 0.9:
                tid = held.pop(int(rng.integers(0, len(held))))
                if rng.random() < 0.2:
                    held.append(tid)  # released again later
                j = jsvc.release_concurrent_token(tid)
                t = tsvc.release_concurrent_token(tid)
                assert int(j.status) == int(t.status) and j.ok == t.ok, step
            else:
                ms = int(rng.integers(20, 400))
                jc.advance(ms)
                tc.advance(ms)
                if rng.random() < 0.5:
                    assert (jsvc.concurrency.expire()
                            == tsvc.concurrency.expire()), step
            for fid in range(8):
                assert (jsvc.concurrency.now_calls(fid)
                        == tsvc.concurrency.now_calls(fid)), (step, fid)
            assert (jsvc.concurrency.token_count()
                    == tsvc.concurrency.token_count()), step
        for s in (jsvc, tsvc):
            s.reopen()
        assert tsvc._expiry is not None
    finally:
        jsvc.close()
        tsvc.close()
        j_clock.set_clock(prev_j)
        t_clock.set_clock(prev_t)
