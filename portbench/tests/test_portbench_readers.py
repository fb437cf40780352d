"""The trace readers' arithmetic on a made-up slice (the CPU has no device
trace): busy time, idle share, operations a frame and a request, and the
rooflines, which read nothing where nothing ran."""

from __future__ import annotations

import numpy as np
import pytest

import portbench_small  # noqa: F401  (the repo's root on the path)
from portbench import harness, readers, workload
from portbench.tracing import DeviceTrace, kernel_base, lane_of

MS = 1_000_000  # ns


def _trace(events, t0=0, t1=10 * MS):
    tr = DeviceTrace.__new__(DeviceTrace)
    tr.t0_ns, tr.t1_ns, tr.events = t0, t1, events
    return tr.summary([("dispatch", 2 * MS, 6 * MS), ("materialize", 8 * MS,
                                                     10 * MS)])


def test_kernel_names():
    assert kernel_base("void decide_kernel(Params)") == "decide_kernel"
    assert kernel_base("(anonymous namespace)::cms_decide_kernel("
                       "param::Rows, int*)") == "cms_decide_kernel"
    assert kernel_base("roll_kernel(int*, int const*)") == "roll_kernel"


def test_busy_idle_and_gaps():
    s = _trace([("roll_kernel(int*)", 1 * MS, 2 * MS),
                ("void decide_kernel(Params)", 1.5 * MS, 3 * MS),
                ("Memcpy DtoH", 7 * MS, 8 * MS)])
    assert s["busy_s"] == pytest.approx(0.003)
    assert s["window_s"] == pytest.approx(0.010)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["dispatch", pytest.approx(0.004)]
    assert [g[0] for g in gaps] == ["dispatch", "materialize", "idle"]
    ctx = harness.Context(trace=s)
    assert readers.idle_share(ctx) == pytest.approx(70.0)
    assert lane_of(0, 1, []) == "idle"


def test_decide_roofline_and_ops_per_frame():
    events = [("roll_kernel(int*)", 0, 10_000),
              ("start_kernel(int*)", 10_000, 12_000),
              ("void decide_kernel(Params)", 12_000, 40_000),
              ("some elementwise kernel", 40_000, 41_000)]
    s = _trace(events)
    frames = [(5000, 5000, False, 16384)]
    ctx = harness.Context(trace=s, check={
        "frame_stats": frames, "dispatch_frames": [(1, 0, 1)],
        "n_buckets": 10, "max_flows": 100_000})
    want = workload.decide_bytes(16384, 10, 5000, 5000, 0)
    share = 100 * want / workload.PEAK_BYTES_PER_S / 40e-6
    assert readers.decide_roofline(ctx) == pytest.approx(share)
    assert 0 < readers.decide_roofline(ctx) < 100
    assert readers.device_ops_per_frame(ctx) == 4
    ctx.check["dispatch_frames"] = [(20 * MS, 0, 1)]  # outside the slice
    assert readers.decide_roofline(ctx) is None


def test_cms_roofline_reads_nothing_without_its_kernel():
    s = _trace([("void at::native::fill(int)", 0, 1000)])
    ctx = harness.Context(trace=s, check={"steps": [(5, 8, 3)]},
                          config={"param": {"depth": 2, "n_buckets": 2}})
    assert readers.cms_roofline(ctx) is None
    assert readers.device_ops_per_request(ctx) == 1
    s = _trace([("(anonymous namespace)::cms_decide_kernel(param::Rows)",
                 0, 5000)])
    ctx.trace = s
    want = workload.param_bytes("cms", 8, 2, 2, 3, 0)
    assert readers.cms_roofline(ctx) == pytest.approx(
        100 * want / workload.PEAK_BYTES_PER_S / 5e-6)


def test_rtt_percentile_needs_samples():
    done = np.array([[1.0 + i / 100, 0.010 + i / 1000, 4096, 0]
                     for i in range(40)])
    ctx = harness.Context(loadgen={"done": done}, t0=1.0, t1=2.0, seconds=1)
    assert readers.rtt_p95_ms(ctx) == pytest.approx(
        np.percentile(done[:, 1] * 1e3, 95))
    assert readers.rate(ctx) == pytest.approx(40 * 4096)
    ctx.t1 = 1.1
    assert readers.rtt_p95_ms(ctx) is None
