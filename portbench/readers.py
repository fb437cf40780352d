"""What the metric readers under ``metrics/`` share: the window's client
round trips, the server's histogram deltas, and the device trace reduced
per engine frame or per request. A reader returns None where the run has
nothing to read (no trace, no launch of the kernel, too few samples); the
harness then leaves the metric out."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from portbench import workload
from portbench.tracing import kernel_base

MIN_SAMPLES = 20


def rtt_p95_ms(ctx) -> Optional[float]:
    """95th percentile of every request's round trip completed in the
    window (from its first byte sent to its last reply read), ms."""
    done = ctx.window_done()
    if done.shape[0] < MIN_SAMPLES:
        return None
    return float(np.percentile(done[:, 1] * 1e3, 95))


def hist_mean(ctx, name: str) -> Optional[float]:
    """The window's mean of a ``ServerMetrics`` histogram: the delta of its
    sum over the delta of its count."""
    n = ctx.server_delta(name + "_count")
    return ctx.server_delta(name + "_sum") / n if n else None


def fused_depth(ctx) -> Optional[float]:
    """Engine frames folded into fused steps, over the door's dispatches."""
    n = ctx.server_delta("dispatch_ms_count")
    return ctx.server_delta("fused_depth_sum") / n if n else None


def idle_share(ctx) -> Optional[float]:
    """Share of the traced slice in which no device operation ran, %."""
    t = ctx.trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _in_slice(ctx, t_ns: int) -> bool:
    return ctx.trace["t0_ns"] <= t_ns < ctx.trace["t1_ns"]


def kernel_time(ctx, names: Iterable[str], count: str):
    """``(seconds of the named kernels, launches of ``count``)`` in the
    traced slice."""
    names = set(names)
    secs, launches = 0.0, 0
    for n, a, b in ctx.trace["events"]:
        base = kernel_base(n)
        if base in names:
            secs += (b - a) / 1e9
            launches += base == count
    return secs, launches


def slice_frames(ctx):
    """The reference's frame statistics of the engine frames whose
    dispatch began inside the traced slice."""
    stats, out = ctx.check["frame_stats"], []
    for t_ns, first, last in ctx.check["dispatch_frames"]:
        if _in_slice(ctx, t_ns):
            out.extend(stats[first:last])
    return out


def device_ops_per_frame(ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    frames = slice_frames(ctx)
    return len(ctx.trace["events"]) / len(frames) if frames else None


def decide_roofline(ctx) -> Optional[float]:
    """The decide step's bytes (``workload.decide_bytes``) over 3.35 TB/s,
    as a share of its kernels' time (window roll, start stamp, decide),
    mean per launch over the slice, %."""
    if ctx.trace is None:
        return None
    frames = slice_frames(ctx)
    secs, launches = kernel_time(
        ctx, ("decide_kernel", "roll_kernel", "start_kernel"),
        "decide_kernel")
    if not frames or not launches:
        return None
    c = ctx.check
    nbytes = np.mean([
        workload.decide_bytes(n_rows, c["n_buckets"], touched, tails,
                              c["max_flows"] if rolled else 0)
        for touched, tails, rolled, n_rows in frames])
    return 100.0 * (nbytes / workload.PEAK_BYTES_PER_S) / (secs / launches)


def slice_requests(ctx):
    return [s for s in ctx.check["steps"] if _in_slice(ctx, s[0])]


def device_ops_per_request(ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    reqs = slice_requests(ctx)
    return len(ctx.trace["events"]) / len(reqs) if reqs else None


def cms_roofline(ctx) -> Optional[float]:
    """The count-min step's bytes (``workload.param_bytes``) over
    3.35 TB/s, as a share of the kernel's time, mean per launch, %."""
    if ctx.trace is None:
        return None
    reqs = slice_requests(ctx)
    secs, launches = kernel_time(ctx, ("cms_decide_kernel",),
                                 "cms_decide_kernel")
    if not reqs or not launches:
        return None
    pc = ctx.config["param"]
    nbytes = np.mean([
        workload.param_bytes("cms", n_pad, pc["depth"], pc["n_buckets"],
                             admitted, 0)
        for _t, n_pad, admitted in reqs])
    return 100.0 * (nbytes / workload.PEAK_BYTES_PER_S) / (secs / launches)


def rate(ctx) -> Optional[float]:
    """Device verdicts answered in the window over its seconds."""
    done = ctx.window_done()
    return float(done[:, 2].sum()) / ctx.seconds if done.size else None
