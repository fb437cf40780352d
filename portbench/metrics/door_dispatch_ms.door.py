"""The door's device lane: host ms a dispatch (ServerMetrics.dispatch_ms,
the window's sum over its count)."""

from portbench import readers


def read(ctx):
    return readers.hist_mean(ctx, "dispatch_ms")
