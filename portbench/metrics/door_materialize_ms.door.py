"""The door's reply lanes: ms a fused group's verdicts take to come back to
the host (ServerMetrics.decide_ms, the window's sum over its count)."""

from portbench import readers


def read(ctx):
    return readers.hist_mean(ctx, "decide_ms")
