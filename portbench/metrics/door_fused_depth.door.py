"""Engine frames a fused device step folds, over the door's dispatches in
the window (ServerMetrics.fused_depth's sum over dispatch_ms's count):
the door's fuse_depth when every dispatch drains in full."""

from portbench import readers


def read(ctx):
    return readers.fused_depth(ctx)
