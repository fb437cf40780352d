"""The decide kernels' share of their byte roofline (3.35 TB/s), %."""

from portbench import readers


def read(ctx):
    return readers.decide_roofline(ctx)
