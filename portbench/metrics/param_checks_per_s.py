"""PARAM_FLOW requests answered with a device verdict over the whole
window, over the window's seconds."""

from portbench import readers


def read(ctx):
    return readers.rate(ctx)
