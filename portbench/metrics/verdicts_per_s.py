"""Rows answered with a device verdict over the whole window, over the
window's seconds (OVERLOAD, FAIL and unanswered rows count as failed)."""

from portbench import readers


def read(ctx):
    return readers.rate(ctx)
