"""Rows the embedded token server decided over the whole window, over the
window's seconds (rows answered FAIL or OVERLOAD count as failed)."""

from portbench import readers


def read(ctx):
    return readers.rate(ctx)
