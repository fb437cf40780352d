"""Share of the traced slice with no device operation running, %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
