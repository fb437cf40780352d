"""The load generator's 95th percentile pull round trip in the window, ms."""

from portbench import readers


def read(ctx):
    return readers.rtt_p95_ms(ctx)
