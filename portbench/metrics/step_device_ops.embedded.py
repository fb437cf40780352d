"""Device operations (kernels, copies, fills) a 16,384-row engine frame of
the embedded server, over the traced slice."""

from portbench import readers


def read(ctx):
    return readers.device_ops_per_frame(ctx)
