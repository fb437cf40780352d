"""Device operations (kernels, copies, fills) a PARAM_FLOW request, over
the traced slice."""

from portbench import readers


def read(ctx):
    return readers.device_ops_per_request(ctx)
