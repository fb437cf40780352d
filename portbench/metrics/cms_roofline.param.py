"""The count-min kernel's share of its byte roofline (3.35 TB/s), %."""

from portbench import readers


def read(ctx):
    return readers.cms_roofline(ctx)
