"""Process start to the window's start, s: imports, the builds on a first
run, the service and its rules, the door and its warm-up, the load
generator's pool, and its warm-up traffic."""


def read(ctx):
    return ctx.setup_s
