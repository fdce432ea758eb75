"""Process start to the first timed request: imports, CUDA start-up, the
kernel and journal builds of a first run, group creation, the scripting
of the tick and the warm-up under the cell's own traffic (host clock)."""


def read(ctx):
    return ctx.setup_s
