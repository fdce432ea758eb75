"""Host milliseconds per loop turn (propose what is due, then tick) over
the traced slice."""


def read(ctx):
    if ctx.slice_ticks <= 0:
        return None
    return ctx.slice_s / ctx.slice_ticks * 1e3
