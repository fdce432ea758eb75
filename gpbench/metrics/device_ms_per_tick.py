"""Device milliseconds per tick: the union of the device's kernel and copy
records over the traced slice, divided by its ticks (profiler)."""


def read(ctx):
    if ctx.device_busy_s is None or ctx.slice_ticks <= 0:
        return None
    return ctx.device_busy_s / ctx.slice_ticks * 1e3
