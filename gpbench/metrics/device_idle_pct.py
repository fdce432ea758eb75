"""Share of the traced slice in which no kernel or copy ran on the device
(profiler records against the host clock's slice length)."""


def read(ctx):
    if ctx.device_busy_s is None or ctx.slice_s <= 0:
        return None
    return (1.0 - ctx.device_busy_s / ctx.slice_s) * 100.0
