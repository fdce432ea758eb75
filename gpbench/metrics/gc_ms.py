"""Host milliseconds per tick in garbage collection: every generation's
``gc_pause_seconds`` over the traced slice (the program's collector hook),
divided by the slice's ticks."""

from gpbench.spans import slice_totals


def read(ctx):
    r = slice_totals("gc_pause_seconds")
    if r is None or ctx.slice_ticks <= 0:
        return None
    return r[1] / ctx.slice_ticks * 1e3
