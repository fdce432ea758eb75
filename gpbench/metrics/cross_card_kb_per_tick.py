"""Kilobytes (1,000 bytes) the program sends from one mesh shard's card to
another's a tick: the gain of its counter ``mesh_transfer_bytes_total``
(every kind, counted where it sends) over the traced slice, divided by
the slice's ticks.  None on a program without the counter."""

from gpbench.spans import slice_totals


def read(ctx):
    r = slice_totals("mesh_transfer_bytes_total")
    if r is None or ctx.slice_ticks <= 0:
        return None
    return r[1] / ctx.slice_ticks / 1e3
