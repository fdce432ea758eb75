"""Requests acknowledged to their client inside the window, per second of
the window (host clock)."""


def read(ctx):
    if ctx.mix["loop"] != "closed":
        return None
    return ctx.ledger.acked_between(ctx.w0, ctx.w1) / (ctx.w1 - ctx.w0)
