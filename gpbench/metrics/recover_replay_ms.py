"""Milliseconds from the replay's begin to its finish
(``ReplayProgress.begin`` to ``finish``): the journal's scan and its tick
records replayed (host clock, the harness's span ``recover.replay``)."""


def read(ctx):
    c = getattr(ctx.ledger, "crash", None)
    if c is None or c["t_finish"] is None:
        return None
    return (c["t_finish"] - c["t_begin"]) * 1e3
