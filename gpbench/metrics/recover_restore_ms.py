"""Milliseconds from ``recover()`` entered to the replay's begin
(``ReplayProgress.begin``): the manager's build and the snapshot's read
and restore (host clock, the harness's span ``recover.restore``)."""


def read(ctx):
    c = getattr(ctx.ledger, "crash", None)
    if c is None or c["t_begin"] is None:
        return None
    return (c["t_begin"] - c["t_enter"]) * 1e3
