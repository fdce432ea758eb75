"""Milliseconds from ``recover()`` returned to the first acknowledgement
from the recovered deployment: the retried and due requests admitted and
the first live ticks (host clock, the harness's span
``recover.first_ack``)."""


def read(ctx):
    c = getattr(ctx.ledger, "crash", None)
    if c is None or c["first_ack"] is None:
        return None
    return (c["first_ack"] - c["t_back"]) * 1e3
