"""Seconds from the restart after a crash (the manager dropped and the
journal cut: the harness's own power loss, left out) to the first
acknowledgement from the recovered deployment: the recovery's restore and
replay, re-attaching the journal, admitting the backlog and the first
live ticks (host clock; crash cells only)."""


def read(ctx):
    c = getattr(ctx.ledger, "crash", None)
    if c is None or c["first_ack"] is None:
        return None
    return c["first_ack"] - c["t_down"]
