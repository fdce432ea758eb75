"""``recover_replay_ms`` over the tick records the journal held after the
crash's cut, which the replay runs one by one (host clock)."""


def read(ctx):
    c = getattr(ctx.ledger, "crash", None)
    if c is None or c["t_finish"] is None or c["tick_records"] <= 0:
        return None
    return (c["t_finish"] - c["t_begin"]) * 1e3 / c["tick_records"]
