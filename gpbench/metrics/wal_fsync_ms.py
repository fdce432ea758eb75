"""Mean host milliseconds per tick of the manager's ``wal_fsync`` phase
(journal append and fsync) over the traced slice; durable cells only."""


def read(ctx):
    if not ctx.config.get("wal"):
        return None
    n, total = ctx.slice_phases.get("wal_fsync", (0, 0.0))
    return total / n * 1e3 if n else None
