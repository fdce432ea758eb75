"""Mean host milliseconds per tick of the manager's execute phase over
the traced slice (the port's ``tick_phase_seconds{driver="modea",
phase="execute"}``)."""


def read(ctx):
    n, total = ctx.slice_phases.get("execute", (0, 0.0))
    return total / n * 1e3 if n else None
