"""Device milliseconds of the outbox's copy to the host at each tick's
completion: the program's CUDA-event timer
``tick_device_seconds{part="copy"}``, mean over the traced slice."""

from gpbench.spans import mean_ms


def read(ctx):
    return mean_ms("tick_device_seconds", driver="modea", plane="gpbench",
                   part="copy")
