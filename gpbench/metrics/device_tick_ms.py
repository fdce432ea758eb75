"""Device milliseconds of the tick's dispatch (the scripted tick program or
``fused_compact``), from the first to the last of its ops: the program's
CUDA-event timer ``tick_device_seconds{part="tick"}``, mean over the
traced slice."""

from gpbench.spans import mean_ms


def read(ctx):
    return mean_ms("tick_device_seconds", driver="modea", plane="gpbench",
                   part="tick")
