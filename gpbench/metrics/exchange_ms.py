"""Device milliseconds of a mesh shard's rank exchange: the program's
CUDA-event timer ``tick_device_seconds{part="exchange"}`` (on each shard's
card, from before its peers' ``[W, R]`` blocks are copied in to their
arrival), mean over every shard's exchanges in the traced slice."""

from gpbench.spans import mean_ms


def read(ctx):
    return mean_ms("tick_device_seconds", driver="modea", plane="gpbench",
                   part="exchange")
