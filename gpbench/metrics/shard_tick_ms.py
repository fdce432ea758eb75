"""Device milliseconds of the slowest mesh shard's tick: for each shard,
the mean over the traced slice of its CUDA-event timer
``tick_device_seconds{part="tick", shard=<i>}`` (on its card's stream,
from the first to the last op its body queues, the wait at the rank
exchange included); the largest of those means.  None on a program whose
timers carry no shard."""

from gpbench.spans import mean_ms


def read(ctx):
    n = int(ctx.config.get("paxos", {}).get("mesh_devices", 0))
    means = [mean_ms("tick_device_seconds", driver="modea", plane="gpbench",
                     part="tick", shard=str(i)) for i in range(n)]
    means = [v for v in means if v is not None]
    return max(means) if means else None
