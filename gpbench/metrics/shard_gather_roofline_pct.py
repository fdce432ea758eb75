"""Share of their roofline that the mesh shards' plane-select kernels
reach: the least time their launches in the traced slice could take on
one card (each shard's block, ``gpbench.kernels`` bytes at G/shards, over
the card's peak bandwidth) over the device time the profiler recorded for
them on every card, summed.  A slice whose launch counts are not five
gathers and one match a shard a tick has no reading."""

from gpbench import kernels as kb


def read(ctx):
    by = ctx.device_by_name
    n = int(ctx.config.get("paxos", {}).get("mesh_devices", 0))
    if not by or n <= 0 or ctx.slice_ticks <= 0:
        return None
    t = sum(s for name, s in by.items()
            if kb.GATHER_KERNEL in name or kb.MATCH_KERNEL in name)
    lg = ctx.slice_launches.get("gather_planes", 0)
    lm = ctx.slice_launches.get("match_planes", 0)
    if t <= 0 or lg == 0:
        return None
    if (lg != kb.GATHERS_PER_TICK * n * ctx.slice_ticks
            or lm != kb.MATCHES_PER_TICK * n * ctx.slice_ticks):
        return None
    R, W, G, P = ctx.R, ctx.W, ctx.G, ctx.P
    gl = G // n
    nbytes = ctx.slice_ticks * n * (kb.gather_bytes(R, W, gl)
                                    + kb.match_bytes(R, W, gl, P))
    return nbytes / ctx.peak_bw / t * 100.0
