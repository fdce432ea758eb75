"""Share of their roofline that the tick's plane-select kernels reach:
the least time their launches in the traced slice could take (bytes they
must move over the card's peak bandwidth) over the device time the
profiler recorded for them.  Bytes follow ``gpbench.kernels``; a slice
whose launch counts are not five gathers and one match a tick has no
reading."""

from gpbench import kernels as kb


def read(ctx):
    by = ctx.device_by_name
    if not by:
        return None
    t = sum(s for n, s in by.items()
            if kb.GATHER_KERNEL in n or kb.MATCH_KERNEL in n)
    lg = ctx.slice_launches.get("gather_planes", 0)
    lm = ctx.slice_launches.get("match_planes", 0)
    if t <= 0 or lg == 0:
        return None
    if (lg != kb.GATHERS_PER_TICK * ctx.slice_ticks
            or lm != kb.MATCHES_PER_TICK * ctx.slice_ticks):
        return None
    R, W, G, P = ctx.R, ctx.W, ctx.G, ctx.P
    nbytes = (lg // kb.GATHERS_PER_TICK * kb.gather_bytes(R, W, G)
              + lm * kb.match_bytes(R, W, G, P))
    return nbytes / ctx.peak_bw / t * 100.0
