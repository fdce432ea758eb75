"""95th percentile of the same population as ``commit_p50_ms``."""

from gpbench.latency import due_latency_quantile


def read(ctx):
    return due_latency_quantile(ctx, 0.95)
