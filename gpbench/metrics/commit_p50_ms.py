"""Median commit latency of the requests due in the window, from due time
to acknowledgement; a request refused or never acknowledged counts as
over every limit (host clock)."""

from gpbench.latency import due_latency_quantile


def read(ctx):
    return due_latency_quantile(ctx, 0.50)
