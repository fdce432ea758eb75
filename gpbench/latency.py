"""Latency of an open loop's requests, from due time to acknowledgement."""

from __future__ import annotations

import math

import numpy as np


def due_latencies(ctx) -> np.ndarray:
    """Seconds from due time to acknowledgement of every request due in
    the window.  A request refused, or not acknowledged by the time the
    run stopped waiting (``ctx.gave_up``), counts as answered then: later
    than any limit."""
    led = ctx.ledger
    adm = led.admitted()
    due = led.t_due[adm]
    sel = adm[(due >= ctx.w0) & (due < ctx.w1)]
    ack = np.where(np.isnan(led.t_ack[sel]), ctx.gave_up, led.t_ack[sel])
    return np.concatenate([ack - led.t_due[sel],
                           ctx.gave_up - ctx.refused_due_in_window])


def nearest_rank(values: np.ndarray, q: float) -> float:
    """The q-quantile by nearest rank (an observed value, inf allowed)."""
    n = len(values)
    k = max(1, math.ceil(q * n))
    return float(np.partition(values, k - 1)[k - 1])


def due_latency_quantile(ctx, q: float):
    if ctx.mix["loop"] != "open":
        return None
    lat = due_latencies(ctx)
    if not len(lat):
        return None
    return nearest_rank(lat, q) * 1e3
