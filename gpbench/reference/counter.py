"""Plain reference of the counter deployment (NumPy only).

Every replica executes every decided request once, so after the drain each
replica's accumulator of a group is the sum of the increments of the
requests admitted to it, and its count is their number, whatever the
order."""

from __future__ import annotations

import numpy as np


def expected(G: int, group, delta):
    """Per-group (sum of increments, number of requests)."""
    acc = np.zeros(G, np.int64)
    cnt = np.zeros(G, np.int64)
    np.add.at(acc, group, delta)
    np.add.at(cnt, group, 1)
    return acc, cnt


def compare(G: int, group, delta, acc, count) -> dict:
    """Numbers compared: groups whose state differs from the reference, at
    each replica and in all (``acc``/``count``: the program's [R, G] state
    in group order)."""
    want_acc, want_cnt = expected(G, group, delta)
    bad = (acc != want_acc[None, :]) | (count != want_cnt[None, :])
    return {"state_groups_wrong": int(bad.any(axis=0).sum()),
            "state_cells_wrong": int(bad.sum())}
