"""Plain reference of the key-value deployment (NumPy only).

The store of a group at a replica is ``slots`` direct-mapped cells: key
``k`` lives in cell ``k & (slots - 1)``, a PUT writes its key and value
there (the last writer wins a shared cell) and echoes the value, a GET
returns the cell's value when the cell holds its key and 0 otherwise.  A
group's requests apply in the order of their decided slots.

That order is the consensus's decision, so the reference takes it from
the program's executed stream (rid, replica, row, slot) and first judges
the stream itself: every replica holds the same request at each slot of a
group, every acknowledged request is executed exactly once at every
replica, every executed request is one that was admitted to that group,
and no request is ordered before one that was acknowledged before it was
proposed.  It then replays each group's stream with the generated
requests' own operations, keys and values, and compares every
acknowledged response and every replica's final store."""

from __future__ import annotations

import numpy as np

PUT, GET = 1, 2


def _order(stream, R):
    """The stream as (rid, row, slot) arrays per replica, sorted by (row,
    slot); noops (rid 0) dropped."""
    rid, rep, row, slot = stream
    live = rid != 0
    out = []
    for r in range(R):
        sel = live & (rep == r)
        o = np.lexsort((slot[sel], row[sel]))
        out.append((rid[sel][o], row[sel][o], slot[sel][o]))
    return out


def replay(group_of_seq, op, key, val, G: int, slots: int):
    """Apply requests in sequence order: ``group_of_seq`` sorted so that
    each group's requests are contiguous and in slot order.  Returns
    (responses, key table [G, slots], value table [G, slots])."""
    n = len(group_of_seq)
    tk = np.zeros((G, slots), np.int64)
    tv = np.zeros((G, slots), np.int64)
    resp = np.zeros(n, np.int64)
    if not n:
        return resp, tk, tv
    # position of each request within its group's run
    start = np.r_[0, np.nonzero(np.diff(group_of_seq))[0] + 1]
    run = np.zeros(n, np.int64)
    run[start] = 1
    pos = np.arange(n) - start[np.cumsum(run) - 1]
    cell = key.astype(np.int64) & (slots - 1)
    for k in range(int(pos.max()) + 1):
        i = np.nonzero(pos == k)[0]
        g, c = group_of_seq[i], cell[i]
        cur_k, cur_v = tk[g, c], tv[g, c]
        is_put = op[i] == PUT
        hit = cur_k == key[i]
        resp[i] = np.where(is_put, val[i], np.where(hit, cur_v, 0))
        w = i[is_put]
        tk[group_of_seq[w], cell[w]] = key[w]
        tv[group_of_seq[w], cell[w]] = val[w]
    return resp, tk, tv


def compare(ledger, rows_of_group, stream, key_tab, val_tab) -> dict:
    """Numbers compared.  ``key_tab``/``val_tab``: the program's [R, G,
    slots] stores in row order; ``rows_of_group``: each group's row."""
    R, _, S = key_tab.shape
    G = len(rows_of_group)
    group_of_row = np.full(key_tab.shape[1], -1, np.int64)
    group_of_row[rows_of_group] = np.arange(G)
    adm = ledger.admitted()
    acked = adm[ledger.n_ack[adm] > 0]
    per = _order(stream, R)
    out = {}

    # one order at every replica: the same rid at the same (row, slot)
    base = per[0]
    disagree = 0
    for rid, row, slot in per[1:]:
        same = (len(rid) == len(base[0]) and np.array_equal(rid, base[0])
                and np.array_equal(row, base[1])
                and np.array_equal(slot, base[2]))
        if not same:
            a = set(zip(base[0].tolist(), base[1].tolist(),
                        base[2].tolist()))
            b = set(zip(rid.tolist(), row.tolist(), slot.tolist()))
            disagree += len(a ^ b)
    out["order_disagree"] = disagree

    # each acknowledged request executed exactly once at every replica,
    # and nothing executed that was not admitted to that group
    top = ledger.top
    bad_once = np.zeros(top, bool)
    foreign = 0
    for rid, row, _ in per:
        ok = (rid > 0) & (rid < top)
        foreign += int((~ok).sum())
        rid, row = rid[ok], row[ok]
        wrong_group = ledger.group[rid] != group_of_row[row]
        foreign += int(wrong_group.sum())
        n = np.bincount(rid, minlength=top)
        bad_once |= n != 1
    out["exec_not_once"] = int(bad_once[acked].sum())
    out["exec_foreign"] = foreign

    # real-time order within a group: no request takes a later slot than
    # one that was proposed after its acknowledgement
    rid, row, slot = base
    out["order_realtime"] = _realtime_violations(
        row, ledger.t_prop[rid], ledger.t_ack[rid])

    # replay the decided order and compare responses and stores
    seq_group = group_of_row[row]
    o = np.argsort(seq_group, kind="stable")
    seq_rid = rid[o]
    resp, tk, tv = replay(seq_group[o], ledger.op[seq_rid],
                          ledger.key[seq_rid].astype(np.int64),
                          ledger.val[seq_rid].astype(np.int64), G, S)
    want = np.zeros(top, np.int64)
    want[seq_rid] = resp
    got = ledger.resp[acked]
    out["resp_wrong"] = int((got != want[acked]).sum())
    kt = key_tab[:, rows_of_group, :].astype(np.int64)
    vt = val_tab[:, rows_of_group, :].astype(np.int64)
    out["store_cells_wrong"] = int(((kt != tk[None]) | (vt != tv[None]))
                                   .sum())
    return out


def _realtime_violations(row, t_prop, t_ack) -> int:
    """Requests (sorted by row, then slot) acknowledged before some request
    of an earlier slot of their row was proposed.  The running maximum of
    proposal times restarts at each row: each row's times are lifted by a
    step larger than their whole range, so one running maximum over the
    lifted times never carries across a row boundary."""
    n = len(row)
    if n == 0:
        return 0
    t0 = float(np.nanmin(t_prop))
    tp = t_prop - t0
    span = float(np.nanmax(tp)) + 1.0
    start = np.r_[True, row[1:] != row[:-1]]
    seg = np.cumsum(start) - 1
    lifted = tp + seg * span
    run = np.maximum.accumulate(lifted)
    prev = np.r_[-np.inf, run[:-1]]
    prev[start] = -np.inf
    prev = prev - seg * span
    ta = np.where(np.isnan(t_ack), np.inf, t_ack - t0)
    return int((ta < prev).sum())
