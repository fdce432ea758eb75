"""Plain reference of a crash cell (NumPy only): the key-value checks and
the journal checks over both lives of the deployment, and what the crash
must not do.

The executed history is the first life's executed stream, cut at the last
tick whose record survived the crash (the recovery replays the journal up
to it and no further), followed by the recovered deployment's stream with
its request ids filed as the ledger files them.  The tick records the
recovery replays past the last outbox the first life folded (the one
fsynced as the power went, whose outbox was still pending) are in neither
stream: ``recover`` hands the replay's executions to no one.  Over it:

* every check of the key-value reference (``reference/kv.py``);
* the journal checks of ``reference/journal.py`` over the journal files
  that survive, for the requests admitted after the set-up snapshot (the
  placements of the earlier ones were in the journals the checkpoint
  removed, and their effects are held to the final store);
* ``crash_acked_lost``: requests acknowledged before the crash that some
  replica does not execute in the history;
* ``crash_exec_twice``: requests that some replica executes more than once
  in the history, counting a request sent again after the crash and its
  first sending as one; and requests sent again whose first sending a
  tick record of the cut journal placed, which the recovered deployment
  therefore executes as well (in its replay, or live)."""

from __future__ import annotations

import copy
import glob
import os

import numpy as np

from . import journal, kv


def history(run) -> np.ndarray:
    """[4, n] int64: rid (ledger rows), replica, row, slot of every
    execution of the history."""
    streams = run.app.streams
    last = run.crash["last_tick"]
    blocks = [b for b, t in zip(streams[:run.n_pre_blocks], run.block_tick)
              if t <= last]
    for b in streams[run.n_pre_blocks:]:
        b = b.copy()
        b[0] = run.ledger.file_ids(b[0])
        blocks.append(b)
    if not blocks:
        return np.zeros((4, 0), np.int64)
    return np.concatenate(blocks, axis=1)


def placed_before(log_dir: str, cut: int, top: int) -> np.ndarray:
    """[top] bool: ledger rows of the first life that a tick record ending
    at or before the cut position places."""
    placed = np.zeros(top, bool)
    for path in sorted(glob.glob(os.path.join(log_dir, "journal.*.log"))):
        for _tick, rids, _desc, end in journal.read_journal(path)["ticks"]:
            if end <= cut:
                placed[rids[(rids > 0) & (rids < top)]] = True
    return placed


def crash_checks(ledger, stream, R: int, t_crash: float, retry_orig,
                 retry_new, placed) -> dict:
    """``placed``: ``placed_before`` over the first life's ledger rows."""
    rid, rep = stream[0], stream[1]
    live = rid > 0
    rid, rep = rid[live], rep[live]
    top = max(ledger.top, int(rid.max()) + 1 if len(rid) else 0)
    # one request, one id: a retry counts under its first sending's id
    logical = np.arange(top, dtype=np.int64)
    logical[retry_new] = retry_orig
    lrid = logical[rid]
    n = np.zeros((R, top), np.int64)
    np.add.at(n, (rep, lrid), 1)
    twice = (n > 1).any(axis=0)
    twice[retry_orig[placed[retry_orig]]] = True
    t_ack = np.full(top, np.nan)
    t_ack[:ledger.top] = ledger.t_ack[:ledger.top]
    acked_before = ~np.isnan(t_ack) & (t_ack < t_crash)
    acked_before[retry_new] = False
    return {"crash_acked_lost": int((acked_before
                                     & (n == 0).any(axis=0)).sum()),
            "crash_exec_twice": int(twice.sum())}


def compare(run, state) -> dict:
    led, c = run.ledger, run.crash
    stream = history(run)
    cut = c["cut_pos"]
    placed = placed_before(run.wal_dir, cut, led.n0)
    orig = run.retry_orig
    c["resent_durable"] = int(placed[orig].sum())
    out = crash_checks(led, stream, run.R, c["t_crash"], orig,
                       run.retry_new, placed)
    out.update(kv.compare(led, run.rows, stream, state["key"],
                          state["val"]))
    # the journal checks over the requests admitted after the snapshot
    jview = copy.copy(led)
    jview.group = led.group.copy()
    jview.group[:run.rid_ckpt] = -1

    def ledger_rows(rids, end):
        return led.file_ids(rids) if end > cut else rids

    out.update(journal_checks(run.wal_dir, jview, ledger_rows))
    return out


def journal_checks(log_dir, ledger, ledger_rows) -> dict:
    """``journal.compare`` over journals whose request ids are not all
    ledger rows: ``ledger_rows(rids, end)`` gives the rows of the ids of
    the record that ends at ``end``."""
    placed, descs, records, barriers = [], [], [], []
    for path in sorted(glob.glob(os.path.join(log_dir, "journal.*.log"))):
        j = journal.read_journal(path)
        barriers.append(j["barriers"])
        for k, (_tick, rids, desc, end) in enumerate(j["ticks"]):
            rids = ledger_rows(rids, end)
            if desc is not None:
                desc = np.concatenate([ledger_rows(desc[:1], end),
                                       desc[1:]]).astype(np.int64)
            records.append((rids, end))
            if k >= j["covered"]:
                continue
            placed.append(rids)
            if desc is not None:
                descs.append(desc)
    top = ledger.top
    adm = ledger.admitted()
    acked = adm[ledger.n_ack[adm] > 0]
    seen = np.zeros(top, bool)
    if placed:
        p = np.concatenate(placed)
        p = p[(p > 0) & (p < top)]
        seen[p] = True
    good = np.zeros(top, bool)
    if descs:
        d = np.concatenate(descs, axis=1).astype(np.int64)
        d = d[:, (d[0] > 0) & (d[0] < top)]
        rid = d[0]
        match = ((ledger.op[rid] == d[1]) & (ledger.key[rid] == d[2])
                 & (ledger.val[rid] == d[3]))
        good[rid[match]] = True
    b = (np.concatenate(barriers) if barriers else np.zeros(0, np.int64))
    return {"wal_unplaced": int((~seen[acked]).sum()),
            "wal_desc_wrong": int((~good[acked]).sum()),
            "wal_acked_early": journal.acked_early(records, b, ledger,
                                                   acked)}
