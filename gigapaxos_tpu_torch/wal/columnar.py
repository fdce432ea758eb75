"""Columnar journal decode: OP_TICK records as SoA slabs.

``replay_journals`` historically treated the journal as a command stream —
one Python loop iteration per placed record, one device dispatch per tick.
But a journal file is a columnar dataset: every OP_TICK carries the same
five per-entry fields (rid, entry replica, proposal lane, row, stop bit),
so a window of ticks flattens into five dense columns plus a cumsum offset
table (the PR-5 wire-codec pattern applied to the WAL).  The batched
replay arm (wal/logger.replay) then ships a whole window of tick inboxes
to the device as padded COO arrays and runs the K ticks back to back
on the device (``ops.tick.replay_scan_ticks``) — O(ticks/K)
host↔device round trips instead of O(ticks).

This module is policy-free: it consumes OP_TICK record tuples that the
replay driver already decoded (and whitelist-validated) and builds slabs;
corrupt-record tolerance, snapshot skipping and admin-op barriers stay in
``wal/logger.py``.  Payref resolution — undoing journal payload dedup —
runs here over the flat payload column in writer order (placed entries,
then the bulk list, per tick), against the same dedup table the
record-at-a-time arm threads through ``_resolve_payload``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..paxos.paystore import DEDUP_MIN_BYTES, payload_digest


def _resolve_flat(pl, pay_tab: dict):
    """One payload slot of the flat column: harvest raw bodies, swap
    ``(_PAYREF, digest)`` markers for the bodies they reference.  Same
    policy (and same ValueError on a dangling ref) as the reference arm's
    ``_resolve_payload`` — the caller maps failures back to a record
    index so the corrupt-record policy applies unchanged."""
    from .logger import _is_payref  # lazy: logger imports this module

    if _is_payref(pl):
        body = pay_tab.get(pl[1])
        if body is None:
            raise ValueError(f"dangling payload reference {pl[1].hex()}")
        return body
    if isinstance(pl, bytes) and len(pl) >= DEDUP_MIN_BYTES:
        pay_tab[payload_digest(pl)] = pl
    return pl


@dataclasses.dataclass
class TickSlab:
    """A window of journaled tick inboxes in structure-of-arrays form.

    The five entry columns are the concatenation of every tick's placed
    entries in journal order; ``offsets[t]:offsets[t+1]`` is tick ``t``'s
    span.  ``row_groups[t]`` preserves the writer's per-row grouping as
    ``(row, lo, hi)`` spans into the columns — the host staging pass
    (outstanding-record creation, snapshot-queue dedup) consumes groups in
    exactly the order the record-at-a-time arm would have."""

    tick_nums: np.ndarray          # i64 [T]
    offsets: np.ndarray            # i64 [T+1] cumsum of per-tick entries
    entry: np.ndarray              # i32 [N] entry replica
    lane: np.ndarray               # i32 [N] proposal lane (p)
    row: np.ndarray                # i32 [N] composite row
    rid: np.ndarray                # i64 [N]
    stop: np.ndarray               # bool [N]
    payloads: list                 # len N, dedup-resolved bodies
    row_groups: list               # per tick: [(row, lo, hi), ...]
    alive: np.ndarray              # bool [T, R]
    bulk: list                     # per tick: resolved bulk record or None
    kv_reg: list                   # per tick: kv_reg tuple or None

    def __len__(self) -> int:
        return len(self.tick_nums)

    def max_entries(self) -> int:
        """Widest tick in the slab, bulk entries included (the COO pad
        width the device scan must accommodate)."""
        widest = 0
        for t in range(len(self.tick_nums)):
            n = int(self.offsets[t + 1] - self.offsets[t])
            if self.bulk[t] is not None:
                n += len(self.bulk[t][5])
            widest = max(widest, n)
        return widest


def build_tick_slab(recs: List[tuple], n_replicas: int,
                    pay_tab: Optional[dict] = None,
                    resolve: bool = True) -> TickSlab:
    """Flatten a window of decoded OP_TICK records into a :class:`TickSlab`.

    ``recs`` are OP_TICK tuples with any OP_REG fold already applied:
    ``(OP_TICK, tick_num, placed, alive_bytes[, bulk[, kv_reg]])``.  One
    pass builds the columns; with ``resolve=True`` payref resolution then
    runs over the flat payload column tick by tick (placed slice, then
    bulk payloads — the writer's dedup order), mutating ``pay_tab``
    exactly as the record-at-a-time arm would.  The batched replay driver
    passes ``resolve=False`` because it resolves at decode time, where a
    dangling reference still has a record index for the corrupt-record
    policy to act on (OP_REG bodies land in the table before their tick's
    placed column, matching writer append order)."""
    if pay_tab is None:
        pay_tab = {}
    T = len(recs)
    tick_nums = np.empty(T, np.int64)
    counts = np.empty(T, np.int64)
    alive = np.ones((T, n_replicas), bool)
    row_groups: list = []
    bulk: list = []
    kv_reg: list = []
    ent_l: list = []
    lane_l: list = []
    row_l: list = []
    rid_l: list = []
    stop_l: list = []
    payloads: list = []
    for t, rec in enumerate(recs):
        tick_nums[t] = rec[1]
        alive[t] = np.frombuffer(rec[3], dtype=bool)
        groups = []
        n0 = len(rid_l)
        for row, entries in rec[2]:
            lo = len(rid_l)
            for rid, entry, p, payload, stop in entries:
                rid_l.append(rid)
                ent_l.append(entry)
                lane_l.append(p)
                row_l.append(row)
                stop_l.append(stop)
                payloads.append(payload)
            groups.append((row, lo, len(rid_l)))
        counts[t] = len(rid_l) - n0
        row_groups.append(groups)
        bulk.append(rec[4] if len(rec) > 4 else None)
        kv_reg.append(rec[5] if len(rec) > 5 else None)
    offsets = np.zeros(T + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    if resolve:
        # payref resolution over the flat column, in writer order per
        # tick: the placed slice first, then the bulk payload list
        for t in range(T):
            lo, hi = int(offsets[t]), int(offsets[t + 1])
            for i in range(lo, hi):
                payloads[i] = _resolve_flat(payloads[i], pay_tab)
            b = bulk[t]
            if b is not None:
                bulk[t] = tuple(b[:5]) + (
                    [_resolve_flat(pl, pay_tab) for pl in b[5]],)
    return TickSlab(
        tick_nums=tick_nums,
        offsets=offsets,
        entry=np.asarray(ent_l, np.int32),
        lane=np.asarray(lane_l, np.int32),
        row=np.asarray(row_l, np.int32),
        rid=np.asarray(rid_l, np.int64),
        stop=np.asarray(stop_l, bool),
        payloads=payloads,
        row_groups=row_groups,
        alive=alive,
        bulk=bulk,
        kv_reg=kv_reg,
    )


def resolved_placed(slab: TickSlab, t: int) -> list:
    """Reconstruct tick ``t``'s ``placed`` structure (``[(row, [(rid,
    entry, p, payload, stop), ...]), ...]``) from the columns — the
    record-at-a-time fallback path needs the nested form."""
    out = []
    for row, lo, hi in slab.row_groups[t]:
        out.append((row, [
            (int(slab.rid[i]), int(slab.entry[i]), int(slab.lane[i]),
             slab.payloads[i], bool(slab.stop[i]))
            for i in range(lo, hi)
        ]))
    return out


def coo_window(slab: TickSlab, lo_t: int, hi_t: int, pad_rows: int,
               pad_width: int):
    """Pack ticks ``[lo_t, hi_t)`` as padded COO arrays for the device
    scan: five ``[K, M]`` arrays plus ``alive [K, R]``.  Padding lanes
    target ``row == pad_rows`` (one past the row space) so the on-device
    scatter sends them to a trash column that is sliced away.  Bulk entries ride the
    same COO — the device inbox is placed ∪ bulk, exactly what the
    record-at-a-time arm scatters into its dense buffers."""
    K = hi_t - lo_t
    M = pad_width
    e = np.zeros((K, M), np.int32)
    p = np.zeros((K, M), np.int32)
    g = np.full((K, M), pad_rows, np.int32)
    rid = np.zeros((K, M), np.int32)
    stop = np.zeros((K, M), bool)
    for k in range(K):
        t = lo_t + k
        o0, o1 = int(slab.offsets[t]), int(slab.offsets[t + 1])
        n = o1 - o0
        e[k, :n] = slab.entry[o0:o1]
        p[k, :n] = slab.lane[o0:o1]
        g[k, :n] = slab.row[o0:o1]
        rid[k, :n] = slab.rid[o0:o1].astype(np.int32)
        stop[k, :n] = slab.stop[o0:o1]
        b = slab.bulk[t]
        if b is not None:
            b_rids = np.frombuffer(b[0], np.int64)
            nb = len(b_rids)
            e[k, n:n + nb] = np.frombuffer(b[1], np.int32)
            p[k, n:n + nb] = np.frombuffer(b[2], np.int32)
            g[k, n:n + nb] = np.frombuffer(b[3], np.int32)
            rid[k, n:n + nb] = b_rids.astype(np.int32)
            stop[k, n:n + nb] = np.frombuffer(b[4], bool)
    return e, p, g, rid, stop, slab.alive[lo_t:hi_t]
