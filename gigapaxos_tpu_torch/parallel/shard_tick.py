"""The sharded tick: the per-shard-local formulation of the fused tick.

The reference wraps its UNCHANGED tick body in ``shard_map`` over the
(replica, groups) mesh; this module runs the same body once per shard of a
:class:`~.mesh.Mesh`, in one process, in lockstep:

* Each shard ticks its own ``[R_local(, W), G_local]`` block on its own
  device, so the hand kernels run per shard on the local block
  (``ops/window.py`` dispatches by the block's device): 5 gathers and 1
  match a shard a tick.  The blocks stay where they are between ticks
  (:class:`~.mesh.ResidentState`): no tick cuts or joins the state.
* The body (:func:`shard_tick_body`) is written against a small
  collectives object, :class:`Collectives` (``all_gather(xs, axis)``,
  ``axis_index(axis)``).  It is a generator: at each collective it yields
  the request, and :func:`run_lockstep` drives every shard's body to that
  point, performs the exchange and sends each shard its result.  The host
  never waits in it: every shard's work is queued on its device's stream,
  and a copy between devices waits on events (``torch``'s own two-way
  barrier between the two streams).
* Cross-replica exchange is explicit: the body all-gathers the replica-led
  state and inbox fields over the ``replica`` axis (the ACCEPT fan-out /
  ACCEPT_REPLY fan-in), runs the tick on the full-R local-G block, and
  slices its own replica rows back out.  The math inside is the verbatim
  single-device tick (``ops.tick.tick_front`` then ``tick_back``, each one
  scripted program), so results are bit-identical to the unsharded tick.
* The groups axis never communicates, except the exec-budget global
  ranking, which exchanges a tiny ``[W, R]`` count block between the
  tick's two halves (``rank_base`` of ``ops.tick.tick_back``).
* With ``replica_shards == 1`` the replica gathers disappear and the body
  is pure data-parallel: the rank blocks are all that crosses devices.

Each shard compacts its own executions with the single-device compaction
(``ops.tick._compact_outbox_impl``, its rows and replicas local, plus the
executions of each (r, j) row) and its outbox goes to the host on its own;
:func:`join_compact` (and :func:`join_full` for the full outbox) put the
host's parts together in the single-device layout, every execution at its
global (r, j, g) rank, so the host loop is byte-compatible with the
single-device path.

Bytes sent from one shard's device to another's are counted where they are
sent, into ``mesh_transfer_bytes_total{kind}`` (``obs/phase.py``).
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.phase import mesh_transfer_counter
from ..ops import tick as tk
from ..ops.tick import CompactHostOutbox, HostOutbox, TickInbox, TickOutbox
from ..paxos.state import PaxosState
from .mesh import (GROUPS_AXIS, REPLICA_AXIS, _OUTBOX_SPECS, _STATE_SPECS,
                   Mesh, gather_outbox, gather_state, shard_inbox,
                   shard_state)

#: state fields with a leading replica axis: gathered across replica shards
#: on entry to the body, sliced back to local rows on exit
_REPLICA_LED = tuple(f for f, spec in _STATE_SPECS.items()
                     if spec in ("rg", "rwg"))
_OUTBOX_REPLICA_LED = tuple(f for f, spec in _OUTBOX_SPECS.items()
                            if spec in ("rg", "rwg"))

#: what an exchange over each axis sends
_KIND = {GROUPS_AXIS: "rank", REPLICA_AXIS: "replica"}


class _Gather:
    """A pending all-gather: what a body yields at a collective."""

    def __init__(self, xs: List[torch.Tensor], axis: str, tiled: bool):
        self.xs, self.axis, self.tiled = list(xs), axis, tiled


class Collectives:
    """One shard's view of the mesh's collectives."""

    def __init__(self, mesh: Mesh, ri: int, gi: int):
        self.mesh, self.ri, self.gi = mesh, ri, gi

    def axis_index(self, axis: str) -> int:
        """This shard's position along ``axis``."""
        return self.ri if axis == REPLICA_AXIS else self.gi

    def all_gather(self, xs: List[torch.Tensor], axis: str,
                   tiled: bool = False) -> _Gather:
        """The request to yield: each of ``xs`` from every shard along
        ``axis`` (this shard's row or column of the grid), in axis order,
        concatenated along dim 0 when ``tiled``, else stacked on a new
        leading axis.  The yield returns the list of results."""
        return _Gather(xs, axis, tiled)


def _answer(mesh: Mesh, k: tuple, pending: Dict[tuple, _Gather],
            timers) -> tuple:
    """Shard ``k``'s result of the collective every shard has yielded
    (``pending``), on its device, and the bytes it took from other
    shards."""
    req = pending[k]
    ri, gi = k
    if req.axis == REPLICA_AXIS:
        peers = [(r, gi) for r in range(mesh.replica_shards)]
    else:
        peers = [(ri, g) for g in range(mesh.groups_shards)]
    dev = mesh.device_at(ri, gi)
    t_ex = timers[k].start() if timers is not None else None
    out, got = [], 0
    for i in range(len(req.xs)):
        parts = [pending[p].xs[i].to(dev) for p in peers]
        got += sum(pending[p].xs[i].numel() * pending[p].xs[i].element_size()
                   for p in peers if p != k)
        out.append(torch.cat(parts, dim=0) if req.tiled
                   else torch.stack(parts))
    if timers is not None:
        timers[k].stop("exchange", t_ex)
    return out, got


def run_lockstep(mesh: Mesh, bodies: Dict[tuple, "object"],
                 timers: Optional[Dict[tuple, "object"]] = None) -> Dict:
    """Drive each shard's body generator (``{(ri, gi): generator}``) in
    lockstep to its return value; every body makes the same collectives in
    the same order.  ``timers`` (``{(ri, gi): obs.phase.DeviceTimers}``)
    time each shard's body as part ``tick`` and each of its exchanges as
    part ``exchange``, on its device's stream.  One thread steps the
    bodies in turn: each step only queues work on its shard's device, so
    every card's half-tick is queued before any exchange waits on it."""
    results: Dict[tuple, object] = {}
    pending: Dict[tuple, _Gather] = {}
    t_tick: Dict[tuple, object] = {}

    def step(k, value):
        try:
            pending[k] = bodies[k].send(value)
        except StopIteration as done:
            pending.pop(k, None)
            results[k] = done.value
            if timers is not None:
                timers[k].stop("tick", t_tick[k])

    for k in bodies:
        if timers is not None:
            t_tick[k] = timers[k].start()
        step(k, None)
    while pending:
        if len(pending) != len(bodies):
            raise RuntimeError("shard bodies diverged: some returned while "
                               "others wait at a collective")
        axis = next(iter(pending.values())).axis
        answers, sent = {}, 0
        for k in pending:
            answers[k], got = _answer(mesh, k, pending, timers)
            sent += got
        mesh_transfer_counter(_KIND[axis]).inc(sent)
        for k in list(pending):
            step(k, answers[k])
    return results


def validate_mesh_for(mesh: Mesh, R: int, G: int) -> None:
    rs = mesh.shape[REPLICA_AXIS]
    gs = mesh.shape[GROUPS_AXIS]
    if R % rs:
        raise ValueError(f"replica dim {R} not divisible by {rs} shards")
    if G % gs:
        raise ValueError(f"group dim {G} not divisible by {gs} shards")


def shard_exec_cap(R_local: int, W: int, G_local: int,
                   exec_budget: int) -> int:
    """The exec columns' length in a shard's compacted outbox: every
    execution the budget can leave the shard (all of the budget, or all
    of its block)."""
    return min(exec_budget, R_local * W * G_local)


def shard_tick_body(mesh: Mesh, own_row: int = -1, exec_budget: int = 0,
                    lag_budget: int = 0, demand_decay: Optional[float] = None,
                    pack: bool = False):
    """The per-shard tick: ``body(coll, state, inbox, demand)`` is a
    generator that yields at each collective (see :func:`run_lockstep`)
    and returns the shard's ``(state, outbox, demand)``.  The outbox is
    the shard's compacted buffer with ``lag_budget > 0`` (needs an exec
    budget), its packed full outbox with ``pack``, else its
    :class:`TickOutbox` block.  ``demand`` (placement, the column's first
    replica shard only, else None) folds ``decided_now`` with
    ``demand_decay``."""
    rs = mesh.shape[REPLICA_AXIS]
    gs = mesh.shape[GROUPS_AXIS]
    compact = lag_budget > 0
    if compact and exec_budget <= 0:
        raise ValueError("a compacted outbox needs an exec budget")

    def body(coll: Collectives, state: PaxosState, inbox: TickInbox,
             demand=None):
        if rs > 1:
            got = yield coll.all_gather(
                [getattr(state, f) for f in _REPLICA_LED]
                + [inbox.req, inbox.stop], REPLICA_AXIS, tiled=True)
            state = state._replace(**dict(zip(_REPLICA_LED, got)))
            inbox = inbox._replace(req=got[-2], stop=got[-1])
        m = tk.run_front(state, inbox, own_row)
        rank_base = None
        if gs > 1 and exec_budget > 0:
            # G is a shard-local block, but the flat (j, r, g) enumeration
            # of the exec budget must rank GLOBALLY (g is the fastest
            # axis, so shard k's (j, r) row sits after the same row on
            # shards < k).  Exchange the tiny [W, R] per-row counts and
            # rebase: global rank = (count before this (j, r) row) + (this
            # row's count on earlier shards) + (local within-row rank).
            blk = tk.exec_row_counts(m.exec_mask)
            allblk = (yield coll.all_gather([blk], GROUPS_AXIS))[0]
            shard = coll.axis_index(GROUPS_AXIS)
            total = allblk.sum(dim=0, dtype=torch.int32)  # [W, R]
            tf = total.reshape(-1)
            before_row = (torch.cumsum(tf, 0, dtype=torch.int32)
                          - tf).reshape(total.shape)
            earlier = allblk[:shard].sum(dim=0, dtype=torch.int32)
            rank_base = before_row + earlier
        new, out = tk.run_back(state, inbox, m, exec_budget, rank_base)
        if demand is not None:
            demand = tk.demand_fold(demand, out.decided_now,
                                    float(demand_decay))
        ri = coll.axis_index(REPLICA_AXIS)
        rloc = new.exec_slot.shape[0] // rs
        if rs > 1:
            def sl(x):
                return x[ri * rloc:(ri + 1) * rloc]

            new = new._replace(**{f: sl(getattr(new, f))
                                  for f in _REPLICA_LED})
            out = out._replace(**{f: sl(getattr(out, f))
                                  for f in _OUTBOX_REPLICA_LED})
        if compact:
            W, gl = new.acc_req.shape[1], new.exec_slot.shape[1]
            out = tk.run_compact(out, shard_exec_cap(rloc, W, gl,
                                                     exec_budget),
                                 lag_budget, True)
        elif pack:
            out = tk.pack_outbox_impl(out)
        return new, out, demand

    return body


def make_resident_tick(mesh: Mesh, own_row: int = -1, exec_budget: int = 0,
                       lag_budget: int = 0,
                       demand_decay: Optional[float] = None,
                       pack: bool = False):
    """The sharded tick over resident blocks: ``fn(blocks, inboxes,
    demands=None, timers=None) -> (blocks, outs, demands)``.  ``blocks``
    and ``inboxes`` are ``{(ri, gi): block}`` on the shards' devices;
    ``outs`` the shards' outboxes (see :func:`shard_tick_body`: with
    ``lag_budget > 0`` each shard's compacted buffer, which
    :func:`join_compact` joins on the host in the single-device layout);
    ``demands`` (placement: per-group ``decided_now`` never reaches the
    host in compact mode, so each column folds ``d' = decay*d +
    decided_now`` on its device) one ``[G/gs]`` float32 block a shard
    column, on the column's first device, in column order, or None."""
    body = shard_tick_body(mesh, own_row, exec_budget, lag_budget,
                           demand_decay, pack)

    def fn(blocks, inboxes, demands=None, timers=None):
        res = run_lockstep(mesh, {
            k: body(Collectives(mesh, *k), blocks[k], inboxes[k],
                    demands[k[1]] if demands is not None and k[0] == 0
                    else None)
            for k in mesh.shards()}, timers)
        new_demands = (None if demands is None else
                       [res[(0, gi)][2] for gi in range(mesh.groups_shards)])
        return ({k: v[0] for k, v in res.items()},
                {k: v[1] for k, v in res.items()}, new_demands)

    return fn


def make_shardmap_tick(mesh: Mesh, own_row: int = -1, exec_budget: int = 0):
    """The sharded tick over global-view operands, for twins of the
    unsharded tick: ``fn(state, inbox) -> (state, TickOutbox)``, both on
    the state's device (a cut before the shards' bodies and a join after
    them, each tick)."""
    tick = make_resident_tick(mesh, own_row, exec_budget)

    def fn(state: PaxosState, inbox: TickInbox):
        dev = state.exec_slot.device
        blocks, outs, _ = tick(shard_state(state, mesh),
                               shard_inbox(inbox, mesh))
        return (gather_state(blocks, mesh, dev),
                gather_outbox(outs, mesh, dev))

    return fn


class ColumnBlocks:
    """A host ``[R, G]`` array held as its shard columns' ``[R, G/gs]``
    blocks, in column order: ``x[replicas, rows]`` (global rows, scalars
    or equal-length arrays) reads the owning blocks, and ``np.asarray``
    joins them.  The mesh's ``taken_bits``: the host reads a few entries a
    tick, so the ``[R, G]`` join is left to whoever wants it whole."""

    def __init__(self, blocks: List[np.ndarray]):
        self.blocks = blocks
        self.per = blocks[0].shape[1]
        self.shape = (blocks[0].shape[0], self.per * len(blocks))
        self.dtype = blocks[0].dtype
        self.ndim = 2

    def __getitem__(self, key):
        reps, rows = key
        if np.ndim(rows) == 0:
            b, r = divmod(int(rows), self.per)
            return self.blocks[b][reps, r]
        reps, rows = np.broadcast_arrays(np.asarray(reps), np.asarray(rows))
        b, loc = np.divmod(rows, self.per)
        out = np.empty(rows.shape, self.dtype)
        for k in np.unique(b).tolist():
            sel = b == k
            out[sel] = self.blocks[k][reps[sel], loc[sel]]
        return out

    def __array__(self, dtype=None, copy=None):
        whole = np.concatenate(self.blocks, axis=1)
        return whole if dtype is None else whole.astype(dtype)

    def astype(self, dtype):
        return np.asarray(self, dtype)


def join_compact(flats: Dict[tuple, np.ndarray], mesh: Mesh, R: int, W: int,
                 G: int, exec_budget: int,
                 lag_budget: int) -> CompactHostOutbox:
    """The single-device compacted outbox from the shards' host buffers
    (``{(ri, gi): flat}``, each ``ops.tick._compact_outbox_impl`` of its
    block with its row counts, in :class:`~..ops.tick.CompactLayout`'s
    layout at the shard's size).  Every array is the host's own,
    executions in global (r, j, g) order and laggards in (r, g) order, as
    ``ops.tick.unpack_compact(..., own=True)`` reads them from the
    unsharded tick; ``taken_bits`` is a :class:`ColumnBlocks` of owned
    copies.  A shard's replicas and rows are local: the join adds each
    shard's first replica and first row.  ``decided`` counts each column
    once (every replica shard of a column holds the same ``[G]``
    fields)."""
    rs, gs = mesh.replica_shards, mesh.groups_shards
    rl, gl = R // rs, G // gs
    Lb = lag_budget
    cap = shard_exec_cap(rl, W, gl, exec_budget)
    L = tk.CompactLayout(rl, gl, cap, Lb)
    n_exec = sum(int(f[0]) for f in flats.values())
    decided = sum(int(flats[(0, gi)][1]) for gi in range(gs))
    lag_n = sum(int(f[2]) for f in flats.values())
    taken = ColumnBlocks([np.concatenate(
        [flats[(ri, gi)][L.o_taken:L.o_exec].reshape(rl, gl)
         for ri in range(rs)]) for gi in range(gs)])
    counts, starts = {}, {}
    for k, f in flats.items():
        c = f[L.o_counts:L.o_counts + rl * W].astype(np.int64)
        counts[k] = c.reshape(rl, W)
        starts[k] = (np.cumsum(c) - c).reshape(rl, W)
    # each shard holds its part of every (r, j) row; the rows run in
    # (r, j) order and within a row the shards in group order
    pieces = []
    for r in range(R):
        ri, rr = divmod(r, rl)
        for j in range(W):
            for gi in range(gs):
                n = int(counts[(ri, gi)][rr, j])
                if n:
                    pieces.append(((ri, gi), int(starts[(ri, gi)][rr, j]),
                                   n))
    lens = [n for _, _, n in pieces]

    def col(c, per_shard=None):
        if not pieces:
            return np.zeros(0, np.int32)
        o = L.o_exec + c * cap
        got = np.concatenate([flats[k][o + s:o + s + n]
                              for k, s, n in pieces])
        if per_shard is not None:
            got += np.repeat(np.array([per_shard(k) for k, _, _ in pieces],
                                      np.int32), lens)
        return got

    e_rid, e_slot = col(0), col(2)
    e_meta = col(1, lambda k: k[0] * rl)  # the replica is its low byte
    e_row = col(3, lambda k: k[1] * gl)
    lag = [[] for _ in range(tk.CompactLayout.LAG_COLS)]
    for r in range(R):
        ri, rr = divmod(r, rl)
        for gi in range(gs):
            f = flats[(ri, gi)]
            ln = min(int(f[2]), Lb)
            a, b = np.searchsorted(f[L.o_lag:L.o_lag + ln], [rr, rr + 1])
            for c, acc in enumerate(lag):
                part = f[L.o_lag + c * Lb + a:L.o_lag + c * Lb + b]
                # the first two columns are the laggard's replica and row
                acc.append(part + (ri * rl, gi * gl)[c] if c < 2 else part)
    keep = min(lag_n, Lb)
    l_cols = [np.concatenate(acc)[:keep] for acc in lag]
    return CompactHostOutbox(
        n_exec, decided, lag_n, taken, e_rid, e_meta & 0xFF, e_row, e_slot,
        (e_meta >> 8).astype(bool), *l_cols)


def join_full(flats: Dict[tuple, np.ndarray], mesh: Mesh, R: int, P: int,
              W: int, G: int) -> HostOutbox:
    """The single-device full outbox from the shards' packed host buffers
    (``ops.tick.pack_outbox_impl`` of each block); every array a copy."""
    rs, gs = mesh.replica_shards, mesh.groups_shards
    rl, gl = R // rs, G // gs
    parts = {k: tk.unpack_outbox(f, rl, P, W, gl) for k, f in flats.items()}
    fields = []
    for i, name in enumerate(HostOutbox._fields):
        rows = range(rs) if _OUTBOX_SPECS[name] != "g" else range(1)
        cols = [np.concatenate([parts[(ri, gi)][i] for ri in rows], axis=0)
                for gi in range(gs)]
        fields.append(np.concatenate(cols, axis=-1))
    return HostOutbox(*fields)

