"""The sharded tick: the per-shard-local formulation of the fused tick.

The reference wraps its UNCHANGED tick body in ``shard_map`` over the
(replica, groups) mesh; this module runs the same body once per shard of a
:class:`~.mesh.Mesh`, in one process, in lockstep:

* Each shard sees a concrete local ``[R_local(, W), G_local]`` block on its
  own device, so the hand kernels run per shard on the local block
  (``ops/window.py`` dispatches by the block's device): 5 gathers and 1
  match a shard a tick.
* The body (:func:`shard_tick_body`) is written against a small
  collectives object, :class:`Collectives` (``all_gather(xs, axis)``,
  ``axis_index(axis)``).  It is a generator: at each collective it yields
  the request, and :func:`run_lockstep` drives every shard's body to that
  point, performs the exchange and sends each shard its result.
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
  is pure data-parallel with zero collectives in the hot phases.

Outbox pack / compaction stays global-view after the shards: the compact
prefix-scatter ranks executions over ALL groups, so the flat buffer
(``CompactLayout``) and the whole host loop are byte-compatible with the
single-device path.  The state lives global-view between ticks (on the
device the caller keeps it on); each tick cuts it into the shards' blocks
and joins the blocks back.
"""

from typing import Callable, Dict, List, Optional

import torch

from ..ops import tick as tk
from ..ops.tick import TickInbox, TickOutbox
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


def run_lockstep(mesh: Mesh, bodies: Dict[tuple, "object"]) -> Dict:
    """Drive each shard's body generator (``{(ri, gi): generator}``) in
    lockstep to its return value; every body makes the same collectives in
    the same order."""
    results: Dict[tuple, object] = {}
    pending: Dict[tuple, _Gather] = {}

    def step(k, value):
        try:
            pending[k] = bodies[k].send(value)
        except StopIteration as done:
            pending.pop(k, None)
            results[k] = done.value

    for k in bodies:
        step(k, None)
    while pending:
        if len(pending) != len(bodies):
            raise RuntimeError("shard bodies diverged: some returned while "
                               "others wait at a collective")
        axis = next(iter(pending.values())).axis
        answers = {}
        for k, req in pending.items():
            ri, gi = k
            if axis == REPLICA_AXIS:
                peers = [(r, gi) for r in range(mesh.replica_shards)]
            else:
                peers = [(ri, g) for g in range(mesh.groups_shards)]
            dev = mesh.device_at(ri, gi)
            out = []
            for i in range(len(req.xs)):
                parts = [pending[p].xs[i].to(dev) for p in peers]
                out.append(torch.cat(parts, dim=0) if req.tiled
                           else torch.stack(parts))
            answers[k] = out
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


def shard_tick_body(mesh: Mesh, own_row: int = -1, exec_budget: int = 0):
    """The per-shard tick: ``body(coll, state, inbox)`` is a generator that
    yields at each collective (see :func:`run_lockstep`) and returns the
    shard's ``(state, TickOutbox)`` blocks."""
    rs = mesh.shape[REPLICA_AXIS]
    gs = mesh.shape[GROUPS_AXIS]

    def body(coll: Collectives, state: PaxosState, inbox: TickInbox):
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
        if rs > 1:
            ri = coll.axis_index(REPLICA_AXIS)
            rloc = new.exec_slot.shape[0] // rs

            def sl(x):
                return x[ri * rloc:(ri + 1) * rloc]

            new = new._replace(**{f: sl(getattr(new, f))
                                  for f in _REPLICA_LED})
            out = out._replace(**{f: sl(getattr(out, f))
                                  for f in _OUTBOX_REPLICA_LED})
        return new, out

    return body


def make_shardmap_tick(mesh: Mesh, own_row: int = -1, exec_budget: int = 0):
    """The sharded tick over global-view operands: ``fn(state, inbox) ->
    (state, TickOutbox)``, both on the state's device."""
    body = shard_tick_body(mesh, own_row, exec_budget)

    def fn(state: PaxosState, inbox: TickInbox):
        dev = state.exec_slot.device
        sb, ib = shard_state(state, mesh), shard_inbox(inbox, mesh)
        res = run_lockstep(mesh, {
            k: body(Collectives(mesh, *k), sb[k], ib[k])
            for k in mesh.shards()})
        return (gather_state({k: v[0] for k, v in res.items()}, mesh, dev),
                gather_outbox({k: v[1] for k, v in res.items()}, mesh, dev))

    return fn


def fetch_host_outbox(out: TickOutbox) -> "tk.HostOutbox":
    """The full outbox on the host from the global-view fields, one field
    at a time."""
    return tk.HostOutbox(*(tk._host(f) for f in out))


def make_shardmap_tick_compact(mesh: Mesh, own_row: int, exec_budget: int,
                               lag_budget: int,
                               demand_decay: Optional[float] = None
                               ) -> Callable:
    """Sharded tick + budgeted compaction of the global outbox
    (O(budget) transfer, the flat layout of the single-device path).

    ``demand_decay`` (placement plane): per-group ``decided_now`` [G] never
    reaches the host in compact mode, so the demand EWMA fold
    ``d' = decay*d + decided_now`` runs on the device, after the shards:
    ``fn(state, inbox, demand) -> (state, flat, new_demand)``; without a
    decay ``fn(state, inbox) -> (state, flat)``."""
    tick = make_shardmap_tick(mesh, own_row, exec_budget)
    if demand_decay is None:
        def fn(state, inbox):
            state, out = tick(state, inbox)
            return state, tk.run_compact(out, exec_budget, lag_budget)

        return fn

    decay = float(demand_decay)

    def fn3(state, inbox, demand):
        state, out = tick(state, inbox)
        new_demand = tk.demand_fold(demand, out.decided_now, decay)
        return state, tk.run_compact(out, exec_budget, lag_budget), new_demand

    return fn3


def init_demand(mesh: Mesh, n_groups: int, device=None) -> torch.Tensor:
    """Zeroed [G] float32 demand array (global view, on ``device`` or the
    mesh's first device)."""
    dev = mesh.devices[0] if device is None else device
    return torch.zeros(n_groups, dtype=torch.float32, device=dev)
