"""Dense device-resident Paxos state.

One column per replica group, one leading axis per replica slot:

* acceptor scalars (next slot to execute, promised ballot, status) ->
  ``int32`` tensors ``[R, G]``;
* the accepted-pvalue and decision maps -> ring windows ``[R, W, G]``
  addressed by ``slot & (W-1)`` on the W axis;
* coordinator state -> ``[R, G]`` scalars plus a proposal ring
  ``[R, W, G]``; the majority tally is recomputed each tick as a count over
  the replica axis;
* group membership -> a bool mask ``[R, G]`` plus member count ``[G]``.

The group axis G is the minor (contiguous) dimension, so neighbouring
CUDA threads work on neighbouring groups and every load is coalesced.

Request payloads never enter the device: requests are ``int32`` ids handed
out by the host (see ``paxos/manager.py``).  ``NO_REQUEST`` (0) marks empty
slots and no-op decisions.

The admin functions below (:func:`create_groups`, :func:`free_groups`,
:func:`hot_restore`) write the given state's tensors IN PLACE and return
it: at 2^20 groups a functional copy of the whole state per admin call
would cost about a gigabyte of traffic.  Callers that still need the old
values copy them first (:func:`clone_state`).  The tick itself
(``ops/tick.py``) never writes its input state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..types import (
    GroupStatus,
    INITIAL_BALLOT_COORD,
    INITIAL_BALLOT_NUM,
    NO_REQUEST,
)

I32 = torch.int32
BOOL = torch.bool


class PaxosState(NamedTuple):
    # ---- acceptor, per replica [R, G] ----
    exec_slot: torch.Tensor  # next slot to execute
    bal_num: torch.Tensor  # promised ballot number
    bal_coord: torch.Tensor  # promised ballot coordinator
    status: torch.Tensor  # GroupStatus per replica

    # ---- accepted-pvalue ring [R, W, G] ----
    acc_bnum: torch.Tensor
    acc_bcoord: torch.Tensor
    acc_req: torch.Tensor
    acc_slot: torch.Tensor  # absolute slot the entry holds (validity check)
    acc_stop: torch.Tensor  # bool: pvalue is a stop request

    # ---- decision ring [R, W, G] (last W learned decisions) ----
    dec_req: torch.Tensor
    dec_slot: torch.Tensor
    dec_valid: torch.Tensor
    dec_stop: torch.Tensor

    # ---- coordinator, per replica [R, G] ----
    coord_active: torch.Tensor  # bool: majority promised my ballot
    coord_preparing: torch.Tensor  # bool: prepare issued, awaiting promises
    coord_fast: torch.Tensor  # bool: active via fast re-election (Mode B)
    coord_bnum: torch.Tensor  # my ballot number (coordinator id == replica idx)
    next_slot: torch.Tensor  # next slot I will assign

    # ---- coordinator proposal ring [R, W, G] ----
    prop_req: torch.Tensor
    prop_slot: torch.Tensor
    prop_valid: torch.Tensor
    prop_stop: torch.Tensor

    # ---- group config [R, G] / [G] ----
    member: torch.Tensor  # bool [R, G]: replica slot r is a member of group g
    n_members: torch.Tensor  # int32 [G]
    epoch: torch.Tensor  # int32 [G]

    @property
    def n_replica_slots(self) -> int:
        return self.exec_slot.shape[0]

    @property
    def n_groups(self) -> int:
        return self.exec_slot.shape[1]

    @property
    def window(self) -> int:
        return self.acc_req.shape[1]

    @property
    def device(self) -> torch.device:
        return self.exec_slot.device


#: fields with a ring axis [R, W, G], and the value a fresh ring entry holds
_RING_FILL = {
    "acc_bnum": INITIAL_BALLOT_NUM, "acc_bcoord": INITIAL_BALLOT_COORD,
    "acc_req": NO_REQUEST, "acc_slot": -1, "acc_stop": False,
    "dec_req": NO_REQUEST, "dec_slot": -1, "dec_valid": False,
    "dec_stop": False,
    "prop_req": NO_REQUEST, "prop_slot": -1, "prop_valid": False,
    "prop_stop": False,
}


def init_state(n_replicas: int, n_groups: int, window: int,
               device=None) -> PaxosState:
    """All rows FREE; groups are opened by :func:`create_groups`.
    ``device`` defaults to CUDA (see ``device.resolve_device``)."""
    dev = resolve_device(device)
    R, G, W = n_replicas, n_groups, window

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    fields = {}
    for name in PaxosState._fields:
        if name in _RING_FILL:
            fill = _RING_FILL[name]
            fields[name] = full((R, W, G), fill,
                                BOOL if isinstance(fill, bool) else I32)
    fields.update(
        exec_slot=full((R, G), 0, I32),
        bal_num=full((R, G), INITIAL_BALLOT_NUM, I32),
        bal_coord=full((R, G), INITIAL_BALLOT_COORD, I32),
        status=full((R, G), int(GroupStatus.FREE), I32),
        coord_active=full((R, G), False, BOOL),
        coord_preparing=full((R, G), False, BOOL),
        coord_fast=full((R, G), False, BOOL),
        coord_bnum=full((R, G), INITIAL_BALLOT_NUM, I32),
        next_slot=full((R, G), 0, I32),
        member=full((R, G), False, BOOL),
        n_members=full((G,), 0, I32),
        epoch=full((G,), 0, I32),
    )
    return PaxosState(**fields)


def concat_replica_slots(state, fresh):
    """Append ``fresh``'s virgin replica rows to ``state`` (both the same
    NamedTuple type): every field whose leading dim is the replica axis is
    concatenated; per-group config state ([G]) is shared, not copied.  The
    leading-dim test is by ndim (>= 2) — a protocol state with a 2-D
    [G, *] field would need this extended.  Shared by the paxos and chain
    expanders (runtime node addition)."""
    R = state[0].shape[0]
    merged = {}
    for f in state._fields:
        a, b = getattr(state, f), getattr(fresh, f)
        if a.dim() >= 2 and a.shape[0] == R:
            merged[f] = torch.cat([a, b], dim=0)
        else:
            # only 1-D per-group config may skip the concatenation: a 2-D
            # [G, *] field whose leading dim happened to equal R would be
            # concatenated on the wrong axis without a word
            assert a.dim() == 1, (
                f"{f}: shape {tuple(a.shape)} is neither replica-led nor "
                "1-D per-group config — extend concat_replica_slots")
            merged[f] = a
    return type(state)(**merged)


def expand_replica_slots(state: PaxosState, n_new: int) -> PaxosState:
    """Grow the replica axis by ``n_new`` virgin slots (runtime node
    addition).  Existing slots keep their indices (new nodes append), new
    rows hold :func:`init_state`'s values, and no group membership changes:
    groups adopt the new slots through ordinary epoch reconfiguration."""
    if n_new <= 0:
        return state
    return concat_replica_slots(
        state, init_state(n_new, state.n_groups, state.window,
                          device=state.device))


def clone_state(state: PaxosState) -> PaxosState:
    return PaxosState(*(t.clone() for t in state))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy COPY of ``t`` (never a view of a CPU tensor that an
    in-place admin op could later change)."""
    return t.to("cpu", copy=True).numpy()


def _rows(rows, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=dev)


def _reset_rings(state: PaxosState, rows: torch.Tensor) -> None:
    for name, fill in _RING_FILL.items():
        getattr(state, name)[:, :, rows] = fill


def create_groups(state: PaxosState, rows, members,
                  epochs=None) -> PaxosState:
    """Open group rows, in place (batched ``createPaxosInstance``).

    rows: int [K] row indices; members: bool [K, R] member masks; epochs:
    optional int [K].  Fresh groups start at slot 0, initial ballot, ACTIVE
    status on every replica slot (non-members simply never contribute)."""
    dev = state.device
    r = _rows(rows, dev)
    mem = torch.as_tensor(np.asarray(members, bool), device=dev)
    ep = (torch.zeros(r.shape[0], dtype=I32, device=dev) if epochs is None
          else torch.as_tensor(np.asarray(epochs, np.int32), device=dev))
    state.exec_slot[:, r] = 0
    state.bal_num[:, r] = INITIAL_BALLOT_NUM
    state.bal_coord[:, r] = INITIAL_BALLOT_COORD
    state.status[:, r] = int(GroupStatus.ACTIVE)
    _reset_rings(state, r)
    state.coord_active[:, r] = False
    state.coord_preparing[:, r] = False
    state.coord_fast[:, r] = False
    state.coord_bnum[:, r] = INITIAL_BALLOT_NUM
    state.next_slot[:, r] = 0
    state.member[:, r] = mem.T
    state.n_members[r] = mem.sum(dim=1, dtype=I32)
    state.epoch[r] = ep
    return state


def free_groups(state: PaxosState, rows) -> PaxosState:
    """Close group rows, in place (kill/cremation analog)."""
    r = _rows(rows, state.device)
    state.status[:, r] = int(GroupStatus.FREE)
    state.member[:, r] = False
    state.n_members[r] = 0
    return state


# --------------------------------------------------------------- pause/spill
#
# A paused group's resident state is ~9 scalars (HotRestoreInfo): pause
# spills those scalar columns to host RAM and frees the device row.  Ring
# contents are not spilled: a group is only pausable when every member is
# caught up (exec == next slot), at which point the windows hold nothing
# undelivered.

_HRI_COLS = ("exec_slot", "bal_num", "bal_coord", "status", "coord_active",
             "coord_fast", "coord_bnum", "next_slot", "member")


def extract_hri(state: PaxosState, row: int) -> dict:
    """Host-side HotRestoreInfo of one caught-up group row."""
    r = int(row)
    hri = {name: to_host(getattr(state, name)[:, r]) for name in _HRI_COLS}
    hri["epoch"] = int(state.epoch[r])
    return hri


def hot_restore(state: PaxosState, row: int, hri: dict) -> PaxosState:
    """Re-materialize a spilled group into a device row, in place
    (``hotRestore``).  Writes the scalar columns; windows start empty,
    which is correct because pause required the group to be quiescent."""
    r = int(row)
    dev = state.device

    def col(name, dtype, value):
        getattr(state, name)[:, r] = torch.as_tensor(
            np.asarray(value), dtype=dtype, device=dev)

    col("exec_slot", I32, hri["exec_slot"])
    col("bal_num", I32, hri["bal_num"])
    col("bal_coord", I32, hri["bal_coord"])
    col("status", I32, hri["status"])
    _reset_rings(state, torch.tensor([r], device=dev))
    col("coord_active", BOOL, hri["coord_active"])
    state.coord_preparing[:, r] = False
    col("coord_fast", BOOL,
        hri.get("coord_fast", np.zeros_like(hri["coord_active"])))
    col("coord_bnum", I32, hri["coord_bnum"])
    col("next_slot", I32, hri["next_slot"])
    col("member", BOOL, hri["member"])
    state.n_members[r] = int(np.sum(hri["member"]))
    state.epoch[r] = int(hri["epoch"])
    return state


# ------------------------------------------------------ carry-across helpers

def state_from_numpy(state_np, device=None) -> PaxosState:
    """A :class:`PaxosState` on ``device`` from any 24-field state of
    array-likes in field order (numpy arrays, or another framework's state
    after ``np.asarray`` per field)."""
    dev = resolve_device(device)
    return PaxosState(*(torch.as_tensor(np.array(a), device=dev)
                        for a in state_np))


def state_to_numpy(state: PaxosState) -> PaxosState:
    """The same state as numpy arrays (host copies), field order kept."""
    return PaxosState(*(to_host(t) for t in state))
