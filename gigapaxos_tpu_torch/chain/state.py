"""Dense device-resident chain-replication state.

The second per-group coordination protocol over the same group-table
layout as ``paxos/state.py``: per-chain (members, head, tail, slot) become
dense tensors with one column per chain, ``[R, G]`` / ``[R, W, G]`` with G
the minor axis.

Chain order is the ascending replica-slot order of the member mask: head =
lowest member slot, tail = highest.  Each replica's received-log window is
a ring ``[R, W, G]`` that fills one hop per tick from its predecessor (the
forward propagation of the head's ordering); the commit point is
application at the tail (reads are served at the tail).

As in ``paxos/state.py``, :func:`create_groups` and :func:`free_groups`
write the given state's tensors in place and return it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..types import GroupStatus, NO_REQUEST

I32 = torch.int32
BOOL = torch.bool


class ChainState(NamedTuple):
    # ---- per replica [R, G] ----
    applied: torch.Tensor  # next slot to apply at replica r (exec watermark)
    status: torch.Tensor  # GroupStatus per replica

    # ---- received-log ring [R, W, G] ----
    c_req: torch.Tensor
    c_slot: torch.Tensor  # absolute slot held by the plane (-1 = empty)
    c_stop: torch.Tensor

    # ---- per chain [G] ----
    next_slot: torch.Tensor  # head's assignment counter

    # ---- group config ----
    member: torch.Tensor  # bool [R, G]
    n_members: torch.Tensor  # int32 [G]
    epoch: torch.Tensor  # int32 [G]

    @property
    def n_replica_slots(self) -> int:
        return self.applied.shape[0]

    @property
    def n_groups(self) -> int:
        return self.applied.shape[1]

    @property
    def window(self) -> int:
        return self.c_req.shape[1]


def init_state(n_replicas: int, n_groups: int, window: int,
               device=None) -> ChainState:
    """All rows FREE.  ``device`` defaults to CUDA (see
    ``device.resolve_device``)."""
    dev = resolve_device(device)
    R, G, W = n_replicas, n_groups, window

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return ChainState(
        applied=full((R, G), 0),
        status=full((R, G), int(GroupStatus.FREE)),
        c_req=full((R, W, G), NO_REQUEST),
        c_slot=full((R, W, G), -1),
        c_stop=full((R, W, G), False, BOOL),
        next_slot=full((G,), 0),
        member=full((R, G), False, BOOL),
        n_members=full((G,), 0),
        epoch=full((G,), 0),
    )


def _rows(rows, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=dev)


def create_groups(state: ChainState, rows, members,
                  epochs=None) -> ChainState:
    """Open chain rows, in place.  rows: int [K]; members: bool [K, R];
    epochs: optional int [K]."""
    dev = state.applied.device
    r = _rows(rows, dev)
    mem = torch.as_tensor(np.asarray(members, bool), device=dev)
    state.applied[:, r] = 0
    state.status[:, r] = int(GroupStatus.ACTIVE)
    state.c_req[:, :, r] = NO_REQUEST
    state.c_slot[:, :, r] = -1
    state.c_stop[:, :, r] = False
    state.next_slot[r] = 0
    state.member[:, r] = mem.T
    state.n_members[r] = mem.sum(dim=1, dtype=I32)
    state.epoch[r] = (0 if epochs is None else torch.as_tensor(
        np.asarray(epochs, np.int32), device=dev))
    return state


def free_groups(state: ChainState, rows) -> ChainState:
    """Close chain rows, in place."""
    r = _rows(rows, state.applied.device)
    state.status[:, r] = int(GroupStatus.FREE)
    state.member[:, r] = False
    state.n_members[r] = 0
    return state


def state_from_numpy(state_np, device=None) -> ChainState:
    """A :class:`ChainState` on ``device`` from any 9-field state of
    array-likes in field order."""
    dev = resolve_device(device)
    return ChainState(*(torch.as_tensor(np.array(a), device=dev)
                        for a in state_np))


def state_to_numpy(state: ChainState) -> ChainState:
    """The same state as numpy arrays (host copies), field order kept."""
    return ChainState(*(t.to("cpu", copy=True).numpy() for t in state))
