"""Device mesh + shard layout for the consensus data plane.

The reference's two scaling axes (SURVEY §2.2) map to two mesh axes:

* ``groups``  — millions of independent RSMs, embarrassingly parallel: pure
  data parallelism, no cross-shard communication;
* ``replica`` — the 3-5-way replication dimension whose quorum traffic
  (ACCEPT fan-out / ACCEPT_REPLY fan-in) becomes an exchange between the
  replica shards of one group column.

A :class:`Mesh` is a ``[replica_shards, groups_shards]`` grid of torch
devices, repeats allowed (eight shards on one card, or ``n`` x ``cpu``
standing in for ``n`` devices).  Shard ``(ri, gi)`` holds the
``[R/rs, (W,) G/gs]`` block of every replica-led field (rows
``ri*R/rs ...``, columns ``gi*G/gs ...``) and the ``[G/gs]`` block of the
``[G]`` fields; ``alive`` is replicated.  :func:`shard_state` /
:func:`shard_inbox` cut a global-view state into those blocks on their
devices, :func:`gather_state` / :func:`gather_outbox` put them back.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.tick import TickInbox, TickOutbox
from ..paxos.state import PaxosState

REPLICA_AXIS = "replica"
GROUPS_AXIS = "groups"

#: how each field is laid out: "rg" [R, G] and "rwg" [R, W, G] split by
#: replica rows and group columns, "g" [G] by group columns, "rep"
#: replicated
_STATE_SPECS = dict(
    exec_slot="rg", bal_num="rg", bal_coord="rg", status="rg",
    acc_bnum="rwg", acc_bcoord="rwg", acc_req="rwg", acc_slot="rwg",
    acc_stop="rwg",
    dec_req="rwg", dec_slot="rwg", dec_valid="rwg", dec_stop="rwg",
    coord_active="rg", coord_preparing="rg", coord_fast="rg",
    coord_bnum="rg", next_slot="rg",
    prop_req="rwg", prop_slot="rwg", prop_valid="rwg", prop_stop="rwg",
    member="rg", n_members="g", epoch="g",
)

_INBOX_SPECS = dict(req="rwg", stop="rwg", alive="rep")

#: [G] outbox fields are computed from replica-gathered operands, so every
#: replica shard of a column holds the same values
_OUTBOX_SPECS = dict(
    exec_req="rwg", exec_stop="rwg", exec_base="rg", exec_count="rg",
    intake_taken="rwg", coord_id="g", decided_now="g", lag="rg",
    donor="rg", donor_exec="rg", donor_status="rg",
)


class Mesh:
    """A ``[replica_shards, groups_shards]`` grid of torch devices."""

    def __init__(self, devices: Sequence, replica_shards: int,
                 groups_shards: int):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {REPLICA_AXIS: int(replica_shards),
                      GROUPS_AXIS: int(groups_shards)}

    @property
    def replica_shards(self) -> int:
        return self.shape[REPLICA_AXIS]

    @property
    def groups_shards(self) -> int:
        return self.shape[GROUPS_AXIS]

    def device_at(self, ri: int, gi: int) -> torch.device:
        return self.devices[ri * self.groups_shards + gi]

    def shards(self) -> List[Tuple[int, int]]:
        """Every ``(ri, gi)``, replica-major."""
        return [(ri, gi) for ri in range(self.replica_shards)
                for gi in range(self.groups_shards)]


def make_mesh(devices: Optional[Sequence] = None, replica_shards: int = 1,
              groups_shards: Optional[int] = None) -> Mesh:
    """Build a (replica, groups) mesh over the given (or all visible CUDA)
    devices; repeats are allowed.

    ``replica_shards`` must divide both the device count and the replica-slot
    dimension R of the state it will run.  The remaining devices form the
    groups axis (pure data parallel).
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if n % replica_shards:
        raise ValueError(f"{replica_shards} replica shards over {n} devices")
    if groups_shards is None:
        groups_shards = n // replica_shards
    if replica_shards * groups_shards != n:
        raise ValueError("replica_shards * groups_shards != device count")
    return Mesh(devices, replica_shards, groups_shards)


def _block(x: torch.Tensor, spec: str, mesh: Mesh, ri: int, gi: int,
           dev: torch.device) -> torch.Tensor:
    """Shard ``(ri, gi)``'s contiguous block of a global-view field."""
    if spec != "rep":
        gl = x.shape[-1] // mesh.groups_shards
        x = x[..., gi * gl:(gi + 1) * gl]
        if spec != "g":
            rl = x.shape[0] // mesh.replica_shards
            x = x[ri * rl:(ri + 1) * rl]
    return x.contiguous().to(dev)


def _split(tup, specs: Dict[str, str], mesh: Mesh) -> Dict[tuple, tuple]:
    return {(ri, gi): type(tup)(*(
        _block(x, specs[f], mesh, ri, gi, mesh.device_at(ri, gi))
        for f, x in zip(type(tup)._fields, tup)))
        for ri, gi in mesh.shards()}


def shard_state(state: PaxosState, mesh: Mesh) -> Dict[tuple, PaxosState]:
    """``{(ri, gi): block}``: each shard's block of a global-view state,
    on its device."""
    return _split(state, _STATE_SPECS, mesh)


def shard_inbox(inbox: TickInbox, mesh: Mesh) -> Dict[tuple, TickInbox]:
    return _split(inbox, _INBOX_SPECS, mesh)


def _join(blocks: Dict[tuple, tuple], specs: Dict[str, str], mesh: Mesh,
          device) -> tuple:
    """Inverse of :func:`_split`: the global view on ``device``."""
    rs, gs = mesh.replica_shards, mesh.groups_shards
    cls = type(blocks[(0, 0)])
    fields = []
    for i, f in enumerate(cls._fields):
        spec = specs[f]
        if spec == "rep":
            fields.append(blocks[(0, 0)][i].to(device))
            continue
        rows = range(rs) if spec != "g" else range(1)
        cols = [torch.cat([blocks[(ri, gi)][i].to(device) for ri in rows],
                          dim=0) if len(rows) > 1
                else blocks[(0, gi)][i].to(device) for gi in range(gs)]
        fields.append(torch.cat(cols, dim=-1) if gs > 1 else cols[0])
    return cls(*fields)


def gather_state(blocks: Dict[tuple, PaxosState], mesh: Mesh,
                 device) -> PaxosState:
    """The global view of a sharded state, on ``device``."""
    return _join(blocks, _STATE_SPECS, mesh, device)


def gather_outbox(blocks: Dict[tuple, TickOutbox], mesh: Mesh,
                  device) -> TickOutbox:
    """The global view of the shards' outboxes, on ``device``."""
    return _join(blocks, _OUTBOX_SPECS, mesh, device)
