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
``[G]`` fields; ``alive`` is replicated.

A :class:`ResidentState` keeps a state as those blocks, each on its
shard's device, for its whole life: the sharded tick
(``parallel/shard_tick.py``) reads and replaces the blocks where they
lie.  :func:`shard_state` / :func:`shard_inbox` cut a global-view state
or inbox into blocks, :func:`gather_state` / :func:`gather_outbox` put
them back; they serve the rare paths (a snapshot's restore, a journal
record's inbox in recovery, ``PaxosManager.gather_state``, a twin's
comparison) and the global-view form of the tick, never the live
resident tick.
"""

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.tick import TickInbox, TickOutbox
from ..obs.phase import mesh_transfer_counter
from ..paxos.state import PaxosState, init_state, to_host

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ResidentState:
    """A :class:`PaxosState` held as its shards' blocks, each on its
    shard's device (``blocks``: ``{(ri, gi): PaxosState}``).  Rows of the
    group axis are global: shard column ``gi`` owns rows
    ``[gi*G/gs, (gi+1)*G/gs)``.  Whole-state gathers and scatters count
    the bytes of every block but the first shard's (the home of the
    global view) into ``mesh_transfer_bytes_total{kind="state"}``."""

    def __init__(self, mesh: Mesh, blocks: Dict[tuple, PaxosState]):
        self.mesh = mesh
        self.blocks = blocks

    @classmethod
    def fresh(cls, mesh: Mesh, R: int, G: int, W: int) -> "ResidentState":
        """Every row FREE, each block made on its own device (a fresh
        state is the same in every column, so no cut is needed)."""
        rl, gl = R // mesh.replica_shards, G // mesh.groups_shards
        return cls(mesh, {k: init_state(rl, gl, W, mesh.device_at(*k))
                          for k in mesh.shards()})

    @property
    def rows_per_shard(self) -> int:
        return self.blocks[(0, 0)].exec_slot.shape[1]

    def _count(self) -> None:
        """The bytes a whole-state gather or scatter moves."""
        n = sum(_nbytes(t) for k, b in self.blocks.items()
                if k != (0, 0) for t in b)
        mesh_transfer_counter("state").inc(n)

    def gather(self, device) -> PaxosState:
        """The global view, on ``device`` (a copy)."""
        self._count()
        return gather_state(self.blocks, self.mesh, device)

    def assign(self, state: PaxosState) -> None:
        """Replace every block by its cut of the global view ``state``."""
        self.blocks = shard_state(state, self.mesh)
        self._count()

    def field_host(self, name: str) -> np.ndarray:
        """One field's global view as a host array."""
        rs, gs = self.mesh.replica_shards, self.mesh.groups_shards
        spec = _STATE_SPECS[name]
        rows = range(rs) if spec != "g" else range(1)
        cols = [np.concatenate([to_host(getattr(self.blocks[(ri, gi)], name))
                                for ri in rows], axis=0)
                for gi in range(gs)]
        return np.concatenate(cols, axis=-1)

    def owner(self, row: int) -> tuple:
        """``(gi, local row)`` of a global row."""
        return divmod(int(row), self.rows_per_shard)

    def split_rows(self, rows) -> List[tuple]:
        """``(gi, positions in rows, local rows)`` for each shard column
        owning some of ``rows``."""
        rows = np.asarray(rows, np.int64)
        gi = rows // self.rows_per_shard
        out = []
        for g in np.unique(gi).tolist():
            sel = np.nonzero(gi == g)[0]
            out.append((g, sel, rows[sel] - g * self.rows_per_shard))
        return out

    @contextlib.contextmanager
    def column(self, gi: int, write: bool = True):
        """Shard column ``gi`` as one full-R state: with one replica shard
        the resident block itself (written in place); with several, a
        copy on the column's first device, whose fields are written back
        to the replica blocks on exit when ``write``."""
        rs = self.mesh.replica_shards
        if rs == 1:
            yield self.blocks[(0, gi)]
            return
        dev = self.mesh.device_at(0, gi)
        parts = [self.blocks[(ri, gi)] for ri in range(rs)]
        moved = sum(_nbytes(t) for b in parts[1:] for t in b)
        col = PaxosState(*(
            torch.cat([getattr(b, f).to(dev) for b in parts], dim=0)
            if _STATE_SPECS[f] != "g" else getattr(parts[0], f)
            for f in PaxosState._fields))
        mesh_transfer_counter("state").inc(moved)
        yield col
        if not write:
            return
        rl = col.exec_slot.shape[0] // rs
        for ri, b in enumerate(parts):
            for f in PaxosState._fields:
                src = getattr(col, f)
                if _STATE_SPECS[f] != "g":
                    src = src[ri * rl:(ri + 1) * rl]
                dst = getattr(b, f)
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        mesh_transfer_counter("state").inc(moved)
