"""Device-resident KV application: execution fused behind the consensus tick.

Host apps execute the decision stream in interpreted Python per request
(``paxos/manager.py``).  :class:`DeviceKVState` moves the app itself into
device tensors so the decision stream never leaves the device:

* app state — a direct-mapped KV cache per (replica, group):
  ``key[R, G, S]`` / ``val[R, G, S]`` int32 (0 = empty slot, so key 0 is
  reserved as that sentinel and clients use keys >= 1; key k lives at slot
  ``k & (S-1)``, last writer wins on a collision, the same on every replica);
* request descriptors — clients register ``rid -> (op, key, val)`` in a
  hashed device table ``[T]`` (op PUT=1/GET=2/DEL=3); the tick's executed
  rids gather their descriptors and a vectorized apply updates the KV
  tensors for every group at once;
* misses (descriptor evicted or never uploaded) surface in a ``miss`` mask
  so the host repairs them through its scalar path.

:func:`fused_compact` runs the descriptor upload, the tick, the KV apply and
the outbox compaction as one call on the manager's device: "execute" is one
more pass over ``[R, W, G]``, not a host round trip per decision.

Every function here returns fresh tensors and leaves its inputs as they
were, like the tick; the row-granular admin writes of :class:`DeviceKVApp`
(and the manager's row scrubs) write the live tensors in place.
"""

from __future__ import annotations

import contextlib
import json
import struct
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.tick import (CompactLayout, TickInbox, _compact_outbox_impl,
                        _scatter_dest, _scatter_into, paxos_tick_impl)
from ..types import NO_REQUEST

OP_NONE = 0
OP_PUT = 1
OP_GET = 2
OP_DEL = 3

I32 = torch.int32

#: 0x9E3779B9 as an int32: the Fibonacci multiplier of the Mode B hash
_FIB = -1640531527


class DeviceKVState(NamedTuple):
    """Dense app state + request-descriptor table (all device tensors)."""

    key: torch.Tensor    # i32 [R, G, S]   stored key per slot (0 = empty)
    val: torch.Tensor    # i32 [R, G, S]
    t_rid: torch.Tensor  # i32 [T] descriptor table: registered rid (0 = none)
    t_op: torch.Tensor   # i32 [T]
    t_key: torch.Tensor  # i32 [T]
    t_val: torch.Tensor  # i32 [T]

    @property
    def slots(self) -> int:
        return self.key.shape[2]

    @property
    def table(self) -> int:
        return self.t_rid.shape[0]


def init_kv(n_replicas: int, n_groups: int, slots: int = 16,
            table: int = 1 << 16, device=None) -> DeviceKVState:
    """Empty store and table.  ``device`` defaults to CUDA (see
    ``device.resolve_device``)."""
    assert slots & (slots - 1) == 0 and table & (table - 1) == 0
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    R, G = n_replicas, n_groups
    return DeviceKVState(key=z(R, G, slots), val=z(R, G, slots),
                         t_rid=z(table), t_op=z(table), t_key=z(table),
                         t_val=z(table))


def kv_to_numpy(kv: DeviceKVState) -> DeviceKVState:
    """The same state as numpy arrays (host copies), field order kept."""
    return DeviceKVState(*(t.to("cpu", copy=True).numpy() for t in kv))


def _as_i32(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=I32)
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _table_idx(rids, table: int, mix: bool) -> torch.Tensor:
    """Descriptor-table index (int32) for a batch of int32 rids.

    ``mix=False`` (Mode A): the low bits — manager rids are one sequential
    stream, so any live window of <= table consecutive rids maps one to
    one.  ``mix=True`` (Mode B): rids are origin-tagged ``(origin << 24) |
    seq``, so a multiplicative (Fibonacci) hash spreads the origins: the
    int32 product wraps, is read as uint32 and shifted right by 8.  The
    product is taken in int64 and masked to its low 32 bits, which is that
    wrap and that cast on every torch build."""
    if not mix:
        return torch.bitwise_and(rids, table - 1)
    h = (rids.to(torch.int64) * _FIB) & 0xFFFFFFFF
    return ((h >> 8) & (table - 1)).to(I32)


def register_requests(kv: DeviceKVState, rids, ops, keys, vals,
                      mix: bool = False) -> DeviceKVState:
    """Upload request descriptors (one host batch).  Clients call this
    before proposing the rids; a collision evicts (the evicted request
    executes as a miss and falls back to the host's scalar path).

    rid 0 marks an empty upload slot (fixed-size batches pad with zeros):
    it writes nothing.  Rids of one batch that share a table index resolve
    once, last write wins, into one set of distinct indices that all four
    columns scatter through: CUDA leaves the winner of duplicate scatter
    indices undefined, and four separate scatters need not agree."""
    dev = kv.t_rid.device
    T = kv.table
    rids = _as_i32(rids, dev)
    cols = [rids, _as_i32(ops, dev), _as_i32(keys, dev), _as_i32(vals, dev)]
    idx = torch.where(rids == 0, T, _table_idx(rids, T, mix)).to(torch.int64)
    pos = torch.arange(rids.shape[0], dtype=torch.int64, device=dev)
    last = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, idx, pos, reduce="amax")
    # losers and padding go to the trash entry T, which is sliced away
    dst = torch.where((last[idx] == pos) & (idx < T), idx, T)
    out = []
    for t, c in zip((kv.t_rid, kv.t_op, kv.t_key, kv.t_val), cols):
        buf = torch.empty(T + 1, dtype=I32, device=dev)
        buf[:T] = t
        buf.scatter_(0, dst, c)
        out.append(buf[:T])
    return kv._replace(t_rid=out[0], t_op=out[1], t_key=out[2],
                       t_val=out[3])


def kv_apply(kv: DeviceKVState, exec_req, exec_count,
             mix: bool = False) -> Tuple[DeviceKVState, torch.Tensor,
                                         torch.Tensor]:
    """Vectorized execution of one tick's decision stream.

    exec_req: i32 [R, W, G] executed rids in window order (0 = none);
    exec_count: i32 [R, G].  Returns (kv', responses i32 [R, W, G] — PUT
    echoes the value, GET/DEL return the pre-op value, 0 = absent — and
    miss bool [R, W, G]).

    Window plane j executes slot base+j, so the planes apply in order: a
    loop over W threads the store through them (read-your-writes inside
    one tick's batch), each step vectorized over [R, G].  Every (r, g)
    writes one slot per plane, so no scatter has a duplicate index; where a
    plane writes nothing it writes the current value back."""
    R, W, G = exec_req.shape
    S = kv.slots
    dev = exec_req.device
    ji = torch.arange(W, dtype=I32, device=dev)
    valid = (exec_req != NO_REQUEST) & (ji[None, :, None]
                                        < exec_count[:, None, :])
    tix = _table_idx(exec_req, kv.table, mix).to(torch.int64)  # [R, W, G]
    hit = valid & (kv.t_rid[tix] == exec_req)
    op = torch.where(hit, kv.t_op[tix], OP_NONE)
    k = kv.t_key[tix]
    v = kv.t_val[tix]
    slot = torch.bitwise_and(k, S - 1).to(torch.int64)  # [R, W, G]

    key_s, val_s = kv.key.clone(), kv.val.clone()
    zero = torch.zeros((), dtype=I32, device=dev)
    resps = []
    for j in range(W):
        op_j, k_j, v_j = op[:, j], k[:, j], v[:, j]       # [R, G]
        sl = slot[:, j].unsqueeze(-1)                      # [R, G, 1]
        cur_key = key_s.gather(2, sl).squeeze(-1)
        cur_val = val_s.gather(2, sl).squeeze(-1)
        present = cur_key == k_j
        put, dele = op_j == OP_PUT, op_j == OP_DEL
        resps.append(torch.where(put, v_j, torch.where(present, cur_val,
                                                       zero)))
        # DEL writes only when the key is resident: deleting an absent key
        # must not erase a colliding occupant (the scalar path's semantics)
        wr = put | (dele & present)
        nk = torch.where(wr, torch.where(dele, zero, k_j), cur_key)
        nv = torch.where(wr, torch.where(dele, zero, v_j), cur_val)
        key_s.scatter_(2, sl, nk.unsqueeze(-1))
        val_s.scatter_(2, sl, nv.unsqueeze(-1))
    responses = torch.where(hit, torch.stack(resps, dim=1), zero)
    miss = valid & ~hit
    return kv._replace(key=key_s, val=val_s), responses, miss


def fused_step(state, kv: DeviceKVState, inbox: TickInbox, own_row: int = -1,
               fast_elect: bool = False):
    """One consensus tick + device app execution."""
    new_state, out = paxos_tick_impl(state, inbox, own_row,
                                     fast_elect=fast_elect)
    kv2, responses, miss = kv_apply(kv, out.exec_req, out.exec_count)
    return new_state, kv2, out, responses, miss


#: the reference's jitted name; the port runs eagerly
fused_step_jit = fused_step


def _fused_compact_impl(state, kv: DeviceKVState, inbox: TickInbox,
                        reg_rids, reg_ops, reg_keys, reg_vals,
                        own_row: int, exec_budget: int, lag_budget: int,
                        fast_elect: bool = False):
    """Descriptor upload + consensus tick + KV apply + outbox compaction:
    the deployment-path twin of :func:`fused_step`.

    The compact buffer grows two arrays past the consensus-only one:
    per-execution KV responses (e_resp) and miss flags (e_miss), scattered
    with the exec stream's ranks, so entry replicas answer clients without
    any O(R*W*G) transfer.  reg_*: this tick's new descriptors ([K] int32;
    rid 0 = empty slot)."""
    kv = register_requests(kv, reg_rids, reg_ops, reg_keys, reg_vals)
    new_state, out = paxos_tick_impl(state, inbox, own_row, exec_budget,
                                     fast_elect=fast_elect)
    kv2, responses, miss = kv_apply(kv, out.exec_req, out.exec_count)
    packed = _compact_outbox_impl(out, exec_budget, lag_budget)
    R, W, G = out.exec_req.shape
    ji = torch.arange(W, dtype=I32, device=packed.device)[None, :, None]
    dst = _scatter_dest((ji < out.exec_count[:, None, :]).reshape(-1),
                        exec_budget)
    e_resp = _scatter_into(dst, responses.reshape(-1), exec_budget)
    e_miss = _scatter_into(dst, miss.to(I32).reshape(-1), exec_budget)
    flat = torch.cat([packed, e_resp, e_miss])
    L = CompactLayout(R, G, exec_budget, lag_budget)
    assert flat.shape[0] == L.total_device, (flat.shape, L.total_device)
    assert packed.shape[0] == L.o_resp
    return new_state, kv2, flat


#: the reference's jitted name; the port runs eagerly
fused_compact = _fused_compact_impl


#: descriptor wire format for device-app request payloads: op, key, value
DESC = "<iii"
DESC_LEN = 12


def pack_desc(op: int, key: int, val: int) -> bytes:
    return struct.pack(DESC, op, key, val)


class DeviceKVApp:
    """Replicable face of the manager-owned device KV state.

    ``owner.kv`` is the live :class:`DeviceKVState` the fused tick evolves
    (``PaxosManager.kv`` in device-app mode); this wrapper gives the control
    plane (checkpoint transfer, epoch final state, recovery seeding)
    row-granular views of it.  The hot path never calls ``execute``:
    decisions execute on the device inside :func:`fused_compact`; the
    scalar ``execute`` applies one descriptor with the same semantics for
    the rare host fallbacks (control-plane proposes, descriptor misses).
    Each of its reads and writes is one element of a device tensor.

    ``row_of(name)`` maps service names to group rows (the manager's
    RowAllocator)."""

    def __init__(self, owner, replica: int, row_of=None):
        self.owner = owner  # any object with a mutable .kv attribute
        self.replica = replica
        self.row_of = row_of or (lambda name: None)

    def _lock(self):
        """Every access to owner.kv excludes the tick, which replaces it
        (the owner's lock is reentrant, so tick-held paths still work)."""
        lk = getattr(self.owner, "lock", None)
        return lk if lk is not None else contextlib.nullcontext()

    @property
    def kv(self) -> DeviceKVState:
        return self.owner.kv

    @kv.setter
    def kv(self, v: DeviceKVState) -> None:
        self.owner.kv = v

    def execute(self, name: str, request: bytes, request_id: int) -> bytes:
        """Scalar fallback: apply one 12-byte descriptor to this replica's
        row (the same semantics as one plane step of :func:`kv_apply`)."""
        row = self.row_of(name)
        if row is None or len(request) != DESC_LEN:
            return b""
        op, k, v = struct.unpack(DESC, request)
        r = self.replica
        with self._lock():
            kv = self.kv
            slot = k & (kv.slots - 1)
            cur_k = int(kv.key[r, row, slot])
            cur_v = int(kv.val[r, row, slot])
            present = cur_k == k
            if op == OP_PUT:
                kv.key[r, row, slot] = k
                kv.val[r, row, slot] = v
                resp = v
            elif op == OP_DEL:
                if present:
                    kv.key[r, row, slot] = 0
                    kv.val[r, row, slot] = 0
                resp = cur_v if present else 0
            else:  # GET / NONE
                resp = cur_v if present else 0
        return struct.pack("<i", resp)

    def checkpoint(self, name: str) -> bytes:
        row = self.row_of(name)
        if row is None:
            return b""
        with self._lock():
            keys = self.kv.key[self.replica, row].to("cpu", copy=True).numpy()
            vals = self.kv.val[self.replica, row].to("cpu", copy=True).numpy()
        live = keys != 0
        return json.dumps({
            "k": keys[live].tolist(), "v": vals[live].tolist(),
        }).encode()

    def restore(self, name: str, state: bytes) -> None:
        row = self.row_of(name)
        if row is None:
            return
        with self._lock():
            S = self.kv.slots
            keys = np.zeros(S, np.int32)
            vals = np.zeros(S, np.int32)
            if state:
                d = json.loads(state.decode())
                for k, v in zip(d["k"], d["v"]):
                    keys[k & (S - 1)] = k
                    vals[k & (S - 1)] = v
            dev = self.kv.key.device
            self.kv.key[self.replica, row] = torch.as_tensor(keys, device=dev)
            self.kv.val[self.replica, row] = torch.as_tensor(vals, device=dev)
