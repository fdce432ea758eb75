"""Chain replication across hosts: one independent chain node per process.

The reference's chains run over the network (``chainreplication/
ChainManager.java:71-99``, FORWARD/ACK packets ``chainpackets/
ChainPacket.java:119-133``); Mode A runs a whole chain inside one process
(``chain/manager.py``).  :class:`ChainModeBNode` is the chain flavor of the
Mode B design (``modeb/``):

* each process holds the full ``[R, ...]`` chain state on its device but is
  authoritative only for its own row; peer rows are mirrors fed by SoA
  replica frames (same codec as paxos Mode B, chain schema under magic
  ``GPXC``);
* the chain tick runs with ``own_row`` confinement: only the head's process
  orders intake; forward-copy and apply consume mirror *facts* (the
  predecessor really holds those slots — the FORWARD hop; its applied
  watermark really advanced — the ACK);
* writes entering a non-head process are forwarded to the head (the
  reference's clients address the head the same way);
* the origin process responds when the commit point is visible: its mirror
  of the live tail's applied watermark passes the request's slot (reads
  serve at the tail, class doc ``ChainManager.java:71-99``);
* a laggard (or fresh) node repairs by checkpoint transfer from an
  up-to-date peer, exactly like the paxos Mode B node.

Durability: each node owns an independent journal+snapshot WAL
(``chain/modeb_logger.py``, the chain flavor of ``modeb/logger.py``) —
kill a node, restart it with the same log dir, and it replays its own
journal then rejoins via ``request_sync()``; peers repair any remaining gap
by ring copy or checkpoint transfer.

Shared host plumbing (rid space, payload/routed stores, FD refresh, staged
row purge, log-before-respond callback flushing) lives in
``modeb/common.ModeBCommon`` — fixes there cover both protocol flavors.

Kernels: a node tick is one ``chain_tick_impl`` with ``own_row=r``, so it
launches the chain tick's one plane gather (its three rings over the
per-replica window index) and no match.  The frame gather
(:func:`chain_frame_extract`) and the mirror writes
(:func:`chain_mirror_apply_impl`) are plain indexing, like the reference's
XLA gathers and scatters.
"""

from __future__ import annotations

import collections
import functools
import struct
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import overload as _overload
from ..config import GigapaxosTpuConfig
from ..device import resolve_device
from ..models.replicable import Replicable
from ..modeb import wire
from ..modeb.common import RID_MASK, RID_SHIFT, ModeBCommon  # noqa: F401
from ..net.messenger import Messenger
from ..net.transport import SendFailure
from ..obs.phase import phase_clock as _phase_clock
from ..ops.tick import _host
from ..paxos.state import to_host
from ..types import GroupStatus, NO_REQUEST
from ..utils.intmap import RowAllocator
from ..utils.locking import ContendedLock
from ..utils.reqtrace import tracer as _reqtrace
from . import state as st
from .tick import (ChainInbox, chain_tick_impl, pack_chain_outbox_impl,
                   unpack_chain_outbox)

I32 = torch.int32

#: chain frame schema (shared SoA codec, distinct magic)
CH_MAGIC = b"GPXC"
#: chain's own frame-batch container magic (bytes-handler prefix dispatch
#: must stay unambiguous when paxos Mode B coexists on the messenger)
CH_BATCH_MAGIC = b"GPXD"
CH_SCALARS = ("applied", "status", "next_slot")
CH_RINGS = ("c_req", "c_slot")
CH_BITS = ("c_stop",)

CH_PROPOSAL = "chb_proposal"
CH_WHOIS = "chb_whois"
CH_WHOIS_REPLY = "chb_whois_reply"
CH_CKPT_REQ = "chb_ckpt_req"
CH_CKPT = "chb_ckpt"


def chain_node_tick_impl(state, inbox: ChainInbox, r: int):
    """One chain Mode B node step: fused tick, own-row commit, change mask.

    next_slot is per-group state owned by the HEAD: the merge keeps our new
    value only for groups we head; other groups' counters are mirror facts
    updated by the head's frames.  The tick builds a new state, so the old
    tensors are still whole when ``changed`` compares against them."""
    new, out = chain_tick_impl(state, inbox, own_row=r)
    R = state.applied.shape[0]
    dev = state.applied.device
    r_idx = torch.arange(R, dtype=I32, device=dev)
    row2 = (r_idx == r)[:, None]
    row3 = row2[:, None, :]

    head = torch.where(state.member, r_idx[:, None], 1 << 30).amin(dim=0)
    mine_head = (head == r) & (state.n_members > 0)  # [G]

    merged = {}
    changed = torch.zeros(state.applied.shape[1], dtype=torch.bool,
                          device=dev)
    for f in ("applied", "status"):
        old_a, new_a = getattr(state, f), getattr(new, f)
        merged[f] = torch.where(row2, new_a, old_a)
        changed = changed | (new_a[r] != old_a[r])
    for f in ("c_req", "c_slot", "c_stop"):
        old_a, new_a = getattr(state, f), getattr(new, f)
        merged[f] = torch.where(row3, new_a, old_a)
        changed = changed | (new_a[r] != old_a[r]).any(dim=0)
    merged["next_slot"] = torch.where(mine_head, new.next_slot,
                                      state.next_slot)
    changed = changed | (mine_head & (new.next_slot != state.next_slot))
    return state._replace(**merged), out, changed


@functools.lru_cache(maxsize=None)
def chain_node_tick_packed(r: int):
    """Node step returning (state', flat_i32): packed outbox ++ changed, ONE
    device-to-host copy per tick.  The factory keeps the reference's call
    shape (``chain_node_tick_packed(r)(state, inbox)``)."""

    def impl(state, inbox):
        new, out, changed = chain_node_tick_impl(state, inbox, r)
        flat = torch.cat([pack_chain_outbox_impl(out), changed.to(I32)])
        return new, flat

    return impl


def unpack_chain_node_tick(flat, R: int, P: int, W: int, G: int):
    """Host inverse of :func:`chain_node_tick_packed`'s flat buffer (the
    device sync point) -> (outbox, changed[G])."""
    flat = _host(flat)
    out = unpack_chain_outbox(flat[:-G], R, P, W, G)
    return out, flat[-G:].astype(bool)


@functools.lru_cache(maxsize=None)
def chain_frame_extract(r: int, K: int):
    """Own-row gather of all chain frame fields for K (pow2-padded) rows in
    one flat i32 buffer, one device-to-host copy (not a dispatch and a sync
    per field).  Layout: applied[K] ++ status[K] ++ next_slot[K] ++
    c_req[K,W] ++ c_slot[K,W] ++ c_stop[K,W]."""

    def impl(state, rows):
        rows = torch.as_tensor(rows, device=state.applied.device).long()
        parts = [
            state.applied[r, rows],
            state.status[r, rows],
            state.next_slot[rows],
            state.c_req[r][:, rows].T,
            state.c_slot[r][:, rows].T,
            state.c_stop[r][:, rows].T,
        ]
        return torch.cat([p.to(I32).reshape(-1) for p in parts])

    return impl


def unpack_chain_frame_extract(flat, n: int, K: int, W: int):
    """Host inverse of :func:`chain_frame_extract` -> (scalars, rings, bits)
    dicts truncated to the first ``n`` rows."""
    flat = _host(flat)
    scalars = {
        "applied": flat[0:K][:n],
        "status": flat[K:2 * K][:n],
        "next_slot": flat[2 * K:3 * K][:n],
    }
    off = 3 * K
    rings = {}
    for f in ("c_req", "c_slot"):
        rings[f] = flat[off:off + K * W].reshape(K, W)[:n]
        off += K * W
    bits = {"c_stop": flat[off:off + K * W].reshape(K, W)[:n].astype(bool)}
    return scalars, rings, bits


def _in_range(rows, G: int) -> np.ndarray:
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows,
                   np.int64).reshape(-1)
    return r, np.flatnonzero((r >= 0) & (r < G))


def chain_mirror_apply_impl(state, sr, rows, scalars, bits_stop, rings,
                            head_rows):
    """Apply one decoded chain frame to sender ``sr``'s mirror rows, in
    place, and return the state.

    scalars: [3, K] (applied, status, next_slot); rings: [2, K, W] (c_req,
    c_slot); bits_stop: [K, W]; rows: [K] padded with G; head_rows: [K] the
    row where the SENDER is that group's head, G elsewhere — next_slot is
    only adopted from the head's own frames.  A torch index has no drop
    mode (an out-of-range row raises on the CPU and traps on CUDA), so the
    out-of-range rows are filtered on the host before the writes; rows and
    head_rows are host data in every caller.  The rings are written with
    ``index_copy_`` along the G axis of ``[W, G]``: a plain
    ``c_req[sr, :, rows] = rings[0]`` would take the ``[K, W]`` values
    transposed when K == W."""
    dev = state.applied.device
    G = state.applied.shape[1]
    sr = int(sr)
    r, keep = _in_range(rows, G)
    if keep.size:
        idx = torch.as_tensor(r[keep], device=dev)
        sel = torch.as_tensor(keep, device=dev)
        scal = torch.as_tensor(scalars, device=dev).to(I32).index_select(
            1, sel)                                          # [3, n]
        rng = torch.as_tensor(rings, device=dev).to(I32).index_select(
            1, sel)                                          # [2, n, W]
        bts = torch.as_tensor(bits_stop, device=dev).to(
            torch.bool).index_select(0, sel)                 # [n, W]
        state.applied[sr].index_copy_(0, idx, scal[0])
        state.status[sr].index_copy_(0, idx, scal[1])
        state.c_req[sr].index_copy_(1, idx, rng[0].T.contiguous())
        state.c_slot[sr].index_copy_(1, idx, rng[1].T.contiguous())
        state.c_stop[sr].index_copy_(1, idx, bts.T.contiguous())
    h, hkeep = _in_range(head_rows, G)
    if hkeep.size:
        hsel = torch.as_tensor(hkeep, device=dev)
        nxt = torch.as_tensor(scalars, device=dev).to(I32)[2].index_select(
            0, hsel)
        state.next_slot.index_copy_(0, torch.as_tensor(h[hkeep], device=dev),
                                    nxt)
    return state


#: the reference's jitted name; the port writes the mirrors in place
chain_mirror_apply = chain_mirror_apply_impl


class ChainBRecord:
    __slots__ = ("rid", "name", "row", "payload", "stop", "callback",
                 "slot", "response", "responded", "born_tick")

    def __init__(self, rid, name, row, payload, stop, callback, born_tick):
        self.rid = rid
        self.name = name
        self.row = row
        self.payload = payload
        self.stop = stop
        self.callback = callback
        self.slot = -1
        self.response = None
        self.responded = False
        self.born_tick = born_tick


class ChainModeBNode(ModeBCommon):
    """One process of a multi-host chain deployment (ChainManager-per-
    machine analog).  Public surface mirrors :class:`~gigapaxos_tpu_torch.
    modeb.ModeBNode` so drivers and coordinators bind either protocol."""

    def __init__(
        self,
        cfg: GigapaxosTpuConfig,
        member_ids: List[str],
        node_id: str,
        app: Replicable,
        messenger: Optional[Messenger] = None,
        wal=None,
        anti_entropy_every: int = 64,
        device=None,
    ):
        """``device`` holds the node's state (``None`` = CUDA; see
        ``device.resolve_device``)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.members = list(member_ids)
        self.node_id = node_id
        self.r = self.members.index(node_id)
        self.R = len(self.members)
        self.G = cfg.paxos.max_groups
        self.W = cfg.paxos.window
        self.P = cfg.paxos.proposals_per_tick
        self.app = app
        self.m: Optional[Messenger] = None
        self.anti_entropy_every = anti_entropy_every

        self.state = st.init_state(self.R, self.G, self.W,
                                   device=self.device)
        self.rows = RowAllocator(self.G)
        self._gid_row: Dict[int, int] = {}
        self._row_meta: Dict[int, tuple] = {}
        self.alive = np.ones(self.R, bool)
        self.tick_num = 0
        self._init_common()  # rid space, payload/_routed stores, wake, FD
        self.outstanding: Dict[int, ChainBRecord] = {}
        self._queues: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque
        )
        self._stopped_rows: set = set()
        self._tainted_rows: set = set()
        self._await_commit: list = []  # records applied locally, commit TBD
        self._dirty = np.zeros(self.G, bool)
        self._occupied = np.zeros(self.G, bool)  # live rows (frame targets)
        self._ae_phase = (np.arange(self.G, dtype=np.int64)
                          % max(anti_entropy_every, 1))
        self._force_full = True
        self._placed: list = []
        #: lock-free propose staging, drained at each tick
        self._staged: collections.deque = collections.deque()
        #: per-request flow tracing (see modeb/manager.py): universe-scoped
        self.reqtrace = _reqtrace(f"chu:{self.members[0]}")
        #: always-on tick phase clock (obs/phase.py)
        self._pc = _phase_clock("chain_modeb", plane=str(self.node_id))
        self._pending_whois: set = set()
        self._pending_mirror: list = []
        self._frame_applied_tick: Dict[int, int] = {}
        self._last_frame_rx = 0
        self.stats = collections.Counter()
        # intake governor: watermark shed of client-class proposes
        self._ov_node = node_id
        self.overload = (
            _overload.IntakeGovernor(cfg.overload.intake_hi,
                                     cfg.overload.intake_lo, node=node_id)
            if cfg.overload.enabled else None)
        self.lock = ContendedLock()
        self._tick_packed = chain_node_tick_packed(self.r)
        self._in_req = np.zeros((self.P, self.G), np.int32)
        self._in_stp = np.zeros((self.P, self.G), bool)
        self.wal = wal
        if wal is not None:
            wal.attach(self)
        if messenger is not None:
            self.attach_messenger(messenger)

    # --------------------------------------------------------------- plumbing
    def attach_messenger(self, messenger: Messenger) -> None:
        self.m = messenger
        d = self.m.demux
        prev = d.bytes_handler

        def on_bytes(sender: str, payload: bytes) -> None:
            if payload.startswith(CH_BATCH_MAGIC):
                # split the per-(peer, tick) container; each sub-frame is
                # journaled/applied like a singly-sent frame (WAL replay
                # format unchanged)
                try:
                    subs = wire.decode_frames(payload, magic=CH_BATCH_MAGIC)
                except (ValueError, struct.error):
                    self.stats["bad_frames"] += 1
                    return
                for sub in subs:
                    self._on_frame(sender, sub)
            elif payload.startswith(CH_MAGIC):
                self._on_frame(sender, payload)
            elif prev is not None:
                prev(sender, payload)

        d.bytes_handler = on_bytes
        self.m.register(CH_PROPOSAL, self._on_proposal)
        self.m.register(CH_WHOIS, self._on_whois)
        self.m.register(CH_WHOIS_REPLY, self._on_whois_reply)
        self.m.register(CH_CKPT_REQ, self._on_ckpt_req)
        self.m.register(CH_CKPT, self._on_ckpt)

    # ------------------------------------------------------------------ admin
    def create_group(self, name: str, members: List[int],
                     epoch: int = 0) -> bool:
        with self.lock:
            if name in self.rows or self.rows.full():
                return False
            row = self.rows.alloc(name)
            mask = np.zeros((1, self.R), bool)
            for mm in members:
                mask[0, mm] = True
            self.state = st.create_groups(
                self.state, np.array([row], np.int32), mask,
                np.array([epoch], np.int32),
            )
            self._gid_row[wire.gid_of(name)] = row
            self._row_meta[row] = (name, list(members), epoch)
            self._stopped_rows.discard(row)
            self._dirty[row] = True
            self._occupied[row] = True
            if self.wal is not None:
                self.wal.log_create(name, list(members), epoch)
            return True

    def remove_group(self, name: str) -> bool:
        with self.lock:
            row = self.rows.row(name)
            if row is None:
                return False
            if self.wal is not None:
                self.wal.log_remove(name)
            self.state = st.free_groups(self.state, np.array([row], np.int32))
            self.rows.free(name)
            self._gid_row.pop(wire.gid_of(name), None)
            self._row_meta.pop(row, None)
            self._queues.pop(row, None)
            self._stopped_rows.discard(row)
            self._occupied[row] = False
            self._dirty[row] = False
            self._purge_staged_row(row)
            return True

    def _expand_state(self, n_new: int) -> None:
        self.state = st.expand_replica_slots(self.state, n_new)

    def _reset_intake_buffers(self) -> None:
        self._in_req = np.zeros((self.P, self.G), np.int32)
        self._in_stp = np.zeros((self.P, self.G), bool)

    def is_stopped(self, name: str) -> bool:
        row = self.rows.row(name)
        return row is not None and row in self._stopped_rows

    def group_members(self, name: str):
        with self.lock:
            row = self.rows.row(name)
            if row is None:
                return None
            meta = self._row_meta.get(row)
            return list(meta[1]) if meta is not None else None

    def group_epoch(self, name: str):
        with self.lock:
            row = self.rows.row(name)
            if row is None:
                return None
            meta = self._row_meta.get(row)
            return meta[2] if meta is not None else None

    def is_tainted(self, name: str) -> bool:
        with self.lock:
            row = self.rows.row(name)
            return row is not None and row in self._tainted_rows

    def _head_of(self, row: int) -> Optional[int]:
        meta = self._row_meta.get(row)
        return min(meta[1]) if meta and meta[1] else None

    def _live_tail_of(self, row: int) -> Optional[int]:
        meta = self._row_meta.get(row)
        if not meta or not meta[1]:
            return None
        live = [m for m in meta[1] if self.alive[m]]
        return max(live) if live else None

    # ---------------------------------------------------------------- propose
    def propose(self, name: str, payload: bytes,
                callback: Optional[Callable[[int, Optional[bytes]], None]] = None,
                stop: bool = False, deadline: Optional[int] = None,
                cls: int = _overload.CLS_CONTROL) -> Optional[int]:
        """Lock-free fast path like the paxos planes (see
        paxos/manager.propose): stage for the next tick's drain; the
        existence/fenced pre-checks are racy reads and the authoritative
        outcome rides the callback.  A racy negative (unknown or fenced)
        re-checks under the lock before rejecting — a recycled row can be
        visible in the row table before the old occupant's stopped flag is
        discarded."""
        if (cls == _overload.CLS_CLIENT and self.overload is not None
                and not self.overload.admit(cls)):
            # watermark shed: explicit retriable busy NACK, never silent
            self.stats["shed_requests"] += 1
            _overload.count_shed(cls, "intake", self._ov_node)
            with self.lock:
                if callback is not None:
                    self._held_callbacks.append(
                        (callback, _overload.RID_BUSY, None))
            return None
        row = self.rows.row(name)  # racy read: benign for the POSITIVE case
        if row is None or row in self._stopped_rows:
            with self.lock:
                row = self.rows.row(name)
                if row is None or row in self._stopped_rows:
                    if callback is not None:
                        self._held_callbacks.append((callback, -1, None))
                    return None
        rid = self.next_rid()
        self._staged.append((rid, name, payload, callback, stop, deadline))
        if self.reqtrace.enabled:
            self.reqtrace.event(rid, "staged", name=name, node=self.node_id)
        self._wake()
        return rid

    def _drain_staged(self) -> None:
        """Admit staged proposals (start of each tick, lock held): queue
        on the group's row — the placement loop that runs right after
        already forwards every queued rid to a remote head."""
        while True:
            try:
                (rid, name, payload, callback, stop,
                 deadline) = self._staged.popleft()
            except IndexError:
                return
            if _overload.expired(deadline):
                if callback is not None:
                    self._held_callbacks.append(
                        (callback, _overload.RID_EXPIRED, None))
                self.stats["expired_drops"] += 1
                _overload.count_expired("intake", self._ov_node)
                continue
            row = self.rows.row(name)
            if row is None or row in self._stopped_rows:
                if callback is not None:
                    self._held_callbacks.append((callback, rid, None))
                continue
            rec = ChainBRecord(rid, name, row, payload, stop, callback,
                               self.tick_num)
            self.outstanding[rid] = rec
            if self.reqtrace.enabled:
                self.reqtrace.event(rid, "admitted", row=row,
                                    node=self.node_id)
            self._queues[row].append(rid)

    def propose_stop(self, name: str, payload: bytes = b"", callback=None):
        return self.propose(name, payload, callback, stop=True)

    def _forward(self, rec: ChainBRecord, head: int) -> None:
        if self.m is None:
            self._queues[rec.row].append(rec.rid)
            return
        self.m.send(self.members[head], {
            "type": CH_PROPOSAL, "rid": rec.rid,
            "gid": str(wire.gid_of(rec.name)),
            "payload": rec.payload.hex(), "stop": rec.stop,
        })
        self.stats["forwarded"] += 1

    def _on_proposal(self, sender: str, p: dict) -> None:
        rid = int(p["rid"])
        gid = int(p["gid"])
        with self.lock:
            row = self._gid_row.get(gid)
            if row is None:
                self._whois(gid, sender)
                return
            if rid in self.outstanding:
                return
            self._store_payload(rid, bytes.fromhex(p["payload"]),
                                bool(p.get("stop")))
            if not self._mark_routed(rid):
                return
            self._queues[row].append(rid)
        self._wake()

    # ------------------------------------------------------------------- tick
    def tick(self):
        pc = self._pc
        pc.begin()
        if self.overload is not None:
            with self.lock:
                backlog = (len(self._staged)
                           + sum(len(q) for q in self._queues.values())
                           + sum(1 for rec in self.outstanding.values()
                                 if not rec.responded))
            self.overload.update(backlog)
        with self.lock:
            self._refresh_alive()
            self._flush_mirrors()
            inbox = self._build_inbox()
            pc.mark("intake")
            # dispatch first, journal second: the WAL fsync overlaps the
            # asynchronous device step
            self.state, packed = self._tick_packed(self.state, inbox)
            pc.mark("dispatch")
            if self.wal is not None:
                self.wal.log_inbox(self.tick_num, self.alive)
            pc.mark("wal_fsync")
            out, changed = unpack_chain_node_tick(
                packed, self.R, self.P, self.W, self.G
            )
            pc.mark("tally")
            self._process_outbox(out)
            self._dirty |= changed
            self.tick_num += 1
            frames = self._build_frames()
            pc.mark("outbox_pack")
            if self.wal is not None:
                self.wal.maybe_checkpoint()
            self._release_committed()
            self._flush_callbacks()
            if self.tick_num % 16 == 0 or self._tainted_rows:
                self._check_laggard()
            if self.tick_num % 64 == 0:
                self._sweep()
            pc.mark("execute")
        if frames and self.m is not None:
            # identical frame list for every peer: one container, one
            # transport frame (and one writev) per peer per tick
            batch = (wire.encode_frames(frames, magic=CH_BATCH_MAGIC)
                     if len(frames) > 1 else frames[0])
            for i, peer in enumerate(self.members):
                if i != self.r:
                    try:
                        self.m.send_bytes(peer, batch)
                    except SendFailure:
                        self.stats["send_failures"] += 1
        pc.mark("egress")
        pc.end()
        return out

    def _build_inbox(self) -> ChainInbox:
        self._drain_staged()
        req, stp = self._in_req, self._in_stp
        for _row, take in self._placed:
            for _rid, p in take:
                req[p, _row] = 0
                stp[p, _row] = False
        placed = []
        for row, q in self._queues.items():
            head = self._head_of(row)
            if head is not None and head != self.r and self.m is not None:
                while q:  # head is elsewhere: forward everything queued here
                    rid = q.popleft()
                    rec = self.outstanding.get(rid)
                    if rec is not None:
                        self._forward(rec, head)
                    elif rid in self.payloads:
                        name = self.rows.name(row)
                        if name is None:
                            continue  # group freed: drop, don't mis-route
                        payload, stop = self.payloads[rid]
                        self.m.send(self.members[head], {
                            "type": CH_PROPOSAL, "rid": rid,
                            "gid": str(wire.gid_of(name)),
                            "payload": payload.hex(), "stop": stop,
                        })
                continue
            take = []
            p = 0
            while q and p < self.P:
                rid = q.popleft()
                if rid not in self.outstanding and rid not in self.payloads:
                    continue
                rec = self.outstanding.get(rid)
                stop = rec.stop if rec is not None else self.payloads[rid][1]
                req[p, row] = rid
                stp[p, row] = stop
                take.append((rid, p))
                p += 1
            if take:
                placed.append((row, take))
        self._placed = placed
        # device copies (the staging buffers are mutated next build; on the
        # CPU a tensor made from numpy would alias them); the WAL journals
        # the host alive vector the inbox was built from
        return ChainInbox(self._on_device(req), self._on_device(stp),
                          self._on_device(self.alive))

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        if self.device.type == "cpu":
            return torch.from_numpy(a.copy())
        return torch.as_tensor(a, device=self.device)

    def _process_outbox(self, out) -> None:
        taken = out.intake_taken  # [P, G]
        for row, take in self._placed:
            for rid, p in reversed(take):
                if not taken[p, row]:
                    self._queues[row].appendleft(rid)
        er = out.exec_req[self.r]   # [W, G]
        es = out.exec_stop[self.r]
        eb = out.exec_base[self.r]
        ec = out.exec_count[self.r]
        for row in np.nonzero(ec)[0]:
            name = self.rows.name(int(row))
            if name is None:
                continue
            for j in range(int(ec[row])):
                self._apply_one(int(row), name, int(er[j, row]),
                                int(eb[row]) + j, bool(es[j, row]))
        self.stats["committed"] += int(np.asarray(out.committed_now).sum())

    def _apply_one(self, row: int, name: str, rid: int, slot: int,
                   is_stop: bool) -> None:
        if is_stop and row not in self._stopped_rows:
            self._stopped_rows.add(row)
            q = self._queues.pop(row, None)
            for qrid in (q or ()):
                rec = self.outstanding.get(qrid)
                if rec is not None and rec.callback and not rec.responded:
                    rec.responded = True
                    self._held_callbacks.append((rec.callback, qrid, None))
        if rid == NO_REQUEST:
            return
        rec = self.outstanding.get(rid)
        if rec is not None:
            payload = rec.payload
        elif rid in self.payloads:
            payload = self.payloads[rid][0]
        else:
            self.stats["orphan_execs"] += 1
            self._tainted_rows.add(row)
            return
        response = self.app.execute(name, payload, rid)
        self.stats["executions"] += 1
        if rec is not None and not rec.responded:
            # hold until the commit point (tail applied) is visible
            rec.slot = slot
            rec.response = response
            self._await_commit.append(rec)

    def _release_committed(self) -> None:
        """Fire callbacks whose slot the live tail has applied — the ACK
        path: tail application is the commit point, and the tail's applied
        watermark is a mirror fact (or our own row when we are the tail)."""
        if not self._await_commit:
            return
        applied = to_host(self.state.applied)  # [R, G], a host copy
        still = []
        for rec in self._await_commit:
            if rec.responded:
                continue
            tail = self._live_tail_of(rec.row)
            if tail is not None and applied[tail, rec.row] > rec.slot:
                rec.responded = True
                if rec.callback is not None:
                    self._held_callbacks.append(
                        (rec.callback, rec.rid, rec.response)
                    )
            else:
                still.append(rec)
        self._await_commit = still

    def _sweep(self) -> None:
        gone = [rid for rid, rec in self.outstanding.items()
                if rec.responded and self.tick_num - rec.born_tick > 4096]
        for rid in gone:
            del self.outstanding[rid]

    # ------------------------------------------------------------ frames (tx)
    def _row_wire_bytes(self) -> int:
        return (8 + 4 * len(CH_SCALARS) + 4       # gid + scalars + flags
                + 4 * self.W * len(CH_RINGS)       # i32 rings
                + 4 * len(CH_BITS))                # W bits -> one i32

    def _build_frames(self) -> List[bytes]:
        """Fragmented chain frames for this tick (shared selection/chunking
        in ModeBCommon; this flavor contributes the chain columns gather +
        the chain wire schema)."""
        def extract(chunk_rows):
            n = len(chunk_rows)
            K = max(16, 1 << max(0, int(n - 1).bit_length()))
            rpad = np.zeros(K, np.int32)
            rpad[:n] = chunk_rows
            flat = chain_frame_extract(self.r, K)(
                self.state, torch.as_tensor(rpad, device=self.device)
            )
            return unpack_chain_frame_extract(flat, n, K, self.W)

        def encode(chunk_gids, fields, chunk_pay, full):
            scalars, rings, bits = fields
            return wire.encode_frame(
                self.r, self.tick_num, self.W, chunk_gids, scalars,
                np.zeros(len(chunk_gids), np.int32), rings, bits, chunk_pay,
                full=full, scalar_fields=CH_SCALARS, ring_fields=CH_RINGS,
                bit_fields=CH_BITS, magic=CH_MAGIC,
            )

        return self._build_frames_common(
            self._row_wire_bytes(), extract, encode
        )

    # ------------------------------------------------------------ frames (rx)
    def _on_frame(self, sender: str, payload: bytes) -> None:
        try:
            frame = wire.decode_frame(
                payload, scalar_fields=CH_SCALARS, ring_fields=CH_RINGS,
                bit_fields=CH_BITS, magic=CH_MAGIC,
            )
        except (ValueError, IndexError, struct.error):
            self.stats["bad_frames"] += 1
            return
        with self.lock:
            if self.wal is not None:
                self.wal.log_frame(payload)
            self._stage_frame(frame, sender)
        self._wake()

    def _stage_frame(self, frame: wire.Frame, sender: str = "?") -> None:
        sr = frame.sender_r
        if sr == self.r or not (0 <= sr < self.R) or frame.W != self.W:
            return
        last = self._frame_applied_tick.get(sr, -1)
        if frame.tick < last:
            return
        self._frame_applied_tick[sr] = frame.tick
        self._last_frame_rx = self.tick_num
        for rid, stop, data in frame.payloads:
            self.bump_seq(np.array([rid]))
            if rid not in self.outstanding and rid not in self.payloads:
                self._store_payload(rid, data, stop)
        self.bump_seq(frame.rings["c_req"])
        n = len(frame.gids)
        if n == 0:
            return
        rows = np.full(n, -1, np.int64)
        unknown = []
        for i in range(n):
            row = self._gid_row.get(int(frame.gids[i]))
            if row is None:
                unknown.append(int(frame.gids[i]))
            else:
                rows[i] = row
        if unknown and sender != "?":
            for gid in unknown[:16]:
                self._whois(gid, sender)
        sel = rows >= 0
        if not sel.any():
            return
        self._pending_mirror.append(
            (sr, rows[sel], np.nonzero(sel)[0], frame)
        )
        self.stats["frames_staged"] += 1

    def _flush_mirrors(self) -> None:
        """Apply every staged frame to the peer mirrors: one batch of field
        writes per frame, over exactly the frame's known rows (the
        reference pads them to a power of two for its jit cache; the port
        has no compile cache to bound)."""
        if not self._pending_mirror:
            return
        pend, self._pending_mirror = self._pending_mirror, []
        for sr, rows, keep, frame in pend:
            scal = np.stack([frame.scalars[f][keep] for f in CH_SCALARS])
            rings = np.stack([frame.rings[f][keep] for f in CH_RINGS])
            bits = frame.ring_bits["c_stop"][keep]
            # next_slot is adopted only for groups the SENDER heads
            head_rows = np.array(
                [row if self._head_of(int(row)) == sr else self.G
                 for row in rows], np.int64)
            self.state = chain_mirror_apply(self.state, sr, rows, scal, bits,
                                            rings, head_rows)
            self.stats["frames_applied"] += 1

    # ------------------------------------------------- missed birthing (whois)
    def _whois(self, gid: int, ask: str) -> None:
        if gid in self._pending_whois or self.m is None:
            return
        self._pending_whois.add(gid)
        self.m.send(ask, {"type": CH_WHOIS, "gid": str(gid)})

    def _on_whois(self, sender: str, p: dict) -> None:
        gid = int(p["gid"])
        if gid == 0:
            # sync request (rejoin): re-announce everything next frame
            with self.lock:
                self._force_full = True
            self._wake()
            return
        with self.lock:
            row = self._gid_row.get(gid)
            if row is None:
                return
            name, members, epoch = self._row_meta[row]
            self._dirty[row] = True
        self.m.send(sender, {
            "type": CH_WHOIS_REPLY, "gid": str(gid), "name": name,
            "members": members, "epoch": epoch,
        })

    def _on_whois_reply(self, sender: str, p: dict) -> None:
        with self.lock:
            self._pending_whois.discard(int(p["gid"]))
            if self.whois_birth is not None and not self.whois_birth(p["name"]):
                self.stats["whois_birth_filtered"] += 1
                return
            self.create_group(p["name"], [int(x) for x in p["members"]],
                              int(p["epoch"]))
        self._wake()

    # ------------------------------------------ checkpoint transfer (laggard)
    def _check_laggard(self) -> None:
        """Own applied trails the live maximum by >= W (ring copy can never
        catch up), or the row's app copy is tainted: fetch an app checkpoint
        from the most advanced live peer."""
        if self.m is None:
            return
        applied = to_host(self.state.applied)  # [R, G], a host copy
        need = set(list(self._tainted_rows)[:16])
        for name, row in list(self.rows.items())[:256]:
            meta = self._row_meta.get(row)
            if not meta:
                continue
            live = [m for m in meta[1] if self.alive[m] and m != self.r]
            if not live:
                continue
            peak = max(applied[m, row] for m in live)
            if peak - applied[self.r, row] >= self.W:
                need.add(row)
        for row in list(need)[:16]:
            name = self.rows.name(int(row))
            if name is None:
                self._tainted_rows.discard(row)
                continue
            meta = self._row_meta.get(row)
            donors = [m for m in (meta[1] if meta else [])
                      if m != self.r and self.alive[m]]
            if not donors:
                continue
            donor = max(donors, key=lambda m: applied[m, row])
            self.m.send(self.members[donor], {
                "type": CH_CKPT_REQ, "gid": str(wire.gid_of(name)),
            })
            self.stats["ckpt_requests"] += 1

    def _on_ckpt_req(self, sender: str, p: dict) -> None:
        gid = int(p["gid"])
        with self.lock:
            row = self._gid_row.get(gid)
            if row is None or row in self._tainted_rows:
                return
            name = self.rows.name(row)
            blob = self.app.checkpoint(name)
            reply = {
                "type": CH_CKPT, "gid": str(gid),
                "applied": int(self.state.applied[self.r, row]),
                "status": int(self.state.status[self.r, row]),
                "state": blob.hex(),
            }
        self.m.send(sender, reply)

    def _on_ckpt(self, sender: str, p: dict) -> None:
        gid = int(p["gid"])
        with self.lock:
            row = self._gid_row.get(gid)
            if row is None:
                return
            if self.wal is not None:
                self.wal.log_ckpt(gid, p)
            self._apply_ckpt(row, p)
        self._wake()

    def _apply_ckpt(self, row: int, p: dict) -> None:
        """Adopt a donor checkpoint (shared with WAL replay — the transfer
        mutates own-row state outside the deterministic tick)."""
        with self.lock:
            donor_applied = int(p["applied"])
            have = int(self.state.applied[self.r, row])
            if donor_applied < have or (donor_applied == have
                                        and row not in self._tainted_rows):
                return
            name = self.rows.name(row)
            self.app.restore(name, bytes.fromhex(p["state"]))
            self.state.applied[self.r, row] = donor_applied
            self.state.status[self.r, row] = int(p["status"])
            if int(p["status"]) == int(GroupStatus.STOPPED):
                self._stopped_rows.add(row)
            self._tainted_rows.discard(row)
            self._dirty[row] = True
            self.stats["ckpt_transfers"] += 1
        self._wake()

    def request_sync(self) -> None:
        if self.m is None:
            return
        with self.lock:
            self._force_full = True
        for i, peer in enumerate(self.members):
            if i != self.r:
                self.m.send(peer, {"type": CH_WHOIS, "gid": "0"})

    # ------------------------------------------------------------ driver shim
    def pending_count(self) -> int:
        with self.lock:
            n = sum(len(q) for q in self._queues.values()) + len(self._staged)
            n += sum(1 for rec in self.outstanding.values()
                     if not rec.responded)
            n += len(self._await_commit)
            if self.tick_num - self._last_frame_rx < 8:
                n += 1
            return n

    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.tick()

    def close(self) -> None:
        if self.m is not None:
            self.m.close()
