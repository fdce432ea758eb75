"""Mode-B node manager: one independent consensus node per process.

The reference's deployment unit is a machine-level ``PaxosManager`` with its
own disk log, exchanging ACCEPT / ACCEPT_REPLY / DECISION over the network
(gigapaxos/PaxosManager.java:104-119; ACCEPT multicast
PaxosInstanceStateMachine.java:844-845; per-node logs
SQLPaxosLogger.java:123).  :class:`ModeBNode` is that unit for the dense
design:

* own device state (authoritative row r + peer mirrors, ``kernel.py``) on
  ``device`` (CUDA unless the caller asks for the CPU);
* own WAL (:class:`~gigapaxos_tpu_torch.modeb.logger.ModeBLogger`) —
  snapshot + journal of everything that feeds the deterministic step:
  admin ops, applied replica frames, placed intake;
* replica traffic as per-tick SoA frames over the Messenger (``wire.py``),
  delta-encoded by the kernel's change mask with periodic anti-entropy
  full frames;
* request forwarding to the current coordinator (the PROPOSAL unicast of
  handleProposal, PaxosInstanceStateMachine.java:854-868) with payload
  dissemination riding the frames;
* missed-birthing resolution by gid (FindReplicaGroupPacket analog,
  gigapaxos/PaxosManager.java:2459-2469).

Losing a machine here means losing a process: a SIGKILL'd node stops
framing, the survivors' failure view marks its row dead, a surviving
member wins the coordinatorship and the majority keeps committing; the
killed node restarts from *its own* journal (``recover_modeb``) and
rejoins.
"""

from __future__ import annotations

import collections
import os
import queue
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import overload as _overload
from ..config import GigapaxosTpuConfig
from ..device import resolve_device, serial_on_cpu
from ..models.device_kv import DESC as _DESC, DESC_LEN as _DESC_LEN
from ..models.replicable import Replicable
from ..net.messenger import Messenger
from ..net.transport import SendFailure
from ..obs.metrics import registry as _obs_registry
from ..obs.phase import phase_clock as _phase_clock
from ..ops.tick import TickInbox
from ..paxos import state as st
from ..types import GroupStatus, NO_REQUEST
from ..utils.diskmap import DiskMap
from ..utils.intmap import RowAllocator
from ..utils.locking import ContendedLock
from ..utils.reqtrace import tracer as _reqtrace
from . import wire
#: request ids are node-scoped: high bits carry the origin replica slot so
#: any node can route the response duty without a lookup (the entry-replica
#: field of RequestPacket, gigapaxos/paxospackets/RequestPacket.java:189)
from .common import RID_MASK, RID_SHIFT, ModeBCommon, rid_origin  # noqa: F401
from .kernel import (frame_extract, mirror_apply, node_tick_device,
                     node_tick_packed, ring_downstream,
                     unpack_frame_extract, unpack_node_tick,
                     unpack_node_tick_device)

MB_PROPOSAL = "mb_proposal"
MB_UNDIGEST = "mb_undigest"
MB_UNDIGEST_REPLY = "mb_undigest_reply"
MB_WHOIS = "mb_whois"
MB_WHOIS_REPLY = "mb_whois_reply"
MB_SYNC_REQ = "mb_sync_req"
MB_CKPT_REQ = "mb_ckpt_req"
MB_CKPT = "mb_ckpt"


class ModeBRecord:
    __slots__ = ("rid", "name", "row", "payload", "stop", "callback",
                 "responded", "born_tick")

    def __init__(self, rid, name, row, payload, stop, callback, born_tick):
        self.rid = rid
        self.name = name
        self.row = row
        self.payload = payload
        self.stop = stop
        self.callback = callback
        self.responded = False
        self.born_tick = born_tick


class ModeBNode(ModeBCommon):
    def __init__(
        self,
        cfg: GigapaxosTpuConfig,
        member_ids: List[str],
        node_id: str,
        app: Replicable,
        messenger: Optional[Messenger] = None,
        wal=None,
        anti_entropy_every: int = 64,
        spill_ns: Optional[str] = None,
        device=None,
    ):
        """``spill_ns`` namespaces this node's disk spill store — several
        planes (AR + RC) of one process share a cfg and must never adopt
        or clear each other's cold files.  ``device`` holds the node's
        state (``None`` = CUDA; see ``device.resolve_device``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.members = list(member_ids)
        self.node_id = node_id
        self.r = self.members.index(node_id)
        self.R = len(self.members)
        assert self.R <= (1 << 6), "replica-slot space exceeds rid encoding"
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
        self._row_meta: Dict[int, tuple] = {}  # row -> (name, members, epoch)
        self.alive = np.ones(self.R, bool)
        self.tick_num = 0
        self._init_common()  # rid space, payload/_routed stores, wake, FD
        self.outstanding: Dict[int, ModeBRecord] = {}
        self._queues: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque
        )
        self._seen: Dict[int, collections.OrderedDict] = collections.defaultdict(
            collections.OrderedDict
        )
        self._seen_cap = 8 * self.W
        self._stopped_rows: set = set()
        # ---- pause/spill (per-node deactivation, PaxosManager.java:2284;
        # pause tables SQLPaxosLogger.java:4044-4048).  A node pauses its
        # own locally-quiescent groups independently; spilled records
        # demand-page to disk so the per-process group population can
        # exceed the preallocated device rows.  Mirror rows are soft state
        # and simply re-fill from anti-entropy after unpause.
        self._paused = DiskMap(
            os.path.join(cfg.paxos.spill_dir, spill_ns or f"mb_{node_id}")
            if cfg.paxos.spill_dir else None,
            cfg.paxos.spill_cache,
        )
        # the spill dir is scratch: stale files of an earlier process must
        # never resurrect consensus state on a fresh boot
        self._paused.clear()
        self._paused_gids: Dict[int, str] = {}
        self._row_last_active = np.zeros(self.G, np.int64)
        self._coord_view = np.full(self.G, -1, np.int32)
        self._dirty = np.zeros(self.G, bool)
        self._occupied = np.zeros(self.G, bool)  # live rows (frame targets)
        #: precomputed rotation phase per row (avoids an O(G) arange+mod
        #: allocation in every tick's frame build)
        self._ae_phase = (np.arange(self.G, dtype=np.int64)
                          % max(anti_entropy_every, 1))
        #: rows whose app state diverged by skipping a payload-less decision
        #: (orphan exec) — repaired by checkpoint transfer, until which the
        #: local app copy must not be trusted as a donor
        self._tainted_rows: set = set()
        #: per-row checkpoint-request attempts (donor rotation); cleared on
        #: successful adoption
        self._ckpt_tries: Dict[int, int] = {}
        self._force_full = True  # first frame announces full own row
        self._placed: list = []
        #: pipelined mode: (outbox, placed) of the last dispatched tick
        self._pending_out = None
        #: lock-free propose staging, drained at each tick
        self._staged: collections.deque = collections.deque()
        #: per-request flow tracing (RequestInstrumenter analog); the
        #: namespace is the universe's slot-0 owner — identical on every
        #: node of one universe AND stable under runtime expansion, so a
        #: forwarded request's cross-node hops merge into one timeline in
        #: in-process deployments.  (Distinct universes that share a slot-0
        #: id in one process share a namespace; their slot-tagged rids can
        #: then collide — acceptable for a debug facility.)
        self.reqtrace = _reqtrace(f"mbu:{self.members[0]}")
        #: always-on tick phase clock (obs/phase.py); host timestamps only —
        #: the device wait lands in "tally" at the unpack sync point
        self._pc = _phase_clock("modeb", plane=str(self.node_id))
        # ---- digest-only accepts (PendingDigests.java:23) ----
        # Explicit opt-in, OR the default-at-scale threshold: past
        # digest_min_replicas members, payload fan-out (R-1 copies per
        # decision) dominates coordinator egress, so digest ordering
        # becomes the default (HT-Paxos, arxiv 1407.1237).  Resolved once
        # at construction — see the config.py knob for why.
        _thresh = int(getattr(cfg.paxos, "digest_min_replicas", 0) or 0)
        self._digest_accepts = bool(cfg.paxos.digest_accepts) or (
            0 < _thresh <= self.R
        )
        # ---- ring payload dissemination (HT-Ring Paxos, 1507.04086) ----
        # Only meaningful on top of digest ordering: ordering frames carry
        # rids, payload bytes ride a relay slab around the alive members —
        # one upstream recv + one downstream send per tick per node.
        self._ring_dissemination = self._digest_accepts and bool(
            getattr(cfg.paxos, "ring_dissemination", False)
        )
        #: upstream slabs staged for the downstream hop:
        #: (RelaySlab, precomputed forward mask sans the downstream drop)
        self._relay_fwd: list = []
        #: rids already relayed through here (cycle breaker; see
        #: _mark_relayed), bounded like the payload store
        self._relay_seen: "collections.OrderedDict[int, bool]" = (
            collections.OrderedDict()
        )
        #: derived egress efficiency gauge: (broadcast + relay bytes this
        #: node sent) / decisions it has ordered — the number the ring is
        #: designed to hold ~flat in R (see benchmarks/egress_bench.py)
        self._egress_g = _obs_registry().gauge(
            "egress_bytes_per_decision",
            "frame+relay egress bytes per ordered decision",
            node=str(node_id),
        )
        #: ring hop latency: upstream slab send -> local receive
        self._ring_hop_h = _obs_registry().histogram(
            "ring_hop_seconds",
            "relay slab latency across one ring hop",
            node=str(node_id),
        )
        #: rid -> stop flag for digest proposals whose payload has not
        #: arrived yet (placement needs only the rid + stop)
        self._digest_meta: "collections.OrderedDict[int, bool]" = (
            collections.OrderedDict()
        )
        #: rows whose execution stream is held on a rid-without-payload
        #: (the PendingDigests "accept waits for its payload" analog, moved
        #: to the execution edge — our accepts are rid-only by design);
        #: row -> deque[(name, rid, slot, is_stop)], drained in slot order
        self._stalled: Dict[int, collections.deque] = {}
        self._stall_tick: Dict[int, int] = {}
        self._undigest_asked: "collections.OrderedDict[int, int]" = (
            collections.OrderedDict()
        )
        self._pending_whois: set = set()
        #: decoded frames awaiting the once-per-tick fused mirror apply:
        #: (sender_r, local_rows, frame_row_selector, Frame)
        self._pending_mirror: list = []
        self._frame_applied_tick: Dict[int, int] = {}
        self._last_frame_rx = 0  # our tick count when a frame last arrived
        self.stats = collections.Counter()
        # intake governor: watermark shed of client-class proposes when the
        # staged+outstanding backlog crosses the high watermark
        self._ov_node = spill_ns or node_id
        self.overload = (
            _overload.IntakeGovernor(cfg.overload.intake_hi,
                                     cfg.overload.intake_lo,
                                     node=self._ov_node)
            if cfg.overload.enabled else None)
        # ---- host-side read leases (pragmatic Mode-B twin) ----
        # Mode A folds leases on device; a per-process node instead keeps
        # tick-denominated host bookkeeping over its completed-tick
        # coordinator view: holdership renews every completed tick we
        # remain the winning coordinator, and a takeover write-fences the
        # row for a full horizon+margin (we cannot see the prior holder's
        # grant time, so we wait out the worst case).  Semantics are
        # deliberately conservative; leases default OFF.
        self._read_leases = bool(cfg.paxos.read_leases)
        self._lease_horizon = int(cfg.paxos.lease_ticks)
        self._lease_margin = int(cfg.paxos.lease_margin_ticks)
        self._lease_until = np.zeros(self.G, np.int64)  # our holdership expiry
        self._lease_fence = np.zeros(self.G, np.int64)  # takeover write fence
        self._lease_prev_coord = np.full(self.G, np.int32(-1))
        # renewal requires recent MAJORITY contact, not just local belief:
        # a partitioned stale coordinator still names itself in its own
        # view forever, and without this gate it would keep serving local
        # reads while the majority side elects and writes
        self._last_heard = np.zeros(self.R, np.int64)  # slot -> last rx tick
        self._reads_local_c = _obs_registry().counter(
            "reads_local_total",
            help="reads answered locally under a valid lease (no consensus "
                 "round)", node=self._ov_node)
        self._reads_fallback_c = _obs_registry().counter(
            "reads_fallback_total",
            help="reads that fell back to a consensus round (no/invalid "
                 "lease or non-quiescent group)", node=self._ov_node)
        # ---- group-health plane (host-numpy Mode-B twin) ----
        # Mode A folds health on device; a per-process node mirrors the
        # same stall/churn/heat definitions over its completed-tick view
        # (queues + outstanding = backlog; own exec progress = activity;
        # coordinator-view handoffs = churn), so /health and the flight
        # transitions read the same either way.  OFF by default — the fold
        # is pure observation and adds one vectorized pass per tick.
        self._group_health = bool(cfg.paxos.group_health)
        self._health_topk = int(cfg.paxos.health_topk)
        self._health_wedge = int(cfg.paxos.health_wedge_ticks)
        self._health_shift = int(cfg.paxos.health_decay_shift)
        self._h_last_active = np.zeros(self.G, np.int64)
        self._h_churn = np.zeros(self.G, np.int32)  # Q4 fixed point
        self._h_heat = np.zeros(self.G, np.int32)   # Q4 fixed point
        self._h_view: Optional[dict] = None
        self._wedged_rows: set = set()
        #: optional FlightRecorder set by the serving layer (server.py)
        self.flight = None
        self._hg_backlog = _obs_registry().gauge(
            "health_backlogged_groups",
            help="groups with queued or outstanding work (health fold)",
            node=self._ov_node)
        self._hg_wedged = _obs_registry().gauge(
            "health_wedged_groups",
            help="backlogged groups with no exec progress for at least "
                 "health_wedge_ticks ticks", node=self._ov_node)
        self.lock = ContendedLock()
        # ---- device-resident application (models/device_kv.py) ----
        # The per-process deployment twin of Mode A's device_app
        # (PaxosManager.java:108-111 deployment shape): this node owns a
        # 1-replica-axis DeviceKVState; decisions of its OWN row execute
        # on device inside the fused node tick.
        self._device_app = bool(cfg.paxos.device_app)
        self.kv = None
        if self._device_app:
            from ..models.device_kv import DeviceKVApp, init_kv

            table = cfg.paxos.kv_table or (
                1 << max(16, (4 * self.G - 1).bit_length())
            )
            self.kv = init_kv(1, self.G, cfg.paxos.kv_slots, table,
                              device=self.device)
            self.app = DeviceKVApp(self, 0, row_of=self.rows.row)
            self._kv_reg_budget = cfg.paxos.kv_reg_budget or max(
                256, 2 * self.P * 16
            )
            #: parsed descriptors awaiting upload: (rid, op, key, val)
            self._kv_pending: collections.deque = collections.deque()
            self._kv_known: "collections.OrderedDict[int, bool]" = (
                collections.OrderedDict()
            )
            self._tick_device = node_tick_device(
                self.r, self._kv_reg_budget, cfg.paxos.fast_reelection
            )
        self._tick_packed = node_tick_packed(
            self.r, cfg.paxos.fast_reelection
        )
        # preallocated inbox staging (entries cleared lazily next build)
        self._in_req = np.zeros((self.R, self.P, self.G), np.int32)
        self._in_stp = np.zeros((self.R, self.P, self.G), bool)

        self.wal = wal
        if wal is not None:
            wal.attach(self)
        if messenger is not None:
            self.attach_messenger(messenger)

    def attach_messenger(self, messenger: Messenger) -> None:
        """Wire the transport endpoint.  Separate from __init__ so recovery
        can finish journal replay before any live traffic interleaves."""
        self.m = messenger
        d = self.m.demux
        prev = d.bytes_handler

        def on_bytes(sender: str, payload: bytes) -> None:
            self._heard(sender)
            if payload.startswith(wire.RELAY_MAGIC):
                self._on_relay(sender, payload)
            elif payload.startswith(wire.BATCH_MAGIC):
                # per-(peer, tick) container: split and journal/apply each
                # sub-frame individually, so WAL replay sees exactly the
                # records a singly-sent stream would have produced
                try:
                    subs = wire.decode_frames(payload)
                except (ValueError, struct.error):
                    self.stats["bad_frames"] += 1
                    return
                for sub in subs:
                    self._on_frame(sender, sub)
            elif payload.startswith(wire.MAGIC):
                self._on_frame(sender, payload)
            elif prev is not None:
                prev(sender, payload)

        d.bytes_handler = on_bytes

        def _reg(mtype, handler):
            def wrapped(sender, p, _h=handler):
                self._heard(sender)
                return _h(sender, p)
            self.m.register(mtype, wrapped)

        _reg(MB_PROPOSAL, self._on_proposal)
        _reg(MB_UNDIGEST, self._on_undigest)
        _reg(MB_UNDIGEST_REPLY, self._on_undigest_reply)
        _reg(MB_WHOIS, self._on_whois)
        _reg(MB_WHOIS_REPLY, self._on_whois_reply)
        _reg(MB_SYNC_REQ, self._on_sync_req)
        _reg(MB_CKPT_REQ, self._on_ckpt_req)
        _reg(MB_CKPT, self._on_ckpt)

    def _heard(self, sender: str) -> None:
        """Record peer contact for the lease renewal quorum gate."""
        try:
            s = self.members.index(sender)
        except ValueError:
            return
        if s >= self._last_heard.shape[0]:
            # universe expansion grew the membership past the array sized
            # at init — a new member's first frame must not raise here
            self._last_heard = np.concatenate([
                self._last_heard,
                np.zeros(s + 1 - self._last_heard.shape[0], np.int64)])
        self._last_heard[s] = self.tick_num

    # ------------------------------------------------------------------ admin
    def create_group(self, name: str, members: List[int], epoch: int = 0,
                     _log: bool = True) -> bool:
        """Open a group.  Must be invoked on every member node (the control
        plane's StartEpoch does exactly that); stragglers self-heal via
        whois when the first frame for an unknown gid arrives."""
        with self.lock:
            if name in self.rows or name in self._paused:
                return False
            if self.rows.full():
                # demand-page: evict the coldest quiescent group so the
                # per-process population can exceed the device rows
                if not self.pause_idle(limit=1, ignore_idle=True):
                    return False
            row = self.rows.alloc(name)
            mask = np.zeros((1, self.R), bool)
            for mm in members:
                mask[0, mm] = True
            self.state = st.create_groups(
                self.state, np.array([row], np.int32), mask,
                np.array([epoch], np.int32),
            )
            gid = wire.gid_of(name)
            self._gid_row[gid] = row
            self._row_meta[row] = (name, list(members), epoch)
            self._stopped_rows.discard(row)
            self._dirty[row] = True
            self._occupied[row] = True
            if _log and self.wal is not None:
                self.wal.log_create(name, list(members), epoch)
            return True

    def create_groups_bulk(self, names: List[str], members: List[int],
                           epoch: int = 0) -> int:
        """Batched create: one device call for the whole batch (the
        BatchedCreateServiceName shape at the data plane).  Returns how
        many were created; names already present / beyond capacity are
        skipped (capacity overflow spills via the single-create path)."""
        with self.lock:
            fresh = list(dict.fromkeys(  # order-preserving dedup
                n for n in names
                if n not in self.rows and n not in self._paused
            ))
            take = fresh[:self.rows.free_count()]
            rest = fresh[len(take):]
            if take:
                rows = np.array([self.rows.alloc(n) for n in take], np.int32)
                mask = np.zeros((len(take), self.R), bool)
                mask[:, members] = True
                self.state = st.create_groups(
                    self.state, rows, mask,
                    np.full(len(take), epoch, np.int32),
                )
                for n, row in zip(take, rows):
                    gid = wire.gid_of(n)
                    self._gid_row[gid] = int(row)
                    self._row_meta[int(row)] = (n, list(members), epoch)
                    self._stopped_rows.discard(int(row))
                    self._row_last_active[row] = self.tick_num
                self._dirty[rows] = True
                self._occupied[rows] = True
                if self.wal is not None:
                    # one fsync for the whole batch, not one per name
                    self.wal.log_creates(take, list(members), epoch)
            made = len(take)
        for n in rest:  # overflow: the spilling single-create path
            if self.create_group(n, list(members), epoch):
                made += 1
        return made

    def remove_group(self, name: str, _log: bool = True) -> bool:
        with self.lock:
            if name in self._paused:
                del self._paused[name]
                self._paused_gids.pop(wire.gid_of(name), None)
                if _log and self.wal is not None:
                    self.wal.log_remove(name)
                return True
            row = self.rows.row(name)
            if row is None:
                return False
            # complete a pipelined pending outbox before the row is freed
            # (and possibly recycled): its requeues/decisions must resolve
            # against the OLD name<->row mapping
            self.drain_pipeline()
            # fail still-outstanding requests of the dying group so their
            # rids can never be re-placed onto a future occupant of the row
            gone = [rid for rid, rec in self.outstanding.items()
                    if rec.row == row]
            for rid in gone:
                rec = self.outstanding.pop(rid)
                if rec.callback is not None and not rec.responded:
                    rec.responded = True
                    self._held_callbacks.append((rec.callback, rid, None))
            self.state = st.free_groups(self.state, np.array([row], np.int32))
            self._kv_clear_rows([row])
            self.rows.free(name)
            self._gid_row.pop(wire.gid_of(name), None)
            self._row_meta.pop(row, None)
            self._queues.pop(row, None)
            self._stalled.pop(row, None)
            self._stall_tick.pop(row, None)
            self._tainted_rows.discard(row)
            self._ckpt_tries.pop(row, None)
            self._stopped_rows.discard(row)
            self._occupied[row] = False
            self._dirty[row] = False
            self._purge_staged_row(row)
            if _log and self.wal is not None:
                self.wal.log_remove(name)
            return True

    # ------------------------------------------------------------ pause/spill
    def pause_idle(self, limit: int = 64, ignore_idle: bool = False) -> int:
        """Spill locally-quiescent idle groups (Deactivator analog).  Must
        hold the lock.  Safety: a row may only leave the device when no
        own-row fact could still matter — everything assigned is executed,
        no accepted pvalue sits above the execution watermark, and no
        prepare is in flight; peers' mirror rows of us keep serving reads
        of the past, and our coordinator ballot survives in the spilled
        record."""
        idle_after = 0 if ignore_idle else self.cfg.paxos.deactivation_ticks
        if not ignore_idle and idle_after <= 0:
            return 0
        self.drain_pipeline()
        r = self.r
        exec_s = st.to_host(self.state.exec_slot[r])
        next_s = st.to_host(self.state.next_slot[r])
        acc_top = st.to_host(self.state.acc_slot[r].amax(dim=0))  # [G]
        prop_any = st.to_host(self.state.prop_valid[r].any(dim=0))
        preparing = st.to_host(self.state.coord_preparing[r])
        # responded records are retransmission-dedup memory, not live work
        busy_rows = {rec.row for rec in self.outstanding.values()
                     if not rec.responded}
        cands = np.nonzero(
            self._occupied
            & (self.tick_num - self._row_last_active >= idle_after)
            # own assignments drained (non-coordinators carry next_slot 0)
            & (exec_s >= next_s) & (acc_top < exec_s)
            & ~prop_any & ~preparing
        )[0]
        # coldest first so eviction keeps the working set hot
        cands = sorted(cands, key=lambda rw: self._row_last_active[rw])
        names = []
        for row in cands:
            row = int(row)
            if len(names) >= limit:
                break
            if (self._queues.get(row) or row in busy_rows
                    or row in self._tainted_rows
                    or row in self._stalled):
                continue
            name = self.rows.name(row)
            if name is not None:
                names.append(name)
        if names:
            self._do_pause(names)
            if self.wal is not None:
                self.wal.log_pause(names)
        return len(names)

    def _kv_clear_rows(self, rows) -> None:
        """Scrub device-app KV rows on free: a recycled row must not leak
        the previous occupant's keys to the next group."""
        if self.kv is not None and len(rows):
            r = torch.as_tensor(np.asarray(rows, np.int64),
                                device=self.device)
            self.kv.key[:, r] = 0
            self.kv.val[:, r] = 0

    def _do_pause(self, names) -> None:
        """Spill exactly ``names`` (also the WAL replay entry point — must
        mirror the live run's choice so row allocation stays in lockstep)."""
        rows_to_free = []
        for name in names:
            row = self.rows.row(name)
            hri = st.extract_hri(self.state, row)
            hri["stopped"] = row in self._stopped_rows
            rec = {"hri": hri, "meta": self._row_meta[row]}
            if self.kv is not None:
                # device-app state is keyed by ROW — ride the spilled record
                rec["dkv_key"] = st.to_host(self.kv.key[0, row])
                rec["dkv_val"] = st.to_host(self.kv.val[0, row])
            self._paused[name] = rec
            gid = wire.gid_of(name)
            self._paused_gids[gid] = name
            self._gid_row.pop(gid, None)
            rows_to_free.append(row)
        self.state = st.free_groups(self.state,
                                    np.array(rows_to_free, np.int32))
        self._kv_clear_rows(rows_to_free)
        for name, row in zip(names, rows_to_free):
            self.rows.free(name)
            self._row_meta.pop(row, None)
            self._stopped_rows.discard(row)
            self._queues.pop(row, None)
            self._occupied[row] = False
            self._dirty[row] = False
            # staged mirror frames resolved their row indices at arrival:
            # a group recreated into this row must not inherit stale facts
            self._purge_staged_row(row)
        self.stats["paused"] += len(names)

    def _unpause(self, name: str):
        """Re-materialize a spilled group (getInstance -> unpause,
        PaxosManager.java:2370-2412).  Own-row scalars restore from the
        spilled record; peer mirrors start empty and refill from frames /
        anti-entropy.  Returns the row, or None (not paused / no room)."""
        rec = self._paused.get(name)
        if rec is None:
            return None
        if self.rows.full():
            if not self.pause_idle(limit=1, ignore_idle=True):
                return None  # every row is hot — genuinely full
        row = self.rows.alloc(name)
        hri = rec["hri"]
        mask = np.asarray(hri["member"]).reshape(1, -1)
        self.state = st.create_groups(
            self.state, np.array([row], np.int32), mask,
            np.array([hri["epoch"]], np.int32),
        )
        self.state = st.hot_restore(self.state, row, hri)
        if self.kv is not None and "dkv_key" in rec:
            self.kv.key[0, row] = torch.as_tensor(rec["dkv_key"],
                                                  device=self.device)
            self.kv.val[0, row] = torch.as_tensor(rec["dkv_val"],
                                                  device=self.device)
        gid = wire.gid_of(name)
        del self._paused[name]
        self._paused_gids.pop(gid, None)
        self._gid_row[gid] = row
        self._row_meta[row] = tuple(rec["meta"])
        if hri.get("stopped"):
            self._stopped_rows.add(row)
        self._occupied[row] = True
        self._dirty[row] = True  # announce our restored row to peers
        self._row_last_active[row] = self.tick_num
        self.stats["unpaused"] += 1
        if self.wal is not None:
            self.wal.log_unpause(name)
        return row

    def paused_count(self) -> int:
        return len(self._paused)

    def _pre_expand(self) -> None:
        self.drain_pipeline()  # pending outbox shapes change with R

    def _expand_state(self, n_new: int) -> None:
        self.state = st.expand_replica_slots(self.state, n_new)

    def _reset_intake_buffers(self) -> None:
        self._in_req = np.zeros((self.R, self.P, self.G), np.int32)
        self._in_stp = np.zeros((self.R, self.P, self.G), bool)

    def is_stopped(self, name: str) -> bool:
        row = self.rows.row(name)
        if row is None:
            rec = self._paused.get(name)
            return bool(rec and rec["hri"].get("stopped"))
        return row in self._stopped_rows

    def group_members(self, name: str):
        """Replica-slot members of a group (``getReplicaGroup`` analog,
        PaxosManager.java:561); None if unknown."""
        with self.lock:
            row = self.rows.row(name)
            if row is None:
                rec = self._paused.get(name)
                return list(rec["meta"][1]) if rec is not None else None
            meta = self._row_meta.get(row)
            return list(meta[1]) if meta is not None else None

    def group_epoch(self, name: str):
        with self.lock:
            row = self.rows.row(name)
            if row is None:
                rec = self._paused.get(name)
                return rec["meta"][2] if rec is not None else None
            meta = self._row_meta.get(row)
            return meta[2] if meta is not None else None

    def is_tainted(self, name: str) -> bool:
        """True when this node's app copy for ``name`` diverged (skipped a
        payload-less decision) and awaits checkpoint repair — it must not be
        trusted as a state donor."""
        with self.lock:
            row = self.rows.row(name)
            return row is not None and row in self._tainted_rows

    def mark_tainted(self, name: str) -> None:
        """Explicitly flag a row as not-authoritative (e.g. an epoch group
        born without its carried state because the previous epoch's final
        state was GC'd) — `_check_laggard` repairs it by checkpoint
        transfer from a caught-up peer.  Journaled: a crash must not
        resurrect the row untainted with its empty birth state."""
        with self.lock:
            row = self.rows.row(name)
            if row is not None:
                self._tainted_rows.add(row)
                if self.wal is not None and hasattr(self.wal, "log_taint"):
                    self.wal.log_taint(name)

    # ---------------------------------------------------------------- propose
    def propose(self, name: str, payload: bytes,
                callback: Optional[Callable[[int, Optional[bytes]], None]] = None,
                stop: bool = False, deadline: Optional[int] = None,
                cls: int = _overload.CLS_CONTROL) -> Optional[int]:
        """Lock-free fast path: stage the request for the next tick's drain
        (see paxos/manager.propose — the existence/fenced pre-checks are
        racy reads; the authoritative outcome rides the callback).

        ``deadline`` is the wire deadline in unix ms (0/None = none);
        expired work is dropped at drain with RID_EXPIRED.  ``cls`` is the
        traffic class: client-class proposes are subject to the intake
        governor's watermark shed (RID_BUSY), control-class never."""
        wal = self.wal
        _aw = getattr(wal, "accepting_writes", None)  # test stubs lack it
        if _aw is not None and not _aw():
            # storage low-watermark / failed WAL: shed with the retriable
            # failure convention (response None); reads keep serving
            wal.note_shed()
            self.stats["shed_requests"] += 1
            with self.lock:
                if callback is not None:
                    self._held_callbacks.append((callback, -1, None))
            return None
        if (cls != _overload.CLS_CONTROL and self.overload is not None
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
            # a racy negative re-checks under the lock before rejecting: a
            # recycled row can be visible in the row table before the old
            # occupant's stopped flag is discarded
            with self.lock:
                row = self.rows.row(name)
                if row is None and name in self._paused:
                    row = self._unpause(name)  # demand-page back in
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
        """Admit staged proposals (start of each tick, lock held)."""
        while True:
            try:
                (rid, name, payload, callback, stop,
                 deadline) = self._staged.popleft()
            except IndexError:
                return
            if _overload.expired(deadline):
                # deadline passed while staged: nobody is waiting — settle
                # with RID_EXPIRED (AR drops it silently, never responds)
                if callback is not None:
                    self._held_callbacks.append(
                        (callback, _overload.RID_EXPIRED, None))
                self.stats["expired_drops"] += 1
                _overload.count_expired("intake", self._ov_node)
                if self.reqtrace.enabled:
                    self.reqtrace.event(rid, "expired", name=name,
                                        node=self.node_id)
                continue
            row = self.rows.row(name)
            if row is None and name in self._paused:
                row = self._unpause(name)
            if row is None or row in self._stopped_rows:
                # the group vanished or stopped between stage and drain
                if callback is not None:
                    self._held_callbacks.append((callback, rid, None))
                if self.reqtrace.enabled:
                    self.reqtrace.event(rid, "failed", name=name,
                                        node=self.node_id)
                continue
            rec = ModeBRecord(rid, name, row, payload, stop, callback,
                              self.tick_num)
            self.outstanding[rid] = rec
            if self._device_app:
                self._kv_note(rid, payload)
            self._route(rec)

    def propose_stop(self, name: str, payload: bytes = b"", callback=None):
        return self.propose(name, payload, callback, stop=True)

    def _route(self, rec: ModeBRecord) -> None:
        """Queue locally if we are (or may become) the coordinator, else
        unicast the proposal to the current coordinator (handleProposal's
        forward, PaxosInstanceStateMachine.java:854-868)."""
        coord = int(self._coord_view[rec.row])
        if coord == self.r or coord < 0 or not self.alive[coord]:
            # no coordinator, us, or a dead one (failover in progress):
            # hold locally — placement happens once a live view emerges
            self._queues[rec.row].append(rec.rid)
        else:
            self._forward(rec, coord)

    def _forward(self, rec: ModeBRecord, coord: int) -> None:
        if self.m is None:
            self._queues[rec.row].append(rec.rid)  # replay: keep local
            return
        msg = {
            "type": MB_PROPOSAL,
            "rid": rec.rid,
            "gid": str(wire.gid_of(rec.name)),
            "stop": rec.stop,
        }
        if self._digest_accepts:
            # digest mode: the proposal to the coordinator is rid-only;
            # WE (the entry replica) broadcast the payload to every peer
            # on this tick's frames (PendingDigests' entry-replica
            # broadcast, PaxosInstanceStateMachine.java:1089-1102)
            self._extra_pay.append((rec.rid, rec.stop, rec.payload))
            if self.wal is not None:
                # non-digest replay re-learns a forwarded payload from the
                # coordinator's (journaled) frames; digest frames are
                # rid-only, so the entry's own journal is the ONLY durable
                # home of this payload — record it or replay stalls on it
                self.wal.log_payload(rec.rid, rec.payload, rec.stop)
        else:
            msg["payload"] = rec.payload.hex()
        self.m.send(self.members[coord], msg)
        self.stats["forwarded"] += 1
        if self.reqtrace.enabled:
            self.reqtrace.event(rec.rid, "forwarded",
                                to=self.members[coord])

    def _on_proposal(self, sender: str, p: dict) -> None:
        rid = int(p["rid"])
        gid = int(p["gid"])
        payload = bytes.fromhex(p["payload"]) if "payload" in p else None
        stop = bool(p.get("stop"))
        with self.lock:
            row = self._gid_row.get(gid)
            if row is None and gid in self._paused_gids:
                row = self._unpause(self._paused_gids[gid])
            if row is None:
                self._whois(gid, sender)
                return
            if rid in self.outstanding:
                return  # our own request; already routed locally
            # NOTE: "payload already known" must NOT suppress queueing — the
            # payload may have arrived via frame dissemination while the
            # explicit forward is the only thing that makes us PROPOSE it
            # (dedup on payloads would drop forwarded requests).
            # Retransmission dedup instead rides _routed: every rid we ever
            # queued for proposal, GC'd at the same depth as the payload
            # table (GCConcurrentHashMap of outstanding, PaxosManager.java:189).
            if payload is not None:
                self._store_payload(rid, payload, stop)
            else:
                # digest-only proposal: placement needs just rid + stop;
                # the payload arrives on the entry replica's frames
                self._digest_note(rid, stop)
            if not self._mark_routed(rid):
                return  # duplicate/late forward of a rid we already proposed
            if rid not in self._queues[row]:
                self._queues[row].append(rid)
        self._wake()

    def _digest_note(self, rid: int, stop: bool) -> None:
        self._digest_meta[rid] = stop
        while len(self._digest_meta) > self._payload_cap:
            self._digest_meta.popitem(last=False)

    # ------------------------------------------------- device-app descriptors
    def _store_payload(self, rid: int, payload: bytes, stop: bool) -> None:
        super()._store_payload(rid, payload, stop)
        if self._device_app:
            self._kv_note(rid, payload)

    def _kv_note(self, rid: int, payload: bytes) -> None:
        """Stage a request descriptor for upload inside the next fused tick
        (every payload choke point funnels here: own proposes, forwards,
        frame payload items, undigest fills, journal replay)."""
        if len(payload) != _DESC_LEN or rid in self._kv_known:
            return
        self._kv_known[rid] = True
        while len(self._kv_known) > self._payload_cap:
            self._kv_known.popitem(last=False)
        op, k, v = struct.unpack(_DESC, payload)
        self._kv_pending.append((rid, op, k, v))

    def _take_kv_reg(self):
        """Up to kv_reg_budget staged descriptors as fixed-size arrays
        (rid 0 = empty slot; leftovers stay queued)."""
        K = self._kv_reg_budget
        arrs = [np.zeros(K, np.int32) for _ in range(4)]
        n = min(K, len(self._kv_pending))
        for i in range(n):
            rid, op, k, v = self._kv_pending.popleft()
            arrs[0][i], arrs[1][i], arrs[2][i], arrs[3][i] = rid, op, k, v
        return arrs

    # ------------------------------------------------------------------- tick
    def tick(self):
        pc = self._pc
        pc.begin()
        if self.overload is not None:
            # feed the governor the client-work backlog: staged + queued +
            # unresponded outstanding (NOT pending_count — that adds driver
            # keep-ticking slop that would poison small watermarks)
            with self.lock:
                backlog = (len(self._staged)
                           + sum(len(q) for q in self._queues.values())
                           + sum(1 for rec in self.outstanding.values()
                                 if not rec.responded))
            self.overload.update(backlog)
        with self.lock:
            self._refresh_alive()
            self._flush_mirrors()
            if self._device_app and self._pending_out is not None:
                # complete the previous outbox BEFORE building this tick's
                # hold mask: a stall it discovers must suppress THIS device
                # step (pipelined hold built from stale _stalled would let
                # the device apply slot j+1 while slot j is payload-stalled)
                p = self._pending_out
                self._pending_out = None
                self._complete_tick(*p)
            pc.mark("ingress")
            inbox = self._build_inbox()
            placed = self._placed
            pc.mark("intake")
            # dispatch first, journal second: the WAL append+fsync overlaps
            # the asynchronous device step; responses stay held until
            # is_synced()
            if self._device_app:
                hold = np.zeros(self.G, bool)
                if self._stalled:
                    hold[list(self._stalled)] = True
                kv_reg = self._take_kv_reg()
                with serial_on_cpu(self.device):
                    self.state, self.kv, packed = self._tick_device(
                        self.state, self.kv, inbox, *kv_reg, hold,
                    )
            else:
                with serial_on_cpu(self.device):
                    self.state, packed = self._tick_packed(self.state,
                                                           inbox)
            pc.mark("dispatch")
            if self.wal is not None:
                self.wal.log_inbox(self.tick_num, self.alive)
            pc.mark("wal_fsync")
            self.tick_num += 1
            if self.cfg.paxos.pipeline_ticks:
                # stage-3 overlap: execute the PREVIOUS tick's decision
                # stream while the device computes this one
                if self._pending_out is not None:
                    p_out, p_placed, p_extras = self._pending_out
                    self._pending_out = None  # callbacks may re-enter a
                    # drain path; never double-process
                    self._complete_tick(p_out, p_placed, p_extras)
                pc.mark("execute")
                out, changed, extras = self._unpack_tick(packed)
                pc.mark("tally")
                self._pending_out = (out, placed, extras)
                self._dirty |= changed
                if self.wal is not None and self.wal.checkpoint_due():
                    # the snapshot's host metadata must cover every tick the
                    # device state contains — drain the one-tick pipeline
                    self.drain_pipeline()
            else:
                out, changed, extras = self._unpack_tick(packed)
                pc.mark("tally")
                self._dirty |= changed
                self._complete_tick(out, placed, extras)
                pc.mark("execute")
            if (self.cfg.paxos.deactivation_ticks > 0
                    and self.tick_num % 256 == 0 and len(self.rows) > 0):
                self.pause_idle()
            frames = self._build_frames()
            relay = self._build_relay()
            pc.mark("outbox_pack")
            if self.wal is not None:
                self.wal.maybe_checkpoint()
        if frames and self.m is not None:
            self.stats["frame_bytes_sent"] += sum(map(len, frames)) * (
                len(self.members) - 1
            )
            # the frame list is identical for every peer: pack it ONCE into
            # one contiguous container, so the whole per-(peer, tick)
            # fan-out is a single transport frame per peer (and the writer
            # drains it in a single writev)
            batch = (wire.encode_frames(frames) if len(frames) > 1
                     else frames[0])
            for i, peer in enumerate(self.members):
                if i != self.r:
                    try:
                        self.m.send_bytes(peer, batch)
                    except SendFailure:
                        # transport closing underneath a final tick — the
                        # anti-entropy full frame re-ships state anyway
                        self.stats["send_failures"] += 1
        pc.mark("egress")
        if relay is not None:
            # the dissemination half of the split: payload bytes leave on
            # exactly ONE downstream link, not R-1 (a slab lost to a crash
            # here is refetched via undigest — see _on_relay)
            dest, buf = relay
            self.stats["relay_bytes_sent"] += len(buf)
            self.stats["relay_frames_sent"] += 1
            try:
                self.m.send_bytes(dest, buf)
            except SendFailure:
                self.stats["send_failures"] += 1
        pc.mark("ring_relay")
        dec = self.stats["decisions"]
        if dec:
            self._egress_g.set(
                (self.stats["frame_bytes_sent"]
                 + self.stats["relay_bytes_sent"]) / dec
            )
        pc.end()
        return out

    def _build_inbox(self) -> TickInbox:
        self._drain_staged()
        req, stp = self._in_req, self._in_stp
        for _row, take in self._placed:
            for _rid, p in take:
                req[self.r, p, _row] = 0
                stp[self.r, p, _row] = False
        placed = []
        for row, q in self._queues.items():
            coord = int(self._coord_view[row])
            if (coord >= 0 and coord != self.r and self.alive[coord]
                    and self.m is not None):
                # coordinator is elsewhere: forward everything queued here
                while q:
                    rid = q.popleft()
                    rec = self.outstanding.get(rid)
                    if rec is not None:
                        self._forward(rec, coord)
                    elif rid in self.payloads:
                        name = self.rows.name(row)
                        if name is None:
                            continue  # group freed underneath: drop the rid
                            # rather than forward under a bogus gid
                        payload, stop = self.payloads[rid]
                        self.m.send(self.members[coord], {
                            "type": MB_PROPOSAL, "rid": rid,
                            "gid": str(wire.gid_of(name)),
                            "payload": payload.hex(), "stop": stop,
                        })
                continue
            if (self._read_leases
                    and self.tick_num < int(self._lease_fence[row])):
                # takeover write fence: a freshly-won row's
                # proposals stay queued until the prior holder's lease has
                # provably run out — delay, never refusal (the fence only
                # gates NEW intake; journal-replayed inboxes are immune)
                continue
            take = []
            p = 0
            while q and p < self.P:
                rid = q.popleft()
                rec = self.outstanding.get(rid)
                if rec is not None:
                    stop = rec.stop
                elif rid in self.payloads:
                    stop = self.payloads[rid][1]
                elif rid in self._digest_meta:
                    # digest-only proposal: place the rid now — the accept
                    # rings are rid-only anyway; execution stalls on the
                    # payload if it has not arrived by commit time
                    stop = self._digest_meta[rid]
                else:
                    continue
                req[self.r, p, row] = rid
                stp[self.r, p, row] = stop
                take.append((rid, p))
                p += 1
            if take:
                placed.append((row, take))
                self._row_last_active[row] = self.tick_num
        self._placed = placed
        # device copies (the staging buffers are mutated next build; on the
        # CPU a tensor made from numpy would alias them)
        return TickInbox(self._on_device(req), self._on_device(stp),
                         self._on_device(self.alive))

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        if self.device.type == "cpu":
            return torch.from_numpy(a.copy())
        return torch.as_tensor(a, device=self.device)

    def _unpack_tick(self, packed):
        """-> (outbox, changed, extras) where extras is None (host app) or
        (resp[W, G], row_skip[G]) from the fused device-app tick."""
        if self._device_app:
            out, changed, resp, row_skip = unpack_node_tick_device(
                packed, self.R, self.P, self.W, self.G
            )
            return out, changed, (resp, row_skip)
        out, changed = unpack_node_tick(
            packed, self.R, self.P, self.W, self.G
        )
        return out, changed, None

    def _complete_tick(self, out, placed: list, extras=None) -> None:
        """Consume one tick's outbox: requeue rejected intake, execute the
        decision stream, release durable callbacks, periodic repair/GC."""
        self._process_outbox(out, placed, extras)
        self._drain_stalled()
        self._flush_callbacks()
        if self.tick_num % 16 == 0 or self._tainted_rows:
            self._check_laggard(out)
        if self.tick_num % 64 == 0:
            self._sweep()

    def drain_pipeline(self) -> None:
        """Synchronously finish the pending pipelined outbox."""
        with self.lock:
            if self._pending_out is not None:
                p_out, p_placed, p_extras = self._pending_out
                self._pending_out = None
                self._complete_tick(p_out, p_placed, p_extras)

    def _process_outbox(self, out, placed=None, extras=None) -> None:
        if self._read_leases:
            self._lease_fold(np.asarray(out.coord_id))
        if self._group_health:
            # before _coord_view adopts the new view, so handoff detection
            # still sees the previous tick's coordinators
            self._health_fold(out)
        self._coord_view = out.coord_id
        taken = out.intake_taken[self.r]  # [P, G]
        for row, take in (self._placed if placed is None else placed):
            # intake only really happened if WE were the winning coordinator;
            # a write into a peer's mirror ring was discarded by the kernel
            ours = int(self._coord_view[row]) == self.r
            for rid, p in reversed(take):
                if not (ours and taken[p, row]):
                    self._queues[row].appendleft(rid)
        er = out.exec_req[self.r]      # [W, G]
        es = out.exec_stop[self.r]
        eb = out.exec_base[self.r]     # [G]
        ec = out.exec_count[self.r]    # [G]
        resp = row_skip = None
        if extras is not None:
            resp, row_skip = extras
        for row in np.nonzero(ec)[0]:
            name = self.rows.name(int(row))
            if name is None:
                continue
            # device fast path: this row's decisions executed ON DEVICE
            # inside the fused tick (no miss, no hold) — only response /
            # dedup / stop bookkeeping runs host-side.  Skipped rows (any
            # descriptor miss, or stalled) had NO device effect and route
            # through the scalar _execute_one path in ring order.
            fast = (resp is not None and not row_skip[row]
                    and int(row) not in self._stalled)
            for j in range(int(ec[row])):
                r_bytes = None
                if fast and er[j, row] != NO_REQUEST:
                    r_bytes = struct.pack("<i", int(resp[j, row]))
                self._execute_one(int(row), name, int(er[j, row]),
                                  int(eb[row]) + j, bool(es[j, row]),
                                  response=r_bytes)
        self.stats["decisions"] += int(np.asarray(out.decided_now).sum())

    def _lease_fold(self, coord: np.ndarray) -> None:
        """Tick-denominated lease bookkeeping over the completed tick's
        coordinator view (runs before _coord_view adopts it, so the
        PREVIOUS view is still visible for takeover detection).

        Renewal: while we remain a row's winning coordinator, holdership
        extends to (majority-contact time) + horizon, where the contact
        time is the freshest tick at which a MAJORITY of the row's
        members (self included) had been heard from.  Anchoring at the
        evidence rather than local now is the classic lease discipline:
        a connected coordinator's lease never lapses, while a partitioned
        one's expires exactly one horizon after it last held a quorum —
        even though its own view still names it coordinator — which is
        strictly before a successor's horizon+margin takeover fence ends.

        Takeover: a row whose coordinatorship moved TO us is write-fenced
        for horizon+margin ticks.  The fence applies even when the prior
        view is unknown (prev == -1: bootstrap election, WAL recovery,
        whois late-join) — a node cannot locally distinguish group birth
        from missed history, and an unfenced post-recovery takeover would
        admit writes while the real prior holder still serves reads.
        Write delay at genuine birth is the price of that safety."""
        now = self.tick_num
        ours = coord == self.r
        if ours.any():
            heard = self._last_heard.copy()
            if self.r >= heard.shape[0]:  # post-expansion membership growth
                heard = np.concatenate([
                    heard, np.zeros(self.r + 1 - heard.shape[0], np.int64)])
            heard[self.r] = now
            for row in np.nonzero(ours)[0]:
                meta = self._row_meta.get(int(row))
                if meta is None:
                    continue
                members = list(meta[1])
                k = len(members) // 2 + 1
                t_q = sorted(
                    (int(heard[s]) if s < heard.shape[0] else 0
                     for s in members), reverse=True)[k - 1]
                self._lease_until[row] = t_q + self._lease_horizon
        took = ours & (self._lease_prev_coord != self.r)
        if took.any():
            self._lease_fence[took] = np.maximum(
                self._lease_fence[took],
                now + self._lease_horizon + self._lease_margin)
        self._lease_prev_coord = coord.astype(np.int32, copy=True)

    def _health_fold(self, out) -> None:
        """Host-numpy twin of the Mode-A device health fold:
        same stall/churn/heat definitions over the completed tick's
        outbox.  Backlog = queued intake or placed-but-unresponded work;
        activity = our own exec progress (or no backlog at all); churn
        counts coordinator handoffs in the pre-adoption view as a
        shift-decayed Q4 EWMA, exactly like the device fold."""
        now = self.tick_num
        coord = np.asarray(out.coord_id)
        prev = self._coord_view
        backlog = np.zeros(self.G, bool)
        for row, q in self._queues.items():
            if q and row < self.G:
                backlog[row] = True
        for rec in self.outstanding.values():
            if rec.row < self.G:
                backlog[rec.row] = True
        progress = np.asarray(out.exec_count[self.r]) > 0
        self._h_last_active[progress | ~backlog] = now
        handoff = (coord >= 0) & (prev >= 0) & (coord != prev)
        sh = self._health_shift
        self._h_churn += (handoff.astype(np.int32) << 4) - \
            (self._h_churn >> sh)
        taken = np.asarray(out.intake_taken[self.r])  # [P, G]
        self._h_heat += (taken.sum(axis=0, dtype=np.int32) << 4) - \
            (self._h_heat >> sh)
        stall = np.where(backlog, now - self._h_last_active, 0)
        wedged_mask = backlog & (stall >= self._health_wedge)
        K = min(self._health_topk, self.G)
        top = np.argsort(-stall, kind="stable")[:K]
        stall_by_row = {int(r): int(stall[r]) for r in top if stall[r] > 0}
        wedged_now = {r for r, v in stall_by_row.items()
                      if v >= self._health_wedge}
        self._hg_backlog.set(int(backlog.sum()))
        self._hg_wedged.set(int(wedged_mask.sum()))
        if self.flight is not None:
            for r in sorted(wedged_now - self._wedged_rows):
                self.flight.record("group_wedged", {
                    "row": r, "name": self.rows.name(r),
                    "stall_ticks": stall_by_row[r], "tick": now})
            for r in sorted(self._wedged_rows - wedged_now):
                self.flight.record("group_recovered", {
                    "row": r, "name": self.rows.name(r), "tick": now})
        self._wedged_rows = wedged_now

        def _top_list(vals):
            idx = np.argsort(-vals, kind="stable")[:K]
            return [{"row": int(r), "name": self.rows.name(int(r)),
                     "value": float(vals[r])}
                    for r in idx if vals[r] > 0]

        self._h_view = {
            "clock": int(now),
            "allocated": len(self.rows),
            "backlogged": int(backlog.sum()),
            "wedged": int(wedged_mask.sum()),
            "max_stall_ticks": int(stall.max()) if self.G else 0,
            "max_churn": float(self._h_churn.max()) / 16.0 if self.G else 0,
            "wedge_ticks": self._health_wedge,
            "top_stuck": _top_list(stall),
            "top_churny": _top_list(self._h_churn / 16.0),
            "top_hot": _top_list(self._h_heat / 16.0),
        }

    def health_snapshot(self) -> Optional[dict]:
        """JSON view of the last completed tick's health fold (the
        ``/health`` route body; None when the fold is off)."""
        return self._h_view

    def group_info(self, name: str) -> Optional[dict]:
        """Single-group drill-down, Mode-B flavor: this node's row view
        (coordinator, pending intake, lease fence/holdership, health
        columns) — the per-process analog of PaxosManager.group_info."""
        row = self.rows.row(name)
        if row is None and "#" not in name:
            best = None  # bare service name -> highest resident epoch
            for pname in self.rows.names():
                base, sep, etxt = pname.rpartition("#")
                if base == name and sep and etxt.isdigit():
                    if best is None or int(etxt) > best:
                        best = int(etxt)
            if best is not None:
                name = f"{name}#{best}"
                row = self.rows.row(name)
        if row is None:
            return None
        meta = self._row_meta.get(int(row))
        info = {
            "name": name,
            "row": int(row),
            "mode": "log",
            "members": (list(meta[1]) if meta is not None else None),
            "epoch": (int(meta[2]) if meta is not None else None),
            "coordinator": int(self._coord_view[row]),
            "pending_intake": len(self._queues.get(row) or ()),
            "tick": int(self.tick_num),
        }
        if self._read_leases:
            info["lease"] = {
                "until": int(self._lease_until[row]),
                "fence": int(self._lease_fence[row]),
                "holder": (self.r if self.tick_num
                           < int(self._lease_until[row]) else -1),
            }
        if self._group_health:
            info["health"] = {
                "stall_ticks": int(self.tick_num
                                   - self._h_last_active[row]),
                "churn": float(self._h_churn[row]) / 16.0,
                "heat": float(self._h_heat[row]) / 16.0,
            }
        if self.wal is not None and hasattr(self.wal, "tail_for_row"):
            try:
                info["wal_tail"] = self.wal.tail_for_row(int(row), name)
            except Exception:
                info["wal_tail"] = None
        return info

    def read(
        self,
        name: str,
        payload: bytes = b"",
        callback: Optional[Callable[[int, Optional[bytes]], None]] = None,
        deadline: Optional[int] = None,
    ) -> Optional[int]:
        """Linearizable read (Mode-B twin of
        paxos/manager.read).  Local iff we hold the row's lease (winning
        coordinator within the renewal horizon, past any takeover fence)
        AND the row is quiescent at us: nothing queued or stalled and our
        executed frontier equals our assignment frontier, so every acked
        write is already applied locally.  Otherwise the read rides a
        CLS_READ propose through the ordered stream.  ``payload`` must be
        side-effect-free under the app; local reads use rid 0 and fire
        the callback synchronously."""
        if deadline is not None and _overload.expired(deadline):
            _overload.count_expired("intake", self._ov_node)
            if callback is not None:
                callback(_overload.RID_EXPIRED, None)
            return None
        row = self.rows.row(name)
        if (self._read_leases and row is not None
                and row not in self._stopped_rows
                and row not in self._stalled
                and int(self._coord_view[row]) == self.r
                and self.tick_num < int(self._lease_until[row])
                and self.tick_num >= int(self._lease_fence[row])
                and not self._queues.get(row)
                and int(self.state.next_slot[self.r, row])
                == int(self.state.exec_slot[self.r, row])):
            resp = self.app.execute(name, payload, 0)
            self._reads_local_c.inc()
            self.stats["local_reads"] += 1
            if callback is not None:
                callback(0, resp)
            return 0
        self._reads_fallback_c.inc()
        return self.propose(name, payload, callback, deadline=deadline,
                            cls=_overload.CLS_READ)

    def _execute_one(self, row: int, name: str, rid: int, slot: int,
                     is_stop: bool, response: Optional[bytes] = None) -> None:
        if row in self._stalled:
            # an earlier slot of this row is waiting on its payload: every
            # later decision buffers behind it — RSM order is absolute
            # (device-app fast-path rows never reach here: the tick's hold
            # mask suppressed their on-device execution)
            self._stalled[row].append((name, rid, slot, is_stop))
            return
        self._execute_direct(row, name, rid, slot, is_stop, response)

    def _execute_direct(self, row: int, name: str, rid: int, slot: int,
                        is_stop: bool,
                        response: Optional[bytes] = None) -> None:
        self._row_last_active[row] = self.tick_num
        if is_stop and row not in self._stopped_rows:
            self._stopped_rows.add(row)
            q = self._queues.pop(row, None)
            for qrid in (q or ()):
                rec = self.outstanding.get(qrid)
                if rec is not None and rec.callback and not rec.responded:
                    rec.responded = True
                    self._held_callbacks.append((rec.callback, qrid, None))
        if rid == NO_REQUEST:
            self.stats["noops"] += 1
            return
        seen = self._seen[row]
        if rid in seen:
            self.stats["dup_commits"] += 1
            return
        seen[rid] = slot
        while len(seen) > self._seen_cap:
            seen.popitem(last=False)
        rec = self.outstanding.get(rid)
        if response is not None:
            # device-app fast path: the decision already executed ON DEVICE
            # inside the fused tick; only the response surfaces here
            self.stats["executions"] += 1
            if self.reqtrace.enabled:
                self.reqtrace.event(rid, "executed", slot=slot,
                                    node=self.node_id)
            if rec is not None and not rec.responded:
                rec.responded = True
                if rec.callback is not None:
                    self._held_callbacks.append((rec.callback, rid, response))
                if self.reqtrace.enabled:
                    self.reqtrace.event(rid, "responded", node=self.node_id)
            return
        if rec is not None:
            payload, _ = rec.payload, rec.stop
        elif rid in self.payloads:
            payload = self.payloads[rid][0]
        elif self._digest_accepts or self._device_app:
            # digest mode: a decision routinely commits before its payload
            # arrives — HOLD this row's execution stream and fetch the
            # payload (the PendingDigests match/undigest protocol,
            # PaxosInstanceStateMachine.java:1089-1102, 1257-1268).  The
            # app state is NOT diverged; it is merely behind (_undigest
            # no-ops without a transport; a stall that never drains times
            # out into taint).
            seen.pop(rid, None)  # the drain re-enters the full path
            q = collections.deque()
            q.append((name, rid, slot, is_stop))
            self._stalled[row] = q
            self._stall_tick[row] = self.tick_num
            self.stats["stalled_rows"] += 1
            if not self._ring_grace(rid):
                self._undigest(rid, row)
            return
        else:
            # payload never seen (GC'd or dropped with a dead peer's
            # backlog): the slot was skipped, so our app copy has DIVERGED
            # — taint the row; a checkpoint transfer from an untainted
            # donor repairs it (execute-retry-forever is the reference's
            # answer, PaxosInstanceStateMachine.java:1829-1839; ours is
            # repair-by-StatePacket since the payload is gone)
            self.stats["orphan_execs"] += 1
            self._tainted_rows.add(row)
            return
        response = self.app.execute(name, payload, rid)
        self.stats["executions"] += 1
        if self.reqtrace.enabled:
            self.reqtrace.event(rid, "executed", slot=slot,
                                node=self.node_id)
        if rec is not None and not rec.responded:
            rec.responded = True
            if rec.callback is not None:
                self._held_callbacks.append((rec.callback, rid, response))
            if self.reqtrace.enabled:
                self.reqtrace.event(rid, "responded", node=self.node_id)

    # --------------------------------------------- digest stall / undigest
    def _drain_stalled(self) -> None:
        """Release stalled rows whose head payload has arrived (in slot
        order); re-fetch or give up (taint + checkpoint repair) on the
        rest.  Runs once per completed tick."""
        if not self._stalled:
            return
        for row in list(self._stalled):
            q = self._stalled.pop(row)
            t0 = self._stall_tick.pop(row)
            progressed = False
            while q:
                name, rid, slot, is_stop = q[0]
                if not (rid == NO_REQUEST or rid in self.outstanding
                        or rid in self.payloads):
                    break
                q.popleft()
                # payload verified present and the row is no longer in
                # _stalled, so this cannot re-stall or re-buffer
                self._execute_direct(row, name, rid, slot, is_stop)
                progressed = True
            if not q:
                self.stats["stalls_drained"] += 1
                continue
            head_rid = q[0][1]
            age = self.tick_num - t0
            if not progressed and (
                age > self.cfg.paxos.undigest_timeout_ticks
                or len(q) > 8 * self.W
            ):
                # unrecoverable (origin died before anyone learned the
                # payload): fall back to divergence repair by checkpoint
                # transfer
                self.stats["orphan_execs"] += len(q)
                self._tainted_rows.add(row)
                continue
            self._stalled[row] = q
            self._stall_tick[row] = self.tick_num if progressed else t0
            if age <= self.R and self._ring_grace(head_rid):
                # bytes are (at most R-1 hops) in flight on the ring; let
                # them land before burning an undigest round trip
                continue
            self._undigest(head_rid, row)

    def _ring_grace(self, rid: int) -> bool:
        """True while a missing payload should still be EXPECTED from the
        dissemination ring: ring mode is on and the rid's origin is alive,
        so its slab is (at most R-1 hops) in flight.  Suppresses the
        undigest fetch during a fresh stall — the fallback must not race
        bytes the ring is already carrying.  A dead origin (stranded slab)
        disables the grace and the fetch fires immediately."""
        o = rid_origin(rid)
        return (self._ring_dissemination and 0 <= o < self.R
                and o != self.r and bool(self.alive[o]))

    def _undigest(self, rid: int, row: int) -> None:
        """Fetch a committed-but-unseen payload: ask the rid's ORIGIN node
        (encoded in the rid's high bits — it broadcast the payload and
        keeps it in `outstanding`), falling back to the coordinator, then
        any live peer.  Rate-limited per rid."""
        if self.m is None:
            return
        last, tries = self._undigest_asked.get(rid, (-(1 << 30), 0))
        if self.tick_num - last < 8:
            return
        self._undigest_asked[rid] = (self.tick_num, tries + 1)
        while len(self._undigest_asked) > self._payload_cap:
            self._undigest_asked.popitem(last=False)
        origin = rid_origin(rid)
        cands = [origin, int(self._coord_view[row])] + list(range(self.R))
        live = []
        for t in cands:
            if 0 <= t < self.R and t != self.r and self.alive[t] \
                    and t not in live:
                live.append(t)
        if not live:
            return
        # rotate across retries: an ALIVE origin that GC'd the payload must
        # not absorb every ask while a peer still holds it
        t = live[tries % len(live)]
        self.m.send(self.members[t], {"type": MB_UNDIGEST, "rid": rid})
        self.stats["undigest_reqs"] += 1

    def _on_undigest(self, sender: str, p: dict) -> None:
        rid = int(p["rid"])
        with self.lock:
            rec = self.outstanding.get(rid)
            if rec is not None:
                pl, stop = rec.payload, rec.stop
            elif rid in self.payloads:
                pl, stop = self.payloads[rid]
            else:
                return  # never saw it; the asker tries other peers
        self.m.send(sender, {"type": MB_UNDIGEST_REPLY, "rid": rid,
                             "payload": pl.hex(), "stop": stop})

    def _on_undigest_reply(self, sender: str, p: dict) -> None:
        rid = int(p["rid"])
        pl = bytes.fromhex(p["payload"])
        stop = bool(p.get("stop"))
        with self.lock:
            if rid not in self.outstanding and rid not in self.payloads:
                self._store_payload(rid, pl, stop)
                self.stats["undigest_fills"] += 1
                if self.wal is not None:
                    # out-of-band payload arrival mutates what replay can
                    # execute — journal it like a frame payload
                    self.wal.log_payload(rid, pl, stop)
        self._wake()

    def _sweep(self) -> None:
        gone = []
        for rid, rec in self.outstanding.items():
            age = self.tick_num - rec.born_tick
            if rec.responded:
                if age > 4096:
                    gone.append(rid)
            elif age > 64 and rec.row not in self._stopped_rows:
                # a forwarded proposal may have died with its coordinator:
                # re-route through the current view (the retransmit duty the
                # reference gives JSONMessenger's backoff + CommitWorker)
                rec.born_tick = self.tick_num
                if rid not in self._queues[rec.row]:
                    self._route(rec)
                self.stats["rerouted"] += 1
        for rid in gone:
            del self.outstanding[rid]

    # ------------------------------------------------------------ frames (tx)
    def _row_wire_bytes(self) -> int:
        """Encoded bytes one group row contributes to a frame."""
        return (8 + 4 * len(wire.SCALARS) + 4                  # gid+scalars+flags
                + 4 * self.W * len(wire.RINGS)                 # i32 rings
                + 4 * len(wire.RING_BITS))                     # W bits -> i32

    def _build_frames(self) -> List[bytes]:
        """Fragmented replica frames for this tick (the shared selection /
        chunking loop lives in ModeBCommon; this flavor contributes the
        fused device gather of the paxos frame columns + the wire schema)."""
        def extract(chunk_rows):
            # one gather + one transfer for all ~21 frame fields, not a
            # dispatch and a sync per field
            n = len(chunk_rows)
            K = max(16, 1 << max(0, int(n - 1).bit_length()))
            rpad = np.zeros(K, np.int32)
            rpad[:n] = chunk_rows
            flat = frame_extract(self.r, K)(
                self.state, torch.as_tensor(rpad, device=self.device))
            return unpack_frame_extract(flat, n, K, self.W)

        def encode(chunk_gids, fields, chunk_pay, full):
            scalars, flags, rings, ring_bits = fields
            return wire.encode_frame(
                self.r, self.tick_num, self.W, chunk_gids, scalars, flags,
                rings, ring_bits, chunk_pay, full=full,
            )

        return self._build_frames_common(
            self._row_wire_bytes(), extract, encode
        )

    # ------------------------------------------------------------- ring relay
    def _mark_relayed(self, rid: int) -> bool:
        """First relay sighting of a rid here; False on a repeat (breaks
        relay cycles when alive views diverge mid-crash: a slab that laps
        the ring dies at the first node that already forwarded it)."""
        if rid in self._relay_seen:
            return False
        self._relay_seen[rid] = True
        while len(self._relay_seen) > self._payload_cap:
            self._relay_seen.popitem(last=False)
        return True

    def _build_relay(self):
        """Assemble this tick's downstream relay slab (lock held): the
        node's own newly-entered payloads plus every upstream slab staged
        by ``_on_relay``.  One frame to the next ALIVE member clockwise —
        dissemination costs each node one payload-sized downstream link
        per tick regardless of R, the HT-Ring egress shape."""
        if not self._ring_dissemination or self.m is None:
            return None
        if not self._ring_out and not self._relay_fwd:
            return None
        d = ring_downstream(self.alive, self.r)
        if d < 0:
            return None  # no live downstream: stay staged for later ticks
        groups = []
        own, self._ring_out = self._ring_out, []
        if own:
            groups.append(wire.relay_group(own))
        fwd, self._relay_fwd = self._relay_fwd, []
        for slab, pre in fwd:
            # the downstream drop rule: an item never travels INTO its
            # origin, so each payload crosses exactly R-1 links — once per
            # link, never twice over any of them
            keep = pre & ((slab.rids >> RID_SHIFT) != d)
            if keep.any():
                groups.append(wire.slab_keep(slab, keep))
        if not groups:
            return None
        buf = wire.encode_relay(self.r, self.tick_num, time.time(), groups)
        return self.members[d], buf

    def _on_relay(self, sender: str, payload: bytes) -> None:
        """Upstream relay slab: adopt+journal unseen payloads, stage the
        (masked) slab for the downstream hop.  A slab lost to a crash
        between here and downstream is NOT retransmitted — receivers that
        commit a rid without its payload refetch via the undigest path,
        and anti-entropy repairs the stragglers."""
        try:
            slab = wire.decode_relay(payload)
        except (ValueError, struct.error):
            self.stats["bad_frames"] += 1
            return
        if slab.sent_s > 0:
            self._ring_hop_h.observe(max(0.0, time.time() - slab.sent_s))
        with self.lock:
            self.stats["relay_frames_rcvd"] += 1
            rids = slab.rids
            self.bump_seq(rids)
            n = len(rids)
            fresh = np.fromiter(
                (self._mark_relayed(rid) for rid in rids.tolist()), bool, n
            )
            offs, stops = slab.offs, slab.stops.tolist()
            for i, rid in enumerate(rids.tolist()):
                if not fresh[i] or rid in self.payloads:
                    continue
                body = bytes(slab.blob[int(offs[i]): int(offs[i + 1])])
                self._store_payload(rid, body, bool(stops[i]))
                self.stats["relay_payloads"] += 1
                if self.wal is not None:
                    # journaled like an undigest fill so WAL replay of a
                    # ring deployment stays bit-identical (OP_PAYLOAD)
                    self.wal.log_payload(rid, body, bool(stops[i]))
            pre = fresh & ((rids >> RID_SHIFT) != self.r)
            if pre.any():
                self._relay_fwd.append((slab, pre))
        self._wake()

    # ------------------------------------------------------------ frames (rx)
    def _on_frame(self, sender: str, payload: bytes) -> None:
        try:
            frame = wire.decode_frame(payload)
        except (ValueError, IndexError, struct.error):
            self.stats["bad_frames"] += 1
            return
        with self.lock:
            if self.wal is not None:
                self.wal.log_frame(payload)
            self._apply_frame(frame, sender)
        self._wake()

    def _apply_frame(self, frame: wire.Frame, sender: str = "?") -> None:
        """Stage one decoded frame: payload/bookkeeping now, mirror writes
        deferred to the once-per-tick fused apply (``_flush_mirrors``) —
        frames arriving between ticks cost numpy work only, never a device
        dispatch (~20 scatters per frame on the node lock's hot path)."""
        sr = frame.sender_r
        if sr == self.r or not (0 <= sr < self.R) or frame.W != self.W:
            return
        last = self._frame_applied_tick.get(sr, -1)
        if frame.tick < last:
            return  # reordered stale frame (reconnect replay)
        self._frame_applied_tick[sr] = frame.tick
        self._last_frame_rx = self.tick_num
        for rid, stop, data in frame.payloads:
            self.bump_seq(np.array([rid]))
            if rid not in self.outstanding:
                self._store_payload(rid, data, stop)
        for f in ("acc_req", "dec_req", "prop_req"):
            self.bump_seq(frame.rings[f])
        n = len(frame.gids)
        if n == 0:
            return
        rows = np.full(n, -1, np.int64)
        unknown = []
        for i in range(n):
            gid = int(frame.gids[i])
            row = self._gid_row.get(gid)
            if row is None and gid in self._paused_gids:
                # peer traffic for a spilled group demand-pages it back
                row = self._unpause(self._paused_gids[gid])
            if row is None:
                unknown.append(gid)
            else:
                rows[i] = row
        if unknown and sender != "?":
            for gid in unknown[:16]:
                self._whois(gid, sender)
        sel = rows >= 0
        if not sel.any():
            return
        keep = np.nonzero(sel)[0]
        self._row_last_active[rows[sel]] = self.tick_num  # peer activity
        self._pending_mirror.append((sr, rows[sel], keep, frame))
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
            scal = np.stack([frame.scalars[f][keep] for f in wire.SCALARS])
            rings = np.stack([frame.rings[f][keep] for f in wire.RINGS])
            bits = np.stack([frame.ring_bits[f][keep]
                             for f in wire.RING_BITS])
            self.state = mirror_apply(self.state, sr, rows, scal,
                                      frame.flags[keep], rings, bits)
            self.stats["frames_applied"] += 1

    # ------------------------------------------------- missed birthing (whois)
    def _whois(self, gid: int, ask: str) -> None:
        if gid in self._pending_whois or self.m is None:
            return
        self._pending_whois.add(gid)
        self.m.send(ask, {"type": MB_WHOIS, "gid": str(gid)})

    def _on_whois(self, sender: str, p: dict) -> None:
        gid = int(p["gid"])
        with self.lock:
            row = self._gid_row.get(gid)
            if row is None and gid in self._paused_gids:
                row = self._unpause(self._paused_gids[gid])
            if row is None:
                return
            name, members, epoch = self._row_meta[row]
            self._dirty[row] = True  # resend its state next frame
        self.m.send(sender, {
            "type": MB_WHOIS_REPLY, "gid": str(gid), "name": name,
            "members": members, "epoch": epoch,
        })

    def _on_whois_reply(self, sender: str, p: dict) -> None:
        with self.lock:
            self._pending_whois.discard(int(p["gid"]))
            if self.whois_birth is not None and not self.whois_birth(p["name"]):
                # the control plane births this group (with proper state
                # seeding); until then the group runs on the other members
                self.stats["whois_birth_filtered"] += 1
                return
            self.create_group(p["name"], [int(x) for x in p["members"]],
                              int(p["epoch"]))

    def _on_sync_req(self, sender: str, p: dict) -> None:
        with self.lock:
            self._force_full = True

    # ------------------------------------------ checkpoint transfer (laggard)
    def _check_laggard(self, out) -> None:
        """When our own row trails the mirror maximum by >= W, ring sync can
        never catch up — fetch an app checkpoint from the most advanced live
        peer (StatePacket/handleCheckpoint analog,
        PaxosInstanceStateMachine.java:1852-1861)."""
        if self.m is None:
            return
        lag = np.asarray(out.lag[self.r])  # [G]
        need = set(int(x) for x in np.nonzero(lag >= self.W)[0][:16])
        need |= set(list(self._tainted_rows)[:16])
        if not need:
            return
        exec_all = st.to_host(self.state.exec_slot)  # one transfer
        for row in need:
            name = self.rows.name(int(row))
            if name is None:
                self._tainted_rows.discard(row)
                continue
            ex = exec_all[:, int(row)]
            # only the group's MEMBERS can donate (a non-member's
            # _gid_row lookup silently drops the request)
            meta = self._row_meta.get(int(row))
            members = meta[1] if meta else range(self.R)
            donors = [i for i in members
                      if i != self.r and 0 <= i < self.R and self.alive[i]]
            if not donors:
                continue
            # best watermark first, but ROTATE across retries: with tied
            # (e.g. all-zero mirror) watermarks a fixed pick can hammer a
            # peer that refuses to donate (itself tainted/stalled) forever
            # while a willing donor sits unasked
            donors.sort(key=lambda i: ex[i], reverse=True)
            tries = self._ckpt_tries[row] = self._ckpt_tries.get(row, 0) + 1
            donor = donors[(tries - 1) % len(donors)]
            self.m.send(self.members[donor], {
                "type": MB_CKPT_REQ, "gid": str(wire.gid_of(name)),
                "have": int(ex[self.r]),
            })
            self.stats["ckpt_requests"] += 1

    def donate_ckpt(self, gid: int) -> Optional[dict]:
        """Build a checkpoint-transfer packet for one of our rows, or None
        if this replica must not donate.  Shared by the async
        ``MB_CKPT_REQ`` handler and the recovery-time
        :class:`PeerCheckpointStreamer` (synchronous fetch, from its worker
        threads while this node ticks: everything is read under the node
        lock into host copies, so a packet never aliases live tensors)."""
        with self.lock:
            # the donated (watermark, blob) pair must be consistent: with a
            # pipelined tick in flight the device exec watermark is ahead
            # of the app by that tick's undelivered executions, and the
            # asker would adopt the watermark while the blob lacks them —
            # permanently skipping those slots (the Mode A twin lost
            # acknowledged writes this way; paxos/manager.py sync_laggard)
            self.drain_pipeline()
            row = self._gid_row.get(gid)
            if row is None or row in self._tainted_rows:
                return None  # never donate a diverged copy
            if row in self._stalled:
                # a stalled row's app state EXCLUDES its stalled slots while
                # its exec watermark includes them — donating would make the
                # receiver skip those slots forever; let a caught-up peer
                # donate instead (or this row after its stall drains)
                return None
            name = self.rows.name(row)
            blob = self.app.checkpoint(name)
            return {
                "type": MB_CKPT, "gid": str(gid),
                "exec_slot": int(self.state.exec_slot[self.r, row]),
                "status": int(self.state.status[self.r, row]),
                "state": blob.hex(),
            }

    def _on_ckpt_req(self, sender: str, p: dict) -> None:
        reply = self.donate_ckpt(int(p["gid"]))
        if reply is not None:
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

    def _apply_ckpt(self, row: int, p: dict) -> None:
        """Adopt a donor checkpoint into our own row (shared with WAL
        replay — the transfer mutates state outside the deterministic tick,
        so it is journaled as its own record)."""
        donor_exec = int(p["exec_slot"])
        have = int(self.state.exec_slot[self.r, row])
        if donor_exec < have or (donor_exec == have
                                 and row not in self._tainted_rows):
            return  # stale reply; we caught up meanwhile (a tainted row
            #         accepts an equal-watermark donor: ours is diverged)
        name = self.rows.name(row)
        self.app.restore(name, bytes.fromhex(p["state"]))
        self.state.exec_slot[self.r, row] = donor_exec
        self.state.status[self.r, row] = int(p["status"])
        # stalled decisions at/below the adopted watermark are covered by
        # the transferred state; later ones can still drain normally
        q = self._stalled.get(row)
        if q is not None:
            kept = collections.deque(e for e in q if e[2] > donor_exec)
            if kept:
                self._stalled[row] = kept
            else:
                del self._stalled[row]
                self._stall_tick.pop(row, None)
        if int(p["status"]) == int(GroupStatus.STOPPED):
            self._stopped_rows.add(row)
        self._seen.pop(row, None)
        self._tainted_rows.discard(row)
        self._ckpt_tries.pop(row, None)
        self._dirty[row] = True
        self.stats["ckpt_transfers"] += 1

    def request_sync(self) -> None:
        """Ask every peer for a full-state frame (recovery rejoin)."""
        if self.m is None:
            return
        for i, peer in enumerate(self.members):
            if i != self.r:
                self.m.send(peer, {"type": MB_SYNC_REQ})

    # ------------------------------------------------------------ driver shim
    def pending_count(self) -> int:
        with self.lock:
            n = sum(len(q) for q in self._queues.values()) + len(self._staged)
            n += sum(1 for rec in self.outstanding.values()
                     if not rec.responded)
            if self._pending_out is not None:
                n += 1  # a pipelined outbox still needs a tick to complete
            # keep ticking while replica traffic is flowing, even with no
            # local work: mirror updates only turn into decisions via ticks
            if self.tick_num - self._last_frame_rx < 8:
                n += 1
            return n

    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.tick()

    def close(self) -> None:
        if self.m is not None:
            self.m.close()



class PeerCheckpointStreamer:
    """Parallel peer snapshot streaming for recovery.

    Anti-entropy repair alone fetches peer checkpoints one row at a time,
    *after* local WAL replay finished — so time-to-full-service is replay
    + N sequential transfers.  This streamer overlaps the two: recovery
    hands it the fetch plan (the recovering node's own group ids) *before*
    replay starts, worker threads pull checkpoint packets from multiple
    donors concurrently while the replay loop runs, and the blobs are
    adopted after replay through the same watermark-checked
    ``_apply_ckpt`` path as a live transfer — a blob that replay already
    caught up past is simply dropped as stale, so overlap can never
    regress state.

    ``fetchers`` maps donor id -> ``callable(gid) -> packet | None``
    where the packet is ``MB_CKPT``-shaped (``exec_slot`` / ``status`` /
    ``state``); :meth:`ModeBNode.donate_ckpt` is the canonical donor-side
    producer (in-process planes and tests call it directly; an RPC
    deployment wraps its transport equivalent).  Donors are interleaved
    round-robin across the plan and failed fetches rotate to the next
    donor, so one slow or refusing peer neither serializes nor starves
    the stream."""

    def __init__(self, fetchers: Dict[str, Callable], window: int = 4):
        self.fetchers = dict(fetchers)
        self.window = max(1, int(window))
        self._results: list = []
        self._threads: list = []
        self._lock = threading.Lock()
        self._queue = None
        self._planned: set = set()
        self.stats = {"fetched": 0, "failed": 0, "applied": 0, "stale": 0}

    def start(self, gids) -> None:
        """Begin fetching (non-blocking).  ``gids`` is the initial fetch
        plan — every own row known at recovery start (snapshot rows).
        Rows that only materialize during journal replay (no checkpoint
        yet) are picked up by :meth:`apply`, which extends the plan before
        adopting."""
        self._launch(gids)

    def _launch(self, gids) -> None:
        peers = sorted(self.fetchers)
        gids = [int(g) for g in gids if int(g) not in self._planned]
        if not peers or not gids:
            return
        self._planned.update(gids)
        if self._queue is None:
            self._queue = queue.Queue()
        for i, gid in enumerate(gids):
            self._queue.put((gid, i % len(peers)))
        # workers exit when the queue drains, so each launch (re)spawns
        # its own window of them
        for _ in range(min(self.window, len(gids))):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name="ckpt-stream")
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        peers = sorted(self.fetchers)
        while True:
            try:
                gid, pi = self._queue.get_nowait()
            except queue.Empty:
                return
            pkt = None
            for off in range(len(peers)):  # rotate donors on failure
                peer = peers[(pi + off) % len(peers)]
                try:
                    pkt = self.fetchers[peer](gid)
                except Exception:
                    pkt = None
                if pkt is not None:
                    break
            with self._lock:
                if pkt is not None:
                    self.stats["fetched"] += 1
                    self._results.append((gid, pkt))
                else:
                    self.stats["failed"] += 1

    def join(self, timeout_s: Optional[float] = None) -> list:
        for t in self._threads:
            t.join(timeout_s)
        with self._lock:
            return list(self._results)

    def apply(self, node) -> int:
        """Adopt the fetched blobs (recovery thread, after replay and WAL
        re-attach).  Mirrors the live ``_on_ckpt`` order — journal the
        transfer, then apply through the watermark check — so a crash
        mid-adoption replays to the same state."""
        # rows born inside the journal (unknown at stream start — no
        # checkpoint covered them yet) join the plan now: still a
        # parallel multi-donor fetch, just without the replay overlap
        self._launch(set(node._gid_row))
        applied = 0
        for gid, pkt in self.join():
            row = node._gid_row.get(int(gid))
            if row is None:
                continue
            before = node.stats["ckpt_transfers"]
            if node.wal is not None:
                node.wal.log_ckpt(int(gid), dict(pkt))
            node._apply_ckpt(row, pkt)
            if node.stats["ckpt_transfers"] > before:
                applied += 1
                self.stats["applied"] += 1
            else:
                self.stats["stale"] += 1
        return applied
