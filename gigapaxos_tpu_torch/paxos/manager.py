"""PaxosManager: the host control loop that owns the device data plane
(Mode A: the whole replica set is one device program on one card).

It owns:

* the dense device state (one :class:`PaxosState` on ``device``) and the
  fused tick (``ops/tick.py``);
* the name<->row table (:class:`RowAllocator`);
* the request store: request-id -> payload/callback, with execution-side
  dedup so a request that commits in two slots (possible across
  coordinator turnover) executes once;
* per-replica-slot app instances (``Replicable``), executed on the host
  from the device's ordered decision stream;
* the per-tick batcher: queued proposals are packed into the inbox tensor,
  rejected intake is re-queued;
* the optional write-ahead log (``wal=PaxosLogger(...)``, ``wal/logger.py``):
  admin ops and each tick's placed intake are journaled, and client
  responses are held until an fsync covers the tick that produced them;
* the optional planes: register groups (``register_groups``: a second W=1
  state plane, rows ``[G, G + G_reg)`` of the composite row space), read
  leases (``read_leases``: lease columns folded in the tick, local reads
  against their host mirror) and group health (``group_health``: stall,
  churn and heat columns reduced to an O(K) pack per tick).  Every
  combination ticks through the one dispatch ``ops.tick.paxos_tick_health``;
* the optional device-resident app (``device_app``,
  ``models/device_kv.py``): request descriptors upload and decisions
  execute on the device inside one fused call per tick;
* the two measurement baselines (``emulate_unreplicated``,
  ``lazy_propagation``): the entry replica executes at admission.

* the sharded data plane (``mesh_devices``, ``parallel/shard_tick.py``):
  one tick body a shard of a (replica, groups) mesh, bit-identical to the
  single-device tick; each shard's state block lives on its own device
  from birth (``parallel.mesh.ResidentState``), each shard's inbox block
  goes to its device and its compacted outbox to the host on its own;
* the placement demand plane (``placement.enabled``, ``placement/``):
  per-group demand counters folded on the device (inside the scripted
  compact tick, or after the mesh's shards) or on the host, read by the
  rebalancer through :meth:`PaxosManager.demand_snapshot`.

``fast_reelection`` is accepted
and, as in the reference's Mode A manager, changes nothing here (only Mode
B elects through it).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import overload as _overload
from ..config import GigapaxosTpuConfig
from ..device import resolve_device, serial_on_cpu
from ..models.device_kv import DeviceKVApp, fused_compact, init_kv
from ..models.replicable import Replicable
from ..obs.metrics import registry as _obsreg
from ..obs.phase import BLOCKING_PHASE as _BLOCKING_PHASE
from ..obs.phase import device_timers as _device_timers
from ..obs.phase import phase_clock as _phase_clock
from ..ops.tick import (LP_ASN, LP_EPOCH, LP_HOLDER, LP_UNTIL, LP_WAIT,
                        CompactHostOutbox, CompactLayout, HostOutbox,
                        TickInbox, frontier_rows, health_clear_rows,
                        init_health, init_lease, lease_clear_rows,
                        merge_compact_outbox,
                        merge_health, merge_outbox,
                        paxos_tick_compact_demand, paxos_tick_health,
                        sweep_frontier, unpack_compact, unpack_health,
                        unpack_outbox)
from ..parallel import shard_tick as _stk
from ..parallel.mesh import GROUPS_AXIS, ResidentState, make_mesh
from ..types import NO_REQUEST
from ..utils.diskmap import DiskMap
from ..utils.intmap import RowAllocator
from ..utils.locking import ContendedLock, locked as _locked
from ..utils.reqtrace import tracer as _reqtrace
from . import state as st
from .bulkstore import BulkStore
from .outcopy import OutboxCopier
from .paystore import PayloadStore

#: process-wide manager counter for trace namespaces (never reused)
_MGR_SEQ = itertools.count()


@dataclass
class RequestRecord:
    rid: int
    name: str
    row: int
    payload: bytes
    stop: bool
    callback: Optional[Callable[[int, bytes], None]]
    entry: int  # entry replica slot
    slot: int = -1  # filled at first execution
    executed_by: set = field(default_factory=set)
    responded: bool = False


def _mesh_for(p, device: torch.device):
    """The mesh of ``paxos.mesh_devices`` devices (-1: every visible one):
    ``cuda:0 .. cuda:n-1`` for a CUDA manager; on the CPU, ``n`` x ``cpu``
    stand in for ``n`` devices."""
    if device.type == "cpu":
        devs = [device] * max(p.mesh_devices, 1)
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    n = len(devs) if p.mesh_devices < 0 else p.mesh_devices
    if n > len(devs):
        raise ValueError(
            f"mesh_devices={n} but only {len(devs)} devices visible"
        )
    return make_mesh(devs[:n], replica_shards=p.mesh_replica_shards)


def _pad_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` as int32, zero-padded to a power-of-two bucket (>= 16)."""
    padded = np.zeros(max(16, 1 << int(len(rows) - 1).bit_length()),
                      np.int32)
    padded[:len(rows)] = rows
    return padded


def _frontier_np(x, n: int) -> np.ndarray:
    """The first ``n`` values of a gathered frontier column on the host:
    one device tensor, or a mesh's ``(count, tensor)`` list."""
    if isinstance(x, list):
        return np.concatenate([t.cpu().numpy()[:c] for c, t in x])
    return x.cpu().numpy()[:n]


def _refuse_device_app_combinations(cfg: GigapaxosTpuConfig) -> None:
    """The reference's ValueErrors for the options the fused KV program
    has no formulation for, in the reference's order."""
    p = cfg.paxos
    if not p.compact_outbox:
        raise ValueError("device_app requires compact_outbox")
    if p.register_groups:
        raise ValueError(
            "register_groups + device_app is not supported yet: the "
            "fused KV program has no mixed-plane formulation")
    if p.emulate_unreplicated or p.lazy_propagation:
        raise ValueError(
            "baseline modes are host-app measurement tools; the "
            "device app executes on-device only")
    if p.mesh_devices:
        raise ValueError(
            "device_app + mesh_devices is not supported yet: the "
            "fused KV program has no shard_map formulation")
    if p.read_leases:
        raise ValueError(
            "read_leases + device_app is not supported yet: the "
            "fused KV program has no lease formulation")
    if p.group_health:
        raise ValueError(
            "group_health + device_app is not supported yet: the "
            "fused KV program has no health formulation")


class PaxosManager:
    def __init__(
        self,
        cfg: GigapaxosTpuConfig,
        n_replicas: int,
        apps: List[Replicable],
        wal=None,
        spill_ns: str = "default",
        device=None,
        mesh=None,
    ):
        """``device`` defaults to CUDA (see ``device.resolve_device``);
        ``spill_ns`` names this manager's plane in metrics; ``wal`` is an
        optional ``wal.logger.PaxosLogger``.  ``mesh`` (a
        ``parallel.mesh.Mesh``) runs the data plane on that mesh in place
        of the one ``paxos.mesh_devices`` builds: several shards on one
        card, for instance."""
        assert len(apps) == n_replicas
        self._device_app = bool(cfg.paxos.device_app)
        if self._device_app:
            _refuse_device_app_combinations(cfg)
        self.cfg = cfg
        self.wal = wal
        self.device = resolve_device(device)
        self.R = n_replicas
        self.G = cfg.paxos.max_groups
        self.W = cfg.paxos.window
        self.P = cfg.paxos.proposals_per_tick
        # register plane: a second state at W=1; composite row space [0, G)
        # log rows, [G, G_total) register rows (the row index is the mode
        # bit), so every row-keyed host structure is sized G_total
        self.G_reg = cfg.paxos.register_groups
        self.G_total = self.G + self.G_reg
        self.rows = RowAllocator(self.G_total, split=self.G)
        self.apps = apps
        # ---- sharded data plane (parallel/shard_tick) ----
        # mesh_devices > 0 (or -1 = all): the tick runs once per shard of a
        # (replica, groups) mesh, the hand kernels on each shard's block,
        # the quorum exchange an explicit replica-axis all-gather.  Each
        # shard's block of the state lives on its device from birth
        # (self._res); the rare paths reach a row through its owning block
        # (_owning, _row_blocks), ``self.state`` is None and
        # gather_state() copies the whole state out.  Results equal the
        # single-device path bit for bit, so everything downstream (WAL,
        # replay, laggard repair, compaction layout) is unchanged.
        self.mesh = None
        self._res: Optional[ResidentState] = None
        self._mesh_tick = None
        if cfg.paxos.mesh_devices or mesh is not None:
            if self._device_app:
                raise ValueError(
                    "device_app + mesh_devices is not supported yet: the "
                    "fused KV program has no shard_map formulation")
            if self.G_reg:
                raise ValueError(
                    "register_groups + mesh_devices is not supported yet: "
                    "the shard_map tick has no mixed-plane formulation"
                )
            self.mesh = (mesh if mesh is not None
                         else _mesh_for(cfg.paxos, self.device))
            _stk.validate_mesh_for(self.mesh, self.R, self.G)
            compact = bool(cfg.paxos.compact_outbox)
            self._mesh_tick = _stk.make_resident_tick(
                self.mesh, -1, self._exec_budget_of(cfg) if compact else 0,
                max(64, cfg.paxos.lag_budget) if compact else 0,
                demand_decay=(cfg.placement.ewma_decay
                              if cfg.placement.enabled else None),
                pack=not compact)
            self._res = ResidentState.fresh(self.mesh, self.R, self.G,
                                            self.W)
        #: the log plane's state on one device; None on a mesh, whose
        #: blocks are ``self._res`` (see :meth:`gather_state`)
        self.state = (None if self._res is not None else
                      st.init_state(self.R, self.G, self.W, self.device))
        self.rstate = (st.init_state(self.R, self.G_reg, 1, self.device)
                       if self.G_reg else None)
        # ---- placement plane (placement/): advisory demand counters ----
        # Not journaled and not in snapshots: a recovered node restarts
        # with cold counters and waits out the rebalancer's min-interval
        # guard; the migrations themselves ARE journaled (OP_CREATE_AT).
        self._placement = None
        self._demand_dev = None
        if cfg.placement.enabled:
            # (imported here: placement/ reaches reconfiguration/, which
            # imports this module)
            from ..placement.counters import PlacementCounters

            gs = self.mesh.shape[GROUPS_AXIS] if self.mesh is not None else 1
            self._placement = PlacementCounters(
                self.G, gs,
                decay=cfg.placement.ewma_decay,
                sample_every_ticks=cfg.placement.sample_every_ticks,
            )
            if self._res is not None and cfg.paxos.compact_outbox:
                # each shard column folds its own block in its tick
                # (shard_tick_body), one [G/gs] block a column
                gl = self._res.rows_per_shard
                self._demand_dev = [
                    torch.zeros(gl, dtype=torch.float32,
                                device=self.mesh.device_at(0, gi))
                    for gi in range(gs)]
            elif cfg.paxos.compact_outbox and not self._device_app \
                    and not self.G_reg and not cfg.paxos.read_leases \
                    and not cfg.paxos.group_health:
                # one device, compact: the intake-popcount fold runs inside
                # the scripted tick program (paxos_tick_compact_demand).
                # Mixed planes, leases, health and the device app keep the
                # host fold (placement covers the LOG plane only).
                self._demand_dev = torch.zeros(self.G, dtype=torch.float32,
                                               device=self.device)
        self.alive = np.ones(self.R, bool)
        self.tick_num = 0
        self.outstanding: Dict[int, RequestRecord] = {}
        self._next_rid = 1
        # content-addressed payload interning: N admitted requests sharing
        # one body hold one bytes object
        self._paystore = PayloadStore()
        self._queues: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque
        )  # row -> rids waiting for intake
        # callbacks released at the end of each completed tick
        self._held_callbacks: list = []
        #: rid arrays of the bulk requests those callbacks release
        self._held_rids: list = []
        #: scope openers run around each callback flush; each returns a
        #: closer (the active replica's per-tick client egress coalescing)
        self._flush_scope_hooks: list = []
        # per (replica, row) dedup of executed request ids (bounded)
        self._seen: Dict[tuple, collections.OrderedDict] = \
            collections.defaultdict(collections.OrderedDict)
        self._seen_cap = 8 * self.W
        self.stats = collections.Counter()
        # overload plane: watermark-with-hysteresis admission of
        # CLIENT-class work.  Control-class proposes are never governed.
        self.overload = (
            _overload.IntakeGovernor(cfg.overload.intake_hi,
                                     cfg.overload.intake_lo,
                                     node=spill_ns or "-")
            if cfg.overload.enabled else None
        )
        self._ov_node = spill_ns or "-"
        self._reads_fallback_c = _obsreg().counter(
            "reads_fallback_total",
            help="reads that fell back to a consensus round (no/invalid "
                 "lease or non-quiescent group)", node=self._ov_node)
        self._reads_local_c = _obsreg().counter(
            "reads_local_total",
            help="reads answered locally under a valid lease (no consensus "
                 "round)", node=self._ov_node)
        self._lease_waits_c = _obsreg().counter(
            "lease_waits_total",
            help="per-tick count of groups whose coordinator is write-"
                 "fenced waiting out a prior holder's lease",
            node=self._ov_node)
        self._lease_gauge = _obsreg().gauge(
            "lease_holder_groups",
            help="groups with a currently granted read lease",
            node=self._ov_node)
        _obsreg().gauge(
            "register_groups",
            help="register-mode (RMW) row capacity of this manager",
        ).set(self.G_reg)
        self._hg_backlog = _obsreg().gauge(
            "health_backlogged_groups",
            help="groups with pending intake, an unexecuted assignment "
                 "frontier, or an unresolved election (health fold)",
            node=self._ov_node)
        self._hg_wedged = _obsreg().gauge(
            "health_wedged_groups",
            help="backlogged groups with no commit/exec progress for at "
                 "least health_wedge_ticks ticks", node=self._ov_node)
        self._hg_max_stall = _obsreg().gauge(
            "health_max_stall_ticks",
            help="largest per-group stall age (ticks since last progress "
                 "among backlogged groups)", node=self._ov_node)
        self._hg_max_churn = _obsreg().gauge(
            "health_max_churn",
            help="largest per-group coordinator-churn EWMA (handoffs over "
                 "a decaying window)", node=self._ov_node)
        self._hg_lease_wait = _obsreg().gauge(
            "health_lease_wait_groups",
            help="groups write-fenced behind a prior holder's lease this "
                 "tick (0 when leases are off)", node=self._ov_node)
        # ---- read leases: [G]/[G_reg] columns folded in the tick; the
        # host keeps the last tick's [5, G_total] lease pack (_lease_np)
        # and a lockstep clock for the local-read check ----
        self._lease = self._rlease = None
        self._lease_np = None
        self._lease_clock = 0
        self._lease_skew_ticks = 0    # test hook: injected holder clock skew
        self._lease_horizon = int(cfg.paxos.lease_ticks)
        self._lease_margin = int(cfg.paxos.lease_margin_ticks)
        if cfg.paxos.read_leases:
            if self.mesh is not None:
                raise ValueError(
                    "read_leases + mesh_devices is not supported yet: the "
                    "shard_map tick has no lease formulation"
                )
            self._lease = init_lease(self.G, self._lease_margin, self.device)
            self._rlease = (init_lease(self.G_reg, self._lease_margin,
                                       self.device) if self.G_reg else None)
            self._lease_np = np.zeros((5, self.G_total), np.int32)
            self._lease_np[LP_HOLDER, :] = -1
        # ---- group health: [G]/[G_reg] columns folded in the tick; the
        # host consumes one O(K) pack per completed tick ----
        self._health = self._rhealth = None
        self._health_view = None      # HealthView as of last completed tick
        self._health_clock = 0        # host lockstep clock (+1/completed tick)
        self._health_topk = int(cfg.paxos.health_topk)
        self._health_wedge = int(cfg.paxos.health_wedge_ticks)
        self._health_shift = int(cfg.paxos.health_decay_shift)
        self._wedged_rows: set = set()   # last tick's wedged top-K rows
        self._topk_stuck: tuple = ()     # last tick's stuck top-K rows
        #: optional ``obs.flight.FlightRecorder``: health transitions
        #: (newly wedged / recovered rows, top-K churn) land in its ring
        self.flight = None
        if cfg.paxos.group_health:
            if self.mesh is not None:
                raise ValueError(
                    "group_health + mesh_devices is not supported yet: the "
                    "shard_map tick has no health formulation"
                )
            self._health = init_health(self.G, self.device)
            self._rhealth = (init_health(self.G_reg, self.device)
                             if self.G_reg else None)
        self._stopped_rows: set[int] = set()
        # ---- pause (deactivation): name -> HotRestoreInfo; row freed ----
        # paused records beyond spill_cache page to spill_dir/<spill_ns>
        self._paused = DiskMap(
            os.path.join(cfg.paxos.spill_dir, spill_ns)
            if cfg.paxos.spill_dir else None,
            cfg.paxos.spill_cache,
        )
        self._last_active = np.zeros(self.G_total, np.int64)
        self._row_outstanding = collections.Counter()
        # host mirrors of config state (member mask / group size): the
        # tick never writes these, so the hot path reads numpy instead of
        # the device
        self._member_np = np.zeros((self.R, self.G_total), bool)
        self._n_members_np = np.zeros(self.G_total, np.int32)
        self._stopped_np = np.zeros(self.G_total, bool)
        self._row_name_np = np.empty(self.G_total, object)
        self._member_bits = np.zeros(self.G_total, np.int64)
        self._member_ord = None  # lazy [R, G_total] cumulative member ordinal
        #: per-row window / laggard threshold: W for log rows, 1 for
        #: register rows (one version behind already needs the register
        #: shipped: there is no ring to catch up from)
        self._w_np = np.full(self.G_total, self.W, np.int32)
        self._w_np[self.G:] = 1
        # ---- compacted-outbox / bulk-propose machinery ----
        self._use_compact = bool(cfg.paxos.compact_outbox)
        self._exec_budget = self._exec_budget_of(cfg)
        self._lag_budget = max(64, cfg.paxos.lag_budget)
        bc = cfg.paxos.bulk_capacity or max(1 << 16, 4 * self.G)
        self._bulk_cap = 1 << (bc - 1).bit_length()
        self.bulk: Optional[BulkStore] = None  # lazy (most managers: unused)
        self._bulk_cbs: Dict[int, Callable] = {}  # optional per-rid cbs
        #: columnar completion sinks: one per admitted contiguous rid
        #: block — [rid0, rid0+n) -> sink(offsets, responses), kept sorted
        #: by rid0: [rid0, n, remaining, sink]
        self._sink_blocks: list = []
        self._bulk_chunks: list = []  # FIFO of staged rid arrays
        self._bulk_leftover = np.zeros(0, np.int64)  # queued, not yet placed
        self._bulk_placed = None  # (rids, entries, ps, rows) of last tick
        #: the last completed tick's compacted laggard table (rep, row,
        #: donor, donor exec, donor status, laggard exec)
        z0 = np.zeros(0, np.int64)
        self._lag_pending = (z0, z0, z0, z0, z0, z0)
        #: (replica, row) transfers noticed during tick completion, run at
        #: the next tick() top after a pipeline drain
        self._lag_sync_due: list = []
        #: pairs repaired at the previous tick() top (their re-flag from
        #: the pre-repair pipelined outbox is filtered)
        self._repaired_last: set = set()
        self._sweep_every = 64
        #: HOST-APPLIED execution watermark [R, G]: how far each replica's
        #: app has executed (device exec_slot runs one pipelined tick
        #: ahead); the payload sweep judges "everyone passed" against it
        self._host_exec = np.zeros((self.R, self.G_total), np.int32)
        # first-occurrence scratch (generation-tagged so no per-tick clear)
        self._scr_pos = np.zeros(self.R * self.G_total, np.int64)
        self._scr_gen = np.zeros(self.R * self.G_total, np.int64)
        self._scr2_pos = None  # store-capacity scratch, allocated w/ store
        self._scr2_gen = None
        self._gen = 0
        # ---- device-resident application (models/device_kv.py) ----
        self.kv = None
        if self._device_app:
            table = cfg.paxos.kv_table or (
                1 << max(16, (4 * self.G - 1).bit_length()))
            # live-descriptor evictions must be impossible: rids are
            # sequential and the admit window caps live spread at the bulk
            # capacity, so a table >= 2x that can only ever evict
            # descriptors of already-freed requests
            table = max(table, 2 * self._bulk_cap)
            self.kv = init_kv(self.R, self.G, cfg.paxos.kv_slots, table,
                              device=self.device)
            # the manager owns the device state; the Replicable faces the
            # control plane sees are row-granular views of it
            self.apps = [DeviceKVApp(self, r, row_of=self.rows.row)
                         for r in range(self.R)]
            self._kv_reg_budget = cfg.paxos.kv_reg_budget or 2 * self.G
            self._kv_chunks: list = []  # staged descriptor uploads
            self._kv_watermark = 0  # highest rid with descriptor on device
            self._kv_uploaded = None  # this tick's upload (journaled)
        self._in_kv_admit = False
        #: recovery hooks (``wal.logger.recover``), set while a device-app
        #: journal replays: the compact fold and the tick's kv_reg upload
        self._replay_process = None
        self._replay_kv_reg = None
        # inbox staging buffers; entries placed last tick are zeroed
        # lazily at the next build
        self._in_req = np.zeros((self.R, self.P, self.G_total), np.int32)
        self._in_stp = np.zeros((self.R, self.P, self.G_total), bool)
        self._inbox_alive = self.alive.copy()  # liveness of the last inbox
        self._placed: list = []
        #: pipelined mode: the last dispatched tick, completed at the start
        #: of the next
        self._pending_out = None
        #: completed outbox stashed by drain_pipeline() for the next tick()
        self._drained_out = None
        #: lock-free propose staging (drained at each tick) + a tiny
        #: rid-assignment lock that never contends with the tick
        self._staged: collections.deque = collections.deque()
        self._rid_lock = threading.Lock()
        self._draining = False
        self.reqtrace = _reqtrace(f"pxm:{next(_MGR_SEQ)}")
        #: always-on tick phase clock: host timestamps only ("dispatch" is
        #: enqueue cost, the device wait lands in "tally" at the unpack
        #: sync point); cfg.obs.blocking_phases adds "device_step"
        self._pc = _phase_clock("modea", plane=spill_ns)
        self._obs_block = bool(cfg.obs.blocking_phases)
        #: device time of the inbox upload and the dispatch, read a tick
        #: or two late without a sync (CUDA, one device)
        self._dt = _device_timers("modea", spill_ns, ("upload", "tick"),
                                  self.device if self.mesh is None else None)
        #: the outbox's copy to the host, started at dispatch into a ring of
        #: host buffers (pinned, on a copy stream, for a CUDA outbox) and
        #: timed there as part "copy"
        self._outcopy = OutboxCopier("modea", spill_ns)
        #: a mesh: per shard (labelled by its index in ``mesh.shards()``)
        #: the timers of its inbox upload, its body ("tick") and its
        #: exchanges ("exchange"), and its outbox's copier
        self._dts: Dict[tuple, object] = {}
        self._outcopies: Dict[tuple, OutboxCopier] = {}
        #: a CUDA mesh's inbox staging is pinned: each shard's block goes
        #: to its card without blocking the host, and the next build waits
        #: for these events (the uploads' ends) before writing the staging
        self._staging_pinned = None
        self._uploaded: list = []
        if self.mesh is not None:
            for i, k in enumerate(self.mesh.shards()):
                dev = self.mesh.device_at(*k)
                self._dts[k] = _device_timers(
                    "modea", spill_ns, ("upload", "tick", "exchange"), dev,
                    shard=str(i))
                self._outcopies[k] = OutboxCopier("modea", spill_ns,
                                                  shard=str(i))
            if any(d.type == "cuda" for d in self.mesh.devices):
                self._staging_pinned = (
                    torch.zeros(self._in_req.shape, dtype=torch.int32,
                                pin_memory=True),
                    torch.zeros(self._in_stp.shape, dtype=torch.bool,
                                pin_memory=True))
                self._in_req = self._staging_pinned[0].numpy()
                self._in_stp = self._staging_pinned[1].numpy()
        #: a bulk request's wait from admission to placement ("queue") and
        #: from placement to the release of its response ("order")
        self._wait_h = {stage: _obsreg().histogram(
            "request_wait_seconds", help="bulk request wait per stage",
            plane=spill_ns, stage=stage) for stage in ("queue", "order")}
        # control-plane threads call the admin/propose API while a driver
        # loops on tick(); one reentrant lock serializes them
        self.lock = ContendedLock()
        if self.wal is not None:
            self.wal.attach(self)

    # ------------------------------------------------------ device helpers
    # The composite row space is [0, G) log + [G, G_total) register rows;
    # these helpers are the only places host code maps a composite row onto
    # one of the two device planes.

    def _exec_budget_of(self, cfg: GigapaxosTpuConfig) -> int:
        return cfg.paxos.exec_budget or max(4096, 2 * self.G_total)

    def is_register_row(self, row: int) -> bool:
        return row >= self.G

    def gather_state(self) -> st.PaxosState:
        """The log plane's whole state: :attr:`state` on one device.  On a
        mesh, where :attr:`state` is None, a copy gathered from the shards'
        blocks onto ``device`` (its bytes counted as
        ``mesh_transfer_bytes_total{kind="state"}``); writes to it reach
        no shard."""
        if self._res is None:
            return self.state
        return self._res.gather(self.device)

    def load_state(self, state: st.PaxosState) -> None:
        """Replace the log plane's whole state (a snapshot's restore): on a
        mesh, each shard's block by its cut of ``state``."""
        if self._res is None:
            self.state = state
        else:
            self._res.assign(state)

    @contextlib.contextmanager
    def _owning(self, row: int, write: bool = True):
        """``(state, row)`` of the plane, and on a mesh the block, that
        holds composite ``row``; writes in place land in it (with replica
        shards, written back on exit unless ``write`` is False)."""
        if row >= self.G:
            yield self.rstate, row - self.G
        elif self._res is None:
            yield self.state, row
        else:
            gi, prow = self._res.owner(row)
            with self._res.column(gi, write) as col:
                yield col, prow

    def _row_blocks(self, rows):
        """``(state, rows in it, positions in rows)`` for each log-plane
        block holding some of ``rows``: the whole plane on one device, each
        owning shard column on a mesh (writes land as with
        :meth:`_owning`)."""
        if self._res is None:
            yield self.state, rows, slice(None)
            return
        for gi, sel, prows in self._res.split_rows(rows):
            with self._res.column(gi) as col:
                yield col, prows, sel

    def _field_np(self, name: str) -> np.ndarray:
        """One log-plane field's global view on the host."""
        if self._res is None:
            return st.to_host(getattr(self.state, name))
        return self._res.field_host(name)

    def _dev_exec_np(self) -> np.ndarray:
        """Composite [R, G_total] device exec watermark on the host."""
        ex = self._field_np("exec_slot")
        if self.rstate is None:
            return ex
        return np.hstack([ex, st.to_host(self.rstate.exec_slot)])

    def _dev_exec_col(self, row: int) -> np.ndarray:
        with self._owning(row, write=False) as (pst, prow):
            return st.to_host(pst.exec_slot[:, prow])

    def _set_exec_status(self, r: int, row: int, exec_slot: int,
                         status: int) -> None:
        """Point-write a replica's exec watermark + status on the owning
        plane (checkpoint transfer apply), in place."""
        with self._owning(row) as (pst, prow):
            pst.exec_slot[r, prow] = exec_slot
            pst.status[r, prow] = status

    def _sync_device(self) -> None:
        devs = self.mesh.devices if self.mesh is not None else [self.device]
        for d in dict.fromkeys(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ------------------------------------------------------------ lease plane
    # The device fold owns grant/renew/expiry and the write fence; the host
    # mirrors each completed tick's [5, G] lease pack and answers reads
    # against it.

    def _adopt_lease_pack(self, lease_pack) -> None:
        """Consume one tick's lease pack(s) at completion (the device sync
        point).  Mixed planes hand a (log, register) pair that lands side
        by side in the composite [5, G_total] mirror."""
        if isinstance(lease_pack, tuple):
            lp = np.concatenate([st.to_host(lease_pack[0]),
                                 st.to_host(lease_pack[1])], axis=1)
        else:
            lp = st.to_host(lease_pack)
        self._lease_np = lp
        self._lease_clock += 1  # lockstep with the device fold's clock+1
        self._lease_gauge.set(int((lp[LP_HOLDER] >= 0).sum()))
        waits = int(lp[LP_WAIT].sum())
        if waits:
            self._lease_waits_c.inc(waits)

    def _split_rows(self, rows):
        """Composite rows as (log-plane rows, register-plane rows)."""
        rows = np.asarray(rows, np.int64)
        return rows[rows < self.G], rows[rows >= self.G] - self.G

    def _lease_drop_rows(self, rows) -> None:
        """Reset lease columns for freed rows (remove/pause): a recycled
        row must not inherit the previous occupant's lease."""
        if self._lease is None or not len(rows):
            return
        if self._pending_out is not None:
            # a pending tick's lease pack predates this drop; complete it
            # first so adoption cannot resurrect the dropped holder
            self.drain_pipeline()
        lrows, rrows = self._split_rows(rows)
        if len(lrows):
            lease_clear_rows(self._lease, lrows)
        if len(rrows) and self._rlease is not None:
            lease_clear_rows(self._rlease, rrows)
        # a fresh mirror: whoever holds the last tick's stays unchanged
        self._lease_np = self._lease_np.copy()
        self._lease_np[LP_HOLDER, rows] = -1
        self._lease_np[LP_UNTIL, rows] = 0

    @_locked
    def lease_info(self, name: str) -> Optional[dict]:
        """Host view of one group's lease columns as of the last completed
        tick (None when leases are off or the group is not resident)."""
        if self._lease_np is None:
            return None
        row = self.rows.row(name)
        if row is None:
            return None
        lp = self._lease_np
        return {
            "holder": int(lp[LP_HOLDER, row]),
            "epoch": int(lp[LP_EPOCH, row]),
            "until": int(lp[LP_UNTIL, row]),
            "asn": int(lp[LP_ASN, row]),
            "clock": self._lease_clock,
        }

    # ----------------------------------------------------------- health plane
    # The device owns the dense stall/churn/heat columns; the host consumes
    # one O(K) pack per completed tick: gauges, log2 histograms and the
    # top-K stuckest / churniest / hottest rows.

    def _adopt_health_pack(self, health_pack) -> None:
        """Consume one tick's health pack(s) at completion.  Mixed planes
        hand a (log, register) pair merged with register rows re-offset
        into the composite row space."""
        K = self._health_topk
        if isinstance(health_pack, tuple):
            hv = merge_health(
                unpack_health(health_pack[0], min(K, self.G)),
                unpack_health(health_pack[1], min(K, self.G_reg)),
                self.G, K)
        else:
            hv = unpack_health(health_pack, min(K, self.G))
        self._health_view = hv
        self._health_clock += 1  # lockstep with the device fold's clock+1
        self._hg_backlog.set(int(hv.backlog))
        self._hg_wedged.set(int(hv.wedged))
        self._hg_max_stall.set(int(hv.max_stall))
        self._hg_max_churn.set(int(hv.max_churn) / 16.0)  # Q4 -> handoffs
        self._hg_lease_wait.set(int(hv.lease_wait))
        # transitions -> flight ring: newly wedged rows, recoveries and
        # top-K membership churn
        stall_by_row = {int(r): int(v)
                        for v, r in zip(hv.stuck_val, hv.stuck_row)
                        if int(v) > 0}
        wedged_now = {r for r, v in stall_by_row.items()
                      if v >= self._health_wedge}
        stuck_now = tuple(sorted(stall_by_row))
        if self.flight is not None:
            for r in sorted(wedged_now - self._wedged_rows):
                self.flight.record("group_wedged", {
                    "row": r, "name": self.rows.name(r),
                    "stall_ticks": stall_by_row[r],
                    "tick": self.tick_num})
            for r in sorted(self._wedged_rows - wedged_now):
                self.flight.record("group_recovered", {
                    "row": r, "name": self.rows.name(r),
                    "tick": self.tick_num})
            if stuck_now != self._topk_stuck:
                self.flight.record("health_topk", {
                    "stuck_rows": list(stuck_now), "tick": self.tick_num})
        self._wedged_rows = wedged_now
        self._topk_stuck = stuck_now

    def _health_drop_rows(self, rows) -> None:
        """Reset health columns for freed rows (remove/pause): a recycled
        row must not inherit the previous occupant's stall age or churn."""
        if self._health is None or not len(rows):
            return
        if self._pending_out is not None:
            # a pending tick's health pack predates this drop
            self.drain_pipeline()
        lrows, rrows = self._split_rows(rows)
        if len(lrows):
            health_clear_rows(self._health, lrows)
        if len(rrows) and self._rhealth is not None:
            health_clear_rows(self._rhealth, rrows)

    @_locked
    def health_snapshot(self) -> Optional[dict]:
        """JSON-friendly view of the last completed tick's health pack
        (None when the fold is off or no tick has completed).  Top-K rows
        are resolved back to group names."""
        hv = self._health_view
        if hv is None:
            return None

        def _top(vals, rs, scale=1):
            return [{"row": int(r), "name": self.rows.name(int(r)),
                     "value": int(v) / scale}
                    for v, r in zip(vals, rs) if int(v) > 0]

        return {
            "clock": self._health_clock,
            "allocated": int(hv.alloc),
            "backlogged": int(hv.backlog),
            "wedged": int(hv.wedged),
            "max_stall_ticks": int(hv.max_stall),
            "max_churn": int(hv.max_churn) / 16.0,
            "lease_wait": int(hv.lease_wait),
            "wedge_ticks": self._health_wedge,
            "hist_stall": [int(x) for x in hv.hist_stall],
            "hist_churn": [int(x) for x in hv.hist_churn],
            "top_stuck": _top(hv.stuck_val, hv.stuck_row),
            "top_churny": _top(hv.churn_val, hv.churn_row, scale=16),
            "top_hot": _top(hv.heat_val, hv.heat_row, scale=16),
        }

    @_locked
    def group_info(self, name: str) -> Optional[dict]:
        """Single-group drill-down: ballot, frontiers, member liveness,
        lease columns, register version, pending intake, health columns and
        a bounded WAL tail, all from row gathers.  None when the group is
        not resident here.  A bare service name resolves to its highest
        resident epoch (``svc`` -> ``svc#3``)."""
        row = self.rows.row(name)
        if row is None and "#" not in name:
            prefix, best = name + "#", None
            for pname in self.rows.names():
                base, sep, etxt = pname.rpartition("#")
                if base == name and sep and etxt.isdigit():
                    if best is None or int(etxt) > best:
                        best = int(etxt)
            if best is not None:
                name = prefix + str(best)
                row = self.rows.row(name)
        if row is None:
            return None
        register = row >= self.G
        with self._owning(row, write=False) as (pst, prow):
            col = {f: st.to_host(getattr(pst, f)[:, prow])
                   for f in ("member", "bal_num", "bal_coord", "exec_slot",
                             "next_slot", "status", "coord_active",
                             "coord_preparing")}
            epoch = int(pst.epoch[prow])
        members = [int(r) for r in np.nonzero(col["member"])[0]]
        replicas = {
            int(r): {
                "alive": bool(self.alive[r]),
                "ballot": [int(col["bal_num"][r]), int(col["bal_coord"][r])],
                "exec_slot": int(col["exec_slot"][r]),
                "next_slot": int(col["next_slot"][r]),
                "status": int(col["status"][r]),
                "coordinator": bool(col["coord_active"][r]),
                "preparing": bool(col["coord_preparing"][r]),
            }
            for r in members
        }
        info = {
            "name": name,
            "row": int(row),
            "mode": "register" if register else "log",
            "epoch": epoch,
            "members": members,
            "replicas": replicas,
            "stopped": row in self._stopped_rows,
            "pending_intake": len(self._queues.get(row) or ())
            + int(self._row_outstanding[row]),
            "tick": self.tick_num,
        }
        if register and members:
            # a register row's executed slot is its monotone version
            info["version"] = max(int(col["exec_slot"][r]) for r in members)
        if self._lease_np is not None:
            info["lease"] = self.lease_info(name)
        if self._health is not None:
            h = self._rhealth if register else self._health
            info["health"] = {
                "stall_ticks": int(h.clock) - int(h.last_active[prow]),
                "coordinator": int(h.last_coord[prow]),
                "churn": int(h.churn[prow]) / 16.0,
                "heat": int(h.heat[prow]) / 16.0,
            }
        if self.wal is not None:
            try:
                info["wal_tail"] = self.wal.tail_for_row(row, name)
            except Exception:
                info["wal_tail"] = None
        return info

    # ------------------------------------------------------------------ admin
    @_locked
    def create_paxos_instance(self, name: str, members: List[int],
                              epoch: int = 0, register: bool = False) -> bool:
        """createPaxosInstance analog.  ``register=True`` births the group
        on the register plane (needs ``paxos.register_groups > 0``); the
        mode is permanent for the group's lifetime and journaled with the
        create."""
        if name in self.rows or name in self._paused:
            return False
        if register and not self.G_reg:
            raise ValueError(
                "register-mode create requires paxos.register_groups > 0")
        if register:
            if self.rows.full(hi=True):
                return False
            row = self.rows.alloc(name, hi=True)
        else:
            row = self._alloc_row(name)
        if row is None:
            return False
        mask = np.zeros((1, self.R), bool)
        for m in members:
            mask[0, m] = True
        with self._owning(row) as (pst, prow):
            st.create_groups(pst, np.array([prow]), mask,
                             np.array([epoch], np.int32))
        self._set_member_row(row, mask[0], name)
        self._stopped_rows.discard(row)
        self._stopped_np[row] = False
        self._last_active[row] = self.tick_num
        if self.wal is not None:
            self.wal.log_create(name, members, epoch, register=register)
        return True

    @_locked
    def create_paxos_instance_at(
        self, name: str, members: List[int], epoch: int, row: int,
        app_seed: Optional[bytes] = None,
    ) -> bool:
        """Targeted create at a given free row (cell and placement
        migration).  Never evicts: a full destination is a planning
        failure.  ``app_seed`` (the migrated epoch's final checkpoint) is
        restored into every member's app under the same lock as the birth
        and journaled with the create (``OP_CREATE_AT``), so replay
        restores it too.  The row index encodes the plane: a targeted
        create at a register row lands on the register plane."""
        if name in self.rows or name in self._paused:
            return False
        try:
            self.rows.alloc_at(name, row)
        except KeyError:
            return False  # row occupied or out of range
        mask = np.zeros((1, self.R), bool)
        for m in members:
            mask[0, m] = True
        with self._owning(row) as (pst, prow):
            st.create_groups(pst, np.array([prow]), mask,
                             np.array([epoch], np.int32))
        self._set_member_row(row, mask[0], name)
        self._stopped_rows.discard(row)
        self._stopped_np[row] = False
        self._last_active[row] = self.tick_num
        if app_seed is not None:
            for s in members:
                self.apps[s].restore(name, app_seed)
        if self.wal is not None:
            self.wal.log_create_at(name, list(members), epoch, row, app_seed)
        return True

    def create_paxos_instances(
        self, names: List[str], members: List[int], epoch: int = 0
    ) -> int:
        """Batched createPaxosInstance: one device update for the whole
        batch.  Returns how many were created; names already present are
        skipped and capacity overflow spills to the single-create path
        (which can evict cold rows)."""
        if not all(0 <= m < self.R for m in members):
            raise ValueError(f"member slots out of range [0, {self.R}): "
                             f"{members}")
        with self.lock:
            fresh = list(dict.fromkeys(names))  # order-preserving dedup
            if len(self.rows) or len(self._paused):
                fresh = [n for n in fresh
                         if n not in self.rows and n not in self._paused]
            take = fresh[:self.rows.free_count()]
            rest = fresh[len(take):]
            if take:
                rows = np.array(self.rows.alloc_many(take), np.int32)
                mask = np.zeros((len(take), self.R), bool)
                mask[:, members] = True
                for pst, prows, sel in self._row_blocks(rows):
                    st.create_groups(pst, prows, mask[sel],
                                     np.full(len(prows), epoch, np.int32))
                self._member_np[:, rows] = mask.T
                self._n_members_np[rows] = mask.sum(axis=1)
                bits = int(np.bitwise_or.reduce(
                    (1 << np.array(members, np.int64))
                )) if members else 0
                self._member_bits[rows] = bits
                self._row_name_np[rows] = take
                self._member_ord = None
                self._stopped_np[rows] = False
                if self._stopped_rows:
                    self._stopped_rows.difference_update(rows.tolist())
                self._last_active[rows] = self.tick_num
                if self.wal is not None:
                    # one fsync for the whole batch, not one per name
                    self.wal.log_creates(take, list(members), epoch)
            made = len(take)
        for n in rest:  # overflow: single-create path (may evict)
            if self.create_paxos_instance(n, list(members), epoch):
                made += 1
        return made

    def _set_member_row(self, row, mask, name) -> None:
        """Refresh every host mirror of one row's config (mask: [R] bool)."""
        self._member_np[:, row] = mask
        self._n_members_np[row] = mask.sum()
        self._member_bits[row] = int(
            np.bitwise_or.reduce((1 << np.where(mask)[0]).astype(np.int64))
        ) if mask.any() else 0
        self._row_name_np[row] = name
        self._member_ord = None

    def _clear_member_rows(self, rows) -> None:
        self._host_exec[:, rows] = 0  # recycled rows restart at slot 0
        self._member_np[:, rows] = False
        self._n_members_np[rows] = 0
        self._member_bits[rows] = 0
        self._row_name_np[rows] = None
        self._member_ord = None

    @_locked
    def remove_paxos_instance(self, name: str) -> bool:
        """kill/cremation analog."""
        if name in self._paused:
            del self._paused[name]
            if self.wal is not None:
                self.wal.log_remove(name)
            return True
        row = self.rows.row(name)
        if row is None:
            return False
        # a pipelined pending outbox may still reference this row under its
        # OLD name<->row mapping; complete it before the row is freed
        self.drain_pipeline()
        with self._owning(row) as (pst, prow):
            st.free_groups(pst, np.array([prow]))
        self._kv_clear_rows([row])
        self._clear_member_rows([row])
        self._lease_drop_rows([row])
        self._health_drop_rows([row])
        self.rows.free(name)
        self._fail_queued(row)
        self._purge_row_outstanding(row)
        if self.bulk is not None:
            gone = np.nonzero(self.bulk.valid & (self.bulk.row == row))[0]
            if len(gone):
                if self._bulk_cbs or self._sink_blocks:
                    self._bulk_fire(
                        self.bulk.rid[gone[~self.bulk.responded[gone]]]
                    )
                self.stats["failed_requests"] += self.bulk.fail(gone)
        self._stopped_rows.discard(row)
        self._stopped_np[row] = False
        if self.wal is not None:
            self.wal.log_remove(name)
        return True

    @_locked
    def group_members(self, name: str) -> Optional[List[int]]:
        if name in self._paused:
            hri = self._paused[name]
            return [int(r) for r in np.where(hri["member"])[0]]
        row = self.rows.row(name)
        if row is None:
            return None
        return [int(r) for r in np.where(self._member_np[:, row])[0]]

    @_locked
    def is_stopped(self, name: str) -> bool:
        if name in self._paused:
            return bool(self._paused[name].get("stopped"))
        row = self.rows.row(name)
        return row is not None and row in self._stopped_rows

    @_locked
    def exec_watermarks(self, name: str) -> Optional[np.ndarray]:
        """Per-replica-slot execution watermark for the group ([R] int)."""
        if name in self._paused:
            return np.array(self._paused[name]["exec_slot"])
        row = self.rows.row(name)
        if row is None:
            return None
        return self._dev_exec_col(row)

    # ---------------------------------------------------------- placement
    def shard_geometry(self) -> tuple:
        """(groups_shards, rows_per_shard): mesh shard k owns the
        contiguous row range [k*per, (k+1)*per)."""
        gs = self.mesh.shape[GROUPS_AXIS] if self.mesh is not None else 1
        return gs, self.G // gs

    @_locked
    def free_rows_in_shard(self, shard: int) -> int:
        """Free-row capacity of one mesh shard (rebalancer's budget)."""
        gs, _per = self.shard_geometry()
        lo, hi = st.shard_row_range(self.G, gs, shard)
        return sum(1 for r in self.rows._free if lo <= r < hi)

    @_locked
    def blob_bytes_of_row(self, row: int) -> int:
        """Checkpoint-blob size a migration of ``row`` would transfer (the
        rebalancer's move-cost estimator; MigrationStats.bytes_transferred
        records the same quantity after the fact).  0 for free rows.

        Serializes one member's checkpoint, so call it only at plan time,
        never per tick."""
        name = self.rows.name(int(row))
        if name is None:
            return 0
        for r in range(self.R):
            if self.alive[r] and self._member_np[r, int(row)]:
                blob = self.apps[r].checkpoint(name)
                return len(blob) if blob is not None else 0
        return 0

    def demand_snapshot(self):
        """Host view of the per-group demand EWMA [G] (None when the
        placement plane is disabled).  Device-folded demand is pulled at
        most every ``placement.sample_every_ticks`` ticks."""
        p = self._placement
        if p is None:
            return None
        if self._demand_dev is not None and p.should_sample():
            p.sample_device()  # one device->host pull per sample window
        return p.demand_snapshot()

    # ------------------------------------------------------------ pause
    def _resident_row(self, name: str) -> Optional[int]:
        """Row of ``name``, transparently unpausing a paused group."""
        row = self.rows.row(name)
        if row is not None:
            return row
        if name in self._paused:
            return self._unpause(name)
        return None

    def _alloc_row(self, name: str) -> Optional[int]:
        """Row allocation with eviction under pressure: a full table
        force-pauses the coldest quiescent group to make room."""
        if self.rows.full():
            evicted = self._pause_eligible(limit=1, ignore_idle=True)
            if not evicted:
                return None  # every row is hot — table genuinely full
        return self.rows.alloc(name)

    @_locked
    def pause_idle(self, limit: int = 64) -> int:
        """Deactivator analog: pause groups idle for
        ``deactivation_ticks``.  Returns the number paused."""
        return len(self._pause_eligible(limit=limit, ignore_idle=False))

    def _pause_eligible(self, limit: int, ignore_idle: bool) -> List[str]:
        # quiescence is judged against host bookkeeping — admit staged
        # proposals and complete any pipelined pending outbox first
        self._drain_staged()
        self.drain_pipeline()
        idle_after = 0 if ignore_idle else self.cfg.paxos.deactivation_ticks
        exec_slot = self._field_np("exec_slot")
        next_slot = self._field_np("next_slot")
        member = self._member_np
        # rows referenced by live/queued bulk requests are not pausable
        bulk_ref = None
        if self.bulk is not None and (
            self.bulk.n_live or self._bulk_leftover.size or self._bulk_chunks
        ):
            bulk_ref = np.zeros(self.G_total, bool)
            bulk_ref[self.bulk.row[self.bulk.valid]] = True
            parts = ([self._bulk_leftover] if self._bulk_leftover.size
                     else []) + self._bulk_chunks
            if parts:
                q = np.concatenate(parts)
                qi, qlive = self.bulk.lookup(q)
                bulk_ref[self.bulk.row[qi[qlive]]] = True
        # coldest first so eviction keeps the working set hot
        cands = sorted(
            self.rows.items(), key=lambda kv: self._last_active[kv[1]]
        )
        paused: List[str] = []
        for name, row in cands:
            if len(paused) >= limit:
                break
            if row >= self.G:
                # register rows never pause: their whole footprint is the
                # register cell (no ring to reclaim)
                continue
            if self.tick_num - self._last_active[row] < idle_after:
                if not ignore_idle:
                    break  # sorted: everything later is hotter
                continue
            if self._queues.get(row) or self._row_outstanding[row] > 0:
                continue
            if bulk_ref is not None and bulk_ref[row]:
                continue
            ms = np.where(member[:, row])[0]
            if len(ms) == 0:
                continue
            ex = exec_slot[ms, row]
            # quiescent = every member executed everything anyone assigned
            if ex.min() != ex.max() or next_slot[ms, row].max() > ex.min():
                continue
            paused.append(name)
        if paused:
            self._do_pause(paused)
            if self.wal is not None:
                self.wal.log_pause(paused)
        return paused

    def _kv_clear_rows(self, rows) -> None:
        """Scrub device-app KV rows on free, in place: a recycled row must
        not leak the previous occupant's keys to the next group."""
        if self.kv is not None and len(rows):
            r = torch.as_tensor(np.asarray(rows, np.int64),
                                device=self.device)
            self.kv.key[:, r] = 0
            self.kv.val[:, r] = 0

    def _do_pause(self, names: List[str]) -> None:
        """Pause exactly ``names`` (selection already done)."""
        rows_to_free = []
        for name in names:
            row = self.rows.row(name)
            with self._owning(row, write=False) as (pst, prow):
                hri = st.extract_hri(pst, prow)
            hri["stopped"] = row in self._stopped_rows
            if self.kv is not None:
                # device-app state is keyed by row: it rides the spilled
                # record or pause would silently drop it
                hri["dkv_key"] = st.to_host(self.kv.key[:, row])
                hri["dkv_val"] = st.to_host(self.kv.val[:, row])
            self._paused[name] = hri
            rows_to_free.append(row)
        for pst, prows, _ in self._row_blocks(np.array(rows_to_free)):
            st.free_groups(pst, prows)
        self._kv_clear_rows(rows_to_free)
        self._clear_member_rows(rows_to_free)
        self._lease_drop_rows(rows_to_free)
        self._health_drop_rows(rows_to_free)
        for name in names:
            row = self.rows.free(name)
            self._stopped_rows.discard(row)
            self._stopped_np[row] = False
            self._queues.pop(row, None)
        self.stats["paused"] += len(names)

    def _unpause(self, name: str) -> Optional[int]:
        hri = self._paused.get(name)
        if hri is None:
            return None
        row = self._alloc_row(name)
        if row is None:
            return None
        del self._paused[name]
        # reset the row to a clean slate, then restore the scalar columns
        mask = hri["member"].reshape(1, -1)
        with self._owning(row) as (pst, prow):
            st.create_groups(pst, np.array([prow]), mask,
                             np.array([hri["epoch"]], np.int32))
            st.hot_restore(pst, prow, hri)
        self._set_member_row(row, mask[0], name)
        # pause holds drained state (host == device), so the restored
        # device watermark is also the host-applied one for this row
        self._host_exec[:, row] = np.asarray(hri["exec_slot"], np.int32)
        if self.kv is not None and "dkv_key" in hri:
            self.kv.key[:, row] = torch.as_tensor(hri["dkv_key"],
                                                  device=self.device)
            self.kv.val[:, row] = torch.as_tensor(hri["dkv_val"],
                                                  device=self.device)
        if hri.get("stopped"):
            self._stopped_rows.add(row)
            self._stopped_np[row] = True
        self._last_active[row] = self.tick_num
        self.stats["unpaused"] += 1
        if self.wal is not None:
            self.wal.log_unpause(name)
        return row

    def paused_count(self) -> int:
        return len(self._paused)

    # ---------------------------------------------------------------- propose
    def read(
        self,
        name: str,
        payload: bytes = b"",
        callback: Optional[Callable[[int, bytes], None]] = None,
        deadline: Optional[int] = None,
    ) -> Optional[int]:
        """Linearizable read.

        Answered LOCALLY (no consensus round, no journal entry) iff the last
        completed tick's lease mirror shows a live holder whose lease has
        not expired (less any injected skew) AND the group is quiescent:
        the holder's executed frontier equals the accepted frontier as of
        that same tick, so every acked write is applied at the holder.
        Otherwise the read falls back to a CLS_READ propose through the
        ordered stream (a classic consensus read).

        ``payload`` must be side-effect-free under the app's ``execute``.
        The callback fires ``(rid, response)`` like propose's; local reads
        use rid 0 and fire synchronously.
        """
        if deadline is not None and _overload.expired(deadline):
            _overload.count_expired("intake", self._ov_node)
            if callback is not None:
                callback(_overload.RID_EXPIRED, None)
            return None
        row = self.rows.row(name)  # racy read: benign (propose's argument)
        lp = self._lease_np
        if (lp is not None and row is not None
                and row not in self._stopped_rows):
            holder = int(lp[LP_HOLDER, row])
            if (holder >= 0 and self.alive[holder]
                    and (self._lease_clock - self._lease_skew_ticks)
                    < int(lp[LP_UNTIL, row])
                    and int(self._host_exec[holder, row])
                    == int(lp[LP_ASN, row])):
                resp = self.apps[holder].execute(name, payload, 0)
                self._reads_local_c.inc()
                self.stats["local_reads"] += 1
                if callback is not None:
                    callback(0, resp)
                return 0
        self._reads_fallback_c.inc()
        return self.propose(name, payload, callback, deadline=deadline,
                            cls=_overload.CLS_READ)

    def propose(
        self,
        name: str,
        payload: bytes,
        callback: Optional[Callable[[int, bytes], None]] = None,
        stop: bool = False,
        entry: Optional[int] = None,
        deadline: Optional[int] = None,
        cls: int = _overload.CLS_CONTROL,
    ) -> Optional[int]:
        """propose/proposeStop analog.

        ``deadline``: absolute wire deadline (unix ms); a request still
        staged when it passes is dropped at intake with callback
        ``(RID_EXPIRED, None)``.  ``cls``: traffic class; CLS_CLIENT
        proposes are refused with ``(RID_BUSY, None)`` while the intake
        governor sheds, CLS_CONTROL (default) is never governed.  While
        the WAL cannot make writes durable (failed, or below its free-space
        watermark) every propose is refused with ``(-1, None)``.

        Returns the request id, or None if the group is unknown (or fenced
        by a stop).  The common case takes NO manager lock: the request is
        staged into a thread-safe deque the next tick drains.
        """
        if self.wal is not None and not self.wal.accepting_writes():
            return self._shed_propose(callback)
        if (cls != _overload.CLS_CONTROL and self.overload is not None
                and not self.overload.admit(cls)):
            return self._shed_busy(callback, cls)
        row = self.rows.row(name)  # racy read: benign (see docstring)
        if row is None:
            if name in self._paused:
                # paused group: unpause needs the lock anyway (rare path)
                return self._propose_locked(name, payload, callback, stop,
                                            entry)
            return None
        if row in self._stopped_rows:
            return self._propose_locked(name, payload, callback, stop, entry)
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        self._staged.append((rid, name, payload, callback, stop, entry,
                             deadline))
        if self.reqtrace.enabled:
            self.reqtrace.event(rid, "staged", name=name)
        return rid

    @_locked
    def _shed_propose(self, callback):
        """Storage low-watermark / failed WAL: refuse new writes with the
        retriable failure convention (response None) while reads and the
        already-admitted pipeline keep serving.  The disk-full case clears
        itself once space returns; the failed case fail-stops the node at
        the next tick anyway."""
        self.wal.note_shed()
        if callback is not None:
            self._held_callbacks.append((callback, -1, None))
        self.stats["shed_requests"] += 1
        self.stats["failed_requests"] += 1
        return None

    @_locked
    def _shed_busy(self, callback, cls: int = _overload.CLS_CLIENT):
        """Intake governor shed: the callback fires with RID_BUSY (retry
        the same active after backoff)."""
        if callback is not None:
            self._held_callbacks.append((callback, _overload.RID_BUSY, None))
        self.stats["shed_requests"] += 1
        _overload.count_shed(cls, "intake", self._ov_node)
        return None

    @_locked
    def _propose_locked(self, name, payload, callback, stop, entry):
        """Slow path (paused or fenced groups)."""
        row = self._resident_row(name)
        if row is None:
            return None
        if row in self._stopped_rows:
            # stopped epoch: fail fast so the client can re-resolve actives
            if callback is not None:
                self._held_callbacks.append((callback, -1, None))
            self.stats["failed_requests"] += 1
            return None
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        if self.reqtrace.enabled:
            self.reqtrace.event(rid, "staged", name=name, path="slow")
        self._admit(rid, name, row, payload, callback, stop, entry)
        return rid

    def _admit(self, rid, name, row, payload, callback, stop, entry) -> None:
        """Insert one request into the per-row queues (manager lock held)."""
        if isinstance(payload, bytes):
            payload = self._paystore.intern(payload)
        members = np.where(self._member_np[:, row])[0]
        if entry is None or entry not in members:
            # spread entry replicas across the group's members
            entry = int(members[rid % len(members)]) if len(members) else 0
        rec = RequestRecord(rid, name, row, payload, stop, callback, entry)
        self.outstanding[rid] = rec
        self._row_outstanding[row] += 1
        self._queues[row].append(rid)
        self._last_active[row] = self.tick_num
        if self.reqtrace.enabled:
            self.reqtrace.event(rid, "admitted", row=row, entry=entry)

    def _drain_staged(self) -> None:
        """Admit every staged proposal (start of each tick, lock held).
        Re-entrancy guard: unpausing under row pressure evicts via
        ``_pause_eligible``, which itself drains staged work."""
        if self._draining:
            return
        self._draining = True
        try:
            while True:
                try:
                    rid, name, payload, callback, stop, entry, deadline = \
                        self._staged.popleft()
                except IndexError:
                    return
                if _overload.expired(deadline):
                    # deadline passed while staged: nobody is waiting
                    if callback is not None:
                        self._held_callbacks.append(
                            (callback, _overload.RID_EXPIRED, None))
                    self.stats["expired_drops"] += 1
                    _overload.count_expired("intake", self._ov_node)
                    continue
                row = self._resident_row(name)
                if row is None or row in self._stopped_rows:
                    # the group vanished or stopped between stage and drain
                    if callback is not None:
                        self._held_callbacks.append((callback, rid, None))
                    self.stats["failed_requests"] += 1
                    if self.reqtrace.enabled:
                        self.reqtrace.event(rid, "failed", name=name)
                    continue
                self._admit(rid, name, row, payload, callback, stop, entry)
        finally:
            self._draining = False

    def propose_stop(self, name: str, payload: bytes = b"", callback=None):
        return self.propose(name, payload, callback, stop=True)

    # -------------------------------------------------------- bulk (fast path)
    def _ensure_bulk(self) -> BulkStore:
        if self.bulk is None:
            self.bulk = BulkStore(self._bulk_cap)
            self._scr2_pos = np.zeros(self._bulk_cap, np.int64)
            self._scr2_gen = np.zeros(self._bulk_cap, np.int64)
        return self.bulk

    def _member_ordinals(self) -> np.ndarray:
        """[R, G] ordinal of each member within its group (cached)."""
        if self._member_ord is None:
            m = self._member_np.astype(np.int32)
            self._member_ord = np.cumsum(m, axis=0) - m
        return self._member_ord

    @_locked
    def propose_bulk(self, rows, payloads, stops=None,
                     callbacks=None, entries=None,
                     batch_sink=None,
                     cls: int = _overload.CLS_CLIENT) -> np.ndarray:
        """Vectorized propose: admit one request per entry of ``rows`` (row
        indices into the group table) in a single columnar operation.

        ``payloads``: one bytes object (shared by all) or a sequence of
        per-request bytes.  Returns the assigned rid array (int64);
        negative entries were not admitted and no callback fires for them:
        -1 = target row unknown/stopped, -2 = store window full or intake
        shed (transient backpressure).  ``callbacks``: optional per-request
        ``cb(rid, response_or_None)`` list aligned with ``rows``.
        ``batch_sink``: optional columnar completion ``sink(offsets,
        responses)`` for the admitted block (offsets = rid - first rid).
        Callbacks and sinks fire only once the WAL covering the request's
        tick is fsynced (log-before-respond).
        """
        t_in = time.perf_counter()  # the requests' wait starts here
        if self._device_app and not self._in_kv_admit:
            raise ValueError(
                "device-app managers admit bulk work via propose_bulk_kv "
                "(a plain payload has no descriptor and could never place)"
            )
        if self.wal is not None and not self.wal.accepting_writes():
            # storage low-watermark / failed WAL: whole batch sheds with
            # the transient-backpressure code (-2, plain retry); no
            # callback fires
            self.wal.note_shed()
            n = len(rows)
            self.stats["shed_requests"] += n
            self.stats["failed_requests"] += n
            return np.full(n, -2, np.int64)
        if (cls == _overload.CLS_CLIENT and self.overload is not None
                and not self.overload.admit(cls)):
            n = len(rows)
            self.stats["shed_requests"] += n
            _overload.count_shed(_overload.CLS_CLIENT, "intake",
                                 self._ov_node, n)
            return np.full(n, -2, np.int64)
        store = self._ensure_bulk()
        rows = np.asarray(rows, np.int64)
        out = np.full(len(rows), -1, np.int64)
        ok = (self._n_members_np[rows] > 0) & ~self._stopped_np[rows]
        if stops is not None:
            stops = np.asarray(stops, bool)
        if not ok.all():
            self.stats["failed_requests"] += int((~ok).sum())
            rows = rows[ok]
            if stops is not None:
                stops = stops[ok]
            if not isinstance(payloads, (bytes, bytearray)):
                payloads = [p for p, o in zip(payloads, ok) if o]
            if callbacks is not None:
                callbacks = [c for c, o in zip(callbacks, ok) if o]
        n = len(rows)
        if n == 0:
            return out
        # bounded-outstanding backpressure: admit only what the store
        # window can hold; the remainder returns -2 (retry later)
        store._advance_lo()
        with self._rid_lock:
            rid0 = self._next_rid
            if store.n_live == 0:
                store.lo = rid0  # empty store: no slot can collide
                room = store.cap
            else:
                room = store.cap - (rid0 - store.lo)
            n_adm = max(0, min(n, room))
            self._next_rid += n_adm
        if self._next_rid >= 2**31:
            raise OverflowError("rid space exhausted (int32 device ids)")
        if n_adm == 0:
            self.stats["backpressured"] += n
            out[ok] = -2
            return out
        if n_adm < n:
            self.stats["backpressured"] += n - n_adm
            out[np.nonzero(ok)[0][n_adm:]] = -2
            rows = rows[:n_adm]
            if stops is not None:
                stops = stops[:n_adm]
            if not isinstance(payloads, (bytes, bytearray)):
                payloads = payloads[:n_adm]
        # spread entry duty across each group's members by rid rotation
        # (or pin it to a requested member, falling back to rotation)
        nm = self._n_members_np[rows]
        k = ((rid0 + np.arange(n_adm)) % nm).astype(np.int32)
        om = self._member_ordinals()
        ent = np.zeros(n_adm, np.int32)
        for r in range(self.R):
            sel = self._member_np[r, rows] & (om[r, rows] == k)
            ent[sel] = r
        if entries is not None:
            e = int(entries)
            ent = np.where(self._member_np[e, rows], e, ent).astype(np.int32)
        if self.cfg.paxos.emulate_unreplicated:
            # measurement baseline (emulateUnreplicated,
            # PaxosManager.java:1751-1799): execute at the entry replica
            # now, respond, touch nothing else — no store, no tick, no
            # journal
            resps = self._baseline_exec(
                rows, ent, payloads, rid0 + np.arange(n_adm, dtype=np.int64),
                callbacks, eager_fire=True)
            if batch_sink is not None:
                # inline columnar delivery: no tick ever runs to route a
                # sink block, and the baseline has no durability to gate
                batch_sink(np.arange(n_adm, dtype=np.int64), resps)
            self.stats["decisions"] += n_adm
            out[np.nonzero(ok)[0][:n_adm]] = rid0 + np.arange(n_adm)
            return out
        if not isinstance(payloads, (bytes, bytearray)):
            # per-request bodies: intern so duplicates collapse to one
            # shared object
            payloads = [
                self._paystore.intern(p) if isinstance(p, bytes) else p
                for p in payloads
            ]
        rids = store.admit(rid0, rows.astype(np.int32), ent, stops,
                           payloads, now=t_in)
        if batch_sink is not None:
            self._sink_blocks.append([rid0, n_adm, n_adm, batch_sink])
        if callbacks is not None:
            for rid, cb in zip(rids, callbacks):
                if cb is not None:
                    self._bulk_cbs[int(rid)] = cb
        if self.cfg.paxos.lazy_propagation:
            # measurement baseline (emulateLazyPropagation /
            # EXECUTE_UPON_ACCEPT): the entry replica executes and responds
            # now; the request still rides the consensus stream, so the
            # other replicas converge through ordinary decisions (their
            # mark_executed skips the entry's pre-set bit)
            idx = store.idx_of(rids)
            self._baseline_exec(rows, ent, store.payload[idx], rids,
                                callbacks=None, eager_fire=False,
                                store_idx=idx)
        self._bulk_chunks.append(rids)
        self._last_active[rows] = self.tick_num
        out[np.nonzero(ok)[0][:n_adm]] = rids
        return out

    def _baseline_exec(self, rows, ent, payloads, rids, callbacks,
                       eager_fire: bool, store_idx=None) -> list:
        """Entry-replica immediate execution for the two measurement
        baselines.  With ``store_idx`` (lazy mode) the store's entry exec
        bit and responded flag are pre-set so commit-time execution skips
        the entry replica and never responds again.  Returns the responses
        aligned with the input order (b"" where the app returned none)."""
        if isinstance(payloads, (bytes, bytearray)):
            pa = np.empty(len(rows), object)
            pa[:] = bytes(payloads)
            payloads = pa
        payloads = np.asarray(payloads, object)
        rows = np.asarray(rows, np.int64)
        eager: list = []
        out_resps: list = [b""] * len(rows)
        for r in range(self.R):
            sel = ent == r
            if not sel.any():
                continue
            erb = getattr(self.apps[r], "execute_rows_batch", None)
            if erb is not None:
                resp = erb(rows[sel], payloads[sel], rids[sel])
            else:
                resp = self.apps[r].execute_batch(
                    self._row_name_np[rows[sel]], payloads[sel], rids[sel])
            self.stats["executions"] += int(sel.sum())
            if store_idx is not None:
                si = store_idx[sel]
                self.bulk.exec_mask[si] |= np.int64(1) << r
                self.bulk.responded[si] = True
                if resp is not None:
                    ra = np.empty(len(si), object)
                    ra[:] = resp
                    self.bulk.response[si] = ra
                if self._bulk_cbs or self._sink_blocks:
                    self._bulk_fire(rids[sel],
                                    resp if resp is not None
                                    else [b""] * int(sel.sum()))
            else:
                for pos, j in enumerate(np.nonzero(sel)[0]):
                    r_j = resp[pos] if resp is not None else b""
                    out_resps[j] = r_j or b""
                    if eager_fire and callbacks is not None \
                            and callbacks[j] is not None:
                        # fired inline below, never through the shared
                        # durability-gated queue, whose other occupants
                        # must keep waiting for their WAL sync
                        eager.append((callbacks[j], int(rids[j]),
                                      r_j or b""))
        if eager_fire:
            # the unreplicated baseline responds inline (no durability by
            # definition)
            for cb, rid, resp in eager:
                cb(rid, resp)
        return out_resps

    def _bulk_fire(self, rids, responses=None) -> None:
        """Queue completion callbacks for bulk rids that just reached their
        responded transition."""
        if self._sink_blocks:
            self._sink_route(rids, responses)
        if not self._bulk_cbs:
            return
        held = self._held_callbacks
        n0 = len(held)
        if responses is None:
            for rid in rids:
                cb = self._bulk_cbs.pop(int(rid), None)
                if cb is not None:
                    self._held_callbacks.append((cb, int(rid), None))
        else:
            for rid, resp in zip(rids, responses):
                cb = self._bulk_cbs.pop(int(rid), None)
                if cb is not None:
                    if resp is not None and not isinstance(
                            resp, (bytes, bytearray)):
                        # device-app responses are int32 scalars
                        resp = struct.pack("<i", int(resp))
                    self._held_callbacks.append((cb, int(rid), resp))
        n = len(held) - n0
        if n == len(rids):
            self._held_rids.append(np.asarray(rids, np.int64))
        elif n:
            self._held_rids.append(np.fromiter(
                (h[1] for h in held[n0:]), np.int64, count=n))

    def _sink_route(self, rids, responses) -> None:
        """Deliver completions to their rid-block sinks: ONE thunk per
        (sink, fire) instead of a Python callback per request.
        ``responses`` None = failure."""
        a = np.asarray(rids, np.int64)
        if a.size == 0:
            return
        blocks = self._sink_blocks
        starts = np.fromiter((b[0] for b in blocks), np.int64,
                             count=len(blocks))
        bi = np.searchsorted(starts, a, "right") - 1
        gc = False
        for k in np.unique(bi):
            if k < 0:
                continue
            blk = blocks[k]
            sel = bi == k
            offs = (a[sel] - blk[0])
            inside = offs < blk[1]
            if not inside.any():
                continue
            offs = offs[inside]
            if responses is None:
                resp_sel = None
            else:
                idx = np.nonzero(sel)[0][inside]
                resp_sel = [responses[i] for i in idx]
            blk[2] -= len(offs)
            gc = gc or blk[2] <= 0
            sink = blk[3]

            def fire(_rid, _resp, s=sink, o=offs, rr=resp_sel):
                s(o, rr)

            self._held_callbacks.append((fire, -1, None))
            self._held_rids.append(offs + blk[0])
        if gc:
            self._sink_blocks = [b for b in blocks if b[2] > 0]

    @_locked
    def propose_bulk_kv(self, rows, ops, keys, vals,
                        callbacks=None, entries=None) -> np.ndarray:
        """Device-app propose: admit requests whose execution is a KV
        descriptor (op, key, val), uploaded to the device table inside the
        fused tick — the decision stream never surfaces as host work.
        Returns rids like :meth:`propose_bulk` (negative = not admitted)."""
        assert self._device_app, "propose_bulk_kv needs cfg.paxos.device_app"
        self._in_kv_admit = True
        try:
            out = self.propose_bulk(rows, b"", callbacks=callbacks,
                                    entries=entries)
        finally:
            self._in_kv_admit = False
        adm = out >= 0
        if adm.any():
            self._kv_chunks.append((
                out[adm],
                np.asarray(ops, np.int32)[adm],
                np.asarray(keys, np.int32)[adm],
                np.asarray(vals, np.int32)[adm],
            ))
        return out

    def _take_kv_uploads(self):
        """Pull up to kv_reg_budget staged descriptors for this tick's
        fused upload; advances the placement watermark.  Returns padded
        [K] arrays (rid 0 = empty slot)."""
        K = self._kv_reg_budget
        take, total = [], 0
        while self._kv_chunks and total < K:
            c = self._kv_chunks[0]
            room = K - total
            if len(c[0]) <= room:
                take.append(c)
                total += len(c[0])
                self._kv_chunks.pop(0)
            else:
                take.append(tuple(a[:room] for a in c))
                self._kv_chunks[0] = tuple(a[room:] for a in c)
                total += room
        cols = [np.zeros(K, np.int32) for _ in range(4)]
        o = 0
        for c in take:
            n = len(c[0])
            for dst, a in zip(cols, c):
                dst[o:o + n] = a
            o += n
        if o:
            self._kv_watermark = max(self._kv_watermark,
                                     int(cols[0][:o].max()))
        self._kv_uploaded = (tuple(a[:o].copy() for a in cols) if o
                             else None)
        return tuple(cols)

    def bulk_response(self, rid: int):
        """Response payload of an entry-replica-completed bulk request;
        None once freed (or unknown), and None until the WAL covering the
        request's tick is fsynced."""
        if self.wal is not None and not self.wal.is_synced():
            return None
        s = self.bulk
        if s is None:
            return None
        i = rid & s.mask
        if s.valid[i] and s.rid[i] == rid:
            return s.response[i]
        return None

    def bulk_stats(self) -> dict:
        s = self.bulk
        return {
            "live": 0 if s is None else s.n_live,
            "done": 0 if s is None else s.done,
            "queued": int(self._bulk_leftover.size)
            + sum(len(c) for c in self._bulk_chunks),
        }

    def _first_occurrence(self, keys: np.ndarray, scr_pos, scr_gen) -> np.ndarray:
        """Mask of first occurrences of each key, order-preserving, O(n)."""
        self._gen += 1
        pos = np.arange(len(keys))
        # reversed scatter: the FIRST occurrence is written last and wins
        scr_pos[keys[::-1]] = pos[::-1]
        scr_gen[keys[::-1]] = self._gen
        return (scr_gen[keys] == self._gen) & (scr_pos[keys] == pos)

    def _purge_row_outstanding(self, row: int) -> None:
        """Drop placed-but-unfinished records of a removed group."""
        gone = [rid for rid, rec in self.outstanding.items() if rec.row == row]
        for rid in gone:
            rec = self.outstanding.pop(rid)
            if rec.callback is not None and not rec.responded:
                self._held_callbacks.append((rec.callback, rid, None))
        self._row_outstanding.pop(row, None)

    def _fail_queued(self, row: int) -> None:
        """Fail queued-but-never-committed requests for a stopped/removed
        group: callbacks fire with response None."""
        q = self._queues.pop(row, None)
        if not q:
            return
        for rid in q:
            rec = self.outstanding.pop(rid, None)
            if rec is not None:
                self._row_outstanding[rec.row] -= 1
                if rec.callback is not None and not rec.responded:
                    self._held_callbacks.append((rec.callback, rid, None))
            self.stats["failed_requests"] += 1
            if self.reqtrace.enabled:
                self.reqtrace.event(rid, "failed", reason="group_fenced")

    # ------------------------------------------------------------------- tick
    def _build_inbox(self, reg=None):
        """This tick's inbox on the device, and the device app's descriptor
        columns ``reg`` uploaded with it."""
        self._drain_staged()
        # pinned staging: the last inbox's uploads must have read it
        for ev in self._uploaded:
            ev.synchronize()
        self._uploaded = []
        # lazily clear last tick's placements instead of reallocating R*P*G
        req, stp = self._in_req, self._in_stp
        for _row, take in self._placed:
            for _rid, entry, p in take:
                req[entry, p, _row] = 0
                stp[entry, p, _row] = False
        if self._bulk_placed is not None:
            _r, _e, _p, _rw = self._bulk_placed
            req[_e, _p, _rw] = 0
            stp[_e, _p, _rw] = False
            self._bulk_placed = None
        placed = []
        for row, q in self._queues.items():
            used = collections.Counter()
            take = []
            while q and len(take) < self.P:
                rid = q.popleft()
                rec = self.outstanding.get(rid)
                if rec is None:
                    continue
                if not self.alive[rec.entry]:
                    # re-home the request to a live *member* so the response
                    # callback is not orphaned on a dead entry node
                    ms = np.where(self._member_np[:, row])[0]
                    live = [m for m in ms if self.alive[m]]
                    if not live:
                        q.appendleft(rid)
                        break
                    rec.entry = int(live[0])
                entry = rec.entry
                p = used[entry]
                if p >= self.P:
                    q.appendleft(rid)
                    break
                used[entry] += 1
                req[entry, p, row] = rid
                stp[entry, p, row] = rec.stop
                take.append((rid, entry, p))
                if self.reqtrace.enabled:
                    self.reqtrace.event(rid, "placed", tick=self.tick_num)
            if take:
                placed.append((row, take))
        self._placed = placed
        self._place_bulk(req, stp, placed)
        # the liveness view this inbox carries (journaled by the WAL from
        # the host copy: the device copy is never read back)
        self._inbox_alive = self.alive.copy()
        if self._res is not None:
            return self._upload_shards(req, stp), reg
        # device copies: the staging buffers are mutated next tick
        dev, dt = self.device, self._dt
        t_up = dt.start()
        inbox = TickInbox(torch.from_numpy(req).to(dev, copy=True),
                          torch.from_numpy(stp).to(dev, copy=True),
                          torch.from_numpy(self._inbox_alive).to(dev))
        if reg is not None:
            reg = tuple(torch.from_numpy(c).to(dev) for c in reg)
        dt.stop("upload", t_up)
        return inbox, reg

    def _upload_shards(self, req, stp) -> dict:
        """Each mesh shard's ``[R/rs, P, G/gs]`` inbox block on its
        device, one contiguous row of the staging at a time (no host
        copy), on the device's stream, timed as the shard's "upload";
        ``alive`` goes whole to every shard.  From pinned staging (a CUDA
        mesh) the copies do not block the host."""
        mesh = self.mesh
        rl, gl = self.R // mesh.replica_shards, self._res.rows_per_shard
        pinned = self._staging_pinned is not None
        alive = torch.from_numpy(self._inbox_alive)
        if pinned:
            alive = alive.pin_memory()
        srcs = (torch.from_numpy(req), torch.from_numpy(stp))
        out = {}
        for k in mesh.shards():
            ri, gi = k
            dev, timers = mesh.device_at(ri, gi), self._dts[k]
            t_up = timers.start()
            blk = []
            for src in srcs:
                dst = torch.empty((rl, self.P, gl), dtype=src.dtype,
                                  device=dev)
                for r in range(rl):
                    for p in range(self.P):
                        dst[r, p].copy_(
                            src[ri * rl + r, p, gi * gl:(gi + 1) * gl],
                            non_blocking=pinned)
                blk.append(dst)
            out[k] = TickInbox(blk[0], blk[1],
                               alive.to(dev, non_blocking=pinned,
                                        copy=True))
            timers.stop("upload", t_up)
            if pinned and dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._uploaded.append(ev)
        return out

    def _place_bulk(self, req, stp, placed) -> None:
        """Vectorized placement of the bulk queue into the staging arrays:
        up to P first-occurrence passes per (entry, row) key; the remainder
        stays queued in arrival order."""
        if not self._bulk_chunks and not self._bulk_leftover.size:
            return
        parts = ([self._bulk_leftover] if self._bulk_leftover.size else []) \
            + self._bulk_chunks
        self._bulk_chunks = []
        q = parts[0] if len(parts) == 1 else np.concatenate(parts)
        store = self.bulk
        idx, live = store.lookup(q)
        if not live.all():
            q, idx = q[live], idx[live]
        rows = store.row[idx]
        # rows gone dead under queued requests (removed/stopped): drop them
        bad = (self._n_members_np[rows] == 0) | self._stopped_np[rows]
        if bad.any():
            if self._bulk_cbs or self._sink_blocks:
                self._bulk_fire(q[bad])  # group gone: cb(None), client retries
            store.fail(idx[bad])
            self.stats["failed_requests"] += int(bad.sum())
            q, idx, rows = q[~bad], idx[~bad], rows[~bad]
        if not len(q):
            self._bulk_leftover = np.zeros(0, np.int64)
            return
        hold = np.zeros(0, np.int64)
        if self._device_app:
            # a request may only be placed once its descriptor upload is on
            # (or riding to) the device — rids beyond the watermark wait
            wm = q <= self._kv_watermark
            if not wm.all():
                hold = q[~wm]
                q, idx, rows = q[wm], idx[wm], rows[wm]
                if not len(q):
                    self._bulk_leftover = hold
                    return
        entries = store.entry[idx]
        qk = np.zeros(0, np.int64)
        if not self.alive.all():
            # re-home requests whose entry replica is dead to the first
            # live member of their group (response duty must stay live)
            dead = ~self.alive[entries]
            if dead.any():
                lm = self._member_np & self.alive[:, None]  # [R, G]
                has = lm.any(axis=0)
                flm = np.argmax(lm, axis=0).astype(np.int32)
                fixable = dead & has[rows]
                ei = idx[fixable]
                store.entry[ei] = flm[rows[fixable]]
                entries = store.entry[idx]
                # groups with no live member at all: keep queued
                keep = ~self.alive[entries]
                if keep.any():
                    sel = ~keep
                    qk = q[keep]
                    q, idx, rows, entries = (q[sel], idx[sel], rows[sel],
                                             entries[sel])
        key = (entries.astype(np.int64) * self.G_total
               + rows).astype(np.intp)
        # up to P requests per (entry, row) per tick, in arrival order
        p = np.full(len(q), -1, np.int32)
        remaining = np.arange(len(q))
        for pp in range(self.P):
            if not len(remaining):
                break
            fo = self._first_occurrence(key[remaining], self._scr_pos,
                                        self._scr_gen)
            p[remaining[fo]] = pp
            remaining = remaining[~fo]
        # collision with slow-path placements at the same (entry, row):
        # shift this tick's bulk entries up past the used p slots
        if placed:
            used = collections.Counter()
            for row_, take in placed:
                for _rid, e_, _p in take:
                    used[(e_, row_)] += 1
            for (e_, row_), cnt in used.items():
                sel = (entries == e_) & (rows == row_) & (p >= 0)
                p[sel] += cnt
        fit = (p >= 0) & (p < self.P)
        if fit.any():
            fe, fp, fr, fi = entries[fit], p[fit], rows[fit], idx[fit]
            req[fe, fp, fr] = q[fit].astype(np.int32)
            stp[fe, fp, fr] = store.stop[fi]
            self._bulk_placed = (q[fit], fe, fp, fr)
            self._observe_wait("queue", fi)
        rest = q[~fit]
        parts = [p for p in (rest, hold, qk) if p.size]
        self._bulk_leftover = (np.concatenate(parts) if len(parts) > 1
                               else (parts[0] if parts else rest))

    def _observe_wait(self, stage: str, idx) -> None:
        """Observe the time since each bulk store slot ``idx`` was last
        stamped into ``stage``'s wait; a placement ("queue") stamps the
        slots anew."""
        t = self.bulk.t_stage
        w = t[idx]
        now = time.perf_counter()
        if stage == "queue":
            t[idx] = now
        # stamps come in blocks (one an admission or a placement): each run
        # of equal stamps is observed once, with its length
        starts = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
        self._wait_h[stage].observe_array(
            now - w[starts], np.diff(np.r_[starts, len(w)]))

    def _run_due_laggard_syncs(self) -> None:
        """Run checkpoint transfers noticed during tick completion, at the
        top of tick() after draining the pipeline: the transfer must
        capture the donor's device exec watermark and host app state at
        the SAME point."""
        due, self._lag_sync_due = self._lag_sync_due, []
        repaired, self._repaired_last = self._repaired_last, set()
        if not due:
            return
        if self._use_compact and self.cfg.paxos.device_donor_sel:
            # control-summary path: O(due) host work, no [R, G] pulls
            cand, seen = [], set()
            for r_, row_ in due:
                key = (int(r_), int(row_))
                if key in seen or key in repaired or not self.alive[key[0]]:
                    continue
                seen.add(key)
                cand.append(key)
            if not cand:
                return
            self.drain_pipeline()  # host apps catch up; refresh _lag_pending
            latest = {
                (int(r_), int(w_)): (int(d_), int(de_), int(ds_), int(le_))
                for r_, w_, d_, de_, ds_, le_ in zip(*self._lag_pending)
            }
            for key in cand:
                info = latest.get(key)
                if info is None or info[0] < 0:  # healed / no live donor
                    continue
                name = self.rows.name(key[1])
                if name is None:
                    continue
                if self._sync_from_summary(key[0], key[1], name, *info):
                    self._repaired_last.add(key)
            return
        # host scan (full-outbox mode / device_donor_sel off): re-check lag
        # against CURRENT state first
        exec_slot = self._dev_exec_np()
        still, seen = [], set()
        for r_, row_ in due:
            key = (int(r_), int(row_))
            if key in seen or not self.alive[key[0]]:
                continue
            seen.add(key)
            ms = self._member_np[:, key[1]]
            if not ms[key[0]]:
                continue
            # per-row window: a register row (W=1) flags at any lag
            if (exec_slot[ms, key[1]].max() - exec_slot[key]
                    >= self._w_np[key[1]]):
                still.append(key)
        if not still:
            return
        self.drain_pipeline()  # host apps catch up to the device watermark
        for r_, row_ in still:
            name = self.rows.name(row_)
            if name:
                self.sync_laggard(r_, name)

    @_locked
    def tick(self):
        """One manager step.  Returns the tick's :class:`HostOutbox` (full
        mode) / :class:`CompactHostOutbox` (compact mode); in pipelined mode
        the return is the PREVIOUS tick's outbox (None on the first)."""
        pc = self._pc
        pc.begin()
        if self.overload is not None:
            # feed the intake governor once per tick: the node's backlog
            self.overload.update(
                self.pending_count() + len(self.outstanding)
                + (self.bulk.n_live if self.bulk is not None else 0))
        self._run_due_laggard_syncs()
        pc.mark("repair")
        # the device app's descriptor upload rides the same fused call as
        # the tick; the watermark advances BEFORE the build so those rids
        # place
        reg = self._take_kv_uploads() if self._device_app else None
        inbox, reg = self._build_inbox(reg)
        pc.mark("intake")
        dt = self._dt
        t_tick = dt.start()
        placed = self._placed
        bulk_placed = self._bulk_placed
        if self._device_app:
            # leases, health and register planes are refused at
            # construction, so the fused KV call is the whole tick
            with serial_on_cpu(self.device):
                self.state, self.kv, packed = fused_compact(
                    self.state, self.kv, inbox, *reg, -1,
                    self._exec_budget, self._lag_budget)
            lease_pack = health_pack = None
        elif self._res is not None:
            # one body a shard (parallel/shard_tick) on its resident block
            # and its inbox block, each on its device; ``packed`` holds the
            # shards' outboxes.  Leases, health and register planes are
            # refused with a mesh
            with serial_on_cpu(self.device):
                self._res.blocks, packed, demand = self._mesh_tick(
                    self._res.blocks, inbox, self._demand_dev, self._dts)
            if demand is not None:
                # placement: each column folded its decided_now
                self._demand_dev = demand
                self._placement.adopt_device(demand)
            lease_pack = health_pack = None
        elif self._demand_dev is not None:
            # placement on one device: the intake-demand EWMA folds inside
            # the scripted compact tick program (leases, health and
            # register planes keep the host fold)
            with serial_on_cpu(self.device):
                self.state, packed, self._demand_dev = (
                    paxos_tick_compact_demand(
                        self.state, inbox, self._demand_dev, -1,
                        self._exec_budget, self._lag_budget,
                        self._placement.decay))
            self._placement.adopt_device(self._demand_dev)
            lease_pack = health_pack = None
        else:
            # one dispatch covers every combination of planes and folds;
            # absent ones are None (the packed path runs with no budget)
            with serial_on_cpu(self.device):
                (self.state, self.rstate, self._lease, self._rlease,
                 self._health, self._rhealth, pk_l, pk_r, lp_l, lp_r, hp_l,
                 hp_r) = paxos_tick_health(
                    self.state, self.rstate, self._lease, self._rlease,
                    self._health, self._rhealth, inbox, -1,
                    self._exec_budget if self._use_compact else 0,
                    self._lag_budget, self._lease_horizon,
                    self._use_compact, self._health_wedge,
                    self._health_shift, self._health_topk)
            packed = pk_l if pk_r is None else (pk_l, pk_r)
            lease_pack = lp_l if lp_r is None else (lp_l, lp_r)
            health_pack = hp_l if hp_r is None else (hp_l, hp_r)
        # device sweep frontier: computed only at the dispatch whose
        # completion runs _sweep_outstanding, from THIS tick's post-state,
        # with the O(rows) gather enqueued right behind it.  Mixed planes
        # skip it (its [G]-indexed gathers cover the log plane only) and
        # sweep from the composite host reductions.
        frontier = None
        done_at = self.tick_num + (2 if self.cfg.paxos.pipeline_ticks else 1)
        if self.rstate is None and done_at % self._sweep_every == 0 and (
            self.outstanding or (self.bulk is not None and self.bulk.n_live)
        ):
            frontier = (self._frontier_gather_mesh(inbox)
                        if self._res is not None else
                        self._frontier_gather(sweep_frontier(
                            self.state.exec_slot, self.state.member,
                            inbox.alive)))
        dt.stop("tick", t_tick)
        if self._obs_block:
            # opt-in exact device step: costs the pipeline overlap
            self._sync_device()
            pc.mark(_BLOCKING_PHASE)
        # the outbox starts for the host now, behind this tick's work;
        # completion waits for the copy alone, not for later ticks' kernels
        if self._res is not None:
            packed = self._start_shard_copies(packed)
        else:
            packed = self._outcopy.start(packed)
        pc.mark("dispatch")
        if self.wal is not None:
            self.wal.log_inbox(self.tick_num, self._inbox_alive)
        pc.mark("wal_fsync")
        self.tick_num += 1
        if self.cfg.paxos.pipeline_ticks:
            # deferred unpack: tick N's outbox, copied since its dispatch,
            # is read at tick N+1's completion
            if self._pending_out is not None:
                prev = self._pending_out
                self._pending_out = None  # before completing: _complete_tick
                # may reach drain_pipeline (pause_idle) — must not re-enter
                out = self._complete_tick(*prev)
            else:
                # drain_pipeline may have completed the previous tick's
                # outbox moments ago; hand that stashed result out
                out, self._drained_out = self._drained_out, None
            self._pending_out = (packed, placed, bulk_placed, frontier,
                                 lease_pack, health_pack, pc.tick)
            # a due checkpoint must cover on-host effects of every tick the
            # device state contains — drain the one-tick pipeline first
            if self.wal is not None and self.wal.checkpoint_due():
                self.drain_pipeline()
        else:
            out = self._complete_tick(packed, placed, bulk_placed, frontier,
                                      lease_pack, health_pack)
        if self.wal is not None:
            self.wal.maybe_checkpoint()
        pc.end()
        return out

    def _start_shard_copies(self, packed: dict) -> dict:
        """Start each mesh shard's outbox copy through its own copier."""
        return {k: self._outcopies[k].start(flat)
                for k, flat in packed.items()}

    def _land_shard_copies(self, packed: dict) -> dict:
        """The shards' host buffers of one tick (see
        ``parallel.shard_tick.join_compact`` / ``join_full``)."""
        return {k: self._outcopies[k].land(h) for k, h in packed.items()}

    def _complete_tick(self, packed, placed: list, bulk_placed=None,
                       frontier=None, lease_pack=None, health_pack=None,
                       tick=None):
        """Consume one tick's outbox (waiting for its copy to the host,
        started at dispatch, is the sync point): adopt the lease and health
        packs, requeue rejected intake, execute the ordered decision
        stream, release callbacks, periodic GC.  ``packed`` is the
        :meth:`OutboxCopier.start` handle; mixed planes copy a (log,
        register) pair of buffers, merged into the composite row space.
        ``tick``: the phase clock's number of the tick that dispatched the
        outbox (None: the current one)."""
        pc = self._pc
        # re-arm without observing: drain_pipeline completes a deferred tick
        # outside tick(), and cross-call idle time must not land in "tally"
        pc.touch(tick)
        # the host buffers are written again two ticks on: the outbox this
        # returns owns its arrays (the mixed planes' merge and the mesh's
        # join copy anyway)
        if self._res is not None:
            packed = self._land_shard_copies(packed)
            for dt in self._dts.values():
                dt.poll()
        else:
            packed = self._outcopy.land(packed)
            self._dt.poll()
        if lease_pack is not None:
            self._adopt_lease_pack(lease_pack)
        if health_pack is not None:
            self._adopt_health_pack(health_pack)
        if self._use_compact:
            if self._res is not None:
                out = _stk.join_compact(packed, self.mesh, self.R, self.W,
                                        self.G, self._exec_budget,
                                        self._lag_budget)
            elif isinstance(packed, tuple):
                out = merge_compact_outbox(
                    unpack_compact(packed[0], self.R, self.G,
                                   self._exec_budget, self._lag_budget),
                    unpack_compact(packed[1], self.R, self.G_reg,
                                   self._exec_budget, self._lag_budget),
                    self.G)
            else:
                out = unpack_compact(packed, self.R, self.G,
                                     self._exec_budget, self._lag_budget,
                                     own=True)
            e_resp = e_miss = None
            if self._device_app:
                # the extras are sliced through the shared layout, which
                # fused_compact packs them by, and read before the host
                # buffer is written again
                e_resp, e_miss = CompactLayout(
                    self.R, self.G, self._exec_budget,
                    self._lag_budget).kv_extras(packed)
            pc.mark("tally")
            self._process_compact(out, placed, bulk_placed, e_resp, e_miss)
        else:
            if self._res is not None:
                out = _stk.join_full(packed, self.mesh, self.R, self.P,
                                     self.W, self.G)
            elif isinstance(packed, tuple):
                # the register plane is W=1 over G_reg columns; its exec
                # lanes are zero-padded up to W in the merge
                out = merge_outbox(
                    unpack_outbox(packed[0], self.R, self.P, self.W, self.G),
                    unpack_outbox(packed[1], self.R, self.P, 1, self.G_reg))
            else:
                out = unpack_outbox(packed.copy(), self.R, self.P, self.W,
                                    self.G)
            pc.mark("tally")
            self._process_outbox(out, placed, bulk_placed)
        pc.mark("execute")
        self._flush_callbacks()
        pc.mark("egress")
        if self.tick_num % self._sweep_every == 0:
            self._sweep_outstanding(frontier)
        if (
            self.cfg.paxos.deactivation_ticks > 0
            and self.tick_num % 256 == 0
            and len(self.rows) > 0
        ):
            self.pause_idle()
        pc.mark("sweep")
        return out

    @_locked
    def drain_pipeline(self) -> None:
        """Synchronously finish the pending pipelined outbox (no-op when
        nothing is pending).  The completed outbox is stashed for the next
        tick() to return."""
        if self._pending_out is not None:
            prev = self._pending_out
            self._pending_out = None
            self._drained_out = self._complete_tick(*prev)

    def _flush_callbacks(self) -> None:
        """Release client responses only once the WAL covering their tick is
        durable (log-before-respond; with sync_every_ticks > 1 responses ride
        the next group commit)."""
        if not self._held_callbacks:
            return
        if self.wal is not None and not self.wal.is_synced():
            return
        held, self._held_callbacks = self._held_callbacks, []
        rids, self._held_rids = self._held_rids, []
        if rids:
            idx = np.concatenate(rids)
            idx &= self.bulk.mask
            self._observe_wait("order", idx)
        closers = [h() for h in self._flush_scope_hooks]
        try:
            for cb, rid, resp in held:
                cb(rid, resp)
        finally:
            for c in closers:
                c()

    def _process_outbox(self, out: HostOutbox, placed=None,
                        bulk_placed=None) -> None:
        taken = out.intake_taken
        for row, take in (self._placed if placed is None else placed):
            for rid, entry, p in reversed(take):
                if not taken[entry, p, row] and rid in self.outstanding:
                    self._queues[row].appendleft(rid)  # retry next tick
        if bulk_placed is not None:
            b_rids, b_e, b_p, b_r = bulk_placed
            tk = taken[b_e, b_p, b_r]
            rej = b_rids[~tk]
            if rej.size:  # oldest first: rejected re-enter at the front
                self._bulk_leftover = (
                    np.concatenate([rej, self._bulk_leftover])
                    if self._bulk_leftover.size else rej
                )
        er, es, eb, ec = out.exec_req, out.exec_stop, out.exec_base, out.exec_count
        if ec.any():
            for row in np.where(ec.sum(axis=0) > 0)[0]:
                name = self.rows.name(int(row))
                if name is None:
                    continue
                self._last_active[row] = self.tick_num
                for r in range(self.R):
                    n = int(ec[r, row])
                    for j in range(n):
                        rid = int(er[r, j, row])
                        slot = int(eb[r, row]) + j
                        is_stop = bool(es[r, j, row])
                        self._execute_one(r, int(row), name, rid, slot, is_stop)
        np.maximum(self._host_exec, eb + ec, out=self._host_exec)
        self.stats["decisions"] += int(out.decided_now.sum())
        if self._placement is not None and self._demand_dev is None:
            # host demand fold (full-outbox path): per-group decisions are
            # visible here, unlike the compact flat buffer.  Placement
            # covers the log plane only — slice off register columns.
            self._placement.observe_intake(
                np.asarray(out.decided_now)[:self.G])
        # self-heal laggards in full-outbox mode too: a replica >= W behind
        # can never catch up by ring sync (deferred to tick())
        if self.cfg.paxos.auto_laggard_sync:
            # per-row window: register rows (W=1) flag at any lag
            self._lag_sync_due.extend(
                zip(*np.where(out.lag >= self._w_np[None, :])))

    def _execute_one(self, r: int, row: int, name: str, rid: int, slot: int,
                     is_stop: bool) -> None:
        if is_stop and row not in self._stopped_rows:
            self._stopped_rows.add(row)
            self._stopped_np[row] = True
            self._fail_queued(row)  # nothing after a stop can ever commit
        if rid == NO_REQUEST:
            self.stats["noops"] += 1
            return
        seen = self._seen[(r, row)]
        if rid in seen:
            self.stats["dup_commits"] += 1
            return
        seen[rid] = slot
        while len(seen) > self._seen_cap:
            seen.popitem(last=False)
        rec = self.outstanding.get(rid)
        if rec is None:
            if self.bulk is not None:
                sidx = rid & self.bulk.mask
                if self.bulk.valid[sidx] and self.bulk.rid[sidx] == rid:
                    self._store_exec_one(r, row, rid, slot, sidx)
                    return
            self.stats["orphan_execs"] += 1  # payload GC'd (laggard)
            return
        rec.slot = slot
        response = self.apps[r].execute(name, rec.payload, rid)
        rec.executed_by.add(r)
        self.stats["executions"] += 1
        if self.reqtrace.enabled:
            self.reqtrace.event(rid, "executed", slot=slot, replica=r)
        if r == rec.entry and not rec.responded:
            rec.responded = True
            if rec.callback is not None:
                self._held_callbacks.append((rec.callback, rid, response))
            if self.reqtrace.enabled:
                self.reqtrace.event(rid, "responded", slot=slot)
        members = int(self._n_members_np[row])
        if len(rec.executed_by) >= members and rec.responded:
            del self.outstanding[rid]
            self._row_outstanding[row] -= 1

    def _store_exec_one(self, r: int, row: int, rid: int, slot: int,
                        sidx: int) -> None:
        """Scalar execution of one bulk-store request (full-outbox path and
        stops; the compact hot path uses the vectorized twin below)."""
        s = self.bulk
        bit = np.int64(1) << r
        if s.exec_mask[sidx] & bit:
            self.stats["dup_commits"] += 1
            return
        s.exec_mask[sidx] |= bit
        if s.slot[sidx] < 0:
            s.slot[sidx] = slot
        payload = s.payload[sidx]
        desc_lost = False
        if self._device_app and len(payload or b"") == 0:
            # device-app store requests carry no host payload (the
            # descriptor lives in the device table); reaching the scalar
            # path with nothing to re-apply means the descriptor was lost.
            # Fail the request explicitly: executing b"" would be an empty
            # success that silently lost the update
            desc_lost = True
            resp = None
        else:
            resp = self.apps[r].execute(self._row_name_np[row], payload,
                                        rid)
            self.stats["executions"] += 1
        if s.entry[sidx] == r and not s.responded[sidx]:
            s.responded[sidx] = True
            s.response[sidx] = resp
            if desc_lost:
                self.stats["failed_requests"] += 1
                if self._bulk_cbs or self._sink_blocks:
                    self._bulk_fire([rid])  # cb(None): a visible failure
            elif self._bulk_cbs or self._sink_blocks:
                self._bulk_fire([rid], [resp if resp is not None else b""])
        full = self._member_bits[row]
        if s.responded[sidx] and (s.exec_mask[sidx] & full) == full:
            s.valid[sidx] = False
            s.payload[sidx] = None
            s.response[sidx] = None
            s.n_live -= 1
            s.done += 1

    def _process_compact(self, co: CompactHostOutbox, placed=None,
                         bulk_placed=None, e_resp=None,
                         e_miss=None) -> None:
        """Vectorized twin of :meth:`_process_outbox` over the compacted
        stream: every lifecycle step is an index-array operation; only
        stops and non-store (dict) requests fall back to per-item code.

        e_resp/e_miss: device-app extras aligned with the exec stream —
        per-execution KV responses and descriptor-miss flags.  Misses go
        through the scalar path, whose app ``execute`` re-applies the
        descriptor on the host (or fails the request if it is gone)."""
        taken = co.taken_bits
        for row, take in (placed or []):
            for rid, entry, p in reversed(take):
                if (not (taken[entry, row] >> p) & 1
                        and rid in self.outstanding):
                    self._queues[row].appendleft(rid)
        if bulk_placed is not None:
            b_rids, b_e, b_p, b_r = bulk_placed
            tk = (taken[b_e, b_r] >> b_p) & 1
            rej = b_rids[tk == 0]
            if rej.size:
                self._bulk_leftover = (
                    np.concatenate([rej, self._bulk_leftover])
                    if self._bulk_leftover.size else rej
                )
        n = co.n_exec
        store = self.bulk
        if n:
            rids = co.e_rid[:n].astype(np.int64)
            reps = co.e_rep[:n]
            rows = co.e_row[:n]
            slots = co.e_slot[:n]
            stops = co.e_stop[:n]
            # host-applied execution watermark: these entries are being
            # delivered to the apps RIGHT NOW
            np.maximum.at(self._host_exec, (reps, rows),
                          slots.astype(np.int32) + 1)
            valid = rids != NO_REQUEST
            # noop decisions (gap fills): stats parity with _execute_one
            self.stats["noops"] += int((~valid & ~stops).sum())
            self._last_active[rows] = self.tick_num
            if store is not None:
                idx, ok = store.lookup(rids)
                ok &= valid
            else:
                idx, ok = None, np.zeros(n, bool)
            # stops, dict-path/orphan rids and device-app descriptor
            # misses: scalar path (rare at scale)
            per_item = (valid & ~ok) | stops
            vec = ok & ~stops
            if e_miss is not None:
                miss = e_miss[:n].astype(bool) & valid
                if miss.any():
                    self.stats["kv_misses"] += int(miss.sum())
                    per_item |= miss
                    vec &= ~miss
            for i in np.nonzero(per_item)[0]:
                row = int(rows[i])
                name = self.rows.name(row)
                if name is None:
                    continue
                self._execute_one(int(reps[i]), row, name, int(rids[i]),
                                  int(slots[i]), bool(stops[i]))
            touched = []
            for r in range(self.R):
                sel = vec & (reps == r)
                if not sel.any():
                    continue
                idx_r = idx[sel]
                # same rid committed twice in one tick (turnover re-propose):
                # keep the first (lowest-slot) occurrence
                fo = self._first_occurrence(idx_r, self._scr2_pos,
                                            self._scr2_gen)
                if not fo.all():
                    self.stats["dup_commits"] += int((~fo).sum())
                    idx_r = idx_r[fo]
                rid_r = rids[sel][fo]
                row_r = rows[sel][fo]
                slot_r = slots[sel][fo]
                fresh = store.mark_executed(idx_r, r)
                if not fresh.all():
                    self.stats["dup_commits"] += int((~fresh).sum())
                    idx_r, rid_r, row_r, slot_r = (
                        idx_r[fresh], rid_r[fresh], row_r[fresh],
                        slot_r[fresh],
                    )
                if not len(idx_r):
                    continue
                ns = store.slot[idx_r] < 0
                store.slot[idx_r[ns]] = slot_r[ns]
                if e_resp is not None:
                    # device app: execution already happened on the device
                    # inside the fused tick; only responses surface
                    resp = e_resp[:n][sel][fo]
                    if not fresh.all():
                        resp = resp[fresh]
                else:
                    erb = getattr(self.apps[r], "execute_rows_batch", None)
                    if erb is not None:
                        resp = erb(row_r, store.payload[idx_r], rid_r,
                                   lens=store.pay_len[idx_r])
                    else:
                        resp = self.apps[r].execute_batch(
                            self._row_name_np[row_r], store.payload[idx_r],
                            rid_r
                        )
                self.stats["executions"] += len(idx_r)
                em = (store.entry[idx_r] == r) & ~store.responded[idx_r]
                ri = idx_r[em]
                if len(ri):
                    store.responded[ri] = True
                    if resp is not None:
                        ra = np.empty(len(resp), object)
                        ra[:] = resp
                        store.response[ri] = ra[em]
                        if self._bulk_cbs or self._sink_blocks:
                            self._bulk_fire(store.rid[ri], list(ra[em]))
                    elif self._bulk_cbs or self._sink_blocks:
                        self._bulk_fire(store.rid[ri],
                                        [b""] * len(ri))
                touched.append(idx_r)
            if touched:
                ti = np.concatenate(touched)
                store.free_done(ti, self._member_bits[store.row[ti]])
        self.stats["decisions"] += co.decided_total
        if self._placement is not None and self._demand_dev is None:
            # host demand fold (compact path): per-group decisions are gone
            # from the flat buffer, so fold the intake acceptance bits
            # instead — popcount of each row's taken mask
            bits = co.taken_bits.astype(np.int64)
            per_row = np.zeros(bits.shape[1], np.int64)
            for _ in range(self.P):
                per_row += (bits & 1).sum(axis=0)
                bits >>= 1
            # placement covers the log plane only: composite register
            # columns (rows >= G) are sliced off before the demand fold
            self._placement.observe_intake(per_row[:self.G])
        self._lag_pending = (co.l_rep.copy(), co.l_row.copy(),
                             co.l_donor.copy(), co.l_dexec.copy(),
                             co.l_dstat.copy(), co.l_lexec.copy())
        if self.cfg.paxos.auto_laggard_sync and co.lag_n:
            # self-heal: a replica >= W behind can never catch up by ring
            # sync.  DEFERRED to tick() (see _run_due_laggard_syncs)
            self._lag_sync_due.extend(zip(*self._lag_pending[:2]))

    def _sweep_outstanding(self, frontier=None) -> None:
        """Drop responded records whose payload can never be needed again:
        every member has executed past the slot, OR the slot has rotated
        out of every decision ring (slot < base - W), in which case any
        replica still behind it can only catch up by checkpoint transfer.
        A slot still inside the ring window of a DEAD member's gap keeps
        its payload (ring replay on revival needs it).

        ``frontier`` — ``(urows, amin, base, live)`` from the dispatch —
        routes to the O(records) path; ``None`` keeps the [R, G] host
        reductions."""
        if not self.outstanding and (self.bulk is None
                                     or self.bulk.n_live == 0):
            return
        if frontier is not None:
            self._sweep_with_frontier(frontier)
            return
        # "passed" is judged against the HOST-APPLIED watermark
        exec_slot = self._host_exec
        dev_exec = self._dev_exec_np()
        if self.bulk is not None and self.bulk.n_live:
            s = self.bulk
            member_exec = np.where(self._member_np, exec_slot,
                                   np.iinfo(np.int32).max)
            amin = member_exec.min(axis=0)  # [G] min ALL-member watermark
            # rotation uses the DEVICE watermark (ring overwrite is a
            # device-side fact)
            base = np.where(self._member_np, dev_exec,
                            np.iinfo(np.int32).min).max(axis=0)  # [G]
            any_live = (self._member_np & self.alive[:, None]).any(axis=0)
            # rotation bound is STRICT: slot base-W's ring plane survives
            # until base is decided
            sel = np.nonzero(
                s.valid & s.responded & (s.slot >= 0) & any_live[s.row]
                & ((s.slot < amin[s.row])
                   | (s.slot < base[s.row] - self._w_np[s.row]))
            )[0]
            if len(sel):
                s.valid[sel] = False
                s.payload[sel] = None
                s.response[sel] = None
                s.n_live -= len(sel)
                s.done += len(sel)
                self.stats["swept"] += len(sel)
        if not self.outstanding:
            return
        member = self._member_np
        dead = []
        for rid, rec in self.outstanding.items():
            if not rec.responded or rec.slot < 0:
                continue
            ms = np.where(member[:, rec.row])[0]
            if not any(self.alive[m] for m in ms):
                continue
            marks = [int(exec_slot[m, rec.row]) for m in ms]
            dbase = max(int(dev_exec[m, rec.row]) for m in ms)
            if (all(mk > rec.slot for mk in marks)
                    or rec.slot < dbase - self._w_np[rec.row]):  # strict
                dead.append(rid)
        for rid in dead:
            self._row_outstanding[self.outstanding[rid].row] -= 1
            del self.outstanding[rid]
            self.stats["swept"] += 1

    def _frontier_gather(self, fr):
        """Dispatch-time half of the frontier sweep: the rows holding live
        records and the O(rows) gather of the frontier at those rows, padded
        to a power-of-two bucket (results stay on the device)."""
        urows = self._frontier_rows()
        if urows is None:
            return None
        am, bs, lv = frontier_rows(*fr, _pad_rows(urows))
        return urows, am, bs, lv

    def _frontier_gather_mesh(self, inboxes):
        """:meth:`_frontier_gather` on a mesh: each shard column computes
        its frontier and gathers it at its own rows, on its device; the
        results are ``(count, tensor)`` lists in column order."""
        urows = self._frontier_rows()
        if urows is None:
            return None
        gs, per = self.shard_geometry()
        cuts = np.searchsorted(urows, np.arange(gs + 1) * per)
        parts = ([], [], [])
        for gi in range(gs):
            loc = urows[cuts[gi]:cuts[gi + 1]] - gi * per
            if not len(loc):
                continue
            with self._res.column(gi, write=False) as col:
                fr = sweep_frontier(col.exec_slot, col.member,
                                    inboxes[(0, gi)].alive)
            for acc, t in zip(parts, frontier_rows(*fr, _pad_rows(loc))):
                acc.append((len(loc), t))
        return (urows,) + parts

    def _frontier_rows(self):
        """The rows holding live records, sorted, or None."""
        s = self.bulk
        rows_parts = []
        if s is not None and s.n_live:
            rws = s.row[s.valid]
            if len(rws):
                rows_parts.append(rws.astype(np.int32))
        if self.outstanding:
            rows_parts.append(np.fromiter(
                (rec.row for rec in self.outstanding.values()),
                np.int32, len(self.outstanding)))
        if not rows_parts:
            return None
        return np.unique(np.concatenate(rows_parts)
                         if len(rows_parts) > 1 else rows_parts[0])

    def _sweep_with_frontier(self, frontier) -> None:
        """O(records) sweep off the device control summary gathered at
        dispatch (see :meth:`_frontier_gather`).  A record whose row is
        missing from that gather is kept for the next sweep."""
        urows, am, bs, lv = frontier
        amin, base, live = (_frontier_np(x, len(urows)) for x in (am, bs, lv))
        s = self.bulk
        if s is not None and s.n_live:
            cand = np.nonzero(s.valid & s.responded & (s.slot >= 0))[0]
            if len(cand):
                crows = s.row[cand]
                ix = np.minimum(np.searchsorted(urows, crows),
                                len(urows) - 1)
                sel = cand[(urows[ix] == crows) & live[ix]
                           & ((s.slot[cand] < amin[ix])
                              | (s.slot[cand] < base[ix] - self.W))]
                if len(sel):
                    s.valid[sel] = False
                    s.payload[sel] = None
                    s.response[sel] = None
                    s.n_live -= len(sel)
                    s.done += len(sel)
                    self.stats["swept"] += len(sel)
        if not self.outstanding:
            return
        dead = []
        for rid, rec in self.outstanding.items():
            if not rec.responded or rec.slot < 0:
                continue
            i = int(np.searchsorted(urows, rec.row))
            if i >= len(urows) or urows[i] != rec.row or not live[i]:
                continue
            if rec.slot < amin[i] or rec.slot < base[i] - self.W:
                dead.append(rid)
        for rid in dead:
            self._row_outstanding[self.outstanding[rid].row] -= 1
            del self.outstanding[rid]
            self.stats["swept"] += 1

    # --------------------------------------------------------------- liveness
    def set_alive(self, r: int, up: bool) -> None:
        self.alive[r] = up

    @_locked
    def sync_laggard(self, r: int, name: str, donor: Optional[int] = None) -> bool:
        """Checkpoint transfer for a replica lagging >= W on a group: copy
        the exec watermark from the most advanced live member and restore
        its app state."""
        # the captured (watermark, blob) pair must be consistent: with a
        # pipelined tick in flight the device watermark is ahead of the
        # host apps by that tick's executions
        self.drain_pipeline()
        row = self.rows.row(name)
        if row is None:
            return False
        exec_slot = self._dev_exec_col(row)
        if donor is None:
            members = np.where(self._member_np[:, row])[0]
            donors = [m for m in members if self.alive[m] and m != r]
            if not donors:
                return False
            donor = max(donors, key=lambda m: exec_slot[m])
        if exec_slot[donor] <= exec_slot[r]:
            return False
        # "ship the register": for a register row the checkpoint IS the
        # register value, so the same transfer covers both planes
        ckpt = self.apps[donor].checkpoint(name)
        donor_exec = int(exec_slot[donor])
        with self._owning(row, write=False) as (pst, prow):
            donor_status = int(pst.status[donor, prow])
        if self.wal is not None:
            self.wal.log_sync(r, name, int(donor), donor_exec, donor_status,
                              ckpt)
        self._apply_sync_values(r, int(row), name, donor_exec, donor_status,
                                ckpt, old_exec=int(exec_slot[r]))
        self.stats["checkpoint_transfers"] += 1
        return True

    def _sync_from_summary(self, r: int, row: int, name: str, donor: int,
                           donor_exec: int, donor_status: int,
                           old_exec: int) -> bool:
        """Checkpoint transfer driven by the device control summary (the
        compact buffer's l_* columns), with no [R, G] reads."""
        if not self.alive[donor] or not self._member_np[r, row]:
            # liveness/membership moved between the tick and the repair:
            # the host scan re-derives the donor from current state
            return self.sync_laggard(r, name)
        if donor_exec <= old_exec:
            return False
        ckpt = self.apps[donor].checkpoint(name)
        if self.wal is not None:
            self.wal.log_sync(r, name, int(donor), int(donor_exec),
                              int(donor_status), ckpt)
        self._apply_sync_values(r, int(row), name, int(donor_exec),
                                int(donor_status), ckpt,
                                old_exec=int(old_exec))
        self.stats["checkpoint_transfers"] += 1
        return True

    @_locked
    def apply_sync(self, r: int, name: str, donor_exec: int,
                   donor_status: int, ckpt: bytes) -> bool:
        """Apply a checkpoint transfer verbatim from its recorded values
        (no donor-state re-derivation)."""
        row = self.rows.row(name)
        if row is None:
            return False
        self._apply_sync_values(r, int(row), name, donor_exec, donor_status,
                                ckpt)
        self.stats["checkpoint_transfers"] += 1
        return True

    def _apply_sync_values(self, r: int, row: int, name: str,
                           donor_exec: int, donor_status: int,
                           ckpt: bytes, old_exec: Optional[int] = None) -> None:
        if old_exec is None:
            old_exec = int(self._dev_exec_col(row)[r])
        self.apps[r].restore(name, ckpt)
        self._host_exec[r, row] = max(int(self._host_exec[r, row]),
                                      donor_exec)
        self._set_exec_status(r, row, donor_exec, donor_status)
        self._seen.pop((r, row), None)
        # a transfer skips slots [old, donor) on r without ever reporting
        # them executed — settle the store's books.  Entry-duty requests
        # whose response was skipped are marked responded with no payload
        # (client retries; at-least-once).
        if self.bulk is not None:
            s = self.bulk
            lo, hi = old_exec, donor_exec
            sel = np.nonzero(
                s.valid & (s.row == row) & (s.slot >= lo) & (s.slot < hi)
            )[0]
            if len(sel):
                s.exec_mask[sel] |= np.int64(1) << r
                ent = (s.entry[sel] == r) & ~s.responded[sel]
                s.responded[sel[ent]] = True
                if (self._bulk_cbs or self._sink_blocks) and ent.any():
                    self._bulk_fire(s.rid[sel[ent]])  # duty skipped: None
                s.free_done(sel, self._member_bits[s.row[sel]])

    @_locked
    def auto_sync_laggards(self, out=None) -> int:
        """Run checkpoint transfers where ring sync cannot catch up
        (lag >= W).  Accepts a full outbox; with None or a compacted one,
        uses the device-compacted laggard list of the last completed
        tick."""
        if out is None or isinstance(out, CompactHostOutbox):
            if out is None and not self._use_compact:
                raise ValueError(
                    "auto_sync_laggards() needs the tick's outbox in "
                    "full-outbox mode"
                )
            if out is None and self.cfg.paxos.device_donor_sel:
                # control-summary path: after the drain, _lag_pending is the
                # latest completed tick's table
                self.drain_pipeline()
                n = 0
                for r_, row_, d_, de_, ds_, le_ in zip(*self._lag_pending):
                    r = int(r_)
                    if not self.alive[r] or int(d_) < 0:
                        continue
                    name = self.rows.name(int(row_))
                    if name and self._sync_from_summary(
                            r, int(row_), name, int(d_), int(de_),
                            int(ds_), int(le_)):
                        n += 1
                return n
            l_rep = out.l_rep if out is not None else self._lag_pending[0]
            l_row = out.l_row if out is not None else self._lag_pending[1]
            pairs = zip(l_rep, l_row)
        else:
            pairs = zip(*np.where(np.asarray(out.lag)
                                  >= self._w_np[None, :]))
        n = 0
        for r, row in pairs:
            if not self.alive[r]:
                continue
            name = self.rows.name(int(row))
            if name and self.sync_laggard(int(r), name):
                n += 1
        return n

    # ------------------------------------------------------------ conveniences
    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.tick()

    @_locked
    def pending_count(self) -> int:
        n = sum(len(q) for q in self._queues.values()) + len(self._staged)
        n += int(self._bulk_leftover.size)
        n += sum(len(c) for c in self._bulk_chunks)
        if self._pending_out is not None:
            n += 1  # a pipelined outbox still needs a tick to complete
        return n
