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
  combination ticks through the one dispatch ``ops.tick.paxos_tick_health``.

This slice ports the single-device path.  Options whose planes come with
later slices of the port (the device app, the mesh, placement, fast
re-election, the measurement baselines) raise ``NotImplementedError`` at
construction.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import overload as _overload
from ..config import GigapaxosTpuConfig
from ..device import resolve_device
from ..models.replicable import Replicable
from ..obs.metrics import registry as _obsreg
from ..obs.phase import BLOCKING_PHASE as _BLOCKING_PHASE
from ..obs.phase import phase_clock as _phase_clock
from ..ops.tick import (LP_ASN, LP_EPOCH, LP_HOLDER, LP_UNTIL, LP_WAIT,
                        CompactHostOutbox, HostOutbox, TickInbox,
                        frontier_rows, health_clear_rows, init_health,
                        init_lease, lease_clear_rows, merge_compact_outbox,
                        merge_health, merge_outbox, paxos_tick_health,
                        sweep_frontier, unpack_compact, unpack_health,
                        unpack_outbox)
from ..types import NO_REQUEST
from ..utils.diskmap import DiskMap
from ..utils.intmap import RowAllocator
from ..utils.locking import ContendedLock, locked as _locked
from ..utils.reqtrace import tracer as _reqtrace
from . import state as st
from .bulkstore import BulkStore
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


def _unported(cfg: GigapaxosTpuConfig) -> List[str]:
    """Names of the set options whose planes this slice does not port."""
    p = cfg.paxos
    checks = [
        (p.device_app, "paxos.device_app (the device-KV slice)"),
        (p.mesh_devices, "paxos.mesh_devices (the mesh slice)"),
        (p.fast_reelection, "paxos.fast_reelection (the Mode B slice)"),
        (cfg.placement.enabled,
         "placement.enabled (the placement slice, with the mesh)"),
        (p.emulate_unreplicated or p.lazy_propagation,
         "paxos.emulate_unreplicated/lazy_propagation (measurement "
         "baselines, with the benchmark slice)"),
    ]
    return [what for on, what in checks if on]


class PaxosManager:
    def __init__(
        self,
        cfg: GigapaxosTpuConfig,
        n_replicas: int,
        apps: List[Replicable],
        wal=None,
        spill_ns: str = "default",
        device=None,
    ):
        """``device`` defaults to CUDA (see ``device.resolve_device``);
        ``spill_ns`` names this manager's plane in metrics; ``wal`` is an
        optional ``wal.logger.PaxosLogger``."""
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(missing))
        assert len(apps) == n_replicas
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
        self.state = st.init_state(self.R, self.G, self.W, self.device)
        self.rstate = (st.init_state(self.R, self.G_reg, 1, self.device)
                       if self.G_reg else None)
        self.rows = RowAllocator(self.G_total, split=self.G)
        self.apps = apps
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
        self._exec_budget = (cfg.paxos.exec_budget
                             or max(4096, 2 * self.G_total))
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
        # control-plane threads call the admin/propose API while a driver
        # loops on tick(); one reentrant lock serializes them
        self.lock = ContendedLock()
        if self.wal is not None:
            self.wal.attach(self)

    # ------------------------------------------------------ device helpers
    # The composite row space is [0, G) log + [G, G_total) register rows;
    # these helpers are the only places host code maps a composite row onto
    # one of the two device planes.

    def is_register_row(self, row: int) -> bool:
        return row >= self.G

    def _plane_state(self, row: int):
        """(plane_state, plane_row) for a composite row."""
        if row >= self.G:
            return self.rstate, row - self.G
        return self.state, row

    def _dev_exec_np(self) -> np.ndarray:
        """Composite [R, G_total] device exec watermark on the host."""
        ex = st.to_host(self.state.exec_slot)
        if self.rstate is None:
            return ex
        return np.hstack([ex, st.to_host(self.rstate.exec_slot)])

    def _dev_exec_col(self, row: int) -> np.ndarray:
        pst, prow = self._plane_state(row)
        return st.to_host(pst.exec_slot[:, prow])

    def _set_exec_status(self, r: int, row: int, exec_slot: int,
                         status: int) -> None:
        """Point-write a replica's exec watermark + status on the owning
        plane (checkpoint transfer apply), in place."""
        pst, prow = self._plane_state(row)
        pst.exec_slot[r, prow] = exec_slot
        pst.status[r, prow] = status

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        pst, prow = self._plane_state(row)
        register = row >= self.G
        col = {f: st.to_host(getattr(pst, f)[:, prow])
               for f in ("member", "bal_num", "bal_coord", "exec_slot",
                         "next_slot", "status", "coord_active",
                         "coord_preparing")}
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
            "epoch": int(pst.epoch[prow]),
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
        pst, prow = self._plane_state(row)
        st.create_groups(pst, np.array([prow]), mask,
                         np.array([epoch], np.int32))
        self._set_member_row(row, mask[0], name)
        self._stopped_rows.discard(row)
        self._stopped_np[row] = False
        self._last_active[row] = self.tick_num
        if self.wal is not None:
            self.wal.log_create(name, members, epoch, register=register)
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
                st.create_groups(self.state, rows, mask,
                                 np.full(len(take), epoch, np.int32))
                self._member_np[:, rows] = mask.T
                self._n_members_np[rows] = mask.sum(axis=1)
                bits = int(np.bitwise_or.reduce(
                    (1 << np.array(members, np.int64))
                )) if members else 0
                self._member_bits[rows] = bits
                self._row_name_np[rows] = take
                self._member_ord = None
                self._stopped_np[rows] = False
                self._stopped_rows.difference_update(int(r) for r in rows)
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
        pst, prow = self._plane_state(row)
        st.free_groups(pst, np.array([prow]))
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
        exec_slot = st.to_host(self.state.exec_slot)
        next_slot = st.to_host(self.state.next_slot)
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

    def _do_pause(self, names: List[str]) -> None:
        """Pause exactly ``names`` (selection already done)."""
        rows_to_free = []
        for name in names:
            row = self.rows.row(name)
            hri = st.extract_hri(self.state, row)
            hri["stopped"] = row in self._stopped_rows
            self._paused[name] = hri
            rows_to_free.append(row)
        st.free_groups(self.state, np.array(rows_to_free))
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
        st.create_groups(self.state, np.array([row]), mask,
                         np.array([hri["epoch"]], np.int32))
        self._set_member_row(row, mask[0], name)
        st.hot_restore(self.state, row, hri)
        # pause holds drained state (host == device), so the restored
        # device watermark is also the host-applied one for this row
        self._host_exec[:, row] = np.asarray(hri["exec_slot"], np.int32)
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
        if not isinstance(payloads, (bytes, bytearray)):
            # per-request bodies: intern so duplicates collapse to one
            # shared object
            payloads = [
                self._paystore.intern(p) if isinstance(p, bytes) else p
                for p in payloads
            ]
        rids = store.admit(rid0, rows.astype(np.int32), ent, stops,
                           payloads)
        if batch_sink is not None:
            self._sink_blocks.append([rid0, n_adm, n_adm, batch_sink])
        if callbacks is not None:
            for rid, cb in zip(rids, callbacks):
                if cb is not None:
                    self._bulk_cbs[int(rid)] = cb
        self._bulk_chunks.append(rids)
        self._last_active[rows] = self.tick_num
        out[np.nonzero(ok)[0][:n_adm]] = rids
        return out

    def _bulk_fire(self, rids, responses=None) -> None:
        """Queue completion callbacks for bulk rids that just reached their
        responded transition."""
        if self._sink_blocks:
            self._sink_route(rids, responses)
        if not self._bulk_cbs:
            return
        if responses is None:
            for rid in rids:
                cb = self._bulk_cbs.pop(int(rid), None)
                if cb is not None:
                    self._held_callbacks.append((cb, int(rid), None))
        else:
            for rid, resp in zip(rids, responses):
                cb = self._bulk_cbs.pop(int(rid), None)
                if cb is not None:
                    self._held_callbacks.append((cb, int(rid), resp))

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
        if gc:
            self._sink_blocks = [b for b in blocks if b[2] > 0]

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
    def _build_inbox(self) -> TickInbox:
        self._drain_staged()
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
        # device copies: the staging buffers are mutated next tick
        dev = self.device
        return TickInbox(torch.from_numpy(req).to(dev, copy=True),
                         torch.from_numpy(stp).to(dev, copy=True),
                         torch.from_numpy(self._inbox_alive).to(dev))

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
            fe, fp, fr = entries[fit], p[fit], rows[fit]
            req[fe, fp, fr] = q[fit].astype(np.int32)
            stp[fe, fp, fr] = store.stop[idx[fit]]
            self._bulk_placed = (q[fit], fe, fp, fr)
        rest = q[~fit]
        parts = [p for p in (rest, qk) if p.size]
        self._bulk_leftover = (np.concatenate(parts) if len(parts) > 1
                               else (parts[0] if parts else rest))

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
        inbox = self._build_inbox()
        pc.mark("intake")
        placed = self._placed
        bulk_placed = self._bulk_placed
        # one dispatch covers every combination of planes and folds; absent
        # ones are None (the packed path runs with no exec budget)
        (self.state, self.rstate, self._lease, self._rlease, self._health,
         self._rhealth, pk_l, pk_r, lp_l, lp_r, hp_l,
         hp_r) = paxos_tick_health(
            self.state, self.rstate, self._lease, self._rlease, self._health,
            self._rhealth, inbox, -1,
            self._exec_budget if self._use_compact else 0, self._lag_budget,
            self._lease_horizon, self._use_compact, self._health_wedge,
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
            frontier = self._frontier_gather(sweep_frontier(
                self.state.exec_slot, self.state.member, inbox.alive))
        if self._obs_block:
            # opt-in exact device step: costs the pipeline overlap
            self._sync_device()
            pc.mark(_BLOCKING_PHASE)
        pc.mark("dispatch")
        if self.wal is not None:
            self.wal.log_inbox(self.tick_num, self._inbox_alive)
        pc.mark("wal_fsync")
        self.tick_num += 1
        if self.cfg.paxos.pipeline_ticks:
            # deferred unpack: the device->host copy of tick N happens at
            # tick N+1's completion
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
                                 lease_pack, health_pack)
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

    def _complete_tick(self, packed, placed: list, bulk_placed=None,
                       frontier=None, lease_pack=None, health_pack=None):
        """Consume one tick's outbox (the device->host copy is the sync
        point): adopt the lease and health packs, requeue rejected intake,
        execute the ordered decision stream, release callbacks, periodic
        GC.  Mixed planes hand a (log, register) pair of buffers, merged
        into the composite row space."""
        pc = self._pc
        # re-arm without observing: drain_pipeline completes a deferred tick
        # outside tick(), and cross-call idle time must not land in "tally"
        pc.touch()
        if lease_pack is not None:
            self._adopt_lease_pack(lease_pack)
        if health_pack is not None:
            self._adopt_health_pack(health_pack)
        if self._use_compact:
            if isinstance(packed, tuple):
                out = merge_compact_outbox(
                    unpack_compact(packed[0], self.R, self.G,
                                   self._exec_budget, self._lag_budget),
                    unpack_compact(packed[1], self.R, self.G_reg,
                                   self._exec_budget, self._lag_budget),
                    self.G)
            else:
                out = unpack_compact(packed, self.R, self.G,
                                     self._exec_budget, self._lag_budget)
            pc.mark("tally")
            self._process_compact(out, placed, bulk_placed)
        else:
            if isinstance(packed, tuple):
                # the register plane is W=1 over G_reg columns; its exec
                # lanes are zero-padded up to W in the merge
                out = merge_outbox(
                    unpack_outbox(packed[0], self.R, self.P, self.W, self.G),
                    unpack_outbox(packed[1], self.R, self.P, 1, self.G_reg))
            else:
                out = unpack_outbox(packed, self.R, self.P, self.W, self.G)
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
        resp = self.apps[r].execute(self._row_name_np[row], s.payload[sidx],
                                    rid)
        self.stats["executions"] += 1
        if s.entry[sidx] == r and not s.responded[sidx]:
            s.responded[sidx] = True
            s.response[sidx] = resp
            if self._bulk_cbs or self._sink_blocks:
                self._bulk_fire([rid], [resp if resp is not None else b""])
        full = self._member_bits[row]
        if s.responded[sidx] and (s.exec_mask[sidx] & full) == full:
            s.valid[sidx] = False
            s.payload[sidx] = None
            s.response[sidx] = None
            s.n_live -= 1
            s.done += 1

    def _process_compact(self, co: CompactHostOutbox, placed=None,
                         bulk_placed=None) -> None:
        """Vectorized twin of :meth:`_process_outbox` over the compacted
        stream: every lifecycle step is an index-array operation; only
        stops and non-store (dict) requests fall back to per-item code."""
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
            # stops and dict-path/orphan rids: scalar path (rare at scale)
            per_item = (valid & ~ok) | stops
            vec = ok & ~stops
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
        urows = np.unique(np.concatenate(rows_parts)
                          if len(rows_parts) > 1 else rows_parts[0])
        k = max(16, 1 << int(len(urows) - 1).bit_length())
        padded = np.zeros(k, np.int32)
        padded[:len(urows)] = urows
        am, bs, lv = frontier_rows(*fr, padded)
        return urows, am, bs, lv

    def _sweep_with_frontier(self, frontier) -> None:
        """O(records) sweep off the device control summary gathered at
        dispatch (see :meth:`_frontier_gather`).  A record whose row is
        missing from that gather is kept for the next sweep."""
        urows, am, bs, lv = frontier
        amin = am.cpu().numpy()[:len(urows)]
        base = bs.cpu().numpy()[:len(urows)]
        live = lv.cpu().numpy()[:len(urows)]
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
        pst, prow = self._plane_state(row)
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
