"""ChainManager: host control loop for the chain data plane.

Peer of :class:`~gigapaxos_tpu_torch.paxos.manager.PaxosManager` for chains
(``chainreplication/ChainManager.java:71-99``), deliberately exposing the
same public surface (``propose``/``propose_stop``/``create_paxos_instance``/
``remove_paxos_instance``/``group_members``/``is_stopped``/``tick``/
``pending_count``/``apps``/``alive``/``rows``/``lock``) so the
replica-coordination SPI binding and the TickDriver work unchanged — the
reference swaps coordinators the same way via ``REPLICA_COORDINATOR_CLASS``
(``ReconfigurableNode.java:203-218``).

Differences from the paxos manager, mirroring protocol semantics:

* requests are ordered once by the head — no re-proposal, no duplicate
  commits, so there is no execution-side dedup machinery;
* the client response fires when the *tail* applies the request (commit
  point; reads at the tail), not the entry replica;
* every member executes every request in the same order as it applies.

The chain state lives on ``device`` (default CUDA); each tick copies its
packed outbox back to the host, where the apps execute.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import GigapaxosTpuConfig
from ..device import resolve_device, serial_on_cpu
from ..models.replicable import Replicable
from ..types import NO_REQUEST
from .. import overload as _overload
from ..utils.intmap import RowAllocator
from ..obs.phase import phase_clock as _phase_clock
from ..utils.locking import ContendedLock, locked as _locked
from . import state as st
from .tick import (ChainInbox, HostChainOutbox, chain_tick_packed,
                   unpack_chain_outbox)


@dataclass
class ChainRequest:
    rid: int
    name: str
    row: int
    payload: bytes
    stop: bool
    callback: Optional[Callable[[int, bytes], None]]
    responded: bool = False
    executed_by: set = field(default_factory=set)


class ChainManager:
    def __init__(
        self,
        cfg: GigapaxosTpuConfig,
        n_replicas: int,
        apps: List[Replicable],
        wal=None,
        device=None,
    ):
        """``device`` defaults to CUDA (see ``device.resolve_device``)."""
        assert len(apps) == n_replicas
        self.cfg = cfg
        self.device = resolve_device(device)
        self.R = n_replicas
        self.G = cfg.paxos.max_groups
        self.W = cfg.paxos.window
        self.P = cfg.paxos.proposals_per_tick
        self.state = st.init_state(self.R, self.G, self.W, self.device)
        self.rows = RowAllocator(self.G)
        self.apps = apps
        self.wal = wal
        self.alive = np.ones(self.R, bool)
        self.tick_num = 0
        self.outstanding: Dict[int, ChainRequest] = {}
        self._next_rid = 1
        self._queues: Dict[int, collections.deque] = collections.defaultdict(
            collections.deque
        )
        self._held_callbacks: list = []
        self.stats = collections.Counter()
        self._stopped_rows: set[int] = set()
        # intake governor: watermark shed of client-class proposes 
        self.overload = (
            _overload.IntakeGovernor(cfg.overload.intake_hi,
                                     cfg.overload.intake_lo, node="chain")
            if cfg.overload.enabled else None)
        # host mirrors of config state (see paxos/manager.py rationale)
        self._member_np = np.zeros((self.R, self.G), bool)
        self._n_members_np = np.zeros(self.G, np.int32)
        self._in_req = np.zeros((self.P, self.G), np.int32)
        self._in_stp = np.zeros((self.P, self.G), bool)
        self._inbox_alive = self.alive.copy()  # liveness of the last inbox
        self._placed: list = []
        self.lock = ContendedLock()
        self._pc = _phase_clock("chain")
        if self.wal is not None:
            self.wal.attach(self)

    # ------------------------------------------------------------------ admin
    @_locked
    def create_paxos_instance(
        self, name: str, members: List[int], epoch: int = 0
    ) -> bool:
        """Name kept for SPI compatibility; creates a replicated *chain*."""
        if name in self.rows:
            return False
        row = self.rows.alloc(name)
        mask = np.zeros((1, self.R), bool)
        for m in members:
            mask[0, m] = True
        self.state = st.create_groups(
            self.state, np.array([row], np.int32), mask,
            np.array([epoch], np.int32),
        )
        self._member_np[:, row] = mask[0]
        self._n_members_np[row] = mask[0].sum()
        self._stopped_rows.discard(row)
        if self.wal is not None:
            self.wal.log_create(name, members, epoch)
        return True

    @_locked
    def remove_paxos_instance(self, name: str) -> bool:
        row = self.rows.row(name)
        if row is None:
            return False
        self.state = st.free_groups(self.state, np.array([row], np.int32))
        self._member_np[:, row] = False
        self._n_members_np[row] = 0
        self.rows.free(name)
        self._fail_queued(row)
        self._stopped_rows.discard(row)
        if self.wal is not None:
            self.wal.log_remove(name)
        return True

    @_locked
    def group_members(self, name: str) -> Optional[List[int]]:
        row = self.rows.row(name)
        if row is None:
            return None
        return [int(r) for r in np.where(self._member_np[:, row])[0]]

    @_locked
    def is_stopped(self, name: str) -> bool:
        row = self.rows.row(name)
        return row is not None and row in self._stopped_rows

    @_locked
    def exec_watermarks(self, name: str):
        """Per-replica applied watermark [R] (donor selection for
        checkpoint transfer — see PaxosManager.exec_watermarks)."""
        row = self.rows.row(name)
        if row is None:
            return None
        return self.state.applied[:, row].to("cpu", copy=True).numpy()

    # ---------------------------------------------------------------- propose
    @_locked
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
        """Order one write through the chain's head (``propose :434``).
        ``entry`` is accepted for SPI compatibility and ignored — the head
        is always the entry."""
        if _overload.expired(deadline):
            if callback is not None:
                self._held_callbacks.append(
                    (callback, _overload.RID_EXPIRED, None))
            self.stats["expired_drops"] += 1
            _overload.count_expired("intake", "chain")
            return None
        if (cls == _overload.CLS_CLIENT and self.overload is not None
                and not self.overload.admit(cls)):
            if callback is not None:
                self._held_callbacks.append(
                    (callback, _overload.RID_BUSY, None))
            self.stats["shed_requests"] += 1
            _overload.count_shed(cls, "intake", "chain")
            return None
        row = self.rows.row(name)
        if row is None:
            return None
        if row in self._stopped_rows:
            if callback is not None:
                self._held_callbacks.append((callback, -1, None))
            self.stats["failed_requests"] += 1
            return None
        rid = self._next_rid
        self._next_rid += 1
        self.outstanding[rid] = ChainRequest(rid, name, row, payload, stop, callback)
        self._queues[row].append(rid)
        return rid

    def propose_stop(self, name: str, payload: bytes = b"", callback=None):
        return self.propose(name, payload, callback, stop=True)

    def _fail_queued(self, row: int) -> None:
        q = self._queues.pop(row, None)
        if not q:
            return
        for rid in q:
            rec = self.outstanding.pop(rid, None)
            if rec is not None and rec.callback is not None and not rec.responded:
                self._held_callbacks.append((rec.callback, rid, None))
            self.stats["failed_requests"] += 1

    # ------------------------------------------------------------------- tick
    def _build_inbox(self) -> ChainInbox:
        req, stp = self._in_req, self._in_stp
        for _row, take in self._placed:
            for _rid, _e, p in take:
                req[p, _row] = 0
                stp[p, _row] = False
        placed = []
        for row, q in self._queues.items():
            take = []
            while q and len(take) < self.P:
                rid = q.popleft()
                if rid not in self.outstanding:
                    continue
                p = len(take)
                req[p, row] = rid
                stp[p, row] = self.outstanding[rid].stop
                take.append((rid, 0, p))
            if take:
                placed.append((row, take))
        self._placed = placed
        # the WAL journals the host copy of the liveness view; the device
        # copies are fresh (the staging buffers are mutated next build)
        self._inbox_alive = self.alive.copy()
        dev = self.device
        return ChainInbox(torch.from_numpy(req).to(dev, copy=True),
                          torch.from_numpy(stp).to(dev, copy=True),
                          torch.from_numpy(self._inbox_alive).to(dev))

    @_locked
    def tick(self) -> HostChainOutbox:
        pc = self._pc
        pc.begin()
        if self.overload is not None:
            self.overload.update(
                sum(len(q) for q in self._queues.values())
                + sum(1 for rec in self.outstanding.values()
                      if not rec.responded))
        inbox = self._build_inbox()
        pc.mark("intake")
        # dispatch first, journal second: the WAL fsync overlaps the async
        # device step (see paxos/manager.py tick)
        with serial_on_cpu(self.device):
            self.state, packed = chain_tick_packed(self.state, inbox)
        pc.mark("dispatch")
        if self.wal is not None:
            self.wal.log_inbox(self.tick_num, self._inbox_alive)
        pc.mark("wal_fsync")
        out = unpack_chain_outbox(packed, self.R, self.P, self.W, self.G)
        pc.mark("tally")
        self._process_outbox(out)
        self.tick_num += 1
        if self.wal is not None:
            self.wal.maybe_checkpoint()
        self._flush_callbacks()
        if self.tick_num % 64 == 0:
            self._sweep_outstanding()
        pc.mark("execute")
        pc.end()
        return out

    def _flush_callbacks(self) -> None:
        """Release client responses only once the WAL covering their tick
        is durable (log-before-respond, as in the paxos manager)."""
        if not self._held_callbacks:
            return
        if self.wal is not None and not self.wal.is_synced():
            return
        held, self._held_callbacks = self._held_callbacks, []
        for cb, rid, resp in held:
            cb(rid, resp)

    def _process_outbox(self, out: HostChainOutbox) -> None:
        taken = out.intake_taken
        for row, take in self._placed:
            for rid, _entry, p in reversed(take):
                if not taken[p, row] and rid in self.outstanding:
                    self._queues[row].appendleft(rid)
        er, es, ec = out.exec_req, out.exec_stop, out.exec_count
        tail = out.tail_id
        active = np.where(ec.sum(axis=0) > 0)[0] if ec.any() else []
        for row in active:
            name = self.rows.name(int(row))
            if name is None:
                continue
            for r in range(self.R):
                n = int(ec[r, row])
                for j in range(n):
                    rid = int(er[r, j, row])
                    is_stop = bool(es[r, j, row])
                    self._execute_one(
                        r, int(row), name, rid, is_stop, r == int(tail[row])
                    )
        self.stats["decisions"] += int(out.committed_now.sum())

    def _execute_one(self, r: int, row: int, name: str, rid: int,
                     is_stop: bool, at_tail: bool) -> None:
        if is_stop and at_tail and row not in self._stopped_rows:
            self._stopped_rows.add(row)
            self._fail_queued(row)
        if rid == NO_REQUEST:
            return
        rec = self.outstanding.get(rid)
        if rec is None:
            self.stats["orphan_execs"] += 1
            return
        response = self.apps[r].execute(name, rec.payload, rid)
        rec.executed_by.add(r)
        self.stats["executions"] += 1
        if at_tail and not rec.responded:
            # commit point: the tail applied it (every upstream member has
            # therefore applied it too)
            rec.responded = True
            if rec.callback is not None:
                self._held_callbacks.append((rec.callback, rid, response))
        members = int(self._n_members_np[row])
        if rec.responded and len(rec.executed_by) >= members:
            del self.outstanding[rid]

    def _sweep_outstanding(self) -> None:
        """Drop responded records every *live* member has executed — with a
        dead member, executed_by can never cover the full membership, and
        without this sweep every request payload is retained forever (the
        paxos manager sweeps identically; dead members catch up from the
        ring or by checkpoint transfer, not from the host payload store)."""
        if not self.outstanding:
            return
        member = self._member_np
        dead = []
        for rid, rec in self.outstanding.items():
            if not rec.responded:
                continue
            ms = np.where(member[:, rec.row])[0]
            live = [m for m in ms if self.alive[m]]
            if live and all(m in rec.executed_by for m in live):
                dead.append(rid)
        for rid in dead:
            del self.outstanding[rid]
            self.stats["swept"] += 1

    # --------------------------------------------------------------- liveness
    def set_alive(self, r: int, up: bool) -> None:
        self.alive[r] = up

    # ------------------------------------------------------------ conveniences
    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.tick()

    @_locked
    def pending_count(self) -> int:
        return sum(len(q) for q in self._queues.values())
