"""Live migration of a Paxos group between mesh shards.

A "mesh shard" is a contiguous row range of ONE manager's [G] state arrays
(shard k owns rows [k*G/gs, (k+1)*G/gs)) — migrating a group means
re-homing its name to a row in a different range, which is exactly an epoch
change (reconfiguration/coordinator.py) with a targeted destination row:

  1. propose the epoch-final stop (``stop_replica_group``) and pump ticks
     until it commits — everything acknowledged in epoch e is fenced;
  2. ``get_final_state``: pipeline-drained donor checkpoint of epoch e
     (the donor is a member at the max exec watermark, so no acknowledged
     write can be missing from the blob);
  3. allocate a free row in the destination shard's range
     (``RowAllocator.free_in_range``) and birth ``name#(e+1)`` there with
     the blob as seed (``create_replica_group_at`` -> journaled WAL
     OP_CREATE_AT, so crash replay re-creates the SAME row with the SAME
     state);
  4. ``drop_final_state(name, e)`` frees the source row;
  5. update the placement-override table + carry the EWMA counter so the
     rebalancer sees the load move immediately.

Safety argument: a write is acknowledged only after it is decided, executed
and WAL-synced in epoch e; the stop totally orders after it, the donor
checkpoint includes it, and the new epoch is seeded from that checkpoint
before it accepts anything — so the handoff loses nothing.  A crash at any
point replays to one of: old epoch intact (steps 1-3 incomplete), or both
rows present (create journaled, drop not yet) and the drop re-runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .rebalancer import MigrationPlan


@dataclass
class MigrationStats:
    """Observability counters, exported via utils/observability.py."""

    plans_emitted: int = 0
    groups_moved: int = 0
    bytes_transferred: int = 0
    aborts: int = 0
    retries: int = 0
    last_move_tick: int = -1
    #: name -> destination shard of the most recent successful move
    last_moves: Dict[str, int] = field(default_factory=dict)

    def snapshot(self) -> dict:
        return {
            "plans_emitted": self.plans_emitted,
            "groups_moved": self.groups_moved,
            "bytes_transferred": self.bytes_transferred,
            "aborts": self.aborts,
            "retries": self.retries,
            "last_move_tick": self.last_move_tick,
        }


class GroupMigrator:
    """Executes migration plans through the epoch machinery.

    ``coordinator`` is a PaxosReplicaCoordinator (duck-typed); ``pump`` is a
    zero-arg callable advancing the plane one tick (the stop decision and
    its execution need real ticks to commit) — in servers it's the tick
    driver's step, in tests the workload loop.
    """

    def __init__(self, coordinator, *, table=None, counters=None,
                 stats: Optional[MigrationStats] = None,
                 max_pump_ticks: int = 256):
        self.coord = coordinator
        self.table = table
        self.counters = counters
        self.stats = stats or MigrationStats()
        self.max_pump_ticks = int(max_pump_ticks)

    # ------------------------------------------------------------- one move
    def migrate(self, name: str, dst_shard: int,
                pump: Callable[[], None]) -> bool:
        """Live-migrate ``name`` to a free row in ``dst_shard``.  Returns
        True on success; on abort the group keeps serving in place (the
        stop may still have committed — the name then continues in the NEW
        epoch on the SOURCE shard via the normal retry path)."""
        m = self.coord.manager
        epoch = self.coord.current_epoch(name)
        if epoch is None:
            self.stats.aborts += 1
            return False
        pname_old = self.coord._pax_name(name, epoch)
        with m.lock:
            old_row = m.rows.row(pname_old)
            slots = m.group_members(pname_old)
        if old_row is None or not slots:
            self.stats.aborts += 1
            return False
        lo, hi = self._shard_range(m, dst_shard)
        if m.rows.free_in_range(lo, hi) is None:
            self.stats.aborts += 1  # destination full: plan was stale
            return False

        # 1. fence the old epoch
        stopped = [False]
        self.coord.stop_replica_group(name, epoch,
                                      lambda ok: stopped.__setitem__(0, ok))
        # 2. pump until the drained donor checkpoint is available
        blob = self.coord.get_final_state(name, epoch)
        ticks = 0
        while blob is None and ticks < self.max_pump_ticks:
            pump()
            ticks += 1
            if ticks > 1:
                self.stats.retries += 1
            blob = self.coord.get_final_state(name, epoch)
        if blob is None:
            self.stats.aborts += 1
            return False

        # 3. birth the new epoch at a destination-shard row.  The row is
        # re-picked under the lock — the pump may have paused/created rows
        # since the capacity pre-check.
        nodes = [self.coord.node_ids[s] for s in slots]
        with m.lock:
            row = m.rows.free_in_range(lo, hi)
            if row is None:
                self.stats.aborts += 1
                return False
            ok = self.coord.create_replica_group_at(
                name, epoch + 1, blob, nodes, row
            )
        if not ok:
            self.stats.aborts += 1
            return False
        # 4. GC the stopped source epoch (frees the source row)
        self.coord.drop_final_state(name, epoch)
        # 5. routing + counters follow the move
        if self.table is not None:
            self.table.set_override(name, dst_shard)
        if self.counters is not None:
            self.counters.move_row(old_row, row)
        self.stats.groups_moved += 1
        self.stats.bytes_transferred += len(blob)
        self.stats.last_move_tick = m.tick_num
        self.stats.last_moves[name] = dst_shard
        return True

    # ------------------------------------------------------------ plan level
    def execute_plan(self, plan: MigrationPlan,
                     pump: Callable[[], None]) -> int:
        """Run every move of a plan; returns how many succeeded.  Row ids in
        the plan are resolved to names at execution time — a row whose
        occupant changed since planning is skipped (stale plan entry)."""
        if not plan.moves:
            return 0
        self.stats.plans_emitted += 1
        m = self.coord.manager
        moved = 0
        for row, _src, dst in plan.moves:
            pname = m.rows.name(int(row))
            if pname is None or "#" not in pname:
                self.stats.aborts += 1
                continue
            name, _, ep = pname.rpartition("#")
            if self.coord.current_epoch(name) != int(ep):
                self.stats.aborts += 1
                continue
            if self.migrate(name, int(dst), pump):
                moved += 1
        return moved

    @staticmethod
    def _shard_range(m, shard: int) -> tuple:
        _gs, per = m.shard_geometry()
        return shard * per, (shard + 1) * per
