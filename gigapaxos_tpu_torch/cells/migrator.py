"""Cross-cell live migration of a Paxos group, over the worker protocol.

Same epoch machinery as the intra-mesh migrator (placement/migrator.py) —
stop the old epoch, drain the donor checkpoint, birth ``name#(e+1)`` from
the blob via the journaled targeted create (OP_CREATE_AT) — except source
and destination are different OS PROCESSES, so each step is a line-protocol
RPC against the owning cell's worker:

  1. ``migrate_out <name>``            (source: stop + drained blob)
  2. ``migrate_in <name> <e+1> <hex>`` (destination: journaled create-at)
  3. ``migrate_drop <name> <e>``       (source: GC the stopped epoch)
  4. ``broadcast_override``            (router + every edge's directory)

Crash safety is inherited from the journaled steps: a crash after (2)
leaves both cells with journaled state and the drop re-runs on retry; a
crash before (2) leaves the source epoch intact (stopped at worst, where
the name continues in a new epoch on the SOURCE cell via the normal
reconfiguration retry path).  The override broadcast is volatile per
worker but deterministic from the supervisor's router, which re-seeds a
restarted cell through its spec.
"""

from __future__ import annotations

from typing import Optional

from .supervisor import CellSupervisor


class CellMigrator:
    """Drives one-group moves between a supervisor's cells."""

    def __init__(self, sup: CellSupervisor, timeout_s: float = 60.0):
        self.sup = sup
        self.timeout_s = timeout_s
        self.moved = 0
        self.aborted = 0

    def migrate(self, name: str, dst_cell: int) -> bool:
        sup = self.sup
        src_cell = sup.router.cell(name)
        if dst_cell == src_cell:
            return True
        if not (0 <= dst_cell < sup.n_cells):
            raise ValueError(f"cell {dst_cell} out of range")
        src, dst = sup.cells[src_cell], sup.cells[dst_cell]
        t = self.timeout_s
        out = src.rpc(f"migrate_out {name}", "migrat", t)
        if out.startswith("migrate_err"):
            self.aborted += 1
            return False
        _tag, _n, epoch, blob = out.split(" ", 3)
        resp = dst.rpc(f"migrate_in {name} {int(epoch) + 1} {blob}",
                       "migrat", t)
        if resp.startswith("migrate_err"):
            self.aborted += 1
            return False
        src.rpc(f"migrate_drop {name} {epoch}", "migrate_dropped", t)
        sup.broadcast_override(name, dst_cell)
        self.moved += 1
        return True


class CellRebalancer:
    """Tiny demand-driven policy: move the hottest group off the busiest
    cell when its group count exceeds the mean by ``skew_threshold``.
    Group counts (worker ``stats``) stand in for load on a host where every
    cell runs the same workload mix; richer demand wiring rides the
    placement plane."""

    def __init__(self, sup: CellSupervisor, migrator: Optional[CellMigrator]
                 = None, skew_threshold: float = 1.5):
        self.sup = sup
        self.migrator = migrator or CellMigrator(sup)
        self.skew_threshold = skew_threshold

    def run_once(self, candidates) -> int:
        """``candidates``: name -> owner-cell mapping the caller knows
        (e.g. the created names); returns groups moved."""
        counts = {}
        for k, h in self.sup.cells.items():
            if h.alive():
                counts[k] = h.stats().get("groups", 0)
        if len(counts) < 2:
            return 0
        mean = sum(counts.values()) / len(counts)
        busiest = max(counts, key=counts.get)
        coolest = min(counts, key=counts.get)
        if counts[busiest] < max(self.skew_threshold * mean, mean + 1):
            return 0
        for name in candidates:
            if self.sup.router.cell(name) == busiest:
                return int(self.migrator.migrate(name, coolest))
        return 0
