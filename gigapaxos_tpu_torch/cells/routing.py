"""Directory-free cell routing.

Each serving cell owns a static shard of the group-name space:
``cell_of(name, n) = crc32(name) % n``.  Any client (or edge) computes the
owner with zero metadata — the consistent-hashing idea one level down, with
a fixed modulus because the cell count of a host is a deployment constant,
not an elastic membership.  Names migrated across cells
(migrator.CellMigrator) are the exceptions; they live in the override map,
exactly like the placement table layers overrides on the hash ring.

:class:`CellRouter` is the client-side directory.  It duck-types the
placement-table surface ``client._route`` consults (``lead_server`` /
``order_actives`` / ``epoch``) and adds the cell extensions the client uses
when present:

* ``rc_ids(name)``   — the owner cell's reconfigurators (control RPCs for a
  name must go to the cell that holds its records);
* ``actives_of(name)`` — the owner cell's active set, answered with NO RC
  round-trip: static hash placement plus the override map IS the directory,
  which is how a first request reaches the right cell with zero extra hops.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence


def cell_of(name: str, n_cells: int) -> int:
    """The cell owning ``name`` under static hash placement."""
    if n_cells <= 1:
        return 0
    return zlib.crc32(name.encode()) % n_cells


class CellRouter:
    """name -> owner cell -> that cell's node ids, for one host.

    ``actives_by_cell[k]`` / ``rcs_by_cell[k]`` list cell k's node ids in
    the merged topology the supervisor hands to clients (cell-qualified ids
    like ``c0.AR1``).  ``epoch`` bumps on every override change so client
    route caches invalidate (client._route).
    """

    def __init__(self, actives_by_cell: Sequence[Sequence[str]],
                 rcs_by_cell: Sequence[Sequence[str]]):
        if len(actives_by_cell) != len(rcs_by_cell):
            raise ValueError("need one active set and one RC set per cell")
        self.actives_by_cell = [list(c) for c in actives_by_cell]
        self.rcs_by_cell = [list(c) for c in rcs_by_cell]
        self.n_cells = len(self.actives_by_cell)
        self.overrides: Dict[str, int] = {}
        self.epoch = 0
        self._cell_of_node = {
            n: k for k, cell in enumerate(self.actives_by_cell) for n in cell
        }

    # ------------------------------------------------------------- directory
    def cell(self, name: str) -> int:
        ov = self.overrides.get(name)
        return cell_of(name, self.n_cells) if ov is None else ov

    def rc_ids(self, name: str) -> List[str]:
        return list(self.rcs_by_cell[self.cell(name)])

    def actives_of(self, name: str) -> List[str]:
        return list(self.actives_by_cell[self.cell(name)])

    # ------------------------------------------------------------- overrides
    def set_override(self, name: str, cell: int) -> None:
        if not (0 <= cell < self.n_cells):
            raise ValueError(f"cell {cell} out of range")
        self.overrides[name] = int(cell)
        self.epoch += 1

    def clear_override(self, name: str) -> None:
        if self.overrides.pop(name, None) is not None:
            self.epoch += 1

    def load_table(self, table) -> None:
        """Adopt the cell overrides a PlacementTable carries (its
        ``cell_overrides`` map, host shard ignored on a single host) plus
        its epoch, so replicated placement commands drive this router."""
        self.overrides = {
            n: cell for n, (_shard, cell) in table.cell_overrides.items()
            if 0 <= cell < self.n_cells
        }
        self.epoch = int(table.epoch)

    # ------------------------------------- placement-table duck-type surface
    def lead_server(self, name: str) -> Optional[str]:
        """None: within the owner cell the client's RTT-ranked pick decides
        (the cell, not the node, is what this router constrains)."""
        return None

    def order_actives(self, name: str, actives: Sequence[str]) -> List[str]:
        """Owner cell's nodes first, foreign-cell nodes (stale caller list)
        after — a client iterating the result converges on the owner."""
        own = self.cell(name)
        mine = [a for a in actives if self._cell_of_node.get(a) == own]
        rest = [a for a in actives if self._cell_of_node.get(a) != own]
        return mine + rest
