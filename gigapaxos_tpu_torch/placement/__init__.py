"""Placement plane: the placement-override table.

:mod:`table` is an explicit placement-override table layered over the
consistent-hash ring, consulted by edge routing and the client, and
serialized through the replicated reconfigurator DB (``rc_db.py``); it
also carries the cells' name -> (host, cell) overrides.  The demand
counters, the rebalancer and the intra-mesh migrator come with the mesh.
"""

from .table import (PLACEMENT_RECORD, PlacementTable, apply_placement_command,
                    pack_host_cell, unpack_host_cell)

__all__ = [
    "PlacementTable",
    "PLACEMENT_RECORD",
    "apply_placement_command",
    "pack_host_cell",
    "unpack_host_cell",
]
