"""Placement plane: demand-driven live migration of Paxos groups.

* :mod:`counters`   — per-group demand as EWMA request-rate counters, folded
  on the device inside the tick program (one device) or after the shards
  (the mesh), or from host intake bookkeeping, reduced per shard;
* :mod:`rebalancer` — host-side hot/cold shard detection + greedy bin-pack
  migration plans, with hysteresis and min-interval guards mirroring the
  demand SPI's rate limits (reconfiguration/demand.py);
* :mod:`migrator`   — live row migration between shard ranges through the
  stop/start epoch protocol (reconfiguration/coordinator.py), journaled for
  deterministic WAL replay;
* :mod:`table`      — an explicit placement-override table layered over the
  consistent-hash ring, consulted by edge routing and the client, and
  serialized through the replicated reconfigurator DB (``rc_db.py``); it
  also carries the cells' name -> (host, cell) overrides.

The decision plane runs host-side off dense device counters; the data
plane never waits on it.
"""

from .counters import PlacementCounters
from .migrator import GroupMigrator, MigrationStats
from .rebalancer import MigrationPlan, ShardRebalancer
from .table import (PLACEMENT_RECORD, PlacementTable, apply_placement_command,
                    pack_host_cell, unpack_host_cell)

__all__ = [
    "PlacementCounters",
    "GroupMigrator",
    "MigrationStats",
    "MigrationPlan",
    "ShardRebalancer",
    "PlacementTable",
    "PLACEMENT_RECORD",
    "apply_placement_command",
    "pack_host_cell",
    "unpack_host_cell",
]
