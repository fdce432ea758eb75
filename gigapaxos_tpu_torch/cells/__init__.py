"""Serving cells: the multi-core host plane.

One host runs N crash-isolated Mode A manager cells — each a
process-pinned worker (worker.py) owning the static group-space shard
``crc32(name) % N`` with its own tick driver, WAL directory and transport
endpoint — under a :class:`CellSupervisor` (supervisor.py) that spawns,
pins, health-checks (EWMA heartbeats over a local control socket),
SIGTERM-drains and crash-restarts them with WAL replay.  Routing is
directory-free (routing.py): clients compute the owner cell from the name,
and migrated names ride placement-table cell overrides.  Cross-cell moves
reuse the epoch machinery (migrator.py).

The host-plane mirror of the state-plane mesh sharding in parallel/: the
mesh splits one manager's arrays over devices; cells split one host's
*cores* over managers.
"""

from .routing import CellRouter, cell_of
from .supervisor import CellHandle, CellSpec, CellSupervisor
from .migrator import CellMigrator, CellRebalancer

__all__ = [
    "CellHandle",
    "CellMigrator",
    "CellRebalancer",
    "CellRouter",
    "CellSpec",
    "CellSupervisor",
    "cell_of",
]
