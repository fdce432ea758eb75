"""ChainReplicaCoordinator: chains behind the replica-coordination SPI.

The whole reconfiguration control plane — epoch lifecycle, demand
migration, final-state transfer — runs unchanged over chains instead of
Paxos groups (the reference selects it through
``REPLICA_COORDINATOR_CLASS``).  :class:`ChainManager` exposes the same host
surface as ``PaxosManager``, so the binding *is* the Paxos binding with a
chain manager underneath; this subclass is the named extension point for
policy that differs per protocol.
"""

from __future__ import annotations

from typing import List

from ..reconfiguration.coordinator import PaxosReplicaCoordinator
from .manager import ChainManager


class ChainReplicaCoordinator(PaxosReplicaCoordinator):
    def __init__(self, manager: ChainManager, node_ids: List[str]):
        super().__init__(manager, node_ids)
