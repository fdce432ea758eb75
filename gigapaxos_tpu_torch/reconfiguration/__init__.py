from .active_replica import ActiveReplica
from .consistent_hashing import ConsistentHashRing
from .coordinator import AbstractReplicaCoordinator, PaxosReplicaCoordinator
from .demand import AbstractDemandProfile, DemandProfile, RateBasedMigrationPolicy
from .rc_db import ReconfiguratorDB, RepliconfigurableReconfiguratorDB
from .reconfigurator import Reconfigurator
from .records import RCState, ReconfigurationRecord

__all__ = [
    "ActiveReplica",
    "ConsistentHashRing",
    "AbstractReplicaCoordinator",
    "PaxosReplicaCoordinator",
    "AbstractDemandProfile",
    "DemandProfile",
    "RateBasedMigrationPolicy",
    "ReconfiguratorDB",
    "RepliconfigurableReconfiguratorDB",
    "Reconfigurator",
    "RCState",
    "ReconfigurationRecord",
]
