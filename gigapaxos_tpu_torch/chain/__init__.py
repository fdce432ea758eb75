"""Chain replication on the dense device layout (Mode A: the whole chain in
one device program).  The one-process-per-node chain (Mode B) comes with a
later slice of the port."""

from .coordinator import ChainReplicaCoordinator
from .manager import ChainManager

__all__ = ["ChainManager", "ChainReplicaCoordinator"]
