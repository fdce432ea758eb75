"""Chain replication on the dense device layout: Mode A (``manager.py``,
the whole chain in one device program) and one process per chain node
(``modeb.py``'s ``ChainModeBNode``, with ``modeb_logger.py``'s journal and
``recover_chain_modeb``)."""

from .coordinator import ChainReplicaCoordinator
from .manager import ChainManager

__all__ = ["ChainManager", "ChainReplicaCoordinator"]
