"""Mode B: independent per-node consensus processes over the transport.

Mode A (``paxos/manager.py``) drives a whole replica set as one device
program.  Mode B gives every node its own process, device state and WAL,
with replica traffic as SoA frames over the transport — the reference's
deployment shape (``ReconfigurableNode`` per machine,
reconfiguration/ReconfigurableNode.java:63).
"""

from .kernel import node_tick_impl, node_tick_packed
from .logger import ModeBLogger, recover_modeb
from .manager import ModeBNode, PeerCheckpointStreamer, rid_origin
from .wire import decode_frame, encode_frame, gid_of

__all__ = [
    "ModeBLogger",
    "ModeBNode",
    "ModeBReplicaCoordinator",
    "ModeBRepliconfigurableDB",
    "PeerCheckpointStreamer",
    "decode_frame",
    "encode_frame",
    "gid_of",
    "node_tick_impl",
    "node_tick_packed",
    "recover_modeb",
    "rid_origin",
]

from .coordinator import (  # noqa: E402  (needs manager first)
    ModeBReplicaCoordinator,
    ModeBRepliconfigurableDB,
)
