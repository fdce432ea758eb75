"""Mode B: independent per-node consensus processes over the transport.

Mode A (``paxos/manager.py``) drives a whole replica set as one device
program.  Mode B gives every node its own process and device state, with
replica traffic as SoA frames over the transport — the reference's
deployment shape (``ReconfigurableNode`` per machine,
reconfiguration/ReconfigurableNode.java:63).

The Mode B write-ahead log, its recovery, the peer checkpoint streamer and
the replica coordinator come with the Mode B durability slice of the port.
"""

from .kernel import node_tick_impl, node_tick_packed
from .manager import ModeBNode, rid_origin
from .wire import decode_frame, encode_frame, gid_of

__all__ = [
    "ModeBNode",
    "decode_frame",
    "encode_frame",
    "gid_of",
    "node_tick_impl",
    "node_tick_packed",
    "rid_origin",
]
