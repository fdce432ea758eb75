"""Typed messenger over the framed transport.

``JSONMessenger`` analog (``nio/JSONMessenger.java:44-52``): multicast of a
packet to a node set (``GenericMessagingTask`` sends), sender stamping, and
the glue that lets a ``ProtocolExecutor`` emit ``(dest, packet)`` messages
directly.  The reference's exponential-backoff retransmission
(``JSONMessenger.java:323-348``) lives in two places here: the transport
retries frames across reconnects, and workflow liveness comes from
protocol-task restarts — so the messenger itself stays stateless.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

from ..config import NodeConfig
from ..overload import CLS_CONTROL
from .transport import KIND_JSON, JsonDemux, Transport


class NodeMap:
    """node id -> (host, port) resolver over NodeConfig, mutable at runtime
    (elastic node add/remove, Reconfigurator.handleReconfigureRCNodeConfig)."""

    def __init__(self, nodes: Optional[NodeConfig] = None):
        self._addr: Dict[str, Tuple[str, int]] = {}
        if nodes is not None:
            self._addr.update(nodes.actives)
            self._addr.update(nodes.reconfigurators)

    def add(self, node_id: str, host: str, port: int) -> None:
        self._addr[node_id] = (host, port)

    def remove(self, node_id: str) -> None:
        self._addr.pop(node_id, None)

    def __call__(self, node_id: str) -> Optional[Tuple[str, int]]:
        return self._addr.get(node_id)

    def ids(self):
        return sorted(self._addr)


class Messenger:
    """One node's typed messaging endpoint.

    Construction binds the server socket; register handlers on ``demux``
    before traffic arrives.  ``send``/``multicast`` stamp the packet with
    ``sender`` so handlers can reply without trusting the TCP hello alone.
    """

    def __init__(
        self,
        node_id: str,
        bind: Tuple[str, int],
        nodemap: NodeMap,
        **transport_kw,
    ):
        self.node_id = node_id
        self.nodemap = nodemap
        self.demux = JsonDemux()
        self.transport = Transport(
            node_id, bind, self.demux, nodemap, **transport_kw
        )
        self.port = self.transport.port

    def register(self, ptype, handler) -> None:
        self.demux.register(ptype, handler)

    def send(self, dest: str, packet: dict, cls: int = CLS_CONTROL) -> None:
        packet.setdefault("sender", self.node_id)
        self.transport.send(dest, packet, cls=cls)

    def multicast(self, dests: Iterable[str], packet: dict,
                  cls: int = CLS_CONTROL) -> None:
        # serialize ONCE and fan the same byte buffer to every destination
        # (GenericMessagingTask sends one marshalled packet to a node set)
        packet.setdefault("sender", self.node_id)
        data = json.dumps(packet).encode()
        for d in dests:
            if d is not None:
                self.transport.send_raw(d, KIND_JSON, data, cls=cls)

    def send_bytes(self, dest: str, payload: bytes,
                   cls: int = CLS_CONTROL) -> None:
        self.transport.send_bytes(dest, payload, cls=cls)

    def send_bytes_many(self, dest: str, payloads,
                        cls: int = CLS_CONTROL) -> None:
        """A tick's frame list for one peer: stamped under one transport
        generation so the writer can drain them in a single writev."""
        self.transport.send_bytes_many(dest, payloads, cls=cls)

    def close(self) -> None:
        self.transport.close()
