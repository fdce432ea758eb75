"""Consistent hashing of service names onto reconfigurator groups.

Analog of ``reconfigurationutils/ConsistentHashing.java:40-64``: an MD5 ring
over node ids; a name hashes to a point on the ring and its replica group is
the next ``k`` distinct nodes clockwise.  This is how the control plane
shards itself (SURVEY §2.2 parallelism axis 4): each name's RC group is a
deterministic function of the RC node set, so any node can route control
traffic without a directory.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Sequence


def _h(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    def __init__(self, nodes: Sequence[str], replicas_per_node: int = 50):
        """``replicas_per_node`` = virtual points per node for load balance
        (the reference hashes each node id once; virtual nodes strictly
        improve balance with the same interface)."""
        self.nodes = sorted(set(nodes))
        self.vpoints = replicas_per_node
        self._ring: List[int] = []
        self._owner: Dict[int, str] = {}
        for n in self.nodes:
            for v in range(replicas_per_node):
                p = _h(f"{n}#{v}")
                # deterministic collision tiebreak: lowest node id wins
                if p not in self._owner or n < self._owner[p]:
                    self._owner[p] = n
        self._ring = sorted(self._owner)

    def replicated_servers(self, name: str, k: int = 3) -> List[str]:
        """The ``k`` distinct nodes clockwise from the name's ring point
        (``getReplicatedServers`` analog).  k is capped at the node count."""
        if not self.nodes:
            return []
        k = min(k, len(self.nodes))
        start = bisect.bisect_left(self._ring, _h(name)) % len(self._ring)
        out: List[str] = []
        i = start
        while len(out) < k:
            n = self._owner[self._ring[i % len(self._ring)]]
            if n not in out:
                out.append(n)
            i += 1
        return out

    def primary(self, name: str) -> str:
        return self.replicated_servers(name, 1)[0]
