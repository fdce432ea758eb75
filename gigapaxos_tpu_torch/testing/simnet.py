"""Deterministic in-process network simulator: partitions, link delays,
and seeded WAN profiles (RTT / jitter / loss / bandwidth).

The reference tests liveness/failover at loopback RTT and emulates WAN
latency by delaying JSON sends inside the transport
(``nio/JSONDelayEmulator.java:39-77``, enabled by
``TESTPaxosConfig``); partitions are emulated by crashing nodes
(``TESTPaxosConfig.crash``).  This module gives the TPU framework both
knobs with *deterministic* delivery: messages move only when the harness
calls :meth:`SimNet.pump`, so a test can interleave ticks and delivery
rounds exactly, hold a frame in flight across a coordinator change, or cut
any directed link mid-protocol.

Beyond static partitions/delays, each directed link can carry a
:class:`LinkProfile` — a WAN model with one-way latency, seeded jitter,
probabilistic loss, and a bandwidth-ish serialization delay (big payloads
take extra rounds).  Named 3–5 region geo topologies
(:data:`GEO_TOPOLOGIES`) map nodes to regions and install inter-region
profiles from a realistic RTT matrix; whole regions can then be cut and
healed (:meth:`SimNet.cut_region` / :meth:`SimNet.heal_region`).  All
randomness comes from one ``numpy`` generator seeded at construction, so
a scenario replays bit-identically from ``(seed, schedule)``.

:class:`SimMessenger` exposes the same surface as ``net.messenger.Messenger``
(``demux``/``register``/``send``/``multicast``/``send_bytes``/``close``), so
anything that speaks Messenger — ``ModeBNode``, protocol executors, the
failure detector — runs unmodified over the simulator.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import json
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from ..net.transport import KIND_BYTES, KIND_JSON, JsonDemux


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """WAN model for one directed link.  Delay unit is pump rounds.

    ``rtt_rounds`` is the *one-way* base latency (the name matches how the
    geo tables are specified: half the region-pair RTT after conversion).
    ``jitter_rounds`` adds a seeded uniform extra in ``[0, jitter_rounds]``
    per message.  ``loss`` drops each message independently with that
    probability.  ``bytes_per_round`` > 0 models serialization: a payload
    of n bytes takes ``n // bytes_per_round`` extra rounds (slow-node /
    thin-pipe emulation); 0 disables it.
    """

    rtt_rounds: int = 0
    jitter_rounds: int = 0
    loss: float = 0.0
    bytes_per_round: int = 0

    def delay_for(self, nbytes: int, rng: np.random.Generator) -> int:
        d = self.rtt_rounds
        if self.jitter_rounds > 0:
            d += int(rng.integers(0, self.jitter_rounds + 1))
        if self.bytes_per_round > 0:
            d += nbytes // self.bytes_per_round
        return d


#: Inter-region RTT matrices in milliseconds (symmetric; diagonal =
#: intra-region RTT).  Rough public-cloud numbers — the point is realistic
#: *shape* (asymmetry of magnitudes, a far region, a near pair), not
#: provider-exact figures; they are simulated, never measured.
GEO_TOPOLOGIES: Dict[str, Dict[str, object]] = {
    # 3 regions: two close (us-east/us-west), one far (eu).
    "us3": {
        "regions": ["use", "usw", "eu"],
        "rtt_ms": [
            [2, 60, 80],
            [60, 2, 140],
            [80, 140, 2],
        ],
    },
    # 4 regions: US pair + EU + AP, AP far from everything.
    "global4": {
        "regions": ["use", "usw", "eu", "ap"],
        "rtt_ms": [
            [2, 60, 80, 170],
            [60, 2, 140, 110],
            [80, 140, 2, 240],
            [170, 110, 240, 2],
        ],
    },
    # 5 regions: adds South America off us-east.
    "global5": {
        "regions": ["use", "usw", "eu", "ap", "sa"],
        "rtt_ms": [
            [2, 60, 80, 170, 120],
            [60, 2, 140, 110, 180],
            [80, 140, 2, 240, 200],
            [170, 110, 240, 2, 300],
            [120, 180, 200, 300, 2],
        ],
    },
}


class SimMessenger:
    """One simulated node endpoint (Messenger-compatible)."""

    def __init__(self, net: "SimNet", node_id: str):
        self.net = net
        self.node_id = node_id
        self.demux = JsonDemux()
        self.closed = False
        self.port = 0  # no socket; Messenger-surface compatibility

    def register(self, ptype, handler) -> None:
        self.demux.register(ptype, handler)

    def send(self, dest: str, packet: dict) -> None:
        packet.setdefault("sender", self.node_id)
        self.net._enqueue(self.node_id, dest, KIND_JSON,
                          json.dumps(packet).encode())

    def multicast(self, dests: Iterable[str], packet: dict) -> None:
        packet.setdefault("sender", self.node_id)
        for d in dests:
            if d is not None:
                self.net._enqueue(self.node_id, d, KIND_JSON,
                                  json.dumps(packet).encode())

    def send_bytes(self, dest: str, payload: bytes) -> None:
        self.net._enqueue(self.node_id, dest, KIND_BYTES, payload)

    def close(self) -> None:
        self.closed = True


class SimNet:
    """The wire: directed links with up/down state, delay, and WAN profiles.

    Delay unit is *pump rounds* (a message sent at round t with link delay d
    is delivered during the pump that advances past round t+d).  Default
    delay 0 = delivered by the next ``pump()``.  Profile-induced jitter and
    loss draw from one seeded generator, so a run is reproducible from the
    constructor seed.
    """

    def __init__(self, seed: int = 0):
        self.endpoints: Dict[str, SimMessenger] = {}
        self.round = 0
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._seq = 0
        self._heap: list = []  # (due_round, seq, src, dst, kind, payload)
        self._down: set = set()  # directed (src, dst)
        self._delay: Dict[Tuple[str, str], int] = {}
        self._profile: Dict[Tuple[str, str], LinkProfile] = {}
        self._slow_extra: Dict[str, int] = {}  # node -> extra rounds
        self.default_delay = 0
        self.node_region: Dict[str, str] = {}
        self.stats = collections.Counter()

    # ------------------------------------------------------------- topology
    def messenger(self, node_id: str) -> SimMessenger:
        m = SimMessenger(self, node_id)
        self.endpoints[node_id] = m
        return m

    def set_delay(self, src: str, dst: str, rounds: int,
                  both_ways: bool = True) -> None:
        self._delay[(src, dst)] = rounds
        if both_ways:
            self._delay[(dst, src)] = rounds

    def set_profile(self, src: str, dst: str, profile: LinkProfile,
                    both_ways: bool = True) -> None:
        self._profile[(src, dst)] = profile
        if both_ways:
            self._profile[(dst, src)] = profile

    def set_slow_node(self, node: str, extra_rounds: int) -> None:
        """Every message in or out of ``node`` takes ``extra_rounds`` longer
        (0 restores normal speed) — a saturated/overloaded-host emulation."""
        if extra_rounds <= 0:
            self._slow_extra.pop(node, None)
        else:
            self._slow_extra[node] = int(extra_rounds)

    def set_link(self, src: str, dst: str, up: bool,
                 both_ways: bool = True) -> None:
        pairs = [(src, dst)] + ([(dst, src)] if both_ways else [])
        for p in pairs:
            if up:
                self._down.discard(p)
            else:
                self._down.add(p)

    def partition(self, *sides: Iterable[str]) -> None:
        """Cut every link between nodes of different sides (both ways)."""
        groups = [set(s) for s in sides]
        for i, a in enumerate(groups):
            for b in groups[i + 1:]:
                for x in a:
                    for y in b:
                        self._down.add((x, y))
                        self._down.add((y, x))

    def heal(self) -> None:
        self._down.clear()

    # ---------------------------------------------------------------- geo
    def apply_geo(self, name: str, placement: Mapping[str, str],
                  ms_per_round: float = 10.0,
                  jitter_frac: float = 0.2,
                  loss: float = 0.0) -> None:
        """Install a named geo topology over the registered nodes.

        ``placement`` maps node id -> region name (regions from
        :data:`GEO_TOPOLOGIES`\\ [name]).  RTT(ms) converts to one-way
        rounds as ``round(rtt / 2 / ms_per_round)``; jitter is
        ``jitter_frac`` of the one-way latency.  Intra-region links use
        the matrix diagonal.  Idempotent; later calls overwrite profiles.
        """
        topo = GEO_TOPOLOGIES[name]
        regions: List[str] = list(topo["regions"])  # type: ignore[arg-type]
        rtt = topo["rtt_ms"]
        for node, region in placement.items():
            if region not in regions:
                raise ValueError(f"unknown region {region!r} for topo {name!r}")
            self.node_region[node] = region
        nodes = list(placement)
        for a in nodes:
            for b in nodes:
                if a == b:
                    continue
                i = regions.index(placement[a])
                j = regions.index(placement[b])
                one_way = max(0, int(round(rtt[i][j] / 2.0 / ms_per_round)))
                prof = LinkProfile(
                    rtt_rounds=one_way,
                    jitter_rounds=int(round(one_way * jitter_frac)),
                    loss=loss,
                )
                self.set_profile(a, b, prof, both_ways=False)

    def region_nodes(self, region: str) -> List[str]:
        return [n for n, r in self.node_region.items() if r == region]

    def cut_region(self, region: str) -> List[str]:
        """Partition every node of ``region`` from the rest of the world
        (both directions).  Returns the nodes cut."""
        inside = set(self.region_nodes(region))
        outside = [n for n in self.endpoints if n not in inside]
        if inside and outside:
            self.partition(inside, outside)
        self.stats["region_cuts"] += 1
        return sorted(inside)

    def heal_region(self, region: str) -> None:
        """Restore every link touching nodes of ``region`` (other
        partitions stay in place)."""
        inside = set(self.region_nodes(region))
        self._down = {(a, b) for (a, b) in self._down
                      if a not in inside and b not in inside}

    def drop_pending(self, src: Optional[str] = None,
                     dst: Optional[str] = None) -> int:
        """Discard in-flight messages (long-outage emulation: the real
        transport's retries exhausted).  Returns how many were dropped."""
        keep, dropped = [], 0
        for item in self._heap:
            if ((src is None or item[2] == src)
                    and (dst is None or item[3] == dst)):
                dropped += 1
            else:
                keep.append(item)
        heapq.heapify(keep)
        self._heap = keep
        self.stats["dropped_pending"] += dropped
        return dropped

    # ------------------------------------------------------------- transfer
    def _link_delay(self, src: str, dst: str, nbytes: int) -> Optional[int]:
        """Effective delay in rounds, or None if the message is lost."""
        prof = self._profile.get((src, dst))
        if prof is not None:
            if prof.loss > 0.0 and self.rng.random() < prof.loss:
                return None
            d = prof.delay_for(nbytes, self.rng)
        else:
            d = self._delay.get((src, dst), self.default_delay)
        d += self._slow_extra.get(src, 0) + self._slow_extra.get(dst, 0)
        return d

    def _enqueue(self, src: str, dst: str, kind: int, payload: bytes) -> None:
        if (src, dst) in self._down:
            self.stats["dropped_down"] += 1
            return
        d = self._link_delay(src, dst, len(payload))
        if d is None:
            self.stats["dropped_loss"] += 1
            return
        self._seq += 1
        heapq.heappush(self._heap,
                       (self.round + d, self._seq, src, dst, kind, payload))
        self.stats["sent"] += 1

    def pump(self, rounds: int = 1) -> int:
        """Advance time and deliver everything due.  Returns deliveries."""
        n = 0
        for _ in range(rounds):
            self.round += 1
            while self._heap and self._heap[0][0] < self.round:
                _, _, src, dst, kind, payload = heapq.heappop(self._heap)
                ep = self.endpoints.get(dst)
                if ep is None or ep.closed:
                    self.stats["dropped_dead"] += 1
                    continue
                # a link cut while the message was in flight loses it, like
                # a TCP connection reset mid-outage
                if (src, dst) in self._down:
                    self.stats["dropped_down"] += 1
                    continue
                try:
                    ep.demux(src, kind, payload)
                except Exception:
                    self.stats["demux_errors"] += 1
                n += 1
                self.stats["delivered"] += 1
        return n
