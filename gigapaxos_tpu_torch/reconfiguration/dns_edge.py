"""DNS front-end: serve A records for service names.

Analog of ``reconfiguration/dns/DnsReconfigurator.java`` (247 LoC): a UDP
DNS server that answers ``A`` queries for service names with the addresses
of the name's current active replicas, with a pluggable traffic policy
deciding which/in what order (``DnsTrafficPolicy`` analog).

Minimal RFC1035 subset, stdlib-only: one question per query, A/IN answers,
NXDOMAIN for unknown names.  The zone suffix (e.g. ``.gp``) is stripped
before resolution so ``alice.gp`` resolves service name ``alice``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..client import ClientError, ReconfigurableAppClient

#: policy(name, actives, addrs) -> ordered list of IPv4 strings to serve
DnsTrafficPolicy = Callable[[str, List[str], dict], List[str]]


def default_policy(name: str, actives: List[str], addrs: dict) -> List[str]:
    """All actives, rotated by the name hash (coarse load spreading)."""
    ips = [addrs[a][0] for a in actives if a in addrs]
    if not ips:
        return []
    k = hash(name) % len(ips)
    return ips[k:] + ips[:k]


def placement_policy(table, base: DnsTrafficPolicy = default_policy
                     ) -> DnsTrafficPolicy:
    """Traffic policy consulting the placement-override table
    (placement/table.py): a migrated name's answer leads with its override
    shard's server, so clients converge to the new placement within one
    TTL; un-overridden names fall through to ``base`` untouched."""

    def policy(name: str, actives: List[str], addrs: dict) -> List[str]:
        ordered = table.order_actives(name, actives)
        if ordered == list(actives):
            return base(name, actives, addrs)
        return [addrs[a][0] for a in ordered if a in addrs]

    return policy


class DnsReconfigurator:
    def __init__(
        self,
        client: ReconfigurableAppClient,
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        zone: str = "gp",
        ttl: int = 30,
        policy: DnsTrafficPolicy = default_policy,
        max_workers: int = 16,
    ):
        self.client = client
        self.zone = zone.strip(".")
        self.ttl = ttl
        self.policy = policy
        self._host_cache: Dict[str, Tuple[float, Optional[str]]] = {}
        # bounded worker pool: UDP queries are spoofable, so per-query
        # unbounded threads are a trivial resource-exhaustion vector; when
        # every worker is busy (each may hold a synchronous RC round trip)
        # excess queries are dropped — resolvers retry
        self._workers = threading.Semaphore(max_workers)
        self.stats = {"dropped": 0}
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.settimeout(0.25)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name=f"dns-{self.port}", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.sock.close()

    # ------------------------------------------------------------------ serve
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                return
            # per-query worker: a cache-miss resolve is a synchronous RC
            # round trip, and one slow name must not stall every other
            # resolver (the client's actives cache keeps the hot path local)
            if not self._workers.acquire(blocking=False):
                self.stats["dropped"] += 1
                continue
            try:
                threading.Thread(
                    target=self._handle_one, args=(data, addr), daemon=True
                ).start()
            except RuntimeError:
                # thread spawn failed (fd/thread exhaustion — the very
                # overload this bound guards): return the permit or the pool
                # shrinks permanently
                self._workers.release()
                self.stats["dropped"] += 1

    def _handle_one(self, data: bytes, addr) -> None:
        try:
            try:
                resp = self._answer(data)
            except Exception:
                return  # malformed query: drop
            if resp is not None:
                try:
                    self.sock.sendto(resp, addr)
                except OSError:
                    pass
        finally:
            self._workers.release()

    def _resolve(self, qname: str) -> Tuple[str, Optional[List[str]]]:
        """-> ("ok", ips) | ("nxdomain", None) | ("servfail", None).

        A transient RC failure must NOT be answered NXDOMAIN: resolvers
        negative-cache nonexistence and would blackhole a healthy name."""
        name = qname.rstrip(".")
        if self.zone and name.endswith("." + self.zone):
            name = name[: -len(self.zone) - 1]
        try:
            actives = self.client.request_actives(name)
        except ClientError:
            return "nxdomain", None  # authoritative: the name does not exist
        except TimeoutError:
            return "servfail", None  # transient: let the resolver retry
        # the actives response already taught the client's nodemap the addrs
        addrs = {
            a: list(self.client.nodemap(a)) for a in actives
            if self.client.nodemap(a) is not None
        }
        ips = []
        failed = 0
        for ip in self.policy(name, actives, addrs):
            # topology may name hosts ('localhost', 'node1.internal');
            # A records need dotted quads.  Lookups are cached so a
            # resolver hiccup can't block every query for its timeout.
            got = self._host_ip(ip)
            if got is None:
                failed += 1
            else:
                ips.append(got)
        if failed and not ips:
            # every host lookup failed transiently: SERVFAIL, never a
            # negative-cacheable empty NOERROR for a healthy name
            return "servfail", None
        return "ok", ips

    def _host_ip(self, host: str) -> Optional[str]:
        now = time.monotonic()
        hit = self._host_cache.get(host)
        if hit is not None and hit[0] > now:
            return hit[1]
        try:
            ip = socket.gethostbyname(host)
            self._host_cache[host] = (now + 60.0, ip)
            return ip
        except OSError:
            self._host_cache[host] = (now + 5.0, None)  # brief negative cache
            return None

    def _answer(self, q: bytes) -> Optional[bytes]:
        if len(q) < 12:
            return None
        (tid, flags, qd, _an, _ns, _ar) = struct.unpack(">HHHHHH", q[:12])
        if qd != 1:
            return None
        # parse QNAME labels
        off = 12
        labels = []
        while True:
            ln = q[off]
            off += 1
            if ln == 0:
                break
            labels.append(q[off: off + ln].decode("ascii", "replace"))
            off += ln
        qtype, qclass = struct.unpack(">HH", q[off: off + 4])
        off += 4
        question = q[12:off]
        qname = ".".join(labels)
        if qclass != 1:
            hdr = struct.pack(">HHHHHH", tid, 0x8404, 1, 0, 0, 0)  # NOTIMP
            return hdr + question
        status, ips = self._resolve(qname)
        if status == "servfail":
            hdr = struct.pack(">HHHHHH", tid, 0x8402, 1, 0, 0, 0)
            return hdr + question
        if status == "nxdomain":
            # unknown name: NXDOMAIN, authoritative
            hdr = struct.pack(">HHHHHH", tid, 0x8403, 1, 0, 0, 0)
            return hdr + question
        if qtype not in (1, 255) or not ips:
            # the name exists but has no records of this type (e.g. AAAA):
            # NOERROR with zero answers — NXDOMAIN here would let resolvers
            # negative-cache the whole name and kill the parallel A lookup
            hdr = struct.pack(">HHHHHH", tid, 0x8400, 1, 0, 0, 0)
            return hdr + question
        answers = b""
        for ip in ips:
            answers += (
                b"\xc0\x0c"  # pointer to QNAME at offset 12
                + struct.pack(">HHIH", 1, 1, self.ttl, 4)
                + socket.inet_aton(ip)
            )
        hdr = struct.pack(">HHHHHH", tid, 0x8400, 1, len(ips), 0, 0)
        return hdr + question + answers
