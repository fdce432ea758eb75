"""Node-addressed, reconnecting, framed TCP transport (the DCN path).

Analog of the reference's NIO stack (``nio/NIOTransport.java:65-114`` +
``MessageNIOTransport.java:72``): a byte-stream transport with

* length-prefixed framing (``MessageExtractor`` analog);
* node-ID addressing — one outbound connection per peer, created lazily,
  with a bounded send queue and **reconnect-on-failure** (the reference's
  pendingWrites/pendingConnects queues);
* loopback short-circuit for self-sends (``sendOrLoopback``,
  PaxosManager.java:2116-2128);
* an identifying hello frame so receivers know the sender's node id.

Role in this framework (SURVEY §2.2): this carries *host-level* traffic —
client edge, reconfiguration control plane, failure-detection keep-alives,
checkpoint transfer.  Replica-axis quorum traffic inside the device program
stays on the device (ops/tick.py) and never touches this module.

Threads: one acceptor per endpoint, one reader per inbound connection, one
writer per outbound peer.  The reference runs a single selector thread; on the
host control plane connection counts are small (nodes, not groups), so
thread-per-connection is simpler and plenty.

Wire format per frame: ``[u32 len][u8 kind][payload:len-1]``; kind 0 = JSON
(control plane), kind 1 = raw bytes (bulk data, e.g. checkpoint blobs).
"""

from __future__ import annotations

import collections
import json
import socket
import ssl as _ssl
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from ..obs.metrics import registry as _obs_registry
from ..overload import CLS_CLIENT, CLS_CONTROL, CLS_NAMES
from .security import TransportSecurity

KIND_JSON = 0
KIND_BYTES = 1

_HDR = struct.Struct(">IB")  # frame length (kind+payload), kind

#: Maximum frame payload (sanity bound, mirrors MAX_PAYLOAD_SIZE fragmentation
#: pressure in the reference — large states use CHECKPOINT chunking above).
MAX_FRAME = 64 * 1024 * 1024


class SendFailure(Exception):
    pass


def _send_frame(sock: socket.socket, kind: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload) + 1, kind) + payload)


#: Linux caps one sendmsg at IOV_MAX (1024) iovecs; each frame contributes
#: two (header, payload).
_IOV_MAX = 1024


def _send_frames(sock: socket.socket, batch) -> int:
    """Write every ``(gen, kind, payload)`` frame in ``batch`` with as few
    syscalls as the iovec limit allows (writev via ``sendmsg``); returns the
    syscall count.  Partial sends resume mid-buffer; TLS sockets have no
    usable ``sendmsg`` so they fall back to one coalesced ``sendall``."""
    bufs = []
    for _gen, kind, payload in batch:
        bufs.append(_HDR.pack(len(payload) + 1, kind))
        bufs.append(payload)
    if isinstance(sock, _ssl.SSLSocket):
        sock.sendall(b"".join(bufs))
        return 1
    # empty payloads contribute nothing and would stall the resume loop
    views = [memoryview(b) for b in bufs if len(b)]
    syscalls = 0
    i = 0
    while i < len(views):
        sent = sock.sendmsg(views[i: i + _IOV_MAX])
        syscalls += 1
        while sent > 0:
            ln = len(views[i])
            if sent >= ln:
                sent -= ln
                i += 1
            else:
                views[i] = views[i][sent:]
                sent = 0
    return syscalls


#: Receive-buffer chunk: one recv() this size slices dozens-to-thousands of
#: control-plane frames (typical frame: tens of bytes) out of kernel space
#: in a single syscall.
_RECV_CHUNK = 256 * 1024


class FrameReader:
    """Buffered frame extractor for one connection (MessageExtractor analog,
    ``nio/MessageExtractor.java``): each ``recv()`` pulls up to
    ``_RECV_CHUNK`` bytes and ``next_frame`` slices complete frames out of
    the buffer without touching the socket again until it runs dry.

    The previous implementation issued TWO blocking ``recv`` calls per frame
    (exact header, exact payload).  At Mode B's capacity knee the inbound
    control plane is thousands of tiny frames per tick and the syscall pair
    per frame dominated the reader thread; batching turns that into
    O(frames-per-chunk) frames per syscall (see
    ``benchmarks/bench_transport.py``).

    ``syscalls``/``frames`` counters are maintained for observability and
    the micro-bench; the owner aggregates them into Transport.stats when the
    connection closes."""

    __slots__ = ("sock", "buf", "pos", "syscalls", "frames", "peer")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = bytearray()
        self.pos = 0  # parse cursor: buf[:pos] is consumed
        self.syscalls = 0
        self.frames = 0
        self.peer = "?"  # set by the accept loop once the hello names it

    def _fill(self, need: int) -> bool:
        """Ensure ``need`` unconsumed bytes are buffered; False on EOF."""
        while len(self.buf) - self.pos < need:
            if self.pos:
                # compact the consumed prefix before growing — the buffer
                # stays bounded by one chunk + one partial frame
                del self.buf[: self.pos]
                self.pos = 0
            try:
                chunk = self.sock.recv(max(_RECV_CHUNK, need - len(self.buf)))
            except OSError:
                return False
            self.syscalls += 1
            if not chunk:
                return False
            self.buf.extend(chunk)
        return True

    def next_frame(self) -> Optional[Tuple[int, bytes]]:
        if not self._fill(_HDR.size):
            return None
        ln, kind = _HDR.unpack_from(self.buf, self.pos)
        if ln < 1 or ln - 1 > MAX_FRAME:
            # corrupt length: the drop below is otherwise silent, so make
            # a flaky NIC / hostile peer countable before severing the link
            _obs_registry().counter(
                "transport_corrupt_frames_total", peer=self.peer).inc()
            return None  # corrupt length: drop the connection
        if not self._fill(_HDR.size + ln - 1):
            return None
        start = self.pos + _HDR.size
        self.pos = start + ln - 1
        self.frames += 1
        return kind, bytes(self.buf[start: self.pos])


class _Peer:
    """Outbound link to one node: classed queues + writer thread + reconnect.

    Two bounded send queues per link — control (failure detection,
    reconfiguration, accepts/commits) and client (proposes/reads and their
    responses) — with separate budgets, and the writer always drains
    control first.  Overload therefore sheds client-class frames while
    liveness traffic keeps a full, un-stealable budget (a flood
    of client work must never look like a dead node to the FD plane)."""

    def __init__(self, transport: "Transport", dest: str):
        self.t = transport
        self.dest = dest
        #: per-class bounded deques, indexed by CLS_CONTROL / CLS_CLIENT /
        #: CLS_READ; drain priority is index order (control first, then
        #: writes, then reads)
        self.dq = (collections.deque(), collections.deque(),
                   collections.deque())
        self.caps = transport.class_caps
        self.sock: Optional[socket.socket] = None
        #: bumped by Transport.reset_peer; frames are stamped with the
        #: generation at enqueue, and the writer drops any frame — including
        #: one it is holding mid-reconnect-retry — whose stamp is stale.
        #: glock serializes stamp+enqueue against bump+drain so a send
        #: concurrent with a reset is either wholly before it (drained) or
        #: wholly after (stamped fresh, survives)
        self.gen = 0
        self.glock = threading.Lock()
        #: writer parks here when both queues are empty; producers notify
        self.cv = threading.Condition(self.glock)
        #: interrupts the writer's reconnect-backoff sleep: set by close()
        #: and Transport.reset_peer so shutdown / peer reset aren't delayed
        #: up to 2 s by a dead link waiting out its backoff
        self.wake = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name=f"tx-{transport.node_id}->{dest}", daemon=True
        )
        self.thread.start()

    def _connect(self) -> Optional[socket.socket]:
        addr = self.t.resolve(self.dest)
        if addr is None:
            return None
        try:
            s = socket.create_connection(addr, timeout=self.t.connect_timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.t.client_ssl_ctx is not None:
                # TLS handshake before any frame (SERVER_AUTH verifies the
                # peer; MUTUAL_AUTH also presents our certificate)
                s = self.t.client_ssl_ctx.wrap_socket(s)
            hello = json.dumps({"node": self.t.node_id}).encode()
            _send_frame(s, KIND_JSON, hello)
            s.settimeout(None)
            return s
        except (OSError, _ssl.SSLError):
            self.t._count("tls_connect_failures"
                          if self.t.client_ssl_ctx is not None else
                          "connect_failures")
            return None

    def _take_batch(self) -> Optional[list]:
        """Pop one writev batch under the queue lock: highest-priority
        non-empty class (control before client), coalesced up to the
        window and — critically — generation homogeneity: a frame stamped
        with a different generation stays queued and starts the next
        batch, so a single ``sendmsg`` can never interleave frames across
        a ``reset_peer``.  Returns None only when the transport closes."""
        with self.cv:
            while True:
                for dq in self.dq:
                    if not dq:
                        continue
                    first = dq.popleft()
                    batch = [first]
                    nbytes = len(first[2])
                    while (dq and len(batch) < self.t.coalesce_frames
                           and nbytes < self.t.coalesce_bytes
                           and dq[0][0] == first[0]):
                        nxt = dq.popleft()
                        batch.append(nxt)
                        nbytes += len(nxt[2])
                    return batch
                if self.t.closed:
                    return None
                self.cv.wait(timeout=0.25)

    def _run(self) -> None:
        backoff = 0.05
        while not self.t.closed:
            batch = self._take_batch()
            if batch is None:
                continue
            gen = batch[0][0]
            # retry the same batch across reconnects until sent or give up
            attempts = 0
            while not self.t.closed:
                if self.gen != gen:
                    # peer was reset while this batch was in hand: frames
                    # queued before the reset must never reach a peer that
                    # reconnected after it
                    self.t._count("reset_drops", len(batch))
                    break
                if self.sock is None:
                    self.sock = self._connect()
                    if self.sock is None:
                        attempts += 1
                        if attempts > self.t.max_connect_attempts:
                            self.t._count("dropped", len(batch))
                            break
                        # interruptible: close()/reset_peer set wake so a
                        # dead link's backoff never stalls shutdown/reset
                        self.t._count("reconnect_backoffs")
                        self.wake.wait(min(backoff * (2 ** attempts), 2.0))
                        self.wake.clear()
                        continue
                    backoff = 0.05
                if self.gen != gen:
                    # reset landed while _connect was blocking: the new
                    # socket may already be the peer's NEXT incarnation,
                    # which must not see these pre-reset frames
                    self.t._count("reset_drops", len(batch))
                    break
                try:
                    n_sys = _send_frames(self.sock, batch)
                    self.t._count("sent", len(batch))
                    self.t._count("send_syscalls", n_sys)
                    self.t._count_peer("tx_bytes", self.dest,
                                      sum(len(b[2]) for b in batch))
                    self.t._batch_h.observe(len(batch))
                    break
                except (OSError, struct.error):
                    try:
                        self.sock.close()
                    except OSError:
                        pass
                    self.sock = None  # reconnect and retry this batch

    def close(self) -> None:
        self.wake.set()  # pop the writer out of any reconnect backoff
        with self.cv:
            self.cv.notify_all()  # and out of the empty-queue park
        s = self.sock  # snapshot: the writer nulls this field concurrently
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


class Transport:
    """One node's endpoint: listener + peers table.

    ``demux(sender_id, kind, payload)`` is called on reader threads for every
    inbound frame (like the reference's AbstractPacketDemultiplexer handing
    packets to handlers, ``nio/AbstractPacketDemultiplexer.java:48``).

    ``resolve(node_id) -> (host, port)`` maps node ids to addresses — pass
    the NodeConfig-backed lookup; late binding means nodes may join after
    this endpoint starts (elastic node add, SURVEY §5).
    """

    def __init__(
        self,
        node_id: str,
        bind: Tuple[str, int],
        demux: Callable[[str, int, bytes], None],
        resolve: Callable[[str], Optional[Tuple[str, int]]],
        send_queue_cap: int = 4096,
        connect_timeout_s: float = 2.0,
        max_connect_attempts: int = 5,
        security: Optional[TransportSecurity] = None,
        coalesce_frames: int = _IOV_MAX // 2,
        coalesce_bytes: int = 8 * 1024 * 1024,
        reuse_port: bool = False,
        client_queue_frac: float = 0.75,
        read_queue_frac: float = 0.5,
    ):
        self.node_id = node_id
        self.demux = demux
        self.resolve = resolve
        self.send_queue_cap = send_queue_cap
        #: per-class send budgets: control keeps the full
        #: cap; client-class (write) and read-class frames each get a
        #: smaller, separate budget so a flood of either sheds only its
        #: own class — reads can never crowd out writes, and neither can
        #: crowd out liveness traffic (overload must not read as node
        #: death to the FD plane)
        self.class_caps = (
            send_queue_cap,
            max(1, int(send_queue_cap * client_queue_frac)),
            max(1, int(send_queue_cap * read_queue_frac)),
        )
        self.connect_timeout_s = connect_timeout_s
        self.max_connect_attempts = max_connect_attempts
        #: bounded coalescing window per writev batch: at most this many
        #: frames (each is 2 iovecs) and roughly this many payload bytes
        #: leave in one drain, so one flooded peer cannot pin the writer in
        #: a single giant send while a reset is pending
        self.coalesce_frames = max(1, coalesce_frames)
        self.coalesce_bytes = max(1, coalesce_bytes)
        self.security = security
        self.server_ssl_ctx = (
            security.server_context() if security is not None else None
        )
        self.client_ssl_ctx = (
            security.client_context() if security is not None else None
        )
        self.closed = False
        self._peers: Dict[str, _Peer] = {}
        self._plock = threading.Lock()
        self.stats: Dict[str, int] = {}
        self._slock = threading.Lock()
        # every _count key mirrors into the metrics registry as
        # transport_<key>_total{node=}; the dict stays (tests + the
        # StatsReporter transport source read it), the registry is what the
        # scrape endpoint exports.  Frames-per-syscall derives from
        # sent/send_syscalls (and recv_frames/recv_syscalls) server-side.
        self._obs_counters: Dict[str, object] = {}
        self._batch_h = _obs_registry().histogram(
            "transport_writev_batch_frames",
            help="frames coalesced into one writev batch",
            unit="", node=node_id)

        # reuse_port=True: every serving cell of a host binds the same edge
        # port and the kernel load-balances accepts across them (cells/)
        self._server = socket.create_server(bind, reuse_port=reuse_port)
        self._server.settimeout(0.25)
        self.port = self._server.getsockname()[1]
        self._acceptor = threading.Thread(
            target=self._accept_loop, name=f"accept-{node_id}", daemon=True
        )
        self._acceptor.start()

    # ------------------------------------------------------------------ sends
    def send(self, dest: str, obj: Any, cls: int = CLS_CONTROL) -> None:
        """Send a JSON-serializable control packet to node ``dest``."""
        self.send_raw(dest, KIND_JSON, json.dumps(obj).encode(), cls=cls)

    def send_bytes(self, dest: str, payload: bytes,
                   cls: int = CLS_CONTROL) -> None:
        self.send_raw(dest, KIND_BYTES, payload, cls=cls)

    def send_bytes_many(self, dest: str, payloads,
                        cls: int = CLS_CONTROL) -> None:
        self.send_raw_many(dest, KIND_BYTES, payloads, cls=cls)

    def send_raw(self, dest: str, kind: int, payload: bytes,
                 cls: int = CLS_CONTROL) -> None:
        self.send_raw_many(dest, kind, (payload,), cls=cls)

    def send_raw_many(self, dest: str, kind: int, payloads,
                      cls: int = CLS_CONTROL) -> None:
        """Enqueue a tick's worth of frames for ``dest`` under ONE generation
        stamp, so the writer's coalescing drain can put them all in a single
        ``writev`` (frame-at-a-time callers go through here too — a
        one-element list).  ``cls`` picks the traffic class: CLS_CONTROL
        (default — protocol/liveness traffic) or CLS_CLIENT (proposes,
        reads, and their responses), each with its own bounded budget."""
        if self.closed:
            raise SendFailure("transport closed")
        for payload in payloads:
            if len(payload) > MAX_FRAME:
                # fail loudly at the sender — the receiver would drop the
                # whole connection; big state goes through checkpoint
                # chunking
                raise SendFailure(
                    f"frame of {len(payload)}B exceeds MAX_FRAME={MAX_FRAME}"
                )
        if dest == self.node_id:
            # loopback short-circuit: no socket, no serialization round-trip
            # beyond the bytes already built (keeps ordering with real sends
            # unnecessary — the reference short-circuits identically)
            for payload in payloads:
                self._count("loopback")
                self._count_peer("tx_bytes", self.node_id, len(payload))
                try:
                    self.demux(self.node_id, kind, payload)
                except Exception:
                    # same contract as the socket read path: handler bugs are
                    # counted, not propagated into the sender
                    self._count("demux_errors")
            return
        with self._plock:
            peer = self._peers.get(dest)
            if peer is None:
                peer = self._peers[dest] = _Peer(self, dest)
        with peer.cv:  # cv shares glock: stamp+enqueue atomic vs reset
            gen = peer.gen
            dq, cap = peer.dq[cls], peer.caps[cls]
            dropped = 0
            for payload in payloads:
                if len(dq) >= cap:
                    # backpressure: drop-newest within THIS class only —
                    # an explicit, attributable shed (per-peer per-class
                    # counter), and callers with liveness needs retry via
                    # protocol tasks (congestion handling,
                    # PaxosManager.java:920-935)
                    dropped += 1
                else:
                    dq.append((gen, kind, payload))
            peer.cv.notify()
        if dropped:
            self._count("backpressure_drop", dropped)
            self._count_drop(dest, cls, dropped)

    # ---------------------------------------------------------------- receive
    def _accept_loop(self) -> None:
        while not self.closed:
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True
            ).start()

    def _read_loop(self, conn: socket.socket) -> None:
        sender = "?"
        reader = None
        try:
            if self.server_ssl_ctx is not None:
                # handshake on the reader thread so a slow (or malicious)
                # client cannot stall the acceptor
                try:
                    conn.settimeout(self.connect_timeout_s * 2)
                    conn = self.server_ssl_ctx.wrap_socket(conn, server_side=True)
                    conn.settimeout(None)
                except (_ssl.SSLError, OSError):
                    # unauthenticated peer (e.g. no client cert under
                    # MUTUAL_AUTH): reject the connection
                    self._count("tls_rejects")
                    return
            reader = FrameReader(conn)
            first = reader.next_frame()
            if first is None:
                return
            kind, payload = first
            try:
                sender = json.loads(payload.decode()).get("node", "?")
            except (ValueError, AttributeError):
                return  # bad hello; drop connection
            reader.peer = sender
            while not self.closed:
                frame = reader.next_frame()
                if frame is None:
                    return
                kind, payload = frame
                self._count("rcvd")
                self._count_peer("rx_bytes", sender, len(payload))
                try:
                    self.demux(sender, kind, payload)
                except Exception:
                    # handler bugs must not kill the reader (the reference
                    # logs and continues, AbstractPacketDemultiplexer)
                    self._count("demux_errors")
        finally:
            if reader is not None:
                self._count("recv_syscalls", reader.syscalls)
                self._count("recv_frames", reader.frames)
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------------ admin
    def _count(self, key: str, n: int = 1) -> None:
        with self._slock:
            self.stats[key] = self.stats.get(key, 0) + n
            c = self._obs_counters.get(key)
            if c is None:
                c = self._obs_counters[key] = _obs_registry().counter(
                    f"transport_{key}_total", node=self.node_id)
        c.inc(n)

    def _count_peer(self, key: str, peer: str, n: int = 1) -> None:
        """Per-peer-link accounting: stats["<key>:<peer>"] plus a
        peer-labelled counter family.  This is the instrument the
        dissemination split is gated on — "each payload's bytes cross each
        peer link once" is checked against these, not inferred."""
        with self._slock:
            k = f"{key}:{peer}"
            self.stats[k] = self.stats.get(k, 0) + n
            c = self._obs_counters.get(k)
            if c is None:
                c = self._obs_counters[k] = _obs_registry().counter(
                    f"transport_peer_{key}_total",
                    node=self.node_id, peer=peer)
        c.inc(n)

    def _count_drop(self, peer: str, cls: int, n: int = 1) -> None:
        """Attributable backpressure: every queue-full
        shed lands in stats["backpressure_drop:<peer>:<class>"] and the
        ``transport_backpressure_drop_class_total{node,peer,cls}`` family,
        so "who got shed, toward whom" is a scrape away instead of one
        opaque global number."""
        cname = CLS_NAMES.get(cls, str(cls))
        with self._slock:
            k = f"backpressure_drop:{peer}:{cname}"
            self.stats[k] = self.stats.get(k, 0) + n
            c = self._obs_counters.get(k)
            if c is None:
                c = self._obs_counters[k] = _obs_registry().counter(
                    "transport_backpressure_drop_class_total",
                    help="send-queue sheds by peer and traffic class",
                    node=self.node_id, peer=peer, cls=cname)
        c.inc(n)

    def reset_peer(self, dest: str) -> None:
        """Discard everything queued — or held by the writer mid-retry — for
        ``dest`` and drop its connection.  The analog of the reference
        clearing a failed node's pending writes after connect retries are
        exhausted (``nio/NIOTransport.java:65-114`` pendingWrites/
        pendingConnects): once a peer is declared gone, its backlog must not
        be delivered to a later incarnation like a mailbox.  New sends after
        this call flow normally."""
        with self._plock:
            peer = self._peers.get(dest)
        if peer is None:
            return
        with peer.glock:
            # bump + drain atomically vs send_raw's stamp+enqueue: nothing
            # fresh can interleave, so everything drained here is stale
            peer.gen += 1  # also strands the writer's in-hand frame
            stale = sum(len(dq) for dq in peer.dq)
            for dq in peer.dq:
                dq.clear()
        if stale:
            self._count("reset_drops", stale)
        # close the socket only (never null peer.sock from this thread — the
        # writer owns that field): a concurrent sendall gets OSError, which
        # the writer's retry path already handles
        peer.close()

    def close(self) -> None:
        self.closed = True
        try:
            self._server.close()
        except OSError:
            pass
        with self._plock:
            for p in self._peers.values():
                p.close()
        self._acceptor.join(timeout=2)


class JsonDemux:
    """Packet-type demultiplexer: routes JSON packets by their ``type`` field
    to registered handlers (``AbstractPacketDemultiplexer.java:48`` analog).

    Use as the ``demux`` callable of a Transport.  Handlers receive
    ``(sender_id, packet_dict)``.  Raw-bytes frames go to ``bytes_handler``.
    """

    def __init__(self):
        self._handlers: Dict[Any, Callable[[str, dict], None]] = {}
        self._taps: list = []  # called (sender, kind) for EVERY frame
        self.bytes_handler: Optional[Callable[[str, bytes], None]] = None
        self.default_handler: Optional[Callable[[str, dict], None]] = None

    def register(self, ptype, handler: Callable[[str, dict], None]) -> None:
        self._handlers[ptype] = handler

    def add_tap(self, fn: Callable[[str, int], None]) -> None:
        """Observe every inbound frame regardless of type — e.g. failure
        detection treating any traffic as implicit keep-alive
        (``heardFrom``, FailureDetection.java:248)."""
        self._taps.append(fn)

    def remove_tap(self, fn: Callable[[str, int], None]) -> None:
        try:
            self._taps.remove(fn)
        except ValueError:
            pass

    def __call__(self, sender: str, kind: int, payload: bytes) -> None:
        for tap in self._taps:
            tap(sender, kind)
        if kind == KIND_BYTES:
            if self.bytes_handler is not None:
                self.bytes_handler(sender, payload)
            return
        packet = json.loads(payload.decode())
        h = self._handlers.get(packet.get("type"))
        if h is not None:
            h(sender, packet)
        elif self.default_handler is not None:
            self.default_handler(sender, packet)
