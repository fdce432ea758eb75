"""Binary batched-request frames: the client edge's SoA wire format.

The JSON batch path (APP_REQUEST_BATCH) already amortizes frames and
syscalls; at tens of thousands of requests/sec the per-item base64+dict
encode/decode becomes the cap.  These frames are the binary payload path of
the reference's batched ``RequestPacket`` (paxospackets/RequestPacket.java:
189-233, which likewise ships a packed ``batched[]`` body): columnar arrays
(name-table indices, rids, payload offsets) that both ends encode/decode
with numpy, leaving only O(unique names) string work per frame.

Frame kinds ride the transport's raw-bytes channel behind 4-byte magics,
chained with the other bytes consumers (mode-B frames, bulk transfers).

Request frame  (client -> active):
  b"GBR1" | bid u64 | deadline u64 | host u8+bytes | port u16
  | client_id u8+bytes | n_names u16 | {u16 len + bytes} * n_names
  | n u32 | name_idx u16*n | rid u64*n | plen u32*n | payload blob
  ``deadline`` is the batch's absolute wire deadline in unix milliseconds
  (0 = none) — the overload plane's dead-work cutoff (overload.py); one
  per frame because a client tick's batch shares a send instant.
Deduped request frame (ordering/dissemination split, Mode A bulk store):
  b"GBR2" | <same header through rid u64*n>
  | n_uniq u32 | ulen u32*n_uniq | pidx u32*n | unique payload blob
  A batch whose items repeat a body (generated fan-out, hot-key writes)
  ships each unique body ONCE per peer link; the receiver rebuilds the
  per-item payload list with the duplicates sharing one bytes object —
  the wire-side face of ``paxos/paystore.py``.  ``encode_request`` picks
  GBR2 automatically when the bytes saved exceed the index overhead.
Response frame (active -> client):
  b"GBS1" | bid u64 | n u32 | rid u64*n | status u8*n | rlen u32*n | blob
"""

from __future__ import annotations

import struct
import threading
from typing import List, Tuple

import numpy as np

from ..overload import CLS_CLIENT
from .transport import SendFailure

REQ_MAGIC = b"GBR1"
REQ2_MAGIC = b"GBR2"
RESP_MAGIC = b"GBS1"


class ClientEgress:
    """Per-(client, tick) coalescing of response frames.

    The manager's callback flush releases every durable completion of a tick
    in one loop; each finished bid builds one response frame.  Inside an open
    scope (the flushing thread brackets the loop) frames stage per client and
    leave as ONE ``send_bytes_many`` list — a single generation stamp, a
    single writev.  Off-scope emits (dedup resends, admission-thread rejects)
    send immediately.  Scopes are thread-local so completions delivered on
    other threads never stall behind an open scope."""

    def __init__(self, messenger):
        self.m = messenger
        self._tl = threading.local()

    def open_scope(self):
        """Begin staging on this thread; returns the close-and-flush call."""
        self._tl.buf = {}

        def close() -> None:
            buf = self._tl.__dict__.pop("buf", None)
            if not buf:
                return
            for client, frames in buf.items():
                try:
                    self.m.send_bytes_many(client, frames, cls=CLS_CLIENT)
                except SendFailure:
                    # transport closing: responses are simply undeliverable
                    pass

        return close

    def emit(self, client: str, frame: bytes) -> None:
        buf = getattr(self._tl, "buf", None)
        if buf is not None:
            buf.setdefault(client, []).append(frame)
            return
        try:
            self.m.send_bytes(client, frame, cls=CLS_CLIENT)
        except SendFailure:
            pass


def _request_head(magic: bytes, bid: int, host: str, port: int,
                  client_id: str, items,
                  deadline: int = 0) -> Tuple[list, dict, int]:
    """Shared GBR1/GBR2 header through ``rid u64*n``."""
    names: dict = {}
    for name, _rid, _p in items:
        if name not in names:
            names[name] = len(names)
    n = len(items)
    idx = np.fromiter((names[it[0]] for it in items), np.uint16, n)
    rids = np.fromiter((it[1] for it in items), np.uint64, n)
    hb = host.encode()
    cb = client_id.encode()
    head = [magic, struct.pack("<QQB", bid, deadline or 0, len(hb)), hb,
            struct.pack("<HB", port, len(cb)), cb,
            struct.pack("<H", len(names))]
    for name in names:
        nb = name.encode()
        head.append(struct.pack("<H", len(nb)))
        head.append(nb)
    head.append(struct.pack("<I", n))
    head.append(idx.tobytes())
    head.append(rids.tobytes())
    return head, names, n


def encode_request(bid: int, host: str, port: int, client_id: str,
                   items: List[Tuple[str, int, bytes]],
                   deadline: int = 0) -> bytes:
    """items: (name, rid, payload).  Emits GBR2 (unique-payload table)
    when the duplicate bytes it removes exceed the extra index overhead
    (4 bytes/unique body), else plain GBR1 — decode sniffs the magic.
    ``deadline``: absolute unix-ms batch deadline (0 = none)."""
    n = len(items)
    uniq: dict = {}  # body -> table index (content-keyed)
    dup_bytes = 0
    for _name, _rid, p in items:
        if p in uniq:
            dup_bytes += len(p)
        else:
            uniq[p] = len(uniq)
    if dup_bytes > 4 * len(uniq):
        head, _names, _n = _request_head(
            REQ2_MAGIC, bid, host, port, client_id, items, deadline)
        ulens = np.fromiter((len(p) for p in uniq), np.uint32, len(uniq))
        pidx = np.fromiter((uniq[it[2]] for it in items), np.uint32, n)
        head.append(struct.pack("<I", len(uniq)))
        head.append(ulens.tobytes())
        head.append(pidx.tobytes())
        return b"".join(head) + b"".join(uniq)
    head, _names, _n = _request_head(
        REQ_MAGIC, bid, host, port, client_id, items, deadline)
    plens = np.fromiter((len(it[2]) for it in items), np.uint32, n)
    head.append(plens.tobytes())
    return b"".join(head) + b"".join(it[2] for it in items)


def decode_request(buf: bytes):
    """Returns (bid, deadline_ms, (host, port), client_id, names, name_idx,
    rids, payloads list of bytes) for either request-frame kind; GBR2
    duplicates come back as the SAME bytes object (pre-interned for the
    admit path).  ``deadline_ms`` is 0 when the sender set none."""
    magic = buf[:4]
    assert magic in (REQ_MAGIC, REQ2_MAGIC)
    o = 4
    bid, deadline, hlen = struct.unpack_from("<QQB", buf, o)
    o += 17
    host = buf[o:o + hlen].decode()
    o += hlen
    port, clen = struct.unpack_from("<HB", buf, o)
    o += 3
    client_id = buf[o:o + clen].decode()
    o += clen
    (n_names,) = struct.unpack_from("<H", buf, o)
    o += 2
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack_from("<H", buf, o)
        o += 2
        names.append(buf[o:o + ln].decode())
        o += ln
    (n,) = struct.unpack_from("<I", buf, o)
    o += 4
    idx = np.frombuffer(buf, np.uint16, n, o)
    o += 2 * n
    rids = np.frombuffer(buf, np.uint64, n, o)
    o += 8 * n
    mv = memoryview(buf)
    if magic == REQ2_MAGIC:
        (n_uniq,) = struct.unpack_from("<I", buf, o)
        o += 4
        ulens = np.frombuffer(buf, np.uint32, n_uniq, o)
        o += 4 * n_uniq
        pidx = np.frombuffer(buf, np.uint32, n, o)
        o += 4 * n
        uoffs = np.zeros(n_uniq + 1, np.int64)
        np.cumsum(ulens, out=uoffs[1:])
        utab = [bytes(mv[o + uoffs[i]:o + uoffs[i + 1]])
                for i in range(n_uniq)]
        payloads = [utab[i] for i in pidx]
        return (bid, int(deadline), (host, port), client_id, names, idx,
                rids, payloads)
    plens = np.frombuffer(buf, np.uint32, n, o)
    o += 4 * n
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(plens, out=offs[1:])
    payloads = [bytes(mv[o + offs[i]:o + offs[i + 1]]) for i in range(n)]
    return (bid, int(deadline), (host, port), client_id, names, idx, rids,
            payloads)


def encode_response(bid: int, rids, statuses, bodies: List[bytes]) -> bytes:
    n = len(bodies)
    rl = np.fromiter((len(b) for b in bodies), np.uint32, n)
    return (RESP_MAGIC + struct.pack("<QI", bid, n)
            + np.asarray(rids, np.uint64).tobytes()
            + np.asarray(statuses, np.uint8).tobytes()
            + rl.tobytes() + b"".join(bodies))


def decode_response(buf: bytes):
    """Returns (bid, rids u64[n], statuses u8[n], bodies list of bytes)."""
    assert buf[:4] == RESP_MAGIC
    bid, n = struct.unpack_from("<QI", buf, 4)
    o = 16
    rids = np.frombuffer(buf, np.uint64, n, o)
    o += 8 * n
    statuses = np.frombuffer(buf, np.uint8, n, o)
    o += n
    rlens = np.frombuffer(buf, np.uint32, n, o)
    o += 4 * n
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(rlens, out=offs[1:])
    mv = memoryview(buf)
    bodies = [bytes(mv[o + offs[i]:o + offs[i + 1]]) for i in range(n)]
    return bid, rids, statuses, bodies


def chain_bytes_handler(demux, magic: bytes, handler) -> None:
    """Install ``handler(sender, payload)`` for frames starting with
    ``magic``, falling through to the previously installed consumer (the
    mode-B frame chain idiom)."""
    prev = demux.bytes_handler

    def on_bytes(sender: str, payload: bytes) -> None:
        if payload[:4] == magic:
            handler(sender, payload)
        elif prev is not None:
            prev(sender, payload)

    demux.bytes_handler = on_bytes
