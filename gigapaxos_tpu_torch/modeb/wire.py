"""Fixed-width SoA wire format for Mode-B replica traffic.

This is the ``paxospackets`` analog (SURVEY §2.1 wire-schema row;
gigapaxos/paxospackets/PaxosPacket.java:202-291) re-expressed for the dense
design: instead of 17 per-event packet classes, one **replica frame** per
tick carries every protocol message a node emits, as struct-of-arrays int32
columns over its changed group rows:

* PREPARE        -> (flags.PREPARING, coord_bnum)              per group
* PROMISE        -> (bal_num, bal_coord)                       per group
* ACCEPT         -> (flags.COORD_ACTIVE, prop_* ring)          per group
  (batched, like BatchedAccept, gigapaxos/PaxosPacketBatcher.java:28-35)
* ACCEPT_REPLY   -> (acc_* ring: the acceptor's vote ledger)   per group
* DECISION       -> (dec_* ring)                               per group
* checkpoint/gap -> (exec_slot, status)                        per group

plus an out-of-band payload table (request-id -> bytes) for requests the
sender newly proposed, so every learner holds payloads before it executes
(the reference ships full requests inside ACCEPT/DECISION,
gigapaxos/paxospackets/RequestPacket.java:189-233).

Groups are addressed by a 63-bit name hash (``gid``) so independent nodes
agree on addressing without a shared row allocator; each receiver maps gid
-> its own local row.  A reserved per-group ``digest`` column keeps the
protocol slot for digest-only accepts (PendingDigests,
gigapaxos/paxosutil/PendingDigests.java:23) without implementing them yet.

Layout (little-endian):

  header:  MAGIC 'GPXB' | u16 version | u16 W | i32 sender_r | i64 tick
           | u8 full (anti-entropy full-state frame) | i32 n | i32 n_payload
  columns: u64 gid[n]
           i32 {exec_slot,bal_num,bal_coord,status,coord_bnum,next_slot,
                flags,digest}[n]
           i32 {acc_bnum,acc_bcoord,acc_req,acc_slot,
                dec_req,dec_slot,prop_req,prop_slot}[n*W]   (group-major)
           i32 {acc_stop,dec_valid,dec_stop,prop_valid,prop_stop}[n]
                              -- one i32 per ring-bit field per group, bit j
                                 = ring plane j (W <= 31)
  payload table: i32 rid[n_payload] | u8 stop[n_payload] | u32 len[n_payload]
                 | concatenated payload bytes

Everything — including the payload table since v2 — encodes/decodes as
vectorized numpy ``tobytes``/``frombuffer`` column slabs: payload byte
ranges come from one ``cumsum`` over the length column, never a per-request
``struct`` loop (v1 interleaved ``(rid,stop,len,bytes)`` records decode for
journal replay of frames written before the column switch).

Many frames bound for the same peer in one tick pack into a single
contiguous buffer via ``encode_frames``/``decode_frames`` (the
PaxosPacketBatcher analog, gigapaxos/PaxosPacketBatcher.java:28-35): one
batch magic + a length column + the concatenated frames, so the whole
per-(peer, tick) fan-out is one transport frame and one writev on the wire.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

MAGIC = b"GPXB"
#: Frame-batch container magic (chain passes its own so the bytes-handler
#: prefix dispatch stays unambiguous across coexisting protocols).
BATCH_MAGIC = b"GPXS"
VERSION = 2  # v2: columnar payload table; v1 (interleaved) still decodes

FLAG_COORD_ACTIVE = 1
FLAG_COORD_PREPARING = 2
#: the reign was won by consecutive-ballot fast election (no prepare round);
#: acceptors use it for the conflict-refusal rule.  Rides the existing
#: flags i32, so the wire layout is unchanged.
FLAG_COORD_FAST = 4

#: [R, G] scalar columns shipped per group (+ flags packed separately)
SCALARS = ("exec_slot", "bal_num", "bal_coord", "status", "coord_bnum",
           "next_slot")
#: [R, W, G] int32 ring columns
RINGS = ("acc_bnum", "acc_bcoord", "acc_req", "acc_slot",
         "dec_req", "dec_slot", "prop_req", "prop_slot")
#: [R, W, G] bool ring columns, packed W bits -> one i32 per group
RING_BITS = ("acc_stop", "dec_valid", "dec_stop", "prop_valid", "prop_stop")

_HDR = struct.Struct("<4sHHiqBii")
_PAY = struct.Struct("<iBI")  # v1 interleaved payload record (decode only)
_BHDR = struct.Struct("<4sI")  # batch container: magic, frame count


def gid_of(name: str) -> int:
    """Stable 63-bit group id from the service name (the IntegerMap analog
    for cross-node addressing, gigapaxos/paxosutil/IntegerMap.java:40 —
    except interning must agree across nodes, hence a hash, not a counter)."""
    h = hashlib.blake2b(name.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & 0x7FFFFFFFFFFFFFFF


class Frame(NamedTuple):
    sender_r: int
    tick: int
    W: int
    full: bool
    gids: np.ndarray              # u64 [n]
    scalars: Dict[str, np.ndarray]  # name -> i32 [n]
    flags: np.ndarray             # i32 [n]
    digest: np.ndarray            # i32 [n] (reserved protocol slot)
    rings: Dict[str, np.ndarray]  # name -> i32 [n, W]
    ring_bits: Dict[str, np.ndarray]  # name -> bool [n, W]
    payloads: List[Tuple[int, bool, bytes]]  # (rid, stop, payload)


def pack_bits(b: np.ndarray) -> np.ndarray:
    """bool [n, W] -> i32 [n] (bit j = plane j); W <= 31."""
    n, W = b.shape
    assert W <= 31, "ring window too deep for bit-packed wire columns"
    weights = (1 << np.arange(W, dtype=np.int64))[None, :]
    return (b.astype(np.int64) * weights).sum(axis=1).astype(np.int32)


def unpack_bits(v: np.ndarray, W: int) -> np.ndarray:
    """i32 [n] -> bool [n, W]."""
    return (v[:, None] >> np.arange(W, dtype=np.int32)[None, :]) & 1 > 0


def encode_frame(
    sender_r: int,
    tick: int,
    W: int,
    gids: np.ndarray,
    scalars: Dict[str, np.ndarray],
    flags: np.ndarray,
    rings: Dict[str, np.ndarray],
    ring_bits: Dict[str, np.ndarray],
    payloads: List[Tuple[int, bool, bytes]],
    full: bool = False,
    digest: np.ndarray = None,
    scalar_fields: Tuple[str, ...] = SCALARS,
    ring_fields: Tuple[str, ...] = RINGS,
    bit_fields: Tuple[str, ...] = RING_BITS,
    magic: bytes = MAGIC,
) -> bytes:
    """The field lists parameterize the schema so other per-group protocols
    (chain replication, ``chain/modeb.py``) reuse the same SoA codec with
    their own columns under a distinct magic."""
    n = len(gids)
    parts = [
        _HDR.pack(magic, VERSION, W, sender_r, tick, int(full), n,
                  len(payloads)),
        np.ascontiguousarray(gids, dtype=np.uint64).tobytes(),
    ]
    for f in scalar_fields:
        parts.append(np.ascontiguousarray(scalars[f], np.int32).tobytes())
    parts.append(np.ascontiguousarray(flags, np.int32).tobytes())
    if digest is None:
        digest = np.zeros(n, np.int32)
    parts.append(np.ascontiguousarray(digest, np.int32).tobytes())
    for f in ring_fields:
        parts.append(np.ascontiguousarray(rings[f], np.int32).tobytes())
    for f in bit_fields:
        parts.append(pack_bits(ring_bits[f]).tobytes())
    n_pay = len(payloads)
    if n_pay:
        parts.append(np.fromiter(
            (p[0] for p in payloads), np.int32, n_pay).tobytes())
        parts.append(np.fromiter(
            (p[1] for p in payloads), np.uint8, n_pay).tobytes())
        parts.append(np.fromiter(
            (len(p[2]) for p in payloads), np.uint32, n_pay).tobytes())
        parts.extend(p[2] for p in payloads)
    return b"".join(parts)


def decode_frame(
    buf: bytes,
    scalar_fields: Tuple[str, ...] = SCALARS,
    ring_fields: Tuple[str, ...] = RINGS,
    bit_fields: Tuple[str, ...] = RING_BITS,
    magic: bytes = MAGIC,
) -> Frame:
    hmagic, ver, W, sender_r, tick, full, n, n_pay = _HDR.unpack_from(buf, 0)
    if hmagic != magic or ver not in (1, VERSION):
        raise ValueError("bad replica frame header")
    off = _HDR.size

    def col(dtype, count):
        nonlocal off
        nbytes = np.dtype(dtype).itemsize * count
        a = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
        off += nbytes
        return a

    gids = col(np.uint64, n)
    scalars = {f: col(np.int32, n) for f in scalar_fields}
    flags = col(np.int32, n)
    digest = col(np.int32, n)
    rings = {f: col(np.int32, n * W).reshape(n, W) for f in ring_fields}
    ring_bits = {f: unpack_bits(col(np.int32, n), W) for f in bit_fields}
    payloads: List[Tuple[int, bool, bytes]] = []
    if ver == 1:
        # journal-replay compatibility: interleaved per-request records
        for _ in range(n_pay):
            rid, stop, ln = _PAY.unpack_from(buf, off)
            off += _PAY.size
            payloads.append((rid, bool(stop), buf[off: off + ln]))
            off += ln
    elif n_pay:
        rids = col(np.int32, n_pay).tolist()
        stops = (col(np.uint8, n_pay) != 0).tolist()
        ends = np.cumsum(col(np.uint32, n_pay).astype(np.int64)) + off
        starts = np.empty(n_pay, np.int64)
        starts[0] = off
        starts[1:] = ends[:-1]
        mv = memoryview(buf)
        payloads = [
            (rid, stop, bytes(mv[s:e]))
            for rid, stop, s, e in zip(rids, stops, starts.tolist(),
                                       ends.tolist())
        ]
    return Frame(sender_r, tick, W, bool(full), gids, scalars, flags, digest,
                 rings, ring_bits, payloads)


# ------------------------------------------------------------- frame batches
def encode_frames(frames: List[bytes], magic: bytes = BATCH_MAGIC) -> bytes:
    """Pack already-encoded frames into one contiguous buffer: all frames a
    node emits toward one peer in a tick travel as a single transport frame
    (and a single writev on the wire)."""
    k = len(frames)
    lens = np.fromiter((len(f) for f in frames), np.uint32, k)
    return b"".join([_BHDR.pack(magic, k), lens.tobytes(), *frames])


def decode_frames(buf: bytes, magic: bytes = BATCH_MAGIC) -> List[bytes]:
    """Split a batch container back into its frames (bytes copies, so each
    sub-frame can be journaled raw exactly like a singly-sent frame)."""
    hmagic, k = _BHDR.unpack_from(buf, 0)
    if hmagic != magic:
        raise ValueError("bad frame-batch header")
    off = _BHDR.size
    lens = np.frombuffer(buf, np.uint32, k, off).astype(np.int64)
    off += 4 * k
    ends = np.cumsum(lens) + off
    starts = ends - lens
    if k and int(ends[-1]) != len(buf):
        raise ValueError("frame-batch length mismatch")
    mv = memoryview(buf)
    return [bytes(mv[s:e]) for s, e in zip(starts.tolist(), ends.tolist())]


# ---------------------------------------------------------- ring relay slabs
#: Payload-dissemination relay frame (HT-Ring Paxos, arxiv 1507.04086).
#: Ordering frames above carry only rids under digest mode; the payload
#: bytes ride these slabs around the member ring instead — one upstream
#: recv, one downstream send per node per tick.  Distinct magic keeps the
#: bytes-handler prefix dispatch unambiguous next to MAGIC/BATCH_MAGIC.
RELAY_MAGIC = b"GPXR"
RELAY_VERSION = 1
#: magic | u16 version | i32 sender_r | i64 tick | f64 sent_s (hop-latency
#: timestamp, observability only — never journaled) | u32 n
_RHDR = struct.Struct("<4sHiqdI")


class RelaySlab(NamedTuple):
    """A decoded relay frame, kept columnar: ``rid``/``stop``/``len``
    column slabs plus ONE blob of concatenated payload bytes.  Forwarding
    never decodes payload bodies — it masks the columns and re-slices the
    blob (``slab_keep``), so a hop costs O(columns), not O(bytes parsed).
    The payload's origin replica needs no column of its own: it lives in
    the rid's high bits (``rid >> RID_SHIFT``, modeb/common.py)."""

    sender_r: int
    tick: int
    sent_s: float
    rids: np.ndarray   # i32 [n]
    stops: np.ndarray  # bool [n]
    lens: np.ndarray   # i64 [n]
    offs: np.ndarray   # i64 [n+1] byte offsets into blob
    blob: memoryview   # concatenated payload bytes

    def items(self) -> List[Tuple[int, bool, bytes]]:
        o = self.offs.tolist()
        return [
            (rid, stop, bytes(self.blob[o[i]: o[i + 1]]))
            for i, (rid, stop) in enumerate(
                zip(self.rids.tolist(), self.stops.tolist()))
        ]


def encode_relay(sender_r, tick, sent_s, groups) -> bytes:
    """Encode one relay frame from column groups.

    ``groups``: iterable of ``(rids, stops, lens, blob_parts)`` — one group
    for the node's own newly-entered payloads, one per upstream slab being
    forwarded (already masked by :func:`slab_keep`).  Columns concatenate;
    blob parts are appended as-is, so forwarded bytes are never re-parsed.
    """
    rid_cols, stop_cols, len_cols, blobs = [], [], [], []
    for rids, stops, lens, parts in groups:
        rid_cols.append(np.ascontiguousarray(rids, np.int32))
        stop_cols.append(np.ascontiguousarray(stops, np.uint8))
        len_cols.append(np.ascontiguousarray(lens, np.uint32))
        blobs.extend(parts)
    rids = (np.concatenate(rid_cols) if rid_cols
            else np.empty(0, np.int32))
    n = len(rids)
    parts = [
        _RHDR.pack(RELAY_MAGIC, RELAY_VERSION, sender_r, tick, sent_s, n),
        rids.tobytes(),
        (np.concatenate(stop_cols) if stop_cols
         else np.empty(0, np.uint8)).tobytes(),
        (np.concatenate(len_cols) if len_cols
         else np.empty(0, np.uint32)).tobytes(),
    ]
    parts.extend(blobs)
    return b"".join(parts)


def relay_group(items) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """(rid, stop, payload) triples -> one encode_relay column group (the
    entry node's own staging path; forwarded slabs never take this loop)."""
    k = len(items)
    rids = np.fromiter((it[0] for it in items), np.int32, k)
    stops = np.fromiter((bool(it[1]) for it in items), np.uint8, k)
    lens = np.fromiter((len(it[2]) for it in items), np.uint32, k)
    return rids, stops, lens, [it[2] for it in items]


def decode_relay(buf: bytes) -> RelaySlab:
    hmagic, ver, sender_r, tick, sent_s, n = _RHDR.unpack_from(buf, 0)
    if hmagic != RELAY_MAGIC or ver != RELAY_VERSION:
        raise ValueError("bad relay frame header")
    off = _RHDR.size
    rids = np.frombuffer(buf, np.int32, n, off)
    off += 4 * n
    stops = np.frombuffer(buf, np.uint8, n, off) != 0
    off += n
    lens = np.frombuffer(buf, np.uint32, n, off).astype(np.int64)
    off += 4 * n
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if off + int(offs[-1]) != len(buf):
        raise ValueError("relay frame length mismatch")
    return RelaySlab(sender_r, tick, sent_s, rids, stops, lens, offs,
                     memoryview(buf)[off:])


def slab_keep(slab: RelaySlab, keep: np.ndarray):
    """Mask a slab for forwarding: kept columns + blob slices re-offset to
    the kept byte ranges.  Contiguous kept runs coalesce into single
    memoryview slices, so the common all-kept hop forwards the whole blob
    as one zero-copy part.  Returns an encode_relay column group."""
    idx = np.flatnonzero(keep)
    parts = []
    if idx.size:
        brk = np.flatnonzero(np.diff(idx) > 1)
        run_lo = np.concatenate(([0], brk + 1))
        run_hi = np.concatenate((brk, [idx.size - 1]))
        offs = slab.offs
        for a, b in zip(run_lo.tolist(), run_hi.tolist()):
            parts.append(
                slab.blob[int(offs[idx[a]]): int(offs[idx[b] + 1])])
    return slab.rids[keep], slab.stops[keep], slab.lens[keep], parts
