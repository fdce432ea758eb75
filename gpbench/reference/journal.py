"""Reads the tick records of a Mode A write-ahead journal on its own (plain
Python and NumPy): the frame format and the record codec are those written
down in the journal's format description, read here without the program.

  file   := b"GPTPUJ02" frame*
  frame  := u32 len | u32 crc32(body) | body
  body   := u8 kind (0 data, 1 barrier) | u64 seq | payload

A barrier frame precedes every fsync, so the frames before the last
barrier are the fsync-covered ones.  A tick record is the tuple
``(3, tick, placed, alive, bulk, kv_reg)`` where ``bulk`` carries the
placed request ids (int64 bytes) and ``kv_reg`` the uploaded descriptors
(rid, op, key, value as int32 bytes).

A position in the journal is the file's number times 2^40 plus a byte
offset in it, as the harness notes it at each acknowledgement."""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np

MAGIC2 = b"GPTPUJ02"
OP_TICK = 3
_HDR = struct.Struct("<II")
_BODY = struct.Struct("<BQ")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


class _Skipped:
    """A list of equal-length byte strings, skipped unread."""

    def __init__(self, n: int):
        self.n = n


def _dec(b, o: int):
    """Decode one value at offset ``o`` of ``b``; returns (value, end)."""
    tag = b[o]
    o += 1
    if tag == 0x4E:
        return None, o
    if tag == 0x54:
        return True, o
    if tag == 0x46:
        return False, o
    if tag == 0x69:
        return _I64.unpack_from(b, o)[0], o + 8
    if tag == 0x49:
        n = _U32.unpack_from(b, o)[0]
        return int.from_bytes(b[o + 4:o + 4 + n], "little", signed=True), \
            o + 4 + n
    if tag == 0x66:
        return struct.unpack_from("<d", b, o)[0], o + 8
    if tag in (0x73, 0x62):
        n = _U32.unpack_from(b, o)[0]
        v = bytes(b[o + 4:o + 4 + n])
        return (v.decode() if tag == 0x73 else v), o + 4 + n
    if tag == 0x61:
        nd = b[o]
        dt = bytes(b[o + 1:o + 1 + nd]).decode()
        o += 1 + nd
        ndim = b[o]
        o += 1
        shape = struct.unpack_from(f"<{ndim}I", b, o)
        o += 4 * ndim
        n = _U32.unpack_from(b, o)[0]
        o += 4
        a = np.frombuffer(bytes(b[o:o + n]), dtype=dt).reshape(shape)
        return a, o + n
    if tag in (0x74, 0x6C, 0x65):
        n = _U32.unpack_from(b, o)[0]
        o += 4
        if tag == 0x6C and n and b[o] == 0x62:
            end = _skip_bytes_list(b, o, n)
            if end is not None:
                return _Skipped(n), end
        items = []
        for _ in range(n):
            v, o = _dec(b, o)
            items.append(v)
        return (tuple(items) if tag == 0x74 else items), o
    if tag == 0x64:
        n = _U32.unpack_from(b, o)[0]
        o += 4
        d = {}
        for _ in range(n):
            k, o = _dec(b, o)
            v, o = _dec(b, o)
            d[k] = v
        return d, o
    raise ValueError(f"journal record: unknown tag {tag:#x}")


def _skip_bytes_list(b, o: int, n: int):
    """End offset of ``n`` byte strings of one length starting at ``o``, or
    None when they are not all of the first one's length."""
    length = _U32.unpack_from(b, o + 1)[0]
    step = 5 + length
    end = o + n * step
    if end > len(b):
        return None
    rows = np.frombuffer(b, np.uint8, n * step, o).reshape(n, step)
    if not (rows[:, 0] == 0x62).all():
        return None
    lens = rows[:, 1:5].copy().view("<u4").ravel()
    return end if (lens == length).all() else None


def _file_number(path) -> int:
    """The number in ``journal.<n>.log``."""
    return int(os.path.basename(path).split(".")[1])


def read_journal(path) -> dict:
    """One journal file: ``ticks``, a list of (tick, placed rids int64,
    (rid, op, key, value) int32 or None, position of the record's end) for
    every intact tick record; ``covered``, how many of them lie before the
    last barrier; ``barriers``, the position of each barrier's end."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    if bytes(buf[:8]) != MAGIC2:
        raise ValueError(f"{path}: not a v2 journal")
    base = _file_number(path) << 40
    pos, frames, barriers, covered = 8, [], [], 0
    while pos + 8 <= len(buf):
        length, crc = _HDR.unpack_from(buf, pos)
        body = buf[pos + 8:pos + 8 + length]
        if len(body) != length or zlib.crc32(body) != crc:
            break
        end = base + pos + 8 + length
        kind, _seq = _BODY.unpack_from(body, 0)
        if kind == 1:
            barriers.append(end)
            covered = len(frames)
        elif (length >= 9 + 14 and body[9] == 0x74
              and body[14] == 0x69
              and _I64.unpack_from(body, 15)[0] == OP_TICK):
            frames.append((body[9:], end))
        pos += 8 + length
    ticks = []
    for payload, end in frames:
        rec, _ = _dec(payload, 0)
        tick, bulk, kv_reg = rec[1], rec[4], rec[5]
        rids = (np.frombuffer(bulk[0], np.int64) if bulk is not None
                else np.zeros(0, np.int64))
        desc = (np.stack([np.frombuffer(x, np.int32) for x in kv_reg])
                if kv_reg is not None else None)
        ticks.append((tick, rids, desc, end))
    return {"ticks": ticks, "covered": covered,
            "barriers": np.array(barriers, np.int64)}


def acked_early(records, barriers, ledger, acked) -> int:
    """Acknowledged requests that no barrier covered when they were
    acknowledged: the latest record placing the request that had been
    written by then (its end at or before the journal position noted at
    the acknowledgement) has no barrier ending between it and that
    position, or no such record exists."""
    a = ledger.jpos[acked]
    top = ledger.top
    if not records:
        return int(len(acked))
    rid = np.concatenate([r for r, _ in records])
    end = np.concatenate([np.full(len(r), e, np.int64) for r, e in records])
    keep = (rid > 0) & (rid < top)
    rid, end = rid[keep], end[keep]
    keep = end <= ledger.jpos[rid]
    rid, end = rid[keep], end[keep]
    # the latest such record of each request
    order = np.lexsort((end, rid))
    rid, end = rid[order], end[order]
    last = np.ones(len(rid), bool)
    last[:-1] = rid[1:] != rid[:-1]
    rid, end = rid[last], end[last]
    latest = np.full(top, -1, np.int64)
    latest[rid] = end
    b = np.sort(barriers)
    nxt = np.searchsorted(b, latest[acked], side="right")
    cover = np.where(nxt < len(b), b[np.minimum(nxt, len(b) - 1)],
                     np.iinfo(np.int64).max)
    early = (latest[acked] < 0) | (cover > a)
    return int(early.sum())


def compare(log_dir, ledger) -> dict:
    """Numbers compared: acknowledged requests that no fsync-covered tick
    record places, those whose journaled descriptor differs from the
    request sent, and those acknowledged before a barrier covered their
    record."""
    placed, descs, records, barriers = [], [], [], []
    for path in sorted(glob.glob(os.path.join(log_dir, "journal.*.log"))):
        j = read_journal(path)
        barriers.append(j["barriers"])
        for k, (_tick, rids, desc, end) in enumerate(j["ticks"]):
            records.append((rids, end))
            if k >= j["covered"]:
                continue
            placed.append(rids)
            if desc is not None:
                descs.append(desc)
    top = ledger.top
    adm = ledger.admitted()
    acked = adm[ledger.n_ack[adm] > 0]
    seen = np.zeros(top, bool)
    if placed:
        p = np.concatenate(placed)
        p = p[(p > 0) & (p < top)]
        seen[p] = True
    good = np.zeros(top, bool)
    if descs:
        d = np.concatenate(descs, axis=1).astype(np.int64)
        d = d[:, (d[0] > 0) & (d[0] < top)]
        rid = d[0]
        match = ((ledger.op[rid] == d[1]) & (ledger.key[rid] == d[2])
                 & (ledger.val[rid] == d[3]))
        good[rid[match]] = True
    b = (np.concatenate(barriers) if barriers else np.zeros(0, np.int64))
    return {"wal_unplaced": int((~seen[acked]).sum()),
            "wal_desc_wrong": int((~good[acked]).sum()),
            "wal_acked_early": acked_early(records, b, ledger, acked)}
