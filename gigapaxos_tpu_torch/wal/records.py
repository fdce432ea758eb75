"""Typed binary record codec for everything the WALs persist.

Replaces pickle in journals, snapshots, and the disk spill tier.  Pickle's
replay path executes arbitrary constructors from disk bytes; a torn or
tampered journal could thus run code at recovery.  This codec is pure data
— a fixed tag set, length-delimited, no imports, no callables — the moral
equivalent of the reference's typed SQL tables (SQLPaxosLogger.java:
3973-4018), shaped for the records this framework writes: admin tuples,
per-tick intake (ints, bytes, nested lists), HotRestoreInfo dicts with
numpy arrays, checkpoint metadata with sets and bytes blobs.

Wire format: 1 tag byte + payload.  Integers are i64 little-endian (a 'I'
bigint escape covers the rest); containers are u32-counted; ndarrays carry
dtype-str + shape + raw bytes.  Dict keys are full values (tuples of ints
are common keys here).
"""

from __future__ import annotations

import struct

import numpy as np

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _enc(o, out: bytearray) -> None:
    if o is None:
        out.append(0x4E)  # N
    elif o is True:
        out.append(0x54)  # T
    elif o is False:
        out.append(0x46)  # F
    elif isinstance(o, (np.integer,)):
        _enc(int(o), out)
    elif isinstance(o, (np.bool_,)):
        _enc(bool(o), out)
    elif isinstance(o, int):
        if I64_MIN <= o <= I64_MAX:
            out.append(0x69)  # i
            out += _I64.pack(o)
        else:
            b = o.to_bytes((o.bit_length() + 8) // 8, "little", signed=True)
            out.append(0x49)  # I
            out += _U32.pack(len(b))
            out += b
    elif isinstance(o, (float, np.floating)):
        out.append(0x66)  # f
        out += _F64.pack(float(o))
    elif isinstance(o, str):
        b = o.encode()
        out.append(0x73)  # s
        out += _U32.pack(len(b))
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        out.append(0x62)  # b
        out += _U32.pack(len(b))
        out += b
    elif isinstance(o, np.ndarray):
        d = o.dtype.str.encode()
        out.append(0x61)  # a
        out.append(len(d))
        out += d
        out.append(o.ndim)
        for s in o.shape:
            out += _U32.pack(s)
        raw = np.ascontiguousarray(o).tobytes()
        out += _U32.pack(len(raw))
        out += raw
    elif isinstance(o, tuple):
        out.append(0x74)  # t
        out += _U32.pack(len(o))
        for x in o:
            _enc(x, out)
    elif isinstance(o, list):
        out.append(0x6C)  # l
        out += _U32.pack(len(o))
        for x in o:
            _enc(x, out)
    elif isinstance(o, (set, frozenset)):
        out.append(0x65)  # e
        out += _U32.pack(len(o))
        for x in o:
            _enc(x, out)
    elif isinstance(o, dict):
        out.append(0x64)  # d
        out += _U32.pack(len(o))
        for k, v in o.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(f"records codec: unsupported type {type(o)!r}")


def dumps(o) -> bytes:
    out = bytearray()
    _enc(o, out)
    return bytes(out)


class _Reader:
    __slots__ = ("b", "o")

    def __init__(self, b: bytes):
        self.b = b
        self.o = 0

    def take(self, n: int) -> bytes:
        v = self.b[self.o:self.o + n]
        if len(v) != n:
            raise ValueError("records codec: truncated record")
        self.o += n
        return v

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


def _dec(r: _Reader):
    tag = r.take(1)[0]
    if tag == 0x4E:
        return None
    if tag == 0x54:
        return True
    if tag == 0x46:
        return False
    if tag == 0x69:
        return _I64.unpack(r.take(8))[0]
    if tag == 0x49:
        return int.from_bytes(r.take(r.u32()), "little", signed=True)
    if tag == 0x66:
        return _F64.unpack(r.take(8))[0]
    if tag == 0x73:
        return r.take(r.u32()).decode()
    if tag == 0x62:
        return bytes(r.take(r.u32()))
    if tag == 0x61:
        dtype = np.dtype(r.take(r.take(1)[0]).decode())
        ndim = r.take(1)[0]
        shape = tuple(r.u32() for _ in range(ndim))
        raw = r.take(r.u32())
        return np.frombuffer(raw, dtype).reshape(shape).copy()
    if tag == 0x74:
        return tuple(_dec(r) for _ in range(r.u32()))
    if tag == 0x6C:
        return [_dec(r) for _ in range(r.u32())]
    if tag == 0x65:
        return {_dec(r) for _ in range(r.u32())}
    if tag == 0x64:
        return {_dec(r): _dec(r) for _ in range(r.u32())}
    raise ValueError(f"records codec: unknown tag {tag:#x}")


def loads(b: bytes):
    r = _Reader(b)
    v = _dec(r)
    if r.o != len(b):
        raise ValueError("records codec: trailing garbage")
    return v


class SchemaError(ValueError):
    """A CRC-valid record decoded to something no logger ever writes."""


def validate_op_record(rec, schema) -> int:
    """Fail-closed whitelist check for op records decoded from disk.

    CRC catches torn/flipped bytes, but a corrupt-but-CRC-valid record (or
    a record from a foreign/garbage file resynced into the stream) must
    not reach the replay dispatchers, which index into it and execute it.
    ``schema`` maps op byte -> (min_arity, max_arity); anything outside
    the whitelist raises :class:`SchemaError` before any field is used.
    Returns the validated op byte.
    """
    if not isinstance(rec, tuple) or not rec:
        raise SchemaError(
            f"op record is {type(rec).__name__}, expected non-empty tuple")
    op = rec[0]
    if isinstance(op, bool) or not isinstance(op, int):
        raise SchemaError(f"op byte is {type(op).__name__}, expected int")
    arity = schema.get(op)
    if arity is None:
        raise SchemaError(f"unknown op {op}")
    lo, hi = arity
    if not lo <= len(rec) <= hi:
        raise SchemaError(
            f"op {op} arity {len(rec)} outside whitelist [{lo}, {hi}]")
    return op
