"""Append-only journal with CRC framing and scribble detection.

The reference's WAL is an append-only journal of log files plus a DB index
(``SQLPaxosLogger.Journaler``, SQLPaxosLogger.java:685, append path :965-1076).
Here the journal is a sequence of length+crc framed records; a torn tail
(partial final record after a crash) is detected by CRC/length mismatch and
truncated at read time, which is exactly the property group-commit fsync
needs.

Format v2 (``GPTPUJ02``) extends the frame with a record kind and a
monotonic per-file sequence number so recovery can tell a *torn tail*
(crash mid-append: truncate, safe — nothing past the tear was ever
fsynced, hence never acked) from a *scribble* (mid-log corruption with
intact records after it: fsynced, possibly acked data was damaged — must
never be silently truncated).  Every ``sync()`` additionally appends a
tiny BARRIER frame before the fsync, so after a crash the byte offset of
the last intact barrier bounds the acked region: any corruption at or
before it destroyed fsynced data (scribble), anything after it was still
in the unsynced group-commit window (torn tail).  The barrier rides the
same fsync it marks, so its cost is ~21 bytes per group commit — noise
next to the fsync itself.

  file      := MAGIC record*
  v1 record := u32 len | u32 crc32(payload) | payload          (GPTPUJ01)
  v2 record := u32 len | u32 crc32(body)    | body             (GPTPUJ02)
  body      := u8 kind | u64 seq | payload      (len = 9 + len(payload))
  kind      := 0 DATA | 1 BARRIER (empty payload)

All integers little-endian.  ``seq`` starts at 1 per file and increases by
exactly 1 per frame (barriers included); reopen resumes after the last
intact frame.  v1 files remain fully readable and are *continued* in v1
format when reopened for append (no mixed-format files); newly created
journals — including post-checkpoint rolls — are v2.

Two interchangeable backends:
* :class:`PyJournal` — pure Python (tests, portability);
* ``native_journal.NativeJournal`` — C++ (``csrc/journal.cc``, built at
  first use) doing buffered appends + batched fsync off the GIL;
  byte-identical format.

The format is the JAX package's, byte for byte, so either package reads
and continues a journal the other wrote.
"""

from __future__ import annotations

import contextlib
import dataclasses
import mmap
import os
import struct
import zlib
from typing import Iterator, List, Optional

_HDR = struct.Struct("<II")
_BODY = struct.Struct("<BQ")  # kind, seq — the fixed prefix of a v2 body
MAGIC = b"GPTPUJ01"
MAGIC2 = b"GPTPUJ02"

KIND_DATA = 0
KIND_BARRIER = 1

#: resync plausibility bound: a candidate frame whose seq jumps more than
#: this past the last good one is treated as a CRC-colliding false positive
SEQ_SLACK = 1 << 20
#: largest frame body a scan will believe (matches nothing the loggers
#: write; a corrupt length field larger than this is rejected immediately)
MAX_FRAME = 1 << 28


class JournalCorruptError(RuntimeError):
    """The journal cannot be opened/replayed without losing fsynced data."""

    def __init__(self, path: str, scan: "JournalScan"):
        self.path = path
        self.scan = scan
        super().__init__(
            f"journal {path}: {scan.kind} at byte {scan.bad_offset} "
            f"({scan.n_records} intact records before, "
            f"{scan.n_suffix} intact after"
            + (f", resync at byte {scan.resync_offset}"
               if scan.resync_offset is not None else "")
            + ") — fsynced (possibly client-acked) data was damaged; "
            "refusing to silently truncate"
        )


@dataclasses.dataclass
class JournalScan:
    """Result of :func:`scan_journal` — the full forensic picture.

    ``kind`` is one of:

    * ``clean``     — every byte parses; nothing to repair.
    * ``torn_tail`` — an incomplete/corrupt region runs to EOF with no
      intact frame after it AND it starts after the last barrier: the
      classic crash tear.  Truncating at ``good_len`` is safe.
    * ``scribble``  — a corrupt region is followed by intact frames
      (resynced via CRC + monotonic-seq validation), or the file magic
      itself is damaged: fsynced data was corrupted in place.
    """

    version: int                     # 1 or 2 (0 = unrecognizable magic)
    kind: str                        # clean | torn_tail | scribble
    records: List[bytes]             # intact-prefix DATA payloads
    n_synced: int                    # prefix records covered by a barrier
    suffix: List[bytes]              # intact DATA payloads after the gap
    good_len: int                    # byte end of the intact prefix
    bad_offset: int                  # == good_len unless clean
    resync_offset: Optional[int]     # where the intact suffix resumes
    last_seq: int                    # last intact-prefix frame seq (v2)
    file_size: int
    # bounded-memory (meta_only) scans classify without materializing
    # payload copies: ``records``/``suffix`` stay empty and only the counts
    # below are filled.  For collecting scans they mirror the list lengths.
    n_records: int = -1
    n_suffix: int = -1

    def __post_init__(self):
        if self.n_records < 0:
            self.n_records = len(self.records)
        if self.n_suffix < 0:
            self.n_suffix = len(self.suffix)


def _parse_frames(buf, pos: int, version: int, last_seq: int,
                  collect: bool = True):
    """Parse frames from ``buf[pos:]`` until a bad one.  Returns
    (payloads, n_data, n_synced, end_pos, last_seq).  For v2, frames must
    carry strictly increasing seq — a CRC-valid frame with a bogus seq is
    not part of this log's stream.  ``buf`` may be bytes or a memoryview
    over an mmap; with ``collect=False`` frames are validated and counted
    without copying any payload bytes out of the map (the bounded-memory
    scan — peak RSS stays O(1) no matter the journal size)."""
    payloads: List[bytes] = []
    n_data = 0
    n_synced = 0
    end = len(buf)
    while pos + _HDR.size <= end:
        length, crc = _HDR.unpack_from(buf, pos)
        if length > MAX_FRAME or pos + _HDR.size + length > end:
            break
        body = buf[pos + _HDR.size:pos + _HDR.size + length]
        if zlib.crc32(body) != crc:
            break
        if version == 2:
            if length < _BODY.size:
                break
            kind, seq = _BODY.unpack_from(body, 0)
            if seq != last_seq + 1 or kind not in (KIND_DATA, KIND_BARRIER):
                break
            last_seq = seq
            if kind == KIND_BARRIER:
                n_synced = n_data
            else:
                n_data += 1
                if collect:
                    payloads.append(bytes(body[_BODY.size:]))
        else:
            n_data += 1
            if collect:
                payloads.append(bytes(body))
        pos += _HDR.size + length
    return payloads, n_data, n_synced, pos, last_seq


def _resync(buf, gap_start: int, version: int, last_seq: int,
            collect: bool = True):
    """Look for an intact frame stream after a corrupt gap.  Returns
    (offset, payloads, n_payloads) or (None, [], 0)."""
    end = len(buf)
    for off in range(gap_start + 1, end - _HDR.size + 1):
        length, crc = _HDR.unpack_from(buf, off)
        if length > MAX_FRAME or off + _HDR.size + length > end:
            continue
        body = buf[off + _HDR.size:off + _HDR.size + length]
        if zlib.crc32(body) != crc:
            continue
        if version == 2:
            if length < _BODY.size:
                continue
            kind, seq = _BODY.unpack_from(body, 0)
            if kind not in (KIND_DATA, KIND_BARRIER):
                continue
            if not (last_seq < seq <= last_seq + SEQ_SLACK):
                continue
            payloads, n_data, _, _, _ = _parse_frames(
                buf, off, 2, seq - 1, collect)
            return off, payloads, n_data
        # v1 has no seq to validate against, so require the candidate
        # stream to parse cleanly all the way to EOF — a lone CRC
        # collision mid-garbage will not do that
        payloads, n_data, _, stop, _ = _parse_frames(buf, off, 1, 0, collect)
        if n_data and stop == end:
            return off, payloads, n_data
    return None, [], 0


@contextlib.contextmanager
def _map_journal(path: str):
    """Yield a read-only memoryview over the file (empty bytes for an
    empty file).  Slicing the view copies only the bytes touched, so a
    multi-GB journal is scanned through the page cache in fixed-size
    windows instead of being materialized whole."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            yield memoryview(b"")
            return
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        mv = memoryview(mm)
        try:
            yield mv
        finally:
            mv.release()
            mm.close()


def scan_journal(path: str, meta_only: bool = False) -> JournalScan:
    """Classify a journal file: clean / torn tail / scribble (see
    :class:`JournalScan`).  This is the read-side authority both backends
    defer to before opening an existing file for append.

    ``meta_only=True`` runs the identical classification (byte-for-byte
    the same verdicts) but leaves ``records``/``suffix`` empty, filling
    only the counts — pair with :func:`iter_scan_records` to replay a
    journal without ever holding more than one record in memory."""
    collect = not meta_only
    with _map_journal(path) as buf:
        size = len(buf)
        if size < len(MAGIC2):
            # shorter than a magic: a tear during file creation — nothing
            # in it was ever fsync-acked (the magic write precedes any
            # record)
            return JournalScan(2 if not size else 0, "torn_tail", [], 0,
                               [], 0, 0, None, 0, size, 0, 0)
        magic = bytes(buf[:len(MAGIC2)])
        if magic == MAGIC2:
            version = 2
        elif magic == MAGIC:
            version = 1
        else:
            # non-empty file with damaged magic: a scribble over the
            # header — every record in the file is unreachable but
            # possibly acked
            return JournalScan(0, "scribble", [], 0, [], 0, 0, None, 0,
                               size, 0, 0)
        payloads, n_data, n_synced, good, last_seq = _parse_frames(
            buf, len(MAGIC2), version, 0, collect)
        if version == 1:
            # no barriers in v1: conservatively treat every intact record
            # as potentially acked (fail closed on decode errors during
            # replay)
            n_synced = n_data
        if good == size:
            return JournalScan(version, "clean", payloads, n_synced, [],
                               good, good, None, last_seq, size, n_data, 0)
        resync_off, suffix, n_suffix = _resync(buf, good, version, last_seq,
                                               collect)
        if resync_off is not None:
            return JournalScan(version, "scribble", payloads, n_synced,
                               suffix, good, good, resync_off, last_seq,
                               size, n_data, n_suffix)
        return JournalScan(version, "torn_tail", payloads, n_synced, [],
                           good, good, None, last_seq, size, n_data, 0)


def iter_scan_records(path: str, scan: JournalScan) -> Iterator[bytes]:
    """Stream the intact-prefix DATA payloads of a scanned journal one
    record at a time (the bounded-memory replay reader).  Yields exactly
    ``scan.n_records`` items, byte-identical to ``scan.records`` from a
    collecting scan; frames were already CRC-validated by the scan, so
    the walk just re-frames up to ``good_len``."""
    if scan.records:
        yield from scan.records
        return
    if scan.n_records == 0:
        return
    with _map_journal(path) as buf:
        pos = len(MAGIC2)
        end = scan.good_len
        # only TEMPORARY slices of the map below: a named slice would
        # still be alive in this frame when the contextmanager unmaps,
        # and mmap.close() refuses while exported buffers exist
        while pos + _HDR.size <= end:
            length, _ = _HDR.unpack_from(buf, pos)
            o = pos + _HDR.size
            if scan.version == 2:
                kind, _ = _BODY.unpack_from(buf, o)
                if kind == KIND_DATA:
                    yield bytes(buf[o + _BODY.size:o + length])
            else:
                yield bytes(buf[o:o + length])
            pos += _HDR.size + length


class PyJournal:
    """Pure-Python journal backend.  Refuses (raises
    :class:`JournalCorruptError`) to open a scribbled file — truncating it
    would silently discard fsynced records; recovery must quarantine it
    first."""

    def __init__(self, path: str):
        self.path = path
        self.failed = False
        self._dirty = False
        self._version = 2
        self._seq = 0
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if exists:
            scan = scan_journal(path)
            if scan.kind == "scribble":
                raise JournalCorruptError(path, scan)
            if scan.good_len < scan.file_size:
                # torn tail: truncate before appending, otherwise
                # everything appended after the tear is unreadable
                with open(path, "r+b") as f:
                    f.truncate(scan.good_len)
            # an existing v1 file is continued in v1 format — mixed-format
            # files would be unreadable by version-at-magic readers
            self._version = scan.version if scan.good_len > 0 else 2
            self._seq = scan.last_seq
            exists = scan.good_len > 0
        # unbuffered FileIO: a crashed node's abandoned journal object must
        # never flush stale buffered bytes at GC time into a file its
        # successor has since reopened (the fault-injection soak restarts
        # loggers over live handles).  v2 appends stage frames in
        # ``_pending`` (plain list, silently dropped on GC — unsynced
        # frames were never acked, so losing them is the page-cache-loss
        # fault model) and ``sync()`` lands pending+barrier in ONE write,
        # mirroring the native backend's batched appends.
        self._pending: List[bytes] = []
        self._f = open(path, "ab", buffering=0)
        if not exists:
            self._f.write(MAGIC2 if self._version == 2 else MAGIC)
            self._f.flush()

    def _frame(self, kind: int, payload: bytes) -> bytes:
        self._seq += 1
        body = _BODY.pack(kind, self._seq) + payload
        return _HDR.pack(len(body), zlib.crc32(body)) + body

    def append(self, record: bytes) -> None:
        if self.failed:
            raise OSError("journal has failed; refusing further appends")
        try:
            if self._version == 2:
                # frame built inline (no _frame() call) and staged, not
                # written: the per-record framing cost stays a few percent
                # of the append
                self._seq = seq = self._seq + 1
                body = _BODY.pack(KIND_DATA, seq) + record
                self._pending.append(
                    _HDR.pack(len(body), zlib.crc32(body)) + body)
            else:
                self._f.write(_HDR.pack(len(record), zlib.crc32(record)))
                self._f.write(record)
        except OSError:
            self.failed = True
            raise
        self._dirty = True

    def _flush_pending(self) -> None:
        """Write staged v2 frames through to the OS without fsyncing —
        the 'bytes reached the page cache, power may still cut' state
        (used by the fault-injection shim to place a tear after them)."""
        if self._pending:
            self._f.write(b"".join(self._pending))
            self._pending.clear()

    def sync(self) -> None:
        if self.failed:
            raise OSError("journal has failed; refusing further syncs")
        try:
            if self._version == 2 and self._dirty:
                # the barrier marks everything before it as covered by
                # this fsync: recovery uses the last intact barrier as
                # the acked-data watermark (see module docstring).  It
                # rides the SAME write as the staged frames, so a group
                # commit costs one write + one fsync regardless of size.
                self._seq = seq = self._seq + 1
                body = _BODY.pack(KIND_BARRIER, seq)
                self._pending.append(
                    _HDR.pack(_BODY.size, zlib.crc32(body)) + body)
            self._flush_pending()
            os.fsync(self._f.fileno())
        except OSError:
            self.failed = True
            raise
        self._dirty = False

    def close(self) -> None:
        try:
            if not self.failed:
                self.sync()
        finally:
            self._f.close()


def read_journal(path: str) -> List[bytes]:
    """Read all intact prefix records; stop silently at the first bad
    frame.  Benign-path reader — recovery paths use :func:`scan_journal`
    so a scribble cannot masquerade as a short log."""
    return scan_journal(path).records

