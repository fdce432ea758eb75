"""Storage fault injection: a journal shim that makes disks lie on cue.

The WAL's fault model (wal/journal.py, wal/logger.py) claims four
recoverable disk behaviors: torn writes (power cut mid-append), scribbles
(firmware/bit-rot damaging fsynced bytes), fsync errors (the fsyncgate
class — the kernel reported EIO and dropped the dirty pages), and
disk-full.  This module manufactures all four deterministically so the
chaos plane (testing/chaos.py) and tests can drive them against either
journal backend and assert the recovery contract: every acked decision
survives, or the node visibly fail-stops — never a silent divergence.

Two injection paths:

* in-process — ``install()`` registers :class:`FaultyJournal` as the
  logger-level journal wrapper (``wal.logger.set_journal_wrapper``); an
  :class:`Injector` arms faults per WAL directory.
* cross-process — a worker started with ``GPTPU_WAL_FAULTS=1`` wraps its
  journals via :func:`wrap_from_env`, which reads a ``FAULT.json`` plan
  the runner drops next to the journal (the only channel into a child the
  runner cannot reach in-process).

File-level helpers (:func:`flip_byte`, :func:`tear_tail`,
:func:`newest_journal`) operate on a *crashed* node's directory — the
moral equivalent of what a bad disk does while nobody is looking.
"""

from __future__ import annotations

import errno
import glob
import json
import os
import random
from typing import Dict, Optional

#: fault kinds an armed journal understands (file-level bit_flip is a
#: helper on dead files, not a journal behavior)
KINDS = ("torn_write", "fsync_error", "disk_full")


class FaultyJournal:
    """Wraps a ``PyJournal``/``NativeJournal`` and fails on command.

    * ``torn_write``  — the next append leaves a *partial* frame on disk
      (pure-Python inner: a real mid-frame tear; native inner: the frame
      is dropped at the boundary — still a tear, at offset 0) and raises
      ``OSError`` as the "crash".
    * ``fsync_error`` — the next sync raises ``EIO`` without fsyncing.
    * ``disk_full``   — sticky ``ENOSPC`` on every append until cleared.

    All faults mark the journal ``failed`` (sticky), matching the real
    backends: after fsyncgate the write may be gone from the page cache,
    so retrying would ack vapor.
    """

    def __init__(self, inner, path: str):
        self.inner = inner
        self.path = path
        self.armed: Dict[str, dict] = {}
        self.counts: Dict[str, int] = {}

    # journal protocol ----------------------------------------------------
    @property
    def failed(self) -> bool:
        return getattr(self.inner, "failed", False)

    @failed.setter
    def failed(self, v: bool) -> None:
        self.inner.failed = v

    def arm(self, kind: str, **args) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.armed[kind] = args

    def clear(self, kind: str) -> None:
        self.armed.pop(kind, None)

    def _trip(self, kind: str) -> dict:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return self.armed.pop(kind)

    def append(self, record: bytes) -> None:
        if "disk_full" in self.armed:
            # sticky: re-arm (ENOSPC does not clear itself)
            self.counts["disk_full"] = self.counts.get("disk_full", 0) + 1
            self.inner.failed = True
            raise OSError(errno.ENOSPC, "no space left on device (injected)")
        if "torn_write" in self.armed:
            args = self._trip("torn_write")
            self._tear(record, args)
            raise OSError(errno.EIO, "torn write (injected power cut)")
        self.inner.append(record)

    def sync(self) -> None:
        if "fsync_error" in self.armed:
            self._trip("fsync_error")
            self.inner.failed = True
            raise OSError(errno.EIO, "fsync failed (injected)")
        self.inner.sync()

    def close(self) -> None:
        self.inner.close()

    # tear mechanics ------------------------------------------------------
    def _tear(self, record: bytes, args: dict) -> None:
        """Leave a partial frame of ``record`` on disk, then fail the
        journal (nothing may land after a power cut)."""
        inner = self.inner
        f = getattr(inner, "_f", None)
        if f is not None and hasattr(inner, "_frame"):
            # PyJournal: staged-but-unwritten frames reached "the page
            # cache" first, then the torn frame's prefix lands after them
            inner._flush_pending()
            # materialize the real frame bytes and write a strict prefix
            # straight through to the OS
            if inner._version == 2:
                frame = inner._frame(0, record)  # KIND_DATA
            else:
                import struct
                import zlib
                frame = (struct.pack("<II", len(record), zlib.crc32(record))
                         + record)
            keep = int(args.get("keep_bytes",
                                max(1, len(frame) // 2)))
            keep = min(keep, len(frame) - 1)
            f.write(frame[:keep])
            f.flush()
        # native inner: the frame never reaches the C buffer — a tear at
        # the frame boundary (keep == 0), which scan_journal treats the
        # same way (clean truncation point)
        inner.failed = True


# ----------------------------------------------------------- in-process arm
class Injector:
    """Process-wide fault director: tracks every FaultyJournal created by
    the logger wrapper, keyed by WAL directory, so a chaos runner can arm
    faults on "node N's disk" without holding journal references."""

    def __init__(self):
        self.journals: Dict[str, FaultyJournal] = {}  # dir -> newest shim

    def wrap(self, j, path: str) -> FaultyJournal:
        fj = FaultyJournal(j, path)
        self.journals[os.path.dirname(os.path.abspath(path))] = fj
        return fj

    def for_dir(self, log_dir: str) -> Optional[FaultyJournal]:
        return self.journals.get(os.path.abspath(log_dir))

    def arm(self, log_dir: str, kind: str, **args) -> bool:
        fj = self.for_dir(log_dir)
        if fj is None:
            return False
        fj.arm(kind, **args)
        return True

    def clear(self, log_dir: str, kind: str) -> bool:
        fj = self.for_dir(log_dir)
        if fj is None:
            return False
        fj.clear(kind)
        return True


def install() -> Injector:
    """Route every journal the loggers open through a fresh Injector.
    Returns it; call :func:`uninstall` when done (tests)."""
    from ..wal import logger as wal_logger

    inj = Injector()
    wal_logger.set_journal_wrapper(inj.wrap)
    return inj


def uninstall() -> None:
    from ..wal import logger as wal_logger

    wal_logger.set_journal_wrapper(None)


# -------------------------------------------------------- cross-process arm
def plan_path(log_dir: str) -> str:
    return os.path.join(log_dir, "FAULT.json")


def write_plan(log_dir: str, plan: dict) -> str:
    """Drop a fault plan a GPTPU_WAL_FAULTS worker will pick up when it
    (re)opens its journal.  Keys: ``fsync_error_after`` (syncs),
    ``disk_full_after`` / ``torn_write_after`` (appends); 0 = immediately.
    """
    p = plan_path(log_dir)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(plan, f)
    os.replace(tmp, p)
    return p


class _PlannedJournal(FaultyJournal):
    """FaultyJournal driven by a countdown plan instead of explicit arms."""

    def __init__(self, inner, path: str, plan: dict):
        super().__init__(inner, path)
        self._appends = 0
        self._syncs = 0
        self.plan = plan

    def append(self, record: bytes) -> None:
        if self._countdown("disk_full_after", self._appends):
            self.arm("disk_full")
        if self._countdown("torn_write_after", self._appends):
            self.arm("torn_write")
        self._appends += 1
        super().append(record)

    def sync(self) -> None:
        if self._countdown("fsync_error_after", self._syncs):
            self.arm("fsync_error")
        self._syncs += 1
        super().sync()

    def _countdown(self, key: str, done: int) -> bool:
        v = self.plan.get(key)
        return v is not None and done >= int(v)


def wrap_from_env(j, path: str):
    """Hook used by ``wal.logger._new_journal`` under GPTPU_WAL_FAULTS=1:
    if a FAULT.json plan sits next to the journal, wrap it; otherwise the
    journal passes through untouched (workers whose disks behave)."""
    p = plan_path(os.path.dirname(os.path.abspath(path)))
    if not os.path.exists(p):
        return j
    try:
        with open(p) as f:
            plan = json.load(f)
    except (OSError, ValueError):
        return j
    return _PlannedJournal(j, path, plan)


# ---------------------------------------------------------- dead-file tools
def newest_journal(log_dir: str) -> Optional[str]:
    js = sorted(glob.glob(os.path.join(log_dir, "journal.*.log")))
    return js[-1] if js else None


def flip_byte(path: str, offset: Optional[int] = None,
              rng: Optional[random.Random] = None) -> int:
    """Flip one bit of ``path`` in place (the classic latent scribble).
    Returns the chosen offset.  Offsets inside the 8-byte magic model a
    damaged header; anywhere else damages a frame."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty; nothing to flip")
    if offset is None:
        offset = (rng or random).randrange(size)
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (1 << ((rng or random).randrange(8)))]))
        f.flush()
        os.fsync(f.fileno())
    return offset


def tear_tail(path: str, drop_bytes: Optional[int] = None,
              rng: Optional[random.Random] = None) -> int:
    """Truncate ``drop_bytes`` off the end of ``path`` (a torn write
    observed post-crash).  Returns how many bytes were dropped."""
    size = os.path.getsize(path)
    if size <= 8:  # magic only — nothing to tear
        return 0
    if drop_bytes is None:
        drop_bytes = (rng or random).randrange(1, min(64, size - 8) + 1)
    drop_bytes = min(drop_bytes, size - 8)
    with open(path, "r+b") as f:
        f.truncate(size - drop_bytes)
        f.flush()
        os.fsync(f.fileno())
    return drop_bytes
