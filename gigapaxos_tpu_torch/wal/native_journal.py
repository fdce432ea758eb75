"""ctypes binding for the C++ journal backend (``csrc/journal.cc``).

The library is built with the host C++ compiler at first use into
``build/libgpjournal-<hash>.so`` inside the package (``.gitignore`` lists
the directory); the content hash in the name keeps a stale library from
ever being loaded for a changed source.  Nothing outside the package is
written.  On-disk format is byte-identical to :mod:`.journal`, so readers
are shared.  There is no fallback here: a failed build raises
:class:`NativeUnavailable`, and the logger surfaces it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "journal.cc"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_LOAD_ERROR: Exception | None = None
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgpjournal-{digest}.so"


def build() -> Path:
    """Compile ``csrc/journal.cc`` unless its library exists; returns the
    library's path.  Raises :class:`NativeUnavailable` with the compiler's
    output on failure."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode:
        raise NativeUnavailable(
            f"{cxx} failed for {SOURCE.name} (exit {proc.returncode}):\n"
            + proc.stdout.decode(errors="replace"))
    os.replace(tmp, so)
    return so


def _load():
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERROR is not None:
            # cache the failure: re-running the compiler on every journal
            # roll would put a fork+compile on the durability path
            raise NativeUnavailable(str(_LOAD_ERROR)) from _LOAD_ERROR
        try:
            lib = ctypes.CDLL(str(build()))
        except (NativeUnavailable, OSError) as e:
            _LOAD_ERROR = e
            raise NativeUnavailable(f"native journal unavailable: {e}") from e
        lib.gpj_open.restype = ctypes.c_void_p
        lib.gpj_open.argtypes = [ctypes.c_char_p]
        lib.gpj_append.restype = ctypes.c_int
        lib.gpj_append.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.gpj_sync.restype = ctypes.c_int
        lib.gpj_sync.argtypes = [ctypes.c_void_p]
        lib.gpj_close.restype = None
        lib.gpj_close.argtypes = [ctypes.c_void_p]
        lib.gpj_crc32.restype = ctypes.c_uint32
        lib.gpj_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                  ctypes.c_uint32]
        _LIB = lib
        return lib


def crc32(data: bytes, crc: int = 0) -> int:
    """The library's own CRC-32 (the value ``zlib.crc32`` gives)."""
    return _load().gpj_crc32(data, len(data), crc)


class NativeJournal:
    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        if os.path.exists(path) and os.path.getsize(path) > 0:
            # scribble classification is the Python scanner's job: gpj_open
            # truncates at the first bad frame, which on a mid-log scribble
            # would silently destroy the intact (possibly acked) suffix
            from .journal import JournalCorruptError, scan_journal

            scan = scan_journal(path)
            if scan.kind == "scribble":
                raise JournalCorruptError(path, scan)
        self._h = lib.gpj_open(path.encode())
        if not self._h:
            raise OSError(f"gpj_open failed for {path}")
        self.path = path
        self.failed = False

    def append(self, record: bytes) -> None:
        if self.failed:
            raise OSError("journal has failed; refusing further appends")
        if self._lib.gpj_append(self._h, record, len(record)) != 0:
            self.failed = True
            raise OSError("journal append failed")

    def sync(self) -> None:
        if self.failed:
            raise OSError("journal has failed; refusing further syncs")
        if self._lib.gpj_sync(self._h) != 0:
            self.failed = True
            raise OSError("journal sync failed")

    def close(self) -> None:
        if self._h:
            self._lib.gpj_close(self._h)
            self._h = None
