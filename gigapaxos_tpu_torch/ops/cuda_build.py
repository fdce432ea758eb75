"""Builds the port's CUDA sources into shared libraries at first use.

A ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` inside the
package (``.gitignore`` lists the directory), then loaded with ``ctypes``.
The content hash in the file name keeps a stale library from ever being
loaded for a changed source.  Nothing here runs at import time: the first
kernel call builds, or a caller builds up front with :func:`build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
#: one build at a time: the planes of a cluster tick on threads of their
#: own, and two builds of one source would share a temporary file
_build_lock = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    compiler's output (``-Xptxas -v``: registers and spills per kernel), or
    None when nothing was built; raises with that output on failure."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, so)
    return log


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
