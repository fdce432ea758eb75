"""Crash flight recorder: the last N snapshots/events survive the process.

A bounded ring of recent StatsReporter snapshots plus transport/chaos
events.  Because a SIGKILL'd process gets no last words, the recorder
*persists continuously*: every ``record`` call past a small debounce window
(and every explicit ``dump``) rewrites the JSON artifact atomically
(tmp + rename), so the on-disk file always holds the near-latest ring.
SIGUSR2 triggers an on-demand dump with ``reason="sigusr2"``; an installed
``sys.excepthook`` chain dumps on crash-by-exception.

``ProcChaosRunner`` (testing/chaos.py) threads each victim's artifact path
into its chaos log, so a chaos soak leaves one postmortem per killed
process next to the run's WAL directories.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Optional


class FlightRecorder:
    def __init__(self, path: str, cap: int = 256, node: str = "?",
                 persist_every_s: float = 1.0):
        self.path = path
        self.node = node
        self.cap = cap
        self.persist_every_s = persist_every_s
        self._ring: "collections.deque[dict]" = collections.deque(maxlen=cap)
        self._lock = threading.Lock()
        self._last_persist = 0.0
        self._dumps = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    # -------------------------------------------------------------- recording
    def record(self, kind: str, data: Optional[dict] = None, **kw) -> None:
        ev = {"ts": time.time(), "kind": kind}
        if data:
            ev.update(data)
        if kw:
            ev.update(kw)
        with self._lock:
            self._ring.append(ev)
        now = time.monotonic()
        if now - self._last_persist >= self.persist_every_s:
            self.persist()

    def snapshot_sink(self, snap: dict) -> None:
        """StatsReporter ``sink=`` adapter: every periodic snapshot lands in
        the ring (and, via the debounce, on disk)."""
        self.record("stats", snap)

    # ------------------------------------------------------------ persistence
    def persist(self) -> str:
        with self._lock:
            doc = {
                "node": self.node,
                "written": time.time(),
                "pid": os.getpid(),
                "dumps": self._dumps,
                "events": list(self._ring),
            }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._last_persist = time.monotonic()
        return self.path

    def dump(self, reason: str = "manual") -> str:
        """Record the dump marker and force a persist; returns the path."""
        self._dumps += 1
        self.record("dump", reason=reason)
        return self.persist()

    # ---------------------------------------------------------------- hooks
    def install_signal(self) -> None:
        """SIGUSR2 -> dump (main thread only; no-op where unsupported)."""
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            signal.signal(signal.SIGUSR2,
                          lambda _sig, _frm: self.dump("sigusr2"))
        except (ValueError, OSError, AttributeError):
            pass

    def install_excepthook(self) -> None:
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                self.record("crash", exc=f"{exc_type.__name__}: {exc}")
                self.persist()
            except Exception:
                pass
            prev(exc_type, exc, tb)

        sys.excepthook = hook

    @staticmethod
    def read(path: str) -> dict:
        """Load a persisted artifact (postmortem consumer side)."""
        with open(path) as f:
            return json.load(f)
