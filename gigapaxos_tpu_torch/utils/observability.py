"""Periodic state dumps: the observability loop.

The reference logs periodic summaries — DelayProfiler stats printed from
the execution loop (``PaxosInstanceStateMachine.java:1794-1796``) and the
outstanding/unpaused counts dump (``PaxosManager.java:482-494``).
:class:`StatsReporter` is that loop: registered sources are polled on an
interval and emitted as one JSON line each through ``logging``
(machine-parseable, journald/file friendly).  The sources here cover the
nodes and the transport; the placement plane's sources come with it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from typing import Callable, Dict

log = logging.getLogger("gigapaxos_tpu_torch.stats")


class StatsReporter:
    def __init__(self, node_id: str, interval_s: float = 10.0,
                 sink: "Callable[[dict], None] | None" = None):
        self.node_id = node_id
        self.interval_s = max(interval_s, 0.5)
        self.sink = sink  # e.g. FlightRecorder.snapshot_sink
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add_source(self, tag: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._sources[tag] = fn

    def snapshot(self) -> dict:
        """One dump of every source (the periodic line's payload)."""
        out = {"node": self.node_id, "ts": time.time()}
        with self._lock:
            sources = dict(self._sources)
        for tag, fn in sources.items():
            try:
                out[tag] = fn()
            except Exception as e:  # a broken source must not kill the loop
                out[tag] = {"error": f"{type(e).__name__}: {e}"[:200]}
        return out

    def start(self) -> "StatsReporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"stats-{self.node_id}", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        # reset so a stop/start cycle restarts the loop (supervisor-driven
        # cell restarts stop the reporter, replay the WAL, then start again)
        self._thread = None
        self._stop = threading.Event()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            snap = self.snapshot()
            log.info("%s", json.dumps(snap, default=str))
            sink = self.sink
            if sink is not None:
                try:
                    sink(snap)
                except Exception:  # a broken sink must not kill the loop
                    pass


def node_stats_source(node) -> Callable[[], dict]:
    """Standard source for any tick-driven node.

    Duck-typed over the union of ModeBNode / ChainModeBNode / Mode A
    ``PaxosManager`` shapes: Mode A managers have no ``alive`` mask of their
    own shape guarantees, use a ``collections.Counter`` for ``stats`` and a
    ``RowAllocator`` (``names()``) rather than a row dict (``items()``), so
    each field degrades to present-if-there instead of raising."""

    def snap() -> dict:
        # the reporter thread races the tick thread on these structures:
        # take the node lock (when it has one) so dict copies don't hit
        # "changed size during iteration" under load
        lock = getattr(node, "lock", None)
        with (lock if lock is not None else contextlib.nullcontext()):
            out = {"ticks": int(getattr(node, "tick_num", 0))}
            rows = getattr(node, "rows", None)
            if rows is not None:
                try:
                    out["groups"] = sum(1 for _ in rows.names())
                except AttributeError:
                    out["groups"] = len(list(rows.items()))
            outstanding = getattr(node, "outstanding", None)
            if outstanding is not None:
                out["outstanding"] = len(outstanding)
            alive = getattr(node, "alive", None)
            if alive is not None:
                out["alive"] = [bool(x) for x in alive]
            stats = getattr(node, "stats", None)
            if stats:
                out["stats"] = dict(stats)
            paused = getattr(node, "_paused", None)
            if paused is not None:
                out["paused"] = len(paused)
            return out

    return snap


def transport_stats_source(transport) -> Callable[[], dict]:
    """Byte/message counters (NIOInstrumenter analog,
    nio/nioutils/NIOInstrumenter.java)."""

    def snap() -> dict:
        return dict(transport.stats)

    return snap
