"""Scenario timeline recorder.

Bad-day scenarios (mass recovery, evacuation storms) are judged by
TIME-SERIES measurements — goodput dip depth, shed window length,
time-to-recover — which the point-in-time scrape plane (obs/metrics.py)
cannot answer.  This module is the instrument: a background sampler that
records metric series against wall clock into a bounded ring, with EVENT
ANNOTATIONS (crash, restart, migration, replay progress) interleaved on the
same clock, so a plot of "goodput vs t" can be read against "node 2 was
killed here".

One :class:`TimelineRecorder` runs per node; a ``ModeBServer`` serves its
recorder's snapshot on ``/timeline``.  (The reference's
``merge_timelines``, which composes the snapshots of several cells, comes
with the cells.)

Families registered here: ``timeline_samples_total``,
``timeline_events_total``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

from .metrics import registry as _registry


def registry_sampler(*families: str) -> Callable[[], Dict[str, float]]:
    """A ``sample_fn`` reading named families from the process registry,
    summing across label sets (a node's per-class counters collapse to
    one series).  Histograms contribute their p99."""

    def sample() -> Dict[str, float]:
        snap = _registry().snapshot()
        out: Dict[str, float] = {}
        for key, val in snap.items():
            fam = key.split("{", 1)[0]
            if fam not in families:
                continue
            if isinstance(val, dict):  # histogram snapshot -> p99 series
                out[fam + "_p99"] = val.get("p99", 0.0)
            else:
                out[fam] = out.get(fam, 0.0) + val
        return out

    return sample


class TimelineRecorder:
    """Samples ``sample_fn()`` every ``interval_s`` into a bounded ring.

    ``annotate(kind, **data)`` interleaves an event on the same wall
    clock from any thread.  ``snapshot()`` returns the JSON document the
    ``/timeline`` route serves.
    """

    def __init__(self, sample_fn: Callable[[], Dict[str, float]],
                 interval_s: float = 0.25, cap: int = 4096,
                 node: str = "?"):
        self.node = node
        self.interval_s = max(0.01, float(interval_s))
        self._sample_fn = sample_fn
        self._samples: "collections.deque[dict]" = collections.deque(
            maxlen=cap)
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=cap)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.t0 = time.time()
        self._samples_c = _registry().counter(
            "timeline_samples_total",
            help="timeline metric samples recorded", node=node)
        self._events_c = _registry().counter(
            "timeline_events_total",
            help="timeline event annotations recorded", node=node)

    # --------------------------------------------------------------- sampling
    def sample_once(self) -> dict:
        """Take one sample now (the thread's body; also the test hook —
        deterministic tests drive the clock without the thread)."""
        row = {"t": time.time()}
        try:
            row.update(self._sample_fn())
        except Exception:
            # a broken source must not kill the sampler; the gap itself
            # is visible in the series
            row["sample_error"] = 1
        with self._lock:
            self._samples.append(row)
        self._samples_c.inc()
        return row

    def annotate(self, kind: str, **data) -> None:
        ev = {"t": time.time(), "kind": kind}
        ev.update(data)
        with self._lock:
            self._events.append(ev)
        self._events_c.inc()

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "TimelineRecorder":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"timeline:{self.node}", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    # --------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "node": self.node,
                "t0": self.t0,
                "interval_s": self.interval_s,
                "samples": list(self._samples),
                "events": list(self._events),
            }


def merge_timelines(snaps: Iterable[dict]) -> dict:
    """Compose per-cell timeline snapshots onto one wall clock: samples
    stay per-source (series have different columns per cell), events
    merge into one list sorted by time with a ``node`` tag — the
    supervisor's ``/timeline`` body."""
    snaps = [s for s in snaps if s]
    events: List[dict] = []
    sources = {}
    for s in snaps:
        node = str(s.get("node", "?"))
        sources[node] = {
            "t0": s.get("t0"),
            "interval_s": s.get("interval_s"),
            "samples": s.get("samples", []),
        }
        for ev in s.get("events", []):
            events.append(dict(ev, node=node))
    events.sort(key=lambda e: e.get("t", 0.0))
    return {
        "t0": min((s.get("t0") or 0.0) for s in snaps) if snaps else 0.0,
        "sources": sources,
        "events": events,
    }
