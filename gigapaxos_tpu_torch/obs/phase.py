"""Per-tick phase clocks for the tick drivers.

A :class:`PhaseClock` lives on a manager and splits each tick into named
host-side phases: ``mark(phase)`` records the wall time since the previous
mark into ``tick_phase_seconds{driver=,plane=,phase=}``.  The timestamps are
host-side (taken at dispatch enqueue and at completion/unpack), so the
always-on mode adds **no device synchronization** — the ``dispatch`` phase
is enqueue cost and the ``tally`` phase absorbs the device wait exactly as
the manager already experiences it.  For exact device step time there is an
opt-in blocking mode (``cfg.obs.blocking_phases``): the driver
synchronizes the device before marking, so ``device_step`` holds the
tick's device time.

Spans.  While spans are recorded — between ``record_spans(True)`` and
``record_spans(False)``, or while a ``torch.profiler`` session runs — each
``mark(p)`` also appends ``("<driver>.<p>", start_ns, end_ns, tick)`` to a
bounded in-memory ring, ``end`` appends the whole tick as
``<driver>.tick``, and the collector hook appends ``gc.gen<g>`` for each
collection.  Stamps are Unix nanoseconds, the host clock of the profiler's
event list, and a span's length is exactly what its histogram observed.
``tick`` is the number of the tick whose work the phase did: a pipelined
completion that finishes tick N-1 inside tick N carries N-1.  The ring
keeps the newest :data:`RING_SPANS` spans (older ones are overwritten);
:func:`take_spans` reads and clears it, and :func:`session_totals` gives
what every histogram gained over the last stretch in which spans were
recorded.

:class:`DeviceTimers` times parts of a tick on the device with CUDA event
pairs and reads each pair only once ``query()`` says it has passed, so it
never waits for the device.

The canonical phase vocabulary below is the list of phases each tick
driver marks; the clock pre-creates them so a scrape shows all of them.
"""

from __future__ import annotations

import collections
import gc
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import METRICS_ENABLED, Counter, Histogram, Registry, registry

# driver name -> the phases its tick marks
DRIVER_PHASES: Dict[str, Tuple[str, ...]] = {
    # paxos/manager.py PaxosManager.tick/_complete_tick
    "modea": ("repair", "intake", "dispatch", "wal_fsync",
              "tally", "execute", "egress", "sweep"),
    # modeb/manager.py ModeBNode.tick (ring_relay: the one-downstream-send
    # payload dissemination hop that replaces payload fan-out under
    # cfg.paxos.ring_dissemination)
    "modeb": ("ingress", "intake", "dispatch", "wal_fsync",
              "tally", "execute", "outbox_pack", "egress", "ring_relay"),
    # chain/manager.py ChainManager.tick
    "chain": ("intake", "dispatch", "wal_fsync", "tally", "execute"),
    # chain/modeb.py ChainModeBNode.tick
    "chain_modeb": ("intake", "dispatch", "wal_fsync",
                    "tally", "execute", "outbox_pack", "egress"),
}

#: The extra phase recorded only under cfg.obs.blocking_phases.
BLOCKING_PHASE = "device_step"

#: spans the ring holds; the oldest are overwritten beyond it
RING_SPANS = 1 << 16

_now_ns = time.perf_counter_ns

# process-wide span state: the switch, the ring, and the Unix time of
# perf_counter_ns() == 0 (taken when recording starts)
_ON = False
_FORCED = False
_RING: collections.deque = collections.deque(maxlen=RING_SPANS)
_OFFSET_NS = 0
_BASE: Dict[tuple, Tuple[int, float]] = {}
_SESSION: Dict[tuple, Tuple[int, float]] = {}
_PROFILER = None  # torch.autograd.profiler, once it is loaded


def _profiling() -> bool:
    """True while a ``torch.profiler`` session runs in this process."""
    global _PROFILER
    if _PROFILER is None:
        _PROFILER = sys.modules.get("torch.autograd.profiler")
        if _PROFILER is None:
            return False
    return bool(getattr(_PROFILER, "_is_profiler_enabled", False))


def _totals() -> Dict[tuple, Tuple[int, float]]:
    """``(count, total)`` of every histogram, ``(value, value)`` of every
    counter."""
    out = {}
    for h in registry().metrics():
        if isinstance(h, Histogram):
            out[(h.name, h.labels)] = (h.count, h.total)
        elif isinstance(h, Counter):
            out[(h.name, h.labels)] = (h.value, float(h.value))
    return out


def _set_recording(on: bool) -> None:
    global _ON, _OFFSET_NS, _BASE, _SESSION
    if on == _ON:
        return
    if on:
        _OFFSET_NS = time.time_ns() - _now_ns()
        _BASE = _totals()
    else:
        base = _BASE
        _SESSION = {k: (c - base.get(k, (0, 0.0))[0],
                        t - base.get(k, (0, 0.0))[1])
                    for k, (c, t) in _totals().items()}
    _ON = on


def refresh_recording() -> None:
    """Start or stop recording spans as the switch and the profiler say;
    every tick's ``begin`` calls it."""
    _set_recording(_FORCED or _profiling())


def record_spans(on: bool) -> None:
    """Record spans from now on (``True``) or stop, unless a profiler
    session keeps them on."""
    global _FORCED
    _FORCED = bool(on)
    refresh_recording()


def take_spans() -> List[Tuple[str, int, int, int]]:
    """The ring's spans, oldest first, and an empty ring."""
    out = list(_RING)
    _RING.clear()
    return out


def session_totals() -> Dict[tuple, Tuple[int, float]]:
    """``(count, total)`` each histogram of the default registry gained in
    the last stretch of span recording, keyed by ``(name, labels)`` (a
    counter's gain in both places); while recording, the stretch so far."""
    if _ON:
        base = _BASE
        return {k: (c - base.get(k, (0, 0.0))[0],
                    t - base.get(k, (0, 0.0))[1])
                for k, (c, t) in _totals().items()}
    return dict(_SESSION)


# ------------------------------------------------------------ collections
_GC_HOOKED = False
_GC_H: Dict[int, Histogram] = {}
_gc_t0 = 0


def _gc_hook(phase: str, info: dict) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = _now_ns()
        return
    t0, now = _gc_t0, _now_ns()
    g = info["generation"]
    _GC_H[g].observe((now - t0) * 1e-9)
    if _ON:
        _RING.append((f"gc.gen{g}", t0 + _OFFSET_NS, now + _OFFSET_NS, -1))


def _install_gc_hook() -> None:
    """Observe every collection's pause into ``gc_pause_seconds``, once a
    process."""
    global _GC_HOOKED
    if _GC_HOOKED:
        return
    reg = registry()
    for g in range(len(gc.get_stats())):
        _GC_H[g] = reg.histogram(
            "gc_pause_seconds", help="host pause per garbage collection",
            generation=str(g))
    gc.callbacks.append(_gc_hook)
    _GC_HOOKED = True


class PhaseClock:
    """Delta clock over one tick: ``begin`` ... ``mark(p)*`` ... ``end``.

    ``mark`` observes (now - last mark) into the phase histogram and
    advances the mark.  ``touch`` re-arms the mark without observing — the
    pipelined completion path (``drain_pipeline``) uses it so a deferred
    ``_complete_tick`` doesn't attribute cross-tick idle time to ``tally``;
    given a tick number, the spans of the marks after it carry that tick.
    ``tick`` counts ``begin`` calls.
    """

    __slots__ = ("driver", "plane", "_reg", "_h", "_tick_h", "_t", "_t0",
                 "tick", "_cur", "_names")

    def __init__(self, driver: str, plane: str = "default",
                 reg: Optional[Registry] = None):
        self.driver = driver
        self.plane = plane
        self._reg = registry() if reg is None else reg
        self._h: Dict[str, Histogram] = {}
        self._names: Dict[str, str] = {}
        self._tick_h = self._reg.histogram(
            "tick_seconds", help="whole-tick wall time",
            driver=driver, plane=plane)
        now = _now_ns()
        self._t = now
        self._t0 = now
        self.tick = 0
        self._cur = 0
        # pre-create the declared phases so the scrape shows the full
        # vocabulary (zero-count) from the first tick
        for p in DRIVER_PHASES.get(driver, ()):
            self._phase_h(p)
        if METRICS_ENABLED:
            _install_gc_hook()

    def _phase_h(self, phase: str) -> Histogram:
        h = self._h.get(phase)
        if h is None:
            h = self._h[phase] = self._reg.histogram(
                "tick_phase_seconds",
                help="host wall time per tick phase",
                driver=self.driver, plane=self.plane, phase=phase)
            self._names[phase] = f"{self.driver}.{phase}"
        return h

    def begin(self) -> None:
        refresh_recording()
        now = _now_ns()
        self._t = now
        self._t0 = now
        self.tick += 1
        self._cur = self.tick

    def touch(self, tick: Optional[int] = None) -> None:
        self._t = _now_ns()
        if tick is not None:
            self._cur = tick

    def mark(self, phase: str) -> None:
        now = _now_ns()
        self._phase_h(phase).observe((now - self._t) * 1e-9)
        if _ON:
            _RING.append((self._names[phase], self._t + _OFFSET_NS,
                          now + _OFFSET_NS, self._cur))
        self._t = now

    def end(self) -> None:
        now = _now_ns()
        self._tick_h.observe((now - self._t0) * 1e-9)
        if _ON:
            _RING.append((f"{self.driver}.tick", self._t0 + _OFFSET_NS,
                          now + _OFFSET_NS, self.tick))


class _NullPhaseClock:
    """Compiled-out twin: every method is an empty call."""

    __slots__ = ()
    driver = "null"
    plane = "null"
    tick = 0

    def begin(self) -> None:
        pass

    def touch(self, tick: Optional[int] = None) -> None:
        pass

    def mark(self, phase: str) -> None:
        pass

    def end(self) -> None:
        pass


_NULL_CLOCK = _NullPhaseClock()


def phase_clock(driver: str, plane: str = "default"):
    """A PhaseClock on the default registry, or the shared no-op twin
    under ``GPTPU_METRICS=0`` (the bound-at-construction compile-out)."""
    if not METRICS_ENABLED:
        return _NULL_CLOCK
    return PhaseClock(driver, plane)


class DeviceTimers:
    """Device time of named parts of a tick, without a sync.

    ``t = start()`` ... ``stop(part, t)`` records an event pair on
    ``stream`` around the work enqueued between them; ``poll()``
    observes every pair whose end event ``query()`` reports passed into
    ``tick_device_seconds{driver=,plane=,part=}`` and returns its events to
    a pool.  The stream runs in order, so pairs are read oldest first and
    each once; call ``poll`` after a blocking copy and the pairs enqueued
    before it are ready.  Past :attr:`PENDING_MAX` unread pairs ``start``
    records nothing."""

    PENDING_MAX = 64

    def __init__(self, driver: str, plane: str, parts, event: Callable,
                 stream, reg: Optional[Registry] = None, **labels):
        reg = registry() if reg is None else reg
        self._h = {p: reg.histogram(
            "tick_device_seconds",
            help="device time of a part of a tick (CUDA events)",
            driver=driver, plane=plane, part=p, **labels) for p in parts}
        self._event = event
        self._stream = stream
        self._free: list = []
        self._pending: collections.deque = collections.deque()

    def _record(self):
        ev = self._free.pop() if self._free else self._event()
        ev.record(self._stream)
        return ev

    def start(self):
        if len(self._pending) >= self.PENDING_MAX:
            return None
        return self._record()

    def stop(self, part: str, ev0) -> None:
        if ev0 is not None:
            self._pending.append((self._h[part], ev0, self._record()))

    def poll(self) -> None:
        q = self._pending
        while q and q[0][2].query():
            h, e0, e1 = q.popleft()
            h.observe(e0.elapsed_time(e1) * 1e-3)
            self._free += (e0, e1)


class _NullDeviceTimers:
    """No device, or metrics compiled out: every method is an empty call."""

    __slots__ = ()

    def start(self):
        return None

    def stop(self, part: str, ev0) -> None:
        pass

    def poll(self) -> None:
        pass


_NULL_TIMERS = _NullDeviceTimers()


def device_timers(driver: str, plane: str, parts, device, stream=None,
                  **labels):
    """:class:`DeviceTimers` on ``stream``, by default a CUDA ``device``'s
    current stream (the one its ticks then run on); the no-op twin on any
    other device and under ``GPTPU_METRICS=0``.  ``labels`` (a mesh
    shard's ``shard``) join the histograms' labels."""
    if not METRICS_ENABLED or getattr(device, "type", None) != "cuda":
        return _NULL_TIMERS
    import torch

    return DeviceTimers(
        driver, plane, parts,
        event=lambda: torch.cuda.Event(enable_timing=True),
        stream=(torch.cuda.current_stream(device) if stream is None
                else stream), **labels)


def mesh_transfer_counter(kind: str):
    """``mesh_transfer_bytes_total{kind}``: bytes a mesh program sends
    from one shard's device to another's, counted where it sends them
    (``rank``: the exec budget's rank blocks; ``replica``: the replica
    axis's all-gathers; ``state``: whole-state gathers and scatters of the
    rare paths)."""
    return registry().counter(
        "mesh_transfer_bytes_total",
        help="bytes sent between a mesh's shards", kind=kind)
