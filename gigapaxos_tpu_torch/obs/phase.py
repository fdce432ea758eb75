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

The canonical phase vocabulary below is the list of phases each tick
driver marks; the clock pre-creates them so a scrape shows all of them.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from .metrics import METRICS_ENABLED, Histogram, Registry, registry

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


class PhaseClock:
    """Delta clock over one tick: ``begin`` ... ``mark(p)*`` ... ``end``.

    ``mark`` observes (now - last mark) into the phase histogram and
    advances the mark.  ``touch`` re-arms the mark without observing — the
    pipelined completion path (``drain_pipeline``) uses it so a deferred
    ``_complete_tick`` doesn't attribute cross-tick idle time to ``tally``.
    """

    __slots__ = ("driver", "plane", "_reg", "_h", "_tick_h", "_t", "_t0")

    def __init__(self, driver: str, plane: str = "default",
                 reg: Optional[Registry] = None):
        self.driver = driver
        self.plane = plane
        self._reg = registry() if reg is None else reg
        self._h: Dict[str, Histogram] = {}
        self._tick_h = self._reg.histogram(
            "tick_seconds", help="whole-tick wall time",
            driver=driver, plane=plane)
        now = time.perf_counter()
        self._t = now
        self._t0 = now
        # pre-create the declared phases so the scrape shows the full
        # vocabulary (zero-count) from the first tick
        for p in DRIVER_PHASES.get(driver, ()):
            self._phase_h(p)

    def _phase_h(self, phase: str) -> Histogram:
        h = self._h.get(phase)
        if h is None:
            h = self._h[phase] = self._reg.histogram(
                "tick_phase_seconds",
                help="host wall time per tick phase",
                driver=self.driver, plane=self.plane, phase=phase)
        return h

    def begin(self) -> None:
        now = time.perf_counter()
        self._t = now
        self._t0 = now

    def touch(self) -> None:
        self._t = time.perf_counter()

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self._phase_h(phase).observe(now - self._t)
        self._t = now

    def end(self) -> None:
        self._tick_h.observe(time.perf_counter() - self._t0)


class _NullPhaseClock:
    """Compiled-out twin: every method is an empty call."""

    __slots__ = ()
    driver = "null"
    plane = "null"

    def begin(self) -> None:
        pass

    def touch(self) -> None:
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
