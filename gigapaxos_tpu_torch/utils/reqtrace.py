"""Per-request flow tracing (RequestInstrumenter analog).

The reference's ``paxosutil/RequestInstrumenter.java:25-60`` accumulates a
per-requestID string of every packet hop when DEBUG is on, for single-node
debugging of lost or slow requests.  The dense design has no per-request
packets to hook, so the trace points are the host lifecycle stages instead:

  staged -> admitted(row) -> placed(tick) -> executed(slot, replica)
         -> responded | failed

A no-op unless enabled (``GPTPU_REQTRACE`` set to anything but
``0/false/off/""``, or set ``.enabled`` directly).  Bounded to the most
recent ``cap`` requests, thread-safe.

Timelines are keyed by (namespace, rid): rid spaces are per-manager (Mode
A managers all start at rid 1; Mode B planes reuse slot-tagged rids), so
each manager scopes the process-global store with a namespace — every
node of one Mode B universe shares a namespace, which is what merges a
forwarded request's cross-node hops into one timeline in in-process
deployments.  Managers expose their scope as ``manager.reqtrace``.
"""

from __future__ import annotations

import collections
import os
import threading
import time


def _env_enabled() -> bool:
    val = os.environ.get("GPTPU_REQTRACE", "")
    return val.strip().lower() not in ("", "0", "false", "off", "no")


class _Store:
    def __init__(self, cap: int = 4096):
        self.enabled = _env_enabled()
        self.cap = cap
        self._events: "collections.OrderedDict[tuple, list]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def event(self, ns: str, rid: int, stage: str, detail: dict) -> None:
        ts = time.monotonic() - self._t0
        key = (ns, rid)
        with self._lock:
            ev = self._events.get(key)
            if ev is None:
                ev = self._events[key] = []
                while len(self._events) > self.cap:
                    self._events.popitem(last=False)
            ev.append((ts, stage, detail))

    def get(self, ns: str, rid: int) -> list:
        with self._lock:
            return list(self._events.get((ns, rid), ()))

    def keys(self, ns: str, limit: int = 64) -> list:
        """Most-recent rids recorded under a namespace (newest last)."""
        with self._lock:
            out = [rid for (n, rid) in self._events if n == ns]
        return out[-limit:]


_STORE: "_Store | None" = None
_STORE_LOCK = threading.Lock()


def _store() -> _Store:
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = _Store()
    return _STORE


class RequestTracer:
    """A namespace-scoped view over the process-global trace store.

    ``enabled`` reads the process default (GPTPU_REQTRACE) unless this view
    was explicitly toggled — setting it affects ONLY this view, so enabling
    tracing on one manager neither records nor evicts for the others."""

    def __init__(self, ns: str):
        self.ns = ns
        self._st = _store()
        self._override: "bool | None" = None

    @property
    def enabled(self) -> bool:
        return (self._st.enabled if self._override is None
                else self._override)

    @enabled.setter
    def enabled(self, on: bool) -> None:
        self._override = bool(on)

    # ------------------------------------------------------------- recording
    def event(self, rid: int, stage: str, **detail) -> None:
        if not self.enabled:  # view override first, then process default
            return
        self._st.event(self.ns, rid, stage, detail)

    # ------------------------------------------------------------- inspection
    def dump(self, rid: int) -> str:
        """Formatted timeline for one request id ('' if unknown/disabled)."""
        return "\n".join(
            f"[{ts * 1e3:10.3f}ms] rid={rid} {stage}"
            + (f" {detail}" if detail else "")
            for ts, stage, detail in self._st.get(self.ns, rid)
        )

    def stages(self, rid: int):
        return [stage for _ts, stage, _d in self._st.get(self.ns, rid)]

    def latency_s(self, rid: int) -> "float | None":
        """staged -> responded wall time, if both stages were recorded."""
        ev = self._st.get(self.ns, rid)
        if not ev:
            return None
        t = {stage: ts for ts, stage, _ in ev}
        if "staged" in t and "responded" in t:
            return t["responded"] - t["staged"]
        return None


def tracer(ns: str) -> RequestTracer:
    """Scoped view for one rid namespace (one Mode A manager, or one Mode B
    universe — all nodes of a universe share it so cross-node hops merge)."""
    return RequestTracer(ns)


# --------------------------------------------------------------------------
# Cross-process tracing.
#
# The per-manager namespaces above merge hops only inside one process.  For
# the serving-cell plane a request crosses processes (client -> edge cell ->
# owner cell), so the client mints a process-independent trace id and stamps
# it on the wire frame (``p["trace"]``, behind the client-side flag — see
# ``client.trace``); every hop that sees the key records into the shared
# ``x`` namespace of ITS process store.  ``dump_ns`` is the per-process
# export; CellSupervisor merges the workers' dumps into one timeline served
# from the scrape endpoint (``/trace/<tid>``).
#
# Recording at a hop is gated by the id's *presence*, not by the hop
# process's GPTPU_REQTRACE — the client flag is the one switch, and the
# bounded store caps memory either way.

XNS = "x"

_TID_LOCK = threading.Lock()
_TID_NEXT = 0


def new_trace_id() -> int:
    """Process-unique 48-bit id: random 32-bit prefix per process (from the
    pid + clock via os.urandom) x 16-bit sequence.  Fits in a JSON number."""
    global _TID_NEXT
    with _TID_LOCK:
        _TID_NEXT += 1
        seq = _TID_NEXT & 0xFFFF
    prefix = int.from_bytes(os.urandom(4), "big")
    return (prefix << 16) | seq


def xtracer() -> RequestTracer:
    """The cross-process view: always records (presence of a trace id on a
    frame IS the flag; the stamping side is what GPTPU_REQTRACE gates)."""
    t = RequestTracer(XNS)
    t.enabled = True
    return t


def dump_ns(ns: str = XNS, limit: int = 64) -> dict:
    """JSON-able export of a namespace's recent timelines:
    ``{rid: [[ts, stage, detail], ...]}`` — the worker's ``trace`` reply,
    which the supervisor merges across cells."""
    st = _store()
    out = {}
    for rid in st.keys(ns, limit):
        out[str(rid)] = [[round(ts, 6), stage, detail]
                         for ts, stage, detail in st.get(ns, rid)]
    return out
