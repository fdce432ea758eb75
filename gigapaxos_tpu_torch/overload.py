"""Overload-robustness plane.

One invariant threads client -> transport -> node -> manager: *finish or
refuse fast, never silently drop or do dead work*.  This module holds the
four shared mechanisms the rest of the tree wires in:

- **Deadlines** — absolute wall-clock milliseconds carried on the wire
  (JSON ``deadline`` field, binbatch header u64).  Every pipeline stage
  checks :func:`expired` and drops dead work with a per-stage
  ``overload_expired_drops_total{stage=...}`` counter instead of burning
  ticks on requests nobody is waiting for.
- **Traffic classes** — ``CLS_CONTROL`` (failure detection,
  reconfiguration RPCs, accepts/commits), ``CLS_CLIENT`` (proposes/
  writes), and ``CLS_READ`` (lease-era reads).  Transport
  keeps separate bounded send budgets per class and drains control
  first, so a client flood can never starve liveness traffic and a read
  flood sheds independently of writes; the intake governor never sheds
  control-class work.
- **:class:`IntakeGovernor`** — watermark-with-hysteresis admission at
  the node intake, generalizing the WAL's ``GPTPU_WAL_MIN_FREE_BYTES``
  disk shed: above the high watermark client proposes get an explicit
  retriable NACK (the ``busy`` reject), never a silent drop; shedding
  stops only once backlog falls below the low watermark.
- **:class:`TokenBucket` / :class:`CircuitBreaker`** — client-side storm
  dampers: retries spend from a budget funded at ~10% of fresh
  requests, and a NACK/timeout-rate breaker per active fails fast
  instead of hammering a browned-out destination.

Everything here is stdlib-only and lock-cheap; the hot-path check
(:func:`expired`) is one comparison.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .obs.metrics import registry

# Traffic classes.  Integers on purpose: they index per-class queue/budget
# arrays in the transport and stamp cheaply into stats keys.
CLS_CONTROL = 0   # FD pings, reconfiguration RPCs, accepts/commits/ring
CLS_CLIENT = 1    # client proposes (writes) and their responses
CLS_READ = 2      # client reads: lease-local or consensus
#                   fallback — their own transport budget, so a read flood
#                   backpressures reads, never writes or control

CLS_NAMES = {CLS_CONTROL: "control", CLS_CLIENT: "client",
             CLS_READ: "read"}

# Pipeline stages that check deadlines, in flow order.  Used by tests and
# dashboards; count_expired() accepts only these so a typo'd stage name
# fails loudly instead of minting a ghost label.
STAGES = ("client", "ar_ingress", "intake", "edge_forward", "egress")

# Callback request-id codes for refused work (extends the existing
# convention where rid < 0 means "not admitted"):
#   -1  not_active / stopped / storage shed  (pre-existing)
#   -2  busy: transient admission NACK, retry the SAME active after backoff
#   -3  expired: deadline passed mid-pipeline; drop silently, never respond
RID_REFUSED = -1
RID_BUSY = -2
RID_EXPIRED = -3


# --------------------------------------------------------------- deadlines

def deadline_at(timeout_s: float, now: Optional[float] = None) -> int:
    """Absolute wall-clock deadline, unix milliseconds (the wire unit)."""
    return int(((now if now is not None else time.time()) + timeout_s) * 1000)


def expired(deadline_ms, now: Optional[float] = None) -> bool:
    """True when a wire deadline has passed.  0/None/garbage = no deadline
    (never expires) so old peers and hand-built packets stay compatible."""
    if not isinstance(deadline_ms, int) or deadline_ms <= 0:
        return False
    return ((now if now is not None else time.time()) * 1000.0) > deadline_ms


def count_expired(stage: str, node: str = "-", n: int = 1) -> None:
    """Per-stage dead-work counter: each request is counted ONCE, by the
    stage that detected expiry (later stages never see it — the detector
    drops it or settles it with RID_EXPIRED)."""
    if stage not in STAGES:
        raise ValueError(f"unknown deadline stage {stage!r}")
    registry().counter(
        "overload_expired_drops_total",
        help="expired requests dropped, by pipeline stage",
        stage=stage, node=str(node)).inc(n)


def count_shed(cls: int, where: str, node: str = "-", n: int = 1) -> None:
    """Admission-shed counter (busy NACKs), labelled by traffic class so
    the "zero control sheds while client sheds active" gate is scrapable."""
    registry().counter(
        "overload_admission_shed_total",
        help="admission-control sheds (retriable busy NACKs) by class",
        cls=CLS_NAMES.get(cls, str(cls)), where=where, node=str(node)).inc(n)


# ----------------------------------------------------------- retry budget

class TokenBucket:
    """Retry budget: fresh requests deposit ``fraction`` tokens, each
    retry withdraws one.  When the bucket is dry the caller fails fast
    instead of amplifying a brownout into congestion collapse (the
    classic "retry budget" from the SRE literature; ~10% default).

    ``initial`` seeds a small burst so a cold client can still retry the
    odd transient blip; ``cap`` bounds how much good weather banks up.
    """

    def __init__(self, fraction: float = 0.1, initial: float = 3.0,
                 cap: float = 50.0):
        self.fraction = float(fraction)
        self.cap = float(cap)
        self._tokens = min(float(initial), self.cap)
        self._lock = threading.Lock()
        self.deposits = 0
        self.spent = 0
        self.denied = 0

    def deposit(self, n: int = 1) -> None:
        """Fund the budget: call once per *fresh* (non-retry) request."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.fraction * n)
            self.deposits += n

    def take(self) -> bool:
        """Spend one token for a retry; False = budget exhausted."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


# -------------------------------------------------------- circuit breaker

class CircuitBreaker:
    """Per-destination breaker driven by NACK/timeout rate.

    Closed: traffic flows, failures accumulate in a sliding window.
    Open: after ``threshold`` consecutive failures (or window failure
    rate >= ``rate`` over >= ``min_samples``) the destination is avoided
    for ``cooloff_s``.  Half-open: after cooloff traffic may probe; the
    first success closes the breaker, the first failure re-opens it
    immediately (cooloff doubles, capped).  ``allow()`` is deliberately
    non-consuming so routing can screen several candidates without
    burning probe slots.
    """

    def __init__(self, threshold: int = 5, rate: float = 0.5,
                 min_samples: int = 10, cooloff_s: float = 1.0,
                 max_cooloff_s: float = 15.0, window: int = 32,
                 clock=time.monotonic):
        self.threshold = int(threshold)
        self.rate = float(rate)
        self.min_samples = int(min_samples)
        self.base_cooloff_s = float(cooloff_s)
        self.max_cooloff_s = float(max_cooloff_s)
        self.window = int(window)
        self._clock = clock
        self._lock = threading.Lock()
        self._events = []          # recent outcomes, True = failure
        self._consec = 0
        self._open_until = 0.0
        self._opened = 0           # times tripped (drives backoff doubling)

    def _trip(self) -> None:
        cool = min(self.max_cooloff_s,
                   self.base_cooloff_s * (2 ** min(self._opened, 6)))
        self._open_until = self._clock() + cool
        self._opened += 1
        self._events.clear()
        self._consec = 0

    def record(self, ok: bool) -> None:
        with self._lock:
            if self._open_until > 0.0 and self._clock() >= self._open_until:
                # half-open probe verdict: one success closes, one failure
                # re-opens with a doubled cooloff
                if ok:
                    self._open_until = 0.0
                    self._opened = 0
                else:
                    self._trip()
                return
            self._events.append(not ok)
            if len(self._events) > self.window:
                self._events.pop(0)
            self._consec = 0 if ok else self._consec + 1
            if ok:
                return
            n = len(self._events)
            if self._consec >= self.threshold or (
                    n >= self.min_samples
                    and sum(self._events) / n >= self.rate):
                self._trip()

    def allow(self) -> bool:
        """May we send to this destination now?  Open = no; half-open and
        closed = yes.  Non-consuming: screening a candidate costs nothing."""
        with self._lock:
            return (self._open_until <= 0.0
                    or self._clock() >= self._open_until)

    @property
    def state(self) -> str:
        with self._lock:
            if self._open_until <= 0.0:
                return "closed"
            if self._clock() < self._open_until:
                return "open"
            return "half-open"


# --------------------------------------------------------- intake governor

class IntakeGovernor:
    """Watermark-with-hysteresis admission control at the node intake.

    ``update(backlog)`` runs once per tick with the node's outstanding
    client work (staged + in-flight).  Crossing ``hi`` starts shedding
    client-class proposes (explicit retriable ``busy`` NACK); shedding
    stops only once backlog falls below ``lo`` — the hysteresis band
    prevents admit/shed flapping at the boundary.  Control-class work is
    never governed here: liveness traffic rides through an overload.
    """

    def __init__(self, hi: int = 4096, lo: int = 0, node: str = "-"):
        self.hi = int(hi)
        self.lo = int(lo) if lo else max(1, self.hi // 2)
        if self.lo >= self.hi:
            self.lo = max(1, self.hi // 2)
        self.node = str(node)
        self.shedding = False
        self.backlog = 0
        self.sheds = 0
        self.transitions = 0
        self._gauge = registry().gauge(
            "overload_intake_shedding",
            help="1 while the intake governor is shedding client work",
            node=self.node)

    def update(self, backlog: int) -> bool:
        """Feed the current backlog; returns the (possibly new) shed state."""
        self.backlog = int(backlog)
        if not self.shedding and self.backlog >= self.hi:
            self.shedding = True
            self.transitions += 1
            self._gauge.set(1)
        elif self.shedding and self.backlog < self.lo:
            self.shedding = False
            self.transitions += 1
            self._gauge.set(0)
        return self.shedding

    def admit(self, cls: int = CLS_CLIENT) -> bool:
        """One admission decision.  Control class always passes."""
        if cls == CLS_CONTROL or not self.shedding:
            return True
        self.sheds += 1
        return False


# ------------------------------------------------------------- stamp sugar

def stamp(packet: Dict, timeout_s: Optional[float]) -> Dict:
    """Stamp a JSON packet with a wire deadline (rides the
    trace-stamp pattern: best-effort field, absent on old senders)."""
    if timeout_s is not None and "deadline" not in packet:
        packet["deadline"] = deadline_at(timeout_s)
    return packet
