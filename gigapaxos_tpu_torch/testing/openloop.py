"""Open-loop load harness: simulated client populations with think times.

The capacity probe (``testing/capacity.py``) is effectively closed-loop at
saturation: a slowing system stretches its own arrival schedule, so offered
load sags exactly when the question is "what happens past the knee?".  This
module drives OPEN-loop load — the overload plane's gate methodology:
a population of ``n_clients`` simulated clients, each issuing a
request and then thinking ``think_s`` seconds, yields offered rate
``n_clients / think_s``; arrivals are clock-scheduled (Poisson via
exponential gaps) and NEVER wait for completions.  Hundreds of thousands of
clients cost one generator thread, not one thread each.

Per rung it separates the overload plane's four outcomes — admitted
completions (goodput), ``busy`` NACKs (classed admission shed), ``expired``
refusals (deadline cutoffs), and losses — plus p50/p99 of ADMITTED work,
the number the plane promises stays bounded past the knee ("finish or
refuse fast, never silently drop or do dead work").

``make_overload_cluster`` is the ``make_loopback_cluster`` fixture with the
overload knobs (intake watermark, wire deadline) surfaced, so a bench can
pull the knee down to where a 2-second rung ladder can walk through it.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time
from dataclasses import field
from typing import Dict, List, Optional

from ..client import ReconfigurableAppClient
from ..config import GigapaxosTpuConfig
from ..models.replicable import NoopApp
from ..node import InProcessCluster

#: a rung "passes" (is at or below the knee) while goodput holds 90% of
#: offered — the same threshold the closed-loop probe uses, applied to
#: clock-scheduled arrivals
KNEE_THRESHOLD = 0.9


@dataclasses.dataclass
class RungResult:
    """One rung of offered load and what came back."""

    offered_rps: float
    n_clients: int
    think_s: float
    duration_s: float
    sent: int = 0
    admitted: int = 0       # ok responses inside the run window
    admitted_late: int = 0  # ok responses that straggled into the drain
    shed_busy: int = 0      # retriable admission NACKs (the refuse-fast arm)
    expired: int = 0        # deadline refusals surfaced to the client
    errors: int = 0         # everything else (not_active, stopped, ...)
    lost: int = 0           # never answered within the drain window
    latencies_s: List[float] = field(default_factory=list)

    @property
    def goodput_rps(self) -> float:
        return self.admitted / self.duration_s if self.duration_s else 0.0

    @property
    def refused(self) -> int:
        return self.shed_busy + self.expired

    def p50_s(self) -> float:
        return self._pct(0.50)

    def p99_s(self) -> float:
        return self._pct(0.99)

    def _pct(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def passed(self) -> bool:
        return self.goodput_rps >= KNEE_THRESHOLD * self.offered_rps

    def to_dict(self) -> dict:
        return {
            "offered_rps": round(self.offered_rps, 1),
            "n_clients": self.n_clients,
            "think_s": self.think_s,
            "goodput_rps": round(self.goodput_rps, 1),
            "sent": self.sent,
            "admitted": self.admitted,
            "admitted_late": self.admitted_late,
            "shed_busy": self.shed_busy,
            "expired": self.expired,
            "errors": self.errors,
            "lost": self.lost,
            "p50_ms": round(self.p50_s() * 1e3, 2),
            "p99_ms": round(self.p99_s() * 1e3, 2),
            "passed": self.passed(),
        }


class OpenLoopGenerator:
    """Clock-driven load from a simulated client population.

    Arrivals come from one thread replaying a seeded Poisson process at
    rate ``n_clients / think_s``; completions are accounted on the client's
    receive threads via lock-free deque appends.  The generator deliberately
    uses the ASYNC ``send_request`` path (fire the request, classify the
    response in the callback) — the sync ``request()`` retry loop would
    close the loop and mask the very overload this measures.
    """

    #: latency is sampled 1-in-N admitted responses so the harness itself
    #: does not tax the measured system at six-figure client counts
    LAT_SAMPLE = 4

    def __init__(self, client: ReconfigurableAppClient, names: List[str],
                 payload: bytes = b"noop", deadline_s: float = 2.0,
                 seed: int = 0):
        self.client = client
        self.names = names
        self.payload = payload
        self.seed = seed
        # every async send stamps this as the wire deadline — per-rung dead
        # work past it is refused at whatever stage first sees it expired
        self.client.default_deadline_s = deadline_s
        for n in names:  # pre-resolve so rungs exclude actives lookups
            self.client.request_actives(n)

    def run_rung(self, n_clients: int, think_s: float,
                 duration_s: float, drain_s: float = 2.0) -> RungResult:
        offered = n_clients / think_s
        res = RungResult(offered_rps=offered, n_clients=n_clients,
                         think_s=think_s, duration_s=duration_s)
        rng = random.Random(self.seed * 1_000_003 + n_clients)
        ok_in = collections.deque()
        ok_late = collections.deque()
        busy = collections.deque()
        expired = collections.deque()
        errs = collections.deque()
        lats = collections.deque()
        t_end = time.monotonic() + duration_s
        next_t = time.monotonic()
        i = 0

        def cb_fast(p):
            if p.get("ok"):
                (ok_in if time.monotonic() <= t_end else ok_late).append(1)
            elif p.get("error") == "busy":
                busy.append(1)
            elif p.get("error") == "expired":
                expired.append(1)
            else:
                errs.append(1)

        while True:
            now = time.monotonic()
            if now >= t_end:
                break
            if now < next_t:
                time.sleep(min(next_t - now, 0.002))
                continue
            # Poisson arrivals: the superposition of n_clients independent
            # think-time renewal processes, one exponential gap at a time
            next_t += rng.expovariate(offered)
            name = self.names[i % len(self.names)]
            i += 1
            if i % self.LAT_SAMPLE == 0:
                t0 = time.monotonic()

                def cb(p, t0=t0):
                    if p.get("ok"):
                        now2 = time.monotonic()
                        (ok_in if now2 <= t_end else ok_late).append(1)
                        lats.append(now2 - t0)
                    elif p.get("error") == "busy":
                        busy.append(1)
                    elif p.get("error") == "expired":
                        expired.append(1)
                    else:
                        errs.append(1)
            else:
                cb = cb_fast
            try:
                self.client.send_request(name, self.payload, cb)
                res.sent += 1
            except Exception:
                errs.append(1)
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            got = (len(ok_in) + len(ok_late) + len(busy) + len(expired)
                   + len(errs))
            if got >= res.sent:
                break
            time.sleep(0.01)
        res.admitted = len(ok_in)
        res.admitted_late = len(ok_late)
        res.shed_busy = len(busy)
        res.expired = len(expired)
        res.errors = len(errs)
        res.lost = max(0, res.sent - res.admitted - res.admitted_late
                       - res.shed_busy - res.expired - res.errors)
        res.latencies_s = list(lats)
        return res

    def ramp(self, populations: List[int], think_s: float,
             duration_s: float) -> List[RungResult]:
        """Walk the rung ladder in population order (offered load ramps
        with it); unlike the closed-loop probe this does NOT stop at the
        first failing rung — past-the-knee rungs are the point."""
        return [self.run_rung(n, think_s, duration_s)
                for n in populations]


def find_knee(rungs: List[RungResult]) -> Optional[RungResult]:
    """Highest offered load whose rung still passed (goodput >= 90% of
    offered) — the capacity knee of the ladder."""
    passing = [r for r in rungs if r.passed()]
    return max(passing, key=lambda r: r.offered_rps) if passing else None


def make_overload_cluster(
    n_groups: int = 4,
    n_actives: int = 3,
    intake_hi: int = 4096,
    intake_lo: int = 0,
    app_factory=NoopApp,
    max_groups: Optional[int] = None,
    device=None,
):
    """``make_loopback_cluster`` with the overload plane's knobs surfaced:
    a low ``intake_hi`` pulls the admission watermark under the raw socket
    capacity so a short ladder reaches real shedding."""
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = max_groups or max(64, n_groups)
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.compact_outbox = True
    cfg.paxos.min_tick_interval_s = 0.004
    cfg.overload.enabled = True
    cfg.overload.intake_hi = intake_hi
    cfg.overload.intake_lo = intake_lo
    for i in range(n_actives):
        cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
    cfg.nodes.reconfigurators["RC0"] = ("127.0.0.1", 0)
    from ..reconfiguration.demand import DemandProfile

    cluster = InProcessCluster(
        cfg, app_factory,
        demand_profile_factory=lambda name: DemandProfile(
            name, min_requests_before_report=64),
        device=device,
    )
    client = ReconfigurableAppClient(cfg.nodes)
    for g in range(n_groups):
        resp = client.create(f"g{g}")
        if not resp.get("ok"):
            raise RuntimeError(f"create g{g} failed: {resp}")
    return cluster, client


def shed_totals() -> Dict[str, int]:
    """Sum the overload plane's shed counters by class from the process
    registry — the bench's starvation check (client-class sheds active,
    control-class sheds zero) reads straight off the overload metrics."""
    from ..obs.metrics import registry

    out: Dict[str, int] = {"control": 0, "client": 0}
    for m in registry().find("overload_admission_shed_total"):
        cls = dict(m.labels).get("cls", "?")
        out[cls] = out.get(cls, 0) + int(m.value)
    return out


def expired_totals() -> Dict[str, int]:
    """Per-stage expired-drop counters from the process registry."""
    from ..obs.metrics import registry

    out: Dict[str, int] = {}
    for m in registry().find("overload_expired_drops_total"):
        stage = dict(m.labels).get("stage", "?")
        out[stage] = out.get(stage, 0) + int(m.value)
    return out
