"""Capacity-probe harness: the TESTPaxos analog.

Reproduces the reference's benchmark methodology end-to-end over real
sockets (``testing/TESTPaxosMain.java:43`` spawns in-JVM nodes,
``TESTPaxosClient.java:59`` drives load, probe parameters
``TESTPaxosConfig.java:190-229``): start at an initial load, multiply by
``PROBE_LOAD_INCREASE_FACTOR`` (1.1) each run, and stop when the response
rate drops below ``0.9 x load`` or average latency exceeds 1 s; the last
passing load is the capacity.

The in-process cluster mirrors ``tests/loopback_1_group`` /
``loopback_10_groups`` (3 actives on loopback, NoopApp workload).  The
planes run on CUDA unless ``device="cpu"`` (``--device cpu``) is given.

CLI: ``python -m gigapaxos_tpu_torch.testing.capacity [--groups N] [--load L]``.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..client import ReconfigurableAppClient
from ..config import GigapaxosTpuConfig
from ..models.replicable import NoopApp
from ..node import InProcessCluster

#: probe parameters (TESTPaxosConfig.java:190-229)
PROBE_LOAD_INCREASE_FACTOR = 1.1
PROBE_RESPONSE_THRESHOLD = 0.9
PROBE_MAX_LATENCY_S = 1.0
PROBE_MAX_RUNS = 50


@dataclass
class ProbeResult:
    load: float  # offered req/s
    sent: int
    responded: int  # total, including post-window stragglers
    errors: int
    duration_s: float
    responded_in_window: int = 0
    latencies_s: List[float] = field(default_factory=list)

    @property
    def response_rate(self) -> float:
        """Sustained rate: only responses that arrived WITHIN the run
        window count — a saturated system drains its backlog afterwards,
        and counting that would overstate capacity by up to 2x."""
        return (self.responded_in_window / self.duration_s
                if self.duration_s else 0.0)

    @property
    def avg_latency_s(self) -> float:
        return (
            sum(self.latencies_s) / len(self.latencies_s)
            if self.latencies_s else 0.0
        )

    def p50_latency_s(self) -> float:
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        return xs[len(xs) // 2]

    def passed(self, load: float) -> bool:
        return (
            self.response_rate >= PROBE_RESPONSE_THRESHOLD * load
            and self.avg_latency_s <= PROBE_MAX_LATENCY_S
        )


def make_loopback_cluster(
    n_groups: int = 1,
    n_actives: int = 3,
    n_rc: int = 1,
    app_factory=NoopApp,
    max_groups: Optional[int] = None,
    device=None,
):
    """The ``tests/loopback_*`` fixture: one process, real sockets,
    ``n_groups`` pre-created names g0..g{n-1} on 3 replicas; ``device``
    is the planes' torch device (default CUDA)."""
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = max_groups or max(64, n_groups)
    cfg.paxos.pipeline_ticks = True  # stage-overlap on the probe clusters
    cfg.paxos.compact_outbox = True  # vectorized host loop (batch edge)
    cfg.paxos.min_tick_interval_s = 0.004  # coalesce: amortize tick cost
    for i in range(n_actives):
        cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
    for i in range(n_rc):
        cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
    from ..reconfiguration.demand import DemandProfile

    cluster = InProcessCluster(
        cfg, app_factory,
        # sparse demand reports: at probe rates the reference's
        # report-per-request cadence floods the RC plane (3 frames/req)
        demand_profile_factory=lambda name: DemandProfile(
            name, min_requests_before_report=64
        ),
        device=device,
    )
    client = ReconfigurableAppClient(cfg.nodes)
    for g in range(n_groups):
        resp = client.create(f"g{g}")
        if not resp.get("ok"):
            raise RuntimeError(f"create g{g} failed: {resp}")
    return cluster, client


class CapacityProbe:
    """Drives open-loop load through the async client and walks the probe
    ladder (TESTPaxosClient's runTestWorkload + capacity loop)."""

    def __init__(self, client: ReconfigurableAppClient, names: List[str],
                 payload: bytes = b"noop", batch: bool = False):
        self.client = client
        self.names = names
        self.payload = payload
        # client-edge coalescing (RequestBatcher analog): many requests per
        # frame instead of one — the capacity knee was frame cost
        self.sender = client.batching() if batch else None
        # pre-resolve every name so measurement excludes actives lookups
        for n in names:
            self.client.request_actives(n)

    #: latency is sampled 1-in-N so the probe harness itself doesn't tax
    #: the measured system (the shared-core analog of the reference's
    #: sampled response timing, TESTPaxosClient.java:59)
    LAT_SAMPLE = 8

    def run_once(self, load: float, duration_s: float) -> ProbeResult:
        res = ProbeResult(load=load, sent=0, responded=0, errors=0,
                          duration_s=duration_s)
        # deque.append is atomic under the GIL: response accounting needs
        # no lock on the hot path
        ok_in = collections.deque()
        ok_late = collections.deque()
        errs = collections.deque()
        lats = collections.deque()
        t_end = time.monotonic() + duration_s
        interval = 1.0 / load
        i = 0
        next_t = time.monotonic()

        def cb_fast(p):
            if p.get("ok"):
                (ok_in if time.monotonic() <= t_end else ok_late).append(1)
            else:
                errs.append(1)

        while time.monotonic() < t_end:
            now = time.monotonic()
            if now < next_t:
                time.sleep(min(next_t - now, 0.002))
                continue
            next_t += interval
            name = self.names[i % len(self.names)]
            i += 1
            if i % self.LAT_SAMPLE == 0:
                t0 = time.monotonic()

                def cb(p, t0=t0):
                    if p.get("ok"):
                        now2 = time.monotonic()
                        (ok_in if now2 <= t_end else ok_late).append(1)
                        lats.append(now2 - t0)
                    else:
                        errs.append(1)
            else:
                cb = cb_fast
            try:
                if self.sender is not None:
                    self.sender.submit(name, self.payload, cb)
                else:
                    self.client.send_request(name, self.payload, cb)
                res.sent += 1
            except Exception:
                res.errors += 1
        # drain window: late responses still count against offered load
        deadline = time.monotonic() + min(2.0, PROBE_MAX_LATENCY_S * 2)
        while time.monotonic() < deadline:
            if len(ok_in) + len(ok_late) + len(errs) + res.errors >= res.sent:
                break
            time.sleep(0.01)
        res.responded_in_window = len(ok_in)
        res.responded = len(ok_in) + len(ok_late)
        res.errors += len(errs)
        res.latencies_s = list(lats)
        return res

    def probe(self, init_load: float, duration_s: float = 2.0,
              max_runs: int = PROBE_MAX_RUNS) -> List[ProbeResult]:
        """The capacity ladder; returns all runs (last passing = capacity)."""
        runs: List[ProbeResult] = []
        load = init_load
        for _ in range(max_runs):
            r = self.run_once(load, duration_s)
            runs.append(r)
            if not r.passed(load):
                break
            load *= PROBE_LOAD_INCREASE_FACTOR
        return runs

    @staticmethod
    def capacity(runs: List[ProbeResult]) -> float:
        passing = [r.load for r in runs if r.passed(r.load)]
        return max(passing) if passing else 0.0


def main() -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=10)
    ap.add_argument("--load", type=float, default=1000.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--batch", action="store_true",
                    help="coalesce requests into batched frames")
    ap.add_argument("--device", default=None,
                    help="torch device of the planes (default: cuda)")
    args = ap.parse_args()

    cluster, client = make_loopback_cluster(n_groups=args.groups,
                                            device=args.device)
    try:
        probe = CapacityProbe(client, [f"g{i}" for i in range(args.groups)],
                              batch=args.batch)
        runs = probe.probe(args.load, args.duration, args.runs)
        for r in runs:
            print(json.dumps({
                "load": round(r.load, 1),
                "response_rate": round(r.response_rate, 1),
                "avg_latency_ms": round(r.avg_latency_s * 1e3, 2),
                "p50_latency_ms": round(r.p50_latency_s() * 1e3, 2),
                "passed": r.passed(r.load),
            }))
        print(json.dumps({
            "metric": f"loopback_capacity_req_per_s_{args.groups}_groups"
                      + ("_batched" if args.batch else ""),
            "value": round(CapacityProbe.capacity(runs), 1),
            "unit": "req/s",
        }))
    finally:
        client.close()
        cluster.close()


if __name__ == "__main__":
    main()
