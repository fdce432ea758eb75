"""Demand profiling: the pluggable reconfiguration policy SPI.

``AbstractDemandProfile`` analog (``reconfigurationutils/
AbstractDemandProfile.java:149`` + default ``DemandProfile.java:38-130``):
active replicas fold every coordinated request into a per-name profile and
periodically ship it to the name's reconfigurators (DemandReport); the
reconfigurator aggregates reports and asks the profile whether/where to
migrate the name (``reconfigure``).

The default policy mirrors the reference's: report after every
``min_requests_before_report`` requests, track EWMA inter-arrival time, and
never reconfigure more often than ``min_interval_s`` /
``min_requests_between`` — the sample ``reconfigure`` returns None (no
migration) just like the reference's default, with a rate-threshold hook
subclasses override (see ``RateBasedMigrationPolicy``).
"""

from __future__ import annotations

import abc
import time
from typing import Dict, List, Optional


class AbstractDemandProfile(abc.ABC):
    def __init__(self, name: str):
        self.name = name

    @abc.abstractmethod
    def register_request(self, sender: Optional[str], now: Optional[float] = None) -> None:
        """Fold one client request into the profile (sender = client id/addr,
        used by geo-aware policies)."""

    def register_requests(self, sender: Optional[str], n: int,
                          now: Optional[float] = None) -> None:
        """Fold ``n`` requests from one sender at once (the batched client
        edge registers demand per frame, not per request).  Default loops;
        profiles override with O(1) math."""
        for _ in range(n):
            self.register_request(sender, now)

    @abc.abstractmethod
    def should_report(self) -> bool:
        """True when the active should ship a DemandReport now
        (shouldReportDemandStats, DemandProfile.java:126)."""

    @abc.abstractmethod
    def get_stats(self) -> dict:
        """JSON-serializable snapshot carried by the DemandReport."""

    @abc.abstractmethod
    def combine(self, stats: dict) -> None:
        """Aggregate a received report (reconfigurator side)."""

    @abc.abstractmethod
    def reconfigure(
        self, cur_actives: List[str], all_actives: List[str]
    ) -> Optional[List[str]]:
        """New active set, or None for "leave it" (shouldReconfigure)."""

    def just_reconfigured(self) -> None:
        """Reset rate limiting after a migration commits."""


class DemandProfile(AbstractDemandProfile):
    """The reference's default profile: request counting + EWMA inter-arrival
    time, report every N requests, migration disabled by default."""

    def __init__(
        self,
        name: str,
        # the reference's cadence: report after every request
        # (DemandProfile.java:126 minRequestsBeforeDemandReport).  At high
        # rates a per-request report to the whole RC group dominates the
        # edge (3 frames per request) — deployments chasing throughput
        # raise this via their profile factory (capacity.py uses 64).
        min_requests_before_report: int = 1,
        min_interval_s: float = 0.0,
        min_requests_between: int = 1,
    ):
        super().__init__(name)
        self.min_requests_before_report = min_requests_before_report
        self.min_interval_s = min_interval_s
        self.min_requests_between = min_requests_between
        self.num_requests = 0  # since last report
        self.num_total = 0
        self.inter_arrival_ewma = 0.0
        self._last_request_t = 0.0
        self._last_reconfig_t = 0.0
        self._total_at_last_reconfig = 0
        self.by_sender: Dict[str, int] = {}

    # ----------------------------------------------------------- active side
    def register_request(self, sender: Optional[str], now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.num_requests += 1
        self.num_total += 1
        if sender is not None:
            self.by_sender[sender] = self.by_sender.get(sender, 0) + 1
        if self._last_request_t > 0:
            ia = now - self._last_request_t
            self.inter_arrival_ewma = (
                ia
                if self.inter_arrival_ewma == 0
                else 0.9 * self.inter_arrival_ewma + 0.1 * ia
            )
        self._last_request_t = now

    def register_requests(self, sender: Optional[str], n: int,
                          now: Optional[float] = None) -> None:
        """O(1) batch fold: counters advance by n, the EWMA treats the
        batch as n evenly spaced arrivals over the gap since the last one."""
        if n <= 0:
            return
        now = time.monotonic() if now is None else now
        self.num_requests += n
        self.num_total += n
        if sender is not None:
            self.by_sender[sender] = self.by_sender.get(sender, 0) + n
        if self._last_request_t > 0:
            ia = (now - self._last_request_t) / n
            self.inter_arrival_ewma = (
                ia
                if self.inter_arrival_ewma == 0
                else 0.9 * self.inter_arrival_ewma + 0.1 * ia
            )
        self._last_request_t = now

    def should_report(self) -> bool:
        return self.num_requests >= self.min_requests_before_report

    def get_stats(self) -> dict:
        stats = {
            "name": self.name,
            "rate": (
                1.0 / self.inter_arrival_ewma if self.inter_arrival_ewma > 0 else 0.0
            ),
            "nreqs": self.num_requests,
            "ntotal": self.num_total,
            "by_sender": dict(self.by_sender),
        }
        self.num_requests = 0  # reporting resets the delta counter
        self.by_sender = {}
        return stats

    # ---------------------------------------------------- reconfigurator side
    def combine(self, stats: dict) -> None:
        self.num_total += stats.get("nreqs", 0)
        rate = stats.get("rate", 0.0)
        if rate > 0:
            self.inter_arrival_ewma = (
                1.0 / rate
                if self.inter_arrival_ewma == 0
                else 0.9 * self.inter_arrival_ewma + 0.1 / rate
            )
        for s, n in stats.get("by_sender", {}).items():
            self.by_sender[s] = self.by_sender.get(s, 0) + n

    def _rate_limited(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return (
            now - self._last_reconfig_t < self.min_interval_s
            or self.num_total - self._total_at_last_reconfig
            < self.min_requests_between
        )

    def reconfigure(
        self, cur_actives: List[str], all_actives: List[str]
    ) -> Optional[List[str]]:
        return None  # default policy: demand-driven migration off

    def just_reconfigured(self) -> None:
        self._last_reconfig_t = time.monotonic()
        self._total_at_last_reconfig = self.num_total


class RateBasedMigrationPolicy(DemandProfile):
    """A concrete migration policy: once total demand crosses
    ``migrate_after`` requests, rotate the replica set to the next
    ``len(cur)`` nodes (deterministic, testable — the shape of policy the
    reference's wiki suggests users write)."""

    def __init__(self, name: str, migrate_after: int = 10, **kw):
        super().__init__(name, **kw)
        self.migrate_after = migrate_after

    def reconfigure(
        self, cur_actives: List[str], all_actives: List[str]
    ) -> Optional[List[str]]:
        if self._rate_limited() or self.num_total < self.migrate_after:
            return None
        if len(all_actives) <= len(cur_actives):
            return None
        pool = sorted(all_actives)
        cur = sorted(cur_actives)
        i = pool.index(cur[0]) if cur and cur[0] in pool else 0
        k = len(cur) or 1
        rotated = [pool[(i + 1 + j) % len(pool)] for j in range(k)]
        return None if sorted(rotated) == cur else rotated
