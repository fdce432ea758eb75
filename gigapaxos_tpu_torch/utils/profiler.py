"""EWMA delay/rate/counter instrumentation.

Analog of the reference's ``utils/DelayProfiler.java`` (``updateDelay
:61-131``, ``updateMovAvg :156``, ``getStats``): named exponentially-weighted
moving averages for latencies, rates and counters, printed as a one-line
summary.  Used the same way — sampled (1-in-N) instrumentation on hot paths
(``PaxosInstanceStateMachine.java:135-158``), full instrumentation on control
paths.

Host-side only; device-side timing comes from the PyTorch profiler.
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class DelayProfiler:
    """Thread-safe registry of EWMA stats.

    * ``update_delay(key, t0)`` — EWMA of (now - t0) in milliseconds;
    * ``update_mov_avg(key, value)`` — EWMA of an arbitrary sample;
    * ``update_rate(key, n)`` — EWMA events/sec measured between calls;
    * ``update_count(key, n)`` — plain counter.
    """

    def __init__(self, alpha: float = 1.0 / 32) -> None:
        self.alpha = alpha
        self._lock = threading.Lock()
        self._avg: Dict[str, float] = {}
        self._unit: Dict[str, str] = {}  # "ms" for delays, "" for raw EWMAs
        self._n: Dict[str, int] = {}
        self._count: Dict[str, int] = {}
        self._rate: Dict[str, float] = {}
        self._rate_last: Dict[str, float] = {}

    def _ewma(self, table: Dict[str, float], key: str, sample: float) -> None:
        old = table.get(key)
        table[key] = (
            sample if old is None else (1 - self.alpha) * old + self.alpha * sample
        )

    def update_delay(self, key: str, t0: float, n: int = 1) -> None:
        """Fold in the delay since ``t0`` (``time.monotonic()``), averaged
        over ``n`` operations (the reference's batched variant,
        DelayProfiler.java:102-110)."""
        sample_ms = (time.monotonic() - t0) * 1000.0 / max(n, 1)
        with self._lock:
            self._ewma(self._avg, key, sample_ms)
            self._unit[key] = "ms"
            self._n[key] = self._n.get(key, 0) + n

    def update_mov_avg(self, key: str, value: float) -> None:
        with self._lock:
            self._ewma(self._avg, key, float(value))
            self._unit.setdefault(key, "")
            self._n[key] = self._n.get(key, 0) + 1

    def update_rate(self, key: str, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            last = self._rate_last.get(key)
            self._rate_last[key] = now
            if last is not None and now > last:
                self._ewma(self._rate, key, n / (now - last))

    def update_count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._count[key] = self._count.get(key, 0) + n

    def get(self, key: str) -> float | None:
        with self._lock:
            if key in self._avg:
                return self._avg[key]
            if key in self._rate:
                return self._rate[key]
            if key in self._count:
                return float(self._count[key])
            return None

    def get_stats(self) -> str:
        """One-line summary, the ``DelayProfiler.getStats()`` idiom."""
        with self._lock:
            parts = [
                f"{k}:{v:.2f}{self._unit.get(k, '')}[{self._n.get(k, 0)}]"
                for k, v in sorted(self._avg.items())
            ]
            parts += [f"{k}:{v:.1f}/s" for k, v in sorted(self._rate.items())]
            parts += [f"{k}:{v}" for k, v in sorted(self._count.items())]
        return " ".join(parts)

    def clear(self) -> None:
        with self._lock:
            self._avg.clear()
            self._unit.clear()
            self._n.clear()
            self._count.clear()
            self._rate.clear()
            self._rate_last.clear()


# Module-level default instance (the reference's DelayProfiler is static).
profiler = DelayProfiler()


class Sampler:
    """The 1-in-N instrumentation gate (``instrument(n)``,
    PaxosInstanceStateMachine.java:135-158): ``if sampler(): profiler...``."""

    def __init__(self, n: int = 100):
        self.n = n
        self._i = 0

    def __call__(self) -> bool:
        self._i += 1
        if self._i >= self.n:
            self._i = 0
            return True
        return False
