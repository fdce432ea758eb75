"""Metrics core: counters, gauges, fixed log-bucket histograms.

Design constraints (this sits inside the tick hot path):

* **Allocation-free observation.**  ``Histogram.observe`` converts the
  sample to integer microseconds and indexes a preallocated bucket list by
  ``int.bit_length()`` — no float math beyond one multiply, no dict lookups,
  no allocation.
* **Lock-light.**  Single increments ride CPython's atomic int ops (the
  same contract ``Transport.stats`` already relies on); the registry lock is
  taken only at metric *creation* and at render/snapshot time.
* **Compile-out switch.**  ``GPTPU_METRICS=0`` makes :func:`registry` hand
  back a null registry whose metrics are shared no-op singletons, so every
  instrumentation site degenerates to one attribute lookup + empty call.
  The switch is read once at import (hot paths bind metric objects at
  construction, not per-observation), which is what makes the
  ``benchmarks/obs_overhead.py`` A/B honest: both arms run identical site
  code, only the bound objects differ.

Buckets are powers of two in the sample's base unit (microseconds for
``unit="s"`` histograms, raw integers otherwise), so bucket ``i`` holds
samples with ``int(v).bit_length() == i`` — upper bound ``2**i - 1``.
64 buckets cover < 1 us .. > 2 centuries; percentile error is bounded by
the 2x bucket width, which is the right trade for an always-on plane.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Tuple

import numpy as np


def _env_metrics_enabled() -> bool:
    val = os.environ.get("GPTPU_METRICS", "")
    return val.strip().lower() not in ("0", "false", "off", "no")


#: Read once at import; hot paths bind metric objects at construction time,
#: so flipping this mid-process would not (and must not) take effect.
METRICS_ENABLED = _env_metrics_enabled()

N_BUCKETS = 64


def metrics_enabled() -> bool:
    """True unless the process was started with ``GPTPU_METRICS=0``."""
    return METRICS_ENABLED


def _freeze(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` is a single int add (GIL-atomic)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n


class Histogram:
    """Fixed log-bucket histogram.

    ``unit="s"`` histograms take float seconds and bucket by integer
    microseconds; ``unit=""`` histograms take raw non-negative numbers
    (batch sizes, frame counts).  ``observe`` never allocates.
    """

    __slots__ = ("name", "labels", "unit", "buckets", "count", "total",
                 "_scale")

    def __init__(self, name: str,
                 labels: Tuple[Tuple[str, str], ...] = (),
                 unit: str = "s"):
        self.name = name
        self.labels = labels
        self.unit = unit
        self._scale = 1e6 if unit == "s" else 1.0
        self.buckets: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        raw = int(v * self._scale)
        if raw < 0:
            raw = 0
        i = raw.bit_length()
        if i >= N_BUCKETS:
            i = N_BUCKETS - 1
        self.buckets[i] += 1
        self.count += 1
        self.total += v

    def observe_array(self, values, counts=None) -> None:
        """``observe`` of every value of a float array (``counts[i]`` times
        each, if given), vectorised: the same buckets and count, with no
        Python step per value; the total adds the values' NumPy sum, so it
        may differ from repeated ``observe`` in the last digits.  A value's
        bucket is the bit length of its scaled integer part, read from the
        exponent of the scaled float."""
        v = np.asarray(values, np.float64).ravel()
        if not v.size:
            return
        # for x >= 1 the biased exponent minus 1022 is int(x).bit_length();
        # below 1 (and for negative x, whose sign bit makes it negative)
        # it is at most 0, which the clip takes to bucket 0
        i = np.multiply(v, self._scale).view(np.int64)
        i >>= 52
        i -= 1022
        np.clip(i, 0, N_BUCKETS - 1, out=i)
        if counts is None:
            per_bucket = np.bincount(i, minlength=N_BUCKETS)
            self.count += v.size
            self.total += float(v.sum())
        else:
            n = np.asarray(counts, np.int64).ravel()
            per_bucket = np.bincount(i, weights=n, minlength=N_BUCKETS)
            self.count += int(n.sum())
            self.total += float(np.dot(v, n))
        b = self.buckets
        for k in np.flatnonzero(per_bucket).tolist():
            b[k] += int(per_bucket[k])

    # -------------------------------------------------------------- queries
    def bucket_upper(self, i: int) -> float:
        """Inclusive upper bound of bucket ``i`` in the observe() unit."""
        return ((1 << i) - 1) / self._scale

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile sample.

        Error is bounded by the bucket width (a factor of 2), which is the
        always-on trade; exact latencies come from reqtrace / bench runs.
        """
        n = self.count
        if n == 0:
            return 0.0
        # rank of the q-quantile sample, 1-based, clamped into [1, n]
        rank = min(max(int(q * n) + (0 if q * n == int(q * n) else 1), 1), n)
        cum = 0
        for i, c in enumerate(self.buckets):
            cum += c
            if cum >= rank:
                return self.bucket_upper(i)
        return self.bucket_upper(N_BUCKETS - 1)


class _NullMetric:
    """Shared no-op twin: every mutator is an empty method."""

    __slots__ = ()
    name = "null"
    labels: Tuple[Tuple[str, str], ...] = ()
    unit = ""
    value = 0
    count = 0
    total = 0.0
    buckets: List[int] = []

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def observe_array(self, values, counts=None) -> None:
        pass

    def percentile(self, q) -> float:
        return 0.0

    def bucket_upper(self, i) -> float:
        return 0.0


_NULL_METRIC = _NullMetric()


class Registry:
    """Get-or-create store keyed by (name, frozen labels).

    One process-wide default instance backs :func:`registry`; tests create
    private ones.  The lock guards only creation and iteration — observation
    goes straight at the returned metric object.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._help: Dict[str, str] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], help_: str,
             **kw):
        key = (name, _freeze(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
                    if help_ and name not in self._help:
                        self._help[name] = help_
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "", unit: str = "s",
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, help, unit=unit)

    # ------------------------------------------------------------ inspection
    def metrics(self) -> Iterable[object]:
        with self._lock:
            return list(self._metrics.values())

    def help_text(self, name: str) -> str:
        return self._help.get(name, "")

    def find(self, name: str) -> List[object]:
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def snapshot(self) -> dict:
        """Flat JSON-able dump (flight-recorder / StatsReporter payload)."""
        out = {}
        for m in self.metrics():
            key = m.name
            if m.labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in m.labels) + "}"
            if isinstance(m, Histogram):
                out[key] = {
                    "count": m.count,
                    "sum": round(m.total, 6),
                    "p50": m.percentile(0.50),
                    "p90": m.percentile(0.90),
                    "p99": m.percentile(0.99),
                }
            else:
                out[key] = m.value
        return out


class NullRegistry(Registry):
    """Hands out the shared no-op metric: the GPTPU_METRICS=0 arm."""

    def _get(self, cls, name, labels, help_, **kw):
        return _NULL_METRIC

    def metrics(self):
        return []

    def snapshot(self) -> dict:
        return {}


_DEFAULT = Registry()
_NULL = NullRegistry()


def registry() -> Registry:
    """The process default registry (null twin under ``GPTPU_METRICS=0``)."""
    return _DEFAULT if METRICS_ENABLED else _NULL
