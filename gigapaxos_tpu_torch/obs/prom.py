"""Prometheus text exposition (version 0.0.4) for :mod:`.metrics`.

Two renderers:

* :func:`render_registry` — one process's registry as scrape text, with
  optional ``extra_labels`` injected into every sample (a server renders
  itself with ``node="AR0"``; a worker with ``cell="3"`` so a supervisor
  can concatenate).
* :func:`merge_scrapes` — concatenates already-rendered bodies under one
  host-level scrape, deduplicating ``# HELP`` / ``# TYPE`` header lines
  (Prometheus rejects duplicate metadata).

Histograms emit the classic ``_bucket{le=}`` / ``_sum`` / ``_count``
families plus precomputed ``<name>_p50 / _p90 / _p99`` gauges so operators
get percentiles without server-side ``histogram_quantile``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .metrics import Counter, Histogram, Registry


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(labels: Iterable[Tuple[str, str]],
              extra: Optional[Dict[str, str]] = None) -> str:
    items = list(labels)
    if extra:
        have = {k for k, _ in items}
        items += [(k, v) for k, v in extra.items() if k not in have]
    if not items:
        return ""
    return "{" + ",".join(
        f'{k}="{_esc(v)}"' for k, v in sorted(items)) + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_registry(reg: Registry,
                    extra_labels: Optional[Dict[str, str]] = None) -> str:
    """Registry -> Prometheus text; stable order (name, then labels)."""
    by_name: Dict[str, List[object]] = {}
    for m in reg.metrics():
        by_name.setdefault(m.name, []).append(m)

    out: List[str] = []
    for name in sorted(by_name):
        family = sorted(by_name[name], key=lambda m: m.labels)
        first = family[0]
        help_ = reg.help_text(name)
        if isinstance(first, Histogram):
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} histogram")
            for m in family:
                cum = 0
                # only emit buckets up to the highest occupied one (+inf
                # covers the rest); keeps 64-bucket families readable
                top = max((i for i, c in enumerate(m.buckets) if c),
                          default=-1)
                for i in range(top + 1):
                    cum += m.buckets[i]
                    le = _labelstr(m.labels, dict(extra_labels or {},
                                                  le=_fmt(m.bucket_upper(i))))
                    out.append(f"{name}_bucket{le} {cum}")
                inf = _labelstr(m.labels, dict(extra_labels or {}, le="+Inf"))
                out.append(f"{name}_bucket{inf} {m.count}")
                ls = _labelstr(m.labels, extra_labels)
                out.append(f"{name}_sum{ls} {repr(float(m.total))}")
                out.append(f"{name}_count{ls} {m.count}")
            for q, tag in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
                out.append(f"# TYPE {name}_{tag} gauge")
                for m in family:
                    ls = _labelstr(m.labels, extra_labels)
                    out.append(f"{name}_{tag}{ls} {repr(m.percentile(q))}")
        else:
            kind = "counter" if isinstance(first, Counter) else "gauge"
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            for m in family:
                ls = _labelstr(m.labels, extra_labels)
                out.append(f"{name}{ls} {_fmt(m.value)}")
    return "\n".join(out) + ("\n" if out else "")


def merge_scrapes(bodies: Iterable[str]) -> str:
    """Concatenate rendered scrape bodies, deduping # HELP/# TYPE lines."""
    seen_meta = set()
    out: List[str] = []
    for body in bodies:
        for line in body.splitlines():
            if line.startswith("# "):
                if line in seen_meta:
                    continue
                seen_meta.add(line)
            out.append(line)
    return "\n".join(out) + ("\n" if out else "")
