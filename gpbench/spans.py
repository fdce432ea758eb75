"""What the program records about itself in a traced slice, and idle gaps
labelled with it.

While a ``torch.profiler`` session runs, the port records spans of its
tick phases and collections (``gigapaxos_tpu_torch.obs.phase``) and notes
what each histogram gains, so a traced run's last profiler session is its
slice.  The readers here return None on a program that records neither.

A gap is labelled by the innermost span (harness or program) in which the
host spent the largest part of it; ``host`` is time in no span."""

from __future__ import annotations

import numpy as np


def slice_totals(name: str, **labels):
    """``(count, total)`` summed over the histograms ``name`` whose labels
    include ``labels``, over the program's last span session; None where
    the program keeps no such histogram or no session."""
    from gigapaxos_tpu_torch.obs import phase

    totals = getattr(phase, "session_totals", None)
    if totals is None:
        return None
    n, t, found = 0, 0.0, False
    for (nm, lb), (c, s) in totals().items():
        lbd = dict(lb)
        if nm == name and all(lbd.get(k) == v for k, v in labels.items()):
            n, t, found = n + c, t + s, True
    return (n, t) if found else None


def mean_ms(name: str, **labels):
    """Mean milliseconds per observation over the slice, or None."""
    r = slice_totals(name, **labels)
    if r is None or r[0] <= 0:
        return None
    return r[1] / r[0] * 1e3


def gap_shares(g0: int, g1: int, spans) -> dict:
    """Nanoseconds of ``[g0, g1)`` the host spent in each span as its
    innermost (shortest enclosing) one; ``spans`` are ``(name, start,
    end)`` on one clock."""
    inside = [(n, max(s, g0), min(e, g1), e - s) for n, s, e in spans
              if s < g1 and e > g0]
    cuts = sorted({g0, g1} | {x for _, s, e, _ in inside for x in (s, e)})
    share: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        best, blen = "host", None
        for n, s, e, ln in inside:
            if s <= a and b <= e and (blen is None or ln < blen):
                best, blen = n, ln
        share[best] = share.get(best, 0) + (b - a)
    return share


def label_gap(g0: int, g1: int, spans) -> str:
    share = gap_shares(g0, g1, spans)
    return max(share.items(), key=lambda kv: kv[1])[0]


def device_gaps(intervals):
    """(start, end) of every gap between the merged device intervals."""
    if not intervals:
        return []
    iv = np.array(sorted(intervals), np.int64)
    end = np.maximum.accumulate(iv[:, 1])
    new_run = np.r_[True, iv[1:, 0] > end[:-1]]
    starts = iv[new_run, 0]
    ends = np.zeros(len(starts), np.int64)
    np.maximum.at(ends, np.cumsum(new_run) - 1, iv[:, 1])
    return list(zip(ends[:-1].tolist(), starts[1:].tolist()))


def profile_records(prof, harness_names):
    """Device intervals and the harness's host spans ``(name, start, end)``
    of a finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name in harness_names or e.is_user_annotation():
                continue
            if e.duration_ns() > 0:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name in harness_names:
            host.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return dev, host


def idle_report(dev, spans, n_top: int = 10) -> dict:
    """The ``n_top`` longest gaps, labelled, and the idle seconds of all
    gaps by innermost span."""
    gaps = device_gaps(dev)
    by_span: dict = {}
    labelled = []
    for g0, g1 in gaps:
        share = gap_shares(g0, g1, spans)
        for k, v in share.items():
            by_span[k] = by_span.get(k, 0) + v
        labelled.append((g1 - g0, max(share.items(), key=lambda kv: kv[1])[0]))
    labelled.sort(key=lambda x: -x[0])
    return {"idle_gaps": [[name, ln / 1e9] for ln, name in labelled[:n_top]],
            "idle_s_by_span": {k: v / 1e9 for k, v in
                               sorted(by_span.items(), key=lambda kv: -kv[1])},
            "n_gaps": len(gaps)}
