"""The traced slice of a run: ``torch.profiler`` over host and device, read
straight from the profiler's raw event list.

Device busy time is the union of the device's kernel and copy records (two
records that overlap count once), the idle share is what the union leaves
of the slice, and each idle gap is named by the harness span the host was
in when the gap began (``gen.propose``, ``manager.tick``, ``manager.drain``,
``sink``, or ``host`` outside them)."""

from __future__ import annotations

import contextlib

import numpy as np

SPANS = ("gen.propose", "manager.tick", "manager.drain", "sink")

#: noise in a CUDA kernel's name that says nothing of which kernel it is
_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::")


def short_name(name: str, most: int = 120) -> str:
    """A device record's name without namespaces, cut to ``most``
    characters (records whose short names agree are summed)."""
    for n in _NOISE:
        name = name.replace(n, "")
    return name[:most]


def span_factory(torch, on: bool):
    """``span(name)``: a ``record_function`` while tracing, else nothing."""
    if not on:
        null = contextlib.nullcontext()
        return lambda name: null
    return torch.profiler.record_function


class Slice:
    """Profiles from :meth:`start` to :meth:`stop` (host and device)."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            self.torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summary(self, n_top: int = 10) -> dict:
        """Busy seconds, per-name device seconds, and labelled idle gaps."""
        from torch.autograd import DeviceType

        dev_iv, names, host = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name in SPANS or e.is_user_annotation():
                    continue
                d = e.duration_ns()
                if d <= 0:
                    continue
                dev_iv.append((e.start_ns(), e.start_ns() + d))
                names.append(short_name(name))
            elif name in SPANS:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             name))
        if not dev_iv:
            return {"busy_s": 0.0, "by_name": {}, "gaps": [],
                    "first_ns": None, "last_ns": None}
        iv = np.array(dev_iv, np.int64)
        order = np.argsort(iv[:, 0], kind="stable")
        iv = iv[order]
        dur = iv[:, 1] - iv[:, 0]
        by_name: dict = {}
        for i, k in enumerate(order.tolist()):
            by_name[names[k]] = by_name.get(names[k], 0) + int(dur[i])
        # union of the intervals, and the gaps between merged runs
        end = np.maximum.accumulate(iv[:, 1])
        new_run = np.r_[True, iv[1:, 0] > end[:-1]]
        starts = iv[new_run, 0]
        run_id = np.cumsum(new_run) - 1
        ends = np.zeros(len(starts), np.int64)
        np.maximum.at(ends, run_id, iv[:, 1])
        busy_ns = int((ends - starts).sum())
        gaps = []
        if len(starts) > 1:
            g0, g1 = ends[:-1], starts[1:]
            glen = g1 - g0
            top = np.argsort(-glen, kind="stable")[:n_top]
            for j in top.tolist():
                gaps.append((self._label(host, int(g0[j])),
                             int(glen[j]) / 1e9))
        return {"busy_s": busy_ns / 1e9,
                "by_name": {k: v / 1e9 for k, v in by_name.items()},
                "gaps": gaps, "first_ns": int(starts[0]),
                "last_ns": int(ends[-1])}

    @staticmethod
    def _label(host, t: int) -> str:
        """The innermost harness span open at ``t`` (host clock)."""
        best, best_len = "host", None
        for s, e, name in host:
            if s <= t < e and (best_len is None or e - s < best_len):
                best, best_len = name, e - s
        return best
