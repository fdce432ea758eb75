"""One run of a cell exactly as ``run.py`` makes it, with what the program
records about itself printed beside the result line.

    python3 gpbench/probe.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--out <dir>]

Adds, on stderr as ``probe <json>`` (and in ``<dir>/<cell>-<seed>.json``):

- ``window``: the request waits the manager observed in the measured
  window (``request_wait_seconds``) beside the ledger's acknowledgements
  and propose-to-acknowledgement times of the same window;
- ``cost``: host seconds a tick spent in the always-on instrumentation
  (device timers, request-wait observations, the collector hook, each
  timed where it runs; the admission stamp and the span switch's check
  timed alone at the run's sizes);
- with ``--trace 1``, ``slice``: the ten longest idle gaps labelled by the
  innermost harness or program span covering most of each, idle seconds by
  span, the device timers against the profiler's copy records, and what
  the host's ``modea.tally`` spans waited on.

``--trace`` and every other argument are passed to ``run.py`` unchanged."""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402

from gpbench import harness  # noqa: E402
from gpbench import spans as sp  # noqa: E402
from gpbench.trace import SPANS  # noqa: E402

REPORT: dict = {}


class _Timed:
    """A callable that adds its own seconds and calls to ``acc``."""

    def __init__(self, fn, acc: list):
        self.fn, self.acc = fn, acc

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.acc[0] += time.perf_counter() - t0
            self.acc[1] += 1


def _waits() -> dict:
    from gigapaxos_tpu_torch.obs.metrics import registry

    return {dict(h.labels)["stage"]: (h.count, h.total)
            for h in registry().find("request_wait_seconds")
            if dict(h.labels).get("plane") == "gpbench"}


class ProbeRun(harness.Run):
    def build(self) -> None:
        from gigapaxos_tpu_torch.obs import phase

        super().build()
        m = self.m
        self.cost = {k: [0.0, 0] for k in ("timers", "waits", "gc_hook")}
        if isinstance(m._dt, phase.DeviceTimers):
            for name in ("start", "stop", "poll"):
                setattr(m._dt, name, _Timed(getattr(m._dt, name),
                                            self.cost["timers"]))
        m._observe_wait = _Timed(m._observe_wait, self.cost["waits"])
        for i, cb in enumerate(gc.callbacks):
            if cb is phase._gc_hook:
                gc.callbacks[i] = _Timed(cb, self.cost["gc_hook"])

    def window(self) -> None:
        for v in self.cost.values():
            v[0], v[1] = 0.0, 0
        w0, adm0 = _waits(), self.ledger.n_admitted
        ts0 = time.perf_counter()
        super().window()
        ts1 = time.perf_counter()
        w1 = _waits()
        # the acknowledgements between the two readings of the waits
        led, n = self.ledger, max(1, self.window_ticks)
        acked = ((led.t_ack[:led.top] >= ts0)
                 & (led.t_ack[:led.top] < ts1))
        d = {k: (w1[k][0] - w0.get(k, (0, 0.0))[0],
                 w1[k][1] - w0.get(k, (0, 0.0))[1]) for k in w1}
        lat = (led.t_ack[:led.top] - led.t_prop[:led.top])[acked]
        due = (led.t_ack[:led.top] - led.t_due[:led.top])[acked]
        late = (led.t_prop[:led.top] - led.t_due[:led.top])[acked]
        REPORT["window"] = {
            "ticks": self.window_ticks,
            "acked": int(acked.sum()),
            "order_count": d.get("order", (0, 0))[0],
            "queue_count": d.get("queue", (0, 0))[0],
            "queue_ms": _mean_ms(d.get("queue")),
            "order_ms": _mean_ms(d.get("order")),
            "propose_to_ack_ms": float(lat.mean() * 1e3) if lat.size else None,
            "due_to_ack_p50_ms": (float(np.median(due) * 1e3)
                                  if due.size else None),
            "due_to_propose_ms": (float(late.mean() * 1e3)
                                  if late.size else None),
            "admitted_per_tick": (led.n_admitted - adm0) / n,
        }
        self.cost_window = {k: (v[0], v[1]) for k, v in self.cost.items()}

    def _end_slice(self, sl) -> None:
        from gigapaxos_tpu_torch.obs import phase

        super()._end_slice(sl)
        if self.device.type != "cuda":
            return
        dev, host = sp.profile_records(sl.prof, SPANS)
        t_lo = min([s for _, s, _ in host] + [s for s, _ in dev])
        prog = [(n, s, e) for n, s, e, _ in phase.take_spans() if e > t_lo]
        rep = sp.idle_report(dev, host + prog)
        copies = _copies(sl.prof)
        ticks = max(1, self.slice_ticks)
        rep["profiler_copy_ms_per_tick"] = {k: v / ticks * 1e3
                                            for k, v in copies["sum"].items()}
        rep["timer_ms"] = {p: sp.mean_ms("tick_device_seconds",
                                         plane="gpbench", part=p)
                           for p in ("upload", "tick", "copy")}
        rep["phase_ms"] = {k: v[1] / max(1, v[0]) * 1e3
                           for k, v in self.slice_ph.items()}
        rep["tally"] = _tally_split(prog, copies["iv"], dev, ticks)
        rep["ticks"] = self.slice_ticks
        REPORT["slice"] = rep

    def drain(self) -> None:
        super().drain()
        n = max(1, self.window_ticks)
        cost = {k: {"ms_per_tick": s / n * 1e3, "calls": c}
                for k, (s, c) in self.cost_window.items()}
        cost["stamp_est"] = {"ms_per_tick": _stamp_s(self.m)
                             * REPORT["window"]["admitted_per_tick"] * 1e3}
        cost["switch_est"] = {"ms_per_tick": _switch_s() * 1e3}
        cost["total_ms_per_tick"] = sum(v["ms_per_tick"]
                                        for v in cost.values())
        turns = np.array(self.turns)
        cost["turn_ms_mean"] = float(turns.mean() * 1e3) if turns.size else 0
        REPORT["cost"] = cost


def _mean_ms(ct):
    return ct[1] / ct[0] * 1e3 if ct and ct[0] else None


def _stamp_s(m) -> float:
    """Seconds a request's admission stamp takes, in blocks of 100,000
    slots of the run's store (an admission stamps its block's run of
    slots)."""
    t, n = m.bulk.t_stage, 100_000
    t0 = time.perf_counter()
    for k in range(20):
        t[k * n:(k + 1) * n] = time.perf_counter()
    return (time.perf_counter() - t0) / 20 / n


def _switch_s() -> float:
    """Seconds of the span switch's work in one tick of one clock."""
    from gigapaxos_tpu_torch.obs import phase

    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        phase.refresh_recording()
    return (time.perf_counter() - t0) / n


def _copies(prof) -> dict:
    from torch.autograd import DeviceType

    out = {"sum": {}, "iv": []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        for k in ("DtoH", "HtoD"):
            if f"Memcpy {k}" in name:
                out["sum"][k] = out["sum"].get(k, 0.0) + e.duration_ns() / 1e9
                if k == "DtoH":
                    out["iv"].append((e.start_ns(),
                                      e.start_ns() + e.duration_ns()))
    return out


def _tally_split(prog, dtoh, dev, ticks) -> dict:
    """Per tick, milliseconds of the host's ``modea.tally`` spans during
    which the device copied to the host, ran anything else, or was idle."""
    tally = [(s, e) for n, s, e in prog if n == "modea.tally"]
    cp = np.array(sorted(dtoh), np.int64).reshape(-1, 2)
    iv = np.array(sorted(dev), np.int64).reshape(-1, 2)

    def covered(a, b, arr):
        if not len(arr):
            return 0
        sel = arr[(arr[:, 0] < b) & (arr[:, 1] > a)]
        if not len(sel):
            return 0
        s = np.clip(sel[:, 0], a, b)
        e = np.clip(sel[:, 1], a, b)
        # union of the clipped intervals
        order = np.argsort(s)
        s, e = s[order], np.maximum.accumulate(e[order])
        tot, cur_s, cur_e = 0, s[0], e[0]
        for x, y in zip(s[1:].tolist(), e[1:].tolist()):
            if x > cur_e:
                tot += cur_e - cur_s
                cur_s, cur_e = x, y
            else:
                cur_e = max(cur_e, y)
        return tot + cur_e - cur_s

    tot = cp_t = busy = 0
    for a, b in tally:
        tot += b - a
        cp_t += covered(a, b, cp)
        busy += covered(a, b, iv)
    k = 1e-6 / ticks
    return {"tally_ms": tot * k, "copy_ms": cp_t * k,
            "other_device_ms": (busy - cp_t) * k,
            "device_idle_ms": (tot - busy) * k}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir = None
    if "--out" in argv:
        i = argv.index("--out")
        out_dir = Path(argv[i + 1])
        del argv[i:i + 2]
    from gpbench import run as runmod

    harness.Run = ProbeRun
    rc = runmod.main(argv)
    line = json.dumps(REPORT)
    print(f"probe {line}", file=sys.stderr, flush=True)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        cell = argv[argv.index("--workload") + 1]
        seed = argv[argv.index("--seed") + 1]
        (out_dir / f"{cell}-{seed}.json").write_text(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
