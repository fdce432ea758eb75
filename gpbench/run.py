"""Runs one benchmark cell once and prints one JSON result line.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``gpbench/configs/<config>.json``) and a traffic mix
(``gpbench/traffic/<traffic>.json``), and ``gpbench/workloads/<cell>.json``
holds its warm-up, traced slice and the limits of its comparisons.  A
metric named in ``BENCHMARK.json`` is read by ``gpbench/metrics/<name>.py``
or, for a name with a dot, by the module named by the part before the
first dot; each has ``read(ctx)`` and returns a number or None.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read over a profiled slice of the
window.  Every run compares what the served path produced with the plain
reference in ``gpbench/reference`` once the window has closed; the numbers
compared, each beside its limit, close standard error and the result line.

The run needs a CUDA card (``--device cpu`` is for the CPU tests) and
exits non-zero, printing no result, without one, or if JAX or the JAX
package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "gigapaxos_tpu")


def _fail(msg: str, code: int = 2):
    print(f"gpbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_spec(root: Path, cell_name: str):
    """(BENCHMARK.json, its cell entry, config, mix, cell file)."""
    from gpbench import traffic as tr

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        _fail(f"no workload {cell_name!r} in BENCHMARK.json")
    w = cells[cell_name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / confs[w["config"]]["file"]).read_text())
    mix = tr.load(HERE / "traffic" / f"{w['traffic']}.json")
    cell = json.loads((HERE / "workloads" / f"{cell_name}.json").read_text())
    return bench, w, config, mix, cell


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``, else of the module named by the
    part of ``name`` before its first dot."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"gpbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for the metric {name!r}")


def metrics_of(bench, cell_name: str, trace: bool):
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_loaded():
    return sorted({k.split(".", 1)[0] for k in sys.modules}
                  & set(FORBIDDEN))


class Ctx:
    """What the metric readers see."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the CPU tests and the control runs only
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--groups", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    bench, entry, config, mix, cell = load_spec(ROOT, args.workload)
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")

    import numpy as np
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA card")
        if torch.cuda.device_count() < int(entry["chips"]):
            _fail(f"{entry['chips']} cards wanted, "
                  f"{torch.cuda.device_count()} found")
        card = torch.cuda.get_device_name(0)
        from gpbench.kernels import peak_bandwidth

        peak_bw = peak_bandwidth(card)  # an unknown card fails the run
        torch.cuda.reset_peak_memory_stats()
    else:
        card, peak_bw = "cpu", None
    device = torch.device(args.device)

    from gpbench import faults
    from gpbench.harness import Run

    run = Run(torch, device, config, mix, cell, args.seed, args.seconds,
              bool(args.trace), groups=args.groups)
    t_build = time.perf_counter()
    run.build()
    if args.fault:
        faults.install(args.fault, run)
    run.warm()
    setup_s = time.perf_counter() - T_START
    run.window()
    run.drain()
    mem_peak = (torch.cuda.max_memory_allocated() if args.device == "cuda"
                else 0)
    led = run.ledger
    state = run.app.program_state(run.m)
    run.close()

    bad = forbidden_loaded()
    if bad:
        _fail(f"loaded after the window: {', '.join(bad)}", 3)

    # the program's state is on the host now: free the device's
    dims = (run.R, run.m.W, run.G, run.m.P)
    run.m = None
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = compare(run, state)
    t_ref = time.perf_counter() - t_ref
    limits = cell["limits"]
    missing = sorted(set(checks) - set(limits))
    if missing:
        _fail(f"no limit set for {missing}")
    correct = all(checks[k] <= limits[k] for k in checks)
    journal_bytes = run.journal_bytes()
    run.cleanup()

    ctx = Ctx()
    ctx.config, ctx.mix, ctx.cell, ctx.ledger = config, mix, cell, led
    ctx.R, ctx.W, ctx.G, ctx.P = dims
    ctx.w0, ctx.w1, ctx.setup_s, ctx.peak_bw = run.w0, run.w1, setup_s, \
        peak_bw
    ctx.refused_due_in_window = _refused_due_in_window(led, run)
    ctx.gave_up = run.gave_up
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": card, "count": int(entry["chips"]),
              "memory_peak_bytes": int(mem_peak)}
    breakdown = None
    if args.trace:
        ctx.slice_s = run.slice_t1 - run.slice_t0
        ctx.slice_ticks = run.slice_ticks
        ctx.slice_phases = run.slice_ph
        ctx.slice_launches = run.slice_launch
        s = run.slice.summary() if args.device == "cuda" else None
        ctx.device_busy_s = s["busy_s"] if s else None
        ctx.device_by_name = s["by_name"] if s else {}
        device["busy_s"] = ctx.device_busy_s or 0.0
        device["window_s"] = ctx.slice_s
        if s:
            top = sorted(s["by_name"].items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[k, v] for k, v in top],
                         "idle_gaps": [[k, v] for k, v in s["gaps"]]}

    metrics = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    window = run.w1 - run.w0
    in_win = _window_requests(led, run)
    steps = " ".join(f"{k}={v:.3f}" for k, v in run.setup_steps.items())
    tq = np.percentile(np.array(run.turns) * 1e3, [10, 50, 90, 99]) \
        if run.turns else []
    print("gpbench: turn_ms p10/50/90/99 "
          + "/".join(f"{x:.1f}" for x in tq), file=sys.stderr)
    print(f"gpbench: setup imports_s={t_build - T_START:.3f} {steps}",
          file=sys.stderr)
    print(f"gpbench: {args.workload} seed={args.seed} window={window:.3f}s "
          f"ticks={run.window_ticks} admitted={in_win['admitted']} "
          f"acked={led.acked_between(run.w0, run.w1)} "
          f"refused={in_win['refused']} setup={setup_s:.3f}s "
          f"generator_late_p95_ms={_late_p95(run):.3f} "
          f"reference_s={t_ref:.3f} journal_bytes={journal_bytes}",
          file=sys.stderr)
    wt = max(1, run.window_ticks)
    print("gpbench: window "
          + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in {**run.window_usage,
                                  **run.window_gc}.items())
          + " phase_ms_per_tick "
          + " ".join(f"{k}={v[1] / wt * 1e3:.2f}"
                     for k, v in sorted(run.window_phases.items())),
          file=sys.stderr)
    for k in checks:
        print(f"check {k} {checks[k]} limit {limits[k]}", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": bool(correct), "attempted": in_win["attempted"],
              "failed": in_win["failed"], "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in checks}
    print(json.dumps(result), flush=True)
    return 0


def compare(run, state) -> dict:
    """Every number compared with the reference, by name."""
    import numpy as np

    led = run.ledger
    adm = led.admitted()
    n = led.n_ack[:led.top]
    known = np.zeros(led.top, bool)
    known[adm] = True
    out = {"acks_missing": int((n[adm] == 0).sum()),
           "acks_dup": int((n[adm] > 1).sum()),
           "acks_unknown": int((n[~known] > 0).sum()),
           "acks_failed": int(sum(len(f) for f in led.failed))}
    group = led.group[adm]
    if run.app.kind == "counter":
        from gpbench.reference import counter

        out.update(counter.compare(
            run.G, group, led.delta[adm], state["acc"][:, run.rows],
            state["count"][:, run.rows]))
    else:
        from gpbench.reference import kv

        out.update(kv.compare(led, run.rows, state["exec"], state["key"],
                              state["val"]))
    if run.wal_dir is not None:
        from gpbench.reference import journal

        out.update(journal.compare(run.wal_dir, led))
    return out


def _window_requests(led, run) -> dict:
    """Requests of the window: for a closed loop those proposed in it, for
    an open loop those due in it; failed = refused or never acknowledged."""
    import numpy as np

    adm = led.admitted()
    t = led.t_due[adm] if run.arrivals is not None else led.t_prop[adm]
    sel = adm[(t >= run.w0) & (t < run.w1)]
    unacked = int((led.n_ack[sel] == 0).sum())
    refused = (len(_refused_due_in_window(led, run))
               if run.arrivals is not None else run.refused_in_window)
    return {"admitted": int(len(sel)), "refused": refused,
            "attempted": int(len(sel)) + refused,
            "failed": refused + unacked}


def _refused_due_in_window(led, run):
    """Due times of the open-loop requests refused that were due in the
    window."""
    import numpy as np

    rd = (np.concatenate(led.refused_due) if led.refused_due
          else np.zeros(0))
    return rd[(rd >= run.w0) & (rd < run.w1)]


def _late_p95(run) -> float:
    """How late the open-loop generator proposed, p95 in ms (0 for a closed
    loop, whose requests are due when proposed)."""
    import numpy as np

    if run.arrivals is None:
        return 0.0
    led = run.ledger
    adm = led.admitted()
    sel = adm[(led.t_due[adm] >= run.w0) & (led.t_due[adm] < run.w1)]
    if not len(sel):
        return 0.0
    return float(np.percentile(led.t_prop[sel] - led.t_due[sel], 95)) * 1e3


if __name__ == "__main__":
    sys.exit(main())
