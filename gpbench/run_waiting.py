"""Runs a cell that waits in ``gpbench/waiting/<cell>.json`` as ``run.py``
runs a cell of the benchmark: the same options, the same lines on
standard error and the same result line.

    python3 gpbench/run_waiting.py --workload kvwal-128k-r3.crash \
        --seed <n> --seconds <s> --trace <0|1>

A cell waits there, outside ``BENCHMARK.json``, until the program can pass
it (its file's ``waits_for`` says what for).  Its entries are read as if
``BENCHMARK.json`` held them, with the ``workloads`` lists of the metrics
it shares lengthened as its ``add_to_workloads`` says.  A cell whose file
under ``gpbench/workloads/`` has a ``crash`` entry runs as
``gpbench/crash.py::CrashRun`` and is compared by
``gpbench/reference/crash.py``; ``--fault`` takes the crash controls
(``crash.FAULTS``) besides those of ``faults.py``.

``run.py`` and the modules it imports stay as they are, so the cells of
``BENCHMARK.json`` run the code they ran: in this process only, the names
that ``run.main`` looks up when it runs (``load_spec``, ``compare``,
``harness.Run``, ``faults.install``, ``trace.SPANS``) are set to the
waiting cell's."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from gpbench import run as base  # noqa: E402  (its clock starts set-up)

_SECTIONS = ("configs", "workloads", "end_to_end", "per_layer")


def with_waiting(bench: dict, cell: str) -> dict:
    """``bench`` (a BENCHMARK.json) with the entries of
    ``gpbench/waiting/<cell>.json`` added."""
    w = json.loads((HERE / "waiting" / f"{cell}.json").read_text())
    out = copy.deepcopy(bench)
    for k in _SECTIONS:
        out[k] = out[k] + w[k]
    for m in out["end_to_end"] + out["per_layer"]:
        add = w["add_to_workloads"].get(m["name"], [])
        if add:
            m["workloads"] = m.get("workloads", []) + add
    return out


def load_spec(root: Path, cell_name: str):
    """``run.load_spec`` over BENCHMARK.json with the waiting cell's
    entries."""
    from gpbench import traffic as tr

    if not (HERE / "waiting" / f"{cell_name}.json").exists():
        base._fail(f"no workload {cell_name!r} waits in gpbench/waiting")
    bench = with_waiting(json.loads((root / "BENCHMARK.json").read_text()),
                         cell_name)
    w = {c["name"]: c for c in bench["workloads"]}[cell_name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / confs[w["config"]]["file"]).read_text())
    mix = tr.load(HERE / "traffic" / f"{w['traffic']}.json")
    cell = json.loads((HERE / "workloads" / f"{cell_name}.json").read_text())
    return bench, w, config, mix, cell


def compare_crash(run, state) -> dict:
    """``run.compare`` for a crash cell: the ledger's acknowledgement
    counts, then ``reference/crash.py``; writes the crash's line to
    standard error."""
    import numpy as np

    from gpbench.reference import crash as ref

    led = run.ledger
    adm = led.admitted()
    n = led.n_ack[:led.top]
    known = np.zeros(led.top, bool)
    known[adm] = True
    out = {"acks_missing": int((n[adm] == 0).sum()),
           "acks_dup": int((n[adm] > 1).sum()),
           "acks_unknown": int((n[~known] > 0).sum()),
           "acks_failed": int(sum(len(f) for f in led.failed))}
    out.update(ref.compare(run, state))
    c = run.crash
    first = c["first_ack"] if c["first_ack"] is not None else float("nan")
    print(f"gpbench: crash at={c['t_crash'] - run.w0:.3f}s "
          f"recover_s={first - c['t_down']:.6f} "
          # the harness's own power loss, left out of recover_s
          f"collect_ms={(c['t_collected'] - c['t_crash']) * 1e3:.3f} "
          f"cut_ms={(c['t_down'] - c['t_collected']) * 1e3:.3f} "
          f"enter_ms={(c['t_enter'] - c['t_down']) * 1e3:.3f} "
          f"restore_ms={(c['t_begin'] - c['t_enter']) * 1e3:.3f} "
          f"replay_ms={(c['t_finish'] - c['t_begin']) * 1e3:.3f} "
          f"attach_ms={(c['t_back'] - c['t_finish']) * 1e3:.3f} "
          f"first_ack_ms={(first - c['t_back']) * 1e3:.3f} "
          f"tick_records={c['tick_records']} "
          f"last_tick={c['last_tick']} cut_bytes={c['cut_bytes']} "
          f"answered_after={c['answered_after']} resent={c['resent']} "
          f"resent_durable={c['resent_durable']}",
          file=sys.stderr)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    name = ap.parse_known_args(argv)[0].workload
    base.load_spec = load_spec
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text()) \
        if (HERE / "workloads" / f"{name}.json").exists() else {}
    if cell.get("crash"):
        from gpbench import crash, faults, harness, trace

        harness.Run = crash.CrashRun
        base.compare = compare_crash
        trace.SPANS = trace.SPANS + crash.SPANS
        install = faults.install

        def install_crash(fault: str, run) -> None:
            if fault in crash.FAULTS:
                run.fault = fault
            else:
                install(fault, run)

        faults.install = install_crash
    return base.main(argv)


if __name__ == "__main__":
    sys.exit(main())
