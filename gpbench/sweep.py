"""Finds the highest open-loop rate a configuration sustains, once, on the
card: one process, one deployment, rungs of 10 s from 50,000 requests/s,
each 1.5 times the last.

A rung is sustained when at least 90% of the requests due in it are
acknowledged inside it, the backlog (admitted, not yet acknowledged) does
not grow across it (its mean over the rung's last quarter exceeds that
over its second quarter by less than one loop turn's arrivals), and its
95th-percentile commit latency is at most four times the loop turn of
the lowest rung.  The sweep stops at the first rung
that is not; where the first is not, it steps down by the same factor to
the first rung that is.  It writes every rung to ``gpbench/sweeps/<config>.json``;
the open cells' rate is four fifths of the highest sustained rung.

    python3 gpbench/sweep.py --workload counter-1m-r3.open --seed 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

#: the first rung (the upstream probe's PROBE_INIT_LOAD), the factor from
#: one rung to the next, a rung's seconds, and the most rungs
START, STEP, RUNG_S, MAX_RUNGS = 50_000.0, 1.5, 10.0, 12


def rung_stats(run, w0: float, w1: float, inflight) -> dict:
    import numpy as np

    from gpbench.latency import nearest_rank

    led = run.ledger
    adm = led.admitted()
    due = led.t_due[adm]
    sel = adm[(due >= w0) & (due < w1)]
    ack = led.t_ack[sel]
    in_time = int((ack < w1).sum())
    lat = np.where(np.isnan(ack), np.inf, ack - led.t_due[sel])
    p50 = nearest_rank(lat, 0.50) * 1e3 if len(lat) else None
    p95 = nearest_rank(lat, 0.95) * 1e3 if len(lat) else None
    q = len(inflight) // 4
    growth = (float(np.mean(inflight[-q:]) - np.mean(inflight[q:2 * q]))
              if q else None)
    return {"offered": int(len(sel)), "acked_in_rung": in_time,
            "acked_share": in_time / max(1, len(sel)),
            "p50_ms": p50, "p95_ms": p95, "backlog_growth": growth}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gpbench import traffic as tr
    from gpbench.harness import Run
    from gpbench.run import load_spec

    bench, entry, config, mix, cell = load_spec(HERE.parent, args.workload)
    if mix["loop"] != "open":
        raise SystemExit("the sweep drives an open-loop cell")
    if not torch.cuda.is_available():
        raise SystemExit("the sweep measures the card: no CUDA card")
    card = torch.cuda.get_device_name(0)
    run = Run(torch, torch.device("cuda"), config, dict(mix, rate=START),
              cell, args.seed, RUNG_S, False)
    run.build()
    run.warm()
    rungs, rate, turn0, down = [], START, None, False
    for k in range(MAX_RUNGS):
        run.arrivals = tr.Arrivals(rate, args.seed + 1000 * k)
        run.t_load = time.perf_counter()
        t0, t1 = run.t_load, run.t_load + RUNG_S
        ticks0, inflight = run.ticks, []
        while time.perf_counter() < t1:
            run._feed(time.perf_counter())
            run._tick()
            inflight.append(run.ledger.in_flight())
        turn_ms = RUNG_S / max(1, run.ticks - ticks0) * 1e3
        s = rung_stats(run, t0, t1, np.array(inflight, float))
        if turn0 is None or down:
            turn0 = turn_ms  # this rung is the lowest so far
        s.update(rate=rate, loop_turn_ms=turn_ms,
                 p95_limit_ms=4 * turn0)
        s["backlog_limit"] = rate * turn_ms / 1e3
        s["sustained"] = bool(s["acked_share"] >= 0.9
                              and (s["backlog_growth"] or 0)
                              <= s["backlog_limit"]
                              and s["p95_ms"] is not None
                              and s["p95_ms"] <= 4 * turn0)
        rungs.append(s)
        print(json.dumps(s), flush=True)
        # let the backlog drain before the next rung
        limit = time.perf_counter() + 30
        while run.ledger.in_flight() and time.perf_counter() < limit:
            run._tick()
        # up while rungs hold; below the first rung while none has
        if len(rungs) == 1 and not s["sustained"]:
            down = True
        elif s["sustained"] == down:
            break
        rate = rate / STEP if down else rate * STEP
    ok = [r["rate"] for r in rungs if r["sustained"]]
    out = {"workload": args.workload, "config": entry["config"],
           "card": card, "seed": args.seed, "rungs": rungs,
           "highest_sustained": max(ok) if ok else None,
           "open_rate": 0.8 * max(ok) if ok else None}
    path = HERE / "sweeps" / f"{entry['config']}.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in ("highest_sustained",
                                           "open_rate")}), flush=True)
    run.close()
    run.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
