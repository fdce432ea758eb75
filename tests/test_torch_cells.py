"""Serving-cell twin: a two-cell ``CellSupervisor`` of each package, its
workers spawned as processes (the port's with ``device="cpu"``), driven
through the same scenario — the reference's ``tests/test_cells.py``
two-cell smoke, one cross-cell migration, a SIGKILL of a cell and its WAL
replay under the S1 ledger, and the cell half of
``tests/test_obs_scrape.py`` (the host scrape, a trace across the edge
hop, the flight recorder a SIGKILLed cell leaves) — plus the cells config
checks.

Tolerance: 0.  Responses, groups per cell, every cell's DB dump before and
after the kill, the restarted cell's dump against the one taken before the
kill, the migration's routing and the scrape's and trace's verdicts are
equal between the packages; the S1 ledger over both incarnations of the
killed cell is clean in each.  Times are not compared.
"""

import os
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu.cells import migrator as jmigrator
from gigapaxos_tpu.cells import supervisor as jsupervisor
from gigapaxos_tpu.obs import flight as jflight
from gigapaxos_tpu.reconfiguration import packets as jpkt
from gigapaxos_tpu.testing import chaos as jchaos
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch.cells import migrator as tmigrator
from gigapaxos_tpu_torch.cells import supervisor as tsupervisor
from gigapaxos_tpu_torch.obs import flight as tflight
from gigapaxos_tpu_torch.reconfiguration import packets as tpkt
from gigapaxos_tpu_torch.testing import chaos as tchaos

PKGS = {
    "ref": SimpleNamespace(config=jconfig, sup=jsupervisor, mig=jmigrator,
                           flight=jflight, pkt=jpkt, chaos=jchaos, kw={}),
    "port": SimpleNamespace(config=tconfig, sup=tsupervisor, mig=tmigrator,
                            flight=tflight, pkt=tpkt, chaos=tchaos,
                            kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_supervisor(P, base_dir, **kw):
    cc = P.config.CellsConfig(enabled=True, n_cells=2, n_actives=3,
                              n_reconfigurators=1, pin_cores=False,
                              restart_backoff_s=0.2)
    sup = P.sup.CellSupervisor(str(base_dir), cells=cc,
                               paxos_overrides={"max_groups": 16}, **kw,
                               **P.kw)
    for spec in sup.specs.values():
        spec.stats_interval_s = 0.5  # stats snapshots into the flight ring
    return sup


def served(client, name, payload, limit=120.0):
    """``payload``'s response once ``name``'s cell serves again: a request
    sent into a killed incarnation's connection is lost and retried only
    when its try times out, so the tries are short."""
    deadline = time.monotonic() + limit
    while True:
        try:
            return client.request(name, payload, timeout=3)
        except Exception:
            if time.monotonic() > deadline:
                raise


def _scrape_verdicts(body):
    lines = body.splitlines()
    return {
        "cell_phases": [any(f'cell="{k}"' in ln
                            and ln.startswith("tick_phase_seconds_bucket")
                            for ln in lines) for k in ("0", "1")],
        "phases": [any(f'phase="{p}"' in ln for ln in lines)
                   for p in ("intake", "dispatch", "wal_fsync", "execute")],
        "slo": [any(ln.startswith(f"commit_latency_seconds_{q}")
                    for ln in lines) for q in ("p50", "p99")],
        "planes": [any(ln.startswith(s) for ln in lines)
                   for s in ("wal_fsync_seconds_count",
                             "transport_sent_total")],
        "up": [f'cell_up{{cell="{k}",node="SUP"}} 1' in lines
               for k in ("0", "1")],
        "gauges": [any(ln.startswith(s) for ln in lines)
                   for s in ('cell_restarts_total{cell="0"',
                             "supervisor_restart_backoff_seconds")],
        "one_type_line": sum(ln.startswith("# TYPE tick_phase_seconds ")
                             for ln in lines),
    }


def _trace_verdicts(P, sup, c, names):
    ec = sup.make_client()
    try:
        ec.trace.enabled = True
        ec.nodemap.add("EDGE", sup.edge_addr[0], int(sup.edge_addr[1]))
        got = []
        for n in names:
            done, box = threading.Event(), {}
            ec.send_request(n, f"GET k.{n}".encode(),
                            lambda p, box=box, done=done: (box.update(p),
                                                           done.set()),
                            active="EDGE")
            assert done.wait(60), f"edge request for {n} timed out"
            got.append(P.pkt.b64d(box.get("response")))
        flat = [(ev[0], ev[2]) for evs in sup.trace().values()
                for ev in evs]
        return [got, ("SUP", "client_sent") in flat,
                ("SUP", "client_responded") in flat,
                any(o.startswith("c") and s == "ar_recv" for o, s in flat),
                any(s == "edge_forward" for _o, s in flat)]
    finally:
        ec.close()


def run_scenario(P, base):
    """The whole two-cell scenario on one package; -> its record, the
    pre-kill and post-restart ledgers."""
    out = {}
    sup = make_supervisor(P, base, ledger=True, edge=True,
                          http_port=0).start()
    try:
        c = sup.make_client()
        names = [f"s{i}" for i in range(6)]
        out["create"] = [c.create(n).get("ok") for n in names]
        out["put"] = [c.request(n, f"PUT k.{n} v{i}".encode())
                      for i, n in enumerate(names)]
        out["get"] = [c.request(n, f"GET k.{n}".encode()) for n in names]
        out["owners"] = [sup.router.cell(n) for n in names]
        out["groups"] = {k: h.stats()["groups"]
                         for k, h in sorted(sup.cells.items())}
        # one name to the other cell
        src = sup.router.cell("s1")
        out["migrate"] = [P.mig.CellMigrator(sup).migrate("s1", 1 - src),
                          sup.router.cell("s1") == 1 - src,
                          c.request("s1", b"GET k.s1"),
                          c.request("s1", b"PUT k.s1 moved"),
                          any(k.startswith("s1#")
                              for k in sup.cells[1 - src].db())]
        with urllib.request.urlopen(sup.metrics_server.url + "/metrics",
                                    timeout=60) as r:
            out["scrape"] = _scrape_verdicts(r.read().decode())
        picks = {}
        for n in names[:1] + names[2:]:  # one unmoved name a cell
            picks.setdefault(sup.router.cell(n), n)
        out["trace"] = _trace_verdicts(P, sup, c, sorted(picks.values()))

        # drain, dump, SIGKILL the cell s1 moved to (its replay repeats
        # the journaled targeted create with its seed) under the chaos
        # runner.  (The source cell's live app keeps the dropped epoch's
        # entry, which its replay would not: a remove's documented
        # difference between a live manager and its recovery.)
        for h in sup.cells.values():
            assert h.rpc("drain", "drained ", 60).endswith("ok")
        out["dbs_before_kill"] = {k: h.db()
                                  for k, h in sorted(sup.cells.items())}
        victim = 1 - src
        vh = sup.cells[victim]
        pre_db = [vh.db(r) for r in range(3)]
        pre_ledger = vh.ledger()
        fpath = vh.flight_path
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:  # a stats snapshot on disk
            if os.path.exists(fpath) and any(
                    e["kind"] == "stats"
                    for e in P.flight.FlightRecorder.read(fpath)["events"]):
                break
            time.sleep(0.1)
        sched = P.chaos.ChaosSchedule("cell-kill", [P.chaos.ChaosEvent(
            at_tick=0, action="crash", args={"node": f"c{victim}"})])
        log = P.chaos.ProcChaosRunner({f"c{victim}": vh}, sched,
                                      tick_s=0.01).run()
        doc = P.flight.FlightRecorder.read(fpath)
        kinds = {e["kind"] for e in doc["events"]}
        out["flight"] = [not vh.alive(),
                         [r["info"]["flight"] == fpath for r in log.records
                          if r["action"] == "crash"],
                         doc["node"] == f"c{victim}", "boot" in kinds,
                         "stats" in kinds]
        nh = sup.wait_cell_alive(victim, 300)
        out["restarts"] = dict(sup.restarts)
        out["replayed_equal"] = [nh.db(r) for r in range(3)] == pre_db
        out["after"] = [served(c, n, f"PUT k2.{n} w".encode())
                        for n in names]
        out["after_get"] = [served(c, n, f"GET k.{n}".encode())
                            for n in names]
        for h in sup.cells.values():
            assert h.rpc("drain", "drained ", 60).endswith("ok")
        out["dbs_end"] = {k: h.db() for k, h in sorted(sup.cells.items())}
        post_ledger = sup.cells[victim].ledger()
        c.close()
    finally:
        sup.stop()
    out["stopped"] = all(not h.alive() for h in sup.cells.values())
    return out, pre_ledger, post_ledger


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {k: run_scenario(P, tmp_path_factory.mktemp(f"cells_{k}"))
            for k, P in PKGS.items()}


def same(runs, key):
    ref, port = runs["ref"][0][key], runs["port"][0][key]
    assert ref == port, key
    return port


def test_two_cell_smoke(runs):
    assert same(runs, "create") == [True] * 6
    assert same(runs, "put") == [b"OK"] * 6
    assert same(runs, "get") == [f"v{i}".encode() for i in range(6)]
    owners = same(runs, "owners")
    assert same(runs, "groups") == {k: owners.count(k) for k in (0, 1)}
    assert same(runs, "stopped") is True


def test_cell_migration_moves_group_and_serving_continues(runs):
    assert same(runs, "migrate") == [True, True, b"v1", b"OK", True]


def test_supervisor_host_scrape_two_cells(runs):
    v = same(runs, "scrape")
    assert all(all(x) for k, x in v.items() if k != "one_type_line")
    assert v["one_type_line"] == 1


def test_trace_propagates_across_cell_forwarding(runs):
    v = same(runs, "trace")
    assert all(v[1:]) and all(r is not None for r in v[0])


def test_cell_sigkill_replay_and_s1(runs):
    """The killed cell's restart replays its WAL to the DB dump taken
    before the kill, in both packages; every cell's dump equals the
    reference's before the kill and at the end; S1 holds over both
    incarnations of the killed cell."""
    assert "s1#1" in same(runs, "dbs_before_kill")[
        same(runs, "owners")[1] ^ 1]
    assert same(runs, "replayed_equal") is True
    assert list(same(runs, "restarts").values()).count(1) == 1
    assert same(runs, "after") == [b"OK"] * 6
    assert same(runs, "after_get")[0] == b"v0"
    same(runs, "dbs_end")
    for key, (_out, pre, post) in runs.items():
        led = PKGS[key].chaos.SafetyLedger()
        for r, name, slot, rid, _stop in pre:
            led.observe(f"pre/r{r}", name, slot, rid)
        for r, name, slot, rid, _stop in post:
            led.observe(f"post/r{r}", name, slot, rid)
        assert led.observations >= len(pre) + len(post) > 0
        led.assert_safe()


def test_flight_recorder_survives_sigkill_via_chaos_runner(runs):
    assert same(runs, "flight") == [True, [True], True, True, True]


def test_cells_config_validation():
    out = {}
    for key, P in PKGS.items():
        cc = P.config.CellsConfig()
        rec = [cc.enabled, cc.n_cells, cc.n_actives, cc.n_reconfigurators,
               cc.pin_cores, cc.restart_backoff_s, cc.max_restarts]
        for bad in ({"n_cells": -1}, {"n_actives": 0},
                    {"n_reconfigurators": 0}):
            with pytest.raises(ValueError) as e:
                P.config.CellsConfig(**bad)
            rec.append(str(e.value))
        out[key] = rec
    assert out["ref"] == out["port"]
    assert out["port"][:2] == [False, 0]


def test_supervisor_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsupervisor.CellSupervisor(str(tmp_path),
                                   cells=tconfig.CellsConfig(n_cells=1))
