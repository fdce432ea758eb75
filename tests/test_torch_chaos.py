"""Chaos plane twin: the port's ``testing/chaos.py`` against the reference's,
on the CPU.

Every case of the reference's ``tests/test_chaos.py``, the ring-crash
schedule of ``tests/test_digest_soak.py:74`` and a durable coordinator
crash with real ``recover_modeb`` restarts run once over the reference's
``SimNet`` and ``ModeBNode``s and once over the port's, from the same seed
and schedule.  The applied-event logs, the proposals' responses, the
safety ledgers and the nodes' DBs must be equal (tolerance 0); the durable
run's journal and snapshot files must be byte-equal.  The port's
``testing/faultdisk.py`` planned-journal half is held against the
reference's on the same plan file.
"""

import json
import os
import random

import pytest
import torch

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.modeb import ModeBLogger as JLogger
from gigapaxos_tpu.modeb import ModeBNode as JNode
from gigapaxos_tpu.modeb import recover_modeb as jrecover
from gigapaxos_tpu.testing import chaos as jchaos
from gigapaxos_tpu.testing import faultdisk as jfd
from gigapaxos_tpu.testing.simnet import SimNet as JNet
from gigapaxos_tpu.wal import logger as jwal
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.modeb import ModeBLogger as TLogger
from gigapaxos_tpu_torch.modeb import ModeBNode as TNode
from gigapaxos_tpu_torch.modeb import recover_modeb as trecover
from gigapaxos_tpu_torch.testing import chaos as tchaos
from gigapaxos_tpu_torch.testing import faultdisk as tfd
from gigapaxos_tpu_torch.testing.simnet import SimNet as TNet
from gigapaxos_tpu_torch.wal import logger as twal
from test_torch_modeb import cross_recover_dirs, wal_files

IDS = ["N0", "N1", "N2"]
#: (config, app, node, logger, recover, SimNet, chaos, node kwargs) per
#: package
PKGS = {
    "jax": (jconfig, jrep.KVApp, JNode, JLogger, jrecover, JNet, jchaos, {}),
    "torch": (tconfig, trep.KVApp, TNode, TLogger, trecover, TNet, tchaos,
              {"device": "cpu"}),
}


def _cfg(config):
    cfg = config.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    cfg.paxos.window = 8
    return cfg


#: ``build``'s settings (no digests, classical election) and apps, for
#: recovering one of its nodes in either package
CFGS = (_cfg(jconfig), _cfg(tconfig))
APPS = (jrep.KVApp, trep.KVApp)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(pkg, seed=0, geo=None, placement=None, ms_per_round=30.0,
          wal_root=None, digest=False, window=8, fast=False):
    """``test_chaos.py:build`` in package ``pkg`` (optionally with a
    journal on every node, and ``restart`` recovering from it)."""
    config, App, Node, Logger, recover, Net, _, kw = PKGS[pkg]
    net = Net(seed=seed)
    cfg = _cfg(config)
    cfg.paxos.window = window
    cfg.paxos.digest_accepts = digest
    cfg.paxos.fast_reelection = fast
    apps = {n: App() for n in IDS}
    dirs = {n: str(wal_root / pkg / n) for n in IDS} if wal_root else {}
    nodes = {n: Node(cfg, IDS, n, apps[n], net.messenger(n),
                     wal=(Logger(dirs[n], native=False) if dirs else None),
                     anti_entropy_every=8, **kw) for n in IDS}
    if geo:
        net.apply_geo(geo, placement, ms_per_round=ms_per_round)
    for nd in nodes.values():
        nd.create_group("svc", [0, 1, 2])

    def restart(nid):
        nd = recover(cfg, IDS, nid, App(), dirs[nid], native=False, **kw)
        nd.attach_messenger(net.messenger(nid))
        return nd

    return net, nodes, dirs, (restart if dirs else None)


def with_traffic(sched, n=9, every=12, start=5):
    """``test_chaos.py:with_traffic``: ``n`` PUTs entering at the nodes in
    turn (the schedule's own package's ``ChaosEvent``)."""
    Event = type(sched.events[0])
    sched.events = sched.events + [
        Event(start + i * every, "propose",
              {"node": IDS[i % 3], "group": "svc",
               "payload": f"PUT k{i} v{i}"})
        for i in range(n)
    ]
    return sched


def run_both(make_sched, ticks, **build_kw):
    """Run one schedule in both packages; -> {pkg: (runner, log, nodes,
    dirs)} after holding logs, proposals, ledgers and DBs equal."""
    out = {}
    for pkg in PKGS:
        net, nodes, dirs, restart = build(pkg, **build_kw)
        sched = make_sched(PKGS[pkg][6])
        # storage faults place their damage from a seeded generator
        runner = PKGS[pkg][6].SimChaosRunner(
            net, nodes, sched, wal_dirs=dirs, restart=restart,
            rng=random.Random(7))
        log = runner.run(ticks)
        runner.ledger.assert_safe()
        out[pkg] = (runner, log, runner.nodes, dirs, net)
    (jr, jl, jn, jd, jnet), (tr, tl, tn, td, tnet) = (out["jax"],
                                                      out["torch"])
    # the logs name each package's own WAL paths
    jlog, tlog = jl.to_json(), tl.to_json()
    for nid in jd:
        jlog = jlog.replace(jd[nid], f"<wal {nid}>")
        tlog = tlog.replace(td[nid], f"<wal {nid}>")
    assert jlog == tlog
    assert json.dumps(jr.proposals, sort_keys=True) == \
        json.dumps(tr.proposals, sort_keys=True)
    assert jr.ledger.decided == tr.ledger.decided
    assert jr.ledger.observations == tr.ledger.observations
    assert jr.ledger.violations == tr.ledger.violations == []
    assert jr.failstops == tr.failstops
    assert dict(jnet.stats) == dict(tnet.stats)
    for nid in IDS:
        assert jn[nid].app.db == tn[nid].app.db, nid
        assert dict(jn[nid].stats) == dict(tn[nid].stats), nid
    return out


def dbs(nodes):
    return [nodes[n].app.db.get("svc", {}) for n in IDS]


def coordinator_sched(c, **kw):
    return with_traffic(c.coordinator_crash("N0", crash_at=30,
                                            recover_at=160, detect_after=4,
                                            **kw), n=9, every=25)


# ------------------------------------------------------ test_chaos.py cases
def test_schedule_json_roundtrip():
    for c in (jchaos, tchaos):
        sched = c.coordinator_crash("N1", crash_at=10, recover_at=50, seed=3)
        back = c.ChaosSchedule.from_json(sched.to_json())
        assert back.to_json() == sched.to_json()
        assert back.seed == 3 and back.events[0].action == "crash"
    assert jchaos.coordinator_crash("N1", 10, 50, seed=3).to_json() == \
        tchaos.coordinator_crash("N1", 10, 50, seed=3).to_json()
    out = run_both(lambda c: c.ChaosSchedule.from_json(
        c.coordinator_crash("N1", crash_at=10, recover_at=50,
                            seed=3).to_json()), 5)
    json.loads(out["torch"][1].to_json())


def test_coordinator_crash_commits_before_during_after():
    out = run_both(coordinator_sched, 300)
    runner, _, nodes, _, _ = out["torch"]
    ok = [p for p in runner.proposals if p["resp"] == "OK"]
    assert len(ok) >= 7, runner.proposals
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d


def test_replay_is_bit_identical():
    """Two runs of one (seed, schedule) in the port give the same log,
    state and proposals — and the same as the reference's run."""
    def sched(c):
        return with_traffic(c.coordinator_crash(
            "N0", crash_at=25, recover_at=120, detect_after=4), n=6,
            every=20)

    outs = []
    for _ in range(2):
        out = run_both(sched, 220, seed=11)
        runner, log, nodes, _, _ = out["torch"]
        outs.append((log.to_json(),
                     json.dumps([nodes[n].app.db for n in IDS],
                                sort_keys=True),
                     json.dumps(runner.proposals, sort_keys=True)))
    assert outs[0] == outs[1]


def test_fsync_stall_keeps_cluster_live_and_converges():
    out = run_both(lambda c: with_traffic(c.ChaosSchedule("stall", [
        c.ChaosEvent(20, "fsync_stall", {"node": "N2", "ticks": 30}),
    ]), n=8, every=10), 240)
    runner, _, nodes, _, _ = out["torch"]
    ok = [p for p in runner.proposals if p["resp"] == "OK"]
    assert len(ok) == 8, runner.proposals
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d


def test_rolling_stall_schedule_safe():
    out = run_both(lambda c: with_traffic(
        c.rolling_stall(IDS, every=40, ticks=10), n=10, every=13), 260,
        seed=5)
    d = dbs(out["torch"][2])
    assert d[0] == d[1] == d[2], d


def test_region_cut_majority_continues_and_heals():
    """The ``region_outage`` schedule on the us3 geo topology, one node a
    region: cutting eu leaves the us pair committing, healing re-admits
    it to an identical state."""
    placement = {"N0": "use", "N1": "usw", "N2": "eu"}

    def sched(c):
        s = with_traffic(c.region_outage("eu", cut_at=40, heal_at=200),
                         n=9, every=18)
        s.events = s.events + [
            c.ChaosEvent(44, "mark_down", {"node": "N2"}),
            c.ChaosEvent(200, "mark_up", {"node": "N2"}),
        ]
        return s

    out = run_both(sched, 400, geo="us3", placement=placement)
    runner, _, nodes, _, net = out["torch"]
    assert net.stats["region_cuts"] == 1
    ok = [p for p in runner.proposals if p["resp"] == "OK"]
    assert len(ok) >= 6, runner.proposals
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d


def test_proc_adapter_rejects_unsupported_actions():
    for c in (jchaos, tchaos):
        sched = c.ChaosSchedule("bad", [c.ChaosEvent(
            0, "partition", {"sides": [["A"], ["B"]]})])
        with pytest.raises(ValueError):
            c.ProcChaosRunner({}, sched)
        with pytest.raises(ValueError):
            c.ChaosSchedule("worse", [c.ChaosEvent(0, "meteor",
                                                   {})]).validate()
    assert jchaos.SIM_ACTIONS == tchaos.SIM_ACTIONS
    assert jchaos.PROC_ACTIONS == tchaos.PROC_ACTIONS


# ------------------------------------------- soaks over SimChaosRunner
def test_geo_region_loss_soak_fast_reelection():
    """``benchmarks/geo_soak.py``'s region-loss schedule, driven through
    ``SimChaosRunner`` directly: us3, one node a region, fast re-election,
    N0's region cut and healed while N1 proposes every 6 ticks; commits
    flow before, during and after the cut, and the replicas converge."""
    placement = {"N0": "use", "N1": "usw", "N2": "eu"}
    phase, detect = 60, 8

    def sched(c):
        evs = [c.ChaosEvent(phase, "cut_region", {"region": "use"}),
               c.ChaosEvent(phase + detect, "mark_down", {"node": "N0"}),
               c.ChaosEvent(2 * phase, "heal_region", {"region": "use"}),
               c.ChaosEvent(2 * phase, "mark_up", {"node": "N0"})]
        evs += [c.ChaosEvent(t, "propose",
                             {"node": "N1", "group": "svc",
                              "payload": f"PUT k{t} v{t}"})
                for t in range(2, 3 * phase, 6)]
        return c.ChaosSchedule("geo_soak_us3", evs, seed=0)

    out = run_both(sched, 4 * phase, geo="us3", placement=placement,
                   ms_per_round=10.0, fast=True)
    runner, _, nodes, _, _ = out["torch"]
    for lo, hi in ((0, phase), (phase, 2 * phase), (2 * phase, 3 * phase)):
        ok = [p for p in runner.proposals
              if p["resp"] == "OK" and lo <= p["tick"] < hi]
        assert ok, (lo, hi, runner.proposals)
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d


def test_flap_soak_fast_stays_safe():
    """``test_fast_reelection.py:232``: partition flapping with fast
    re-election on stays S1-clean and converges after the last heal."""
    def sched(c):
        s = c.partition_flap("N0", period=40, flaps=3)
        s.events = s.events + [
            c.ChaosEvent(5 + 10 * i, "propose",
                         {"node": IDS[i % 3], "group": "svc",
                          "payload": f"PUT k{i} v{i}"})
            for i in range(12)]
        return s

    out = run_both(sched, 320, seed=7, fast=True)
    runner, _, nodes, _, _ = out["torch"]
    assert len([p for p in runner.proposals if p["resp"] == "OK"]) >= 6
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d


# ------------------------------------------- test_digest_soak.py ring crash
@pytest.mark.parametrize("seed", [3, 21])
def test_ring_crash_chaos(seed):
    """Digest accepts with payloads on the relay ring N1 -> N2 -> N0; N2
    dies mid-dissemination, so N0 commits rids digest-only and fills the
    bodies through the undigest path — alike in both packages."""
    out = run_both(lambda c: c.ring_crash(
        entry="N1", victim="N2", crash_at=30, recover_at=140,
        detect_after=4, n_writes=12, every=2, seed=seed), 220, seed=seed,
        digest=True, window=4)
    runner, _, nodes, _, _ = out["torch"]
    assert sum(nd.stats["relay_payloads"] for nd in nodes.values()) > 0
    assert sum(nd.stats["undigest_fills"] for nd in nodes.values()) > 0
    ok = [p for p in runner.proposals if p["resp"] == "OK"]
    assert len(ok) >= 10, runner.proposals
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d


# ----------------------------------------------------- durable chaos runs
def test_durable_coordinator_crash_restarts_from_journal(tmp_path):
    """The coordinator-crash schedule on journaled nodes, with ``recover``
    rebuilding N0 from its own WAL through each package's
    ``recover_modeb``: equal runs, byte-equal journals."""
    out = run_both(coordinator_sched, 300, wal_root=tmp_path)
    runner, log, nodes, _, _ = out["torch"]
    rec = [r for r in log.records if r["action"] == "recover"]
    assert rec and rec[0]["info"] == {"recovered_degraded": False}
    assert nodes["N0"].wal is not None
    d = dbs(nodes)
    assert d[0] == d[1] == d[2] and len(d[0]) >= 7, d
    for nid in IDS:
        for pkg in PKGS:
            out[pkg][2][nid].wal.journal.sync()
        assert wal_files(tmp_path / "jax" / nid) == \
            wal_files(tmp_path / "torch" / nid), nid
    cross_recover_dirs(CFGS, IDS, "N0", APPS, tmp_path / "jax" / "N0",
                       tmp_path / "torch" / "N0", tmp_path / "cross")


def test_scribbled_restart_recovers_degraded(tmp_path):
    """Storage chaos: N2 crashes, a ``bit_flip`` damages its journal, and
    the real restart comes back degraded, then repairs from its peers."""
    def sched(c):
        return with_traffic(c.ChaosSchedule("scribble", [
            c.ChaosEvent(40, "crash", {"node": "N2", "detect_after": 2}),
            c.ChaosEvent(60, "bit_flip", {"node": "N2"}),
            c.ChaosEvent(90, "recover", {"node": "N2"}),
        ]), n=9, every=12)

    out = run_both(sched, 200, wal_root=tmp_path)
    runner, log, nodes, dirs, _ = out["torch"]
    rec = [r for r in log.records if r["action"] == "recover"][0]
    assert rec["info"] == {"recovered_degraded": True}
    assert not nodes["N2"]._tainted_rows
    d = dbs(nodes)
    assert d[0] == d[1] == d[2], d
    for pkg in PKGS:
        q = [p for p in os.listdir(out[pkg][3]["N2"])
             if p.endswith(".quarantined")]
        assert len(q) == 1, q
        out[pkg][2]["N2"].wal.journal.sync()
    assert wal_files(tmp_path / "jax" / "N2") == \
        wal_files(tmp_path / "torch" / "N2")
    cross_recover_dirs(CFGS, IDS, "N2", APPS, tmp_path / "jax" / "N2",
                       tmp_path / "torch" / "N2", tmp_path / "cross")


# -------------------------------------------- faultdisk planned journals
@pytest.mark.parametrize("plan", [{"fsync_error_after": 2},
                                  {"disk_full_after": 3},
                                  {"torn_write_after": 2}])
def test_planned_journal_faults_equal_reference(tmp_path, monkeypatch,
                                                plan):
    """A ``FAULT.json`` plan next to the journal (``write_plan``) arms the
    same fault at the same call in both packages' journals opened under
    ``GPTPU_WAL_FAULTS=1``, and leaves the same bytes on disk."""
    monkeypatch.setenv("GPTPU_WAL_FAULTS", "1")
    seen = {}
    for pkg, fd, wal in (("jax", jfd, jwal), ("torch", tfd, twal)):
        d = tmp_path / pkg
        d.mkdir()
        p = fd.write_plan(str(d), plan)
        assert p == fd.plan_path(str(d)) and os.path.exists(p)
        j = wal._new_journal(str(d / "journal.00000000.log"), False)
        assert type(j).__name__ == "_PlannedJournal" and j.plan == plan
        events = []
        for i in range(6):
            try:
                j.append(f"rec{i}".encode() * 8)
                events.append("a")
                if i % 2:
                    j.sync()
                    events.append("s")
            except OSError as e:
                events.append(f"E{e.errno}")
                break
        with open(d / "journal.00000000.log", "rb") as f:
            seen[pkg] = (events, f.read(), j.failed)
        # a journal whose directory holds no plan passes through unwrapped
        (d / "clean").mkdir()
        bare = wal._new_journal(str(d / "clean" / "journal.00000000.log"),
                                False)
        assert type(bare).__name__ == "PyJournal"
        bare.close()
    assert seen["jax"] == seen["torch"]
    assert seen["torch"][2] and seen["torch"][0][-1].startswith("E")


def test_proc_runner_arms_storage_faults_by_plan(tmp_path):
    """``ProcChaosRunner``'s ``fsync_error`` and ``disk_full`` actions drop
    the same plan files in both packages."""
    for pkg, c in (("jax", jchaos), ("torch", tchaos)):
        dirs = {"N0": str(tmp_path / pkg / "N0")}
        os.makedirs(dirs["N0"])
        sched = c.ChaosSchedule("disk", [
            c.ChaosEvent(0, "fsync_error", {"node": "N0", "after": 3}),
            c.ChaosEvent(0, "disk_full", {"node": "N0"}),
        ])
        runner = c.ProcChaosRunner({}, sched, wal_dirs=dirs, tick_s=0.001)
        log = runner.run()
        assert [r["action"] for r in log.records] == ["fsync_error",
                                                      "disk_full"]
        assert log.records[0]["info"]["plan"] == tfd.plan_path(dirs["N0"])
    a = (tmp_path / "jax" / "N0" / "FAULT.json").read_bytes()
    b = (tmp_path / "torch" / "N0" / "FAULT.json").read_bytes()
    assert a == b == b'{"disk_full_after": 0}'
