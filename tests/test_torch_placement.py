"""Placement twin: the port's demand plane (``placement/counters.py``, the
demand fold in the scripted tick and after the mesh's shards), its
rebalancer, migrator and ``RebalancerDaemon`` on the CPU against the JAX
package's, with the same seeded loads, demand arrays and workloads.

Tolerance: 0.  Demand snapshots are compared bit for bit (as uint32): the
reference's XLA program folds ``decay * d + per_row`` as one multiply-add,
and the port folds the same product and sum in float64 (where the product
of two float32 values is exact) and rounds once, which gives the same
float32 bits.  Plans, migration counters, rows, responses, app
checkpoints and routing answers are compared with ``==``.  The migration
cases run ``tests/test_placement_migration.py``'s and
``tests/test_client_placement.py``'s scripts on an 8-shard mesh (eight
``cpu`` shards in the port).
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gigapaxos_tpu import placement as jplacement
from gigapaxos_tpu.client import ReconfigurableAppClient as JClient
from gigapaxos_tpu.config import GigapaxosTpuConfig as JConfig
from gigapaxos_tpu.models.replicable import KVApp as JKV
from gigapaxos_tpu.node import InProcessCluster as JCluster
from gigapaxos_tpu.paxos.manager import PaxosManager as JManager
from gigapaxos_tpu.reconfiguration import consistent_hashing as jch
from gigapaxos_tpu.reconfiguration import coordinator as jcoord
from gigapaxos_tpu.utils import observability as jobs
from gigapaxos_tpu.wal import logger as jwal
from gigapaxos_tpu_torch import placement as tplacement
from gigapaxos_tpu_torch.client import ReconfigurableAppClient as TClient
from gigapaxos_tpu_torch.config import GigapaxosTpuConfig as TConfig
from gigapaxos_tpu_torch.models.replicable import KVApp as TKV
from gigapaxos_tpu_torch.node import InProcessCluster as TCluster
from gigapaxos_tpu_torch.paxos.manager import PaxosManager as TManager
from gigapaxos_tpu_torch.reconfiguration import consistent_hashing as tch
from gigapaxos_tpu_torch.reconfiguration import coordinator as tcoord
from gigapaxos_tpu_torch.utils import observability as tobs
from gigapaxos_tpu_torch.wal import logger as twal

PKGS = {
    "ref": SimpleNamespace(Config=JConfig, KV=JKV, Manager=JManager,
                           pl=jplacement, ch=jch, coord=jcoord, wal=jwal,
                           obs=jobs, Cluster=JCluster, Client=JClient,
                           kw={}),
    "port": SimpleNamespace(Config=TConfig, KV=TKV, Manager=TManager,
                            pl=tplacement, ch=tch, coord=tcoord, wal=twal,
                            obs=tobs, Cluster=TCluster, Client=TClient,
                            kw={"device": "cpu"}),
}

R = 3
N_NAMES = 6
SHARDS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin(scenario):
    out = {key: scenario(P) for key, P in PKGS.items()}
    assert out["ref"] == out["port"]
    return out["port"]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32).tolist()


# ------------------------------------------------------ demand snapshots
@pytest.mark.parametrize("mode", ["device", "host_full", "host_leases"])
def test_demand_snapshot_after_seeded_load(mode):
    """One device (G_s = 1): the demand EWMA after every tick of a seeded
    zipf-ish load, folded inside the scripted compact tick (``device``),
    or on the host from ``decided_now`` (full outbox) or from the
    ``taken_bits`` popcount (compact with leases)."""

    def sc(P):
        c = P.Config()
        c.paxos.max_groups = 64
        c.paxos.window = 8
        c.paxos.compact_outbox = mode != "host_full"
        c.paxos.read_leases = mode == "host_leases"
        c.paxos.pipeline_ticks = True
        c.placement.enabled = True
        c.placement.sample_every_ticks = 1
        m = P.Manager(c, R, [P.KV() for _ in range(R)], **P.kw)
        assert (m._demand_dev is not None) == (mode == "device")
        assert m.shard_geometry() == (1, 64)
        for g in range(16):
            m.create_paxos_instance(f"s{g}", list(range(R)))
        rng = np.random.default_rng(3)
        snaps = []
        for _ in range(24):
            for _ in range(int(rng.integers(0, 12))):
                g = int(rng.zipf(1.5)) % 16
                m.propose(f"s{g}", b"PUT a b", lambda *a: None)
            m.tick()
            snaps.append(_bits(m.demand_snapshot()))
        m.drain_pipeline()
        return snaps, _bits(m._placement.shard_loads())

    snaps, _ = twin(sc)
    assert sum(snaps[-1]) > 0


# ------------------------------------------------------------ rebalancer
def test_rebalancer_propose_same_plans():
    """``ShardRebalancer.propose`` over the same synthetic demand arrays
    and free-row tables, with executions and aborts recorded between
    rounds: the same plans, skews and guard state."""

    def sc(P):
        rng = np.random.default_rng(11)
        G, gs = 512, 8
        reb = P.pl.ShardRebalancer(G, gs, skew_threshold=1.5,
                                   min_interval_ticks=2,
                                   max_moves_per_plan=3)
        free = rng.integers(0, 6, gs)
        blobs = rng.integers(0, 4096, G)
        out = []
        for rnd in range(12):
            d = (rng.pareto(1.2, G) * (rng.random(G) < 0.3)).astype(
                np.float32)
            d[: G // gs] *= 1 + rnd % 3  # shard 0 runs hot
            plan = reb.propose(rnd * 3, d,
                               free_rows_in_shard=lambda s: int(free[s]),
                               blob_bytes=lambda r: int(blobs[r]))
            out.append((plan.tick, list(plan.moves),
                        float(plan.skew_before), float(plan.skew_predicted),
                        bool(plan)))
            if plan and rnd % 2:
                reb.record_executed(len(plan.moves))
            elif plan:
                reb.record_aborted()
        out.append(float(P.pl.ShardRebalancer.skew(
            np.array([3.0, 1.0, 0.0, 2.0]), 1e-3)))
        return out

    out = twin(sc)
    assert any(p[4] for p in out[:-1])


# ------------------------------------------------------- migration (mesh)
def make_cfg(P, placement=True):
    cfg = P.Config()
    cfg.paxos.max_groups = 256
    cfg.paxos.window = 4
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.deactivation_ticks = 0
    cfg.paxos.mesh_devices = 8
    cfg.paxos.mesh_replica_shards = 1
    cfg.placement.enabled = placement
    cfg.placement.sample_every_ticks = 1
    return cfg


def build(P, tmpdir, placement=True):
    wal = P.wal.PaxosLogger(os.path.join(tmpdir, "wal"), sync_every_ticks=2,
                            checkpoint_every_ticks=16)
    apps = [P.KV() for _ in range(R)]
    m = P.Manager(make_cfg(P, placement), R, apps, wal=wal, **P.kw)
    nodes = [f"AR{i}" for i in range(R)]
    coord = P.coord.PaxosReplicaCoordinator(m, nodes)
    for i in range(N_NAMES):
        assert coord.create_replica_group(f"svc{i}", 0, b"", nodes)
    return m, coord, apps, wal, nodes


def _table(P):
    return P.pl.PlacementTable(P.ch.ConsistentHashRing(
        [f"shard{k}" for k in range(SHARDS)]))


def run_workload(P, tmpdir, migrate=False):
    """``test_placement_migration.py``'s scripted workload; optionally
    migrates svc0 to shard 5 mid-stream."""
    m, coord, apps, wal, nodes = build(P, tmpdir)
    table = _table(P)
    stats = P.pl.MigrationStats()
    mig = P.pl.GroupMigrator(coord, table=table, counters=m._placement,
                             stats=stats)
    resp = {}

    def put(name, k, v):
        tag = f"{name}/{k}"
        coord.coordinate_request(
            name, coord.current_epoch(name), f"PUT {k} {v}".encode(),
            lambda r, x, tag=tag: resp.setdefault(tag, x))

    for i in range(6):
        for g in range(N_NAMES):
            put(f"svc{g}", f"k{i}", f"v{g}.{i}")
        put("svc0", f"hot{i}", f"h{i}")
        m.tick()
    m.drain_pipeline()
    if migrate:
        src = m._placement.shard_of_row(m.rows.row("svc0#0"))
        assert src == 0
        assert mig.migrate("svc0", 5, pump=m.tick)
        assert table.shard_of("svc0") == 5
    m.set_alive(R - 1, False)
    for i in range(6):
        put("svc0", f"q{i}", f"w{i}")
        put("svc1", f"q{i}", f"w{i}")
        m.tick()
    m.set_alive(R - 1, True)
    for _ in range(8):
        m.tick()
    for i in range(4):
        for g in range(N_NAMES):
            put(f"svc{g}", f"z{i}", f"y{g}.{i}")
        m.tick()
    m.run_ticks(4)
    m.drain_pipeline()
    ckpts = {}
    for i in range(N_NAMES):
        name = f"svc{i}"
        pname = f"{name}#{coord.current_epoch(name)}"
        ckpts[name] = [a.checkpoint(pname) for a in apps]
    return resp, ckpts, table, stats, m, wal


def test_migrate_mid_workload_bit_identical(tmp_path):
    def sc(P):
        ref_resp, ref_ckpts, _, _, _, wal0 = run_workload(
            P, str(tmp_path / f"{P.wal.__name__}ref"), migrate=False)
        wal0.close()
        got_resp, got_ckpts, table, stats, m1, wal1 = run_workload(
            P, str(tmp_path / f"{P.wal.__name__}mig"), migrate=True)
        wal1.close()
        assert got_resp == ref_resp
        assert all(v == b"OK" for v in got_resp.values())
        assert got_ckpts == ref_ckpts
        row = m1.rows.row("svc0#1")
        gs, per = m1.shard_geometry()
        servers = [f"shard{k}" for k in range(SHARDS)]
        ring = P.ch.ConsistentHashRing(servers)
        snap = stats.snapshot()
        return [sorted(got_resp.items()), got_ckpts, row, gs, per,
                m1.rows.row("svc1#0"), snap, table.lookup("svc0", 3),
                table.order_actives("svc0", servers),
                table.lookup("svc1", 3) == ring.replicated_servers("svc1",
                                                                   3),
                _bits(m1.demand_snapshot())]

    out = twin(sc)
    row, gs, per = out[2], out[3], out[4]
    assert gs == SHARDS and row // per == 5 and out[5] // per == 0
    assert out[6]["groups_moved"] == 1 and out[6]["bytes_transferred"] > 0
    assert out[6]["aborts"] == 0
    assert out[7][0] == "shard5" and out[8][0] == "shard5" and out[9]


def test_wal_recovery_replays_migration(tmp_path):
    """Crash after the migration: OP_CREATE_AT replay lands the new epoch
    on the same row with the same app state, in both packages, from
    journals that are byte-equal."""

    def sc(P):
        wdir = str(tmp_path / P.wal.__name__.replace(".", "_"))
        m, coord, apps, wal, nodes = build(P, wdir)
        mig = P.pl.GroupMigrator(coord)
        resp = []
        for i in range(5):
            coord.coordinate_request("svc0", 0, f"PUT k{i} v{i}".encode(),
                                     lambda r, x: resp.append(x))
            m.tick()
        m.drain_pipeline()
        assert mig.migrate("svc0", 6, pump=m.tick)
        coord.coordinate_request("svc0", 1, b"PUT post after",
                                 lambda r, x: resp.append(x))
        m.run_ticks(4)
        m.drain_pipeline()
        row_live = m.rows.row("svc0#1")
        live = [a.checkpoint("svc0#1") for a in apps]
        wal.close()
        journal = {}
        for root, _, files in os.walk(os.path.join(wdir, "wal")):
            for f in sorted(files):
                with open(os.path.join(root, f), "rb") as fh:
                    journal[f] = fh.read()
        m2 = P.wal.recover(make_cfg(P), R, [P.KV() for _ in range(R)],
                           os.path.join(wdir, "wal"), **P.kw)
        m2.wal.close()
        return [resp, row_live, m2.rows.row("svc0#1"),
                "svc0#0" in m2.rows,
                [a.checkpoint("svc0#1") for a in m2.apps], live, journal]

    out = twin(sc)
    assert out[1] == out[2] and not out[3] and out[4] == out[5]
    assert b"post" in out[5][0] and b"v4" in out[5][0]


def test_rebalancer_closes_skew_end_to_end(tmp_path):
    def sc(P):
        m, coord, apps, wal, nodes = build(
            P, str(tmp_path / P.wal.__name__.replace(".", "_")))
        table = _table(P)
        stats = P.pl.MigrationStats()
        mig = P.pl.GroupMigrator(coord, table=table, counters=m._placement,
                                 stats=stats)
        reb = P.pl.ShardRebalancer(m.G, SHARDS, skew_threshold=2.0,
                                   min_interval_ticks=0,
                                   max_moves_per_plan=2)

        def pump_traffic(rounds):
            for i in range(rounds):
                for g in range(N_NAMES):
                    e = coord.current_epoch(f"svc{g}")
                    coord.coordinate_request(f"svc{g}", e,
                                             f"PUT r{i} x{g}".encode())
                m.tick()
            m.drain_pipeline()

        pump_traffic(8)
        demand = m.demand_snapshot()
        loads_before = m._placement.shard_loads()
        skew_before = P.pl.ShardRebalancer.skew(loads_before, 1e-3)
        plan = reb.propose(m.tick_num, demand,
                           free_rows_in_shard=m.free_rows_in_shard,
                           blob_bytes=m.blob_bytes_of_row)
        moved = mig.execute_plan(plan, pump=m.tick)
        pump_traffic(12)
        loads_after = m._placement.shard_loads()
        skew_after = P.pl.ShardRebalancer.skew(loads_after, 1e-3)
        rep = P.obs.StatsReporter("n0", interval_s=60)
        rep.add_source("migration", P.obs.migration_stats_source(mig))
        rep.add_source("shard_load", P.obs.shard_load_source(m))
        snap = rep.snapshot()
        wal.close()
        return [_bits(demand), _bits(loads_before), float(skew_before),
                list(plan.moves), moved, stats.snapshot(),
                _bits(loads_after), float(skew_after),
                snap["migration"], snap["shard_load"]]

    out = twin(sc)
    assert sum(out[0]) > 0 and int(np.argmax(out[1])) == 0
    assert out[3] and out[4] >= 1 and out[5]["groups_moved"] == out[4]
    assert out[7] < out[2]
    assert out[8]["groups_moved"] == out[4]
    assert out[9]["enabled"] and len(out[9]["shard_loads"]) == SHARDS
    assert out[9]["skew"] > 0


# ----------------------------------------------------------- the client
def client_cfg(P, n_active=5, n_rc=3, placement=False):
    cfg = P.Config()
    cfg.paxos.max_groups = 64
    cfg.paxos.window = 4
    if placement:
        cfg.paxos.mesh_devices = 8
        cfg.paxos.mesh_replica_shards = 1
        cfg.paxos.deactivation_ticks = 0
        cfg.placement.enabled = True
        cfg.placement.sample_every_ticks = 1
    for i in range(n_active):
        cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
    for i in range(n_rc):
        cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
    return cfg


def test_client_routes_by_override_without_rc_roundtrip():
    def sc(P):
        cfg = client_cfg(P)
        cl = P.Cluster(cfg, P.KV, **P.kw)
        c = P.Client(cfg.nodes)
        admin = P.Client(cfg.nodes)
        try:
            assert c.create("routed")["ok"]
            assert c.request("routed", b"PUT a 1") == b"OK"
            old = c.request_actives("routed")
            pool = cfg.nodes.active_ids()
            new = sorted((set(pool) - set(old)) | {sorted(old)[0]})[:3]
            assert admin.reconfigure("routed", new)["ok"]
            new_home = sorted(set(new) - set(old))[0]
            table = P.pl.PlacementTable(P.ch.ConsistentHashRing(sorted(pool)))
            table.set_override("routed", table.shard_of_server[new_home])
            c.attach_placement(table)
            rc_calls = []
            orig_rpc = c._rpc_rc
            c._rpc_rc = lambda *a, **k: rc_calls.append(a) or orig_rpc(*a,
                                                                       **k)
            sent = []
            orig_send = c.m.send

            def spy(dest, p, **kw):
                sent.append(dest)
                return orig_send(dest, p, **kw)

            c.m.send = spy
            got = [c.request("routed", f"PUT k{i} v{i}".encode())
                   for i in range(3)]
            got.append(c.request("routed", b"GET a"))
            only_home = bool(sent) and all(d == new_home for d in sent)
            n_rc = len(rc_calls)
            t = c._route("routed", old, avoid={new_home})
            assert c.create("plain")["ok"]
            acts = c.request_actives("plain")
            return [sorted(old), new, new_home, got, only_home, n_rc,
                    t != new_home and t in old,
                    c._route("plain", acts) in acts]
        finally:
            c.close()
            admin.close()
            cl.close()

    out = twin(sc)
    assert out[3] == [b"OK"] * 3 + [b"1"]
    assert out[4] and out[5] == 0 and out[6] and out[7], out


def test_rebalancer_daemon_moves_hot_group():
    """``start_rebalancer`` (a refusal in earlier slices of the port): the
    daemon detects the skew from live demand counters and migrates a hot
    group with nobody driving the loop.  Its moves race the traffic, so
    the twin compares what both packages must reach, not the timing."""

    def sc(P):
        cfg = client_cfg(P, n_active=3, placement=True)
        cl = P.Cluster(cfg, P.KV, **P.kw)
        try:
            nodes = cfg.nodes.active_ids()
            coord = cl.coordinator
            for g in range(4):
                assert coord.create_replica_group(f"svc{g}", 0, b"", nodes)
            table = P.pl.PlacementTable(P.ch.ConsistentHashRing(
                [f"shard{k}" for k in range(8)]))
            daemon = cl.start_rebalancer(interval_s=0.05, table=table,
                                         skew_threshold=1.5,
                                         min_interval_ticks=0)
            deadline = time.monotonic() + 30
            i = 0
            while daemon.moves_total == 0 and time.monotonic() < deadline:
                for g in range(4):
                    name = "svc0" if g else f"svc{i % 4}"
                    try:
                        coord.coordinate_request(
                            name, coord.current_epoch(name),
                            f"PUT k{i} v{g}".encode())
                    except Exception:
                        pass  # mid-migration epoch race; next round retries
                cl.driver.kick()
                time.sleep(0.002)
                i += 1
            got = [daemon.moves_total >= 1, bool(table.overrides),
                   daemon.stats.snapshot()["groups_moved"] >= 1]
            cl.stop_rebalancer()
            got.append(cl.rebalancer is None)
            cl.start_rebalancer(interval_s=5.0, skew_threshold=10.0)
        finally:
            cl.close()
        got.append(cl.rebalancer is None)
        return got

    assert twin(sc) == [True] * 5
