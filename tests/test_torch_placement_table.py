"""Placement-table and cell-routing twin: the reference's
``tests/test_placement_table.py`` table cases, the six pure routing cases
of ``tests/test_cells.py``, and ``tests/test_client_placement.py``'s
override routing, each run once on each package with the same inputs.

Tolerance: 0.  Each scenario returns what it observed (lookups, shards,
orders, rc_db replies, records, routes, the nodes a client sent to) and the
two packages' observations are equal; the reference's own assertions hold
on both.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gigapaxos_tpu import client as jclient
from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu import node as jnode
from gigapaxos_tpu.cells import routing as jrouting
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.placement import table as jtable
from gigapaxos_tpu.reconfiguration import consistent_hashing as jch
from gigapaxos_tpu.reconfiguration import demand as jdemand
from gigapaxos_tpu.reconfiguration import rc_db as jrc_db
from gigapaxos_tpu.reconfiguration import records as jrecords
from gigapaxos_tpu_torch import client as tclient
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch import node as tnode
from gigapaxos_tpu_torch.cells import routing as trouting
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.placement import table as ttable
from gigapaxos_tpu_torch.reconfiguration import consistent_hashing as tch
from gigapaxos_tpu_torch.reconfiguration import demand as tdemand
from gigapaxos_tpu_torch.reconfiguration import rc_db as trc_db
from gigapaxos_tpu_torch.reconfiguration import records as trecords

PKGS = {
    "ref": SimpleNamespace(
        table=jtable, ring=jch.ConsistentHashRing, rc_db=jrc_db,
        records=jrecords, routing=jrouting, client=jclient, config=jconfig,
        node=jnode, rep=jrep, demand=jdemand, kw={}),
    "port": SimpleNamespace(
        table=ttable, ring=tch.ConsistentHashRing, rc_db=trc_db,
        records=trecords, routing=trouting, client=tclient, config=tconfig,
        node=tnode, rep=trep, demand=tdemand, kw={"device": "cpu"}),
}
SERVERS = [f"s{i}" for i in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin(scenario):
    """Run ``scenario(P)`` on both packages; their observations, equal."""
    ref = scenario(PKGS["ref"])
    port = scenario(PKGS["port"])
    assert ref == port
    return port


def make_table(P, servers=SERVERS):
    return P.table.PlacementTable(P.ring(servers))


# ------------------------------------------------------------------- table
def sc_agrees_with_ring(P):
    t, ring, out = make_table(P), P.ring(SERVERS), []
    for i in range(50):
        name = f"name{i}"
        acts = ring.replicated_servers(name, 4)
        out.append((t.lookup(name, 3), t.shard_of(name),
                    t.default_shard(name), t.order_actives(name, acts)))
        assert t.lookup(name, 3) == ring.replicated_servers(name, 3)
        assert t.shard_of(name) == t.default_shard(name)
        assert t.order_actives(name, acts) == acts
    return out


def test_table_agrees_with_ring_absent_overrides():
    twin(sc_agrees_with_ring)


def sc_override_promotes_and_clears(P):
    t, out = make_table(P), []
    t.set_override("alice", 5)
    out += [t.shard_of("alice"), t.lookup("alice", 3),
            t.order_actives("alice", SERVERS),
            t.order_actives("alice", ["s1", "s2"]), t.epoch,
            t.lead_server("alice")]
    assert t.lookup("alice", 3)[0] == "s5" and len(t.lookup("alice", 3)) == 3
    rest = [s for s in t.order_actives("alice", SERVERS) if s != "s5"]
    assert rest == [s for s in SERVERS if s != "s5"]
    assert t.order_actives("alice", ["s1", "s2"]) == ["s1", "s2"]
    t.clear_override("alice")
    out += [t.lookup("alice", 3), t.epoch, t.lead_server("alice")]
    assert t.lookup("alice", 3) == P.ring(SERVERS).replicated_servers(
        "alice", 3)
    return out


def test_table_override_promotes_and_clears():
    twin(sc_override_promotes_and_clears)


def sc_ring_splice(P):
    t = make_table(P)
    t.set_override("alice", 3)
    t.splice(P.ring(SERVERS + ["s8"]))
    assert t.shard_of("alice") == 3 and t.lookup("alice", 3)[0] == "s3"
    return [t.shard_of("alice"), t.lookup("alice", 3),
            t.lookup("bob", 3), t.shard_of("bob")]


def test_table_survives_ring_splice():
    twin(sc_ring_splice)


def sc_serializes_through_rc_db(P):
    db = P.rc_db.ReconfiguratorDB("X")
    rec = P.table.PLACEMENT_RECORD

    def run(cmd):
        return json.loads(db.execute(rec, json.dumps(cmd).encode(),
                                     0).decode())

    out = []
    t = make_table(P)
    t.set_override("alice", 2)
    out.append(run(t.to_command("alice")))
    assert out[-1]["ok"] and out[-1]["overrides"] == {"alice": 2}
    t.set_override("bob", 7)
    out.append(run(t.to_command("bob")))
    ck = db.checkpoint("_RC:any")
    db.restore("_RC:any", b"")
    out.append(db.get(rec))
    db.restore("_RC:any", ck)
    t2 = make_table(P)
    t2.load_record(db.get(rec).to_dict())
    out += [ck, t2.overrides, t2.lookup("bob", 3), t2.epoch]
    assert t2.overrides == {"alice": 2, "bob": 7}
    t2.clear_override("alice")
    out.append(run(t2.to_command("alice")))
    assert out[-1]["overrides"] == {"bob": 7}
    bad = json.loads(db.execute("other", json.dumps(
        {"op": "placement_set", "name": "other", "service": "x",
         "shard": 1}).encode(), 0).decode())
    assert not bad["ok"]
    # each of the four placement commands through the DB, then a service-
    # less one
    for cmd in ({"op": "placement_set_cell", "service": "c", "shard": 1,
                 "cell": 3},
                {"op": "placement_clear_cell", "service": "c"},
                {"op": "placement_clear", "service": "bob"},
                {"op": "placement_set", "service": ""}):
        out.append(run(dict(cmd, name=rec)))
    return out + [bad, db.checkpoint("_RC:any")]


def test_table_serializes_through_rc_db():
    twin(sc_serializes_through_rc_db)


def sc_register_requests_batch(P):
    a = P.demand.DemandProfile("svc", min_requests_before_report=10 ** 9)
    b = P.demand.DemandProfile("svc", min_requests_before_report=10 ** 9)
    t = 100.0
    a.register_request("c1", now=t)
    b.register_request("c1", now=t)
    for i in range(1, 6):
        a.register_request("c1", now=t + 0.2 * i)
    b.register_requests("c1", 5, now=t + 1.0)
    assert a.num_total == b.num_total == 6 and a.by_sender == b.by_sender
    assert np.isclose(a.inter_arrival_ewma, b.inter_arrival_ewma, rtol=1e-6)
    b.register_requests("c1", 0, now=t + 2.0)
    assert b.num_total == 6
    return [a.num_total, b.num_total, dict(a.by_sender),
            a.inter_arrival_ewma, b.inter_arrival_ewma]


def test_register_requests_batch_matches_loop():
    twin(sc_register_requests_batch)


# ------------------------------------------------------------ cell routing
def sc_cell_of(P):
    out = []
    for n in (1, 2, 3, 8):
        for name in ("g0", "svc-17", "a" * 64):
            k = P.routing.cell_of(name, n)
            assert 0 <= k < n and k == P.routing.cell_of(name, n)
            out.append(k)
    out.append(P.routing.cell_of("anything", 1))
    return out + [P.routing.cell_of(f"n{i}", 4) for i in range(64)]


def test_cell_of_stable_and_in_range():
    twin(sc_cell_of)


def sc_cell_router(P):
    r = P.routing.CellRouter([["c0.AR0", "c0.AR1"], ["c1.AR0", "c1.AR1"]],
                             [["c0.RC0"], ["c1.RC0"]])
    name = "grp"
    home = P.routing.cell_of(name, 2)
    out = [r.cell(name), r.actives_of(name), r.rc_ids(name), r.epoch]
    assert r.cell(name) == home and r.rc_ids(name) == r.rcs_by_cell[home]
    r.set_override(name, 1 - home)
    mixed = ["c0.AR0", "c1.AR1", "c0.AR1", "c1.AR0"]
    ordered = r.order_actives(name, mixed)
    own = set(r.actives_by_cell[1 - home])
    assert set(ordered[:2]) <= own
    out += [r.cell(name), r.epoch, ordered, r.lead_server(name)]
    r.clear_override(name)
    out += [r.cell(name), r.epoch]
    with pytest.raises(ValueError):
        r.set_override(name, 5)
    return out


def test_cell_router_directory_and_overrides():
    twin(sc_cell_router)


def sc_pack_unpack(P):
    out = []
    for shard, cell in [(0, 0), (3, 7), (12, 255)]:
        packed = P.table.pack_host_cell(shard, cell)
        assert P.table.unpack_host_cell(packed) == (shard, cell)
        out.append(packed)
    with pytest.raises(ValueError):
        P.table.pack_host_cell(0, 256)
    return out


def test_pack_unpack_host_cell_roundtrip():
    twin(sc_pack_unpack)


def sc_cell_override_commands(P):
    ring = P.ring(["s0", "s1"])
    t = P.table.PlacementTable(ring)
    t.set_cell_override("g", 1, 3)
    records = {}

    def make(n):
        return P.records.ReconfigurationRecord(name=n)

    rec_name = P.table.PLACEMENT_RECORD
    out = [P.table.apply_placement_command(records, t.to_cell_command("g"),
                                           make),
           P.table.apply_placement_command(
               records, {"op": "placement_set", "name": rec_name,
                         "service": "h", "shard": 1}, make)]
    rec = records[rec_name]
    t2 = P.table.PlacementTable(ring)
    e0 = t2.epoch
    t2.load_record({"rc_epochs": dict(rec.rc_epochs), "epoch": rec.epoch})
    assert t2.cell_of_name("g") == (1, 3) and t2.overrides == {"h": 1}
    assert t2.epoch == rec.epoch != e0
    out += [t2.cell_of_name("g"), t2.overrides, t2.epoch]
    out.append(P.table.apply_placement_command(
        records, {"op": "placement_clear_cell", "name": rec_name,
                  "service": "g"}, make))
    t3 = P.table.PlacementTable(ring)
    t3.load_record({"rc_epochs": dict(rec.rc_epochs), "epoch": rec.epoch})
    assert t3.cell_of_name("g") is None
    for cmd in (t.to_mode_command("g"), {"op": "nope", "service": "g"}):
        out.append(P.table.apply_placement_command(records, cmd, make))
    return out + [rec.to_dict()]


def test_placement_table_cell_override_commands_roundtrip():
    twin(sc_cell_override_commands)


def sc_router_adopts_table(P):
    t = P.table.PlacementTable(P.ring(["s0"]))
    t.set_cell_override("g", 0, 1)
    t.set_cell_override("far", 0, 9)  # beyond this host's cells: ignored
    r = P.routing.CellRouter([["c0.AR0"], ["c1.AR0"]],
                             [["c0.RC0"], ["c1.RC0"]])
    r.load_table(t)
    assert r.cell("g") == 1 and r.epoch == t.epoch
    return [r.cell("g"), r.epoch, r.overrides]


def test_router_adopts_placement_table_cell_overrides():
    twin(sc_router_adopts_table)


def sc_client_route_cache(P):
    nodes = P.config.NodeConfig()
    nodes.actives = {"c0.AR0": ("127.0.0.1", 1), "c1.AR0": ("127.0.0.1", 2)}
    nodes.reconfigurators = {"c0.RC0": ("127.0.0.1", 3)}
    router = P.routing.CellRouter([["c0.AR0"], ["c1.AR0"]],
                                  [["c0.RC0"], ["c0.RC0"]])
    c = P.client.ReconfigurableAppClient(nodes, placement_table=router)
    out = []
    try:
        name = "grp"
        home = router.cell(name)
        t1 = c._route(name, router.actives_of(name))
        assert t1 == f"c{home}.AR0"
        out += [t1, c._route_cache[name]]
        router.set_override(name, 1 - home)
        t2 = c._route(name, router.actives_of(name))
        assert t2 == f"c{1 - home}.AR0"
        out += [t2, c._route_cache[name]]
        c._actives[name] = (time.monotonic() + 30, ["c0.AR0"])
        c._drop_route(name)
        assert name not in c._route_cache and name not in c._actives
        c._resolve_backoff_sleep(name)
        c._resolve_backoff_sleep(name)
        assert c._route_backoff[name] == pytest.approx(0.2)
        out.append(c._route_backoff[name])
        c._resolve_backoff_reset(name)
        assert name not in c._route_backoff
    finally:
        c.close()
    return out


def test_client_route_cache_invalidates_on_epoch_bump():
    twin(sc_client_route_cache)


# --------------------------------------------------------- client placement
def sc_client_routes_by_override(P):
    cfg = P.config.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 64
    cfg.paxos.window = 4
    for i in range(5):
        cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
    for i in range(3):
        cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
    cl = P.node.InProcessCluster(cfg, P.rep.KVApp, **P.kw)
    c = P.client.ReconfigurableAppClient(cfg.nodes)
    admin = P.client.ReconfigurableAppClient(cfg.nodes)
    out = []
    try:
        out += [c.create("routed")["ok"], c.request("routed", b"PUT a 1")]
        old = c.request_actives("routed")
        pool = cfg.nodes.active_ids()
        new = sorted((set(pool) - set(old)) | {sorted(old)[0]})[:3]
        out += [sorted(old), new, admin.reconfigure("routed", new)["ok"]]
        new_home = sorted(set(new) - set(old))[0]
        table = P.table.PlacementTable(P.ring(sorted(pool)))
        table.set_override("routed", table.shard_of_server[new_home])
        c.attach_placement(table)

        rc_calls, sent = [], []
        orig_rpc = c._rpc_rc
        c._rpc_rc = lambda *a, **k: rc_calls.append(a) or orig_rpc(*a, **k)
        orig_send = c.m.send

        def spy(dest, p, **kw):
            sent.append(dest)
            return orig_send(dest, p, **kw)

        c.m.send = spy
        for i in range(3):
            out.append(c.request("routed", f"PUT k{i} v{i}".encode()))
        out.append(c.request("routed", b"GET a"))
        assert sent and all(d == new_home for d in sent), sent
        assert not rc_calls
        t = c._route("routed", old, avoid={new_home})
        assert t != new_home and t in old
        out += [sorted(set(sent)), len(rc_calls), t in old]
        out.append(c.create("plain")["ok"])
        acts = c.request_actives("plain")
        out += [sorted(acts), c._route("plain", acts) in acts]
    finally:
        c.close()
        admin.close()
        cl.close()
    return out


def test_client_routes_by_override_without_rc_roundtrip():
    r = twin(sc_client_routes_by_override)
    assert r[:2] == [True, b"OK"] and r[4] is True
    assert r[5:9] == [b"OK", b"OK", b"OK", b"1"]
