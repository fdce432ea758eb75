"""Mode B control-plane bindings, twin of the reference's
``modeb/coordinator.py``: ``ModeBReplicaCoordinator`` (the replica
coordination SPI over one process's ``ModeBNode``) and
``ModeBRepliconfigurableDB`` (reconfiguration records committed through an
RC-plane ``ModeBNode`` whose app is the ``ReconfiguratorDB``).

The same script drives three journaled nodes on each package's ``SimNet``
(the reference's and the port's), and records every response, final-state
checkpoint, app checkpoint and RC record into a transcript; the two
transcripts, the node states and the journal files must be equal
(tolerance 0).  The script covers ``create_replica_group``,
``coordinate_request`` (right and wrong epoch), ``stop_replica_group``,
``get_final_state``, the next epoch's birth from that state,
``drop_final_state``/``final_state_gone``, ``delete_replica_group``, a
crashed coordinator node rebuilding its epoch map from its journal, and
the RC records' create / reconfigure / delete life cycle.
"""

import pytest
import torch

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.modeb import ModeBLogger as JLogger
from gigapaxos_tpu.modeb import ModeBNode as JNode
from gigapaxos_tpu.modeb import ModeBReplicaCoordinator as JCoord
from gigapaxos_tpu.modeb import ModeBRepliconfigurableDB as JRCDB
from gigapaxos_tpu.modeb import recover_modeb as jrecover
from gigapaxos_tpu.reconfiguration.rc_db import ReconfiguratorDB as JDB
from gigapaxos_tpu.testing.simnet import SimNet as JNet
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.modeb import ModeBLogger as TLogger
from gigapaxos_tpu_torch.modeb import ModeBNode as TNode
from gigapaxos_tpu_torch.modeb import ModeBReplicaCoordinator as TCoord
from gigapaxos_tpu_torch.modeb import ModeBRepliconfigurableDB as TRCDB
from gigapaxos_tpu_torch.modeb import recover_modeb as trecover
from gigapaxos_tpu_torch.reconfiguration.rc_db import ReconfiguratorDB as TDB
from gigapaxos_tpu_torch.testing.simnet import SimNet as TNet
from test_torch_modeb import assert_same_node, cross_recover_dirs, wal_files

IDS = ["N0", "N1", "N2"]
PKGS = {
    "jax": dict(config=jconfig, App=jrep.KVApp, Node=JNode, Logger=JLogger,
                Coord=JCoord, RCDB=JRCDB, DB=JDB, Net=JNet,
                recover=jrecover, kw={}),
    "torch": dict(config=tconfig, App=trep.KVApp, Node=TNode,
                  Logger=TLogger, Coord=TCoord, RCDB=TRCDB, DB=TDB,
                  Net=TNet, recover=trecover, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Plane:
    """Three journaled ``ModeBNode``s of one package on its ``SimNet``."""

    def __init__(self, pkg, root, app_of, tag):
        self.p = PKGS[pkg]
        self.cfg = self.p["config"].GigapaxosTpuConfig()
        self.cfg.paxos.max_groups = 16
        self.cfg.paxos.window = 8
        self.net = self.p["Net"](seed=0)
        self.dirs = {n: str(root / pkg / tag / n) for n in IDS}
        self.app_of = app_of
        self.tag = tag
        self.nodes = {
            n: self.p["Node"](self.cfg, IDS, n, app_of(n),
                              self.net.messenger(n),
                              wal=self.p["Logger"](self.dirs[n],
                                                   native=False),
                              anti_entropy_every=8, spill_ns=tag,
                              **self.p["kw"])
            for n in IDS}

    def spin(self, k=1):
        for _ in range(k):
            for n in IDS:
                if n in self.nodes:
                    self.nodes[n].tick()
            self.net.pump()

    def until(self, box, what, limit=200):
        for _ in range(limit):
            if box:
                return box
            self.spin()
        raise AssertionError(f"no answer to {what}")

    def recover(self, nid):
        self.nodes[nid].close()
        nd = self.p["recover"](self.cfg, IDS, nid, self.app_of(nid),
                               self.dirs[nid], native=False, spill_ns=self.tag,
                               **self.p["kw"])
        nd.attach_messenger(self.net.messenger(nid))
        nd.request_sync()
        self.nodes[nid] = nd
        return nd


def drive_coordinator(pkg, root):
    """The replica-coordinator script; -> (transcript, plane)."""
    p = PKGS[pkg]
    pl = Plane(pkg, root, lambda n: p["App"](), "ar")
    co = {n: p["Coord"](nd) for n, nd in pl.nodes.items()}
    out = []
    seed_app = p["App"]()
    seed_app.execute("seed", b"PUT base 0", 1)
    seed = seed_app.checkpoint("seed")
    for n in IDS:
        out.append(("create", n, co[n].create_replica_group(
            "svc", 0, seed, list(IDS))))
    pl.spin(4)
    out.append(("members", co["N1"].get_replica_group("svc")))
    for i, n in enumerate(IDS):
        box = []
        rid = co[n].coordinate_request(
            "svc", 0, f"PUT k{i} v{i}".encode(),
            lambda r, x, box=box: box.append(x))
        out.append(("request", n, rid, pl.until(box, "request")[0]))
    out.append(("wrong_epoch", co["N0"].coordinate_request("svc", 1,
                                                           b"PUT x 1")))
    pl.spin(6)
    done = []
    out.append(("stop", co["N0"].stop_replica_group(
        "svc", 0, lambda ok: done.append(ok))))
    out.append(("stopped", pl.until(done, "stop")))
    pl.spin(6)
    finals = {n: co[n].get_final_state("svc", 0) for n in IDS}
    out.append(("final", finals))
    assert all(f is not None for f in finals.values())
    out.append(("after_stop", co["N1"].coordinate_request("svc", 0,
                                                          b"PUT y 2")))
    for n in IDS:
        out.append(("create1", n, co[n].create_replica_group(
            "svc", 1, finals["N0"], list(IDS))))
    pl.spin(4)
    box = []
    co["N2"].coordinate_request("svc", 1, b"PUT k9 v9",
                                lambda r, x: box.append(x))
    out.append(("request1", pl.until(box, "epoch 1")))
    pl.spin(6)
    out.append(("apps", {n: nd.app.checkpoint("svc#1")
                         for n, nd in pl.nodes.items()}))
    for n in IDS:
        out.append(("gone_before", n, co[n].final_state_gone("svc", 0)))
        out.append(("drop", n, co[n].drop_final_state("svc", 0)))
        out.append(("gone_after", n, co[n].final_state_gone("svc", 0)))
    # crash the coordinator node N2 and rebuild its epoch map from disk
    for nd in pl.nodes.values():
        nd.wal.journal.sync()
    nd2 = pl.recover("N2")
    co["N2"] = p["Coord"](nd2)
    out.append(("recovered_epoch", co["N2"].current_epoch("svc"),
                nd2.app.checkpoint("svc#1")))
    pl.spin(8)
    box = []
    co["N2"].coordinate_request("svc", 1, b"PUT k10 v10",
                                lambda r, x: box.append(x))
    out.append(("request2", pl.until(box, "after recovery")))
    pl.spin(6)
    for n in IDS:
        out.append(("delete", n, co[n].delete_replica_group("svc", 1)))
    out.append(("deleted", co["N0"].get_replica_group("svc")))
    pl.spin(2)
    return out, pl


def drive_rc_db(pkg, root):
    """RC records through ``ModeBRepliconfigurableDB``; -> (transcript,
    plane)."""
    p = PKGS[pkg]
    pl = Plane(pkg, root, lambda n: p["DB"](n), "rc")
    rc = {n: p["RCDB"](nd, IDS, k=3) for n, nd in pl.nodes.items()}
    out = [("group", rc["N0"].rc_group_of("svc"),
            rc["N0"].primary_of("svc"))]

    def commit(at, name, cmd):
        box = []
        rc[at].commit(name, cmd, box.append)
        return pl.until(box, cmd["op"])[0]

    out.append(commit("N0", "svc", {"op": "create", "name": "svc",
                                    "actives": ["N0", "N1", "N2"]}))
    out.append(commit("N1", "svc", {"op": "create", "name": "svc",
                                    "actives": ["N0"]}))
    out.append(commit("N2", "batch", {"op": "create_batch", "name": "batch",
                                      "creates": [
                                          {"name": "a", "actives": ["N1"]},
                                          {"name": "b", "actives": ["N2"]}]}))
    out.append(commit("N1", "svc", {"op": "reconfigure_intent",
                                    "name": "svc",
                                    "new_actives": ["N1", "N2"]}))
    out.append(commit("N2", "svc", {"op": "reconfigure_complete",
                                    "name": "svc", "epoch": 0}))
    out.append(commit("N0", "svc", {"op": "delete_intent", "name": "svc",
                                    "now": 5}))
    out.append(commit("N0", "svc", {"op": "delete_complete",
                                    "name": "svc"}))
    out.append(commit("N2", "svc", {"op": "create", "name": "svc",
                                    "actives": ["N2"]}))
    pl.spin(8)
    for n in IDS:
        db = rc[n].db_of(n)
        out.append(("db", n, {k: db.get(k).to_dict() for k in db.names()},
                    dict(db.tombstones)))
    with pytest.raises(KeyError):
        rc["N0"].db_of("N1")
    return out, pl


@pytest.mark.parametrize("drive", [drive_coordinator, drive_rc_db])
def test_modeb_control_plane_equals_reference(tmp_path, drive):
    jout, jpl = drive("jax", tmp_path)
    tout, tpl = drive("torch", tmp_path)
    assert jout == tout
    for n in IDS:
        assert_same_node(jpl.nodes[n], tpl.nodes[n])
        for pl in (jpl, tpl):
            pl.nodes[n].wal.journal.sync()
        assert wal_files(jpl.dirs[n]) == wal_files(tpl.dirs[n]), n
    cross_recover_dirs((jpl.cfg, tpl.cfg), IDS, "N1",
                       (lambda: jpl.app_of("N1"), lambda: tpl.app_of("N1")),
                       jpl.dirs["N1"], tpl.dirs["N1"], tmp_path / "cross",
                       spill_ns=tpl.tag)
