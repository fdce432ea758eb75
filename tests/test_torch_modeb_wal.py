"""Mode B durability twin: the crash cases of the reference's
``tests/test_modeb.py`` with a ``ModeBLogger`` on every node, in both
packages, on the CPU.

Each case runs three of the reference's nodes on its ``SimNet`` and three
of the port's on the port's, in lockstep (``test_torch_modeb.Twin``): state,
wire bytes, responses and apps are held equal after every step (tolerance
0), every node's journal and snapshot files are byte-equal to the
reference's, a killed node comes back through each package's
``recover_modeb`` to equal state, and each package recovers the other's
copy of its directory.  The reference runs these cases over loopback
sockets; the twin uses the simulator so that both runs are deterministic
and comparable step by step.
"""

import numpy as np
import pytest
import torch

from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.modeb import ModeBLogger as JLogger
from gigapaxos_tpu.modeb import ModeBNode as JNode
from gigapaxos_tpu.modeb import wire as jwire
from gigapaxos_tpu.testing.simnet import SimNet as JNet
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.modeb import ModeBLogger as TLogger
from gigapaxos_tpu_torch.modeb import ModeBNode as TNode
from gigapaxos_tpu_torch.testing.simnet import SimNet as TNet
from test_torch_modeb import (APPS, IDS, Twin, cross_recover_dirs, make_cfgs,
                              wal_files)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ckpt_every", [1024, 8])
def test_kill_restart_from_own_journal(tmp_path, ckpt_every):
    """``test_modeb.py:194``: N2 dies, the majority commits, N2 comes back
    from its own journal with its pre-crash app and catches up; with
    ``ckpt_every=8`` every node also snapshots (and rolls its journal)
    during the run, and recovery reads a snapshot and a journal tail."""
    tw = Twin(make_cfgs(), wal_root=tmp_path / "wal", ckpt_every=ckpt_every)
    tw.create("svc")
    assert tw.commit("N2", "svc", b"PUT k1 v1") == b"OK"
    tw.spin(10)
    db_n2 = dict(tw.tapps["N2"].db)
    tw.kill("N2")
    assert tw.commit("N0", "svc", b"PUT k2 v2",
                     only=("N0", "N1")) == b"OK"
    tw.check_wal()
    tw.cross_recover("N2", tmp_path / "cross")
    n2 = tw.recover("N2")
    assert tw.tapps["N2"].db == db_n2  # recovered locally, not copied
    for _ in range(150):
        tw.spin(1)
        if tw.tapps["N2"].db.get("svc", {}).get("k2") == "v2":
            break
    assert tw.tapps["N2"].db["svc"] == {"k1": "v1", "k2": "v2"}
    assert tw.commit("N2", "svc", b"PUT k3 v3") == b"OK"
    assert n2.wal is not None and n2.wal.is_synced()
    tw.check_wal()
    if ckpt_every < 1024:
        assert all(wal_files(tw.wal_dir("torch", nid))[-1][0]
                   .startswith("snapshot.") for nid in IDS)


def test_native_journal_writes_the_reference_bytes(tmp_path):
    """The same case with the port's native journal (``csrc/journal.cc``):
    its files equal the reference's Python journal's, and it recovers."""
    tw = Twin(make_cfgs(), wal_root=tmp_path / "wal", native=True)
    assert all(n.wal.backend == "native" for n in tw.t.values())
    tw.create("svc")
    assert tw.commit("N1", "svc", b"PUT a 1") == b"OK"
    tw.kill("N1")
    assert tw.commit("N0", "svc", b"PUT b 2", only=("N0", "N2")) == b"OK"
    tw.check_wal()
    n1 = tw.recover("N1")
    assert n1.wal.backend == "native"
    assert tw.commit("N1", "svc", b"PUT c 3") == b"OK"
    tw.check_wal()
    tw.cross_recover("N1", tmp_path / "cross")


def test_deep_laggard_checkpoint_transfer_durable(tmp_path):
    """``test_modeb.py:221``: N2 misses more than W decisions, restarts
    from its journal, is repaired by a checkpoint transfer, and the
    transfer itself survives a second crash."""
    tw = Twin(make_cfgs(window=4), wal_root=tmp_path / "wal")
    tw.create("svc")
    assert tw.commit("N0", "svc", b"PUT seed 0") == b"OK"
    tw.spin(10)
    tw.kill("N2")
    for i in range(10):  # 10 > W=4 decisions missed
        assert tw.commit("N0", "svc", f"PUT k{i} {i}".encode(),
                         only=("N0", "N1")) == b"OK"
    tw.drop_backlog("N2")
    tw.recover("N2")
    for _ in range(200):
        tw.spin(1)
        if (tw.tapps["N2"].db.get("svc", {}).get("k9") == "9"
                and tw.t["N2"].stats.get("ckpt_transfers", 0) >= 1):
            break
    assert tw.tapps["N2"].db["svc"]["k9"] == "9"
    assert tw.t["N2"].stats["ckpt_transfers"] >= 1, dict(tw.t["N2"].stats)
    tw.check_wal()
    # the adopted transfer is journaled: crash again, recover, still there
    tw.kill("N2")
    tw.check_wal()
    tw.cross_recover("N2", tmp_path / "cross")
    tw.recover("N2")
    assert tw.tapps["N2"].db["svc"]["k9"] == "9"


def test_ckpt_donation_consistent_under_pipelined_tick(tmp_path):
    """``test_modeb.py:295`` with a journal: a donor with a pipelined tick
    in flight donates a watermark its app blob covers; both packages'
    replies and journals are equal."""
    import json

    jcfg, tcfg = make_cfgs(window=4, pipeline_ticks=True)
    sides = []
    for cfg, Node, Logger, Net, app, side in (
            (jcfg, JNode, JLogger, JNet, jrep.KVApp(), "jax"),
            (tcfg, TNode, TLogger, TNet, trep.KVApp(), "torch")):
        kw = {"device": "cpu"} if side == "torch" else {}
        net = Net(seed=0)
        node = Node(cfg, ["N0"], "N0", app, net.messenger("N0"),
                    wal=Logger(str(tmp_path / side), native=False), **kw)
        sent = []
        node.m.send = lambda dest, pkt, sent=sent: sent.append((dest, pkt))
        node.create_group("svc", [0])
        done = []
        node.propose("svc", b"PUT a 1", lambda r, v: done.append(v))
        for _ in range(12):
            node.tick()
            if done:
                break
        assert done == [b"OK"]
        # one more decision INTO the pipeline: executed on the device, not
        # yet delivered on the host
        node.propose("svc", b"PUT b 2", lambda r, v: done.append(v))
        node.tick()
        node._on_ckpt_req("N9", {"gid": str(jwire.gid_of("svc"))})
        assert sent, "no checkpoint reply produced"
        sides.append((node, sent[-1][1]))
    (jn, jreply), (tn, treply) = sides
    assert jreply == treply
    row = tn.rows.row("svc")
    blob = bytes.fromhex(treply["state"])
    db = json.loads(blob.decode()) if blob else {}
    wm = int(treply["exec_slot"])
    assert wm == int(tn.state.exec_slot[0, row])
    if wm >= 3:  # create-noop + two puts
        assert db.get("b") == "2", (wm, db)
    assert db.get("a") == "1", (wm, db)
    for n in (jn, tn):
        n.wal.journal.sync()
    a, b = wal_files(tmp_path / "jax"), wal_files(tmp_path / "torch")
    assert a == b and a
    cross_recover_dirs((jcfg, tcfg), ["N0"], "N0", APPS["kv"],
                       tmp_path / "jax", tmp_path / "torch",
                       tmp_path / "cross")


def run_random_kill_restart(tw, seed, steps=30):
    """``test_modeb.py:344``'s property on the twin: random commits at
    random nodes under random single-node deaths and journal restarts
    (majority always alive, backlogs dropped on outage); every response
    released to a client converges onto every node's app."""
    rng = np.random.default_rng(seed)
    pending = {}
    dead = None
    kills = 0
    tw.create("svc")
    n = 0
    for step in range(steps):
        if dead is None and rng.random() < 0.2:
            dead = IDS[int(rng.integers(0, 3))]
            tw.kill(dead)
            kills += 1
        elif dead is not None and rng.random() < 0.4:
            tw.drop_backlog(dead)
            tw.recover(dead)
            dead = None
        at = str(rng.choice([i for i in IDS if i != dead]))
        n += 1
        k, v = f"k{n}", str(step)
        tag, rid = tw.propose(at, "svc", f"PUT {k} {v}".encode())
        if rid is None:
            continue
        pending[k] = (v, tag)
        for _ in range(240):
            tw.spin(1)
            if tw.got(tag):
                break
    if dead is not None:
        tw.drop_backlog(dead)
        tw.recover(dead)

    def released():
        return {k: v for k, (v, tag) in pending.items()
                if b"OK" in tw.got(tag)}

    for _ in range(400):
        tw.spin(1)
        rel = released()
        if rel and all(tw.tapps[nid].db.get("svc", {}).get(k) == v
                       for nid in IDS for k, v in rel.items()):
            break
    rel = released()
    for nid in IDS:
        db = tw.tapps[nid].db.get("svc", {})
        missing = {k: v for k, v in rel.items() if db.get(k) != v}
        assert not missing, (nid, len(missing))
    assert rel
    return kills


@pytest.mark.parametrize("seed", [1, 4, 9])
def test_random_kill_restart_released_writes_converge(tmp_path, seed):
    tw = Twin(make_cfgs(window=4), wal_root=tmp_path / "wal")
    run_random_kill_restart(tw, seed)
    tw.check_wal()
    for nid in IDS:
        tw.t[nid].wal.journal.sync()
        tw.j[nid].wal.journal.sync()
    tw.check_wal()
    tw.cross_recover("N0", tmp_path / "cross")
