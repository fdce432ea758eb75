"""Mode B durability twin, the planes' crash cases: digest accepts
(``test_modeb_digest.py:111``), pause/spill (``test_modeb_pause.py:63``),
the device app (``test_modeb_device.py:93``), universe expansion
(``test_modeb_expand.py:158``) and a scribbled journal's degraded
recovery, each with a ``ModeBLogger`` on every node in both packages.

As in ``test_torch_modeb_wal.py``: the reference's and the port's nodes run
in lockstep over their ``SimNet``s (``test_torch_modeb.Twin``) and are held
equal after every step with tolerance 0; journal and snapshot files are
byte-equal to the reference's; each package recovers the other's
directory.
"""

import os
import random
import shutil
import struct

import pytest
import torch

from gigapaxos_tpu.modeb import ModeBNode as JNode
from gigapaxos_tpu.modeb import recover_modeb as jrecover
from gigapaxos_tpu.testing import faultdisk as jfd
from gigapaxos_tpu.wal.logger import WalQuarantinedError as \
    JWalQuarantinedError
from gigapaxos_tpu_torch.models.device_kv import (OP_GET, OP_PUT,
                                                  pack_desc)
from gigapaxos_tpu_torch.modeb import ModeBNode as TNode
from gigapaxos_tpu_torch.modeb import recover_modeb as trecover
from gigapaxos_tpu_torch.testing import faultdisk as tfd
from gigapaxos_tpu_torch.wal.journal import scan_journal
from gigapaxos_tpu_torch.wal.logger import WalQuarantinedError
from test_torch_modeb import APPS, IDS, Twin, assert_same_node, make_cfgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_digest_survives_crash_recovery(tmp_path):
    """Digest placements journal with payload None; frames and undigest
    fills re-learn payloads; the recovered node matches its pre-crash app
    and catches up."""
    tw = Twin(make_cfgs(digest_accepts=True), wal_root=tmp_path / "wal")
    tw.create("svc")
    for i in range(6):
        assert tw.commit(IDS[i % 3], "svc",
                         f"PUT k{i} v{i}".encode()) == b"OK"
    tw.spin(10)
    expect = dict(tw.tapps["N1"].db.get("svc", {}))
    tw.kill("N1")
    tw.drop_backlog("N1")
    assert tw.commit("N0", "svc", b"PUT late 1",
                     only=("N0", "N2")) == b"OK"
    tw.check_wal()
    tw.cross_recover("N1", tmp_path / "cross")
    tw.recover("N1")
    assert dict(tw.tapps["N1"].db.get("svc", {})) == expect
    for _ in range(100):
        tw.spin(2)
        if tw.tapps["N1"].db.get("svc", {}).get("late") == "1":
            break
    assert tw.tapps["N1"].db["svc"]["late"] == "1"
    assert tw.commit("N1", "svc", b"PUT post 2") == b"OK"
    tw.check_wal()


def test_pause_survives_crash_recovery(tmp_path):
    """Five groups on four rows force a spill; the paused set and the
    spilled groups' state come back from the journal."""
    tw = Twin(make_cfgs(groups=4, deactivation_ticks=4),
              wal_root=tmp_path / "wal")
    for i in range(5):
        tw.create(f"g{i}")
        assert tw.commit("N0", f"g{i}", f"PUT k v{i}".encode()) == b"OK"
    n0 = tw.t["N0"]
    assert n0.paused_count() >= 1
    paused = [f"g{i}" for i in range(5) if n0.rows.row(f"g{i}") is None]
    for side in (tw.j, tw.t):
        side["N0"].wal.journal.sync()
    tw.check_wal()
    tw.cross_recover("N0", tmp_path / "cross")
    jcfg, tcfg = tw.cfgs
    jb = jrecover(jcfg, IDS, "N0", APPS["kv"][0](), tw.wal_dir("jax", "N0"),
                  native=False)
    tb = trecover(tcfg, IDS, "N0", APPS["kv"][1](),
                  tw.wal_dir("torch", "N0"), native=False, device="cpu")
    assert_same_node(jb, tb)
    assert tb.paused_count() == n0.paused_count()
    for name in paused:
        assert name in tb._paused
        assert jb._unpause(name) == tb._unpause(name) is not None
        assert tb.group_members(name) == [0, 1, 2]
    assert_same_node(jb, tb)


def test_device_crash_recovery_from_own_journal(tmp_path):
    """Device-app nodes: N1 dies, the survivors commit on, N1 comes back
    with identical device arrays and catches up."""
    tw = Twin(make_cfgs(device_app=True), wal_root=tmp_path / "wal",
              app="device")
    tw.create("svc")
    for i in range(6):
        assert tw.commit(IDS[i % 3], "svc", pack_desc(OP_PUT, i + 1,
                                                      10 + i)) == \
            struct.pack("<i", 10 + i)
    tw.spin(10)
    row = tw.t["N1"].rows.row("svc")
    pre = (tw.t["N1"].kv.key[0, row].clone(),
           tw.t["N1"].kv.val[0, row].clone())
    tw.kill("N1")
    tw.drop_backlog("N1")
    assert tw.commit("N0", "svc", pack_desc(OP_PUT, 2, 999),
                     only=("N0", "N2")) == struct.pack("<i", 999)
    tw.check_wal()
    tw.cross_recover("N1", tmp_path / "cross")
    node = tw.recover("N1")
    row = node.rows.row("svc")
    assert torch.equal(node.kv.key[0, row], pre[0])
    assert torch.equal(node.kv.val[0, row], pre[1])
    for _ in range(100):
        tw.spin(2)
        if 999 in node.kv.val[0, node.rows.row("svc")].tolist():
            break
    assert 999 in node.kv.val[0, node.rows.row("svc")].tolist()
    assert tw.commit("N1", "svc", pack_desc(OP_GET, 2, 0)) == \
        struct.pack("<i", 999)
    tw.check_wal()


def test_expand_survives_wal_recovery(tmp_path):
    """Journal replay rebuilds an expanded universe (``OP_EXPAND``), and a
    snapshot taken after it carries the member list."""
    ids = ["B0", "B1", "B2"]
    tw = Twin(make_cfgs(groups=32), ids=ids, wal_root=tmp_path / "wal")
    tw.create("g")
    assert tw.commit("B0", "g", b"PUT x 9") == b"OK"
    # node addition: every member expands, then the newcomer boots with
    # the expanded topology
    for nid in ids:
        assert tw.both(nid, "expand_universe", ["B3"])
    tw.ids.append("B3")
    jcfg, tcfg = tw.cfgs
    tw.japps["B3"], tw.tapps["B3"] = APPS["kv"][0](), APPS["kv"][1]()
    tw.j["B3"] = JNode(jcfg, tw.ids, "B3", tw.japps["B3"],
                       tw.jnet.messenger("B3"), wal=tw._wal("jax", "B3"),
                       anti_entropy_every=tw.anti_entropy_every)
    tw.t["B3"] = TNode(tcfg, tw.ids, "B3", tw.tapps["B3"],
                       tw.tnet.messenger("B3"), wal=tw._wal("torch", "B3"),
                       anti_entropy_every=tw.anti_entropy_every,
                       device="cpu")
    tw.create("h", members=(0, 1, 3))
    assert tw.commit("B0", "h", b"PUT y 8") == b"OK"
    tw.close()
    tw.check_wal()
    tw.cross_recover("B0", tmp_path / "cross", ids=ids)
    nodes = []
    for recover, app, side, kw in (
            (jrecover, APPS["kv"][0](), "jax", {}),
            (trecover, APPS["kv"][1](), "torch", {"device": "cpu"})):
        cfg = jcfg if side == "jax" else tcfg
        n0 = recover(cfg, ids, "B0", app, tw.wal_dir(side, "B0"),
                     native=False, **kw)
        assert n0.members == ["B0", "B1", "B2", "B3"] and n0.R == 4
        assert n0.app.db.get("h", {}).get("y") == "8"
        n0.wal.checkpoint()
        n0.wal.close()
        nodes.append(n0)
    assert_same_node(*nodes)
    tw.check_wal(["B0"])
    again = []
    for recover, app, side, kw in (
            (jrecover, APPS["kv"][0](), "jax", {}),
            (trecover, APPS["kv"][1](), "torch", {"device": "cpu"})):
        cfg = jcfg if side == "jax" else tcfg
        n0b = recover(cfg, ids, "B0", app, tw.wal_dir(side, "B0"),
                      native=False, **kw)
        assert n0b.members == ["B0", "B1", "B2", "B3"] and n0b.R == 4
        assert n0b.app.db.get("g", {}).get("x") == "9"
        again.append(n0b)
    assert_same_node(*again)


def test_scribbled_journal_recovers_degraded_and_repairs(tmp_path):
    """A bit flipped inside the fsynced region of a dead node's journal
    (``test_storage_faults.py:457``'s damage on a three-node twin): the
    journal is quarantined byte for byte, every own row is tainted and the
    taint is journaled, and peer checkpoint transfers clear it — in both
    packages alike.  With ``allow_degraded=False`` both fail-stop."""
    tw = Twin(make_cfgs(), wal_root=tmp_path / "wal")
    for name in ("a", "b"):
        tw.create(name)
        assert tw.commit("N0", name, f"PUT {name} 1".encode()) == b"OK"
    tw.spin(4)
    tw.kill("N2")
    tw.check_wal()
    paths = {side: tfd.newest_journal(tw.wal_dir(side, "N2"))
             for side in ("jax", "torch")}
    off = os.path.getsize(paths["torch"]) // 2
    for side, fd in (("jax", jfd), ("torch", tfd)):
        assert fd.flip_byte(paths[side], offset=off,
                            rng=random.Random(7)) == off
        assert scan_journal(paths[side]).kind == "scribble"
    damaged = {side: open(p, "rb").read() for side, p in paths.items()}
    assert damaged["jax"] == damaged["torch"]
    # fail-stop without permission to degrade (a copy of each directory)
    jcfg, tcfg = tw.cfgs
    d = tmp_path / "strict"
    shutil.copytree(tw.wal_dir("jax", "N2"), d / "jax")
    shutil.copytree(tw.wal_dir("torch", "N2"), d / "torch")
    with pytest.raises(JWalQuarantinedError):
        jrecover(jcfg, IDS, "N2", APPS["kv"][0](), str(d / "jax"),
                 native=False, allow_degraded=False)
    with pytest.raises(WalQuarantinedError):
        trecover(tcfg, IDS, "N2", APPS["kv"][1](), str(d / "torch"),
                 native=False, allow_degraded=False, device="cpu")
    node = tw.recover("N2", allow_degraded=True)
    assert node.recovered_degraded and tw.j["N2"].recovered_degraded
    assert node._tainted_rows == set(dict(node.rows.items()).values())
    for side in ("jax", "torch"):
        assert open(paths[side] + ".quarantined", "rb").read() == \
            damaged[side]
        assert scan_journal(paths[side]).kind == "clean"
    tw.check_wal()
    for _ in range(200):
        tw.spin(1)
        if not tw.t["N2"]._tainted_rows:
            break
    assert not tw.t["N2"]._tainted_rows and not tw.j["N2"]._tainted_rows
    assert tw.t["N2"].stats["ckpt_transfers"] >= 2
    for name in ("a", "b"):
        assert tw.tapps["N2"].db[name] == {name: "1"}
    assert tw.commit("N2", "a", b"PUT c 2") == b"OK"
    tw.check_wal()
    tw.cross_recover("N2", tmp_path / "cross")
