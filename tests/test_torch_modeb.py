"""Mode B node twin: three of the port's ``ModeBNode``s on the port's
``SimNet`` against three of the reference's on the reference's ``SimNet``,
same seed, same tick-and-pump schedule, on the CPU.

Tolerance: 0.  After every node tick the two nodes' states (every field),
coordinator views, tick counts and stats must be equal; after every tick
and every pump the bytes each side put on its wire (replica frame batches,
relay slabs with their wall-clock stamp masked, JSON control packets) must
be equal, and so must the client responses and the app states.  The
scenarios are the SimNet-able cases of the reference's ``test_modeb.py``,
``test_modeb_partition.py`` and ``test_fast_reelection.py``; the digest,
pause and device-app cases are in ``test_torch_modeb_planes.py``.  One
case runs the port alone over its real loopback ``Messenger``.
"""

import glob
import itertools
import os
import shutil
import time

import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu.models import device_kv as jdkv
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.modeb import ModeBLogger as JLogger
from gigapaxos_tpu.modeb import ModeBNode as JNode
from gigapaxos_tpu.modeb import recover_modeb as jrecover
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu.testing.simnet import SimNet as JNet
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.modeb import ModeBLogger as TLogger
from gigapaxos_tpu_torch.modeb import ModeBNode as TNode
from gigapaxos_tpu_torch.modeb import recover_modeb as trecover
from gigapaxos_tpu_torch.modeb import wire as twire
from gigapaxos_tpu_torch.net.messenger import Messenger, NodeMap
from gigapaxos_tpu_torch.paxos import state as tst
from gigapaxos_tpu_torch.testing.simnet import SimNet as TNet

IDS = ["N0", "N1", "N2"]
#: byte range of the relay header's wall-clock stamp (``<4sHiqdI``): the
#: one field two runs of the same schedule legitimately disagree on
_RELAY_SENT_S = slice(18, 26)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfgs(groups=16, window=8, **paxos):
    """The same settings in both packages' config classes."""
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.GigapaxosTpuConfig()
        cfg.paxos.max_groups = groups
        cfg.paxos.window = window
        for k, v in paxos.items():
            setattr(cfg.paxos, k, v)
        cfgs.append(cfg)
    return cfgs


def _rec_kv(base):
    class RecKV(base):
        """KVApp that records the executed payload sequence."""

        def __init__(self):
            super().__init__()
            self.trace = []

        def execute(self, name, request, request_id):
            self.trace.append((name, bytes(request)))
            return super().execute(name, request, request_id)

    return RecKV


APPS = {
    "kv": (jrep.KVApp, trep.KVApp),
    "rec": (_rec_kv(jrep.KVApp), _rec_kv(trep.KVApp)),
    "device": (lambda: None, lambda: None),
}


def _record(net, log):
    """Log every message the wire accepts for sending, in order."""
    orig = net._enqueue

    def enqueue(src, dst, kind, payload):
        if payload.startswith(twire.RELAY_MAGIC):
            b = bytearray(payload)
            b[_RELAY_SENT_S] = bytes(8)
            logged = bytes(b)
        else:
            logged = payload
        log.append((src, dst, kind, logged))
        orig(src, dst, kind, payload)

    net._enqueue = enqueue


def wal_files(d):
    """(name, bytes) of every journal and snapshot file of a WAL dir."""
    out = []
    for pattern in ("journal.*.log", "snapshot.*.bin"):
        for p in sorted(glob.glob(os.path.join(str(d), pattern))):
            with open(p, "rb") as f:
                out.append((os.path.basename(p), f.read()))
    return out


class Twin:
    """The same cluster in both packages, driven in lockstep and held equal
    after every step.  ``j``/``t`` are the reference's and the port's nodes
    by id; ``tapps`` the port's apps; ``resp`` the port's responses.

    With ``wal_root`` every node journals (``ModeBLogger``) into
    ``wal_root/jax/<id>`` and ``wal_root/torch/<id>`` (a snapshot every
    ``ckpt_every`` ticks); ``native`` picks the port's journal backend (the
    reference's always writes the Python one, whose bytes the native
    backend reproduces)."""

    def __init__(self, cfgs, ids=IDS, seed=0, anti_entropy_every=8,
                 app="kv", net=True, wal_root=None, native=False,
                 ckpt_every=1024):
        jcfg, tcfg = cfgs
        self.cfgs = cfgs
        self.app = app
        self.anti_entropy_every = anti_entropy_every
        self.wal_root = wal_root
        self.native = native
        self.wal_kw = dict(checkpoint_every_ticks=ckpt_every)
        self.ids = list(ids)
        self.jlog, self.tlog = [], []
        self.jnet = self.tnet = None
        if net:
            self.jnet, self.tnet = JNet(seed=seed), TNet(seed=seed)
            _record(self.jnet, self.jlog)
            _record(self.tnet, self.tlog)
        japp, tapp = APPS[app]
        self.japps = {n: japp() for n in ids}
        self.tapps = {n: tapp() for n in ids}
        self.j = {n: JNode(jcfg, self.ids, n, self.japps[n],
                           self.jnet.messenger(n) if net else None,
                           wal=self._wal("jax", n),
                           anti_entropy_every=anti_entropy_every)
                  for n in ids}
        self.t = {n: TNode(tcfg, self.ids, n, self.tapps[n],
                           self.tnet.messenger(n) if net else None,
                           wal=self._wal("torch", n),
                           anti_entropy_every=anti_entropy_every,
                           device="cpu")
                  for n in ids}
        if app == "device":  # the node builds its own DeviceKVApp
            self.japps = {n: self.j[n].app for n in ids}
            self.tapps = {n: self.t[n].app for n in ids}
        self.jresp, self.resp = [], []
        self._tags = itertools.count()

    def wal_dir(self, side, nid):
        return str(self.wal_root / side / nid)

    def _wal(self, side, nid):
        if self.wal_root is None:
            return None
        if side == "jax":
            return JLogger(self.wal_dir(side, nid), native=False,
                           **self.wal_kw)
        return TLogger(self.wal_dir(side, nid), native=self.native,
                       **self.wal_kw)

    # ------------------------------------------------------------- checks
    def check_node(self, nid):
        jn, tn = self.j[nid], self.t[nid]
        assert jn.tick_num == tn.tick_num, nid
        for f, a, b in zip(jst.PaxosState._fields, jn.state,
                           tst.state_to_numpy(tn.state)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                (nid, tn.tick_num, f)
        assert np.array_equal(np.asarray(jn._coord_view), tn._coord_view)
        if jn.kv is not None:
            for f, a, b in zip(jdkv.DeviceKVState._fields, jn.kv, tn.kv):
                assert np.array_equal(np.asarray(a), b.numpy()), (nid, f)
        assert dict(jn.stats) == dict(tn.stats), nid

    def check_wire(self):
        assert self.jlog == self.tlog
        self.jlog.clear()
        self.tlog.clear()

    def check_apps(self):
        assert self.jresp == self.resp
        for nid in self.ids:
            a, b = self.japps[nid], self.tapps[nid]
            if hasattr(a, "db"):
                assert a.db == b.db, nid
            if hasattr(a, "trace"):
                assert a.trace == b.trace, nid

    def check_all(self):
        for nid in self.j:
            self.check_node(nid)
        self.check_wire()
        self.check_apps()

    def check_wal(self, nids=None):
        """Every journal and snapshot file of each node is byte-equal to
        the reference's."""
        for nid in nids or self.ids:
            a = wal_files(self.wal_dir("jax", nid))
            b = wal_files(self.wal_dir("torch", nid))
            assert [n for n, _ in a] == [n for n, _ in b], nid
            for (name, x), (_, y) in zip(a, b):
                assert x == y, (nid, name)
            assert a, nid

    # ------------------------------------------------------------- driving
    def both(self, nid, method, *args, **kw):
        """Call ``method`` on both nodes ``nid``; the results must agree."""
        a = getattr(self.j[nid], method)(*args, **kw)
        b = getattr(self.t[nid], method)(*args, **kw)
        assert a == b, (nid, method, a, b)
        return b

    def create(self, name, members=(0, 1, 2), only=None):
        for nid in (only or list(self.j)):
            self.both(nid, "create_group", name, list(members))
        self.check_all()

    def propose(self, at, name, payload, stop=False):
        """Propose on both sides with tagged callbacks; returns (tag, rid)."""
        tag = next(self._tags)
        jr = self.j[at].propose(
            name, payload, lambda r, x: self.jresp.append((tag, r, x)),
            stop=stop)
        tr = self.t[at].propose(
            name, payload, lambda r, x: self.resp.append((tag, r, x)),
            stop=stop)
        assert jr == tr
        return tag, tr

    def got(self, tag):
        return [x for k, _r, x in self.resp if k == tag]

    def spin(self, k=1, only=None):
        for _ in range(k):
            for nid in self.ids:
                if nid in self.j and (only is None or nid in only):
                    self.j[nid].tick()
                    self.t[nid].tick()
                    self.check_node(nid)
            self.check_wire()
            if self.jnet is not None:
                assert self.jnet.pump() == self.tnet.pump()
                assert self.jnet.stats == self.tnet.stats
            self.check_all()

    def commit(self, at, name, payload, max_ticks=200, only=None):
        tag, rid = self.propose(at, name, payload)
        assert rid is not None
        for _ in range(max_ticks):
            self.spin(1, only=only)
            if self.got(tag):
                return self.got(tag)[0]
        raise AssertionError(f"no commit of {payload!r} at {at}")

    def set_alive(self, nid_of, r, up):
        for side in (self.j, self.t):
            side[nid_of].set_alive(r, up)

    def kill(self, nid):
        """Process death: transport gone, ticking stops; the survivors'
        failure view marks the slot dead."""
        for side in (self.j, self.t):
            side[nid].close()
            del side[nid]
        for other in self.j:
            self.set_alive(other, self.ids.index(nid), False)

    def drop_backlog(self, nid):
        """Discard what the wire still holds for or from a dead node (the
        transport's retries exhausted over a long outage)."""
        for net in (self.jnet, self.tnet):
            net.drop_pending(dst=nid)
            net.drop_pending(src=nid)

    def recover(self, nid, peer_streams=(None, None), sync=True, **kw):
        """Rebuild node ``nid`` from its own WAL in both packages (fresh
        apps), re-attach it to the wire and, with ``sync``, ask its peers
        for full frames; the survivors mark it alive again."""
        japp, tapp = APPS[self.app]
        ja, ta = japp(), tapp()
        jcfg, tcfg = self.cfgs
        jn = jrecover(jcfg, self.ids, nid, ja, self.wal_dir("jax", nid),
                      native=False, peer_stream=peer_streams[0], **kw)
        tn = trecover(tcfg, self.ids, nid, ta, self.wal_dir("torch", nid),
                      native=self.native, peer_stream=peer_streams[1],
                      device="cpu", **kw)
        self.japps[nid], self.tapps[nid] = ja, ta
        if self.app == "device":
            self.japps[nid], self.tapps[nid] = jn.app, tn.app
        self.j[nid], self.t[nid] = jn, tn
        self.check_node(nid)
        self.check_apps()
        if self.jnet is not None:
            jn.attach_messenger(self.jnet.messenger(nid))
            tn.attach_messenger(self.tnet.messenger(nid))
            for other in self.j:
                if other != nid:
                    self.set_alive(other, self.ids.index(nid), True)
            if sync:
                self.both(nid, "request_sync")
        return tn

    def cross_recover(self, nid, tmp, ids=None):
        """Each package recovers the other's copy of node ``nid``'s WAL
        (``ids``: the boot topology, when the universe grew since)."""
        cross_recover_dirs(self.cfgs, list(ids or self.ids), nid,
                           APPS[self.app], self.wal_dir("jax", nid),
                           self.wal_dir("torch", nid), tmp)

    def partition(self, *sides):
        for net in (self.jnet, self.tnet):
            net.partition(*sides)

    def heal(self):
        for net in (self.jnet, self.tnet):
            net.heal()

    def close(self):
        for side in (self.j, self.t):
            for n in side.values():
                n.close()


def cross_recover_dirs(cfgs, ids, nid, apps, jdir, tdir, tmp, **kw):
    """Each package recovers the other's copy of one node's WAL directory
    (``jdir`` written by the reference, ``tdir`` by the port) to the state
    its own package recovers from its own copy; ``apps`` are the two
    packages' app factories."""
    jcfg, tcfg = cfgs
    japp, tapp = apps
    shutil.copytree(jdir, tmp / "jax" / nid)
    shutil.copytree(tdir, tmp / "torch" / nid)
    own_j = jrecover(jcfg, ids, nid, japp(), str(jdir), native=False, **kw)
    own_t = trecover(tcfg, ids, nid, tapp(), str(tdir), native=False,
                     device="cpu", **kw)
    t_of_j = trecover(tcfg, ids, nid, tapp(), str(tmp / "jax" / nid),
                      native=False, device="cpu", **kw)
    j_of_t = jrecover(jcfg, ids, nid, japp(), str(tmp / "torch" / nid),
                      native=False, **kw)
    for jn, tn in ((own_j, own_t), (own_j, t_of_j), (j_of_t, own_t)):
        assert_same_node(jn, tn)
    for n in (own_j, own_t, t_of_j, j_of_t):
        n.wal.close()


def assert_same_node(jn, tn):
    """A reference node and a port node hold equal state, host bookkeeping
    and app state."""
    assert jn.tick_num == tn.tick_num
    assert jn.members == tn.members
    for f, a, b in zip(jst.PaxosState._fields, jn.state,
                       tst.state_to_numpy(tn.state)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if jn.kv is not None:
        for f, a, b in zip(jdkv.DeviceKVState._fields, jn.kv, tn.kv):
            assert np.array_equal(np.asarray(a), b.numpy()), f
    assert np.array_equal(np.asarray(jn._coord_view), tn._coord_view)
    assert dict(jn.rows.items()) == dict(tn.rows.items())
    assert jn._next_seq == tn._next_seq
    assert jn._tainted_rows == tn._tainted_rows
    assert sorted(jn.outstanding) == sorted(tn.outstanding)
    assert dict(jn.payloads.items()) == dict(tn.payloads.items())
    assert {k: list(v) for k, v in jn._queues.items() if v} == \
        {k: list(v) for k, v in tn._queues.items() if v}
    assert sorted(jn._paused) == sorted(tn._paused)
    if hasattr(jn.app, "db"):
        assert jn.app.db == tn.app.db


# ----------------------------------------------------- test_modeb.py cases
def test_commit_from_every_node():
    tw = Twin(make_cfgs())
    tw.create("svc")
    assert tw.commit("N0", "svc", b"PUT a 0") == b"OK"
    assert tw.commit("N1", "svc", b"PUT b 1") == b"OK"
    assert tw.commit("N2", "svc", b"PUT c 2") == b"OK"
    tw.spin(20)
    want = {"a": "0", "b": "1", "c": "2"}
    for nid in IDS:
        assert tw.tapps[nid].db["svc"] == want, nid


def test_coordinator_kill_majority_commits():
    tw = Twin(make_cfgs())
    tw.create("svc")
    assert tw.commit("N1", "svc", b"PUT pre 1") == b"OK"
    row = tw.t["N1"].rows.row("svc")
    assert int(tw.t["N1"]._coord_view[row]) == 0
    tw.kill("N0")
    assert tw.commit("N1", "svc", b"PUT post 2") == b"OK"
    assert tw.commit("N2", "svc", b"PUT post2 3") == b"OK"
    tw.spin(20)
    for nid in ("N1", "N2"):
        assert tw.tapps[nid].db["svc"]["post"] == "2"
        assert tw.tapps[nid].db["svc"]["post2"] == "3"
    assert int(tw.t["N1"]._coord_view[row]) == 1


def test_stop_request_fences_group():
    tw = Twin(make_cfgs())
    tw.create("svc")
    assert tw.commit("N0", "svc", b"PUT a 1") == b"OK"
    tag, _ = tw.propose("N0", "svc", b"", stop=True)
    tw.spin(40)
    assert tw.got(tag), "stop never committed"
    for nid in IDS:
        assert tw.both(nid, "is_stopped", "svc"), nid
    tag2, rid = tw.propose("N1", "svc", b"PUT b 2")
    assert rid is None
    tw.spin(5)
    assert tw.got(tag2) == [None]


def test_missed_birthing_whois():
    tw = Twin(make_cfgs())
    tw.create("late", only=("N0", "N1"))  # N2 never hears the create
    assert tw.commit("N0", "late", b"PUT x 9") == b"OK"
    for _ in range(100):
        tw.spin(1)
        if "late" in tw.t["N2"].rows:
            break
    assert "late" in tw.t["N2"].rows
    tw.spin(40)
    assert tw.tapps["N2"].db.get("late", {}).get("x") == "9"


def test_deep_laggard_checkpoint_transfer_in_memory():
    """A node cut off while the majority decides more than W slots cannot
    catch up by ring sync: after it rejoins (``request_sync``), the
    checkpoint transfer repairs it.  The reference's case restarts the node
    from its own journal; here the node keeps its memory and only loses
    the link (the journal comes with the Mode B durability slice)."""
    tw = Twin(make_cfgs(window=4))
    tw.create("svc")
    assert tw.commit("N0", "svc", b"PUT seed 0") == b"OK"
    tw.spin(10)
    tw.partition({"N2"}, {"N0", "N1"})
    for nid in ("N0", "N1"):
        tw.set_alive(nid, 2, False)
    for i in range(10):  # 10 > W=4 decisions missed
        assert tw.commit("N0", "svc", f"PUT k{i} {i}".encode(),
                         only=("N0", "N1")) == b"OK"
    tw.heal()
    for nid in ("N0", "N1"):
        tw.set_alive(nid, 2, True)
    tw.both("N2", "request_sync")
    for _ in range(120):
        tw.spin(1)
        if (tw.tapps["N2"].db.get("svc", {}).get("k9") == "9"
                and tw.t["N2"].stats.get("ckpt_transfers", 0) >= 1):
            break
    assert tw.tapps["N2"].db["svc"]["k9"] == "9"
    assert tw.t["N2"].stats["ckpt_transfers"] >= 1, dict(tw.t["N2"].stats)


# ------------------------------------------- test_modeb_partition.py cases
def test_isolated_node_never_commits():
    jcfg, tcfg = make_cfgs()
    tw = Twin((jcfg, tcfg), ids=IDS, app="rec")
    # only N0 exists on the wire: close the other two before any tick
    for nid in ("N1", "N2"):
        for side in (tw.j, tw.t):
            side[nid].close()
            del side[nid]
    tw.create("svc")
    tag, rid = tw.propose("N0", "svc", b"PUT x 1")
    assert rid is not None
    tw.spin(60)
    assert not tw.got(tag), "isolated minority committed (split brain)"
    assert tw.t["N0"].stats["executions"] == 0
    assert tw.tapps["N0"].db.get("svc", {}) == {}


def test_partition_two_coordinators_no_divergence():
    tw = Twin(make_cfgs(), app="rec")
    tw.create("svc")
    assert tw.commit("N0", "svc", b"PUT a 1") == b"OK"
    tw.spin(10)
    row = tw.t["N0"].rows.row("svc")
    assert int(tw.t["N0"]._coord_view[row]) == 0
    tw.partition({"N0"}, {"N1", "N2"})
    for nid in ("N1", "N2"):
        tw.set_alive(nid, 0, False)
    solo, _ = tw.propose("N0", "svc", b"PUT solo S")
    maj, _ = tw.propose("N1", "svc", b"PUT maj M")
    tw.spin(120)
    assert tw.got(maj) == [b"OK"]
    for nid in ("N1", "N2"):
        assert tw.tapps[nid].db["svc"]["maj"] == "M", nid
    assert not tw.got(solo), "isolated minority committed (split brain)"
    n0_trace = list(tw.tapps["N0"].trace)
    tw.heal()
    for nid in ("N1", "N2"):
        tw.set_alive(nid, 0, True)
    for _ in range(400):
        tw.spin(1)
        if tw.got(solo) and all(
                tw.tapps[n].db.get("svc", {}).get("solo") == "S"
                for n in IDS):
            break
    assert tw.got(solo) == [b"OK"]
    for nid in IDS:
        assert tw.tapps[nid].db["svc"] == {"a": "1", "maj": "M",
                                           "solo": "S"}, nid
    t1 = [p for _n, p in tw.tapps["N1"].trace]
    assert t1 == [p for _n, p in tw.tapps["N2"].trace]
    it = iter(t1)
    assert all(any(p == q for q in it)
               for _n, p in tw.tapps["N0"].trace)
    assert [p for _n, p in n0_trace] == [b"PUT a 1"]


def test_in_flight_frames_across_coordinator_change():
    tw = Twin(make_cfgs(), app="rec")
    tw.create("svc")
    assert tw.commit("N0", "svc", b"PUT k 0") == b"OK"
    tw.spin(5)
    for net in (tw.jnet, tw.tnet):
        net.set_delay("N0", "N1", 6, both_ways=False)
        net.set_delay("N0", "N2", 6, both_ways=False)
    for nid in ("N1", "N2"):
        tw.set_alive(nid, 0, False)
    assert tw.commit("N1", "svc", b"PUT k 1", only=("N1", "N2")) == b"OK"
    for nid in ("N1", "N2"):
        tw.set_alive(nid, 0, True)
    tw.spin(40)
    for nid in IDS:
        assert tw.tapps[nid].db["svc"]["k"] == "1", nid
    assert tw.tapps["N1"].trace == tw.tapps["N2"].trace


# ------------------------------------------ test_fast_reelection.py case
def _ticks_to_failover(fast):
    tw = Twin(make_cfgs(groups=8, window=8, fast_reelection=fast), seed=1)
    tw.create("svc")
    tag, _ = tw.propose("N0", "svc", b"PUT a 1")
    tw.spin(40)
    assert tw.got(tag) == [b"OK"]
    row = tw.t["N1"].rows.row("svc")
    assert int(tw.t["N1"]._coord_view[row]) == 0
    tw.partition({"N0"}, {"N1", "N2"})
    for nid in ("N1", "N2"):
        tw.set_alive(nid, 0, False)
    tag2, _ = tw.propose("N1", "svc", b"PUT b 2")
    t_coord = t_commit = None
    for t in range(1, 101):
        tw.spin(1, only=("N1", "N2"))
        if t_coord is None and int(tw.t["N1"]._coord_view[row]) == 1:
            t_coord = t
        if tw.got(tag2):
            t_commit = t
            break
    assert tw.got(tag2) == [b"OK"]
    return t_coord, t_commit


def test_modeb_fast_takeover_beats_full_prepare():
    """Both packages take the same number of ticks on each leg (the twin
    holds every tick equal), and the fast leg is strictly quicker."""
    full_coord, full_commit = _ticks_to_failover(fast=False)
    fast_coord, fast_commit = _ticks_to_failover(fast=True)
    assert fast_coord < full_coord, (fast_coord, full_coord)
    assert fast_commit < full_commit, (fast_commit, full_commit)
    assert fast_coord == 1


# ------------------------------------------------------ a WAL and expand
def test_wal_is_accepted_and_expansion_grows_both_packages(tmp_path):
    """A node takes a ``ModeBLogger``; the expansion grows both packages'
    nodes alike and journals the same ``OP_EXPAND`` bytes."""
    tw = Twin(make_cfgs(), net=False, wal_root=tmp_path)
    assert all(isinstance(n.wal, TLogger) for n in tw.t.values())
    tw.create("svc")
    for nid in IDS:
        tw.both(nid, "expand_universe", ["N3"])
        tw.check_node(nid)
        assert tw.t[nid].state.exec_slot.shape[0] == 4
        assert tw.t[nid].R == 4 and not tw.t[nid].alive[3]
    tw.check_wal()


# ------------------------------------ the port alone over real sockets
def test_commit_from_every_node_over_loopback_messenger():
    cfg = tconfig.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 16
    cfg.paxos.window = 8
    nodemap = NodeMap()
    msgs, apps, nodes = {}, {}, {}
    for nid in IDS:
        m = Messenger(nid, ("127.0.0.1", 0), nodemap)
        nodemap.add(nid, "127.0.0.1", m.port)
        msgs[nid] = m
    try:
        for nid in IDS:
            apps[nid] = trep.KVApp()
            nodes[nid] = TNode(cfg, IDS, nid, apps[nid], msgs[nid],
                               anti_entropy_every=16, device="cpu")
            nodes[nid].create_group("svc", [0, 1, 2])

        def commit(at, payload):
            done = []
            assert nodes[at].propose(
                "svc", payload, lambda _r, x: done.append(x)) is not None
            deadline = time.monotonic() + 60
            while not done and time.monotonic() < deadline:
                for n in nodes.values():
                    n.tick()
                time.sleep(0.005)
            assert done, f"no commit of {payload!r} at {at}"
            return done[0]

        assert commit("N0", b"PUT a 0") == b"OK"
        assert commit("N1", b"PUT b 1") == b"OK"
        assert commit("N2", b"PUT c 2") == b"OK"
        want = {"a": "0", "b": "1", "c": "2"}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                apps[n].db.get("svc") == want for n in IDS):
            for n in nodes.values():
                n.tick()
            time.sleep(0.005)
        for nid in IDS:
            assert apps[nid].db["svc"] == want, nid
    finally:
        for n in nodes.values():
            n.close()
        for m in msgs.values():
            m.close()
