"""Chain-over-Mode-B twin: the port's ``chain/modeb.py`` and
``chain/modeb_logger.py`` against the JAX package's, on the CPU (the port
with ``device="cpu"``), driven by the same seeded inputs.

Tolerance: 0.  The unit twins hold the own-row chain tick, the packed node
step, the frame extract and the mirror apply equal on seeded states.  The
three-node twins run both packages' ``ChainModeBNode``s over their
``SimNet``s with the same seed and schedule (the scenarios of the
reference's ``tests/test_chain_modeb.py``): after every node tick the two
nodes' states (every field), tick counts and stats must be equal, after
every tick and pump the bytes each side put on its wire must be equal, and
so must the responses and the app states.  The durable twins journal every
node (``ChainBLogger(native=False)``), hold journal and snapshot files
byte-equal, restart nodes from their own journals, and recover each
package's directory in the other.  One case runs the port alone over its
real loopback ``Messenger``.
"""

import glob
import itertools
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu.chain import modeb as jcm
from gigapaxos_tpu.chain import state as jcst
from gigapaxos_tpu.chain import tick as jct
from gigapaxos_tpu.chain.modeb_logger import ChainBLogger as JLogger
from gigapaxos_tpu.chain.modeb_logger import recover_chain_modeb as jrecover
from gigapaxos_tpu.modeb.coordinator import ModeBReplicaCoordinator as JCoord
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.testing.simnet import SimNet as JNet
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch.chain import modeb as tcm
from gigapaxos_tpu_torch.chain import state as tcst
from gigapaxos_tpu_torch.chain import tick as tct
from gigapaxos_tpu_torch.chain.modeb_logger import ChainBLogger as TLogger
from gigapaxos_tpu_torch.chain.modeb_logger import \
    recover_chain_modeb as trecover
from gigapaxos_tpu_torch.modeb.coordinator import \
    ModeBReplicaCoordinator as TCoord
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.net.messenger import Messenger, NodeMap
from gigapaxos_tpu_torch.testing.simnet import SimNet as TNet
from gigapaxos_tpu_torch.types import GroupStatus

IDS = ["C0", "C1", "C2"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfgs(groups=16, window=8):
    """The same settings in both packages' config classes."""
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.GigapaxosTpuConfig()
        cfg.paxos.max_groups = groups
        cfg.paxos.window = window
        cfgs.append(cfg)
    return cfgs


def same_state(j, t, what=""):
    for f, a, b in zip(tcst.ChainState._fields, j, tcst.state_to_numpy(t)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)


# ------------------------------------------------------------ unit twins
def seeded_states(seed, R=3, G=64, W=4):
    """A chain state of numpy arrays with mixed membership (empty, single,
    pairs, full chains), watermarks spread over the window (some chains'
    windows full: next_slot - min applied == W), rings holding the slots
    around each watermark (some planes empty), sparse stops, and a few
    stopped or free rows."""
    rng = np.random.default_rng(seed)
    member = rng.random((R, G)) < 0.7
    member[:, :4] = [[True] * 4, [True, True, False, False],
                     [True, False, True, False]]
    member[:, 4] = False
    n_members = member.sum(axis=0).astype(np.int32)
    base = rng.integers(0, 1000, G).astype(np.int32)
    applied = (base[None, :] + rng.integers(0, W + 1, (R, G))).astype(
        np.int32)
    applied = np.where(member, applied, 0).astype(np.int32)
    lo = np.where(member, applied, 1 << 30).min(axis=0)
    lo = np.where(n_members > 0, lo, 0)
    full = rng.random(G) < 0.3
    next_slot = np.where(full, lo + W,
                         np.maximum(applied.max(axis=0),
                                    lo + rng.integers(0, W + 1, G)))
    next_slot = np.minimum(next_slot, lo + W).astype(np.int32)
    c_slot = np.full((R, W, G), -1, np.int32)
    for r in range(R):
        for i in range(W):
            s = lo + ((i - lo) % W)  # the slot of plane i in [lo, lo+W)
            have = (s < next_slot) & (rng.random(G) < 0.85)
            c_slot[r, i] = np.where(have, s, -1)
    c_req = np.where(c_slot >= 0,
                     rng.integers(1, 1 << 24, (R, W, G)), 0).astype(np.int32)
    c_stop = (c_slot >= 0) & (rng.random((R, W, G)) < 0.05)
    status = np.where(member, int(GroupStatus.ACTIVE),
                      int(GroupStatus.FREE)).astype(np.int32)
    status[rng.integers(0, R, 3), rng.integers(0, G, 3)] = int(
        GroupStatus.STOPPED)
    epoch = rng.integers(0, 4, G).astype(np.int32)
    return (applied, status, c_req, c_slot, c_stop, next_slot.astype(
        np.int32), member, n_members, epoch)


def seeded_inbox(seed, R=3, P=3, G=64):
    rng = np.random.default_rng(seed + 1000)
    req = np.where(rng.random((P, G)) < 0.6,
                   rng.integers(1, 1 << 24, (P, G)), 0).astype(np.int32)
    stop = (req != 0) & (rng.random((P, G)) < 0.1)
    return req, stop


ALIVE = {"all": [True, True, True], "dead_head": [False, True, True],
         "dead_middle": [True, False, True]}


def both_states(seed):
    arrs = seeded_states(seed)
    return (jcst.ChainState(*(jnp.asarray(a) for a in arrs)),
            tcst.state_from_numpy(arrs, device=CPU))


def both_inboxes(seed, alive):
    req, stop = seeded_inbox(seed)
    a = np.array(alive, bool)
    return (jct.ChainInbox(jnp.asarray(req), jnp.asarray(stop),
                           jnp.asarray(a)),
            tct.ChainInbox(torch.from_numpy(req), torch.from_numpy(stop),
                           torch.from_numpy(a)))


@pytest.mark.parametrize("alive", sorted(ALIVE))
@pytest.mark.parametrize("r", [0, 1, 2])
def test_own_row_chain_tick_equals_reference(r, alive):
    """The tick a chain Mode B node runs (``own_row >= 0``): only the own
    row may take head intake.  Seeded states with mixed membership, full
    windows, a dead head or a dead middle replica."""
    for seed in (1, 2, 3):
        js, ts = both_states(seed)
        ji, ti = both_inboxes(seed, ALIVE[alive])
        jnew, jout = jct.chain_tick_impl(js, ji, own_row=r)
        tnew, tout = tct.chain_tick_impl(ts, ti, own_row=r)
        same_state(jnew, tnew, (seed, r, alive))
        for f, a, b in zip(tct.ChainOutbox._fields, jout, tout):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (seed, f)
        # the own-row confinement took effect: only row r takes intake
        taken = tout.intake_taken.numpy()
        heads = tout.head_id.numpy()
        assert not taken[:, heads != r].any()


@pytest.mark.parametrize("r", [0, 1, 2])
def test_packed_node_step_and_unpack_equal_reference(r):
    for seed in (4, 5):
        js, ts = both_states(seed)
        ji, ti = both_inboxes(seed, ALIVE["dead_middle" if seed == 5
                                          else "all"])
        jnew, jflat = jcm.chain_node_tick_packed(r)(js, ji)
        tnew, tflat = tcm.chain_node_tick_packed(r)(ts, ti)
        same_state(jnew, tnew, (seed, r))
        assert np.array_equal(np.asarray(jflat), tflat.numpy())
        jout, jch = jcm.unpack_chain_node_tick(jflat, 3, 3, 4, 64)
        tout, tch = tcm.unpack_chain_node_tick(tflat, 3, 3, 4, 64)
        assert np.array_equal(jch, tch) and tch.dtype == bool
        for f, a, b in zip(tct.HostChainOutbox._fields, jout, tout):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        # the merge: only row r moves, and next_slot only where r heads
        told = tcst.state_to_numpy(tcst.state_from_numpy(
            seeded_states(seed), device=CPU))
        tn = tcst.state_to_numpy(tnew)
        for f in ("applied", "status", "c_req", "c_slot", "c_stop"):
            a, b = getattr(told, f), getattr(tn, f)
            keep = [i for i in range(3) if i != r]
            assert np.array_equal(a[keep], b[keep]), f


@pytest.mark.parametrize("n", [1, 5, 16, 23])
def test_frame_extract_equals_reference(n):
    js, ts = both_states(6)
    K = max(16, 1 << max(0, int(n - 1).bit_length()))
    rows = np.zeros(K, np.int32)
    rows[:n] = np.random.default_rng(n).choice(64, n, replace=False)
    for r in range(3):
        jf = np.asarray(jcm.chain_frame_extract(r, K)(js, jnp.asarray(rows)))
        tf = tcm.chain_frame_extract(r, K)(ts, torch.from_numpy(rows))
        assert np.array_equal(jf, tf.numpy())
        for a, b in zip(jcm.unpack_chain_frame_extract(jf, n, K, 4),
                        tcm.unpack_chain_frame_extract(tf, n, K, 4)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("K,W", [(16, 4), (16, 16), (8, 8)])
def test_mirror_apply_padded_rows_equals_reference(K, W):
    """Rows padded with G (dropped by the reference's scatter), next_slot
    adopted only at head rows, and K == W, where a plain torch index
    assignment would write the rings transposed."""
    G, R = 64, 3
    rng = np.random.default_rng(K * 100 + W)
    arrs = list(seeded_states(7, R=R, G=G, W=W))
    js = jcst.ChainState(*(jnp.asarray(a) for a in arrs))
    ts = tcst.state_from_numpy(arrs, device=CPU)
    n = K - 3
    rows = np.full(K, G, np.int32)
    rows[:n] = rng.choice(G, n, replace=False)
    head_rows = np.where(rng.random(K) < 0.5, rows, G).astype(np.int32)
    scal = rng.integers(-5, 1 << 20, (3, K)).astype(np.int32)
    rings = rng.integers(-1, 1 << 20, (2, K, W)).astype(np.int32)
    bits = rng.random((K, W)) < 0.3
    for sr in (0, 2):
        js = jcm.chain_mirror_apply_impl(
            js, jnp.int32(sr), jnp.asarray(rows), jnp.asarray(scal),
            jnp.asarray(bits), jnp.asarray(rings), jnp.asarray(head_rows))
        ts = tcm.chain_mirror_apply_impl(ts, sr, rows, scal, bits, rings,
                                         head_rows)
        same_state(js, ts, sr)
    # the writes landed where the frame says, not transposed
    got = tcst.state_to_numpy(ts)
    assert np.array_equal(got.c_req[2][:, rows[:n]].T, rings[0, :n])


# --------------------------------------------------- the three-node twin
def wal_files(d):
    """(name, bytes) of every journal and snapshot file of a WAL dir."""
    out = []
    for pattern in ("journal.*.log", "snapshot.*.bin"):
        for p in sorted(glob.glob(os.path.join(str(d), pattern))):
            with open(p, "rb") as f:
                out.append((os.path.basename(p), f.read()))
    return out


class ChainTwin:
    """The same chain deployment in both packages, driven in lockstep over
    the two ``SimNet``s and held equal after every step.  ``j``/``t`` are
    the reference's and the port's nodes by id; ``tapps`` the port's apps;
    ``resp`` the port's responses.  With ``wal_root`` every node journals
    into ``wal_root/jax/<id>`` and ``wal_root/torch/<id>``."""

    def __init__(self, cfgs, ids=IDS, seed=0, anti_entropy_every=16,
                 wal_root=None, ckpt_every=1024):
        self.cfgs = cfgs
        self.ids = list(ids)
        self.wal_root = wal_root
        self.wal_kw = dict(checkpoint_every_ticks=ckpt_every)
        self.ae = anti_entropy_every
        self.jlog, self.tlog = [], []
        self.jnet, self.tnet = JNet(seed=seed), TNet(seed=seed)
        for net, log in ((self.jnet, self.jlog), (self.tnet, self.tlog)):
            orig = net._enqueue

            def enqueue(src, dst, kind, payload, _o=orig, _l=log):
                _l.append((src, dst, kind, payload))
                _o(src, dst, kind, payload)

            net._enqueue = enqueue
        self.japps = {n: jrep.KVApp() for n in ids}
        self.tapps = {n: trep.KVApp() for n in ids}
        self.j = {n: self._jnode(n, self.ids) for n in ids}
        self.t = {n: self._tnode(n, self.ids) for n in ids}
        self.jresp, self.resp = [], []
        self._tags = itertools.count()

    def _jnode(self, nid, ids):
        return jcm.ChainModeBNode(
            self.cfgs[0], ids, nid, self.japps[nid],
            self.jnet.messenger(nid), wal=self._wal("jax", nid),
            anti_entropy_every=self.ae)

    def _tnode(self, nid, ids):
        return tcm.ChainModeBNode(
            self.cfgs[1], ids, nid, self.tapps[nid],
            self.tnet.messenger(nid), wal=self._wal("torch", nid),
            anti_entropy_every=self.ae, device="cpu")

    def wal_dir(self, side, nid):
        return str(self.wal_root / side / nid)

    def _wal(self, side, nid):
        if self.wal_root is None:
            return None
        cls = JLogger if side == "jax" else TLogger
        return cls(self.wal_dir(side, nid), native=False, **self.wal_kw)

    # ------------------------------------------------------------- checks
    def check_node(self, nid):
        jn, tn = self.j[nid], self.t[nid]
        assert jn.tick_num == tn.tick_num, nid
        same_state(jn.state, tn.state, (nid, tn.tick_num))
        assert dict(jn.stats) == dict(tn.stats), nid
        assert jn._stopped_rows == tn._stopped_rows, nid

    def check_all(self):
        for nid in self.j:
            self.check_node(nid)
        assert self.jlog == self.tlog
        self.jlog.clear()
        self.tlog.clear()
        assert self.jresp == self.resp
        for nid in self.ids:
            assert self.japps[nid].db == self.tapps[nid].db, nid

    def check_wal(self, nids=None):
        for nid in nids or self.ids:
            a = wal_files(self.wal_dir("jax", nid))
            b = wal_files(self.wal_dir("torch", nid))
            assert a and [n for n, _ in a] == [n for n, _ in b], nid
            for (name, x), (_, y) in zip(a, b):
                assert x == y, (nid, name)

    # ------------------------------------------------------------- driving
    def both(self, nid, method, *args, **kw):
        a = getattr(self.j[nid], method)(*args, **kw)
        b = getattr(self.t[nid], method)(*args, **kw)
        assert a == b, (nid, method, a, b)
        return b

    def create(self, name, members=(0, 1, 2), only=None):
        for nid in (only or list(self.j)):
            self.both(nid, "create_group", name, list(members))
        self.check_all()

    def propose(self, at, name, payload, stop=False):
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
            assert self.jnet.pump() == self.tnet.pump()
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
        """Process death: transport gone, ticking stops, what the wire
        holds for or from it dropped; the survivors mark the slot dead."""
        for side in (self.j, self.t):
            side[nid].close()
            if side[nid].wal is not None:
                side[nid].wal.close()
            del side[nid]
        for net in (self.jnet, self.tnet):
            net.drop_pending(dst=nid)
            net.drop_pending(src=nid)
        for other in self.j:
            self.set_alive(other, self.ids.index(nid), False)

    def restart(self, nid):
        """Rebuild ``nid`` from its own journal in both packages (fresh
        apps), re-attach it to the wire, ask for full frames."""
        jcfg, tcfg = self.cfgs
        self.japps[nid], self.tapps[nid] = jrep.KVApp(), trep.KVApp()
        jn = jrecover(jcfg, self.ids, nid, self.japps[nid],
                      self.wal_dir("jax", nid), native=False)
        tn = trecover(tcfg, self.ids, nid, self.tapps[nid],
                      self.wal_dir("torch", nid), native=False,
                      device="cpu")
        self.j[nid], self.t[nid] = jn, tn
        self.check_node(nid)
        assert self.japps[nid].db == self.tapps[nid].db
        jn.attach_messenger(self.jnet.messenger(nid))
        tn.attach_messenger(self.tnet.messenger(nid))
        for other in self.j:
            if other != nid:
                self.set_alive(other, self.ids.index(nid), True)
        self.both(nid, "request_sync")
        return tn

    def close(self):
        for side in (self.j, self.t):
            for n in side.values():
                n.close()
                if n.wal is not None:
                    n.wal.close()


def test_commit_at_head_and_by_forward():
    tw = ChainTwin(make_cfgs())
    tw.create("svc")
    assert tw.commit("C0", "svc", b"PUT a 1") == b"OK"
    assert tw.commit("C2", "svc", b"PUT b 2") == b"OK"
    tw.spin(30)
    for nid in IDS:
        assert tw.tapps[nid].db["svc"] == {"a": "1", "b": "2"}, nid
    assert tw.t["C2"].stats["forwarded"] == 1


def test_midchain_death_relinks():
    tw = ChainTwin(make_cfgs())
    tw.create("svc")
    assert tw.commit("C0", "svc", b"PUT pre 0") == b"OK"
    tw.kill("C1")
    assert tw.commit("C0", "svc", b"PUT post 1", only=("C0", "C2")) == b"OK"
    tw.spin(20, only=("C0", "C2"))
    for nid in ("C0", "C2"):
        assert tw.tapps[nid].db["svc"]["post"] == "1", nid


def test_tail_death_moves_commit_point():
    tw = ChainTwin(make_cfgs())
    tw.create("svc")
    assert tw.commit("C0", "svc", b"PUT pre 0") == b"OK"
    tw.kill("C2")
    assert tw.commit("C0", "svc", b"PUT post 1", only=("C0", "C1")) == b"OK"
    assert tw.commit("C1", "svc", b"PUT more 2", only=("C0", "C1")) == b"OK"
    tw.spin(20, only=("C0", "C1"))
    for nid in ("C0", "C1"):
        assert tw.tapps[nid].db["svc"]["more"] == "2", nid


def test_missed_create_catches_up():
    tw = ChainTwin(make_cfgs())
    W = tw.cfgs[1].paxos.window
    tw.create("deep", only=("C0", "C1"))
    for nid in ("C0", "C1"):
        tw.set_alive(nid, 2, False)
    for i in range(W):
        assert tw.commit("C0", "deep", f"PUT k{i} {i}".encode(),
                         only=("C0", "C1")) == b"OK"
    for nid in ("C0", "C1"):
        tw.set_alive(nid, 2, True)
    for _ in range(200):
        tw.spin(1)
        if tw.tapps["C2"].db.get("deep", {}).get(f"k{W - 1}") is not None:
            break
    assert tw.tapps["C2"].db["deep"] == tw.tapps["C0"].db["deep"]
    assert tw.commit("C1", "deep", b"PUT post 9") == b"OK"


def test_stop_fences():
    tw = ChainTwin(make_cfgs())
    tw.create("svc")
    assert tw.commit("C0", "svc", b"PUT a 1") == b"OK"
    tag, _ = tw.propose("C0", "svc", b"", stop=True)
    tw.spin(60)
    assert tw.got(tag), "stop never committed"
    for nid in IDS:
        assert tw.both(nid, "is_stopped", "svc"), nid
    tag2, rid = tw.propose("C1", "svc", b"PUT b 2")
    assert rid is None
    tw.spin(5)
    assert tw.got(tag2) == [None]


def test_expand_universe_commits_through_new_tail():
    tw = ChainTwin(make_cfgs())
    tw.create("old")
    assert tw.commit("C0", "old", b"PUT a 1") == b"OK"
    for nid in IDS:
        assert tw.both(nid, "expand_universe", ["C3"])
        tw.check_node(nid)
        assert tw.t[nid].state.applied.shape[0] == 4
    ids4 = IDS + ["C3"]
    tw.ids = ids4
    tw.japps["C3"], tw.tapps["C3"] = jrep.KVApp(), trep.KVApp()
    tw.j["C3"], tw.t["C3"] = tw._jnode("C3", ids4), tw._tnode("C3", ids4)
    for nid in IDS:
        tw.set_alive(nid, 3, True)
    tw.create("mix", members=(1, 2, 3))
    assert tw.commit("C1", "mix", b"PUT k v") == b"OK"
    assert tw.tapps["C3"].db.get("mix", {}).get("k") == "v"
    assert tw.commit("C2", "old", b"PUT b 2") == b"OK"


def test_coordinator_binds_the_chain_node():
    """``ModeBReplicaCoordinator`` duck-types over the chain node (the
    server's chain coordinator): the epoch-GC donor paths must not assume
    a pause tier."""
    tw = ChainTwin(make_cfgs())
    jc, tc = JCoord(tw.j["C0"]), TCoord(tw.t["C0"])
    for c in (jc, tc):
        assert c.create_replica_group("csvc", 0, b"", list(IDS))
        assert c.drop_final_state("csvc", -1)
        assert c.get_final_state("csvc", -1) is None
        assert c.final_state_gone("csvc", -1)
        assert c.drop_final_state("csvc", 0)
        assert c.get_final_state("csvc", 0) is None
    tw.check_node("C0")


# ------------------------------------------------------ the durable twins
def cross_recover(tw, nid, tmp):
    """Each package recovers the other's copy of ``nid``'s journal
    directory to the state its own package recovers from its own copy."""
    jcfg, tcfg = tw.cfgs
    jdir, tdir = tw.wal_dir("jax", nid), tw.wal_dir("torch", nid)
    shutil.copytree(jdir, tmp / "jax" / nid)
    shutil.copytree(tdir, tmp / "torch" / nid)
    own_j = jrecover(jcfg, IDS, nid, jrep.KVApp(), jdir, native=False)
    own_t = trecover(tcfg, IDS, nid, trep.KVApp(), tdir, native=False,
                     device="cpu")
    t_of_j = trecover(tcfg, IDS, nid, trep.KVApp(), str(tmp / "jax" / nid),
                      native=False, device="cpu")
    j_of_t = jrecover(jcfg, IDS, nid, jrep.KVApp(), str(tmp / "torch" / nid),
                      native=False)
    for jn, tn in ((own_j, own_t), (own_j, t_of_j), (j_of_t, own_t)):
        assert jn.tick_num == tn.tick_num
        same_state(jn.state, tn.state, nid)
        assert dict(jn.rows.items()) == dict(tn.rows.items())
        assert jn._next_seq == tn._next_seq
        assert sorted(jn.outstanding) == sorted(tn.outstanding)
        assert dict(jn.payloads.items()) == dict(tn.payloads.items())
        assert jn.app.db == tn.app.db
    for n in (own_j, own_t, t_of_j, j_of_t):
        n.wal.close()


def test_kill_restart_from_own_journal(tmp_path):
    tw = ChainTwin(make_cfgs(), wal_root=tmp_path / "w")
    try:
        tw.create("svc")
        assert tw.commit("C1", "svc", b"PUT k1 v1") == b"OK"
        tw.spin(10)
        db_c1 = dict(tw.tapps["C1"].db)
        tw.check_wal()
        tw.kill("C1")
        assert tw.commit("C0", "svc", b"PUT k2 v2", only=("C0", "C2")) == \
            b"OK"
        tw.restart("C1")
        assert tw.tapps["C1"].db == db_c1  # recovered locally, not copied
        for _ in range(200):
            tw.spin(1)
            if tw.tapps["C1"].db.get("svc", {}).get("k2") == "v2":
                break
        assert tw.tapps["C1"].db["svc"] == {"k1": "v1", "k2": "v2"}
        assert tw.commit("C1", "svc", b"PUT k3 v3") == b"OK"
        tw.check_wal()
        cross_recover(tw, "C1", tmp_path / "x")
        # a checkpoint inside every node's next tick: equal snapshot files
        for side in (tw.j, tw.t):
            for n in side.values():
                n.wal._ticks_since_ckpt = n.wal.checkpoint_every - 1
        tw.spin(1)
        assert tw.commit("C2", "svc", b"PUT k4 v4") == b"OK"
        tw.check_wal()
        snap_recover(tw, "C1", tmp_path / "s")
    finally:
        tw.close()


def snap_recover(tw, nid, tmp):
    """Recovery from a snapshot plus a journal tail.  The port recovers
    its own copy of ``nid``'s directory and the reference's (whose files
    are byte-equal) to the same node.  The reference's own
    ``recover_chain_modeb`` reads the snapshot file without stripping its
    checksum footer and fails; the port reads it as ``recover_modeb``
    does (``load_latest_snapshot``)."""
    tcfg = tw.cfgs[1]
    jdir, tdir = tw.wal_dir("jax", nid), tw.wal_dir("torch", nid)
    assert any(n.startswith("snapshot") for n, _ in wal_files(tdir))
    shutil.copytree(jdir, tmp / "jax")
    shutil.copytree(tdir, tmp / "torch")
    with pytest.raises(ValueError, match="trailing garbage"):
        jrecover(tw.cfgs[0], IDS, nid, jrep.KVApp(), str(tmp / "jax"),
                 native=False)
    a = trecover(tcfg, IDS, nid, trep.KVApp(), str(tmp / "torch"),
                 native=False, device="cpu")
    b = trecover(tcfg, IDS, nid, trep.KVApp(), str(tmp / "jax"),
                 native=False, device="cpu")
    live = tw.t[nid]
    for n in (a, b):
        assert n.tick_num == live.tick_num
        same_state(tcst.state_to_numpy(live.state), n.state, nid)
        assert dict(n.rows.items()) == dict(live.rows.items())
        assert n._next_seq == live._next_seq
        assert n.app.db == live.app.db
        n.wal.close()


@pytest.mark.parametrize("seed", [3, 14])
def test_random_kill_restart_released_writes_converge(tmp_path, seed):
    """Random commits under random single-node kills (head, middle or
    tail) and journal restarts: every released write converges onto every
    node's app, in both packages alike, and the journals stay equal."""
    rng = np.random.default_rng(seed)
    tw = ChainTwin(make_cfgs(), wal_root=tmp_path / "w")
    pending = {}
    dead = None
    try:
        tw.create("svc")
        cnt = 0
        for step in range(24):
            if dead is None and rng.random() < 0.3:
                dead = IDS[int(rng.integers(0, 3))]
                tw.kill(dead)
            elif dead is not None and rng.random() < 0.45:
                tw.restart(dead)
                dead = None
            at = str(rng.choice([i for i in IDS if i != dead]))
            cnt += 1
            k, v = f"h{cnt}", str(step)
            tag, rid = tw.propose(at, "svc", f"PUT {k} {v}".encode())
            if rid is None:
                continue
            pending[k] = (v, tag)
            for _ in range(100):
                tw.spin(1)
                if tw.got(tag):
                    break
        if dead is not None:
            tw.restart(dead)

        def released():
            return {k: v for k, (v, tag) in pending.items()
                    if b"OK" in tw.got(tag)}

        for _ in range(300):
            tw.spin(1)
            rel = released()
            if rel and all(tw.tapps[n].db.get("svc", {}).get(k) == v
                           for n in IDS for k, v in rel.items()):
                break
        rel = released()
        assert rel
        for nid in IDS:
            db = tw.tapps[nid].db.get("svc", {})
            assert all(db.get(k) == v for k, v in rel.items()), nid
        tw.check_wal()
        cross_recover(tw, "C2", tmp_path / "x")
    finally:
        tw.close()


# ------------------------------------ the port alone over real sockets
def test_commit_over_loopback_messenger():
    cfg = tconfig.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 16
    cfg.paxos.window = 8
    nodemap = NodeMap()
    msgs, apps, nodes = {}, {}, {}
    for nid in IDS:
        msgs[nid] = Messenger(nid, ("127.0.0.1", 0), nodemap)
        nodemap.add(nid, "127.0.0.1", msgs[nid].port)
    try:
        for nid in IDS:
            apps[nid] = trep.KVApp()
            nodes[nid] = tcm.ChainModeBNode(cfg, IDS, nid, apps[nid],
                                            msgs[nid], anti_entropy_every=16,
                                            device="cpu")
            nodes[nid].create_group("svc", [0, 1, 2])

        def commit(at, payload):
            done = []
            assert nodes[at].propose(
                "svc", payload, lambda _r, x: done.append(x)) is not None
            deadline = time.monotonic() + 60
            while not done and time.monotonic() < deadline:
                for n in nodes.values():
                    n.tick()
                time.sleep(0.004)
            assert done, f"no commit of {payload!r} at {at}"
            return done[0]

        assert commit("C0", b"PUT a 0") == b"OK"
        assert commit("C2", b"PUT b 1") == b"OK"
        want = {"a": "0", "b": "1"}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                apps[n].db.get("svc") == want for n in IDS):
            for n in nodes.values():
                n.tick()
            time.sleep(0.004)
        for nid in IDS:
            assert apps[nid].db["svc"] == want, nid
    finally:
        for n in nodes.values():
            n.close()
        for m in msgs.values():
            m.close()


def test_entry_points_default_to_cuda(tmp_path):
    cfg = make_cfgs()[1]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcm.ChainModeBNode(cfg, IDS, "C0", trep.KVApp())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trecover(cfg, IDS, "C0", trep.KVApp(), str(tmp_path), native=False)


def test_chip_smoke_chain_modeb_leg_on_cpu(tmp_path):
    """chip_smoke's ``chain-modeb-128k`` leg, small, on the CPU: the create,
    the waves with the tail crashed after round 2, its recovery to the
    pre-crash state and its repair by checkpoint transfers."""
    import chip_smoke
    from gigapaxos_tpu_torch.ops import plane_gather as pg

    r = chip_smoke.chain_modeb_leg(torch, pg, CPU, str(tmp_path), G=512,
                                   hot=64, outage=32, cpu_ticks=2)
    assert r["wave"]["commits"] == 2 * 64 + 2 * 32
    assert r["recovery"]["ckpt_transfers"] >= 32
    assert r["cpu_ticks_equal"] == 2 and r["acked"] == 193
