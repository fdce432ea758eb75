"""Chain replication twin: the port's ``chain/`` and ``wal/chain_logger.py``
against the JAX package's, on the CPU (the port with ``device="cpu"``),
driven by the same seeded inputs.

Tolerance: 0.  The chain state, the packed outbox, the executed streams,
the responses, the app states and the journal and snapshot bytes must be
equal; each package recovers the other's chain WAL directory.  The head
orders writes, propagation is one hop per tick, the commit point is the
tail, every member executes in head order, and a broken chain stalls until
reconfigured.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jcfg
from gigapaxos_tpu.chain import ChainManager as JChainManager
from gigapaxos_tpu.chain import state as jcst
from gigapaxos_tpu.chain import tick as jct
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.wal import ChainLogger as JChainLogger
from gigapaxos_tpu.wal import recover_chain as jrecover_chain
from gigapaxos_tpu_torch import config as tcfg
from gigapaxos_tpu_torch.chain import ChainManager as TChainManager
from gigapaxos_tpu_torch.chain import state as tcst
from gigapaxos_tpu_torch.chain import tick as tct
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.ops import plane_gather as tpg
from gigapaxos_tpu_torch.wal import ChainLogger as TChainLogger
from gigapaxos_tpu_torch.wal import recover_chain as trecover_chain

PORT, REF = "port", "ref"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twin:
    """The same chain state in both packages, ticked together; every tick
    holds the new states and the packed outboxes equal."""

    def __init__(self, R=3, G=4, W=8, P=4, members=None):
        self.R, self.G, self.P = R, G, P
        m = np.ones((G, R), bool) if members is None else members
        rows = np.arange(G, dtype=np.int32)
        self.j = jcst.create_groups(jcst.init_state(R, G, W), rows, m)
        self.t = tcst.create_groups(tcst.init_state(R, G, W, device=CPU),
                                    rows, m)

    def tick(self, req=None, stop=None, alive=None):
        P, G, R = self.P, self.G, self.R
        req = np.zeros((P, G), np.int32) if req is None else req
        stop = np.zeros((P, G), bool) if stop is None else stop
        alive = np.ones(R, bool) if alive is None else np.asarray(alive)
        self.j, jflat = jct.chain_tick_packed(
            self.j, jct.ChainInbox(jnp.asarray(req), jnp.asarray(stop),
                                   jnp.asarray(alive)))
        self.t, tflat = tct.chain_tick_packed(
            self.t, tct.ChainInbox(torch.from_numpy(req),
                                   torch.from_numpy(stop),
                                   torch.from_numpy(alive)))
        assert np.array_equal(np.asarray(jflat), tflat.numpy())
        for name, a, b in zip(tcst.ChainState._fields, self.j,
                              tcst.state_to_numpy(self.t)):
            assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b), \
                name
        return tct.unpack_chain_outbox(tflat, R, P,
                                       self.t.c_req.shape[1], G)

    @property
    def applied(self):
        return self.t.applied.numpy()


def test_hop_by_hop_propagation_and_tail_commit():
    tw = Twin()
    req = np.zeros((4, 4), np.int32)
    req[0, 0] = 101
    out = tw.tick(req=req)
    # the head applies at once; the tail has not seen it yet
    assert out.exec_count[0, 0] == 1 and out.exec_req[0, 0, 0] == 101
    assert out.committed_now[0] == 0
    out = tw.tick()  # hop to replica 1
    assert out.exec_count[1, 0] == 1
    out = tw.tick()  # hop to the tail -> commit
    assert out.exec_count[2, 0] == 1 and out.committed_now[0] == 1
    assert out.head_id[0] == 0 and out.tail_id[0] == 2


def test_pipelining_multiple_writes():
    tw = Twin(G=2)
    total = 0
    pending = list(range(100, 112))  # 12 writes > window of 8: backpressure
    for _ in range(12):
        req = np.zeros((4, 2), np.int32)
        batch = pending[:4]
        req[:len(batch), 0] = batch
        out = tw.tick(req=req)
        taken = out.intake_taken[:, 0]
        pending = ([rid for p, rid in enumerate(batch) if not taken[p]]
                   + pending[len(batch):])
        total += int(out.committed_now[0])
        if not pending and tw.applied[2, 0] == 12:
            break
    assert total == 12 and tw.applied[2, 0] == 12


def test_dead_middle_relinks_chain():
    """A dead middle member is routed around, so writes still commit at the
    live tail; on recovery it resumes from its own watermark."""
    tw = Twin(G=2)
    req = np.zeros((4, 2), np.int32)
    req[0, 0] = 7
    alive = [True, False, True]
    committed = int(tw.tick(req=req, alive=alive).committed_now[0])
    for _ in range(3):
        committed += int(tw.tick(alive=alive).committed_now[0])
    assert committed == 1 and tw.applied[1, 0] == 0
    tw.tick()
    tw.tick()
    assert tw.applied[1, 0] == 1


def test_dead_head_blocks_intake():
    tw = Twin(G=2)
    req = np.zeros((4, 2), np.int32)
    req[0, 0] = 7
    assert not tw.tick(req=req, alive=[False, True, True]).intake_taken[0, 0]


def test_stop_fences_intake():
    tw = Twin(G=2)
    req = np.zeros((4, 2), np.int32)
    stop = np.zeros((4, 2), bool)
    req[:3, 0] = [1, 2, 3]
    stop[1, 0] = True  # a stop in the middle: request 3 is refused
    taken = tw.tick(req=req, stop=stop).intake_taken
    assert taken[0, 0] and taken[1, 0] and not taken[2, 0]
    for _ in range(3):
        tw.tick()
    req2 = np.zeros((4, 2), np.int32)
    req2[0, 0] = 9
    assert not tw.tick(req=req2).intake_taken[0, 0]


def test_random_chains_twin():
    """Random member masks, loads, stops and liveness over 60 ticks at
    R=4 (chains of 1 to 4 members): equal states and outboxes every
    tick."""
    rng = np.random.default_rng(7)
    R, G, P = 4, 32, 4
    tw = Twin(R=R, G=G, W=8, P=P, members=rng.random((G, R)) < 0.7)
    rid = 1
    for _t in range(60):
        req = np.zeros((P, G), np.int32)
        n = rng.integers(0, P + 1, G)
        for g in range(G):
            req[:n[g], g] = np.arange(rid, rid + n[g])
            rid += n[g]
        tw.tick(req=req, stop=rng.random((P, G)) < 0.01,
                alive=rng.random(R) < 0.85)


# ------------------------------------------------------------- ChainManager

def make_mgr(which, G=16, wal=None):
    cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    rep = trep if which == PORT else jrep
    apps = [rep.KVApp() for _ in range(3)]
    if which == PORT:
        return cfg, TChainManager(cfg, 3, apps, wal=wal, device="cpu")
    return cfg, JChainManager(cfg, 3, apps, wal=wal)


def _mgr_script(m):
    """Writes to two chains (one of 2 members), a dead middle member for a
    while, reads at the tail; returns every response in order."""
    m.create_paxos_instance("c1", [0, 1, 2])
    m.create_paxos_instance("c2", [0, 2])
    got = []
    for i in range(12):
        m.propose("c1", f"PUT k{i} {i}".encode(),
                  lambda r, v, i=i: got.append(("c1", i, v)))
        m.propose("c2", f"PUT k {i}".encode(),
                  lambda r, v, i=i: got.append(("c2", i, v)))
        if i == 4:
            m.set_alive(1, False)
        if i == 8:
            m.set_alive(1, True)
        m.tick()
    m.run_ticks(6)
    m.propose("c1", b"GET k3", lambda r, v: got.append(("get", 3, v)))
    m.propose("c2", b"GET k", lambda r, v: got.append(("get", 0, v)))
    m.run_ticks(6)
    return got


def _assert_chain_managers_equal(a, b):
    for name, x, y in zip(tcst.ChainState._fields, a.state,
                          tcst.state_to_numpy(b.state)):
        assert np.array_equal(np.asarray(x), y), name
    assert [x.db for x in a.apps] == [y.db for y in b.apps]
    assert dict(a.stats) == dict(b.stats)
    assert a.tick_num == b.tick_num and sorted(a.outstanding) == \
        sorted(b.outstanding)


def test_chain_manager_end_to_end():
    res = {}
    for which in (REF, PORT):
        _, m = make_mgr(which)
        res[which] = (m, _mgr_script(m))
    assert res[PORT][1] == res[REF][1]
    _assert_chain_managers_equal(res[REF][0], res[PORT][0])
    got = res[PORT][1]
    assert ("get", 3, b"3") in got and ("get", 0, b"11") in got
    for app in res[PORT][0].apps:
        assert app.db["c1"]["k11"] == "11"


def test_chain_wal_recovery(tmp_path):
    """Crash a durable chain deployment mid-stream: journals and snapshots
    equal byte for byte, each package recovers both directories to the
    live state, and the recovered plane keeps working."""
    live, cfgs = {}, {}
    for which in (REF, PORT):
        d = str(tmp_path / which)
        wal = (TChainLogger if which == PORT else JChainLogger)(
            d, checkpoint_every_ticks=7, native=False)
        cfgs[which], m = make_mgr(which, wal=wal)
        live[which] = (m, _mgr_script(m))
        wal.close()  # crash
    assert live[PORT][1] == live[REF][1]
    files = sorted(os.listdir(tmp_path / REF))
    assert files == sorted(os.listdir(tmp_path / PORT))
    assert any(f.startswith("snapshot") for f in files)
    for f in files:
        assert (tmp_path / REF / f).read_bytes() == \
            (tmp_path / PORT / f).read_bytes(), f
    for which in (REF, PORT):
        for d in (REF, PORT):
            # each recovery appends to its own copy of the directory
            work = str(tmp_path / f"{which}-recovers-{d}")
            shutil.copytree(tmp_path / d, work)
            rep = trep if which == PORT else jrep
            apps = [rep.KVApp() for _ in range(3)]
            if which == PORT:
                m2 = trecover_chain(cfgs[PORT], 3, apps, work, native=False,
                                    device="cpu")
            else:
                m2 = jrecover_chain(cfgs[REF], 3, apps, work, native=False)
            live_m = live[REF][0]
            for name, x, y in zip(tcst.ChainState._fields, live_m.state,
                                  m2.state):
                assert np.array_equal(np.asarray(x), np.asarray(y)), \
                    (which, d, name)
            assert [x.db for x in live_m.apps] == [y.db for y in m2.apps]
            got = []
            m2.propose("c1", b"GET k3", lambda r, v: got.append(v))
            m2.run_ticks(6)
            assert got == [b"3"]
            m2.wal.close()


# ---------------------------------------------------- the chain control plane

def test_chain_control_plane_e2e():
    """The whole reconfiguration stack over chains: both packages' clusters
    give the same responses and actives."""
    from gigapaxos_tpu.client import ReconfigurableAppClient as RefClient
    from gigapaxos_tpu.node import InProcessCluster as RefCluster
    from gigapaxos_tpu_torch.client import ReconfigurableAppClient as Client
    from gigapaxos_tpu_torch.node import InProcessCluster as Cluster

    def run(which):
        cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
        cfg.paxos.max_groups = 64
        for i in range(5):
            cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
        for i in range(3):
            cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
        rep = trep if which == PORT else jrep
        kw = {"device": "cpu"} if which == PORT else {}
        cl = (Cluster if which == PORT else RefCluster)(
            cfg, rep.KVApp, coordinator="chain", **kw)
        c = (Client if which == PORT else RefClient)(cfg.nodes)
        try:
            out = [c.create("csvc")["ok"],
                   c.request("csvc", b"PUT a 1", timeout=120),
                   c.request("csvc", b"GET a", timeout=120)]
            old = set(c.request_actives("csvc"))
            pool = set(cfg.nodes.active_ids())
            new = sorted((pool - old) | set(sorted(old)[:1]))[:3]
            out += [sorted(old), c.reconfigure("csvc", new)["ok"],
                    set(c.request_actives("csvc", force=True)) == set(new),
                    c.request("csvc", b"GET a", timeout=120),
                    c.delete("csvc")["ok"]]
            return out, type(cl.manager).__module__
        finally:
            c.close()
            cl.close()

    (ref, ref_mod), (port, port_mod) = run(REF), run(PORT)
    assert port == ref
    assert port_mod == "gigapaxos_tpu_torch.chain.manager"
    assert port[:3] == [True, b"OK", b"1"] and port[4:] == [True, True, b"1",
                                                          True]


# ----------------------------------------------------------- the chain gather

def test_chain_tick_gathers_three_rings_in_one_call(monkeypatch):
    """The tick reads its three rings through one gather_planes_many call
    over the per-replica index (one kernel launch on the card)."""
    calls = []
    real = tct.gather_planes_many

    def spy(arrs, idx):
        calls.append((len(arrs), tuple(idx.shape)))
        return real(arrs, idx)

    monkeypatch.setattr(tct, "gather_planes_many", spy)
    s = tcst.create_groups(tcst.init_state(3, 16, 8, device=CPU),
                           np.arange(16), np.ones((16, 3), bool))
    tct.chain_tick_impl(s, tct.make_inbox(3, 16, 4, device=CPU))
    assert calls == [(3, (3, 8, 16))]


@pytest.mark.cuda
def test_chain_gather_kernel_matches_plain():
    """The chain tick's one launch: c_req int32, c_slot int32 and c_stop
    bool [R, W, G] over a per-lead rotation index, against the plain
    version (the kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (its plain version runs in the twins above)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    for R, W, G in ((3, 8, 4099), (3, 8, 1 << 17), (5, 4, 1000)):
        arrs = [torch.randint(-999, 999, (R, W, G), generator=gen,
                              dtype=torch.int32),
                torch.randint(-1, 99, (R, W, G), generator=gen,
                              dtype=torch.int32),
                torch.randint(0, 2, (R, W, G), generator=gen).bool()]
        base = torch.randint(0, 2**30, (R, 1, G), generator=gen,
                             dtype=torch.int32)
        idx = torch.bitwise_and(
            base + torch.arange(W, dtype=torch.int32)[None, :, None], W - 1)
        tpg.reset_launches()
        got = tpg.gather_planes_many_cuda([a.to(dev) for a in arrs],
                                          idx.to(dev))
        assert tpg.launches["gather_planes"] == 1
        for g, want in zip(got, tpg.gather_planes_many_plain(arrs, idx)):
            assert torch.equal(g.cpu(), want)


# ----------------------------------------------------- chip_smoke's chain phase

def test_chip_smoke_chain_phase_on_cpu(tmp_path):
    """chip_smoke.py's chain legs at a small size on the CPU, every check
    included (kernel launch counts are read on the card only)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    out = chip_smoke.chain_phase(torch, tpg, CPU, str(tmp_path),
                                 G_1m=1 << 12, G_128k=1 << 10, ticks_1m=6,
                                 ticks_128k=12, cluster_groups=256,
                                 n_names=16, n_reconf=2, n_delete=2)
    assert out["chain-1M"]["commits"] > 0
    assert out["chain-128k"]["acked_read_back"] > 0
    assert out["chain-cluster"]["names"] == 16
