"""Manager twin: the port's ``PaxosManager`` (on the CPU) against the JAX
reference manager, driven by the same seeded workloads.

Tolerance: 0.  Per tick the device state must be equal field by field;
at the end the executed streams (replica, group, rid, in execution order),
the client-visible results, the manager counters and the app states must
be equal.
"""

import struct

import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jcfg
from gigapaxos_tpu.models import dense_apps as jdense
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.paxos import manager as jmgr
from gigapaxos_tpu_torch import config as tcfg
from gigapaxos_tpu_torch.models import dense_apps as tdense
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.paxos import manager as tmgr
from gigapaxos_tpu_torch.paxos import state as tst

PORT, REF = "port", "ref"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and keeps
    the parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """Wraps an app and logs every execution, checkpoint and restore."""

    def __init__(self, app, r, log):
        self.app, self.r, self.log = app, r, log
        if hasattr(app, "execute_rows_batch"):
            self.execute_rows_batch = self._rows_batch

    def execute(self, name, request, rid):
        self.log.append((self.r, name, int(rid)))
        return self.app.execute(name, request, rid)

    def execute_batch(self, names, requests, rids):
        self.log.extend((self.r, n, int(q)) for n, q in zip(names, rids))
        return self.app.execute_batch(names, requests, rids)

    def _rows_batch(self, rows, payloads, rids, lens=None):
        self.log.extend((self.r, int(w), int(q)) for w, q in zip(rows, rids))
        return self.app.execute_rows_batch(rows, payloads, rids, lens=lens)

    def checkpoint(self, name):
        self.log.append((self.r, name, "checkpoint"))
        return self.app.checkpoint(name)

    def restore(self, name, state):
        self.log.append((self.r, name, "restore"))
        return self.app.restore(name, state)


def make(which, app_kind="noop", R=3, groups=64, window=8, **paxos):
    cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
    cfg.paxos.max_groups = groups
    cfg.paxos.window = window
    for k, v in paxos.items():
        setattr(cfg.paxos, k, v)
    rep = trep if which == PORT else jrep
    dense = tdense if which == PORT else jdense
    log = []
    if app_kind == "noop":
        inner = [rep.NoopApp() for _ in range(R)]
    elif app_kind == "kv":
        inner = [rep.KVApp() for _ in range(R)]
    else:
        inner = [dense.DenseCounterApp(groups) for _ in range(R)]
    apps = [Recorder(a, r, log) for r, a in enumerate(inner)]
    kw = {"device": "cpu"} if which == PORT else {}
    m = (tmgr if which == PORT else jmgr).PaxosManager(cfg, R, apps, **kw)
    if app_kind == "dense":
        for a in inner:
            a.row_of = m.rows.row
    states = []
    tick = m.tick

    def recording_tick():
        out = tick()
        if which == PORT:
            states.append(tst.state_to_numpy(m.state))
        else:
            states.append([np.array(f) for f in m.state])
        return out

    m.tick = recording_tick
    return m, inner, log, states


def run_both(workload, **kw):
    res = {}
    for which in (REF, PORT):
        m, inner, log, states = make(which, **kw)
        obs = workload(m, which)
        res[which] = (m, inner, log, states, obs)
    (jm, ja, jlog, jst, jobs), (tm, ta, tlog, tst_, tobs) = \
        res[REF], res[PORT]
    assert len(jst) == len(tst_)
    for t, (a, b) in enumerate(zip(jst, tst_)):
        for name, x, y in zip(tst.PaxosState._fields, a, b):
            assert np.array_equal(x, y), (t, name)
    assert jlog == tlog
    assert jobs == tobs
    assert dict(jm.stats) == dict(tm.stats)
    for a, b in zip(ja, ta):
        if hasattr(a, "db"):
            assert a.db == b.db
        if hasattr(a, "acc"):
            assert np.array_equal(a.acc, b.acc)
            assert np.array_equal(a.count, b.count)
    return res


def test_loopback_1_group_noop():
    def wl(m, which):
        assert m.create_paxos_instance("svc0", [0, 1, 2])
        got = {}
        for i in range(10):
            m.propose("svc0", f"req{i}".encode(),
                      lambda rid, resp, i=i: got.__setitem__(i, resp))
        m.run_ticks(6)
        return got

    res = run_both(wl)
    assert res[PORT][4] == {i: b"ok:req" + str(i).encode() for i in range(10)}


def test_loopback_10_groups_kv_consistency():
    def wl(m, which):
        for g in range(10):
            m.create_paxos_instance(f"kv{g}", [0, 1, 2])
        resp = {}
        for g in range(10):
            for i in range(5):
                m.propose(f"kv{g}", f"PUT k{i} v{g}.{i}".encode())
            m.propose(f"kv{g}", b"GET k3",
                      lambda rid, r, g=g: resp.__setitem__(g, r))
        m.run_ticks(10)
        return resp

    res = run_both(wl, app_kind="kv")
    assert res[PORT][4] == {g: f"v{g}.3".encode() for g in range(10)}


def test_failover_mid_stream():
    def wl(m, which):
        m.create_paxos_instance("svc", [0, 1, 2])
        done = []
        for i in range(4):
            m.propose("svc", f"PUT a{i} {i}".encode(),
                      lambda rid, r: done.append(rid))
        m.run_ticks(2)
        m.set_alive(0, False)  # coordinator dies
        for i in range(4, 8):
            m.propose("svc", f"PUT a{i} {i}".encode(),
                      lambda rid, r: done.append(rid))
        m.run_ticks(4)
        m.set_alive(0, True)  # recovers and catches up via ring sync
        m.run_ticks(2)
        return done

    res = run_both(wl, app_kind="kv")
    assert len(res[PORT][4]) == 8
    apps = res[PORT][1]
    assert apps[0].db["svc"] == apps[1].db["svc"] == \
        {f"a{i}": str(i) for i in range(8)}


def test_checkpoint_transfer_beyond_window():
    def wl(m, which):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.set_alive(2, False)
        for i in range(30):  # 30 > W while replica 2 is down
            m.propose("svc", f"PUT k{i} {i}".encode())
        m.run_ticks(12)
        m.set_alive(2, True)
        out = m.tick()
        lag = int(np.asarray(out.lag)[2, 0])
        n = m.auto_sync_laggards(out)
        ok = []
        m.propose("svc", b"GET k7", lambda rid, r: ok.append(r))
        m.run_ticks(3)
        return lag, n, ok

    res = run_both(wl, app_kind="kv", auto_laggard_sync=False)
    lag, n, ok = res[PORT][4]
    assert lag >= 8 and n == 1 and ok == [b"7"]
    apps = res[PORT][1]
    assert apps[2].db["svc"] == apps[0].db["svc"]


def test_dedup_double_commit_executes_once():
    def wl(m, which):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.create_paxos_instance("x", [0, 1, 2])
        rid = m.propose("x", b"PUT k 1")
        m.run_ticks(2)
        before = m.stats["executions"]
        m._execute_one(0, m.rows.row("x"), "x", rid, slot=99, is_stop=False)
        return m.stats["dup_commits"], m.stats["executions"] - before

    res = run_both(wl, app_kind="kv")
    assert res[PORT][4] == (1, 0)


def test_stop_remove_and_pause_unpause():
    def wl(m, which):
        got = []
        for g in range(6):
            m.create_paxos_instance(f"s{g}", [0, 1, 2] if g % 2 else [0, 1])
            m.propose(f"s{g}", f"one{g}".encode(),
                      lambda rid, r: got.append(r))
        m.propose_stop("s0", b"bye", lambda rid, r: got.append(r))
        m.run_ticks(4)
        late = m.propose("s0", b"late", lambda rid, r: got.append(r))
        m.run_ticks(2)
        removed = m.remove_paxos_instance("s0")
        m.run_ticks(3)
        paused = m.pause_idle()
        # a propose to a paused group unpauses it
        m.propose("s3", b"again", lambda rid, r: got.append(r))
        m.run_ticks(3)
        return (got, late, removed, paused, m.paused_count(),
                m.group_members("s3"), m.is_stopped("s1"))

    res = run_both(wl, deactivation_ticks=2)
    got, late, removed, paused, n_paused, members, stopped = res[PORT][4]
    assert late is None and removed and paused > 0
    assert b"ok:again" in got and members == [0, 1, 2] and not stopped


@pytest.mark.parametrize("pipeline", [True, False])
def test_bulk_compact_pipelined_with_crash_and_repair(pipeline):
    """propose_bulk through the compact outbox, replicas down for more
    than W decisions (repaired by checkpoint transfer from the device
    control summary), and a payload sweep while one of them is down."""
    G = 64
    rng = np.random.default_rng(11)
    waves = [rng.permutation(G)[:48] for _ in range(70)]

    def wl(m, which):
        m.create_paxos_instances([f"g{i}" for i in range(G)], [0, 1, 2])
        acks, cbs = [], []
        for t, rows in enumerate(waves):
            if t in (5, 45):  # replica 1, then 2, down for > W decisions
                m.set_alive(1 + t // 45, False)
            if t == 25:
                m.set_alive(1, True)
            payloads = [struct.pack("<q", int(r) + t) for r in rows]
            cb = (lambda rid, resp: cbs.append(rid)) if t % 3 else None
            rids = m.propose_bulk(
                rows, payloads, callbacks=[cb] * len(rows) if cb else None,
                batch_sink=lambda offs, resp, t=t: acks.append(
                    (t, sorted(int(o) for o in offs))))
            m.tick()
        for t in range(12):
            if t == 4:
                m.set_alive(2, True)
            m.tick()
        m.drain_pipeline()
        return (acks, sorted(cbs), m.bulk_stats(), m.pending_count(),
                rids.tolist())

    res = run_both(wl, app_kind="dense", groups=G, compact_outbox=True,
                   pipeline_ticks=pipeline, exec_budget=3 * G + 64,
                   proposals_per_tick=2)
    m = res[PORT][0]
    assert m.stats["checkpoint_transfers"] > 0
    assert m.stats["swept"] > 0
    a = res[PORT][1]
    assert np.array_equal(a[0].acc, a[1].acc)
    assert np.array_equal(a[0].acc, a[2].acc)


@pytest.mark.parametrize("option,value", [
    ("device_app", True), ("mesh_devices", 2), ("fast_reelection", True),
    ("emulate_unreplicated", True),
])
def test_unported_options_raise(option, value):
    cfg = tcfg.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    setattr(cfg.paxos, option, value)
    with pytest.raises(NotImplementedError):
        tmgr.PaxosManager(cfg, 3, [trep.NoopApp() for _ in range(3)],
                          device="cpu")


def test_wal_raises_and_cuda_default_needs_card(monkeypatch, tmp_path):
    """A durable manager still refuses an unported plane (the WAL is
    ported; the device KV app is not), and without a card the CUDA
    default raises."""
    from gigapaxos_tpu_torch.wal.logger import PaxosLogger

    cfg = tcfg.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    cfg.paxos.device_app = True
    apps = [trep.NoopApp() for _ in range(3)]
    with pytest.raises(NotImplementedError, match="device-KV"):
        tmgr.PaxosManager(cfg, 3, apps, device="cpu",
                          wal=PaxosLogger(str(tmp_path), native=False))
    cfg.paxos.device_app = False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmgr.PaxosManager(cfg, 3, apps)
