"""Plane twins at the manager level: the Mode A workloads of the reference's
register-mode, lease and health tests, run through both packages'
``PaxosManager`` (the port on ``device="cpu"``) with the same seeds.

Tolerance: 0.  After every tick both state planes, the lease and health
columns, the lease mirror and the health snapshot must be equal; at the end
the observations each workload records (responses, ``lease_info``,
``health_snapshot``, ``group_info``), the per-replica execution ledgers,
the app states, the manager counters and the flight-recorder events must
be equal.  The reference tests' own assertions run on both packages.
"""

import json
import types

import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jcfg
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.obs import flight as jflight
from gigapaxos_tpu.paxos import manager as jmgr
from gigapaxos_tpu.wal import logger as jlog
from gigapaxos_tpu_torch import config as tcfg
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.obs import flight as tflight
from gigapaxos_tpu_torch.paxos import manager as tmgr
from gigapaxos_tpu_torch.paxos import state as tst
from gigapaxos_tpu_torch.wal import logger as tlog

PORT, REF = "port", "ref"
PKG = {
    REF: types.SimpleNamespace(which=REF, cfg=jcfg, rep=jrep, mgr=jmgr,
                               log=jlog, flight=jflight, kw={}),
    PORT: types.SimpleNamespace(which=PORT, cfg=tcfg, rep=trep, mgr=tmgr,
                                log=tlog, flight=tflight,
                                kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Ledger:
    """Wraps an app and records each replica's execution order per group
    (local lease reads included, as rid 0)."""

    def __init__(self, app, log):
        self.app, self.log = app, log

    @property
    def db(self):
        return self.app.db

    def execute(self, name, request, rid):
        self.log.setdefault(name, []).append(int(rid))
        return self.app.execute(name, request, rid)

    def execute_batch(self, names, requests, rids):
        return [self.execute(n, q, r) for n, q, r in zip(names, requests,
                                                           rids)]

    def checkpoint(self, name):
        return self.app.checkpoint(name)

    def restore(self, name, state):
        return self.app.restore(name, state)


def mk_cfg(which, G=8, G_reg=0, compact=False, pipeline=False,
           leases=False, horizon=16, margin=4, health=False, wedge=4,
           topk=4, **paxos):
    cfg = PKG[which].cfg.GigapaxosTpuConfig()
    p = cfg.paxos
    p.max_groups, p.register_groups = G, G_reg
    p.compact_outbox, p.pipeline_ticks = compact, pipeline
    p.read_leases, p.lease_ticks, p.lease_margin_ticks = (leases, horizon,
                                                          margin)
    p.group_health, p.health_wedge_ticks, p.health_topk = (health, wedge,
                                                           topk)
    for k, v in paxos.items():
        setattr(p, k, v)
    return cfg


def _host(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tst.to_host(x)
    return np.array(x)  # a copy: the manager may replace it in place


def _fields(tree):
    return None if tree is None else [_host(f) for f in tree]


def tick_view(m):
    """Everything a tick can change that the twin compares."""
    return {
        "state": _fields(m.state), "rstate": _fields(m.rstate),
        "lease": _fields(m._lease), "rlease": _fields(m._rlease),
        "health": _fields(m._health), "rhealth": _fields(m._rhealth),
        "lease_np": _host(m._lease_np), "lease_clock": m._lease_clock,
        "health_snapshot": m.health_snapshot(),
    }


def make(which, R=3, wal=None, **cfg_kw):
    P = PKG[which]
    cfg = mk_cfg(which, **cfg_kw)
    ledgers = [dict() for _ in range(R)]
    apps = [Ledger(P.rep.KVApp(), ledgers[r]) for r in range(R)]
    m = P.mgr.PaxosManager(cfg, R, apps, wal=wal, **P.kw)
    views = []
    tick = m.tick

    def recording_tick():
        out = tick()
        views.append(tick_view(m))
        return out

    m.tick = recording_tick
    return m, ledgers, views


def _assert_tree_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_tree_equal(a[k], b[k], (what, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, (what, i))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, (what, a, b)


def flight_events(path):
    """The recorder's events without their wall-clock stamps."""
    with open(path) as f:
        doc = json.load(f)
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in doc["events"]]


def twin(workload, tmp_path=None, R=3, **cfg_kw):
    """Run ``workload(m, P, obs)`` in both packages and compare."""
    res = {}
    for which in (REF, PORT):
        m, ledgers, views = make(which, R=R, **cfg_kw)
        if tmp_path is not None:
            m.flight = PKG[which].flight.FlightRecorder(
                str(tmp_path / f"{which}.json"), node="t")
        obs = []
        workload(m, PKG[which], obs)
        fl = (flight_events(m.flight.persist())
              if m.flight is not None else None)
        res[which] = (m, ledgers, views, obs, fl)
    (jm, jl, jv, jo, jf), (tm, tl, tv, to, tf) = res[REF], res[PORT]
    assert len(jv) == len(tv)
    for t, (a, b) in enumerate(zip(jv, tv)):
        _assert_tree_equal(a, b, ("tick", t))
    _assert_tree_equal(jo, to, "observations")
    assert jl == tl
    assert dict(jm.stats) == dict(tm.stats)
    for r in range(R):
        assert jm.apps[r].db == tm.apps[r].db
    assert jf == tf
    return tm, to


def pump(m, n):
    for _ in range(n):
        m.tick()
    m.drain_pipeline()


def cb_into(obs, tag):
    return lambda rid, resp: obs.append((tag, int(rid), resp))


# ------------------------------------------------------------ register mode

@pytest.mark.parametrize("compact,pipeline", [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_mixed_planes_end_to_end(compact, pipeline):
    def wl(m, P, obs):
        assert m.create_paxos_instance("logA", [0, 1, 2])
        assert m.create_paxos_instance("regA", [0, 1, 2], register=True)
        for i in range(6):
            m.propose("logA", f"L{i}".encode().ljust(40, b"x"),
                      cb_into(obs, "log"))
            m.propose("regA", f"R{i}".encode().ljust(40, b"x"),
                      cb_into(obs, "reg"))
            m.tick()
        pump(m, 20)
        assert len(obs) == 12
        assert all(m.exec_watermarks("logA") == 6)
        assert all(m.exec_watermarks("regA") == 6)
        obs.append(m.group_info("regA"))

    twin(wl, G_reg=4, compact=compact, pipeline=pipeline)


def test_register_rows_allocate_high_and_recycle():
    def wl(m, P, obs):
        m.create_paxos_instance("r0", [0, 1, 2], register=True)
        m.create_paxos_instance("r1", [0, 1, 2], register=True)
        assert m.rows.row("r0") >= m.G and m.rows.row("r1") >= m.G
        assert m.is_register_row(m.rows.row("r0"))
        assert not m.create_paxos_instance("r2", [0, 1, 2], register=True)
        m.create_paxos_instance("l0", [0, 1, 2])
        assert m.rows.row("l0") < m.G
        m.remove_paxos_instance("r1")
        m.create_paxos_instance("r2", [0, 1, 2], register=True)
        assert m.rows.row("r2") >= m.G
        obs.append(dict(m.rows.items()))
        obs.append(m.rows.snapshot_free_rows())
        # no register plane: a register create is refused
        plain = P.mgr.PaxosManager(mk_cfg(P.which), 3,
                                   [P.rep.NoopApp() for _ in range(3)],
                                   **P.kw)
        with pytest.raises(ValueError):
            plain.create_paxos_instance("r0", [0, 1, 2], register=True)

    twin(wl, G=4, G_reg=2)


def test_register_overwrite_semantics():
    def wl(m, P, obs):
        m.create_paxos_instance("reg", [0, 1, 2], register=True)
        for i in range(10):
            m.propose("reg", f"PUT k v{i}".encode(), cb_into(obs, i))
            m.tick()
        pump(m, 10)
        assert all(m.exec_watermarks("reg") == 10)
        for a in m.apps:
            obs.append(a.app.execute("reg", b"GET k", 10**9))
        assert obs[-1] == b"v9"
        assert m.rstate.acc_req.shape[1] == 1

    twin(wl, G_reg=4, compact=True)


def test_register_laggard_repair_ships_register():
    def wl(m, P, obs):
        m.create_paxos_instance("reg", [0, 1, 2], register=True)
        for i in range(3):
            m.propose("reg", f"PUT k v{i}".encode())
            m.tick()
        pump(m, 5)
        m.set_alive(2, False)
        for i in range(5):
            m.propose("reg", f"PUT k w{i}".encode())
            m.tick()
        pump(m, 5)
        m.set_alive(2, True)
        pump(m, 30)
        ws = m.exec_watermarks("reg")
        assert ws[2] == ws[0] == ws[1] == 8, ws
        assert m.stats["checkpoint_transfers"] >= 1
        obs.append(m.apps[2].app.execute("reg", b"GET k", 10**9))
        assert obs[-1] == b"w4"

    twin(wl, G_reg=4, compact=True)


# register safety: replica 0 stays up, 1 and 2 crash and revive at random
@pytest.mark.parametrize("seed,compact", [(3, False), (11, True),
                                          (57, True)])
def test_register_random_crash_order(seed, compact):
    groups_log, groups_reg = ["g0", "g1"], ["rg0", "rg1"]

    def wl(m, P, obs):
        rng = np.random.default_rng(seed)
        for g in groups_log:
            m.create_paxos_instance(g, [0, 1, 2])
        for g in groups_reg:
            m.create_paxos_instance(g, [0, 1, 2], register=True)
        groups = groups_log + groups_reg
        for t in range(60):
            for r in (1, 2):
                if rng.random() < 0.1:
                    if m.alive[r]:
                        if int((~m.alive).sum()) < 1:
                            m.set_alive(r, False)
                    else:
                        m.set_alive(r, True)
            for _ in range(int(rng.integers(0, 4))):
                g = groups[int(rng.integers(0, len(groups)))]
                m.propose(g, f"PUT bg{int(rng.integers(0, 6))} x".encode())
            g = groups[int(rng.integers(0, len(groups)))]
            m.propose(g, f"PUT t{t} tv{t}".encode(), cb_into(obs, (g, t)))
            m.tick()
        for r in range(3):
            m.set_alive(r, True)
        pump(m, 40)

    m, _ = twin(wl, G=4, G_reg=4, pipeline=True, compact=compact)
    # the reference's per-(group, version) ledger check, on the port
    for g in groups_reg:
        truth = m.apps[0].log.get(g, [])
        assert len(truth) == len(set(truth))
        for r in (1, 2):
            seq = m.apps[r].log.get(g, [])
            it = iter(truth)
            assert all(any(x == y for y in it) for x in seq), (g, r)


# -------------------------------------------------------------------- leases

@pytest.mark.parametrize("compact,pipeline,g_reg",
                         [(False, False, 0), (False, True, 0),
                          (True, False, 4), (True, True, 4)])
def test_lease_grant_renew_and_local_read(compact, pipeline, g_reg):
    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        for i in range(5):
            m.propose("svc", f"PUT k v{i}".encode())
            m.tick()
        pump(m, 10)
        info = m.lease_info("svc")
        obs.append(info)
        assert info["holder"] == 0 and info["epoch"] >= 1
        assert info["until"] > info["clock"]
        rid = m.read("svc", b"GET k", cb_into(obs, "read"))
        assert rid == 0 and obs[-1] == ("read", 0, b"v4")
        assert m.stats["local_reads"] >= 1

    twin(wl, G_reg=g_reg, compact=compact, pipeline=pipeline, leases=True)


def test_register_group_lease_read():
    def wl(m, P, obs):
        m.create_paxos_instance("reg", [0, 1, 2], register=True)
        for i in range(6):
            m.propose("reg", f"PUT k r{i}".encode())
            m.tick()
        pump(m, 10)
        obs.append(m.lease_info("reg"))
        assert obs[-1]["holder"] == 0
        assert m.read("reg", b"GET k", cb_into(obs, "read")) == 0
        assert obs[-1][2] == b"r5"

    twin(wl, G_reg=4, compact=True, leases=True)


def test_read_falls_back_without_lease():
    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        for i in range(3):
            m.propose("svc", f"PUT k v{i}".encode())
            m.tick()
        pump(m, 8)
        assert m.lease_info("svc") is None
        rid = m.read("svc", b"GET k", cb_into(obs, "read"))
        assert rid not in (0, None)
        pump(m, 8)
        assert obs[-1][2] == b"v2"
        assert m.stats["local_reads"] == 0

    twin(wl)


def test_skew_guard_blocks_local_reads():
    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.propose("svc", b"PUT k v")
        pump(m, 6)
        assert m.read("svc", b"GET k") == 0
        m._lease_skew_ticks = -100
        rid = m.read("svc", b"GET k", cb_into(obs, "read"))
        assert rid != 0
        pump(m, 8)
        assert obs[-1][2] == b"v"

    twin(wl, leases=True, horizon=8, margin=2)


def test_write_fence_delays_failover_writes():
    horizon, margin = 12, 4

    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.propose("svc", b"PUT k old")
        pump(m, 5)
        assert m.lease_info("svc")["holder"] == 0
        m.set_alive(0, False)
        assert m.read("svc", b"GET k", cb_into(obs, "read")) != 0
        acks = []
        m.propose("svc", b"PUT k new", lambda r, resp: acks.append(resp))
        waited = 0
        for _ in range(4 * (horizon + margin)):
            m.tick()
            m.drain_pipeline()
            if acks:
                break
            waited += 1
        assert acks == [b"OK"]
        assert waited >= margin, waited
        obs.append(waited)
        info = m.lease_info("svc")
        obs.append(info)
        assert info["holder"] == 1 and info["epoch"] >= 2
        assert m.read("svc", b"GET k", cb_into(obs, "read2")) == 0
        assert obs[-1][2] == b"new"

    twin(wl, leases=True, horizon=horizon, margin=margin)


def test_lease_cleared_on_remove_and_recreate():
    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.propose("svc", b"PUT k a")
        pump(m, 6)
        assert m.lease_info("svc")["holder"] == 0
        m.remove_paxos_instance("svc")
        assert m.lease_info("svc") is None
        m.create_paxos_instance("svc2", [0, 1, 2])
        m.propose("svc2", b"PUT k b")
        pump(m, 6)
        assert m.read("svc2", b"GET k", cb_into(obs, "read")) == 0
        assert obs[-1][2] == b"b"

    twin(wl, leases=True)


@pytest.mark.parametrize("seed", [11, 12])
def test_lease_soak_mode_a_linearizable(seed):
    horizon, margin = 12, 4

    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        rng = np.random.default_rng(seed)
        state = {"acked": 0, "issued": 0, "outstanding": None}
        failures = []

        def write():
            val = state["issued"] + 1
            state["issued"] = val
            state["outstanding"] = val

            def cb(r, resp):
                if resp == b"OK":
                    state["acked"] = max(state["acked"], val)
                    if state["outstanding"] == val:
                        state["outstanding"] = None
            m.propose("svc", f"PUT k {val}".encode(), cb)

        def read(t):
            floor = state["acked"]

            def cb(r, resp, _floor=floor, _t=t):
                hi = state["issued"]
                obs.append((_t, int(r), resp))
                if resp is None:
                    return
                v = 0 if resp == b"NF" else int(resp)
                if not (_floor <= v <= hi):
                    failures.append((_t, v, _floor, hi))
            m.read("svc", b"GET k", cb)

        down = None
        for t in range(200):
            if down is None and t > 20 and rng.random() < 0.03:
                info = m.lease_info("svc")
                victim = int(info["holder"]) if info else 0
                if victim >= 0:
                    m.set_alive(victim, False)
                    down = (victim, t + int(rng.integers(
                        horizon + margin + 5, 3 * horizon)))
            if down is not None and t >= down[1]:
                m.set_alive(down[0], True)
                down = None
            if t % 40 == 7:
                m._lease_skew_ticks = int(rng.integers(0, margin + 1))
            if state["outstanding"] is None and t % 3 == 0:
                write()
            if t % 2 == 0:
                read(t)
            m.tick()
            m.drain_pipeline()
        if down is not None:
            m.set_alive(down[0], True)
        pump(m, 40)
        assert not failures, failures[:5]
        assert state["acked"] > 20
        assert m.stats["local_reads"] > 0
        obs.append(dict(state))

    twin(wl, leases=True, horizon=horizon, margin=margin, compact=True)


# -------------------------------------------------------------------- health

@pytest.mark.parametrize("compact,pipeline,g_reg",
                         [(False, False, 0), (False, True, 0),
                          (True, False, 4), (True, True, 4)])
def test_wedge_detected_in_topk(compact, pipeline, g_reg):
    def wl(m, P, obs):
        for i in range(3):
            m.create_paxos_instance(f"svc{i}", [0, 1, 2])
        for i in range(3):
            m.propose(f"svc{i}", b"PUT k v")
        pump(m, 6)
        h = m.health_snapshot()
        assert h["allocated"] >= 3 and h["wedged"] == 0
        m.set_alive(1, False)
        m.set_alive(2, False)
        m.propose("svc1", b"PUT k w", cb_into(obs, "w"))
        detected = None
        for t in range(20):
            pump(m, 1)
            h = m.health_snapshot()
            if h["wedged"] >= 1 and "svc1" in [e["name"]
                                               for e in h["top_stuck"]]:
                detected = t
                break
        assert detected is not None
        obs.append(detected)
        assert sum(h["hist_stall"][1:]) >= 1
        m.set_alive(1, True)
        m.set_alive(2, True)
        for _ in range(30):
            pump(m, 1)
            if m.health_snapshot()["wedged"] == 0:
                break
        assert m.health_snapshot()["wedged"] == 0

    twin(wl, G_reg=g_reg, compact=compact, pipeline=pipeline, health=True)


def test_flight_records_wedge_and_recover_transitions(tmp_path):
    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.propose("svc", b"PUT k v")
        pump(m, 4)
        m.set_alive(1, False)
        m.set_alive(2, False)
        m.propose("svc", b"PUT k w")
        pump(m, 12)
        m.set_alive(1, True)
        m.set_alive(2, True)
        pump(m, 20)
        doc = P.flight.FlightRecorder.read(m.flight.persist())
        kinds = [e["kind"] for e in doc["events"]]
        assert "group_wedged" in kinds and "group_recovered" in kinds
        ev = next(e for e in doc["events"] if e["kind"] == "group_wedged")
        assert ev["name"] == "svc" and ev["stall_ticks"] >= 4

    twin(wl, tmp_path=tmp_path, health=True)


def test_coordinator_churn_counted():
    def wl(m, P, obs):
        m.create_paxos_instance("flappy", [0, 1, 2])
        m.create_paxos_instance("calm", [1, 2, 3])
        for n in ("flappy", "calm"):
            m.propose(n, b"PUT k v")
        pump(m, 6)
        for _ in range(3):
            m.set_alive(0, False)
            pump(m, 10)
            m.set_alive(0, True)
            pump(m, 10)
        h = m.health_snapshot()
        churny = {e["name"]: e["value"] for e in h["top_churny"]}
        assert churny.get("flappy", 0) > 0 and h["max_churn"] > 0
        obs.append(m.group_info("calm"))
        obs.append(m.group_info("flappy"))
        assert obs[-2]["health"]["churn"] == 0.0

    twin(wl, R=4, health=True, wedge=16)


def test_health_cleared_on_remove_and_recreate():
    def wl(m, P, obs):
        m.create_paxos_instance("svc", [0, 1, 2])
        m.propose("svc", b"PUT k v")
        pump(m, 4)
        m.set_alive(1, False)
        m.set_alive(2, False)
        m.propose("svc", b"PUT k w")
        pump(m, 10)
        assert m.health_snapshot()["wedged"] == 1
        m.set_alive(1, True)
        m.set_alive(2, True)
        m.remove_paxos_instance("svc")
        pump(m, 2)
        h = m.health_snapshot()
        assert h["wedged"] == 0
        m.create_paxos_instance("svc2", [0, 1, 2])
        pump(m, 2)
        gi = m.group_info("svc2")
        obs.append(gi)
        assert gi["health"]["stall_ticks"] <= 2
        assert gi["health"]["churn"] == 0.0

    twin(wl, health=True)


def test_register_plane_health_and_merge():
    def wl(m, P, obs):
        m.create_paxos_instance("log0", [0, 1, 2])
        m.create_paxos_instance("reg0", [0, 1, 2], register=True)
        m.propose("reg0", b"PUT k v")
        m.propose("log0", b"PUT k v")
        pump(m, 6)
        h = m.health_snapshot()
        assert h["allocated"] >= 2
        assert {e["name"] for e in h["top_hot"]} & {"reg0", "log0"}
        gi = m.group_info("reg0")
        assert gi["mode"] == "register" and "version" in gi
        obs.append(gi)
        # a wedged register group surfaces with its composite row
        m.set_alive(1, False)
        m.set_alive(2, False)
        m.propose("reg0", b"PUT k w")
        pump(m, 8)
        obs.append(m.health_snapshot())
        assert any(e["name"] == "reg0" for e in obs[-1]["top_stuck"])

    twin(wl, compact=True, G_reg=4, health=True)


@pytest.mark.parametrize("compact,pipeline,g_reg", [(True, True, 4),
                                                    (False, False, 4)])
def test_all_planes_on_with_group_info(compact, pipeline, g_reg):
    """Register groups, leases and health together: lease reads on both
    planes, a failover under the fence, the health view of the wedge, and
    ``group_info`` of a bare name resolving to its highest epoch."""
    def wl(m, P, obs):
        for e in (0, 2):
            m.create_paxos_instance(f"svc#{e}", [0, 1, 2])
        m.create_paxos_instance("reg#0", [0, 1, 2], register=True)
        for i in range(4):
            m.propose("svc#2", f"PUT k s{i}".encode(), cb_into(obs, i))
            m.propose("reg#0", f"PUT k r{i}".encode(), cb_into(obs, i))
            m.tick()
        pump(m, 8)
        for n in ("svc#2", "reg#0"):
            obs.append(m.read(n, b"GET k", cb_into(obs, n)))
        obs.append(m.group_info("svc"))
        obs.append(m.group_info("reg"))
        assert obs[-2]["name"] == "svc#2"
        m.set_alive(0, False)
        m.propose("reg#0", b"PUT k late", cb_into(obs, "late"))
        pump(m, 30)
        obs.append(m.health_snapshot())
        obs.append(m.lease_info("reg#0"))

    twin(wl, compact=compact, pipeline=pipeline, G_reg=g_reg, leases=True,
         horizon=6, margin=2, health=True)
