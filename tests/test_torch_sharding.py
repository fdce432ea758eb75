"""Sharding twin: the port's mesh (``parallel/mesh.py``,
``parallel/shard_tick.py``, ``paxos.mesh_devices``) on the CPU against the
JAX package's shard_map tick on its virtual 8-device CPU mesh, and against
the port's own unsharded tick, in both of ``tests/test_sharding.py``'s
layouts (R=4, G=64: 2 replica x 4 group shards, and 1 x 8).

Tolerance: 0.  Every state field and every outbox field after every tick,
the stack runs' app tables, responses, counters and journal bytes, and
the journaled OP_SYNC records are compared with ``np.array_equal`` /
``==``.  On the CPU the port's mesh is eight shards of ``cpu``.
"""

import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.config import GigapaxosTpuConfig as JConfig
from gigapaxos_tpu.models.replicable import KVApp as JKV
from gigapaxos_tpu.ops import tick as jt
from gigapaxos_tpu.parallel import mesh as jmesh
from gigapaxos_tpu.parallel import shard_tick as jstk
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu.paxos.manager import PaxosManager as JManager
from gigapaxos_tpu.wal import records as jrecords
from gigapaxos_tpu.wal.journal import read_journal as jread
from gigapaxos_tpu.wal.logger import OP_SYNC as J_OP_SYNC
from gigapaxos_tpu.wal.logger import PaxosLogger as JLogger
from gigapaxos_tpu_torch.config import GigapaxosTpuConfig as TConfig
from gigapaxos_tpu_torch.models.replicable import KVApp as TKV
from gigapaxos_tpu_torch.ops import tick as pt
from gigapaxos_tpu_torch.ops import window as tw
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.parallel import shard_tick as tstk
from gigapaxos_tpu_torch.paxos import state as pst
from gigapaxos_tpu_torch.paxos.manager import PaxosManager as TManager
from gigapaxos_tpu_torch.wal.logger import PaxosLogger as TLogger

PKGS = {
    "ref": SimpleNamespace(Config=JConfig, KV=JKV, Manager=JManager,
                           Logger=JLogger, kw={}),
    "port": SimpleNamespace(Config=TConfig, KV=TKV, Manager=TManager,
                            Logger=TLogger, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ bare tick
def _inbox_np(R, G, P=2, seed=0, alive=None):
    rng = np.random.default_rng(seed)
    req = np.zeros((R, P, G), np.int32)
    for g in range(G):
        for p in range(int(rng.integers(0, P + 1))):
            req[rng.integers(0, R), p, g] = int(rng.integers(1, 1 << 20))
    al = np.ones(R, bool) if alive is None else np.asarray(alive, bool)
    return req, np.zeros((R, P, G), bool), al


def _states(R, G, W):
    rows, members = np.arange(G, dtype=np.int32), np.ones((G, R), bool)
    js = jst.create_groups(jst.init_state(R, G, W), rows, members)
    ts = pst.create_groups(pst.init_state(R, G, W, device="cpu"), rows,
                           members)
    return js, ts


def _run_bare(rs, budget, n_ticks, R=4, G=64, W=8):
    """The same seeded ticks through the reference's shard_map tick, the
    port's sharded tick and the port's unsharded tick; every state and
    outbox field compared after every tick.  Returns the executions of
    each tick."""
    jm = jmesh.make_mesh(jax.devices()[:8], replica_shards=rs)
    jtick = jstk.make_shardmap_tick(jm, -1, budget)
    tm = tmesh.make_mesh(["cpu"] * 8, replica_shards=rs)
    ttick = tstk.make_shardmap_tick(tm, -1, budget)
    js, ts = _states(R, G, W)
    js = jmesh.shard_state(js, jm)
    us = ts
    n_exec = []
    for t in range(n_ticks):
        req, stp, al = _inbox_np(R, G, seed=t,
                                 alive=[True] * (R - 1) + [t % 2 == 0])
        jin = jmesh.shard_inbox(jt.TickInbox(jnp.asarray(req),
                                             jnp.asarray(stp),
                                             jnp.asarray(al)), jm)
        tin = pt.TickInbox(torch.from_numpy(req), torch.from_numpy(stp),
                           torch.from_numpy(al))
        js, jout = jtick(js, jin)
        ts, tout = ttick(ts, tin)
        us, uout = pt.paxos_tick_impl(us, tin, -1, budget)
        for f in pst.PaxosState._fields:
            want = np.asarray(getattr(js, f))
            assert np.array_equal(want, getattr(ts, f).numpy()), (t, f)
            assert np.array_equal(getattr(us, f).numpy(),
                                  getattr(ts, f).numpy()), (t, f)
        for f in pt.TickOutbox._fields:
            want = np.asarray(getattr(jout, f))
            assert np.array_equal(want, getattr(tout, f).numpy()), (t, f)
            assert np.array_equal(getattr(uout, f).numpy(),
                                  getattr(tout, f).numpy()), (t, f)
        n_exec.append(int(tout.exec_count.sum()))
    return n_exec


@pytest.mark.parametrize("rs", [2, 1], ids=["replica2x4", "groups1x8"])
def test_sharded_tick_equals_reference_and_unsharded(rs):
    assert sum(_run_bare(rs, 0, 5)) > 0


@pytest.mark.parametrize("rs", [2, 1], ids=["replica2x4", "groups1x8"])
def test_exec_budget_rank_exchange(rs):
    """A budget that bites (24 executions a tick over 64 groups x 4
    replicas) makes the group shards exchange their per-row counts between
    the tick's halves: still equal to both references."""
    n_exec = _run_bare(rs, 24, 6)
    assert max(n_exec) == 24 and all(n <= 24 for n in n_exec), n_exec


def test_mesh_geometry_and_refusals():
    """Layout checks and the reference's refusals, equal in both
    packages."""
    out = {}
    for key, mk in (("ref", lambda n, rs: jmesh.make_mesh(
            jax.devices()[:n], replica_shards=rs)),
                    ("port", lambda n, rs: tmesh.make_mesh(
                        ["cpu"] * n, replica_shards=rs))):
        got = []
        for n, rs in ((8, 2), (8, 1), (8, 3)):
            try:
                m = mk(n, rs)
                got.append((m.shape["replica"], m.shape["groups"]))
            except ValueError as e:
                got.append(str(e))
        stk = jstk if key == "ref" else tstk
        m = mk(8, 2)
        for R, G in ((3, 64), (4, 60)):
            try:
                stk.validate_mesh_for(m, R, G)
            except ValueError as e:
                got.append(str(e))
        out[key] = got
    assert out["ref"] == out["port"]
    assert out["port"][:2] == [(2, 4), (1, 8)]


def test_manager_mesh_refusals():
    """The reference's ValueErrors for a mesh with register groups, leases
    or health, and for more devices than are visible on CUDA."""
    msgs = {}
    for key, P in PKGS.items():
        got = []
        for field in ("register_groups", "read_leases", "group_health"):
            c = P.Config()
            c.paxos.max_groups = 64
            c.paxos.mesh_devices = 8
            setattr(c.paxos, field, 8 if field == "register_groups" else True)
            try:
                P.Manager(c, 3, [P.KV() for _ in range(3)], **P.kw)
                got.append("built")
            except ValueError as e:
                got.append(str(e))
        msgs[key] = got
    assert msgs["ref"] == msgs["port"]
    assert all("not supported" in m for m in msgs["port"])


def test_shard_body_calls_the_kernels_per_shard(monkeypatch):
    """Twin of the reference's pallas-in-shard_map case: each shard of a
    (1, 2) mesh ticks its own G=128 block through the kernel dispatchers,
    5 gathers + 1 match a shard a tick, and the result equals the
    unsharded tick.  The shard body's scripted halves run the plain
    versions inside their programs on the CPU, so the count runs their
    eager forms."""
    R, G, W = 3, 256, 4
    calls = []

    def counting(kind, fn):
        def wrapped(arrs, *rest):
            calls.append((kind, int(arrs[0].shape[-1])))
            return fn(arrs, *rest)
        return wrapped

    monkeypatch.setattr(tw, "gather_planes_many",
                        counting("gather", tw.gather_planes_many))
    monkeypatch.setattr(tw, "match_planes_many",
                        counting("match", tw.match_planes_many))
    monkeypatch.setattr(pt, "run_front", pt.tick_front)
    monkeypatch.setattr(
        pt, "run_back",
        lambda s, ib, m, eb=0, rb=None: pt.tick_back(s, ib, m, eb, rb)[:2])
    mesh = tmesh.make_mesh(["cpu"] * 2, replica_shards=1)
    tick = tstk.make_shardmap_tick(mesh)
    _, s = _states(R, G, W)
    u = s
    for t in range(3):
        req, stp, al = _inbox_np(R, G, seed=t)
        ib = pt.TickInbox(torch.from_numpy(req), torch.from_numpy(stp),
                          torch.from_numpy(al))
        s, out = tick(s, ib)
        u, uout = pt.paxos_tick_compact(u, ib, -1, 4096, 64)
    per_shard = ([("gather", G // 2)] * 4 + [("match", G // 2)]
                 + [("gather", G // 2)])
    assert sorted(calls) == sorted(per_shard * 2 * 3)
    for f in pst.PaxosState._fields:
        assert torch.equal(getattr(s, f), getattr(u, f)), f


# --------------------------------------------------------------- stacks
STACK_W = 4
STACK_GROUPS = 8


def _whole_state(m):
    """The manager's whole state: the port's mesh manager gathers its
    shards' blocks (``gather_state``); the reference's keeps one."""
    return m.gather_state() if hasattr(m, "gather_state") else m.state


def _run_stack(P, tmpdir, R, mesh_devices=0, replica_shards=1,
               compact=True):
    """``tests/test_sharding_stack.py``'s scripted workload through one
    package's manager: (state, app tables, responses, stats)."""
    cfg = P.Config()
    cfg.paxos.max_groups = 256
    cfg.paxos.window = STACK_W
    cfg.paxos.compact_outbox = compact
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.deactivation_ticks = 0
    cfg.paxos.mesh_devices = mesh_devices
    cfg.paxos.mesh_replica_shards = replica_shards
    wal = P.Logger(os.path.join(tmpdir, "wal"), sync_every_ticks=2,
                   checkpoint_every_ticks=16)
    apps = [P.KV() for _ in range(R)]
    m = P.Manager(cfg, R, apps, wal=wal, **P.kw)
    assert (m.mesh is not None) == bool(mesh_devices)
    members = list(range(R))
    for g in range(STACK_GROUPS):
        assert m.create_paxos_instance(f"svc{g}", members)
    resp = {}

    def cb(rid, r):
        resp[rid] = r

    for i in range(5):
        for g in range(STACK_GROUPS):
            m.propose(f"svc{g}", f"PUT k{i} v{g}.{i}".encode(), cb)
        m.tick()
    m.set_alive(R - 1, False)
    for i in range(2 * STACK_W + 4):
        m.propose("svc0", f"PUT q{i} w{i}".encode(), cb)
        m.tick()
    m.set_alive(R - 1, True)
    for _ in range(8):
        m.tick()
    m.drain_pipeline()
    state = [np.array(f.cpu().numpy() if isinstance(f, torch.Tensor)
                      else np.asarray(f)) for f in _whole_state(m)]
    dbs = [{k: dict(v) for k, v in a.db.items()} for a in apps]
    stats = {k: m.stats[k] for k in ("decisions", "executions",
                                     "checkpoint_transfers")}
    wal.close()
    return state, dbs, resp, stats


def _dir_bytes(root):
    out = {}
    for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                              recursive=True)):
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("R,rs,compact", [(4, 2, True), (3, 1, False)],
                         ids=["compact_replica2x4", "full_groups1x8"])
def test_stack_mesh_twin(tmp_path, R, rs, compact):
    """``test_sharding_stack.py``'s two stacks: the port's mesh manager
    equals the reference's mesh manager and the port's single-device
    manager (state, app tables, responses, counters), and the journals are
    byte-equal."""
    ref = _run_stack(PKGS["ref"], str(tmp_path / "ref"), R, 8, rs, compact)
    got = _run_stack(PKGS["port"], str(tmp_path / "port"), R, 8, rs, compact)
    one = _run_stack(PKGS["port"], str(tmp_path / "one"), R, 0, 1, compact)
    assert ref[3]["checkpoint_transfers"] >= 1
    for a, b, c in zip(ref[0], got[0], one[0]):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    assert ref[1:] == got[1:] == one[1:]
    assert _dir_bytes(str(tmp_path / "ref")) == _dir_bytes(
        str(tmp_path / "port"))


# ------------------------------------------------ control summaries (mesh)
def _repair_workload(P, tmpdir, donor_sel, R, mesh_devices, rs):
    """``tests/test_control_summaries.py``'s kill -> fall off the ring ->
    revive -> auto-repair script through one package's manager."""
    W, NG = 8, 8
    cfg = P.Config()
    cfg.paxos.max_groups = 64
    cfg.paxos.window = W
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.deactivation_ticks = 0
    cfg.paxos.device_donor_sel = donor_sel
    cfg.paxos.mesh_devices = mesh_devices
    cfg.paxos.mesh_replica_shards = rs
    wal = P.Logger(os.path.join(tmpdir, "wal"), sync_every_ticks=2,
                   native=False)
    apps = [P.KV() for _ in range(R)]
    m = P.Manager(cfg, R, apps, wal=wal, **P.kw)
    for g in range(NG):
        assert m.create_paxos_instance(f"svc{g}", list(range(R)))
    resp = {}

    def cb(rid, r):
        resp[rid] = r

    for i in range(4):
        for g in range(NG):
            m.propose(f"svc{g}", f"PUT k{i} v{g}.{i}".encode(), cb)
        m.tick()
    m.set_alive(R - 1, False)
    for i in range(2 * W + 4):
        m.propose("svc0", f"PUT q{i} w{i}".encode(), cb)
        m.propose("svc3", f"PUT r{i} x{i}".encode(), cb)
        m.tick()
    m.set_alive(R - 1, True)
    for i in range(8):
        m.propose(f"svc{i % NG}", f"PUT post{i} {i}".encode(), cb)
        m.tick()
    m.drain_pipeline()
    state = [np.array(f.cpu().numpy() if isinstance(f, torch.Tensor)
                      else np.asarray(f)) for f in _whole_state(m)]
    dbs = [{k: dict(v) for k, v in a.db.items()} for a in apps]
    m.wal.close()
    syncs = []
    for path in sorted(glob.glob(os.path.join(tmpdir, "wal",
                                              "journal.*.log"))):
        for raw in jread(path):
            rec = jrecords.loads(raw)
            if rec[0] == J_OP_SYNC:
                syncs.append(rec)
    return state, dbs, resp, dict(m.stats), syncs


def test_donor_ab_bit_identity_mesh(tmp_path):
    """The mesh case of ``test_control_summaries.py``: on a (2 replica, 4
    groups) mesh the donor summary comes from watermarks gathered across
    replicas inside the shard body and sliced back.  Device donor
    selection equals the host scan, and each equals the reference's run
    (journaled OP_SYNC records too)."""
    runs = {}
    for key, P in PKGS.items():
        for sel in (True, False):
            runs[key, sel] = _repair_workload(
                P, str(tmp_path / f"{key}{int(sel)}"), sel, 4, 8, 2)
    dev, host = runs["port", True], runs["port", False]
    assert len(dev[4]) >= 2, "the script must transfer checkpoints"
    for sel in (True, False):
        a, b = runs["ref", sel], runs["port", sel]
        for x, y in zip(a[0], b[0]):
            assert np.array_equal(x, y)
        assert a[1:3] == b[1:3] and a[4] == b[4]
    for x, y in zip(dev[0], host[0]):
        assert np.array_equal(x, y)
    assert dev[1:3] == host[1:3] and dev[4] == host[4]
