"""Resident mesh twin: a ``PaxosManager`` whose state lives as four shards'
blocks (``paxos.mesh_devices = 4``; on the CPU, 4 x ``cpu`` stand in for
four cards) against the one-device manager on the same seeded traffic.

Tolerance: 0.  Every state field, every tick's outbox, every response,
the counter app's tables and the manager's counters are compared with
``np.array_equal`` / ``==``; the counter deployment's plain reference
(``gpbench/reference/counter.py``) judges the final tables; and the bytes
the mesh sends between its shards each tick (``mesh_transfer_bytes_total``)
are exactly the exec budget's rank blocks: each shard's ``[W, R]`` int32
block to each of the three others.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
from gigapaxos_tpu_torch.models.replicable import KVApp
from gigapaxos_tpu_torch.obs.metrics import registry
from gigapaxos_tpu_torch.parallel import mesh as tmesh
from gigapaxos_tpu_torch.paxos import manager as mgr
from gigapaxos_tpu_torch.paxos.manager import PaxosManager
from gigapaxos_tpu_torch.wal import PaxosLogger, recover

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gpbench.reference import counter as ref_counter  # noqa: E402

R, G, W, P = 3, 256, 8, 4
SHARDS = 4
TICKS = 28
DEAD_FROM, DEAD_TO = 4, 4 + 2 * W + 2
BODIES = [int(d).to_bytes(8, "little", signed=True) for d in range(17)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _transfer(kind):
    return sum(c.value for c in registry().find("mesh_transfer_bytes_total")
               if dict(c.labels).get("kind") == kind)


def _cfg(mesh_devices, compact=True, exec_budget=R * G + 64):
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.window = W
    cfg.paxos.proposals_per_tick = P
    cfg.paxos.compact_outbox = compact
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.deactivation_ticks = 0
    cfg.paxos.mesh_devices = mesh_devices
    cfg.paxos.mesh_replica_shards = 1
    cfg.paxos.exec_budget = exec_budget
    return cfg


def _outbox_np(out):
    if out is None:
        return None
    return [np.array(x) if not isinstance(x, (int, np.integer)) else int(x)
            for x in out]


def _drive(mesh_devices, compact=True, seed=7, exec_budget=R * G + 64):
    """The counter deployment under ``propose_bulk`` traffic: a replica
    dies for long enough to fall off the ring on its busiest groups, comes
    back and is repaired by checkpoint transfer; every tick's outbox, the
    responses, the tables, the state and each tick's shard-to-shard bytes
    are returned."""
    apps = [DenseCounterApp(G) for _ in range(R)]
    m = PaxosManager(_cfg(mesh_devices, compact, exec_budget), R, apps,
                     spill_ns=f"resident{mesh_devices}", device="cpu")
    for a in apps:
        a.row_of = m.rows.row
    names = [f"g{i}" for i in range(G)]
    assert m.create_paxos_instances(names, list(range(R))) == G
    assert (m._res is not None) == bool(mesh_devices)
    rng = np.random.default_rng(seed)
    resp, groups, deltas = {}, [], []

    def sink_for(rids):
        def sink(offsets, responses):
            if responses is None:  # failed
                responses = [None] * len(offsets)
            for o, r in zip(offsets, responses):
                resp[int(rids[0]) + int(o)] = r
        return sink

    outs, per_tick = [], []
    for t in range(TICKS + 40):
        if t == DEAD_FROM:
            m.set_alive(R - 1, False)
        if t == DEAD_TO:
            m.set_alive(R - 1, True)
        if t < TICKS:
            n = 48
            rows = rng.integers(0, G, n)
            if DEAD_FROM <= t < DEAD_TO:
                rows[:16] = rng.integers(0, 4, 16)  # busy groups
            d = rng.integers(1, 17, n)
            holder = []
            rids = m.propose_bulk(
                rows, [BODIES[x] for x in d],
                batch_sink=lambda o, r, h=holder: h[0](o, r))
            adm = rids >= 0
            holder.append(sink_for(rids[adm]) if adm.any()
                          else (lambda o, r: None))
            groups.append(rows[adm])
            deltas.append(d[adm])
        before = _transfer("rank")
        outs.append(_outbox_np(m.tick()))
        per_tick.append(_transfer("rank") - before)
    m.drain_pipeline()
    outs.append(_outbox_np(m.tick()))
    m.drain_pipeline()
    state = [f.numpy().copy() for f in m.gather_state()]
    return dict(
        outs=outs, resp=resp, state=state,
        acc=np.stack([a.acc for a in apps]),
        count=np.stack([a.count for a in apps]),
        rows=np.array([m.rows.row(n) for n in names]),
        group=np.concatenate(groups), delta=np.concatenate(deltas),
        stats=dict(m.stats), per_tick=per_tick, m=m)


@pytest.mark.parametrize("compact,budget",
                         [(True, R * G + 64), (True, 40), (False, R * G + 64)],
                         ids=["compact", "compact_tight_budget", "full"])
def test_resident_mesh_equals_one_device(compact, budget):
    """``compact_tight_budget``: an exec budget below a busy tick's
    executions, so the global rank across the shards decides which run."""
    one = _drive(0, compact, exec_budget=budget)
    mesh = _drive(SHARDS, compact, exec_budget=budget)
    assert one["stats"]["checkpoint_transfers"] >= 1, one["stats"]
    assert one["stats"] == mesh["stats"]
    for t, (a, b) in enumerate(zip(one["outs"], mesh["outs"])):
        assert (a is None) == (b is None), t
        if a is None:
            continue
        for i, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (t, i)
    for x, y in zip(one["state"], mesh["state"]):
        assert np.array_equal(x, y)
    assert one["resp"] == mesh["resp"]
    assert np.array_equal(one["acc"], mesh["acc"])
    assert np.array_equal(one["count"], mesh["count"])
    if budget < R * G:
        # a budget that binds leaves requests behind: some fail, some are
        # still unanswered when the drive stops
        assert None in one["resp"].values()
        return
    assert len(one["resp"]) == len(one["group"])
    assert None not in one["resp"].values()
    # the plain reference, over the rows the groups were given (a laggard
    # repair restores the donor's table: no request is lost or doubled)
    rows = mesh["rows"]
    checks = ref_counter.compare(G, mesh["group"], mesh["delta"],
                                 mesh["acc"][:, rows], mesh["count"][:, rows])
    assert checks == {"state_groups_wrong": 0, "state_cells_wrong": 0}


def test_resident_mesh_sends_only_the_rank_blocks():
    """Each compact tick sends every shard's [W, R] int32 rank block to
    the three other shards, and nothing else crosses shards."""
    before = {k: _transfer(k) for k in ("rank", "replica", "state")}
    got = _drive(SHARDS)
    block = W * R * 4
    assert got["per_tick"] == [SHARDS * (SHARDS - 1) * block] * len(
        got["per_tick"])
    assert _transfer("replica") == before["replica"]
    # nothing of the state moved on a tick: only the final comparison's
    # global view, once
    m = got["m"]
    state_bytes = sum(t.numel() * t.element_size()
                      for k, b in m._res.blocks.items() if k != (0, 0)
                      for t in b)
    assert _transfer("state") - before["state"] == state_bytes


def test_resident_blocks_live_on_their_shards():
    """The blocks are born on the shards' devices and keep their size; the
    whole state is a gather, and loading one cuts it back."""
    m = _drive(SHARDS)["m"]
    per = G // SHARDS
    assert m.shard_geometry() == (SHARDS, per)
    for (ri, gi), b in m._res.blocks.items():
        assert b.exec_slot.shape == (R, per)
        assert b.acc_req.shape == (R, W, per)
    assert m.state is None
    full = m.gather_state()
    blocks = tmesh.shard_state(full, m.mesh)
    for k, b in m._res.blocks.items():
        for x, y in zip(b, blocks[k]):
            assert torch.equal(x, y)
    m.load_state(full)
    for x, y in zip(m.gather_state(), full):
        assert torch.equal(x, y)


def _admin_script(mesh_devices, rs=1, Rr=3):
    """Single creates, a targeted create, a remove, pause and unpause,
    exec watermarks and group_info on a KV manager."""
    cfg = _cfg(mesh_devices)
    cfg.paxos.mesh_replica_shards = rs
    cfg.paxos.exec_budget = 0
    apps = [KVApp() for _ in range(Rr)]
    m = PaxosManager(cfg, Rr, apps, device="cpu")
    for g in range(12):
        assert m.create_paxos_instance(f"s{g}", list(range(Rr)), epoch=g % 3)
    assert m.create_paxos_instance_at("moved", list(range(Rr)), 2, G - 3)
    got = []
    for i in range(6):
        for g in range(12):
            m.propose(f"s{g}", f"PUT k{i} v{g}".encode(),
                      lambda rid, r: got.append((rid, r)))
        m.propose("moved", f"PUT m{i} x".encode(),
                  lambda rid, r: got.append((rid, r)))
        m.tick()
    for _ in range(4):
        m.tick()
    m.drain_pipeline()
    assert m.remove_paxos_instance("s3")
    paused = m._pause_eligible(limit=3, ignore_idle=True)
    assert len(paused) == 3
    m.propose(paused[0], b"PUT after pause", lambda rid, r: got.append(
        (rid, r)))
    for _ in range(4):
        m.tick()
    m.drain_pipeline()
    info = {n: m.group_info(n) for n in ("s0", "moved", paused[0])}
    for v in info.values():
        v.pop("tick", None)
    marks = {n: m.exec_watermarks(n).tolist() for n in ("s1", "moved")}
    state = [f.numpy().copy() for f in m.gather_state()]
    return state, sorted(got), info, marks, dict(m.stats), paused


@pytest.mark.parametrize("mesh_devices,rs,Rr",
                         [(4, 1, 3), (4, 2, 4)], ids=["groups1x4",
                                                      "replica2x2"])
def test_resident_admin_paths_equal_one_device(mesh_devices, rs, Rr):
    """The rare paths reach rows through their owning block (and, with
    replica shards, a column written back): equal to one device."""
    one = _admin_script(0, 1, Rr)
    mesh = _admin_script(mesh_devices, rs, Rr)
    for x, y in zip(one[0], mesh[0]):
        assert np.array_equal(x, y)
    assert one[1:] == mesh[1:]


def _journaled_script(wal_dir, mesh_devices, checkpoint_every):
    """A KV deployment with a WAL: creates, puts, a replica dead long
    enough to need a checkpoint transfer, its repair; every checkpoint
    rolls the journal."""
    cfg = _cfg(mesh_devices)
    apps = [KVApp() for _ in range(R)]
    wal = PaxosLogger(str(wal_dir), sync_every_ticks=2,
                      checkpoint_every_ticks=checkpoint_every, native=False)
    m = PaxosManager(cfg, R, apps, wal=wal, spill_ns=f"walmesh{mesh_devices}",
                     device="cpu")
    assert m.create_paxos_instances([f"g{i}" for i in range(0, G, 5)],
                                    list(range(R))) == len(range(0, G, 5))
    for t in range(2 * W + 12):
        if t == 3:
            m.set_alive(R - 1, False)
        if t == 2 * W + 6:
            m.set_alive(R - 1, True)
        for g in range(0, G, 25):
            m.propose(f"g{g}", f"PUT k{t % 3} v{g}.{t}".encode(),
                      lambda rid, r: None)
        m.tick()
    for _ in range(6):
        m.tick()
    m.drain_pipeline()
    live = ([f.numpy().copy() for f in m.gather_state()],
            [{k: dict(v) for k, v in a.db.items()} for a in apps])
    m.wal.close()
    return cfg, live, dict(m.stats)


def _recovered(cfg, wal_dir, replay_mode=None):
    apps = [KVApp() for _ in range(R)]
    m = recover(cfg, R, apps, str(wal_dir), native=False, device="cpu",
                replay_mode=replay_mode)
    return m, ([f.numpy().copy() for f in m.gather_state()],
               [{k: dict(v) for k, v in a.db.items()} for a in apps])


@pytest.mark.parametrize("checkpoint_every", [1 << 20, 16],
                         ids=["journal", "snapshot_and_journal"])
def test_resident_mesh_recovers_from_its_wal(tmp_path, checkpoint_every):
    """A four-shard manager recovers from its WAL through its own sharded
    tick on the resident blocks, record at a time (the default, batched
    mode asked for): equal to the one-device manager recovered record at a
    time from the same workload's WAL and to the live managers (state and
    tables).  Replaying the journal moves no state between the shards; a
    snapshot's restore cuts the state once."""
    cfg1, live1, stats1 = _journaled_script(tmp_path / "one", 0,
                                            checkpoint_every)
    cfg4, live4, stats4 = _journaled_script(tmp_path / "mesh", SHARDS,
                                            checkpoint_every)
    assert stats1["checkpoint_transfers"] >= 1 and stats1 == stats4
    before = _transfer("state")
    m4, got4 = _recovered(cfg4, tmp_path / "mesh")
    moved = _transfer("state") - before
    assert m4._res is not None and m4.state is None
    _, got1 = _recovered(cfg1, tmp_path / "one", "reference")
    for live, got in ((live1, got1), (live4, got4), (got1, got4)):
        for x, y in zip(live[0], got[0]):
            assert np.array_equal(x, y)
        assert live[1] == got[1]
    block = sum(t.numel() * t.element_size()
                for k, b in m4._res.blocks.items() if k != (0, 0) for t in b)
    # the final comparison's gather, and a restore's cut
    assert moved == block * (2 if checkpoint_every == 16 else 1)


@pytest.mark.cuda
def test_resident_mesh_on_cards():
    """On ``min(4, device_count)`` cards (four shards of ``cuda:0`` on a
    one-card machine) the resident mesh equals the one-device manager on
    the card, state and tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(min(4, n))]
            if n >= 4 else [torch.device("cuda", 0)] * 4)

    def run(mesh):
        cfg = _cfg(0)
        apps = [DenseCounterApp(G) for _ in range(R)]
        m = PaxosManager(cfg, R, apps, device="cuda", mesh=mesh)
        for a in apps:
            a.row_of = m.rows.row
        m.create_paxos_instances([f"g{i}" for i in range(G)], [0, 1, 2])
        rng = np.random.default_rng(3)
        for t in range(12):
            rows = rng.integers(0, G, 64)
            m.propose_bulk(rows, [BODIES[x] for x in rng.integers(1, 17, 64)])
            m.tick()
        m.drain_pipeline()
        m.tick()
        m.drain_pipeline()
        return ([f.cpu().numpy() for f in m.gather_state()],
                [a.acc.copy() for a in apps])

    one = run(None)
    mesh = run(tmesh.make_mesh(devs))
    for x, y in zip(one[0], mesh[0]):
        assert np.array_equal(x, y)
    for x, y in zip(one[1], mesh[1]):
        assert np.array_equal(x, y)
