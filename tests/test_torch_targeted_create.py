"""Targeted-create twin: the row allocator's ``alloc_at`` and
``free_in_range``, ``PaxosManager.create_paxos_instance_at`` with its
journaled ``OP_CREATE_AT`` record, and
``PaxosReplicaCoordinator.create_replica_group_at``, on the port (CPU)
against the JAX package, from the same seeded inputs.

Tolerance: 0.  Return values, allocator free lists, device state, apps,
client responses and journal bytes are equal; each package recovers the
other's directory (with its ``OP_CREATE_AT`` records) to the state the
writer's own package recovers.
"""

import shutil

import numpy as np
import pytest
import torch

from gigapaxos_tpu.reconfiguration import coordinator as jcoord
from gigapaxos_tpu.utils import intmap as jintmap
from gigapaxos_tpu_torch.reconfiguration import coordinator as tcoord
from gigapaxos_tpu_torch.utils import intmap as tintmap
from gigapaxos_tpu_torch.wal import journal as tjournal
from gigapaxos_tpu_torch.wal import logger as tlog
from gigapaxos_tpu_torch.wal import records as trec
from test_torch_recovery import (PORT, REF, _apps, _cfg, _files,
                                 assert_identical, make, recover)

COORD = {REF: jcoord, PORT: tcoord}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- allocator
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("split", [None, 24])
def test_alloc_at_and_free_in_range_equal_reference(seed, split):
    """A seeded mix of alloc, alloc_at (free and taken rows), free and
    range searches: the same answers, errors and free lists."""
    rng = np.random.default_rng(seed)
    allocs = [mod.RowAllocator(32, split) for mod in (jintmap, tintmap)]
    for step in range(300):
        op = int(rng.integers(4))
        name = f"n{int(rng.integers(40))}"
        row = int(rng.integers(-2, 36))
        lo = int(rng.integers(0, 32))
        hi = lo + int(rng.integers(0, 12))
        outs = []
        for a in allocs:
            try:
                if op == 0:
                    out = a.alloc(name, hi=bool(split) and row % 2 == 0)
                elif op == 1:
                    out = a.alloc_at(name, row)
                elif op == 2:
                    out = a.free(name)
                else:
                    out = a.free_in_range(lo, hi)
            except (KeyError, MemoryError) as e:
                out = (type(e).__name__, str(e))
            outs.append(out)
        assert outs[0] == outs[1], (step, op)
        assert allocs[0].snapshot_free_rows() == \
            allocs[1].snapshot_free_rows()
        assert dict(allocs[0].items()) == dict(allocs[1].items())


# --------------------------------------------------------------- manager
def _seed_blob(which, state):
    app = _apps(which)[0]
    for k, v in state.items():
        app.execute("tmp", f"PUT {k} {v}".encode(), 1)
    return app.checkpoint("tmp")


def drive_targeted(which, m):
    """Plain and targeted creates interleaved with frees, traffic on the
    migrated groups, and every refusal of a targeted create; -> the
    manager's return values and the responses its callbacks saw."""
    out, resp = [], []
    for g in range(6):
        out.append(m.create_paxos_instance(f"kv{g}", [0, 1, 2]))
    m.run_ticks(2)
    out.append(m.remove_paxos_instance("kv2"))
    out.append(m.remove_paxos_instance("kv4"))
    free = m.rows.free_in_range(0, m.G)
    out.append(free)
    out.append(m.create_paxos_instance_at(
        "mig#1", [0, 1, 2], 1, free, app_seed=_seed_blob(
            which, {"city": "amherst"})))
    hi = m.rows.free_in_range(m.G // 2, m.G)
    out.append(hi)
    out.append(m.create_paxos_instance_at("far#3", [0, 2], 3, hi))
    out.append(m.create_paxos_instance_at("mig#1", [0, 1, 2], 1, 9))
    out.append(m.create_paxos_instance_at("taken", [0, 1, 2], 0,
                                          m.rows.row("kv0")))
    out.append(m.create_paxos_instance_at("oob", [0, 1, 2], 0, m.G + 5))
    for i in range(4):
        for n in ("mig#1", "far#3", "kv0"):
            m.propose(n, f"PUT k{i} {n}.{i}".encode(),
                      lambda rid, r, n=n: resp.append((n, r)))
        m.propose("mig#1", b"GET city", lambda rid, r: resp.append(r))
        m.run_ticks(2)
    # a plain create after the targeted pops takes the LIFO top the
    # replayed free list must also hold
    out.append(m.create_paxos_instance("late", [0, 1, 2]))
    out.append(m.rows.row("late"))
    m.run_ticks(4)
    return out, resp


@pytest.mark.parametrize("ckpt", [1024, 6])
def test_create_paxos_instance_at_equals_reference(tmp_path, ckpt):
    got = {}
    for which in (REF, PORT):
        d = tmp_path / which
        cfg, m = make(which, d, ckpt_every=ckpt)
        got[which] = (cfg, m, d, drive_targeted(which, m))
        m.wal.close()
    (_, jm, jd, jout), (_, tm, td, tout) = got[REF], got[PORT]
    assert jout == tout
    out, resp = tout
    assert out[9] is True and out[11] is True and out[12:15] == [False] * 3
    assert (("mig#1", b"OK") in resp and b"amherst" in resp)
    assert_identical(jm, tm)
    jj, tj = _files(jd, "journal.*.log"), _files(td, "journal.*.log")
    assert tj == jj
    assert _files(td, "snapshot.*.bin") == _files(jd, "snapshot.*.bin")
    if ckpt == 1024:
        ops = [trec.loads(r)[0] for name, _ in tj
               for r in tjournal.read_journal(str(td / name))]
        assert ops.count(tlog.OP_CREATE_AT) == 2


@pytest.mark.parametrize("writer", [REF, PORT])
@pytest.mark.parametrize("mode", ["reference", "batched"])
def test_targeted_create_cross_package_recovery(tmp_path, writer, mode):
    cfg, m = make(writer, tmp_path / "w")
    drive_targeted(writer, m)
    m.wal.close()
    shutil.copytree(tmp_path / "w", tmp_path / "r")
    other = PORT if writer == REF else REF
    own = recover(writer, cfg, tmp_path / "w", mode)
    cross = recover(other, _cfg(other), tmp_path / "r", mode)
    assert_identical(own, cross)
    assert cross.apps[0].db["mig#1"]["city"] == "amherst"
    assert cross.rows.row("far#3") == own.rows.row("far#3")
    for x in (own, cross):
        x.propose("far#3", b"PUT after 1")
        x.run_ticks(3)
    assert_identical(own, cross)


# ----------------------------------------------------------- coordinator
def test_create_replica_group_at_equals_reference(tmp_path):
    nodes = ["AR0", "AR1", "AR2"]
    got = {}
    for which in (REF, PORT):
        _, m = make(which, tmp_path / which)
        c = COORD[which].PaxosReplicaCoordinator(m, nodes)
        blob = _seed_blob(which, {"a": "1", "b": "2"})
        out, resp = [], []
        out.append(c.create_replica_group("svc", 0, b"", nodes))
        row = m.rows.free_in_range(0, m.G)
        out += [row, c.create_replica_group_at("svc", 1, blob, nodes[:2],
                                               row)]
        out.append(c.create_replica_group_at("svc", 1, blob, nodes, row))
        out.append(c.create_replica_group_at("ghost", 0, blob, ["XX"], 7))
        out += [c.current_epoch("svc"), c.get_replica_group("svc")]
        for p in (b"GET a", b"PUT c 3", b"GET b"):
            c.coordinate_request("svc", 1, p,
                                 lambda rid, r: resp.append(r))
            m.run_ticks(3)
        out += [resp, [a.db for a in m.apps]]
        m.wal.close()
        got[which] = (m, out)
    (jm, jout), (tm, tout) = got[REF], got[PORT]
    assert jout == tout
    assert tout[2] is True and tout[3:5] == [False, False]
    assert tout[-2] == [b"1", b"OK", b"2"]
    assert_identical(jm, tm)
    assert _files(tmp_path / PORT, "journal.*.log") == \
        _files(tmp_path / REF, "journal.*.log")
