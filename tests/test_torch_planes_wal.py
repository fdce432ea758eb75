"""Plane twins of the WAL: journals, snapshots and recovery with the register
plane, the lease columns and the health fold on, in both packages (the port
on ``device="cpu"``).

Tolerance: 0.  Journal and snapshot files must be equal byte for byte
(``OP_REG`` records, 5-field ``OP_CREATE``, ``reg_``/``lease_``/``rlease_``
snapshot fields); each package must recover the other's directory to a
manager equal field by field (both state planes, the lease columns and
their host mirror, apps, rows, queues, counters), through both replay arms;
with every plane off the journals are the bytes they were before the planes
existed.
"""

import numpy as np
import pytest
import torch

from gigapaxos_tpu.testing import faultdisk as jfault
from gigapaxos_tpu.wal import journal as jjournal
from gigapaxos_tpu.wal import logger as jlog
from gigapaxos_tpu_torch.paxos import state as tst
from gigapaxos_tpu_torch.testing import faultdisk as tfault
from gigapaxos_tpu_torch.wal import journal as tjournal
from gigapaxos_tpu_torch.wal import logger as tlog

from test_torch_planes_manager import PKG, PORT, REF, mk_cfg
from test_torch_recovery import _files, assert_identical

R = 3
LOGGER = {REF: jlog, PORT: tlog}
FAULT = {REF: (jfault, jjournal), PORT: (tfault, tjournal)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(which, d, ckpt=12, native=False, **cfg_kw):
    P = PKG[which]
    cfg = mk_cfg(which, **cfg_kw)
    wal = LOGGER[which].PaxosLogger(str(d), checkpoint_every_ticks=ckpt,
                                    native=native)
    m = P.mgr.PaxosManager(cfg, R, [P.rep.KVApp() for _ in range(R)],
                           wal=wal, **P.kw)
    return cfg, m


def recover(which, cfg, d, mode):
    P = PKG[which]
    return LOGGER[which].recover(cfg, R, [P.rep.KVApp() for _ in range(R)],
                                 str(d), native=False, replay_mode=mode,
                                 **P.kw)


def drive(m, ticks=30, seed=5):
    """Log and register groups under seeded load, a replica crash long
    enough for checkpoint transfers on both planes (OP_SYNC), a remove
    and a stop; records every acked write."""
    rng = np.random.default_rng(seed)
    acked = {}
    reg = m.G_reg > 0
    for g in range(3):
        m.create_paxos_instance(f"log{g}", [0, 1, 2])
    if reg:
        for g in range(3):
            m.create_paxos_instance(f"reg{g}", [0, 1, 2], register=True)
    names = [f"log{g}" for g in range(3)] + (
        [f"reg{g}" for g in range(3)] if reg else [])

    def cb(name, k, v):
        def f(rid, resp):
            if resp == b"OK":
                acked[(name, k)] = v
        return f

    for t in range(ticks):
        if t == 8:
            m.set_alive(2, False)
        if t == 20:
            m.set_alive(2, True)
        for name in names:
            if rng.random() < 0.8:
                k, v = f"k{int(rng.integers(0, 4))}", f"v{t}"
                m.propose(name, f"PUT {k} {v}".encode(), cb(name, k, v))
        m.tick()
    m.remove_paxos_instance("log2")
    if reg:
        m.propose_stop("reg2")
    for _ in range(6):
        m.tick()
    m.drain_pipeline()
    return acked


def _host(f):
    return tst.to_host(f) if isinstance(f, torch.Tensor) else np.asarray(f)


def _ops(d):
    """The op byte of every record of every journal in ``d``."""
    out = []
    for p in sorted(d.glob("journal.*.log")):
        scan = tjournal.scan_journal(str(p))
        out += [tlog._load_op(raw, tlog.OP_SCHEMA)[0]
                for raw in tjournal.iter_scan_records(str(p), scan)]
    return out


def _planes(m):
    def host(tree):
        return None if tree is None else [_host(f) for f in tree]

    return {"rstate": host(m.rstate), "lease": host(m._lease),
            "rlease": host(m._rlease),
            "lease_np": None if m._lease_np is None else np.array(
                m._lease_np),
            "lease_clock": m._lease_clock}


def assert_same_manager(a, b):
    """``assert_identical`` of the log plane and the host books, plus the
    register plane and the lease columns."""
    assert_identical(a, b)
    pa, pb = _planes(a), _planes(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        x, y = pa[k], pb[k]
        if isinstance(x, list):
            assert len(x) == len(y), k
            for i, (u, v) in enumerate(zip(x, y)):
                assert u.dtype == v.dtype and np.array_equal(u, v), (k, i)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), k
        else:
            assert x == y, k


PLANES = {
    "register": dict(G_reg=4),
    "leases": dict(leases=True, horizon=6, margin=2),
    "health": dict(health=True),
    "all": dict(G_reg=4, leases=True, horizon=6, margin=2, health=True),
}


@pytest.mark.parametrize("planes", sorted(PLANES))
@pytest.mark.parametrize("compact", [True, False])
def test_plane_journals_snapshots_and_cross_recovery(tmp_path, planes,
                                                     compact):
    """Byte-equal journals and snapshots with each plane on; either package
    recovers either directory, through both replay arms, to one manager;
    every acked write reads back."""
    kw = dict(PLANES[planes], compact=compact, pipeline=compact)
    out = {}
    for which in (REF, PORT):
        cfg, m = make(which, tmp_path / which, **kw)
        acked = drive(m)
        m.wal.close()
        out[which] = (cfg, m, acked)
    assert out[REF][2] == out[PORT][2]
    for pattern in ("journal.*.log", "snapshot.*.bin"):
        jf = _files(tmp_path / REF, pattern)
        tf = _files(tmp_path / PORT, pattern)
        assert [n for n, _ in jf] == [n for n, _ in tf], pattern
        for (n, a), (_, b) in zip(jf, tf):
            assert a == b, n
    assert _files(tmp_path / PORT, "snapshot.*.bin")
    # OP_REG records ride the journal of a mixed run, and only there
    assert (tlog.OP_REG in _ops(tmp_path / PORT)) == ("G_reg" in kw)
    rec = {}
    for reader in (REF, PORT):
        for src in (REF, PORT):
            for mode in ("batched", "reference"):
                rec[(reader, src, mode)] = recover(
                    reader, out[reader][0], tmp_path / src, mode)
    base = rec[(REF, REF, "reference")]
    for key, m in rec.items():
        assert_same_manager(base, m)
    m = rec[(PORT, REF, "batched")]
    for (name, k), v in out[PORT][2].items():
        if name == "log2":
            continue  # removed: its app entry goes with the group
        assert m.apps[0].execute(name, f"GET {k}".encode(), 0) == \
            v.encode(), (name, k)


def test_planes_off_journals_unchanged(tmp_path):
    """With every plane off the port journals what the reference journals;
    a configured-but-unused register plane, and leases and health on under
    a stable coordinator, journal the same bytes (no OP_REG, 4-field
    creates, observation-only folds)."""
    def run(which, sub, **kw):
        d = tmp_path / sub
        _, m = make(which, d, ckpt=1000, compact=True, **kw)
        m.create_paxos_instance("svc", [0, 1, 2])
        for i in range(12):
            m.propose("svc", f"PUT k{i} v{i}".encode())
            m.tick()
        for _ in range(8):
            m.tick()
        m.drain_pipeline()
        m.wal.close()
        return _files(d, "journal.*.log"), [_host(f) for f in m.state]

    want, want_state = run(REF, "ref_off")
    for sub, kw in (("off", {}), ("reg", dict(G_reg=4)),
                    ("lease", dict(leases=True)),
                    ("health", dict(health=True)),
                    ("all", dict(G_reg=4, leases=True, health=True))):
        got, state = run(PORT, sub, **kw)
        assert got == want, sub
        for a, b in zip(want_state, state):
            assert np.array_equal(a, b), sub


@pytest.mark.parametrize("writer", [REF, PORT])
def test_torn_tail_across_mixed_planes_cross_recovery(tmp_path, writer):
    """A torn tail on the newest journal of a mixed, leased run: both
    packages walk the clean prefix (OP_CREATE(register), OP_REG, OP_TICK)
    to the same manager, and every acked write survives."""
    cfg, m = make(writer, tmp_path / "w", ckpt=10_000, G_reg=4,
                  leases=True, compact=True, pipeline=True)
    acked = drive(m, ticks=24)
    m.wal.close()
    fault, journal = FAULT[writer]
    p = fault.newest_journal(str(tmp_path / "w"))
    with open(p, "ab") as f:
        f.write(b"\x07garbage-partial-frame")
    assert journal.scan_journal(p).kind == "torn_tail"
    got = {}
    for reader in (REF, PORT):
        for mode in ("batched", "reference"):
            rcfg = mk_cfg(reader, G_reg=4, leases=True, compact=True,
                          pipeline=True)
            got[(reader, mode)] = recover(reader, rcfg, tmp_path / "w", mode)
    base = got[(REF, "reference")]
    for m2 in got.values():
        assert_same_manager(base, m2)
    m2 = got[(PORT, "batched")]
    for (name, k), v in acked.items():
        assert m2.apps[0].execute(name, f"GET {k}".encode(), 0) == \
            v.encode()
    n0 = m2.stats["decisions"]
    m2.propose("reg0", b"PUT after x")
    for _ in range(6):
        m2.tick()
    m2.drain_pipeline()
    assert m2.stats["decisions"] >= n0 + 1


def test_scribble_in_mixed_journal_fail_stops(tmp_path):
    """A flipped byte inside the fsynced body of a mixed-plane journal is
    refused by the port as by the reference: quarantine, never a skip."""
    cfg, m = make(PORT, tmp_path / "w", ckpt=10_000, G_reg=4, compact=True)
    drive(m, ticks=16)
    m.wal.close()
    p = tfault.newest_journal(str(tmp_path / "w"))
    tfault.flip_byte(p, offset=8 + 4)
    assert tjournal.scan_journal(p).kind == "scribble"
    with pytest.raises(tlog.WalQuarantinedError):
        recover(PORT, cfg, tmp_path / "w", "batched")


@pytest.mark.parametrize("native", [False, True])
def test_mixed_sparse_replay_matches_dense(tmp_path, monkeypatch, native):
    """Batched replay of a mixed run through sparse windows (forced) and
    dense windows (off) recovers the reference arm's manager; a lease run
    keeps the dense scan even when sparse is forced."""
    cfg, m = make(PORT, tmp_path / "w", ckpt=10_000, native=native,
                  G=64, G_reg=64, compact=True)
    drive(m, ticks=20)
    m.wal.close()
    base = recover(PORT, cfg, tmp_path / "w", "reference")
    for mode, want_sparse in (("1", True), ("0", False)):
        monkeypatch.setenv("GPTPU_REPLAY_SPARSE", mode)
        got = recover(PORT, cfg, tmp_path / "w", "batched")
        assert (got._replay_sparse_windows > 0) == want_sparse
        assert got._replay_overflows == 0
        assert_same_manager(base, got)
    cfg, m = make(PORT, tmp_path / "l", ckpt=10_000, G=64, G_reg=64,
                  leases=True, compact=True)
    drive(m, ticks=20)
    m.wal.close()
    monkeypatch.setenv("GPTPU_REPLAY_SPARSE", "1")
    got = recover(PORT, cfg, tmp_path / "l", "batched")
    assert got._replay_windows > 0 and got._replay_sparse_windows == 0
    monkeypatch.delenv("GPTPU_REPLAY_SPARSE")
    assert_same_manager(recover(PORT, cfg, tmp_path / "l", "reference"),
                        got)


@pytest.mark.parametrize("seed,compact", [(3, False), (11, True)])
def test_register_crash_recover_acked_durability(tmp_path, seed, compact):
    """The register safety soak's durability bar across packages: random
    crashes of replicas 1 and 2, checkpoints every 16 ticks, then a full
    crash; every response released to a client reads back after either
    package recovers either directory."""
    groups = ["g0", "g1", "rg0", "rg1"]
    acked_by = {}
    for which in (REF, PORT):
        rng = np.random.default_rng(seed)
        cfg, m = make(which, tmp_path / which, ckpt=16, G=4, G_reg=4,
                      compact=compact, pipeline=True)
        for g in groups:
            m.create_paxos_instance(g, [0, 1, 2], register=g.startswith("r"))
        acked = {}
        for t in range(50):
            for r in (1, 2):
                if rng.random() < 0.1:
                    if m.alive[r]:
                        if int((~m.alive).sum()) < 1:
                            m.set_alive(r, False)
                    else:
                        m.set_alive(r, True)
            g = groups[int(rng.integers(0, 4))]
            k, v = f"t{t}", f"tv{t}"

            def cb(rid, resp, g=g, k=k, v=v):
                if resp == b"OK":
                    acked[(g, k)] = v
            m.propose(g, f"PUT {k} {v}".encode(), cb)
            m.tick()
        for r in range(3):
            m.set_alive(r, True)
        for _ in range(30):
            m.tick()
        m.drain_pipeline()
        m.wal.close()
        acked_by[which] = acked
    assert acked_by[REF] == acked_by[PORT]
    assert any(g.startswith("r") for g, _ in acked_by[PORT])
    for reader in (REF, PORT):
        for src in (REF, PORT):
            rcfg = mk_cfg(reader, G=4, G_reg=4, compact=compact,
                          pipeline=True)
            m2 = recover(reader, rcfg, tmp_path / src, "batched")
            for (g, k), v in acked_by[src].items():
                assert m2.apps[0].execute(g, f"GET {k}".encode(), 0) == \
                    v.encode(), (reader, src, g, k)
