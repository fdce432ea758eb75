"""WAL twin, manager layer: the port's durable ``PaxosManager`` and
``recover`` against the JAX package's, driven by the same seeded workloads
(the port on ``device="cpu"``).

Tolerance: 0.  Journal and snapshot files must be equal byte for byte;
recovered managers must be equal field by field (state arrays, host
watermarks, apps, rows, queues, request records, counters), within a
package across replay arms and across packages.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jcfg
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.paxos import manager as jmgr
from gigapaxos_tpu.wal import logger as jlog
from gigapaxos_tpu_torch import config as tcfg
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.obs.metrics import registry as tregistry
from gigapaxos_tpu_torch.paxos import driver as tdriver
from gigapaxos_tpu_torch.paxos import manager as tmgr
from gigapaxos_tpu_torch.paxos import state as tst
from gigapaxos_tpu_torch.testing import faultdisk as tfault
from gigapaxos_tpu_torch.wal import columnar as tcol
from gigapaxos_tpu_torch.wal import journal as tjournal
from gigapaxos_tpu_torch.wal import logger as tlog
from gigapaxos_tpu_torch.wal import records as trec

PORT, REF = "port", "ref"
R = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(which, groups=32, window=8, **paxos):
    cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
    cfg.paxos.max_groups = groups
    cfg.paxos.window = window
    for k, v in paxos.items():
        setattr(cfg.paxos, k, v)
    return cfg


def _apps(which):
    return [(trep if which == PORT else jrep).KVApp() for _ in range(R)]


def make(which, path, sync_every=1, ckpt_every=1024, native=False,
         **paxos):
    cfg = _cfg(which, **paxos)
    log = tlog if which == PORT else jlog
    wal = log.PaxosLogger(str(path), sync_every_ticks=sync_every,
                          checkpoint_every_ticks=ckpt_every,
                          native=native,
                          payload_dedup=cfg.paxos.wal_payload_dedup)
    kw = {"device": "cpu"} if which == PORT else {}
    mgr = tmgr if which == PORT else jmgr
    return cfg, mgr.PaxosManager(cfg, R, _apps(which), wal=wal, **kw)


def recover(which, cfg, path, mode, native=False):
    kw = {"device": "cpu"} if which == PORT else {}
    log = tlog if which == PORT else jlog
    return log.recover(cfg, R, _apps(which), str(path), native=native,
                       replay_mode=mode, **kw)


BIG = [bytes([97 + i]) * 48 for i in range(3)]  # dedup-sized bodies


def drive(m, rounds=6):
    """Every record kind of the Mode A journal: single and batched
    creates, per-name proposals (bodies that repeat, so payload dedup
    engages), bulk admission, a laggard repaired by checkpoint transfer
    (OP_SYNC), an idle-group pause and the unpause a propose triggers, a
    remove and a stop."""
    for g in range(4):
        m.create_paxos_instance(f"kv{g}", [0, 1, 2])
    m.create_paxos_instances([f"b{g}" for g in range(6)], [0, 1, 2])
    brows = np.array([m.rows.row(f"b{g}") for g in range(6)], np.int64)
    for i in range(rounds):
        for g in range(4):
            m.propose(f"kv{g}", f"PUT k{i} v{g}.{i}".encode())
            m.propose(f"kv{g}", b"PUT big " + BIG[(g + i) % 3])
        m.propose_bulk(brows, [b"PUT bk " + BIG[(i + j) % 3]
                               for j in range(6)])
        m.run_ticks(2)
    # replica 2 misses more than W slots of kv0 -> checkpoint transfer
    m.set_alive(2, False)
    for i in range(14):
        m.propose("kv0", f"PUT lag{i} {i}".encode())
        m.run_ticks(1)
    m.set_alive(2, True)
    m.run_ticks(4)
    for i in range(3):
        for g in (0, 1):
            m.propose(f"kv{g}", b"PUT big2 " + BIG[(g + i) % 3])
        m.run_ticks(1)
    # idle groups pause; a propose to one unpauses it
    m.run_ticks(3)
    m.pause_idle(limit=2)
    m.propose("kv3", b"PUT back alive")
    m.run_ticks(2)
    m.remove_paxos_instance("b5")
    m.propose_stop("kv2")
    m.run_ticks(3)


def post_traffic(m):
    for i in range(3):
        m.propose("kv0", f"PUT post{i} p{i}".encode())
        m.propose("kv1", b"PUT big " + BIG[i])
    m.run_ticks(3)


def _files(path, pattern):
    out = []
    for p in sorted(glob.glob(os.path.join(str(path), pattern))):
        with open(p, "rb") as f:
            out.append((os.path.basename(p), f.read()))
    return out


def _state_np(m):
    if isinstance(m, tmgr.PaxosManager):
        return tst.state_to_numpy(m.state)
    return [np.asarray(f) for f in m.state]


def assert_identical(ma, mb):
    for name, a, b in zip(tst.PaxosState._fields, _state_np(ma),
                          _state_np(mb)):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ma.tick_num == mb.tick_num
    assert ma._next_rid == mb._next_rid
    assert np.array_equal(ma._host_exec, mb._host_exec)
    for r in range(R):
        assert ma.apps[r].db == mb.apps[r].db, f"replica {r} app diverged"
    assert dict(ma.rows.items()) == dict(mb.rows.items())
    assert ma.rows.snapshot_free_rows() == mb.rows.snapshot_free_rows()
    assert ma._stopped_rows == mb._stopped_rows
    assert sorted(ma.outstanding) == sorted(mb.outstanding)
    for rid, a in ma.outstanding.items():
        b = mb.outstanding[rid]
        assert (a.name, a.row, a.payload, a.stop, a.entry, a.slot,
                a.executed_by, a.responded) == \
            (b.name, b.row, b.payload, b.stop, b.entry, b.slot,
             b.executed_by, b.responded)
    qa = {k: list(v) for k, v in ma._queues.items() if v}
    qb = {k: list(v) for k, v in mb._queues.items() if v}
    assert qa == qb
    assert sorted(ma._paused) == sorted(mb._paused)
    assert np.array_equal(ma._bulk_leftover, mb._bulk_leftover)
    assert (ma.bulk is None) == (mb.bulk is None)
    if ma.bulk is not None:
        sa, sb = ma.bulk.snapshot(), mb.bulk.snapshot()
        assert sa.keys() == sb.keys()
        for k in sa:
            if isinstance(sa[k], np.ndarray):
                assert np.array_equal(sa[k], sb[k]), k
            else:
                assert sa[k] == sb[k], k


def _write_both(tmp_path, **kw):
    """The same workload through both packages' durable managers; the
    crash is a WAL close with no drain."""
    out = {}
    for which in (REF, PORT):
        d = tmp_path / which
        cfg, m = make(which, d, **kw)
        drive(m)
        m.wal.close()
        out[which] = (cfg, m, d)
    return out


# --------------------------------------------------------- journal bytes

@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("mode", ["compact_pipe", "full_eager"])
def test_manager_journal_and_snapshot_bytes_equal(tmp_path, dedup, mode):
    kw = dict(compact_outbox=mode == "compact_pipe",
              pipeline_ticks=mode == "compact_pipe",
              wal_payload_dedup=dedup, ckpt_every=16,
              deactivation_ticks=3)
    both = _write_both(tmp_path, **kw)
    (_, jm, jd), (_, tm, td) = both[REF], both[PORT]
    assert tm.stats["checkpoint_transfers"] > 0  # an OP_SYNC was journaled
    assert tm.stats["paused"] > 0 and tm.stats["unpaused"] > 0
    jj, tj = _files(jd, "journal.*.log"), _files(td, "journal.*.log")
    assert [n for n, _ in tj] == [n for n, _ in jj]
    assert tj == jj
    js, ts = _files(jd, "snapshot.*.bin"), _files(td, "snapshot.*.bin")
    assert ts and ts == js
    ops = {trec.loads(r)[0] for name, _ in tj
           for r in tjournal.read_journal(os.path.join(str(td), name))}
    # (the creates sit in a journal the checkpoints' GC removed)
    assert {tlog.OP_TICK, tlog.OP_SYNC, tlog.OP_PAUSE, tlog.OP_UNPAUSE,
            tlog.OP_REMOVE} <= ops
    refs = sum(b.count(b"\x00payref") for _, b in tj)
    assert (refs > 0) == dedup


def test_replayed_coo_triples_unique_per_tick(tmp_path):
    """The on-device inbox scatter needs unique real (entry, lane, row)
    triples per tick (only padding may repeat): check every tick the
    manager journaled."""
    _, m = make(PORT, tmp_path, compact_outbox=True, pipeline_ticks=True)
    drive(m)
    m.wal.close()
    recs = []
    for p in sorted(glob.glob(str(tmp_path / "journal.*.log"))):
        recs += [trec.loads(r) for r in tjournal.read_journal(p)]
    ticks = [r for r in recs if r[0] == tlog.OP_TICK]
    slab = tcol.build_tick_slab(ticks, R, resolve=False)
    e, p, g, *_ = tcol.coo_window(slab, 0, len(slab), m.G,
                                  max(8, slab.max_entries()))
    n_real = 0
    for k in range(len(slab)):
        real = g[k] < m.G
        trip = set(zip(e[k][real], p[k][real], g[k][real]))
        assert len(trip) == int(real.sum()), k
        n_real += int(real.sum())
    assert n_real > 50


# -------------------------------------------------------------- recovery

ARMS = {
    "reference": ("reference", None),
    "batched_dense": ("batched", "0"),
    "batched_sparse": ("batched", "1"),
}


@pytest.mark.parametrize("ckpt", [0, 20])
@pytest.mark.parametrize("mode", ["compact_pipe", "full_eager"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_recovery_equals_reference(tmp_path, monkeypatch, arm, mode, ckpt):
    """Each arm (record at a time, batched dense, batched sparse), from
    the journal alone (ckpt 0) or from a snapshot plus its journal tail."""
    replay_mode, sparse = ARMS[arm]
    if sparse is not None:
        monkeypatch.setenv("GPTPU_REPLAY_SPARSE", sparse)
    both = _write_both(tmp_path, compact_outbox=mode == "compact_pipe",
                       pipeline_ticks=mode == "compact_pipe",
                       ckpt_every=ckpt or 1024, deactivation_ticks=3)
    cfg_j, jm, jd = both[REF]
    cfg_t, tm, td = both[PORT]
    mj = recover(REF, cfg_j, jd, replay_mode)
    mt = recover(PORT, cfg_t, td, replay_mode)
    assert_identical(mj, mt)
    if replay_mode == "batched":
        assert mt._replay_windows == mj._replay_windows
        assert mt._replay_sparse_windows == mj._replay_sparse_windows
        assert mt._replay_overflows == mj._replay_overflows == 0
        if not ckpt:  # the whole journal replays: windows must have run
            assert mt._replay_windows > 0
            assert (mt._replay_sparse_windows > 0) == (sparse == "1")
    # the live twins agree too (a live manager and its recovery differ
    # in the same places in both packages: rows freed by a remove keep
    # their app entries and bulk-store window only in the live run)
    jm.drain_pipeline()
    tm.drain_pipeline()
    assert_identical(jm, tm)
    post_traffic(mj)
    post_traffic(mt)
    assert_identical(mj, mt)
    mj.wal.close()
    mt.wal.close()
    assert _files(td, "journal.*.log") == _files(jd, "journal.*.log")


def test_batched_overflow_falls_back_to_reference(tmp_path, monkeypatch):
    """A tick whose true execution count exceeds the replay scatter
    budget is caught from the compact header and its window re-runs
    through the record-at-a-time body, in both packages alike."""
    calls = {}
    for which, log in ((REF, jlog), (PORT, tlog)):
        monkeypatch.setattr(log, "_REPLAY_SCAT_MIN", 1)
        orig = log._BatchedReplay._reference_tick
        calls[which] = []

        def counted(self, slab, t, _orig=orig, _c=calls[which]):
            _c.append(t)
            return _orig(self, slab, t)

        monkeypatch.setattr(log._BatchedReplay, "_reference_tick", counted)
    both = _write_both(tmp_path, compact_outbox=False, exec_budget=4)
    mj = recover(REF, both[REF][0], both[REF][2], "batched")
    mt = recover(PORT, both[PORT][0], both[PORT][2], "batched")
    assert calls[PORT] and calls[PORT] == calls[REF]
    assert mt._replay_overflows == mj._replay_overflows > 0
    assert_identical(mj, mt)
    ref_arm = recover(PORT, both[PORT][0], both[PORT][2], "reference")
    assert_identical(mt, ref_arm)


@pytest.mark.parametrize("writer", [REF, PORT])
def test_cross_package_recovery(tmp_path, writer):
    """Each package recovers the directory the other wrote, to the state
    the writer's own package recovers."""
    cfg, m = make(writer, tmp_path / "w", compact_outbox=True,
                  pipeline_ticks=True, ckpt_every=16, deactivation_ticks=3)
    drive(m)
    m.wal.close()
    shutil.copytree(tmp_path / "w", tmp_path / "r")
    other = PORT if writer == REF else REF
    own = recover(writer, cfg, tmp_path / "w", "batched")
    cross = recover(other, _cfg(other, compact_outbox=True,
                                pipeline_ticks=True, deactivation_ticks=3),
                    tmp_path / "r", "batched")
    assert_identical(own, cross)
    post_traffic(own)
    post_traffic(cross)
    assert_identical(own, cross)


def test_native_backend_recovery_equals_python(tmp_path):
    """The port's native journal writes the Python backend's files, and a
    directory it wrote recovers to the same state."""
    dirs = {}
    for native in (False, True):
        d = tmp_path / f"n{int(native)}"
        cfg, m = make(PORT, d, native=native, compact_outbox=True,
                      ckpt_every=16, deactivation_ticks=3)
        assert m.wal.backend == ("native" if native else "python")
        drive(m)
        m.wal.close()
        dirs[native] = d
    assert _files(dirs[True], "journal.*.log") == \
        _files(dirs[False], "journal.*.log")
    a = recover(PORT, cfg, dirs[False], "batched")
    b = recover(PORT, cfg, dirs[True], "batched", native=True)
    assert b.wal.backend == "native"
    assert_identical(a, b)


def test_unported_records_raise_naming_their_slice(tmp_path):
    """Device-KV and targeted-create records are refused, never
    skipped."""
    cases = [
        ((tlog.OP_TICK, 0, [], np.ones(R, bool).tobytes(), None,
          (b"", b"", b"", b"")), "device-KV"),
        ((tlog.OP_CREATE_AT, "x", [0, 1, 2], 0, 3, b""), "control-plane"),
    ]
    for i, (rec, word) in enumerate(cases):
        d = tmp_path / f"c{i}"
        d.mkdir()
        j = tjournal.PyJournal(str(d / "journal.00000000.log"))
        j.append(trec.dumps(rec))
        j.close()
        for mode in ("reference", "batched"):
            with pytest.raises(NotImplementedError, match=word):
                recover(PORT, _cfg(PORT), d, mode)


# ------------------------------------------------------ storage faults

def test_torn_tail_recovers_like_reference(tmp_path):
    both = _write_both(tmp_path, compact_outbox=True)
    for which in (REF, PORT):
        p = tfault.newest_journal(str(both[which][2]))
        tfault.tear_tail(p, 23)
        assert tjournal.scan_journal(p).kind == "torn_tail"
    mj = recover(REF, both[REF][0], both[REF][2], "batched")
    mt = recover(PORT, both[PORT][0], both[PORT][2], "batched")
    assert_identical(mj, mt)
    post_traffic(mt)  # the repaired journal takes appends again


def test_scribble_fail_stops_with_evidence(tmp_path):
    cfg, m = make(PORT, tmp_path)
    m.create_paxos_instance("svc", [0, 1, 2])
    for i in range(6):
        m.propose("svc", f"PUT k{i} v{i}".encode())
    m.run_ticks(6)
    m.wal.close()
    (journal,) = glob.glob(str(tmp_path / "journal.*.log"))
    with open(journal, "rb") as f:
        before = f.read()
    tfault.flip_byte(journal, offset=8 + 4)  # first frame's CRC field
    assert tjournal.scan_journal(journal).kind == "scribble"
    with open(journal, "rb") as f:
        damaged = f.read()
    assert damaged != before
    for mode in ("reference", "batched"):
        with pytest.raises(tlog.WalQuarantinedError):
            recover(PORT, cfg, tmp_path, mode)
        with open(journal, "rb") as f:
            assert f.read() == damaged  # left in place, untouched
    with pytest.raises(jlog.WalQuarantinedError):
        recover(REF, _cfg(REF), tmp_path, "batched")


def test_corrupt_snapshot_falls_back_a_generation(tmp_path):
    both = {}
    for which in (REF, PORT):
        cfg, m = make(which, tmp_path / which, ckpt_every=4)
        m.create_paxos_instance("svc", [0, 1, 2])
        for i in range(10):
            m.propose("svc", f"PUT k{i} v{i}".encode())
        m.run_ticks(9)
        snaps = sorted(glob.glob(str(tmp_path / which / "snapshot.*.bin")))
        assert len(snaps) >= 2
        db = [dict(a.db) for a in m.apps]
        tick = m.tick_num
        m.wal.close()
        tfault.flip_byte(snaps[-1], offset=os.path.getsize(snaps[-1]) // 2)
        both[which] = (cfg, snaps, db, tick)
    fb = tregistry().counter("snapshot_fallbacks_total")
    before = fb.value
    cfg, snaps, db, tick = both[PORT]
    mt = recover(PORT, cfg, tmp_path / PORT, "batched")
    assert fb.value == before + 1
    assert os.path.exists(snaps[-1] + ".corrupt")
    assert mt.tick_num == tick
    assert [a.db for a in mt.apps] == db
    mj = recover(REF, both[REF][0], tmp_path / REF, "batched")
    assert_identical(mj, mt)


def test_fsync_error_is_sticky_fail_stop(tmp_path):
    injector = tfault.install()
    try:
        cfg, m = make(PORT, tmp_path)
        m.create_paxos_instance("svc", [0, 1, 2])
        m.propose("svc", b"PUT a 1")
        m.run_ticks(2)
        assert injector.arm(str(tmp_path), "fsync_error")
        m.propose("svc", b"PUT b 2")
        with pytest.raises(tlog.WalFailedError):
            m.run_ticks(2)
        assert m.wal.failed and not m.wal.accepting_writes()
        assert m.propose("svc", b"PUT c 3") is None
        assert m.stats["shed_requests"] >= 1
        with pytest.raises(tlog.WalFailedError):
            m.wal._append(b"zombie write")
    finally:
        tfault.uninstall()


def test_driver_fail_stops_on_wal_error(tmp_path):
    injector = tfault.install()
    try:
        cfg, m = make(PORT, tmp_path)
        m.create_paxos_instance("svc", [0, 1, 2])
        drv = tdriver.TickDriver(m, idle_sleep_s=0.001).start()
        assert drv.wait_ready(timeout_s=60)
        assert injector.arm(str(tmp_path), "fsync_error")
        m.propose("svc", b"PUT a 1")
        drv.kick()
        drv._thread.join(timeout=60)
        assert not drv._thread.is_alive()
        assert isinstance(drv.fatal, tlog.WalFailedError)
    finally:
        tfault.uninstall()


def test_disk_full_sheds_retriable_then_resumes(tmp_path):
    shed = tregistry().counter("wal_shed_writes_total")
    for which in (REF, PORT):
        cfg, m = make(which, tmp_path / which)
        m.create_paxos_instance("svc", [0, 1, 2])
        m.run_ticks(2)
        before = shed.value
        m.wal.shedding = True  # what the free-bytes watermark trips
        done = []
        assert m.propose("svc", b"PUT a 1",
                         lambda _r, resp: done.append(resp)) is None
        rids = m.propose_bulk(np.array([0, 0]), [b"PUT b 2", b"PUT c 3"])
        assert (rids == -2).all()
        m.run_ticks(2)
        assert done == [None]
        if which == PORT:
            assert shed.value >= before + 2
        assert m.stats["shed_requests"] >= 3
        m.wal.shedding = False
        got = []
        assert m.propose("svc", b"PUT d 4",
                         lambda _r, resp: got.append(resp)) is not None
        m.run_ticks(3)
        assert got == [b"OK"]
        m.wal.close()


def test_responses_held_until_fsync(tmp_path):
    """With sync_every_ticks=4 a response is released only by the group
    commit that covers its tick: on the same ticks in both packages."""
    fired = {}
    for which in (REF, PORT):
        cfg, m = make(which, tmp_path / which, sync_every=4)
        m.create_paxos_instance("svc", [0, 1, 2])
        log = []
        for t in range(12):
            m.propose("svc", f"PUT k{t} {t}".encode(),
                      lambda rid, resp, t=t: log.append(
                          (t, m.tick_num, m.wal.is_synced())))
            m.tick()
        fired[which] = log
        m.wal.close()
    assert fired[PORT] == fired[REF]
    assert fired[PORT] and all(ok for *_, ok in fired[PORT])
    assert {n % 4 for _, n, _ in fired[PORT]} == {0}


def test_spill_dir_pause_unpause(tmp_path):
    """Paused groups page to disk (the port's DiskMap, on the records
    codec) and come back on a propose, as in the reference: the same
    spill files and journal bytes."""
    out = {}
    for which in (REF, PORT):
        spill = tmp_path / f"spill_{which}"
        cfg, m = make(which, tmp_path / which, spill_dir=str(spill),
                      spill_cache=1, deactivation_ticks=2)
        for g in range(4):
            m.create_paxos_instance(f"s{g}", [0, 1, 2])
            m.propose(f"s{g}", f"PUT k v{g}".encode())
        m.run_ticks(6)
        assert m.pause_idle(limit=4) == 4
        assert m._paused.cold_count() == 3
        files = _files(spill / "default", "*.rec")  # spill_dir/<spill_ns>
        got = []
        m.propose("s1", b"GET k", lambda _r, resp: got.append(resp))
        m.run_ticks(3)
        assert got == [b"v1"]
        m.wal.close()
        out[which] = (files, _files(tmp_path / which, "journal.*.log"),
                      m.paused_count())
    assert out[PORT] == out[REF]
    assert len(out[PORT][0]) == 3


def test_tail_for_row_equals_reference(tmp_path):
    both = _write_both(tmp_path, compact_outbox=True)
    jm, tm = both[REF][1], both[PORT][1]
    for name in ("kv0", "kv1", "b2"):
        row = tm.rows.row(name)
        assert tm.wal.tail_for_row(row, name) == \
            jm.wal.tail_for_row(row, name)


# ----------------------------------------------- chip_smoke's wal legs

def test_chip_smoke_wal_legs_on_cpu(tmp_path):
    """The ``wal`` phase of chip_smoke.py at a small size on the CPU (its
    dense and sparse legs, every check included)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    dev = torch.device("cpu")
    dense = chip_smoke.wal_dense_leg(torch, dev, 3, 8, 256, ticks=8,
                                     work=str(tmp_path / "dense"))
    assert dense["replay"]["overflows"] == 0
    sparse = chip_smoke.wal_sparse_leg(torch, dev, 3, 4, 4096, ticks=8,
                                       work=str(tmp_path / "sparse"))
    assert sparse["replay"]["sparse_windows"] > 0
