"""The Mode A outbox's copy to the host, started at dispatch into a ring of
host buffers (``paxos/outcopy.py``): the outbox ``tick()`` returns owns its
arrays, a pipelined run that crosses ``drain_pipeline`` executes what an
unpipelined run executes, and on a card the buffers are pinned, reused and
written on a stream of their own.  Imports no JAX; the ``cuda`` test skips
where there is no card."""

import struct

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
from gigapaxos_tpu_torch.models.device_kv import OP_GET, OP_PUT
from gigapaxos_tpu_torch.obs.metrics import registry
from gigapaxos_tpu_torch.paxos.manager import PaxosManager
from gigapaxos_tpu_torch.paxos.outcopy import OutboxCopier
from gigapaxos_tpu_torch.wal.logger import PaxosLogger

R = 3
EXEC_FIELDS = ("e_rid", "e_rep", "e_row", "e_slot", "e_stop")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _manager(app, pipeline, G=64, wal_dir=None, device="cpu", plane="oc"):
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = pipeline
    cfg.paxos.bulk_capacity = 1 << 14
    cfg.overload.intake_hi = 1 << 14
    cfg.paxos.device_app = app == "kv"
    wal = (None if wal_dir is None else PaxosLogger(
        str(wal_dir), sync_every_ticks=1, checkpoint_every_ticks=5,
        native=False))
    apps = ([None] * R if app == "kv"
            else [DenseCounterApp(G) for _ in range(R)])
    m = PaxosManager(cfg, R, apps, wal=wal, spill_ns=plane, device=device)
    if app == "counter":
        for a in apps:
            a.row_of = m.rows.row
    m.create_paxos_instances([f"g{i}" for i in range(G)], list(range(R)))
    return m


class _Run:
    """A seeded load of one request a row on half the rows each tick (no
    intake is refused, so the device sees the same inboxes pipelined or
    not), with every completed outbox and response kept."""

    def __init__(self, m, app, seed=7):
        self.m, self.app = m, app
        self.rng = np.random.default_rng(seed)
        self.outs, self.resp = [], {}
        complete = m._complete_tick

        def completing(*a, **k):
            out = complete(*a, **k)
            self.outs.append(out)
            return out

        m._complete_tick = completing

    def propose(self):
        m, rng = self.m, self.rng
        rows = rng.permutation(m.G)[:m.G // 2]
        cbs = [lambda rid, resp: self.resp.__setitem__(rid, resp)] * len(rows)
        if self.app == "kv":
            ops = rng.choice([OP_PUT, OP_GET], len(rows))
            rids = m.propose_bulk_kv(rows, ops, rng.integers(1, 8, len(rows)),
                                     rng.integers(0, 1 << 20, len(rows)),
                                     callbacks=cbs)
        else:
            rids = m.propose_bulk(
                rows, [struct.pack("<q", int(v)) for v in
                       rng.integers(-1000, 1000, len(rows))], callbacks=cbs)
        assert (rids > 0).all()

    def tick(self):
        self.propose()
        return self.m.tick()

    def stream(self):
        return {f: np.concatenate([getattr(o, f) for o in self.outs])
                for f in EXEC_FIELDS}

    def app_state(self):
        m = self.m
        if self.app == "kv":
            return [np.asarray(f.cpu()) for f in m.kv]
        return [(a.acc.copy(), a.count.copy()) for a in m.apps]


@pytest.mark.parametrize("app", ["counter", "kv"])
def test_returned_outbox_owns_its_arrays(app):
    """An outbox from tick() is unchanged after two more ticks, which copy
    into the same host buffers again."""
    run = _Run(_manager(app, pipeline=True), app)
    for _ in range(3):
        run.tick()
    out = run.tick()
    assert out.n_exec > 0 and out.lag_n == 0
    kept = {f: np.array(getattr(out, f)) for f in out._fields}
    for _ in range(2):
        assert run.tick().n_exec > 0
    for f, v in kept.items():
        assert np.array_equal(getattr(out, f), v), f
    ring = [a for turn in run.m._outcopy._ring for _, a in turn]
    assert len(ring) == 2
    for f in EXEC_FIELDS + ("taken_bits",):
        assert not any(np.shares_memory(getattr(out, f), a) for a in ring)


@pytest.mark.parametrize("app", ["counter", "kv"])
@pytest.mark.parametrize("drain", ["explicit", "wal_checkpoint"])
def test_drained_pipeline_executes_as_unpipelined(app, drain, tmp_path):
    """A pipelined run whose completions cross drain_pipeline (called
    between ticks, or by a due WAL checkpoint inside tick()) executes the
    same stream, answers the same and ends in the same app state as an
    unpipelined run on the same inputs."""
    res, drains = {}, {}
    for pipeline in (True, False):
        wal = tmp_path / str(pipeline) if drain == "wal_checkpoint" else None
        m = _manager(app, pipeline, wal_dir=wal)
        run = _Run(m, app)
        drained = drains[pipeline] = []
        inner = m.drain_pipeline

        def counting(inner=inner, m=m, drained=drained):
            drained.append(m._pending_out is not None)
            inner()

        m.drain_pipeline = counting
        for t in range(16):
            run.tick()
            if drain == "explicit" and t in (4, 9):
                m.drain_pipeline()
        for _ in range(4):
            m.tick()
        m.drain_pipeline()
        assert m.pending_count() == 0
        res[pipeline] = run
    assert sum(drains[True]) >= 3  # drains that completed a pending tick
    a, b = res[True], res[False]
    assert len(a.outs) == len(b.outs) == 20
    sa, sb = a.stream(), b.stream()
    assert len(sa["e_rid"]) >= 16 * 32 * R
    for f in EXEC_FIELDS:
        assert np.array_equal(sa[f], sb[f]), f
    for f in ("n_exec", "decided_total", "lag_n"):
        assert [getattr(o, f) for o in a.outs] == \
            [getattr(o, f) for o in b.outs], f
    for x, y in zip(a.outs, b.outs):
        assert np.array_equal(x.taken_bits, y.taken_bits)
    assert len(a.resp) == 16 * 32 and a.resp == b.resp
    for x, y in zip(a.app_state(), b.app_state()):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    for k in ("decisions", "executions", "dup_commits", "kv_misses"):
        assert a.m.stats[k] == b.m.stats[k], k


def test_copier_ring_reuses_two_buffers_a_position():
    c = OutboxCopier("modea", "ring")
    a = torch.arange(10, dtype=torch.int32)
    got = [c.land(c.start(a + k)) for k in range(3)]
    assert got[0] is got[2] and got[1] is not got[0]
    assert np.array_equal(got[2], np.arange(10) + 2)
    assert np.array_equal(got[1], np.arange(10) + 1)
    # a tuple gets a pair of its own a position; a new size reallocates
    b = torch.arange(4, dtype=torch.int32)
    t1 = c.land(c.start((a, b)))
    t2 = c.land(c.start((a + 1, b + 1)))
    t3 = c.land(c.start((a + 2, b + 2)))
    assert isinstance(t1, tuple) and len(t1) == 2
    assert t3[0] is t1[0] and t3[1] is t1[1] and t2[1] is not t1[1]
    assert np.array_equal(t3[1], np.arange(4) + 2)
    assert np.array_equal(t2[0], np.arange(10) + 1)
    w = c.land(c.start(torch.arange(12, dtype=torch.int32)))
    assert w.shape == (12,) and np.array_equal(w, np.arange(12))


@pytest.mark.cuda
def test_outbox_copy_pinned_reused_on_a_copy_stream():
    """On a card: the outbox lands in two pinned buffers used in turn,
    copied on a stream that is not the tick's, timed as part "copy", and
    the run executes what the same run on the CPU executes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    G, plane = 4096, "outcopy-cuda"
    runs = {}
    for dev in ("cuda", "cpu"):
        m = _manager("counter", pipeline=True, G=G, device=dev,
                     plane=plane if dev == "cuda" else "outcopy-cpu")
        run = _Run(m, "counter", seed=11)
        ptrs, counts = [], []
        for _ in range(10):
            run.tick()
            ptrs.append(m._outcopy._ring[m._outcopy._turn][0][0].data_ptr())
            if dev == "cuda":
                (h,) = [x for x in registry().find("tick_device_seconds")
                        if dict(x.labels) == {"driver": "modea",
                                              "plane": plane, "part": "copy"}]
                counts.append(h.count)
        m.drain_pipeline()
        runs[dev] = (m, run, ptrs, counts)
    m, run, ptrs, counts = runs["cuda"]
    oc = m._outcopy
    assert all(t.is_pinned() for turn in oc._ring for t, _ in turn)
    assert ptrs[0] != ptrs[1] and ptrs[2:] == [ptrs[0], ptrs[1]] * 4
    cur = torch.cuda.current_stream(m.device)
    assert oc._stream is not None and oc._stream != cur
    assert oc._timers._stream == oc._stream
    assert m._dt._stream == cur
    assert counts[-1] >= 8 and counts[-1] > counts[4] > counts[0]
    c_run = runs["cpu"][1]
    sa, sb = run.stream(), c_run.stream()
    for f in EXEC_FIELDS:
        assert np.array_equal(sa[f], sb[f]), f
    assert run.resp == c_run.resp and len(run.resp) == 10 * G // 2
    for x, y in zip(run.app_state(), c_run.app_state()):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
