"""The Mode A inbox's sparse upload (``paxos/inupload.py``): the inbox a
one-device manager builds on its device from the tick's packed placements
equals, bit for bit, a dense fill of the placements the WAL journals
(``_placed``, ``_bulk_placed``), whatever mix of placements a tick makes;
a flat slot outside the inbox raises; every upload counts its bytes; on a
card the
upload never synchronises the host, the scatter kernel matches its plain
version, a pinned buffer is never rewritten before its copy has read it,
and a pipelined run executes what a blocking one does.  Imports no JAX; the
``cuda`` tests skip where there is no card."""

import struct
import time

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
from gigapaxos_tpu_torch.models.device_kv import OP_GET, OP_PUT, pack_desc
from gigapaxos_tpu_torch.obs.metrics import registry
from gigapaxos_tpu_torch.obs.phase import device_timers
from gigapaxos_tpu_torch.ops import plane_gather as pg
from gigapaxos_tpu_torch.paxos.inupload import InboxUploader
from gigapaxos_tpu_torch.paxos.manager import PaxosManager

R, P = 3, 4
EXEC_FIELDS = ("e_rid", "e_rep", "e_row", "e_slot", "e_stop")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _manager(app, G, plane, device="cpu", kv_budget=0, blocking=False):
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.bulk_capacity = 1 << 14
    cfg.overload.intake_hi = 1 << 14
    cfg.paxos.device_app = app == "kv"
    cfg.paxos.kv_reg_budget = kv_budget
    cfg.obs.blocking_phases = blocking
    apps = ([None] * R if app == "kv"
            else [DenseCounterApp(G) for _ in range(R)])
    m = PaxosManager(cfg, R, apps, spill_ns=plane, device=device)
    if app == "counter":
        for a in apps:
            a.row_of = m.rows.row
    m.create_paxos_instances([f"g{i}" for i in range(G)], list(range(R)))
    return m


def _sent_bytes(plane):
    (c,) = [c for c in registry().find("inbox_upload_bytes_total")
            if dict(c.labels) == {"driver": "modea", "plane": plane}]
    return c.value


class _Check:
    """Wraps ``m._upload_inbox``: each tick's device inbox (and descriptor
    columns) is held against a dense numpy fill of the tick's slow-path
    (``_placed``, stops from the outstanding records) and bulk
    (``_bulk_placed``, ``_bulk_stops``) placements, and the counter
    against the bytes the tick's packing needs."""

    def __init__(self, m, plane):
        self.m, self.plane = m, plane
        self.ticks = []
        inner = m._upload_inbox

        def upload(slow, reg):
            bp = m._bulk_placed
            n = len(slow) + (0 if bp is None else len(bp[0]))
            o = 0 if reg is None else len(reg[0])
            b0 = _sent_bytes(plane)
            inbox, dreg = inner(slow, reg)
            words = 3 * n + (R + 3) // 4 + 4 * o
            assert _sent_bytes(plane) - b0 == 4 * words
            assert m._in_req is None and m._in_stp is None
            req = np.zeros((R, m.P, m.G_total), np.int32)
            stp = np.zeros((R, m.P, m.G_total), bool)
            for row, take in m._placed:
                for rid, e, p in take:
                    req[e, p, row] = rid
                    stp[e, p, row] = m.outstanding[rid].stop
            if bp is not None:
                b_rid, b_e, b_p, b_row = bp
                req[b_e, b_p, b_row] = b_rid
                stp[b_e, b_p, b_row] = m._bulk_stops
            assert inbox.req.dtype == torch.int32
            assert inbox.stop.dtype == torch.bool
            assert torch.equal(inbox.req.cpu(), torch.from_numpy(req))
            assert torch.equal(inbox.stop.cpu(), torch.from_numpy(stp))
            assert torch.equal(inbox.alive.cpu(),
                               torch.from_numpy(m._inbox_alive))
            assert int((req != 0).sum()) == n
            if reg is None:
                assert dreg is None
            else:
                K = m._kv_reg_budget
                up = m._kv_uploaded
                assert (up is None) == (o == 0)
                for c, col in enumerate(dreg):
                    want = np.zeros(K, np.int32)
                    if o:
                        want[:o] = up[c]
                    assert col.dtype == torch.int32 and col.shape == (K,)
                    assert torch.equal(col.cpu(), torch.from_numpy(want))
            keys = {(f // (m.P * m.G_total), f % m.G_total)
                    for f, _, _ in slow}
            shifted = 0 if bp is None else sum(
                (int(e), int(row)) in keys and p > 0
                for e, p, row in zip(*bp[1:]))
            self.ticks.append({
                "slow": len(slow), "bulk": n - len(slow), "o": o,
                "shifted": shifted, "entry0": int((req[0] != 0).sum()),
                "stops": int(stp.sum()), "full": bool((req != 0).all()),
                "rows": set(np.flatnonzero((req != 0).any(axis=(0, 1)))),
                "dead": not m._inbox_alive.all(),
                "partial": o == getattr(m, "_kv_reg_budget", -1)
                and bool(m._kv_chunks)})
            return inbox, dreg

        m._upload_inbox = upload


def _pay(v):
    return struct.pack("<q", int(v))


def test_counter_inbox_equals_dense_staging():
    """Slow-path and bulk placements at the same (entry, row), stops, a
    dead entry re-homed, rows placed one tick and not the next, and a fully
    placed [R, P, G]: the device inbox equals the host staging every
    tick."""
    G, plane = 16, "inup-counter"
    m = _manager("counter", G, plane)
    chk = _Check(m, plane)
    rng = np.random.default_rng(5)
    # every (entry, p, row) slot at once
    for e in range(R):
        rids = m.propose_bulk(np.tile(np.arange(G), P),
                              [_pay(i) for i in range(P * G)], entries=e)
        assert (rids > 0).all()
    m.tick()
    for t in range(3):
        m.tick()  # the device's rejects placed again
    # slow path and bulk at the same (entry, row): the bulk shifts past
    for row in range(4):
        for _ in range(2):
            assert m.propose(f"g{row}", _pay(row), entry=1) is not None
    m.propose_bulk(np.arange(6), _pay(7), entries=1)
    m.tick()
    # rows 8..11 only: last tick's rows must read zero again
    m.propose_bulk(np.arange(8, 12), _pay(8))
    m.tick()
    # a dead entry: slow and bulk requests re-homed to a live member
    m.set_alive(0, False)
    m.propose("g5", _pay(5), entry=0)
    m.propose_bulk(np.array([6, 7, 9]), _pay(6), entries=0)
    m.tick()
    m.set_alive(0, True)
    # stops: a slow-path stop and a bulk stop beside plain requests
    assert m.propose_stop("g15", b"") is not None
    m.propose_bulk(np.array([13, 14, 2]), _pay(1),
                   stops=np.array([False, True, False]))
    m.tick()
    for _ in range(4):
        m.propose_bulk(rng.integers(0, 13, 24), _pay(3))
        m.tick()
    for _ in range(3):
        m.tick()
    m.drain_pipeline()
    ts = chk.ticks
    assert len(ts) == 15
    assert ts[0]["full"] and ts[0]["bulk"] == R * P * G
    assert ts[4]["slow"] == 8 and ts[4]["shifted"] == 4
    assert ts[5]["rows"] == {8, 9, 10, 11}
    assert ts[6]["dead"] and ts[6]["slow"] == 1 and ts[6]["bulk"] >= 3
    assert ts[6]["entry0"] == 0
    assert ts[7]["stops"] == 2
    assert not any(t["full"] for t in ts[1:])
    assert sum(t["bulk"] for t in ts[1:4]) > 0  # rejects placed again
    assert ts[-1]["slow"] == ts[-1]["bulk"] == 0


def test_device_app_descriptors_partial_take():
    """The device app's descriptor columns: more staged descriptors than
    the budget takes a tick (a chunk split), padded to the budget on the
    device; its slow path beside them."""
    G, K, plane = 16, 8, "inup-kv"
    m = _manager("kv", G, plane, kv_budget=K)
    chk = _Check(m, plane)
    rng = np.random.default_rng(9)
    for t in range(6):
        n = 11 if t < 4 else 0
        rows = rng.integers(0, G, n)
        m.propose_bulk_kv(rows, rng.choice([OP_PUT, OP_GET], n),
                          rng.integers(1, 8, n), rng.integers(0, 99, n))
        if t == 1:
            m.propose("g3", pack_desc(OP_PUT, 2, 5))
        m.tick()
    for _ in range(6):
        m.tick()
    m.drain_pipeline()
    ts = chk.ticks
    assert [t["o"] for t in ts[:4]] == [K] * 4
    assert any(t["partial"] for t in ts)
    assert sum(t["o"] for t in ts) == 44
    assert ts[-1]["o"] == 0
    assert any(t["slow"] for t in ts) and sum(t["bulk"] for t in ts) == 44


def test_ring_grows_by_power_of_two_and_alternates():
    up = InboxUploader("modea", "inup-ring", (R, P, 8),
                       torch.device("cpu"))
    timers = device_timers("modea", "inup-ring", ("upload",), None)
    sizes, bufs = [], []
    for n in (1, 2, 96, 3, 96):
        v = up.stage(n, 0)
        v.flat[:] = np.arange(n)
        v.rid[:] = np.arange(n) + 1
        v.stop[:] = np.arange(n) % 2
        v.alive[:] = 1
        inbox, reg = up.send(timers)
        assert reg is None
        flat = inbox.req.reshape(-1)
        assert torch.equal(flat[:n], torch.arange(n, dtype=torch.int32) + 1)
        assert int((flat != 0).sum()) == n
        assert torch.equal(inbox.stop.reshape(-1)[:n],
                           torch.arange(n) % 2 == 1)
        tensor, arr = up._ring[up._turn]
        sizes.append(arr.size)
        bufs.append(tensor.data_ptr())
    assert sizes == [InboxUploader.MIN_WORDS] * 5
    assert bufs[2] == bufs[0] and bufs[3] == bufs[1] != bufs[0]
    up.stage(3 * InboxUploader.MIN_WORDS, 0)
    assert up._ring[up._turn][1].size == 16 * InboxUploader.MIN_WORDS
    with pytest.raises(ValueError):
        InboxUploader("modea", "inup-ring", (3, 4, 1 << 28),
                      torch.device("cpu"))


@pytest.mark.parametrize("bad", [-1, R * P * 8])
def test_slot_outside_the_inbox_raises(bad):
    """A packed flat slot outside [0, R*P*G) raises on the host before any
    copy, whatever the device: neither the kernel, which does not check,
    nor ``index_put_``, which wraps a negative index, ever sees it."""
    up = InboxUploader("modea", "inup-range", (R, P, 8), torch.device("cpu"))
    timers = device_timers("modea", "inup-range", ("upload",), None)
    b0 = _sent_bytes("inup-range")
    v = up.stage(3, 0)
    v.flat[:] = [0, bad, 5]
    v.rid[:] = [1, 2, 3]
    v.stop[:] = 0
    v.alive[:] = 1
    with pytest.raises(ValueError, match="outside"):
        up.send(timers)
    assert _sent_bytes("inup-range") == b0


@pytest.mark.cuda
def test_build_inbox_never_synchronises_the_host():
    """At 2^16 groups on a card: _build_inbox, bulk and slow placements
    and the device app's descriptors included, raises nothing under
    ``set_sync_debug_mode("error")``, which does raise for the dense
    build's pageable copy."""
    dev = _cuda()
    G = 1 << 16
    rng = np.random.default_rng(3)
    for app in ("counter", "kv"):
        plane = f"inup-sync-{app}"
        m = _manager(app, G, plane, device=dev,
                     kv_budget=4096 if app == "kv" else 0)
        inner = m._build_inbox

        def strict(*a, inner=inner):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return inner(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        m._build_inbox = strict
        for t in range(6):
            n = 1000 * (t + 1)
            rows = rng.integers(0, G, n)
            if app == "kv":
                m.propose_bulk_kv(rows, rng.choice([OP_PUT, OP_GET], n),
                                  rng.integers(1, 8, n),
                                  rng.integers(0, 99, n))
            else:
                m.propose_bulk(rows, _pay(t))
                m.propose("g7", _pay(t))
            m.tick()
        m.drain_pipeline()
        assert m._inup._ring[0][0].is_pinned()
        assert _sent_bytes(plane) > 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.from_numpy(np.zeros(4, np.int32)).to(dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_scatter_kernel_matches_index_put():
    dev = _cuda()
    shape = (R, P, 1 << 16)
    total = R * P * (1 << 16)
    rng = np.random.default_rng(1)
    for n in (1, 4099, 50_000, total):
        idx = rng.permutation(total)[:n].astype(np.int32)
        rid = rng.integers(1, 2**31 - 1, n).astype(np.int32)
        stop = rng.integers(0, 2, n).astype(np.int32)
        cols = [torch.from_numpy(a) for a in (idx, rid, stop)]
        want = (torch.zeros(shape, dtype=torch.int32),
                torch.zeros(shape, dtype=torch.bool))
        pg.scatter_inbox_plain(*cols, *want)
        got = (torch.zeros(shape, dtype=torch.int32, device=dev),
               torch.zeros(shape, dtype=torch.bool, device=dev))
        before = pg.scatter_launches
        pg.scatter_inbox_cuda(*(c.to(dev) for c in cols), *got)
        torch.cuda.synchronize()
        assert pg.scatter_launches == before + 1
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_ring_buffer_waits_for_its_copy():
    """A buffer's next stage waits for the copy that read it, queued
    behind a long device sleep: the first inbox holds its own placements,
    not the ones written into the same buffer two uploads later."""
    dev = _cuda()
    shape = (R, P, 1 << 16)
    up = InboxUploader("modea", "inup-wait", shape, dev)
    timers = device_timers("modea", "inup-wait", ("upload",), dev)
    inboxes = []
    torch.cuda._sleep(1 << 30)  # ~0.5 s of the tick's stream
    t0 = time.perf_counter()
    for k in range(3):
        v = up.stage(100, 0)
        if k == 2:
            # the first upload's buffer: its copy has run
            assert up._sent[up._turn].query()
            waited = time.perf_counter() - t0
        v.flat[:] = np.arange(100) * 7 + k
        v.rid[:] = 1000 * (k + 1) + np.arange(100)
        v.stop[:] = k % 2
        v.alive[:] = 1
        inboxes.append(up.send(timers)[0])
    torch.cuda.synchronize()
    assert waited > 0.05
    for k, ib in enumerate(inboxes):
        flat = ib.req.reshape(-1).cpu()
        sel = torch.arange(100) * 7 + k
        assert torch.equal(flat[sel], 1000 * (k + 1) + torch.arange(
            100, dtype=torch.int32))
        assert int((flat != 0).sum()) == 100
        assert bool(ib.stop.reshape(-1).cpu()[sel].all()) == bool(k % 2)


@pytest.mark.cuda
def test_pipelined_run_executes_as_blocking():
    """At 2^16 groups: a pipelined run of the sparse upload executes the
    same stream as the same run with every tick's device work waited for
    (``obs.blocking_phases``)."""
    dev = _cuda()
    G = 1 << 16
    streams = {}
    for blocking in (False, True):
        m = _manager("counter", G, f"inup-pipe-{blocking}", device=dev,
                     blocking=blocking)
        outs = []
        complete = m._complete_tick

        def completing(*a, complete=complete, outs=outs, **k):
            out = complete(*a, **k)
            outs.append(out)
            return out

        m._complete_tick = completing
        rng = np.random.default_rng(17)
        for t in range(10):
            rows = rng.integers(0, G, 3000)
            m.propose_bulk(rows, [_pay(v) for v in
                                  rng.integers(-99, 99, len(rows))])
            m.tick()
        for _ in range(4):
            m.tick()
        m.drain_pipeline()
        streams[blocking] = {f: np.concatenate([getattr(o, f)
                                                for o in outs])
                             for f in EXEC_FIELDS}
        assert len(outs) == 14
    a, b = streams[False], streams[True]
    assert len(a["e_rid"]) >= 10 * 3000
    for f in EXEC_FIELDS:
        assert np.array_equal(a[f], b[f]), f
