"""The port's tick spans, device timers and request waits (``obs/phase.py``,
``obs/metrics.py``, the bulk store's stage stamps), on the CPU: spans only
while recording, tiling their tick, equal to their histogram observations
and on the profiler's clock; the vectorised histogram against per-value
``observe``; the request waits of a small manager; the device-timer reader
over a fake event; the collector hook."""

import gc
import time
import tracemalloc

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch import config as tcfg
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.obs import metrics as om
from gigapaxos_tpu_torch.obs import phase
from gigapaxos_tpu_torch.paxos import manager as tmgr


@pytest.fixture
def spans():
    """A clean ring; recording switched off again afterwards."""
    phase.record_spans(False)
    phase.take_spans()
    try:
        yield
    finally:
        phase.record_spans(False)
        phase.take_spans()


def _tick(pc, phases):
    pc.begin()
    for p in phases:
        time.sleep(0.0005)
        pc.mark(p)
    pc.end()


def test_spans_only_while_recording_and_tile_the_tick(spans):
    phases = phase.DRIVER_PHASES["modea"]
    pc = phase.PhaseClock("modea", plane="spans", reg=om.Registry())
    _tick(pc, phases)
    assert phase.take_spans() == []
    phase.record_spans(True)
    _tick(pc, phases)
    phase.record_spans(False)
    _tick(pc, phases)
    got = phase.take_spans()
    assert [s[0] for s in got] == [f"modea.{p}" for p in phases] + [
        "modea.tick"]
    assert {s[3] for s in got} == {pc.tick - 1}
    tick = got[-1]
    assert got[0][1] == tick[1] and got[-2][2] <= tick[2]
    for a, b in zip(got[:-2], got[1:-1]):
        assert a[2] == b[1]
        assert a[1] <= a[2]
    # Unix nanoseconds, the profiler's clock
    assert abs(tick[2] - time.time_ns()) < 60e9


def test_span_lengths_equal_the_histogram_observations(spans):
    reg = om.Registry()
    pc = phase.PhaseClock("chain", plane="spans", reg=reg)
    phase.record_spans(True)
    _tick(pc, phase.DRIVER_PHASES["chain"])
    got = {s[0]: s[2] - s[1] for s in phase.take_spans()}
    for h in reg.find("tick_phase_seconds"):
        p = dict(h.labels)["phase"]
        assert h.count == 1 and h.total == got[f"chain.{p}"] * 1e-9
    (t,) = reg.find("tick_seconds")
    assert t.total == got["chain.tick"] * 1e-9


def test_pipelined_completion_carries_its_own_tick(spans):
    pc = phase.PhaseClock("modea", plane="spans", reg=om.Registry())
    phase.record_spans(True)
    pc.begin()
    pc.mark("repair")
    done = pc.tick - 1
    pc.touch(done)
    pc.mark("tally")
    pc.end()
    got = {s[0]: s[3] for s in phase.take_spans()}
    assert got == {"modea.repair": pc.tick, "modea.tally": done,
                   "modea.tick": pc.tick}


def test_spans_follow_a_profiler_session_on_its_clock(spans):
    pc = phase.PhaseClock("modeb", plane="spans", reg=om.Registry())
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pc.begin()
        assert phase._ON
        with record_function("spans.probe"):
            time.sleep(0.005)
            pc.touch()
            time.sleep(0.002)
            pc.mark("intake")
            time.sleep(0.005)
        pc.end()
    pc.begin()
    assert not phase._ON
    span = [s for s in phase.take_spans() if s[0] == "modeb.intake"][0]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "spans.probe"][0]
    assert ev.start_ns() <= span[1] < span[2] <= ev.start_ns() + \
        ev.duration_ns()


def test_mark_with_recording_off_appends_and_keeps_nothing(spans):
    pc = phase.PhaseClock("modea", plane="spans", reg=om.Registry())
    pc.begin()
    tracemalloc.start()
    try:
        pc.mark("execute")  # the clock's last stamp, traced from here
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            pc.mark("execute")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, phase.__file__)]
    grown = [d for d in after.filter_traces(flt).compare_to(
        before.filter_traces(flt), "lineno") if d.size_diff > 0]
    assert grown == []
    assert phase.take_spans() == []


def test_session_totals_are_the_gain_while_recording(spans):
    h = om.registry().histogram("spans_test_seconds", probe="1")
    h.observe(1.0)
    phase.record_spans(True)
    h.observe(0.25)
    h.observe(0.5)
    phase.record_spans(False)
    h.observe(8.0)
    key = ("spans_test_seconds", (("probe", "1"),))
    assert phase.session_totals()[key] == (2, 0.75)


@pytest.mark.parametrize("unit,seed", [("s", 0), ("s", 1), ("", 2)])
def test_observe_array_matches_observe_value_by_value(unit, seed):
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        rng.exponential(0.01, 3000), rng.uniform(-3, 3, 500),
        rng.lognormal(0, 12, 500),
        [0.0, -0.0, -1.0, -1e-12, 1e-6, 2e-6, 0.5e-6, 2.0 ** 63,
         2.0 ** 63 / 1e6 * 5, 1e300, 2.0 ** 62 / 1e6]])
    rng.shuffle(v)
    a = om.Histogram("a", unit=unit)
    b = om.Histogram("b", unit=unit)
    a.total = b.total = 0.125
    for x in v:
        a.observe(float(x))
    b.observe_array(v[:1234])
    b.observe_array(v[1234:].tolist())
    b.observe_array(np.zeros(0))
    assert a.buckets == b.buckets and a.count == b.count
    # NumPy's pairwise sum against sequential adds: within the sequential
    # sum's own rounding bound
    eps = np.finfo(np.float64).eps
    assert abs(a.total - b.total) <= len(v) * eps * (0.125 + np.abs(v).sum())


def _manager(groups=64, **paxos):
    cfg = tcfg.GigapaxosTpuConfig()
    cfg.paxos.max_groups = groups
    cfg.paxos.window = 8
    for k, v in paxos.items():
        setattr(cfg.paxos, k, v)
    m = tmgr.PaxosManager(cfg, 3, [trep.NoopApp() for _ in range(3)],
                          device="cpu", spill_ns="spans-test")
    m.create_paxos_instances([f"g{i}" for i in range(groups)], [0, 1, 2])
    return m


class _Spy:
    """A request-wait histogram that keeps each observed array."""

    def __init__(self, h):
        self.h, self.seen = h, []

    def observe_array(self, v, counts=None):
        self.seen.append(np.array(v) if counts is None
                         else np.repeat(v, counts))
        self.h.observe_array(v, counts)


@pytest.mark.parametrize("pipeline", [True, False])
def test_request_waits_of_bulk_requests(pipeline):
    m = _manager(pipeline_ticks=pipeline)
    assert isinstance(m._dt, type(phase._NULL_TIMERS))  # no device timers
    spy = {k: _Spy(h) for k, h in m._wait_h.items()}
    m._wait_h = spy
    placed = {"queue": [], "order": []}
    observe = m._observe_wait

    def observe_wait(stage, idx):
        placed[stage].append(m.bulk.rid[idx].copy())
        observe(stage, idx)

    m._observe_wait = observe_wait
    sunk, t_admit = {}, {}
    rng = np.random.default_rng(5)
    n_req = 0
    for t in range(12):
        if t < 6:
            rows = rng.integers(0, 64, 150)  # > P a row: some wait a tick
            holder = []

            def sink(offs, resp, holder=holder):
                now = time.perf_counter()
                for o in np.asarray(offs).tolist():
                    sunk[holder[0] + o] = now

            t0 = time.perf_counter()
            rids = m.propose_bulk(rows, b"x" * 8, batch_sink=sink)
            assert (rids > 0).all()
            holder.append(int(rids[0]))
            for r in rids.tolist():
                t_admit[r] = t0
            n_req += len(rids)
        m.tick()
    m.drain_pipeline()
    assert len(sunk) == n_req
    q_rid = np.concatenate(placed["queue"])
    o_rid = np.concatenate(placed["order"])
    q_val = np.concatenate(spy["queue"].seen)
    o_val = np.concatenate(spy["order"].seen)
    # one queue wait a placement, one order wait a release
    assert len(q_val) == len(q_rid) >= n_req
    assert len(o_val) == len(o_rid) == n_req
    assert sorted(o_rid.tolist()) == sorted(sunk)
    wait = {}
    for r, v in zip(np.r_[q_rid, o_rid].tolist(), np.r_[q_val, o_val]):
        assert v >= 0
        wait[r] = wait.get(r, 0.0) + float(v)
    for r, w in wait.items():
        assert w <= sunk[r] - t_admit[r] + 1e-9


class _FakeEvent:
    """A CUDA event on a fake device whose clock the test advances."""

    created = 0
    device_now = [0.0]

    def __init__(self):
        type(self).created += 1
        self.at = None
        self.reads = 0

    def record(self, stream=None):
        self.at = self._enqueue[0]

    def query(self):
        return self.at is not None and self.at <= self.device_now[0]

    def elapsed_time(self, end):
        assert self.query() and end.query()
        self.reads += 1
        return end.at - self.at


def test_device_timers_read_late_without_a_sync(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    enqueue = [0.0]
    monkeypatch.setattr(_FakeEvent, "_enqueue", enqueue, raising=False)
    _FakeEvent.created = 0
    _FakeEvent.device_now[0] = 0.0
    reg = om.Registry()
    dt = phase.DeviceTimers("modea", "fake", ("upload", "tick", "copy"),
                            event=_FakeEvent, stream=None, reg=reg)
    h = {dict(x.labels)["part"]: x for x in reg.find("tick_device_seconds")}
    seen = []
    for n in range(40):
        for part, ms in (("upload", 2.0), ("tick", 5.0), ("copy", 3.0)):
            t = dt.start()
            enqueue[0] += ms
            dt.stop(part, t)
            seen.append(t)
        # the device runs a tick behind the host
        _FakeEvent.device_now[0] = enqueue[0] - 10.0
        dt.poll()
    _FakeEvent.device_now[0] = enqueue[0]
    dt.poll()
    dt.poll()
    assert {p: x.count for p, x in h.items()} == {
        "upload": 40, "tick": 40, "copy": 40}
    assert h["tick"].total == pytest.approx(40 * 5e-3)
    assert h["copy"].total == pytest.approx(40 * 3e-3)
    assert _FakeEvent.created <= 14  # events come back to the pool
    assert not dt._pending


def test_device_timers_stop_recording_when_never_read(monkeypatch):
    enqueue = [0.0]
    monkeypatch.setattr(_FakeEvent, "_enqueue", enqueue, raising=False)
    _FakeEvent.device_now[0] = -1.0
    dt = phase.DeviceTimers("modea", "fake", ("tick",), event=_FakeEvent,
                            stream=None, reg=om.Registry())
    for _ in range(3 * dt.PENDING_MAX):
        dt.stop("tick", dt.start())
    assert len(dt._pending) == dt.PENDING_MAX


def test_device_timers_only_on_a_card():
    assert phase.device_timers("modea", "p", ("tick",),
                               torch.device("cpu")) is phase._NULL_TIMERS
    assert phase.device_timers("modea", "p", ("tick",), None) \
        is phase._NULL_TIMERS


def test_collections_are_observed_and_spanned(spans):
    phase.PhaseClock("modea", plane="spans", reg=om.Registry())
    (h,) = [x for x in om.registry().find("gc_pause_seconds")
            if dict(x.labels)["generation"] == "2"]
    n0 = h.count
    phase.record_spans(True)
    gc.collect()
    phase.record_spans(False)
    got = [s for s in phase.take_spans() if s[0] == "gc.gen2"]
    assert len(got) == 1 and got[0][1] <= got[0][2]
    assert h.count == n0 + 1
    assert gc.callbacks.count(phase._gc_hook) == 1


@pytest.mark.parametrize("blocking", [False, True])
def test_manager_ticks_record_spans_with_the_pipelined_link(spans,
                                                            blocking):
    cfg = tcfg.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 16
    cfg.paxos.pipeline_ticks = True
    cfg.obs.blocking_phases = blocking
    m = tmgr.PaxosManager(cfg, 3, [trep.NoopApp() for _ in range(3)],
                          device="cpu", spill_ns="spans-mgr")
    m.create_paxos_instances([f"g{i}" for i in range(16)], [0, 1, 2])
    m.propose_bulk(np.arange(16), b"y")
    m.tick()
    phase.record_spans(True)
    m.tick()
    m.tick()
    phase.record_spans(False)
    got = phase.take_spans()
    n = m._pc.tick
    ticks = {s[3] for s in got if s[0] == "modea.tick"}
    assert ticks == {n - 1, n}
    for name, _, _, tick in got:
        if name in ("modea.tally", "modea.execute", "modea.egress",
                    "modea.sweep"):
            assert tick in (n - 2, n - 1)  # the outbox of the tick before
        elif name != "modea.tick" and not name.startswith("gc."):
            assert tick in (n - 1, n)
    names = {s[0] for s in got}
    assert ("modea.device_step" in names) == blocking
    assert {f"modea.{p}" for p in phase.DRIVER_PHASES["modea"]} <= names


def test_observe_array_with_counts_matches_repeated_observe():
    rng = np.random.default_rng(9)
    v = np.r_[rng.exponential(0.05, 300), 0.0, -2.0, 3e13]
    n = rng.integers(0, 6, len(v))
    a, b = om.Histogram("a"), om.Histogram("b")
    for x, k in zip(v, n):
        for _ in range(k):
            a.observe(float(x))
    b.observe_array(v, n)
    assert a.buckets == b.buckets and a.count == b.count
    assert b.total == pytest.approx(a.total, rel=1e-12)


def test_admission_stamps_the_block_across_the_ring_end():
    from gigapaxos_tpu_torch.paxos.bulkstore import BulkStore

    b = BulkStore(1 << 10)
    b.lo = 1000
    t0 = time.perf_counter()
    b.admit(1000, np.zeros(100, np.int32), np.zeros(100, np.int32), None,
            b"x")
    t = b.t_stage
    assert (t[1000:] >= t0).all() and (t[:76] >= t0).all()
    assert (t[76:1000] == 0).all()
