"""The readers of the program's spans and slice totals, on the CPU: a
traced run reads the request waits and no device timer; every reader
gives None on a program that records neither; the gap labeller names a
gap by the innermost span covering most of it."""

import pytest

from gpbench import spans as sp
from gpbench.run import metric_reader
from gpbench.tests.gpbench_helpers import run_cell

NEW = ("device_tick_ms.closed", "outbox_copy_ms.closed",
       "inbox_upload_ms.closed", "gc_ms.closed", "queue_wait_ms.open",
       "order_wait_ms.open")


def test_traced_cpu_run_reads_the_request_waits():
    rc, res, err = run_cell("counter-1m-r3.open", seconds=1.5, groups=256,
                            trace=1, seed=2**33 + 5)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    m = res["metrics"]
    assert m["queue_wait_ms.open"]["value"] >= 0
    assert m["order_wait_ms.open"]["value"] > 0
    assert not any(n.startswith(("device_tick", "outbox_copy",
                                 "inbox_upload")) for n in m)


def test_traced_cpu_run_reads_collections_and_no_device_timer():
    rc, res, err = run_cell("kvwal-1m-r3.closed", seconds=1.5, groups=256,
                            trace=1, seed=2**33 + 6)
    assert rc == 0, err[-3000:]
    m = res["metrics"]
    assert m["gc_ms.closed"]["value"] >= 0
    assert not {"device_tick_ms.closed", "outbox_copy_ms.closed",
                "inbox_upload_ms.closed"} & set(m)


class _Ctx:
    slice_ticks = 10


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_the_programs_totals(name, monkeypatch):
    from gigapaxos_tpu_torch.obs import phase

    monkeypatch.delattr(phase, "session_totals")
    assert metric_reader(name)(_Ctx()) is None


@pytest.mark.parametrize("name", NEW[:3])
def test_device_readers_give_none_with_no_timer(name, monkeypatch):
    from gigapaxos_tpu_torch.obs import phase

    monkeypatch.setattr(phase, "session_totals", lambda: {})
    assert metric_reader(name)(_Ctx()) is None


def test_readers_take_means_and_per_tick_totals(monkeypatch):
    from gigapaxos_tpu_torch.obs import phase

    tot = {("tick_device_seconds", (("driver", "modea"), ("part", "copy"),
                                    ("plane", "gpbench"))): (4, 0.12),
           ("gc_pause_seconds", (("generation", "0"),)): (30, 0.003),
           ("gc_pause_seconds", (("generation", "2"),)): (1, 0.5),
           ("request_wait_seconds", (("plane", "gpbench"),
                                     ("stage", "queue"))): (8, 0.4)}
    monkeypatch.setattr(phase, "session_totals", lambda: tot)
    assert metric_reader("outbox_copy_ms.closed")(_Ctx()) == \
        pytest.approx(30.0)
    assert metric_reader("gc_ms.closed")(_Ctx()) == pytest.approx(50.3)
    assert metric_reader("queue_wait_ms.open")(_Ctx()) == pytest.approx(50.0)
    assert metric_reader("order_wait_ms.open")(_Ctx()) is None


def test_a_gap_is_named_by_the_span_covering_most_of_it():
    # host: a tick [0, 100) holding tally [10, 40) and execute [40, 90),
    # a collection [60, 70) inside execute, a propose [100, 130)
    spans = [("manager.tick", 0, 100), ("modea.tally", 10, 40),
             ("modea.execute", 40, 90), ("gc.gen2", 60, 70),
             ("gen.propose", 100, 130)]
    dev = [(0, 12), (15, 38), (45, 50), (125, 140)]
    gaps = sp.device_gaps(dev)
    assert gaps == [(12, 15), (38, 45), (50, 125)]
    assert sp.label_gap(12, 15, spans) == "modea.tally"
    # 2 of tally, 5 of execute
    assert sp.label_gap(38, 45, spans) == "modea.execute"
    # execute 30 (gc's 10 counted apart), propose 25, tick 10, gc 10
    assert sp.gap_shares(50, 125, spans) == {
        "modea.execute": 30, "gc.gen2": 10, "manager.tick": 10,
        "gen.propose": 25}
    assert sp.label_gap(50, 125, spans) == "modea.execute"
    assert sp.label_gap(140, 150, spans) == "host"
    rep = sp.idle_report(dev, spans, n_top=2)
    assert rep["idle_gaps"] == [["modea.execute", 75e-9],
                                ["modea.execute", 7e-9]]
    assert rep["idle_s_by_span"]["modea.tally"] == pytest.approx(5e-9)
    assert rep["n_gaps"] == 3
