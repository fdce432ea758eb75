"""The crash cell on the CPU: whole runs at a tiny size, its controls, the
cut of the journal at the power loss, the client side across the crash,
and the existing cells' checks, which the crash must leave as they were.

The cell waits in ``gpbench/waiting/`` for a repair of the program (the
requests of the tick whose record was fsynced as the power went are
executed by the recovery and answered by no one), so its runs go through
``gpbench/run_waiting.py``."""

import json
import re
import struct
import zlib

import numpy as np
import pytest

from gpbench import crash, traffic as tr
from gpbench.reference import crash as ref
from gpbench.reference.journal import MAGIC2, read_journal
from gpbench.run_waiting import with_waiting
from gpbench.tests.gpbench_helpers import ROOT, run_cell

CELL = "kvwal-128k-r3.crash"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = {"recover_restore_ms.crash", "recover_replay_ms.crash",
             "replay_ms_per_tick.crash", "recover_first_ack_ms.crash"}


def _limits(cell):
    return json.loads((ROOT / "gpbench" / "workloads" / f"{cell}.json")
                      .read_text())["limits"]


WAITING = ROOT / "gpbench" / "run_waiting.py"


def run_waiting(*extra, **kw):
    return run_cell(CELL, *extra, script=WAITING, **kw)


def _crash_line(err):
    line = re.search(r"gpbench: crash (.*)", err).group(1)
    return dict(kv.split("=", 1) for kv in line.split())


def test_the_crash_shows_the_fault_of_the_last_fsynced_tick():
    """The power goes with the last tick's record fsynced and its outbox
    pending.  The recovery replays that record, executes its requests
    and keeps no response for them; their clients, answered by no one,
    send them again, and each executes twice.  (A GET sent again may
    also read a PUT of that tick, which the history lacks: ``resp_wrong``
    follows the same fault.)  A program that answers them turns this run
    correct."""
    rc, res, err = run_waiting(seconds=6.0,
                            groups=1024, seed=2**33 + 5)
    assert rc == 0, err[-3000:]
    assert set(res["checks"]) == set(_limits(CELL))
    c = _crash_line(err)
    assert int(c["answered_after"]) == 0
    assert int(c["resent_durable"]) > 0
    assert res["correct"] is False
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["crash_exec_twice"] == int(c["resent_durable"])
    held = [k for k in checks if k.startswith(("acks_", "wal_", "order_"))
            or k in ("crash_acked_lost", "exec_not_once", "exec_foreign")]
    assert {k: checks[k] for k in held} == {k: 0 for k in held}, \
        err[-3000:]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "checkpoint_s=" in err
    assert set(res["metrics"]) == {"recover_s", "setup_s", "commit_p50_ms",
                                   "commit_p95_ms"}
    assert res["metrics"]["recover_s"]["value"] > 0


def test_the_crash_cell_reads_its_per_layer_metrics():
    rc, res, err = run_waiting(seconds=4.0,
                            groups=256, seed=2**33 + 6, trace=1)
    assert rc == 0, err[-3000:]
    # the device's idle share comes only from a card's trace
    assert set(res["metrics"]) == PER_LAYER
    assert res["metrics"]["recover_replay_ms.crash"]["value"] > 0


CONTROLS = [("crash_drop_synced", "crash_acked_lost"),
            ("crash_repropose_durable", "crash_exec_twice")]


@pytest.mark.parametrize("fault,check", CONTROLS + [
    ("state_unchanged", "store_cells_wrong"),
    ("half_batch", "store_cells_wrong"),
    ("answer_altered", "resp_wrong")])
def test_crash_faults_fail_on_their_check(fault, check):
    rc, res, err = run_waiting("--fault", fault,
                            seconds=3.0, groups=256, seed=2**34 + 3)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert res["checks"][check]["value"] > 0


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import or collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fault,check", CONTROLS)
def test_crash_controls_fail_on_the_card(card, fault, check):
    """The controls at a size a test run holds, on the card."""
    rc, res, err = run_waiting("--fault", fault,
                            seconds=8.0, groups=1 << 14, device="cuda")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert res["checks"][check]["value"] > 0


def test_the_crash_cell_waits_outside_the_benchmark():
    assert CELL not in {w["name"] for w in BENCH["workloads"]}
    rc, res, err = run_cell(CELL, seconds=1.0, groups=256)
    assert rc != 0 and res is None
    assert "no workload" in err
    merged = with_waiting(BENCH, CELL)
    assert BENCH == json.loads((ROOT / "BENCHMARK.json").read_text())
    assert CELL in {w["name"] for w in merged["workloads"]}
    p95 = {m["name"]: m for m in merged["end_to_end"]}["commit_p95_ms"]
    assert {CELL, "counter-1m-r3.open"} <= set(p95["workloads"])


def test_a_cell_that_does_not_wait_is_refused_by_the_waiting_runner():
    rc, res, err = run_cell(BENCH["workloads"][0]["name"], script=WAITING,
                            seconds=1.0, groups=256)
    assert rc != 0 and res is None
    assert "waits" in err


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_existing_cells_check_as_before(cell):
    """Every check of an existing cell, by name, reads 0, and its run
    takes no crash step."""
    rc, res, err = run_cell(cell, seconds=1.5, groups=256, seed=2**32 + 9)
    assert rc == 0, err[-3000:]
    assert {k: v["value"] for k, v in res["checks"].items()} == \
        {k: 0 for k in _limits(cell)}
    assert "gpbench: crash" not in err and "checkpoint_s" not in err


def _frame(kind: int, payload: bytes) -> bytes:
    body = struct.pack("<BQ", kind, 0) + payload
    return struct.pack("<II", len(body), zlib.crc32(body)) + body


def _tick(tick: int) -> bytes:
    """A tick record: (3, tick, None, None, None, None)."""
    payload = (b"\x74" + struct.pack("<I", 6) + b"\x69"
               + struct.pack("<q", 3) + b"\x69" + struct.pack("<q", tick)
               + b"\x4e" * 4)
    return _frame(0, payload)


def test_the_cut_keeps_the_frames_up_to_the_last_barrier(tmp_path):
    barrier = _frame(1, b"")
    synced = [_tick(0), barrier, _tick(1), _tick(2), barrier]
    after = [_tick(3), _tick(4)]
    head = MAGIC2 + b"".join(synced)
    path = tmp_path / "journal.00000007.log"
    # a torn frame at the end, as a write cut off by the power
    path.write_bytes(head + b"".join(after) + _tick(5)[:11])
    c = crash.cut_at_last_barrier(str(tmp_path))
    assert path.read_bytes() == head
    assert c["cut_pos"] == (7 << 40) | len(head)
    assert c["cut_bytes"] == sum(map(len, after)) + 11
    assert c["tick_records"] == 3 and c["last_tick"] == 2
    j = read_journal(str(path))
    assert j["covered"] == 3 and len(j["ticks"]) == 3

    # the control's cut: the barrier before a position
    c = crash.cut_at_last_barrier(str(tmp_path),
                                  (7 << 40) | len(MAGIC2 + synced[0]) + 20)
    assert path.read_bytes() == MAGIC2 + synced[0] + barrier
    assert c["tick_records"] == 1 and c["last_tick"] == 0


def test_the_ledger_files_the_recovered_ids_apart():
    led = crash.CrashLedger(cap=64)
    reqs = tr.Requests(*(np.arange(4, dtype=np.int64) for _ in range(5)))
    led.admit(np.array([1, 2, 3, 4]), reqs, np.zeros(4), 0.0)
    led.ack_rids(np.array([1, 2]), 1.0, np.array([5, 6]))
    led.n0 = led.top  # the crash: ids 3 and 4 were lost
    # the recovered deployment hands out 3 and 4 again
    led.admit(np.array([3, 4, -2]),
              tr.Requests(*(np.arange(3, dtype=np.int64)
                            for _ in range(5))), np.zeros(3), 2.0)
    assert (led.n1, led.shift) == (3, 2)
    assert list(led.admitted()) == [1, 2, 3, 4, 5, 6]
    led.ack_rids(np.array([3]), 3.0, np.array([7]))
    assert led.n_ack[5] == 1 and led.n_ack[3] == 0
    assert led.first_ack == 3.0
    assert list(led.file_ids(np.array([0, 2, 3, 4]))) == [0, 2, 5, 6]


def test_a_request_sent_again_whose_placement_survived_runs_twice():
    """The history shows each execution once; the request sent again
    whose first sending the cut journal placed counts as executed twice,
    as does one the history shows under both ids."""
    led = crash.CrashLedger(cap=64)
    reqs = tr.Requests(*(np.arange(3, dtype=np.int64) for _ in range(5)))
    led.admit(np.array([1, 2, 3]), reqs, np.zeros(3), 0.0)
    led.ack_rids(np.array([1]), 1.0, np.array([5]))
    led.n0 = led.top
    # 2 and 3 sent again as 4 and 5; the cut journal placed 2
    stream = np.array([[1, 4, 5, 3], [0, 0, 0, 0], [0, 1, 2, 2],
                       [0, 0, 0, 1]])
    placed = np.zeros(4, bool)
    placed[[1, 2]] = True
    out = ref.crash_checks(led, stream, 1, 2.0, np.array([2, 3]),
                           np.array([4, 5]), placed)
    assert out == {"crash_acked_lost": 0, "crash_exec_twice": 2}
    placed[2] = False
    out = ref.crash_checks(led, stream[:, :3], 1, 2.0, np.array([2, 3]),
                           np.array([4, 5]), placed)
    assert out == {"crash_acked_lost": 0, "crash_exec_twice": 0}
