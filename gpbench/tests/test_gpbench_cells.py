"""Whole runs of each cell at a tiny size on the CPU: the result line, the
comparison with the reference, the planted faults it must catch, the
modules a run loads, and a cell added without editing a file."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gpbench.tests.gpbench_helpers import ROOT, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _e2e(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_with_the_contract_keys(cell):
    rc, res, err = run_cell(cell, seconds=2.5, groups=512, seed=2**35 + 7)
    assert rc == 0, err[-3000:]
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True, err[-3000:]
    assert set(res["metrics"]) == _e2e(cell)
    assert all(v["value"] > 0 for v in res["metrics"].values())
    for k, v in res["checks"].items():
        assert f"check {k} {v['value']} limit {v['limit']}" in err


@pytest.mark.parametrize("cell", ["counter-1m-r3.open",
                                  "kvwal-1m-r3.closed"])
def test_traced_run_reads_the_host_layers(cell):
    rc, res, err = run_cell(cell, seconds=1.5, groups=256, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    names = set(res["metrics"])
    loop = cell.rsplit(".", 1)[1]
    assert {f"tick_ms.{loop}", f"execute_ms.{loop}"} <= names
    assert (f"wal_fsync_ms.{loop}" in names) == cell.startswith("kvwal")
    # device readings come only from a card's trace
    assert not any(n.startswith(("device_", "gather_")) for n in names)


FAULTS = [("counter-1m-r3.closed", f) for f in
          ("state_unchanged", "half_batch", "answer_altered",
           "replica_skips")] + \
         [("kvwal-1m-r3.closed", f) for f in
          ("state_unchanged", "half_batch", "answer_altered",
           "wal_dropped", "wal_ack_early")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    rc, res, err = run_cell(cell, "--fault", fault, seconds=1.0,
                            groups=256)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("cell", ["kvwal-1m-r3.closed"])
def test_acks_before_their_fsync_are_caught_where_the_final_journal_is_whole(
        cell):
    """Responses released before the fsync that covers them, with the
    fsync made later: the final journal holds every record under a
    barrier, and only the journal's position at each acknowledgement
    shows the fault."""
    rc, res, err = run_cell(cell, "--fault", "wal_ack_early", seconds=1.5,
                            groups=256)
    assert rc == 0, err[-3000:]
    ch = res["checks"]
    assert res["correct"] is False
    assert ch["wal_unplaced"]["value"] == 0
    assert ch["wal_acked_early"]["value"] > 0


def test_a_run_loads_no_jax_module():
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['run.py', '--workload', 'kvwal-1m-r3.closed', "
        "'--seed', '3', '--seconds', '0.5', '--trace', '0', '--device', "
        "'cpu', '--groups', '128']\n"
        "try:\n"
        "    runpy.run_path(sys.argv[0] if False else "
        f"{str(ROOT / 'gpbench' / 'run.py')!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] "
        "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "gigapaxos_tpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "gigapaxos_tpu"}


def _bench_copy(tmp_path):
    """BENCHMARK.json and gpbench/ alone in a fresh directory."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return tmp_path


def test_fails_without_the_program(tmp_path):
    root = _bench_copy(tmp_path)
    p = subprocess.run([sys.executable, "gpbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--device", "cpu", "--groups",
                        "64"], capture_output=True, text=True,
                       cwd=root, timeout=300)
    assert p.returncode != 0
    assert "gigapaxos_tpu_torch" in p.stderr
    assert not p.stdout.strip()


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, res, err = run_cell(CELLS[0], device="cuda")
    assert rc != 0 and res is None and "no CUDA card" in err


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A new traffic mix, cell and per-layer metric, added as new files and
    new entries of BENCHMARK.json, with no existing file edited."""
    root = _bench_copy(tmp_path)
    os.symlink(ROOT / "gigapaxos_tpu_torch", root / "gigapaxos_tpu_torch")
    g = root / "gpbench"
    (g / "traffic" / "closed-4k.json").write_text(json.dumps(
        {"loop": "closed", "clients": 4096, "groups": {"dist": "uniform"},
         "ops": {"inc": 1.0}, "delta": [1, 9]}))
    shutil.copy(g / "workloads" / "counter-1m-r3.closed.json",
                g / "workloads" / "counter-1m-r3.closed4k.json")
    (g / "metrics" / "acked_total.py").write_text(
        "def read(ctx):\n    return ctx.ledger.n_acked\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "counter-1m-r3.closed4k", "config": "counter-1m-r3",
         "traffic": "closed-4k", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("counter-1m-r3.closed4k")
    bench["per_layer"].append(
        {"name": "acked_total", "unit": "req", "better": "higher",
         "source": "host_clock", "layer": "harness and client",
         "moves": "commits_per_s", "workloads": ["counter-1m-r3.closed4k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell("counter-1m-r3.closed4k", seconds=0.7,
                            groups=512, root=root)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and "commits_per_s" in res["metrics"]
    rc, res, err = run_cell("counter-1m-r3.closed4k", seconds=1.0,
                            groups=512, root=root, trace=1)
    assert rc == 0, err[-3000:]
    assert res["metrics"]["acked_total"]["value"] > 0


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import or collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    ("counter-1m-r3.closed", "replica_skips"),
    ("kvwal-1m-r3.closed", "wal_ack_early")])
def test_controls_fail_on_the_card(card, cell, fault):
    """The controls at a size a test run holds, on the card."""
    rc, res, err = run_cell(cell, "--fault", fault, seconds=2.0,
                            groups=1 << 14, device="cuda")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
