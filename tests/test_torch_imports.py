"""The PyTorch port stands alone: importing it loads no JAX and nothing of
the JAX package, and its sources import neither."""

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import gigapaxos_tpu_torch

PKG = Path(gigapaxos_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="gigapaxos_tpu_torch."))


def test_import_loads_no_jax_and_no_reference_module():
    mods = ["gigapaxos_tpu_torch"] + _submodules()
    for m in ("paxos.manager", "net.transport", "protocoltask.executor",
              "reconfiguration.active_replica", "node", "client",
              "obs.flight", "models.device_kv", "chain", "chain.tick",
              "chain.manager", "wal.chain_logger", "modeb", "modeb.kernel",
              "modeb.manager", "modeb.wire", "modeb.common",
              "testing.simnet", "chain.modeb", "chain.modeb_logger",
              "server", "config", "obs.prom", "obs.http", "obs.timeline",
              "utils.observability", "cells", "cells.routing",
              "cells.worker", "cells.supervisor", "cells.migrator",
              "placement", "placement.table", "txn", "txn.transactor",
              "reconfiguration.dns_edge", "reconfiguration.http_edge",
              "testing", "testing.capacity", "testing.openloop",
              "testing.certs", "placement.counters",
              "placement.rebalancer", "placement.migrator", "parallel",
              "parallel.mesh", "parallel.shard_tick",
              "testing.modeb_worker", "testing.server_worker"):
        assert f"gigapaxos_tpu_torch.{m}" in mods
    assert _loaded_reference_modules(mods) == ""


def _loaded_reference_modules(mods) -> str:
    """Import ``mods`` in a fresh interpreter; the jax and reference
    modules it then holds, comma-separated."""
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'gigapaxos_tpu' or m.startswith('gigapaxos_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_modeb_and_simnet_alone_load_no_jax():
    """The Mode B package and the simulated wire, imported on their own."""
    assert _loaded_reference_modules(
        ["gigapaxos_tpu_torch.modeb",
         "gigapaxos_tpu_torch.testing.simnet"]) == ""


def test_server_chain_modeb_and_obs_alone_load_no_jax():
    """The per-process server, chain over Mode B and the scrape plane,
    imported on their own."""
    assert _loaded_reference_modules(
        ["gigapaxos_tpu_torch.server", "gigapaxos_tpu_torch.chain.modeb",
         "gigapaxos_tpu_torch.chain.modeb_logger",
         "gigapaxos_tpu_torch.obs.prom", "gigapaxos_tpu_torch.obs.http",
         "gigapaxos_tpu_torch.obs.timeline",
         "gigapaxos_tpu_torch.utils.observability"]) == ""


def test_cells_txn_edges_and_harnesses_alone_load_no_jax():
    """The host plane, the transactor, the edges and the capacity and
    open-loop harnesses, imported on their own."""
    assert _loaded_reference_modules(
        ["gigapaxos_tpu_torch.cells", "gigapaxos_tpu_torch.cells.worker",
         "gigapaxos_tpu_torch.placement", "gigapaxos_tpu_torch.txn",
         "gigapaxos_tpu_torch.reconfiguration.dns_edge",
         "gigapaxos_tpu_torch.reconfiguration.http_edge",
         "gigapaxos_tpu_torch.testing.capacity",
         "gigapaxos_tpu_torch.testing.openloop"]) == ""


def test_placement_mesh_and_workers_alone_load_no_jax():
    """The placement plane, the mesh and the process-level workers,
    imported on their own."""
    assert _loaded_reference_modules(
        ["gigapaxos_tpu_torch.placement.counters",
         "gigapaxos_tpu_torch.placement.rebalancer",
         "gigapaxos_tpu_torch.placement.migrator",
         "gigapaxos_tpu_torch.parallel.mesh",
         "gigapaxos_tpu_torch.parallel.shard_tick",
         "gigapaxos_tpu_torch.testing.modeb_worker",
         "gigapaxos_tpu_torch.testing.server_worker"]) == ""


def test_refusal_sites_are_gone():
    """The four places earlier slices refused the mesh and placement: the
    manager's option check, the tick's sharded group axis, the node's
    rebalancer and the shard-load source.  Each now builds or runs."""
    import torch

    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import manager as pm
    from gigapaxos_tpu_torch.paxos import state as pst
    from gigapaxos_tpu_torch.utils.observability import shard_load_source

    assert not hasattr(pm, "_unported")
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = 64
    cfg.paxos.mesh_devices = 8
    cfg.placement.enabled = True
    m = pm.PaxosManager(cfg, 3, [KVApp() for _ in range(3)], device="cpu")
    assert m.shard_geometry() == (8, 8)
    m.create_paxos_instance("g", [0, 1, 2])
    m.propose("g", b"PUT a 1", lambda *a: None)
    m.run_ticks(4)
    snap = shard_load_source(m)()
    assert snap["enabled"] and len(snap["shard_loads"]) == 8
    # the tick's second half takes a group shard's rank base
    R, G, W = 3, 8, 4
    s = pst.create_groups(pst.init_state(R, G, W, device="cpu"),
                          np.arange(G), np.ones((G, R), bool))
    ib = pt.make_inbox(R, G, 2, device="cpu")
    pt.paxos_tick_impl(s, ib, -1, 16, torch.zeros((W, R), dtype=torch.int32))
    node_src = (PKG / "node.py").read_text()
    assert "not ported yet" not in node_src
    assert "def start_rebalancer" in node_src
    tick_src = (PKG / "ops" / "tick.py").read_text()
    assert "NotImplementedError" not in tick_src


def test_cell_worker_process_loads_no_jax(tmp_path):
    """A cell worker, spawned as the supervisor spawns it (its module run
    as ``__main__`` with a spec), boots its cluster on the CPU, answers
    ``stats``, exits on ``exit`` — and has loaded no jax and nothing of
    the JAX package."""
    spec = json.dumps({
        "cell": 0, "n_cells": 1,
        "actives": {"c0.AR0": ["127.0.0.1", 0]},
        "reconfigurators": {"c0.RC0": ["127.0.0.1", 0]},
        "wal_dir": str(tmp_path / "ar"), "rc_wal_dir": str(tmp_path / "rc"),
        "paxos": {"max_groups": 16}, "device": "cpu"})
    code = (
        "import runpy, sys\n"
        "sys.argv = ['worker', sys.argv[1]]\n"
        "try:\n"
        "    runpy.run_module('gigapaxos_tpu_torch.cells.worker',\n"
        "                     run_name='__main__')\n"
        "finally:\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m == 'jax' or m.startswith('jax.')\n"
        "                 or m == 'gigapaxos_tpu'\n"
        "                 or m.startswith('gigapaxos_tpu.'))\n"
        "    print('loaded ' + ','.join(bad), flush=True)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code, spec], cwd=ROOT,
                         env=env, input="stats\nexit\n",
                         capture_output=True, text=True, timeout=300)
    lines = out.stdout.splitlines()
    assert out.returncode == 0, out.stderr[-2000:]
    assert lines[0] == "ready"
    assert json.loads(lines[1][len("stats "):])["launches"] == {
        "gather_planes": 0, "match_planes": 0}
    assert lines[-1] == "loaded "


IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+gigapaxos_tpu\b(?!_torch)"
    r"|from\s+gigapaxos_tpu\b(?!_torch))", re.M)


def test_sources_import_no_jax_and_no_reference_module():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if IMPORT_RE.search(f.read_text())]
    assert offenders == []
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert IMPORT_RE.search("from gigapaxos_tpu.ops import tick")
    assert not IMPORT_RE.search("from gigapaxos_tpu_torch.ops import tick")
