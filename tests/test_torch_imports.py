"""The PyTorch port stands alone: importing it loads no JAX and nothing of
the JAX package, and its sources import neither."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

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
              "utils.observability"):
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
