"""Shared helpers of the benchmark's tests."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_cell(cell, *extra, seconds=1.0, groups=512, seed=11, trace=0,
             device="cpu", root=ROOT, script=None):
    """Run ``gpbench/run.py`` in a subprocess; returns (exit code, result
    dict or None, stderr)."""
    script = script or (root / "gpbench" / "run.py")
    cmd = [sys.executable, str(script), "--workload", cell, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--device", device, "--groups", str(groups), *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                       timeout=600)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, res, p.stderr
