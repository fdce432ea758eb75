"""The ``planes`` phase of chip_smoke.py rehearsed on the CPU at a small
size, every check included: ``mixed-1M``'s two arms (lease and health folds
on and off, the first ticks held against a second CPU run) and
``reads-128k`` (local reads, crash, both replay arms against each other and
the drained live manager, acked writes read back, the leases-off round)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from gigapaxos_tpu_torch.ops import plane_gather as pg  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("folds", [True, False])
def test_mixed_leg_on_cpu(folds):
    out = chip_smoke.mixed_leg(torch, pg, CPU, folds, GL=64, GR=448,
                               warm=2, timed=4, profiled=2, cpu_ticks=2)
    assert out["taken"] == out["offered"] == 8 * 512
    assert out["dec_per_s"] > 0 and out["launches"] is None
    assert out["device_idle_share"] is None  # no device on the CPU
    if folds:
        assert out["lease_holders"] == 512


def test_reads_leg_on_cpu(tmp_path):
    out = chip_smoke.reads_leg(torch, pg, CPU, str(tmp_path), G=4096,
                               hot_log=16, hot_reg=16, ops=400, rounds=2,
                               probe=256)
    assert out["acked_writes"] == 2 * 400 // 20
    assert out["leases"][-1]["local_read_fraction"] > 0.5
    assert out["uniform_probe_local_fraction"] == 1.0
    assert out["leases_off"]["local_reads"] == 0
    assert out["replay"]["overflows"] == 0
