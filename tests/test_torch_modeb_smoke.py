"""The ``modeb`` phase of chip_smoke.py rehearsed on the CPU at a small
size, every check included: ``modeb-1M``'s waves over loopback sockets
(N0's first ticks held against a second CPU run, exactly-once execution at
every node, the mass laggard's convergence with no residual lag),
``modeb-fast``'s two failover legs (the fast one quicker, both counts equal
to a smaller run's) and ``modeb-device-128k`` (equal KV tables, acked
writes read back, the miss path taken)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from gigapaxos_tpu_torch.ops import plane_gather as pg  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_modeb_1m_leg_on_cpu():
    out = chip_smoke.modeb_1m_leg(torch, pg, CPU, G=2048, warm=16, hot=256,
                                  laggard=512, cpu_ticks=2)
    assert out["acked"] == 16 + 16 + 256 + 512
    assert out["laggard"]["residual_lag_slots"] == 0
    assert out["cpu_ticks_equal"] == 2 and out["launches"] is None
    assert out["packed_outbox_bytes"] == (56 + 1) * 4 * 2048
    assert set(out["host_ms_per_node_tick_by_phase"]) == {"N0", "N1", "N2"}


def test_modeb_fast_leg_on_cpu():
    out = chip_smoke.modeb_fast_leg(torch, pg, CPU, G=512, busy=64,
                                    cpu_G=128, cpu_busy=16)
    assert out["fast"]["ticks_to_coordinator"] == 1
    assert (out["fast"]["ticks_to_first_commit"]
            < out["full"]["ticks_to_first_commit"])


def test_modeb_device_leg_on_cpu():
    out = chip_smoke.modeb_device_leg(torch, pg, CPU, G=1024, busy=64,
                                      ticks=8)
    assert out["acked"] == 64 * 8
    assert out["miss_path_scalar_execs_N0"] >= 1
    assert out["gets_read_back"] == 16
