"""The ``modeb-wal-128k`` leg of chip_smoke.py rehearsed on the CPU at a
small size, every check included: the replayed state equal to N2's
pre-crash copy field by field, every acked write read back on all three
nodes after both recoveries, the peer stream with no failed fetch, the
chaos run's safety ledger and equal DBs, the scribbled journal quarantined
byte for byte and every taint cleared.  The launch counts are checked
too, with the plain versions of the kernels counting as launches (a CPU
tensor never reaches a kernel)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from gigapaxos_tpu_torch.ops import plane_gather as pg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_plain_calls(monkeypatch):
    """Make each call of a plain version count as one launch."""
    for name, fn in (("gather_planes", "gather_planes_many_plain"),
                     ("match_planes", "match_planes_many_plain")):
        inner = getattr(pg, fn)

        def counted(*a, _inner=inner, _name=name):
            pg.launches[_name] += 1
            return _inner(*a)

        monkeypatch.setattr(pg, fn, counted)


def _check(out, hot, gap):
    assert out["acked"] == hot + gap + 1  # the probe group's PUT
    rec, chaos = out["recovery"], out["chaos"]
    deg = chaos["degraded"]
    assert rec["ticks_replayed"] > 0 and deg["ticks_replayed"] > 0
    assert rec["stream"]["failed"] == 0
    assert rec["stream"]["fetched"] == out["G"]
    assert rec["stream"]["applied"] >= gap
    assert deg["groups_tainted"] == chaos["groups"]
    assert deg["ckpt_transfers"] >= chaos["groups"]
    assert out["journal"]["op_frame_bytes_per_node_tick"] > 0
    assert out["journal"]["op_tick_bytes_per_node_tick"] > 0
    assert chaos["proposals_ok"] >= 7 and chaos["replayed_ticks"] > 0


def test_modeb_wal_leg_on_cpu(tmp_path, monkeypatch):
    _count_plain_calls(monkeypatch)
    out = chip_smoke.modeb_wal_leg(torch, pg, torch.device("cpu"),
                                   str(tmp_path), G=1024, hot=64, gap=16,
                                   chaos_groups=256, count=True)
    _check(out, 64, 16)
    live, replayed = out["live_node_ticks"], out["replayed_node_ticks"]
    assert live > 0 and replayed > 0
    assert out["launches"] == {"gather_planes": 5 * live,
                               "match_planes": live}
    assert out["replay_launches"] == {"gather_planes": 5 * replayed,
                                      "match_planes": replayed}


@pytest.mark.cuda
def test_modeb_wal_leg_on_the_card(tmp_path):
    """The same leg on the card, where every tick launches the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the leg's launch counts come from "
                    "the hand-written kernels, which have no CPU mode")
    out = chip_smoke.modeb_wal_leg(torch, pg, torch.device("cuda"),
                                   str(tmp_path), G=4096, hot=256, gap=64,
                                   chaos_groups=512)
    _check(out, 256, 64)
    assert out["launches"]["match_planes"] == out["live_node_ticks"]
