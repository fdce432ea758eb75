"""Mode B node twin, second part: digest-only accepts with the undigest
fetch and the dissemination ring, pause/spill, and the device KV app —
the SimNet-able cases of the reference's ``test_modeb_digest.py``,
``test_modeb_pause.py`` and ``test_modeb_device.py`` (their crash cases
need the Mode B journal, which comes with the durability slice).

Tolerance: 0, with the lockstep checks of ``test_torch_modeb.Twin``
(states, wire bytes, responses, apps and stats after every step).
"""

import struct

import numpy as np
import pytest
import torch

from gigapaxos_tpu_torch.models.device_kv import (OP_DEL, OP_GET, OP_PUT,
                                                  pack_desc)
from test_torch_modeb import IDS, Twin, make_cfgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- digest
def test_digest_commit_correctness_all_entries():
    tw = Twin(make_cfgs(digest_accepts=True))
    tw.create("svc")
    for i, nid in enumerate(IDS * 2):
        assert tw.commit(nid, "svc", f"PUT k{i} v{i}".encode()) == b"OK"
    tw.spin(20)
    dbs = [tw.tapps[nid].db.get("svc", {}) for nid in IDS]
    assert dbs[0] == dbs[1] == dbs[2]
    assert len(dbs[0]) == 6


def test_digest_cuts_coordinator_frame_bytes():
    payload = b"PUT big " + b"x" * 4096
    sent = {}
    for digest in (False, True):
        tw = Twin(make_cfgs(digest_accepts=digest))
        tw.create("svc")
        tw.spin(5)
        for side in (tw.j, tw.t):
            for n in side.values():
                n.stats["frame_bytes_sent"] = 0
        for _ in range(12):
            assert tw.commit("N1", "svc", payload) == b"OK"
        tw.spin(5)
        sent[digest] = tw.t["N0"].stats["frame_bytes_sent"]
        assert tw.tapps["N0"].db["svc"]["big"] == "x" * 4096
    assert sent[True] < sent[False] - 10 * len(payload), sent


def test_undigest_fetch_recovers_suppressed_broadcast():
    tw = Twin(make_cfgs(digest_accepts=True))
    tw.create("svc")
    tw.spin(5)
    for side in (tw.j, tw.t):
        entry = side["N1"]
        orig = entry._build_frames

        def sabotaged(entry=entry, orig=orig):
            entry._extra_pay.clear()
            return orig()

        entry._build_frames = sabotaged
    tag, rid = tw.propose("N1", "svc", b"PUT k lost")
    assert rid is not None
    for _ in range(200):
        tw.spin(1)
        if tw.got(tag) and all(
                tw.tapps[n].db.get("svc", {}).get("k") == "lost"
                for n in IDS):
            break
    assert tw.got(tag) == [b"OK"]
    for nid in IDS:
        assert tw.tapps[nid].db["svc"]["k"] == "lost", nid
        assert not tw.t[nid]._tainted_rows and not tw.t[nid]._stalled
    assert sum(tw.t[n].stats["undigest_fills"] for n in IDS) >= 1


def test_digest_default_at_scale_with_ring_relay():
    """Five replicas turn digest ordering on by default and payloads ride
    the relay ring; the relay slabs' bytes are held equal with their
    wall-clock stamp masked."""
    ids = [f"N{i}" for i in range(5)]
    jcfg, tcfg = make_cfgs(window=4)
    assert not tcfg.paxos.digest_accepts
    assert tcfg.paxos.digest_min_replicas == 5
    tw = Twin((jcfg, tcfg), ids=ids, seed=3)
    for nd in tw.t.values():
        assert nd._digest_accepts and nd._ring_dissemination
    tw.create("svc", members=range(5))
    tail = "y" * 600
    tags = []
    for i in range(8):
        tags.append(tw.propose("N2", "svc",
                               f"PUT k{i} v{i}-{tail}".encode())[0])
        tw.spin(4)
    tw.spin(30)
    assert all(tw.got(t) == [b"OK"] for t in tags)
    dbs = [tw.tapps[n].db.get("svc", {}) for n in ids]
    assert all(d == dbs[0] for d in dbs) and len(dbs[0]) == 8
    assert sum(nd.stats["relay_payloads"] for nd in tw.t.values()) > 0


# -------------------------------------------------------------- pause
def test_create_past_max_groups_spills():
    tw = Twin(make_cfgs(groups=4, deactivation_ticks=4))
    for i in range(4):
        tw.create(f"g{i}")
        assert tw.commit("N0", f"g{i}", f"PUT k v{i}".encode()) == b"OK"
    tw.create("g4")
    n0 = tw.t["N0"]
    assert n0.rows.row("g4") is not None
    assert tw.both("N0", "paused_count") >= 1
    assert tw.commit("N0", "g4", b"PUT k v4") == b"OK"
    spilled = [f"g{i}" for i in range(4) if n0.rows.row(f"g{i}") is None][0]
    assert tw.commit("N0", spilled, b"GET k") != b"NF"


def test_idle_groups_pause_and_unpause_via_peer_traffic():
    # SimNet delivers every anti-entropy frame on the next pump, and a
    # mirrored frame refreshes the row's activity: a refresh period (64)
    # past the idle bar (16) lets the cold group go idle at tick 256
    tw = Twin(make_cfgs(groups=8, deactivation_ticks=16),
              anti_entropy_every=64)
    tw.create("cold")
    tw.create("hot")
    assert tw.commit("N1", "cold", b"PUT x 1") == b"OK"
    for i in range(12):
        assert tw.commit("N0", "hot", f"PUT y {i}".encode()) == b"OK"
        tw.spin(24)
    assert any(n.paused_count() for n in tw.t.values())
    assert tw.commit("N2", "cold", b"GET x") == b"1"
    assert tw.commit("N0", "cold", b"GET x") == b"1"


def test_spill_scale_packs_many_groups_per_row():
    tw = Twin(make_cfgs(groups=8, deactivation_ticks=2), ids=["N0"],
              net=False)
    tags = []
    for i in range(64):
        tw.both("N0", "create_group", f"s{i}", [0])
        tags.append(tw.propose("N0", f"s{i}", f"PUT k v{i}".encode())[0])
        tw.spin(6)
    assert all(tw.got(t) == [b"OK"] for t in tags)
    assert tw.both("N0", "paused_count") >= 64 - 8
    for i in (0, 13, 37, 63):
        tag, _ = tw.propose("N0", f"s{i}", b"GET k")
        tw.spin(8)
        assert tw.got(tag) == [f"v{i}".encode()], i


# --------------------------------------------------------- device app
def _kv_row(node, name):
    row = node.rows.row(name)
    return node.kv.key[0, row].numpy(), node.kv.val[0, row].numpy()


def test_device_commit_roundtrip_and_convergence():
    tw = Twin(make_cfgs(device_app=True), app="device")
    tw.create("svc")
    for i, nid in enumerate(IDS * 2):
        assert tw.commit(nid, "svc", pack_desc(OP_PUT, i + 1, 100 + i)) \
            == struct.pack("<i", 100 + i), nid
    assert tw.commit("N1", "svc", pack_desc(OP_GET, 3, 0)) == \
        struct.pack("<i", 102)
    assert tw.commit("N2", "svc", pack_desc(OP_DEL, 3, 0)) == \
        struct.pack("<i", 102)
    assert tw.commit("N0", "svc", pack_desc(OP_GET, 3, 0)) == \
        struct.pack("<i", 0)
    tw.spin(20)
    k0, v0 = _kv_row(tw.t["N0"], "svc")
    for nid in ("N1", "N2"):
        k, v = _kv_row(tw.t[nid], "svc")
        assert np.array_equal(k, k0) and np.array_equal(v, v0), nid
    assert sum(tw.t[n].stats["executions"] for n in IDS) >= 6 * 3


def test_device_miss_routes_scalar_and_state_converges():
    tw = Twin(make_cfgs(device_app=True), app="device")
    tw.create("svc")
    tw.spin(5)
    tag, rid = tw.propose("N0", "svc", pack_desc(OP_PUT, 7, 777))
    assert rid is not None
    for side in (tw.j, tw.t):  # the upload races the commit: a miss
        side["N0"]._kv_pending.clear()
    for _ in range(120):
        tw.spin(1)
        if tw.got(tag):
            break
    assert tw.got(tag) == [struct.pack("<i", 777)]
    tw.spin(10)
    for nid in IDS:
        assert 777 in _kv_row(tw.t[nid], "svc")[1], nid
