"""Device KV app twin: the port's ``models/device_kv.py`` and the manager's
device-app mode and measurement baselines against the JAX package's, on the
CPU (the port with ``device="cpu"``), driven by the same seeded inputs.

Tolerance: 0.  The KV store, the descriptor table, the responses, the miss
masks, the compact buffers, the consensus state, the manager counters and
the journal and snapshot bytes must be equal; each package recovers the
other's device-app WAL directory.
"""

import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu import config as jcfg
from gigapaxos_tpu.models import dense_apps as jdense
from gigapaxos_tpu.models import device_kv as jkv
from gigapaxos_tpu.ops import tick as jtick
from gigapaxos_tpu.paxos import manager as jmgr
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu.wal import logger as jlog
from gigapaxos_tpu_torch import config as tcfg
from gigapaxos_tpu_torch.models import dense_apps as tdense
from gigapaxos_tpu_torch.models import device_kv as tkv
from gigapaxos_tpu_torch.ops import tick as ttick
from gigapaxos_tpu_torch.paxos import manager as tmgr
from gigapaxos_tpu_torch.paxos import state as tst
from gigapaxos_tpu_torch.wal import logger as tlog

from gigapaxos_tpu_torch.models.device_kv import (OP_DEL, OP_GET, OP_PUT,
                                                  pack_desc)

PORT, REF = "port", "ref"
R, G, W, S = 3, 4, 8, 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kv_np(kv):
    """Host arrays of either package's DeviceKVState, field order kept."""
    if isinstance(kv.key, torch.Tensor):
        return tuple(tkv.kv_to_numpy(kv))
    return tuple(np.asarray(f) for f in kv)


def assert_kv_equal(a, b, what=""):
    for name, x, y in zip(tkv.DeviceKVState._fields, kv_np(a), kv_np(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y), (what, name)


def both_kv(slots=S, table=1 << 10, n_rep=R, n_groups=G):
    return (jkv.init_kv(n_rep, n_groups, slots, table),
            tkv.init_kv(n_rep, n_groups, slots, table, device=CPU))


def make_exec(planned, n_rep=R, n_groups=G):
    """planned: (r, g, [rids...]) -> (exec_req [R,W,G], exec_count) numpy."""
    req = np.zeros((n_rep, W, n_groups), np.int32)
    cnt = np.zeros((n_rep, n_groups), np.int32)
    for r, g, rids in planned:
        req[r, :len(rids), g] = rids
        cnt[r, g] = len(rids)
    return req, cnt


def apply_both(kvs, req, cnt, mix=False):
    """kv_apply in both packages; asserts equal outputs, returns them."""
    jk, tk = kvs
    jk2, jr, jm = jkv.kv_apply(jk, jnp.asarray(req), jnp.asarray(cnt), mix)
    tk2, tr, tm = tkv.kv_apply(tk, torch.from_numpy(req),
                               torch.from_numpy(cnt), mix)
    assert_kv_equal(jk2, tk2, "kv_apply")
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(jm), tm.numpy())
    return (jk2, tk2), tr.numpy(), tm.numpy()


def register_both(kvs, rids, ops, keys, vals, mix=False):
    jk, tk = kvs
    out = (jkv.register_requests(jk, rids, ops, keys, vals, mix),
           tkv.register_requests(tk, rids, ops, keys, vals, mix))
    assert_kv_equal(*out, "register_requests")
    return out


# ------------------------------------------------------- models/device_kv

def test_put_get_del_semantics():
    kvs = register_both(both_kv(), [1, 2, 3, 4],
                        [OP_PUT, OP_GET, OP_DEL, OP_GET], [5, 5, 5, 5],
                        [77, 0, 0, 0])
    req, cnt = make_exec([(r, 0, [1, 2, 3, 4]) for r in range(R)])
    kvs, resp, miss = apply_both(kvs, req, cnt)
    for r in range(R):
        # PUT echoes; GET reads the same tick's earlier PUT (plane j sees
        # plane j-1's write); DEL returns the old value; GET after DEL: 0
        assert list(resp[r, :4, 0]) == [77, 77, 77, 0]
    assert not miss.any()
    kvs = register_both(kvs, [9], [OP_GET], [5], [0])
    req2, cnt2 = make_exec([(0, 0, [9])])
    _, resp2, _ = apply_both(kvs, req2, cnt2)
    assert resp2[0, 0, 0] == 0


def test_unregistered_rid_is_miss():
    req, cnt = make_exec([(0, 1, [1234])])
    kvs, resp, miss = apply_both(both_kv(), req, cnt)
    assert miss[0, 0, 1] and resp[0, 0, 1] == 0
    assert kv_np(kvs[1])[0].sum() == 0  # app state untouched


def test_randomized_against_dict_model():
    rng = np.random.default_rng(3)
    kvs = both_kv(table=1 << 12, n_rep=1, n_groups=1)
    model, next_rid = {}, 1
    for _tick in range(20):
        n = int(rng.integers(1, W + 1))
        rids = list(range(next_rid, next_rid + n))
        next_rid += n
        ops = [int(rng.choice([OP_PUT, OP_GET, OP_DEL])) for _ in range(n)]
        # keys within one collision-free set: the direct-mapped store
        # evicts colliding keys, the dict does not
        keys = [int(rng.integers(1, S + 1)) for _ in range(n)]
        vals = [int(rng.integers(1, 1000)) for _ in range(n)]
        kvs = register_both(kvs, rids, ops, keys, vals)
        req, cnt = make_exec([(0, 0, rids)], n_rep=1, n_groups=1)
        kvs, resp, miss = apply_both(kvs, req, cnt)
        assert not miss.any()
        for j in range(n):
            k, v, op = keys[j], vals[j], ops[j]
            if op == OP_PUT:
                expect = model[k] = v
            elif op == OP_GET:
                expect = model.get(k, 0)
            else:
                expect = model.pop(k, 0)
            assert resp[0, j, 0] == expect


@pytest.mark.parametrize("mix", [False, True])
def test_kv_apply_random_twin(mix):
    """Random ops over every (replica, group) and window plane, with slot
    collisions, evicted and never-registered descriptors, short runs and
    holes: store, responses and misses equal after every tick."""
    rng = np.random.default_rng(11 + mix)
    nr, ng, table = 3, 16, 1 << 8
    kvs = both_kv(slots=4, table=table, n_rep=nr, n_groups=ng)
    next_rid = 1
    for _tick in range(12):
        n = int(rng.integers(1, 200))
        rids = np.arange(next_rid, next_rid + n, dtype=np.int32)
        next_rid += n
        keep = rng.random(n) < 0.85  # the rest are never registered
        kvs = register_both(
            kvs, np.where(keep, rids, 0), rng.integers(0, 4, n),
            rng.integers(-3, 12, n), rng.integers(-99, 99, n), mix)
        req = np.zeros((nr, W, ng), np.int32)
        pick = rng.integers(0, n, (nr, W, ng))
        req[:] = rids[pick]
        req[rng.random(req.shape) < 0.1] = 0
        cnt = rng.integers(0, W + 1, (nr, ng)).astype(np.int32)
        kvs, _, _ = apply_both(kvs, req, cnt, mix)


@pytest.mark.parametrize("mix", [False, True])
def test_register_requests_colliding_upload(mix):
    """One upload whose rids collide on table indices (the batch is larger
    than the table): the last write wins, all four columns agree, rid 0
    padding writes nothing."""
    rng = np.random.default_rng(5)
    kvs = both_kv(table=16)
    rids = rng.integers(1, 2**31 - 1, 64).astype(np.int32)
    rids[::7] = 0
    rids[3], rids[40] = 17, 33  # equal rid & (T-1) in one batch
    ops = rng.integers(0, 4, 64)
    keys = rng.integers(1, 99, 64)
    vals = rng.integers(-99, 99, 64)
    jk, tk = register_both(kvs, rids, ops, keys, vals, mix)
    # the winner of each index is the batch's last rid that maps there
    tix = tkv._table_idx(torch.from_numpy(rids), 16, mix).numpy()
    for t in range(16):
        at = np.nonzero((tix == t) & (rids != 0))[0]
        if len(at):
            i = at[-1]
            got = [int(c[t]) for c in kv_np(tk)[2:]]
            assert got == [rids[i], ops[i], keys[i], vals[i]]


def test_table_idx_mix_wraps_as_int32():
    rids = np.array([0, 1, 2, 255, 1 << 24, (7 << 24) | 5, 2**31 - 1,
                     -1, -(2**31), 123456789], np.int32)
    for table in (16, 1 << 10, 1 << 22):
        for mix in (False, True):
            want = np.asarray(jkv._table_idx(jnp.asarray(rids), table, mix))
            got = tkv._table_idx(torch.from_numpy(rids), table, mix).numpy()
            assert want.dtype == got.dtype and np.array_equal(want, got)


def _groups(mod, device=None):
    kw = {} if device is None else {"device": device}
    s = mod.init_state(R, G, W, **kw)
    return mod.create_groups(s, np.arange(G, dtype=np.int32),
                             np.ones((G, R), bool))


def test_fused_step_consensus_to_device_execution():
    """inbox -> consensus tick -> on-device execution: state, store,
    outbox, responses and misses equal every tick, every replica's app
    state converges."""
    js, ts = _groups(jst), _groups(tst, CPU)
    kvs = register_both(both_kv(table=1 << 12), [101, 102],
                        [OP_PUT, OP_PUT], [3, 4], [31, 41])
    jk, tk = kvs
    req = np.zeros((R, 4, G), np.int32)
    req[0, 0, 0] = 101
    req[0, 1, 2] = 102
    executed = 0
    for i in range(6):
        rq = req if i == 0 else np.zeros_like(req)
        stop, alive = np.zeros((R, 4, G), bool), np.ones(R, bool)
        js, jk, jo, jr, jm = jkv.fused_step_jit(
            js, jk, jtick.TickInbox(jnp.asarray(rq), jnp.asarray(stop),
                                    jnp.asarray(alive)))
        ts, tk, to, tr, tm = tkv.fused_step_jit(
            ts, tk, ttick.TickInbox(torch.from_numpy(rq),
                                    torch.from_numpy(stop),
                                    torch.from_numpy(alive)))
        assert_kv_equal(jk, tk, i)
        for name, a, b in zip(tst.PaxosState._fields, js,
                              tst.state_to_numpy(ts)):
            assert np.array_equal(np.asarray(a), b), (i, name)
        for name, a, b in zip(jo._fields, jo, to):
            assert np.array_equal(np.asarray(a), b.numpy()), (i, name)
        assert np.array_equal(np.asarray(jr), tr.numpy())
        assert not tm.any() and np.array_equal(np.asarray(jm), tm.numpy())
        executed += int(to.exec_count.sum())
    assert executed >= 2 * R
    keys, vals = kv_np(tk)[:2]
    for r in range(R):
        assert vals[r, 0, 3] == 31 and keys[r, 0, 3] == 3
        assert vals[r, 2, 4] == 41


class _Holder:  # any object with a mutable .kv (the manager, in a run)
    def __init__(self, kv):
        self.kv = kv


def test_checkpoint_restore_roundtrip():
    kvs = register_both(both_kv(), [1, 2], [OP_PUT, OP_PUT], [3, 6],
                        [30, 60])
    req, cnt = make_exec([(0, 1, [1, 2])])
    (jk, tk), _, _ = apply_both(kvs, req, cnt)
    ja = jkv.DeviceKVApp(_Holder(jk), replica=0, row_of=lambda n: 1)
    ta = tkv.DeviceKVApp(_Holder(tk), replica=0, row_of=lambda n: 1)
    blob = ta.checkpoint("svc")
    assert blob and blob == ja.checkpoint("svc")
    ja.kv = ja.kv._replace(key=ja.kv.key.at[0, 1].set(0),
                           val=ja.kv.val.at[0, 1].set(0))
    ta.kv.key[0, 1] = 0
    ta.kv.val[0, 1] = 0
    ja.restore("svc", blob)
    ta.restore("svc", blob)
    assert_kv_equal(ja.kv, ta.kv, "restore")
    assert int(ta.kv.val[0, 1, 3]) == 30 and int(ta.kv.val[0, 1, 6]) == 60
    # the scalar fallback applies descriptors with kv_apply's semantics
    for desc in (pack_desc(OP_PUT, 3, 99), pack_desc(OP_GET, 3, 0),
                 pack_desc(OP_DEL, 6, 0), pack_desc(OP_DEL, 6, 0),
                 pack_desc(OP_GET, 11, 0), b"x"):
        assert ja.execute("svc", desc, 7) == ta.execute("svc", desc, 7)
        assert_kv_equal(ja.kv, ta.kv, desc)
    assert int(ta.kv.val[0, 1, 3]) == 99


def test_compact_layout_single_source_of_truth():
    """fused_compact's buffer is CompactLayout.total_device long in both
    packages, equal byte for byte, and a commit's response surfaces
    through kv_extras at the documented offsets."""
    E, Lb = 64, 64
    L = ttick.CompactLayout(R, 8, E, Lb)
    JL = jtick.CompactLayout(R, 8, E, Lb)
    for f in ("o_taken", "o_exec", "o_lag", "base", "o_resp", "o_miss",
              "total_plain", "total_device"):
        assert getattr(L, f) == getattr(JL, f), f
    assert L.o_miss == L.o_resp + E and L.o_resp == L.o_lag + 6 * Lb
    js = jst.create_groups(jst.init_state(R, 8, W),
                           np.arange(8, dtype=np.int32), np.ones((8, R), bool))
    ts = tst.create_groups(tst.init_state(R, 8, W, device=CPU),
                           np.arange(8), np.ones((8, R), bool))
    jk = jkv.register_requests(jkv.init_kv(R, 8, 8, 1 << 16), [77],
                               [OP_PUT], [3], [1234])
    tk = tkv.register_requests(tkv.init_kv(R, 8, 8, 1 << 16, device=CPU),
                               [77], [OP_PUT], [3], [1234])
    req = np.zeros((R, 2, 8), np.int32)
    req[0, 0, 0] = 77
    zeros = np.zeros(4, np.int32)
    seen = False
    for i in range(4):  # propose -> accept -> decide -> execute
        rq = req if i == 0 else np.zeros_like(req)
        stop, alive = np.zeros((R, 2, 8), bool), np.ones(R, bool)
        js, jk, jflat = jkv.fused_compact(
            js, jk, jtick.TickInbox(jnp.asarray(rq), jnp.asarray(stop),
                                    jnp.asarray(alive)),
            zeros, zeros, zeros, zeros, -1, E, Lb)
        ts, tk, tflat = tkv.fused_compact(
            ts, tk, ttick.TickInbox(torch.from_numpy(rq),
                                    torch.from_numpy(stop),
                                    torch.from_numpy(alive)),
            zeros, zeros, zeros, zeros, -1, E, Lb)
        flat = tflat.numpy()
        assert flat.shape[0] == L.total_device
        assert np.array_equal(np.asarray(jflat), flat), i
        assert_kv_equal(jk, tk, i)
        co = ttick.unpack_compact(flat, R, 8, E, Lb)
        e_resp, e_miss = L.kv_extras(flat)
        execd = co.e_rid[:co.n_exec] == 77
        if execd.any():
            seen = True
            assert (e_resp[:co.n_exec][execd] == 1234).all()
            assert (e_miss[:co.n_exec][execd] == 0).all()
    assert seen


# -------------------------------------------------- the manager's device app

def make(which, G=32, **paxos):
    cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.compact_outbox = True
    cfg.paxos.device_app = True
    cfg.paxos.bulk_capacity = 1 << 16
    for k, v in paxos.items():
        setattr(cfg.paxos, k, v)
    kw = {"device": "cpu"} if which == PORT else {}
    return (tmgr if which == PORT else jmgr).PaxosManager(
        cfg, R, [None] * R, **kw), cfg


def drain(m, ticks=30):
    for _ in range(ticks):
        m.tick()
    m.drain_pipeline()


def assert_managers_equal(jm, tm):
    assert_kv_equal(jm.kv, tm.kv, "manager kv")
    for name, a, b in zip(tst.PaxosState._fields, jm.state,
                          tst.state_to_numpy(tm.state)):
        assert np.array_equal(np.asarray(a), b), name
    assert dict(jm.stats) == dict(tm.stats)
    assert jm.bulk_stats() == tm.bulk_stats()
    assert jm._kv_watermark == tm._kv_watermark
    assert jm.tick_num == tm.tick_num


def run_both(script, **kw):
    out = {}
    for which in (REF, PORT):
        m, cfg = make(which, **kw)
        out[which] = (m, script(m))
    assert out[PORT][1] == out[REF][1]
    assert_managers_equal(out[REF][0], out[PORT][0])
    return out[PORT]


def cb_into(got, tag):
    return lambda rid, resp: got.setdefault(tag, resp)


def test_device_put_get_roundtrip():
    def script(m):
        for i in range(8):
            assert m.create_paxos_instance(f"d{i}", [0, 1, 2])
        rows = np.array([m.rows.row(f"d{i}") for i in range(8)])
        got = {}
        m.propose_bulk_kv(rows, [OP_PUT] * 8, [7] * 8,
                          [100 + i for i in range(8)],
                          callbacks=[cb_into(got, f"p{i}") for i in range(8)])
        drain(m)
        # (requests of one group entered at different replicas in one tick
        # commit in the coordinator's order, not in rid order: each drain
        # below holds at most one request per key and group)
        m.propose_bulk_kv(rows[:2], [OP_PUT, OP_PUT], [9, 9], [5, 6])
        m.propose_bulk_kv(rows[:1], [OP_GET], [7], [0],
                          callbacks=[cb_into(got, "g")])
        drain(m)
        m.propose_bulk_kv(rows[:1], [OP_DEL], [7], [0],
                          callbacks=[cb_into(got, "dl")])
        m.propose_bulk_kv(rows[:2], [OP_GET, OP_GET], [9, 9], [0, 0],
                          callbacks=[cb_into(got, "g9a"),
                                     cb_into(got, "g9b")])
        drain(m)
        m.propose_bulk_kv(rows[:1], [OP_GET], [7], [0],
                          callbacks=[cb_into(got, "g2")])
        drain(m)
        return sorted(got.items())

    m, got = run_both(script)
    got = dict(got)
    assert [got[f"p{i}"] for i in range(8)] == \
        [struct.pack("<i", 100 + i) for i in range(8)]
    assert got["g"] == struct.pack("<i", 100)
    assert got["g2"] == struct.pack("<i", 0)
    assert (got["g9a"], got["g9b"]) == (struct.pack("<i", 5),
                                        struct.pack("<i", 6))
    assert m.stats["kv_misses"] == 0 and m.bulk_stats()["done"] == 15


def test_device_scalar_propose_miss_path():
    """A scalar propose carries a descriptor with no device upload: every
    replica misses and the host fallback applies it."""
    def script(m):
        assert m.create_paxos_instance("d0", [0, 1, 2])
        got = []
        m.propose("d0", pack_desc(OP_PUT, 5, 42),
                  callback=lambda rid, resp: got.append(resp))
        m.propose("d0", pack_desc(OP_GET, 5, 0),
                  callback=lambda rid, resp: got.append(resp))
        drain(m)
        return got

    m, got = run_both(script)
    assert got == [struct.pack("<i", 42)] * 2
    assert m.stats["kv_misses"] == 6
    row = m.rows.row("d0")
    assert all(int(m.kv.val[r, row, 5]) == 42 for r in range(R))


def test_device_crash_heal_checkpoint_transfer():
    def script(m):
        for i in range(8):
            assert m.create_paxos_instance(f"d{i}", [0, 1, 2])
        rows = np.array([m.rows.row(f"d{i}") for i in range(8)])
        m.propose_bulk_kv(rows, [OP_PUT] * 8, [1] * 8, [11] * 8)
        drain(m, ticks=8)
        m.set_alive(2, False)
        for wave in range(12):
            m.propose_bulk_kv(rows, [OP_PUT] * 8, [2] * 8, [20 + wave] * 8)
            drain(m, ticks=3)
        m.set_alive(2, True)
        drain(m, ticks=40)
        return m.stats["checkpoint_transfers"]

    m, transfers = run_both(script, G=64)
    assert transfers > 0
    key = m.kv.key.numpy()
    assert np.array_equal(key[0], key[2])


def test_descriptor_miss_fails_request_explicitly():
    """A committed rid whose descriptor is gone fails the request (cb(None),
    failed_requests counted): never an empty success."""
    def script(m):
        assert m.create_paxos_instance("d0", [0, 1, 2])
        row = m.rows.row("d0")
        store = m._ensure_bulk()
        rid = 424242
        pay = np.empty(1, object)
        pay[:] = [b""]
        store.admit_at(np.array([rid], np.int64), np.array([row], np.int32),
                       np.array([0], np.int32), np.array([False]), pay)
        got = {}
        m._bulk_cbs[rid] = cb_into(got, "resp")
        for r in range(R):
            m._store_exec_one(r, row, rid, 5 + r, rid & store.mask)
        for cb, rid_, resp in list(m._held_callbacks):
            cb(rid_, resp)
        return got, m.stats["failed_requests"]

    _, (got, failed) = run_both(script, G=8)
    assert failed == 1 and got == {"resp": None}


def test_device_row_lifecycle_no_leak_and_pause_preserves():
    """Removed rows scrub their KV data; paused groups carry it in the
    spilled record."""
    def script(m):
        assert m.create_paxos_instance("old", [0, 1, 2])
        got = {}
        m.propose_bulk_kv(np.array([m.rows.row("old")]), [OP_PUT], [5], [77],
                          callbacks=[cb_into(got, "p")])
        drain(m)
        assert m.remove_paxos_instance("old")
        assert m.create_paxos_instance("fresh", [0, 1, 2])
        m.propose_bulk_kv(np.array([m.rows.row("fresh")]), [OP_GET], [5],
                          [0], callbacks=[cb_into(got, "g")])
        drain(m)
        m.propose_bulk_kv(np.array([m.rows.row("fresh")]), [OP_PUT], [2],
                          [42], callbacks=[cb_into(got, "p2")])
        drain(m)
        paused = m._pause_eligible(limit=4, ignore_idle=True)
        kv_paused = [np.asarray(m.kv.key).copy(), np.asarray(m.kv.val).copy()]
        m.propose_bulk_kv(np.array([m._resident_row("fresh")]), [OP_GET],
                          [2], [0], callbacks=[cb_into(got, "g2")])
        drain(m)
        return sorted(got.items()), paused, [a.sum() for a in kv_paused]

    _, (got, paused, sums) = run_both(script, G=4)
    got = dict(got)
    assert got["p"] == struct.pack("<i", 77)
    assert got["g"] == struct.pack("<i", 0)  # no leak from "old"
    assert "fresh" in paused and sums == [0, 0]  # scrubbed while paused
    assert got["g2"] == struct.pack("<i", 42)


COMBOS = [
    ({"compact_outbox": False}, "requires compact_outbox"),
    ({"register_groups": 8}, "register_groups"),
    ({"emulate_unreplicated": True}, "baseline modes"),
    ({"lazy_propagation": True}, "baseline modes"),
    ({"mesh_devices": 2}, "mesh_devices"),
    ({"read_leases": True}, "read_leases"),
    ({"group_health": True}, "group_health"),
]


@pytest.mark.parametrize("extra,word", COMBOS)
def test_device_app_refusals_match_reference(extra, word):
    msgs = {}
    for which in (REF, PORT):
        with pytest.raises(ValueError, match=word) as e:
            make(which, G=8, **extra)
        msgs[which] = str(e.value)
    assert msgs[PORT] == msgs[REF]


def test_plain_bulk_refused_on_device_app():
    for which in (REF, PORT):
        m, _ = make(which, G=8)
        m.create_paxos_instance("d0", [0, 1, 2])
        with pytest.raises(ValueError, match="propose_bulk_kv"):
            m.propose_bulk(np.array([m.rows.row("d0")]), b"x")


# --------------------------------------------------------- WAL and recovery

def durable(which, path, G=16):
    cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.compact_outbox = True
    cfg.paxos.device_app = True
    cfg.paxos.bulk_capacity = 1 << 16
    log = tlog if which == PORT else jlog
    wal = log.PaxosLogger(str(path), sync_every_ticks=1,
                          checkpoint_every_ticks=5, native=False)
    kw = {"device": "cpu"} if which == PORT else {}
    m = (tmgr if which == PORT else jmgr).PaxosManager(cfg, R, [None] * R,
                                                       wal=wal, **kw)
    return cfg, m


def recover(which, cfg, path):
    kw = {"device": "cpu"} if which == PORT else {}
    log = tlog if which == PORT else jlog
    return log.recover(cfg, R, [None] * R, str(path), native=False, **kw)


def _wal_workload(m):
    for i in range(4):
        assert m.create_paxos_instance(f"d{i}", [0, 1, 2])
    rows = np.array([m.rows.row(f"d{i}") for i in range(4)])
    acked = []
    for wave in range(6):
        m.propose_bulk_kv(rows, [OP_PUT] * 4, [wave % 3 + 1] * 4,
                          [1000 * wave + i for i in range(4)],
                          callbacks=[lambda rid, resp: acked.append(rid)] * 4)
        drain(m, ticks=4)
    m.propose("d1", pack_desc(OP_PUT, 6, 66))  # a scalar miss, journaled
    m.pause_idle(0)
    m.propose_bulk_kv(rows[:2], [OP_PUT] * 2, [4] * 2, [7, 8])  # staged
    drain(m, ticks=4)
    m.propose_bulk_kv(rows[2:], [OP_PUT] * 2, [4] * 2, [9, 10])  # in chunks
    return rows, sorted(acked)


def test_device_wal_recovery(tmp_path):
    """Journals and snapshots equal byte for byte, each package recovers
    both directories to the same store and table as the live run, and the
    recovered managers continue on the device path."""
    live, cfgs = {}, {}
    for which in (REF, PORT):
        cfgs[which], m = durable(which, tmp_path / which)
        rows, acked = _wal_workload(m)
        live[which] = (m, acked)
        m.wal.close()  # crash
    assert live[PORT][1] == live[REF][1] and len(live[PORT][1]) == 24
    assert_kv_equal(live[REF][0].kv, live[PORT][0].kv, "live")
    files = sorted(os.listdir(tmp_path / REF))
    assert files == sorted(os.listdir(tmp_path / PORT))
    assert any(f.startswith("snapshot") for f in files)
    for f in files:
        assert (tmp_path / REF / f).read_bytes() == \
            (tmp_path / PORT / f).read_bytes(), f
    recs = {}
    for which in (REF, PORT):
        for d in (REF, PORT):
            # each recovery appends to its own copy of the directory
            work = tmp_path / f"{which}-recovers-{d}"
            shutil.copytree(tmp_path / d, work)
            recs[which, d] = recover(which, cfgs[which], work)
    base = recs[REF, REF]
    for key, m2 in recs.items():
        assert_kv_equal(base.kv, m2.kv, key)
        assert m2._kv_watermark == base._kv_watermark
        assert m2.bulk_stats() == base.bulk_stats()
    # the recovered managers finish the staged uploads, then serve a GET
    outs = {}
    for which in (REF, PORT):
        m2 = recs[which, which]
        got = []
        drain(m2, ticks=6)
        m2.propose_bulk_kv(rows[:1], [OP_GET], [4], [0],
                           callbacks=[lambda rid, resp: got.append(resp)])
        drain(m2, ticks=10)
        outs[which] = got
    assert outs[PORT] == outs[REF] == [struct.pack("<i", 7)]
    assert_managers_equal(recs[REF, REF], recs[PORT, PORT])


# ----------------------------------------------------- measurement baselines

def _baseline_manager(which, **flag):
    cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    cfg.paxos.compact_outbox = True
    for k, v in flag.items():
        setattr(cfg.paxos, k, v)
    dense = tdense if which == PORT else jdense
    apps = [dense.DenseCounterApp(8) for _ in range(R)]
    kw = {"device": "cpu"} if which == PORT else {}
    m = (tmgr if which == PORT else jmgr).PaxosManager(cfg, R, apps, **kw)
    for a in apps:
        a.row_of = m.rows.row
    return m, apps


def test_unreplicated_baseline_mode():
    """emulateUnreplicated: the entry executes and responds inline, with no
    coordination — no tick runs."""
    out = {}
    for which in (REF, PORT):
        m, apps = _baseline_manager(which, emulate_unreplicated=True)
        assert m.create_paxos_instances([f"u{i}" for i in range(4)],
                                        [0, 1, 2]) == 4
        rows = np.array([m.rows.row(f"u{i}") for i in range(4)])
        got, sunk = {}, []
        rids = m.propose_bulk(
            rows, [struct.pack("<q", 5)] * 4,
            callbacks=[(lambda rid, r, i=i: got.__setitem__(i, r))
                       for i in range(4)])
        rids2 = m.propose_bulk(rows[:2], struct.pack("<q", 2),
                               batch_sink=lambda o, r: sunk.append(
                                   (list(o), list(r))))
        out[which] = (rids.tolist(), rids2.tolist(), sorted(got.items()),
                      sunk, m.tick_num, dict(m.stats),
                      [(a.acc.tolist(), a.count.tolist()) for a in apps])
    assert out[PORT] == out[REF]
    assert len(out[PORT][2]) == 4 and out[PORT][4] == 0
    # exactly one replica executed each request (nothing replicated)
    assert sum(sum(c) for _, c in out[PORT][6]) == 6


def test_lazy_propagation_baseline_mode():
    """emulateLazyPropagation: the entry responds at once; consensus still
    converges the other replicas, with no second execution at the entry."""
    out = {}
    for which in (REF, PORT):
        m, apps = _baseline_manager(which, lazy_propagation=True)
        assert m.create_paxos_instances([f"z{i}" for i in range(4)],
                                        [0, 1, 2]) == 4
        rows = np.array([m.rows.row(f"z{i}") for i in range(4)])
        got = {}
        m.propose_bulk(rows, [struct.pack("<q", 3)] * 4,
                       callbacks=[(lambda rid, r, i=i: got.__setitem__(i, r))
                                  for i in range(4)])
        eager = sum(int(a.count.sum()) for a in apps)
        drain(m, ticks=12)
        out[which] = (eager, sorted(got.items()), dict(m.stats),
                      m.bulk_stats(),
                      [(a.acc.tolist(), a.count.tolist()) for a in apps])
    assert out[PORT] == out[REF]
    assert out[PORT][0] == 4 and len(out[PORT][1]) == 4
    for acc, count in out[PORT][4]:
        assert [acc[r] for r in range(4)] == [3] * 4
        assert [count[r] for r in range(4)] == [1] * 4


# ------------------------------------------------------------- the cluster

def test_device_cluster_e2e():
    """create -> batched descriptor traffic through the binary client edge
    -> reconfigure -> read back, with the device app behind each cluster
    (built directly), the same responses from both packages."""
    import threading
    import time

    from gigapaxos_tpu.client import ReconfigurableAppClient as RefClient
    from gigapaxos_tpu.node import InProcessCluster as RefCluster
    from gigapaxos_tpu_torch.client import ReconfigurableAppClient as Client
    from gigapaxos_tpu_torch.node import InProcessCluster as Cluster

    def run(which):
        cfg = (tcfg if which == PORT else jcfg).GigapaxosTpuConfig()
        cfg.paxos.max_groups = 64
        cfg.paxos.compact_outbox = True
        cfg.paxos.device_app = True
        cfg.paxos.pipeline_ticks = True
        cfg.paxos.bulk_capacity = 1 << 16
        for i in range(3):
            cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
        cfg.nodes.reconfigurators["RC0"] = ("127.0.0.1", 0)
        kw = {"device": "cpu"} if which == PORT else {}
        cluster = (Cluster if which == PORT else RefCluster)(
            cfg, lambda: None, **kw)
        client = (Client if which == PORT else RefClient)(cfg.nodes)
        try:
            assert client.create("svc").get("ok")
            sender = client.batching(max_batch=32, flush_interval_s=0.005)
            ok, done = {}, threading.Event()

            def submit(i, tries=40):
                def cb(p):
                    if p.get("ok"):
                        ok[i] = p.get("response")
                        if len(ok) >= 20:
                            done.set()
                    elif tries > 0:
                        # a create response races the actives' start of
                        # the epoch: retry not_active like request()
                        time.sleep(0.1)
                        submit(i, tries - 1)

                sender.submit("svc", pack_desc(OP_PUT, i % 4 + 1, 500 + i),
                              cb)

            for i in range(20):
                submit(i)
            assert done.wait(120), len(ok)
            sender.close()
            # (a retried PUT may land after a later one: read back only
            # what a serial write fixed)
            got = [client.request("svc", pack_desc(OP_PUT, 3, 777),
                                  timeout=120),
                   client.request("svc", pack_desc(OP_GET, 3, 0),
                                  timeout=120),
                   client.request("svc", pack_desc(OP_GET, 9, 0),
                                  timeout=120)]
            assert client.reconfigure("svc", ["AR0", "AR1", "AR2"]).get("ok")
            got.append(client.request("svc", pack_desc(OP_GET, 3, 0),
                                      timeout=120))
            return sorted(ok.items()), got
        finally:
            client.close()
            cluster.close()

    ref, port = run(REF), run(PORT)
    assert port == ref
    assert len(port[0]) == 20
    assert port[1] == [struct.pack("<i", v) for v in (777, 777, 0, 777)]


# ------------------------------------------------ chip_smoke's device-kv phase

def test_chip_smoke_device_kv_phase_on_cpu(tmp_path):
    """chip_smoke.py's device-kv legs at a small size on the CPU, every
    check included (kernel launch counts are read on the card only)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from gigapaxos_tpu_torch.ops import plane_gather as pg

    out = chip_smoke.device_kv_phase(torch, pg, CPU, str(tmp_path),
                                     G_1m=1 << 12, G_128k=1 << 10,
                                     ticks_1m=4, ticks_128k=4)
    assert out["device-kv-1M"]["ticks_timed"] == 4
    assert out["device-kv-128k"]["acked"] > 0
    assert out["device-kv-recover"]["acked_read_back"] > 0
    for arm in ("unreplicated", "lazy"):
        assert out["baselines-128k"][arm]["dec_per_s"] > 0
