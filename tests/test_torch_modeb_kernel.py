"""Mode B kernel twin: the port's ``modeb/kernel.py`` and replica-slot
expanders against the reference's jitted functions, on the CPU, from the
same seeded inputs.

Tolerance: 0.  The node step (packed and with the device KV app fused
behind it) must give equal states, flat buffers and change masks; the
frame gather equal flat buffers, padded tail included; the mirror
scatter (rows padded with G, which both drop) equal states; the ring hop
the same target; both expanders equal states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.chain import state as jcst
from gigapaxos_tpu.models import device_kv as jdkv
from gigapaxos_tpu.modeb import kernel as jk
from gigapaxos_tpu.ops import tick as jt
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu_torch.chain import state as tcst
from gigapaxos_tpu_torch.models import device_kv as tdkv
from gigapaxos_tpu_torch.modeb import kernel as tk
from gigapaxos_tpu_torch.modeb import wire as twire
from gigapaxos_tpu_torch.ops import tick as pt
from gigapaxos_tpu_torch.paxos import state as tst

R, G, W, P = 3, 32, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcopy(state_np):
    """A fresh reference state (its jitted node steps donate their
    input)."""
    return type(state_np)(*(jnp.asarray(np.array(a)) for a in state_np))


def assert_state(js, ts, what=""):
    for f, a, b in zip(jst.PaxosState._fields, js, tst.state_to_numpy(ts)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, f)


def busy_state(seed):
    """A state whose rings hold decisions, accepts and proposals: Mode A
    ticks of random load on random member masks, as numpy arrays."""
    rng = np.random.default_rng(seed)
    members = rng.random((G, R)) < 0.8
    members[np.arange(G), rng.integers(0, R, G)] = True
    s = jst.create_groups(jst.init_state(R, G, W), np.arange(G, dtype=np.int32),
                          members)
    rid = 1
    for _ in range(5):
        req = np.zeros((R, P, G), np.int32)
        hot = rng.random((R, G)) < 0.5
        req[:, 0][hot] = np.arange(rid, rid + hot.sum())
        rid += int(hot.sum())
        alive = rng.random(R) < 0.9
        s, _ = jt.paxos_tick(s, jt.TickInbox(
            jnp.asarray(req), jnp.zeros((R, P, G), bool), jnp.asarray(alive)))
    return jst.PaxosState(*(np.asarray(a) for a in s)), rng


def random_inbox(rng, base):
    req = np.zeros((R, P, G), np.int32)
    hot = rng.random((R, P, G)) < 0.3
    req[hot] = base + np.arange(hot.sum())
    stop = (rng.random((R, P, G)) < 0.05) & hot
    alive = rng.random(R) < 0.85
    return req, stop, alive


@pytest.mark.parametrize("r,fast", [(0, False), (1, True), (2, False),
                                    (2, True)])
def test_node_tick_packed_matches(r, fast):
    s_np, rng = busy_state(10 + r)
    ts = tst.state_from_numpy(s_np, device="cpu")
    for t in range(6):
        req, stop, alive = random_inbox(rng, 1000 * (t + 1))
        js, jflat = jk.node_tick_packed(r, fast)(
            jcopy(s_np), jt.TickInbox(jnp.asarray(req), jnp.asarray(stop),
                                      jnp.asarray(alive)))
        ts, tflat = tk.node_tick_packed(r, fast)(
            ts, pt.TickInbox(torch.from_numpy(req), torch.from_numpy(stop),
                             torch.from_numpy(alive)))
        assert_state(js, ts, t)
        assert np.array_equal(np.asarray(jflat), tflat.numpy()), t
        out, changed = tk.unpack_node_tick(tflat, R, P, W, G)
        jout, jchanged = jk.unpack_node_tick(jflat, R, P, W, G)
        assert changed.dtype == bool and np.array_equal(changed, jchanged)
        for a, b in zip(jout, out):
            assert np.array_equal(a, b)
        s_np = jst.PaxosState(*(np.asarray(a) for a in js))
    # the impl's own change mask is bool (the packed form casts it)
    _, _, ch = tk.node_tick_impl(ts, pt.TickInbox(
        torch.from_numpy(req), torch.from_numpy(stop),
        torch.from_numpy(alive)), r, fast)
    assert ch.dtype == torch.bool


@pytest.mark.parametrize("fast", [False, True])
def test_node_tick_device_matches(fast):
    r, K = 1, 64
    s_np, rng = busy_state(21)
    ts = tst.state_from_numpy(s_np, device="cpu")
    jkv = jdkv.init_kv(1, G, 8, 1 << 10)
    tkv = tdkv.init_kv(1, G, 8, 1 << 10, device="cpu")
    for t in range(6):
        req, stop, alive = random_inbox(rng, (1 << 24) * r + 1000 * (t + 1))
        taken = np.unique(req[req != 0])
        n = min(K, taken.size)
        reg = [np.zeros(K, np.int32) for _ in range(4)]
        reg[0][:n] = rng.permutation(taken)[:n]  # some descriptors miss
        reg[1][:n] = rng.integers(1, 4, n)
        reg[2][:n] = rng.integers(1, 20, n)
        reg[3][:n] = rng.integers(-50, 50, n)
        hold = rng.random(G) < 0.1
        js, jkv, jflat = jk.node_tick_device(r, K, fast)(
            jcopy(s_np), jkv, jt.TickInbox(jnp.asarray(req),
                                           jnp.asarray(stop),
                                           jnp.asarray(alive)),
            *(jnp.asarray(a) for a in reg), jnp.asarray(hold))
        ts, tkv, tflat = tk.node_tick_device(r, K, fast)(
            ts, tkv, pt.TickInbox(torch.from_numpy(req),
                                  torch.from_numpy(stop),
                                  torch.from_numpy(alive)), *reg, hold)
        assert_state(js, ts, t)
        assert np.array_equal(np.asarray(jflat), tflat.numpy()), t
        for f, a, b in zip(jdkv.DeviceKVState._fields, jkv, tkv):
            assert np.array_equal(np.asarray(a), b.numpy()), (t, f)
        got = tk.unpack_node_tick_device(tflat, R, P, W, G)
        want = jk.unpack_node_tick_device(jflat, R, P, W, G)
        for a, b in zip(want[1:], got[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        s_np = jst.PaxosState(*(np.asarray(a) for a in js))


@pytest.mark.parametrize("r,n", [(0, 1), (1, 5), (2, 16), (1, 17), (0, 32)])
def test_frame_extract_matches_whole_buffer(r, n):
    s_np, rng = busy_state(30 + n)
    ts = tst.state_from_numpy(s_np, device="cpu")
    rows = np.sort(rng.choice(G, size=n, replace=False)).astype(np.int32)
    K = max(16, 1 << max(0, int(n - 1).bit_length()))
    rpad = np.zeros(K, np.int32)  # the manager pads with row 0
    rpad[:n] = rows
    jflat = np.asarray(jk.frame_extract(r, K)(jcopy(s_np),
                                              jnp.asarray(rpad)))
    tflat = tk.frame_extract(r, K)(ts, torch.from_numpy(rpad))
    assert tflat.dtype == torch.int32
    assert np.array_equal(jflat, tflat.numpy())
    for a, b in zip(jk.unpack_frame_extract(jflat, n, K, W),
                    tk.unpack_frame_extract(tflat, n, K, W)):
        if isinstance(a, dict):
            for f in a:
                assert a[f].dtype == b[f].dtype
                assert np.array_equal(a[f], b[f]), f
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("sr,n,K", [(0, 3, 16), (2, 16, 16), (1, 9, 32),
                                    (1, 0, 16)])
def test_mirror_apply_matches_with_padded_rows(sr, n, K):
    s_np, rng = busy_state(40 + n)
    ts = tst.state_from_numpy(s_np, device="cpu")
    S, NR, NB = len(twire.SCALARS), len(twire.RINGS), len(twire.RING_BITS)
    rows = np.full(K, G, np.int32)  # padding G: out of range, dropped
    rows[:n] = rng.choice(G, size=n, replace=False)
    scal = rng.integers(-5, 1 << 20, (S, K)).astype(np.int32)
    flg = rng.integers(0, 8, K).astype(np.int32)
    rings = rng.integers(-1, 1 << 20, (NR, K, W)).astype(np.int32)
    bits = rng.random((NB, K, W)) < 0.5
    js = jk.mirror_apply(jcopy(s_np), jnp.int32(sr), jnp.asarray(rows),
                         jnp.asarray(scal), jnp.asarray(flg),
                         jnp.asarray(rings), jnp.asarray(bits))
    ts = tk.mirror_apply(ts, sr, rows, scal, flg, rings, bits)
    assert_state(js, ts)
    # tensors in, the same result
    ts2 = tk.mirror_apply(tst.state_from_numpy(s_np, device="cpu"), sr,
                          torch.from_numpy(rows), torch.from_numpy(scal),
                          torch.from_numpy(flg), torch.from_numpy(rings),
                          torch.from_numpy(bits))
    assert_state(js, ts2)


def test_ring_downstream_matches():
    for n in (1, 2, 3, 5):
        for mask in range(1 << n):
            alive = np.array([(mask >> i) & 1 for i in range(n)], bool)
            for r in range(n):
                assert jk.ring_downstream(alive, r) == \
                    tk.ring_downstream(alive, r), (alive, r)


def test_expand_replica_slots_match():
    s_np, _ = busy_state(50)
    for n_new in (0, 1, 2):
        js = jst.expand_replica_slots(jcopy(s_np), n_new)
        ts = tst.expand_replica_slots(tst.state_from_numpy(s_np,
                                                           device="cpu"),
                                      n_new)
        assert_state(js, ts, n_new)
        assert ts.exec_slot.shape[0] == R + n_new
    members = np.ones((G, R), bool)
    members[::3, 1] = False
    jc = jcst.create_groups(jcst.init_state(R, G, W),
                            np.arange(G, dtype=np.int32), members)
    tc = tcst.create_groups(tcst.init_state(R, G, W, device="cpu"),
                            np.arange(G, dtype=np.int32), members)
    for n_new in (0, 2):
        je = jcst.expand_replica_slots(jc, n_new)
        te = tcst.expand_replica_slots(tc, n_new)
        for f, a, b in zip(jcst.ChainState._fields, je,
                           tcst.state_to_numpy(te)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), (n_new, f)
