"""Plane twins at the tick level: the lease fold, the health fold, the
mixed log/register planes, their merges and their replay scans in the port
(``gigapaxos_tpu_torch.ops.tick``, on the CPU) against the JAX reference on
the same seeded inputs.

Tolerance: 0.  State, lease and health columns, outbox buffers, lease
packs and health packs are int32 / bool and must be ``np.array_equal`` on
every tick.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import tick as jt
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu_torch.ops import tick as pt
from gigapaxos_tpu_torch.paxos import state as pst

LAG_BUDGET = 16
HORIZON, MARGIN = 6, 2
WEDGE, SHIFT = 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b, what):
    """Reference value ``a`` (jax/numpy/None) equals port value ``b``."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, (what, i))
        return
    x = np.asarray(a)
    y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
    assert x.shape == y.shape, (what, x.shape, y.shape)
    assert np.array_equal(x, y), what


def _port(tree):
    """A reference pytree (NamedTuple of arrays / None) as port tensors."""
    if tree is None:
        return None
    return type(tree)(*(torch.as_tensor(np.array(f)) for f in tree))


def _open_plane(rng, R, G, W, frac=0.75):
    rows = np.sort(rng.choice(G, size=max(1, int(frac * G)), replace=False))
    members = rng.random((len(rows), R)) < 0.8
    members[np.arange(len(rows)), rng.integers(0, R, len(rows))] = True
    js = jst.create_groups(jst.init_state(R, G, W), rows.astype(np.int32),
                           members)
    return js, pst.state_from_numpy([np.asarray(f) for f in js],
                                    device="cpu"), rows


class _Intake:
    """Seeded random intake with replica crashes/recoveries: a crash of the
    sitting coordinator's replica is what churns coordinators."""

    def __init__(self, rng, R, P, G, fill=0.3, flip=0.15):
        self.rng, self.R, self.P, self.G = rng, R, P, G
        self.fill, self.flip = fill, flip
        self.alive = np.ones(R, bool)
        self.next_rid = 1

    def next(self):
        rng = self.rng
        if rng.random() < self.flip:
            self.alive[rng.integers(0, self.R)] ^= True
        fill = rng.random((self.R, self.P, self.G)) < self.fill
        req = np.zeros((self.R, self.P, self.G), np.int32)
        n = int(fill.sum())
        req[fill] = np.arange(self.next_rid, self.next_rid + n,
                              dtype=np.int32)
        self.next_rid += n
        stop = fill & (rng.random((self.R, self.P, self.G)) < 0.005)
        return req, stop, self.alive.copy()


def _inboxes(req, stop, alive):
    return (jt.TickInbox(req, stop, alive),
            pt.TickInbox(torch.from_numpy(req.copy()),
                         torch.from_numpy(stop.copy()),
                         torch.from_numpy(alive.copy())))


# ------------------------------------------------------- paxos_tick_impl folds

@functools.lru_cache(maxsize=None)
def _jax_fold(use_lease, use_health, exec_budget, topk):
    def step(state, lease, health, inbox):
        return jt.paxos_tick_impl(
            state, inbox, -1, exec_budget,
            lease=lease if use_lease else None, lease_horizon=HORIZON,
            health=health if use_health else None, wedge_ticks=WEDGE,
            health_decay_shift=SHIFT, health_topk=topk)

    return jax.jit(step)


@pytest.mark.parametrize("use_lease,use_health,R,W,P,G,budget", [
    (True, False, 3, 8, 2, 96, 0),
    (False, True, 3, 4, 2, 96, 0),
    (True, True, 3, 8, 2, 96, 200),
    (True, True, 5, 1, 4, 64, 0),
])
def test_tick_impl_lease_health_folds(use_lease, use_health, R, W, P, G,
                                      budget):
    """48 ticks of random intake with replica crashes (coordinator churn);
    state, outbox, lease and health columns and both packs equal on every
    tick."""
    rng = np.random.default_rng(7 + R + W + G + budget)
    js, ts, rows = _open_plane(rng, R, G, W)
    jl = jt.init_lease(G, MARGIN) if use_lease else None
    tl = pt.init_lease(G, MARGIN, device="cpu") if use_lease else None
    jh = jt.init_health(G) if use_health else None
    th = pt.init_health(G, device="cpu") if use_health else None
    topk = 8
    step = _jax_fold(use_lease, use_health, budget, topk)
    intake = _Intake(rng, R, P, G, fill=0.25)
    saw_wait = saw_handoff = False
    for t in range(48):
        req, stop, alive = intake.next()
        if t in (16, 32):  # rows freed and reopened: the clears
            gone = rng.choice(rows, size=6, replace=False).astype(np.int32)
            js = jst.free_groups(js, gone)
            pst.free_groups(ts, gone)
            pad = np.concatenate([gone, [G, G]]).astype(np.int32)
            if use_lease:
                jl = jt.lease_clear_rows(jl, pad)
                tl = pt.lease_clear_rows(tl, pad)
            if use_health:
                jh = jt.health_clear_rows(jh, pad)
                th = pt.health_clear_rows(th, pad)
        jin, tin = _inboxes(req, stop, alive)
        jr = step(js, jl, jh, jin)
        tr = pt.paxos_tick_impl(
            ts, tin, -1, budget, lease=tl, lease_horizon=HORIZON, health=th,
            wedge_ticks=WEDGE, health_decay_shift=SHIFT, health_topk=topk)
        assert len(jr) == len(tr)
        _eq(jr[0], tr[0], ("state", t))
        _eq(jr[1], tr[1], ("outbox", t))
        i = 2
        if use_lease:
            _eq(jr[i], tr[i], ("lease", t))
            _eq(jr[i + 1], tr[i + 1], ("lease_pack", t))
            saw_wait |= bool(np.asarray(jr[i + 1])[jt.LP_WAIT].any())
            jl, tl = jr[i], tr[i]
            i += 2
        if use_health:
            _eq(jr[i], tr[i], ("health", t))
            _eq(jr[i + 1], tr[i + 1], ("health_pack", t))
            saw_handoff |= bool(np.asarray(jr[i].churn).any())
            jh, th = jr[i], tr[i]
        js, ts = jr[0], tr[0]
    # the workload reached the folds' interesting branches
    if use_lease:
        assert saw_wait
    if use_health:
        assert saw_handoff


def test_idle_plane_topk_tie_order():
    """An idle plane ranks all ties: every row's stall/churn/heat is 0 (and
    unallocated rows -1), so the top-K must be the LOWEST rows, in order,
    as ``lax.top_k`` returns them."""
    R, W, P, G = 3, 4, 1, 5000
    rng = np.random.default_rng(1)
    js, ts, _ = _open_plane(rng, R, G, W, frac=0.5)
    jh, th = jt.init_health(G), pt.init_health(G, device="cpu")
    req = np.zeros((R, P, G), np.int32)
    jin, tin = _inboxes(req, np.zeros((R, P, G), bool), np.ones(R, bool))
    for k in (1, 8, 64):
        jr = jt.paxos_tick_impl(js, jin, health=jh, health_topk=k)
        tr = pt.paxos_tick_impl(ts, tin, health=th, health_topk=k)
        _eq(jr[3], tr[3], ("health_pack", k))
        hv = pt.unpack_health(tr[3], k)
        first = np.sort(np.nonzero(np.asarray(js.member).any(axis=0))[0])[:k]
        assert np.array_equal(hv.stuck_row, first)
        assert (hv.stuck_val == 0).all()


def test_log2_hist_edges():
    """The frexp/bincount histogram equals the reference's threshold sums
    at every power-of-two edge, for negatives, zero and int32 max."""
    edges = [0, 1, 2, 3, 4, 7, 8, 255, 256, 2**24 - 1, 2**24, 2**24 + 1,
             2**30 - 1, 2**30, 2**31 - 1, -1, -5]
    v = np.array(edges * 3, np.int32)
    mask = np.arange(len(v)) % 3 != 2
    ref = np.asarray(jt._log2_hist(v, mask))
    got = pt._log2_hist(torch.from_numpy(v), torch.from_numpy(mask))
    _eq(ref, got, "hist")


def test_clear_rows_padding_and_clock():
    """The clears ignore out-of-range padding; health resets last_active to
    the plane's clock."""
    G = 16
    jl, tl = jt.init_lease(G, 3), pt.init_lease(G, 3, device="cpu")
    vals = np.arange(G, dtype=np.int32)
    jl = jl._replace(holder=vals % 3, epoch=vals, until=vals + 5)
    tl = _port(jl)
    jh = jt.init_health(G)._replace(
        clock=np.int32(9), last_active=vals, last_coord=vals % 3,
        churn=vals * 16, heat=vals * 32)
    th = _port(jh)
    pad = np.array([3, 7, G, G, G, G, G, G], np.int32)
    _eq(jt.lease_clear_rows(jl, pad), pt.lease_clear_rows(tl, pad), "lease")
    _eq(jt.health_clear_rows(jh, pad), pt.health_clear_rows(th, pad),
        "health")


# -------------------------------------------------------------- mixed planes

def _mixed_setup(seed, R=3, W=8, P=2, g_log=48, g_reg=40):
    rng = np.random.default_rng(seed)
    js, ts, _ = _open_plane(rng, R, g_log, W)
    jr, tr, _ = _open_plane(rng, R, g_reg, 1)
    return rng, js, ts, jr, tr


@pytest.mark.parametrize("compact,lease", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_mixed_ticks_and_merges(compact, lease):
    """The mixed packed/compact ticks and their lease twins, entry point
    for entry point, and ``merge_outbox`` / ``merge_compact_outbox`` of
    their unpacked outboxes."""
    R, P, W, g_log, g_reg = 3, 2, 8, 48, 40
    budget = 300
    rng, js, ts, jr, tr = _mixed_setup(11 + 2 * compact + lease, R, W, P,
                                       g_log, g_reg)
    jl = jrl = tl = trl = None
    if lease:
        jl, jrl = jt.init_lease(g_log, MARGIN), jt.init_lease(g_reg, MARGIN)
        tl = pt.init_lease(g_log, MARGIN, device="cpu")
        trl = pt.init_lease(g_reg, MARGIN, device="cpu")
    intake = _Intake(rng, R, P, g_log + g_reg, fill=0.3)
    for t in range(40):
        jin, tin = _inboxes(*intake.next())
        if compact and lease:
            jres = jt.paxos_tick_mixed_compact_lease(
                js, jr, jl, jrl, jin, -1, budget, LAG_BUDGET, HORIZON)
            tres = pt.paxos_tick_mixed_compact_lease(
                ts, tr, tl, trl, tin, -1, budget, LAG_BUDGET, HORIZON)
        elif compact:
            jres = jt.paxos_tick_mixed_compact(js, jr, jin, -1, budget,
                                               LAG_BUDGET)
            tres = pt.paxos_tick_mixed_compact(ts, tr, tin, -1, budget,
                                               LAG_BUDGET)
        elif lease:
            jres = jt.paxos_tick_mixed_packed_lease(
                js, jr, jl, jrl, jin, -1, budget, HORIZON)
            tres = pt.paxos_tick_mixed_packed_lease(
                ts, tr, tl, trl, tin, -1, budget, HORIZON)
        else:
            jres = jt.paxos_tick_mixed_packed(js, jr, jin, -1, budget)
            tres = pt.paxos_tick_mixed_packed(ts, tr, tin, -1, budget)
        assert len(jres) == len(tres)
        for i, (a, b) in enumerate(zip(jres, tres)):
            _eq(a, b, (t, i))
        js, jr, ts, tr = jres[0], jres[1], tres[0], tres[1]
        if lease:
            jl, jrl, tl, trl = jres[2], jres[3], tres[2], tres[3]
        pk_l, pk_r = (jres[4], jres[5]) if lease else (jres[2], jres[3])
        qk_l, qk_r = (tres[4], tres[5]) if lease else (tres[2], tres[3])
        if compact:
            jm = jt.merge_compact_outbox(
                jt.unpack_compact(np.asarray(pk_l), R, g_log, budget,
                                  LAG_BUDGET),
                jt.unpack_compact(np.asarray(pk_r), R, g_reg, budget,
                                  LAG_BUDGET), g_log)
            tm = pt.merge_compact_outbox(
                pt.unpack_compact(qk_l, R, g_log, budget, LAG_BUDGET),
                pt.unpack_compact(qk_r, R, g_reg, budget, LAG_BUDGET), g_log)
        else:
            jm = jt.merge_outbox(jt.unpack_outbox(pk_l, R, P, W, g_log),
                                 jt.unpack_outbox(pk_r, R, P, 1, g_reg))
            tm = pt.merge_outbox(pt.unpack_outbox(qk_l, R, P, W, g_log),
                                 pt.unpack_outbox(qk_r, R, P, 1, g_reg))
        assert jm._fields == tm._fields
        for f, a, b in zip(jm._fields, jm, tm):
            _eq(a, b, (t, "merged", f))


@pytest.mark.parametrize("mixed,lease,compact", [
    (True, True, True), (True, False, False), (False, True, False),
    (False, False, True), (True, True, False),
])
def test_paxos_tick_health_dispatch(mixed, lease, compact):
    """The one dispatch body with health on, for planes x leases x outbox:
    the 12-tuple matches the reference's, and ``merge_health`` of the two
    planes' views matches too (register top-K clamped to the plane)."""
    R, P, W, g_log, g_reg = 3, 2, 4, 40, 6
    budget = 200
    topk = 8  # > g_reg: the register plane's top-K clamps to 6
    rng, js, ts, jr, tr = _mixed_setup(31 + mixed + 2 * lease, R, W, P,
                                       g_log, g_reg)
    if not mixed:
        jr = tr = None
    g_tot = g_log + (g_reg if mixed else 0)
    jl = jt.init_lease(g_log, MARGIN) if lease else None
    tl = pt.init_lease(g_log, MARGIN, device="cpu") if lease else None
    jrl = jt.init_lease(g_reg, MARGIN) if lease and mixed else None
    trl = (pt.init_lease(g_reg, MARGIN, device="cpu")
           if lease and mixed else None)
    jh, th = jt.init_health(g_log), pt.init_health(g_log, device="cpu")
    jrh = jt.init_health(g_reg) if mixed else None
    trh = pt.init_health(g_reg, device="cpu") if mixed else None
    intake = _Intake(rng, R, P, g_tot, fill=0.3, flip=0.2)
    eb = budget if compact else 0
    for t in range(36):
        jin, tin = _inboxes(*intake.next())
        jres = jt.paxos_tick_health(js, jr, jl, jrl, jh, jrh, jin, -1, eb,
                                    LAG_BUDGET, HORIZON, compact, WEDGE,
                                    SHIFT, topk)
        tres = pt.paxos_tick_health(ts, tr, tl, trl, th, trh, tin, -1, eb,
                                    LAG_BUDGET, HORIZON, compact, WEDGE,
                                    SHIFT, topk)
        assert len(jres) == len(tres) == 12
        for i, (a, b) in enumerate(zip(jres, tres)):
            _eq(a, b, (t, i))
        js, jr, jl, jrl, jh, jrh = jres[:6]
        ts, tr, tl, trl, th, trh = tres[:6]
        if mixed:
            jv = jt.merge_health(
                jt.unpack_health(np.asarray(jres[10]), min(topk, g_log)),
                jt.unpack_health(np.asarray(jres[11]), min(topk, g_reg)),
                g_log, topk)
            tv = pt.merge_health(
                pt.unpack_health(tres[10], min(topk, g_log)),
                pt.unpack_health(tres[11], min(topk, g_reg)), g_log, topk)
            for f, a, b in zip(jv._fields, jv, tv):
                _eq(a, b, (t, "merged health", f))


def test_merge_health_ties_across_planes():
    """``_merge_top`` keeps the stable order across planes on equal values
    (log rows first), in both packages."""
    K = 4
    mk = lambda mod: mod.HealthView(  # noqa: E731
        alloc=3, backlog=1, wedged=0, max_stall=5, max_churn=16,
        lease_wait=0, hist_stall=np.arange(32, dtype=np.int32),
        hist_churn=np.ones(32, np.int32),
        stuck_val=np.array([5, 5, 0, -1], np.int32),
        stuck_row=np.array([2, 7, 0, 0], np.int32),
        churn_val=np.array([16, 0, 0, 0], np.int32),
        churn_row=np.array([1, 0, 3, 4], np.int32),
        heat_val=np.array([3, 3, 3, 3], np.int32),
        heat_row=np.array([0, 1, 2, 3], np.int32))
    jv = jt.merge_health(mk(jt), mk(jt), 10, K)
    tv = pt.merge_health(mk(pt), mk(pt), 10, K)
    for f, a, b in zip(jv._fields, jv, tv):
        _eq(a, b, f)


# -------------------------------------------------------------- replay scans

def _coo(rng, K, R, P, G, M, alive_flip=0.1):
    """K ticks of padded COO intake columns (unique (e, p, g) per tick)."""
    e = np.zeros((K, M), np.int32)
    p = np.zeros((K, M), np.int32)
    g = np.full((K, M), G, np.int32)  # padding: one past the row space
    rid = np.zeros((K, M), np.int32)
    stop = np.zeros((K, M), bool)
    alive = np.ones((K, R), bool)
    nxt = 1
    for k in range(K):
        n = int(rng.integers(M // 2, M + 1))
        cells = rng.choice(R * P * G, size=n, replace=False)
        e[k, :n], rest = np.divmod(cells, P * G)
        p[k, :n], g[k, :n] = np.divmod(rest, G)
        rid[k, :n] = np.arange(nxt, nxt + n)
        nxt += n
        if k and rng.random() < alive_flip:
            alive[k:, rng.integers(0, R)] ^= True
    return {"e": e, "p": p, "g": g, "rid": rid, "stop": stop,
            "alive": alive}


@pytest.mark.parametrize("mixed,lease", [(False, True), (True, False),
                                         (True, True)])
def test_replay_scans_match_reference_and_single_ticks(mixed, lease):
    """Each scan equals the reference's scan, and equals K single ticks of
    the port's own dispatch body (state, lease columns, packs, the last
    lease pack and the per-tick fenced counts)."""
    R, P, W, g_log, g_reg, K, M = 3, 2, 4, 40, 24, 6, 48
    E, scat = 100, 160
    rng, js, ts, jr, tr = _mixed_setup(51 + mixed + 2 * lease, R, W, P,
                                       g_log, g_reg)
    g_tot = g_log + (g_reg if mixed else 0)
    xs = _coo(rng, K, R, P, g_tot, M)
    jxs = {k: np.asarray(v) for k, v in xs.items()}
    jl, tl = jt.init_lease(g_log, MARGIN), pt.init_lease(g_log, MARGIN,
                                                         device="cpu")
    jrl = jt.init_lease(g_reg, MARGIN)
    trl = pt.init_lease(g_reg, MARGIN, device="cpu")
    if mixed and lease:
        jres = jt.replay_scan_ticks_mixed_lease(js, jr, jl, jrl, jxs, P, E,
                                                scat, LAG_BUDGET, HORIZON)
        tres = pt.replay_scan_ticks_mixed_lease(ts, tr, tl, trl, xs, P, E,
                                                scat, LAG_BUDGET, HORIZON)
    elif mixed:
        jres = jt.replay_scan_ticks_mixed(js, jr, jxs, P, E, scat,
                                          LAG_BUDGET)
        tres = pt.replay_scan_ticks_mixed(ts, tr, xs, P, E, scat, LAG_BUDGET)
    else:
        jres = jt.replay_scan_ticks_lease(js, jl, jxs, P, E, scat,
                                          LAG_BUDGET, HORIZON)
        tres = pt.replay_scan_ticks_lease(ts, tl, xs, P, E, scat, LAG_BUDGET,
                                          HORIZON)
    assert len(jres) == len(tres)
    for i, (a, b) in enumerate(zip(jres, tres)):
        _eq(a, b, ("scan", i))
    # K single ticks through the dispatch body
    st, rst = ts, (tr if mixed else None)
    ls = tl if lease else None
    rls = trl if lease and mixed else None
    packs, waits, lp = [], [], None
    for k in range(K):
        x = {n: torch.as_tensor(np.asarray(v[k])) for n, v in xs.items()}
        x = {n: v.to(torch.int64) if n in "epg" else v for n, v in x.items()}
        res = pt.paxos_tick_health(
            st, rst, ls, rls, None, None, pt._coo_inbox(x, R, P, g_tot), -1,
            E, LAG_BUDGET, HORIZON, True, scat_budget=scat)
        st, rst, ls, rls = res[:4]
        packs.append(res[6] if res[7] is None
                     else torch.cat([res[6], res[7]]))
        if lease:
            lp = res[8] if res[9] is None else (res[8], res[9])
            w = res[8][pt.LP_WAIT].sum(dtype=torch.int32)
            if res[9] is not None:
                w = w + res[9][pt.LP_WAIT].sum(dtype=torch.int32)
            waits.append(w)
    single = {"state": st, "rstate": rst, "lease": ls, "rlease": rls,
              "packs": torch.stack(packs), "lp": lp,
              "waits": torch.stack(waits) if waits else None}
    if mixed and lease:
        names = ("state", "rstate", "lease", "rlease", "packs", "lp",
                 "waits")
    elif mixed:
        names = ("state", "rstate", "packs")
    else:
        names = ("state", "lease", "packs", "lp", "waits")
    for n, b in zip(names, tres):
        _eq(tuple(single[n]) if isinstance(single[n], tuple) else single[n],
            tuple(b) if isinstance(b, tuple) else b, ("single", n))
