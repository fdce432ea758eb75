"""Fast re-election twin: the port's tick with ``fast_elect=True`` against
the JAX reference's, on the CPU, from the same seeded inputs.

Tolerance: 0.  Every tick's state and packed outbox must be
``np.array_equal``.  The Mode A cases of ``tests/test_fast_reelection.py``
run through both packages with their own assertions on the port's side; a
seeded run with kills, rejoins, surgically placed conflicting accepts and
competing proposals compares every tick; the flag-off tick stays the
classical path; and a fast tick still makes 5 gathers and 1 match.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import tick as jt
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu_torch.ops import tick as pt
from gigapaxos_tpu_torch.ops import window
from gigapaxos_tpu_torch.paxos import state as pst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_step(own_row: int, fast: bool):
    def step(state, inbox):
        s, out = jt.paxos_tick_impl(state, inbox, own_row, 0, None, fast)
        return s, jt.pack_outbox_impl(out)

    return jax.jit(step)


class Twin:
    """One state in both packages, ticked together; each tick holds the
    states and the packed outboxes equal and returns the port's outbox."""

    def __init__(self, R=3, G=4, W=8, P=4, members=None, fast=True,
                 own_row=-1):
        self.R, self.G, self.W, self.P = R, G, W, P
        self.fast, self.own_row = fast, own_row
        m = np.ones((G, R), bool) if members is None else members
        rows = np.arange(G, dtype=np.int32)
        self.j = jst.create_groups(jst.init_state(R, G, W), rows, m)
        self.t = pst.state_from_numpy([np.asarray(f) for f in self.j],
                                      device="cpu")
        self.ticks = 0

    def tick(self, reqs=(), alive=None, stop=None):
        R, P, G = self.R, self.P, self.G
        req = np.zeros((R, P, G), np.int32)
        ctr = {}
        for r, g, rid in reqs:
            p = ctr.get((r, g), 0)
            req[r, p, g] = rid
            ctr[(r, g)] = p + 1
        stp = np.zeros((R, P, G), bool) if stop is None else stop
        al = np.ones(R, bool) if alive is None else np.array(alive, bool)
        self.j, jflat = _jax_step(self.own_row, self.fast)(
            self.j, jt.TickInbox(jnp.asarray(req), jnp.asarray(stp),
                                 jnp.asarray(al)))
        self.t, tflat = pt.paxos_tick_packed(
            self.t, pt.TickInbox(torch.from_numpy(req),
                                 torch.from_numpy(stp), torch.from_numpy(al)),
            self.own_row, 0, fast_elect=self.fast)
        self.assert_equal()
        assert np.array_equal(np.asarray(jflat), tflat.numpy()), self.ticks
        self.ticks += 1
        return pt.unpack_outbox(tflat, R, P, self.W, G)

    def assert_equal(self):
        for name, a, b in zip(jst.PaxosState._fields, self.j,
                              pst.state_to_numpy(self.t)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                (self.ticks, name)

    def place_accept(self, r, slot, rid, bnum, bcoord):
        """Write one accepted pvalue into row ``r``'s ring of group 0 in
        both packages (the surgery of the reference's own fast cases)."""
        j = slot % self.W
        upd = {}
        for f, v in (("acc_req", rid), ("acc_slot", slot),
                     ("acc_bnum", bnum), ("acc_bcoord", bcoord)):
            a = np.array(getattr(self.j, f))
            a[r, j, 0] = v
            upd[f] = a
        self.j = self.j._replace(**{f: jnp.asarray(a)
                                    for f, a in upd.items()})
        for f, a in upd.items():
            getattr(self.t, f)[r, j, 0] = int(a[r, j, 0])
        self.assert_equal()


def executed_ids(out, r, g):
    row = np.array(out.exec_req[r, :, g])
    n = int(out.exec_count[r, g])
    return [int(x) for x in row if x != 0][: n + 1]


# ------------------------------------------- the reference's Mode A cases
def test_fast_bootstrap_elects_and_commits_same_tick():
    tw = Twin()
    out = tw.tick(reqs=[(0, 1, 7)])
    assert np.all(out.coord_id == 0)
    assert np.all(tw.t.coord_active[0].numpy())
    assert np.all(tw.t.coord_fast[0].numpy())
    assert not tw.t.coord_preparing.any()
    for r in range(3):
        assert executed_ids(out, r, 1) == [7]


def test_fast_failover_carries_accepted_value():
    tw = Twin()
    out = tw.tick(reqs=[(0, 0, 31)])
    assert executed_ids(out, 0, 0) == [31]
    bal = int(tw.t.coord_bnum[0, 0])
    # an accepted-but-undecided pvalue at slot 1 only on row 2, under the
    # dead coordinator's ballot: only the all-member-row carryover sees it
    tw.place_accept(2, 1, 99, bal, 0)
    out = tw.tick(alive=[False, True, True])
    assert int(out.coord_id[0]) == 1
    assert bool(tw.t.coord_fast[1, 0])
    seq = executed_ids(out, 1, 0)
    assert 99 in seq, seq
    assert executed_ids(out, 2, 0) == seq


def test_fast_conflict_converges_on_single_value():
    tw = Twin()
    tw.tick(reqs=[(0, 0, 31)])
    old_bal = int(tw.t.coord_bnum[0, 0])
    out = tw.tick(reqs=[(1, 0, 50)], alive=[False, True, False])
    assert bool(tw.t.coord_fast[1, 0])
    assert int(out.exec_count[1, 0]) == 0
    assert 50 in tw.t.prop_req[1, :, 0].tolist()
    tw.place_accept(2, 1, 99, old_bal, 0)
    seqs = {}
    for _ in range(4):
        out = tw.tick(alive=[False, True, True])
        for r in (1, 2):
            seqs.setdefault(r, []).extend(
                x for x in executed_ids(out, r, 0) if x)
    assert len(seqs[1]) == 1, seqs
    assert seqs[2] == seqs[1], seqs
    assert int(tw.t.exec_slot[1, 0]) >= 2
    assert not bool(tw.t.coord_fast[1, 0])


def test_fast_flag_off_keeps_legacy_graph():
    tw = Twin(fast=False)
    tw.tick()
    out = tw.tick(reqs=[(1, 0, 42)], alive=[False, True, True])
    assert executed_ids(out, 1, 0) == [42]
    assert not tw.t.coord_fast.any()


# --------------------------------------------------------- seeded runs
@pytest.mark.parametrize("own_row", [-1, 1])
def test_seeded_fast_run_with_kills_and_conflicts(own_row):
    """32 ticks over 16 groups with random member masks: crashes and
    rejoins, competing proposals at every entry, and every few ticks an
    accepted pvalue written into a random row under an older ballot (the
    accept that raced a takeover).  With ``own_row`` set the tick is a Mode
    B node's, whose peer rows only change by surgery."""
    rng = np.random.default_rng(17 + own_row)
    R, G, W, P = 3, 16, 8, 2
    members = rng.random((G, R)) < 0.8
    members[np.arange(G), rng.integers(0, R, G)] = True
    tw = Twin(R=R, G=G, W=W, P=P, members=members, own_row=own_row)
    alive = np.ones(R, bool)
    rid = 1
    fast_seen = 0
    for t in range(32):
        if rng.random() < 0.25:
            alive[rng.integers(0, R)] ^= True
        reqs = []
        for g in rng.choice(G, size=6, replace=False):
            for r in rng.choice(R, size=int(rng.integers(1, 3)),
                                replace=False):
                reqs.append((int(r), int(g), rid))
                rid += 1
        if t % 4 == 3:
            r = int(rng.integers(0, R))
            g = int(rng.integers(0, G))
            slot = int(tw.t.exec_slot[r, g]) + int(rng.integers(0, W))
            bn = max(0, int(tw.t.bal_num[:, g].max()) - 1)
            j = slot % W
            for f, v in (("acc_req", 10_000 + t), ("acc_slot", slot),
                         ("acc_bnum", bn), ("acc_bcoord", 0)):
                a = np.array(getattr(tw.j, f))
                a[r, j, g] = v
                tw.j = tw.j._replace(**{f: jnp.asarray(a)})
                getattr(tw.t, f)[r, j, g] = v
            tw.assert_equal()
        tw.tick(reqs=reqs, alive=alive)
        fast_seen += int(tw.t.coord_fast.sum())
    assert fast_seen > 0  # the run went through fast reigns


def test_fast_tick_makes_five_gathers_and_one_match(monkeypatch):
    """The adoption rule's four ring reads ride the carryover's launch: a
    fast tick makes the same 5 + 1 kernel calls as a classical one, and the
    carryover's call carries 8 arrays."""
    calls = {"gather": [], "match": 0}
    g0, m0 = window.gather_planes_many, window.match_planes_many

    def gather(arrs, idx):
        calls["gather"].append(len(arrs))
        return g0(arrs, idx)

    def match(vals, keys, idx):
        calls["match"] += 1
        return m0(vals, keys, idx)

    monkeypatch.setattr(window, "gather_planes_many", gather)
    monkeypatch.setattr(window, "match_planes_many", match)
    R, P, G = 3, 4, 4
    req = torch.zeros((R, P, G), dtype=torch.int32)
    req[0, 0, 1] = 7
    inbox = pt.TickInbox(req, torch.zeros((R, P, G), dtype=torch.bool),
                         torch.ones(R, dtype=torch.bool))
    for fast, carry in ((False, 4), (True, 8)):
        calls["gather"].clear()
        calls["match"] = 0
        tw = Twin(fast=fast)
        # the eager form of the Twin's tick: its scripted CPU program runs
        # the plain versions inside the program, past these dispatchers
        pt.paxos_tick_impl(tw.t, inbox, tw.own_row, 0, fast_elect=fast)
        assert len(calls["gather"]) == 5 and calls["match"] == 1, calls
        assert calls["gather"][1] == carry, calls
