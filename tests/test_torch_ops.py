"""Ballot/window primitives and the plane-select plain versions of the port
(``gigapaxos_tpu_torch.ops``) against the JAX reference on seeded inputs.

Tolerance: 0.  Every value is int32 or bool; results must be equal.
The CUDA kernels themselves are compared with their plain versions only
where a card is present (``cuda`` marker), and the fused (``_many``) forms
are held to the reference one array at a time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import ballot as jb
from gigapaxos_tpu.ops import window as jw
from gigapaxos_tpu.ops.pallas_gather import (gather_planes_pallas,
                                             match_planes_pallas)
from gigapaxos_tpu_torch.ops import ballot as tb
from gigapaxos_tpu_torch.ops import plane_gather as tpg
from gigapaxos_tpu_torch.ops import window as tw

EDGE = np.array([-2**31, -2**31 + 1, -2, -1, 0, 1, 2, 2**31 - 2, 2**31 - 1],
                np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and keeps
    the parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(rng, shape, lo=-2**31, hi=2**31):
    v = rng.integers(lo, hi, size=shape, dtype=np.int64)
    # salt with values around the int32 wrap
    flat = v.reshape(-1)
    k = min(len(flat), 3 * len(EDGE))
    flat[rng.choice(len(flat), k, replace=False)] = np.resize(EDGE, k)
    return v.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["bal_gt", "bal_ge", "bal_eq", "bal_max"])
def test_ballot_compare_matches_reference(fn):
    rng = np.random.default_rng(1)
    # small ranges so ties on the number and on the coordinator both occur
    an, ac, bn, bc = (rng.integers(-3, 3, (6, 200)).astype(np.int32)
                      for _ in range(4))
    want = getattr(jb, fn)(*(jnp.asarray(x) for x in (an, ac, bn, bc)))
    got = getattr(tb, fn)(*(_t(x) for x in (an, ac, bn, bc)))
    if fn == "bal_max":
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())
    else:
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("fn", ["slot_after", "slot_at_or_after",
                                "bal_consecutive"])
def test_slot_compare_wraps_like_reference(fn):
    rng = np.random.default_rng(2)
    a, b = _i32(rng, (4, 300)), _i32(rng, (4, 300))
    # pairs straddling +-2^31: a just past the wrap, b just before it
    a[0, :9], b[0, :9] = EDGE.astype(np.int32), np.roll(EDGE, 1).astype(np.int32)
    want = getattr(jb, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tb, fn)(_t(a), _t(b))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("W", [1, 4, 8, 12])
def test_window_primitives_match_reference(W):
    rng = np.random.default_rng(W)
    G = 130
    exec_slot = _i32(rng, (3, G))
    ring = 1 << max(0, (W - 1).bit_length())  # ring_index needs a power of 2
    np.testing.assert_array_equal(
        np.asarray(jw.ring_index(jnp.asarray(exec_slot), ring)),
        tw.ring_index(_t(exec_slot), ring).numpy())
    ws_j = np.asarray(jw.window_slots(jnp.asarray(exec_slot), W))
    ws_t = tw.window_slots(_t(exec_slot), W).numpy()
    assert np.array_equal(ws_j, ws_t)
    slots = ws_j + rng.integers(-W, W, ws_j.shape).astype(np.int32)
    assert np.array_equal(
        np.asarray(jw.in_window(jnp.asarray(slots), jnp.asarray(exec_slot), W)),
        tw.in_window(_t(slots), _t(exec_slot), W).numpy())
    valid = rng.random((3, W, G)) < 0.8
    assert np.array_equal(np.asarray(jw.leading_run(jnp.asarray(valid))),
                          tw.leading_run(_t(valid)).numpy())
    payload = _i32(rng, (3, W, G))
    wm = exec_slot + rng.integers(-2, 3, exec_slot.shape).astype(np.int32)
    assert np.array_equal(
        np.asarray(jw.clear_below(jnp.asarray(payload), jnp.asarray(slots),
                                  jnp.asarray(wm), -1)),
        tw.clear_below(_t(payload), _t(slots), _t(wm), -1).numpy())


# the shapes of the reference's own pallas gather tests, plus ragged G
GATHER_SHAPES = [((3,), 8, 8, 256), ((3,), 12, 8, 128), ((), 8, 4, 128),
                 ((2, 3), 8, 8, 256), ((3,), 4, 4, 512), ((3,), 8, 8, 100),
                 ((3,), 8, 8, 4224)]


@pytest.mark.parametrize("lead,wp,j,g", GATHER_SHAPES)
@pytest.mark.parametrize("dtype", ["int32", "bool"])
@pytest.mark.parametrize("perlead", [False, True])
def test_gather_planes_plain_matches_reference(lead, wp, j, g, dtype,
                                               perlead):
    rng = np.random.default_rng(42 + g)
    arr = rng.integers(-999, 999, size=lead + (wp, g)).astype(np.int32)
    if dtype == "bool":
        arr = arr % 2 == 0
    idx_shape = lead + (j, g) if perlead else (j, g)
    idx = rng.integers(0, wp, size=idx_shape).astype(np.int32)
    got = tw.gather_planes(_t(arr), _t(idx)).numpy()
    want = np.take_along_axis(arr, np.broadcast_to(idx, lead + (j, g)),
                              axis=-2)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jw.gather_planes(
        jnp.asarray(arr), jnp.asarray(idx))))
    if g % 128 == 0:  # the pallas kernel's lane tiling needs G % 128 == 0
        pallas = gather_planes_pallas(jnp.asarray(arr), jnp.asarray(idx),
                                      interpret=True)
        assert np.array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("e", [3, 12, 20])
@pytest.mark.parametrize("g", [128, 100])
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_match_planes_plain_matches_reference(e, g, dtype):
    rng = np.random.default_rng(7 + e)
    j = 8
    vals = rng.integers(1, 999, size=(e, g)).astype(np.int32)
    if dtype == "bool":
        vals = vals % 2 == 0
    keys = rng.integers(0, max(2, e // 2), size=(e, g)).astype(np.int32)
    keys[rng.random((e, g)) < 0.3] = -1  # holes
    # duplicate keys per lane on purpose: the highest e must win
    keys[1] = keys[0]
    idx = rng.integers(-1, e, size=(j, g)).astype(np.int32)
    got = tw.match_planes(_t(vals), _t(keys), _t(idx)).numpy()
    want = np.zeros((j, g), vals.dtype)
    for jj in range(j):
        for ee in range(e):
            hit = keys[ee] == idx[jj]
            want[jj][hit] = vals[ee][hit]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jw.match_planes(
        jnp.asarray(vals), jnp.asarray(keys), jnp.asarray(idx))))
    if g % 128 == 0:
        pallas = match_planes_pallas(jnp.asarray(vals), jnp.asarray(keys),
                                     jnp.asarray(idx), interpret=True)
        assert np.array_equal(got, np.asarray(pallas))


def test_plain_gather_out_of_range_index_gives_zero():
    """Out-of-range plane indices give 0, as the Pallas and CUDA kernels do."""
    arr = torch.tensor([[1, 2, 3], [11, 12, 13], [21, 22, 23]],
                       dtype=torch.int32)  # [Wp=3, G=3]
    idx = torch.tensor([[-1, 1, 3]], dtype=torch.int32)
    assert tw.gather_planes(arr, idx).tolist() == [[0, 12, 0]]


def test_cpu_tensors_never_launch_kernels():
    tpg.reset_launches()
    tw.gather_planes(torch.zeros(3, 8, 16, dtype=torch.int32),
                     torch.zeros(8, 16, dtype=torch.int32))
    tw.match_planes(torch.zeros(4, 16, dtype=torch.int32),
                    torch.zeros(4, 16, dtype=torch.int32),
                    torch.zeros(8, 16, dtype=torch.int32))
    assert tpg.launches == {"gather_planes": 0, "match_planes": 0}


# the tick's five gather sets (arrays that share one index) at small size:
# (leading shape, dtypes of the arrays, per-lead index)
R_, W_ = 3, 8
TICK_SETS = {
    "S1": ((R_,), "iiiib", False),
    "S2": ((), "iibb", False),
    "S3": ((R_,), "iiiiibb", False),
    "S4": ((), "ibb", False),
    "S5": ((R_,), "iibb", True),
}
RAGGED_G = [1, 3, 130, 256, 4099]


def _mixed(rng, shape, kinds):
    """One array per letter of ``kinds``: ``i`` int32, ``b`` bool."""
    return [_i32(rng, shape) if c == "i" else rng.random(shape) < 0.5
            for c in kinds]


def _rotation(rng, lead, g):
    """Ring indices as the tick makes them: ``(base + j) & (W - 1)``,
    ``lead + [W, G]``."""
    base = rng.integers(0, 2**30, size=lead + (1, g))
    j = np.arange(W_)[:, None]
    return ((base + j) & (W_ - 1)).astype(np.int32)


@pytest.mark.parametrize("g", RAGGED_G)
@pytest.mark.parametrize("tick_set", sorted(TICK_SETS))
def test_gather_planes_many_plain_matches_reference(tick_set, g):
    lead, kinds, perlead = TICK_SETS[tick_set]
    rng = np.random.default_rng(g + len(kinds))
    arrs = _mixed(rng, lead + (W_, g), kinds)
    idx = _rotation(rng, lead if perlead else (), g)
    got = tw.gather_planes_many([_t(a) for a in arrs], _t(idx))
    assert len(got) == len(arrs)
    for a, out in zip(arrs, got):
        want = np.asarray(jw.gather_planes(jnp.asarray(a), jnp.asarray(idx)))
        out = out.numpy()
        assert out.dtype == want.dtype and np.array_equal(out, want)
        if g % 128 == 0:  # the pallas kernel's lane tiling needs G % 128 == 0
            pallas = gather_planes_pallas(jnp.asarray(a), jnp.asarray(idx),
                                          interpret=True)
            assert np.array_equal(out, np.asarray(pallas))


@pytest.mark.parametrize("g", RAGGED_G)
@pytest.mark.parametrize("kinds", ["i", "ib", "bib", "ibbi"])
def test_match_planes_many_plain_matches_reference(kinds, g):
    rng = np.random.default_rng(3 * g + len(kinds))
    e = R_ * 4  # the tick's intake entries, R * P
    vals = _mixed(rng, (e, g), kinds)
    # ranks of taken entries with -1 holes, a duplicate key per lane
    keys = rng.integers(0, e, size=(e, g)).astype(np.int32)
    keys[rng.random((e, g)) < 0.3] = -1
    keys[1] = keys[0]
    idx = _rotation(rng, (), g)
    got = tw.match_planes_many([_t(v) for v in vals], _t(keys), _t(idx))
    assert len(got) == len(vals)
    for v, out in zip(vals, got):
        want = np.asarray(jw.match_planes(jnp.asarray(v), jnp.asarray(keys),
                                          jnp.asarray(idx)))
        out = out.numpy()
        assert out.dtype == want.dtype and np.array_equal(out, want)
        if g % 128 == 0:
            pallas = match_planes_pallas(jnp.asarray(v), jnp.asarray(keys),
                                         jnp.asarray(idx), interpret=True)
            assert np.array_equal(out, np.asarray(pallas))


@pytest.mark.parametrize("dead", [None, 1])
def test_tick_makes_five_gathers_and_one_match(monkeypatch, dead):
    """One tick calls the fused dispatchers once per set of arrays that
    share an index (5 gathers of 5, 4, 7, 3 and 4 arrays, 1 match of 2) and
    never the one-array forms: on CUDA that is 5 + 1 launches."""
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as pst

    calls = []

    def counting(kind, fn):
        def wrapped(arrs, *rest):
            calls.append((kind, len(arrs)))
            return fn(arrs, *rest)
        return wrapped

    def forbidden(*args):
        raise AssertionError("the tick called a one-array plane select")

    monkeypatch.setattr(tw, "gather_planes_many",
                        counting("gather", tw.gather_planes_many))
    monkeypatch.setattr(tw, "match_planes_many",
                        counting("match", tw.match_planes_many))
    monkeypatch.setattr(tw, "gather_planes", forbidden)
    monkeypatch.setattr(tw, "match_planes", forbidden)
    R, W, P, G = 3, 8, 4, 64
    state = pst.create_groups(pst.init_state(R, G, W, device="cpu"),
                              np.arange(G), np.ones((G, R), bool))
    alive = torch.ones(R, dtype=torch.bool)
    if dead is not None:
        alive[dead] = False
    ticks = 3
    for t in range(ticks):
        inbox = pt.make_inbox(R, G, P, device="cpu")
        req = inbox.req.clone()
        req[0, 0] = 1 + t * G + torch.arange(G, dtype=torch.int32)
        state, _ = pt.paxos_tick_impl(
            state, pt.TickInbox(req, inbox.stop, alive), -1, 0)
    per_tick = [("gather", 5), ("gather", 4), ("match", 2), ("gather", 7),
                ("gather", 3), ("gather", 4)]
    assert calls == per_tick * ticks


@pytest.mark.parametrize("fn,args,err", [
    ("gather_planes_many_cuda", "none", ValueError),
    ("gather_planes_many_cuda", "nine", ValueError),
    ("gather_planes_many_cuda", "cpu", ValueError),
    ("match_planes_many_cuda", "none", ValueError),
    ("match_planes_many_cuda", "five", ValueError),
    ("match_planes_many_cuda", "cpu", ValueError),
])
def test_kernel_wrappers_refuse_what_no_launch_takes(fn, args, err):
    """The wrappers raise (and launch nothing) on CPU tensors and on array
    counts one launch does not take; they never fall back."""
    arr = torch.zeros(8, 16, dtype=torch.int32)
    n = {"none": 0, "nine": 9, "five": 5, "cpu": 1}[args]
    tpg.reset_launches()
    with pytest.raises(err):
        if fn.startswith("gather"):
            getattr(tpg, fn)([arr] * n, arr)
        else:
            getattr(tpg, fn)([arr] * n, arr, arr)
    assert tpg.launches == {"gather_planes": 0, "match_planes": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lead,wp,j,g", GATHER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_gather_planes_kernel_matches_plain(cuda_device, lead, wp, j, g,
                                            dtype):
    gen = torch.Generator().manual_seed(g)
    arr = torch.randint(-999, 999, lead + (wp, g), generator=gen,
                        dtype=torch.int32)
    if dtype == torch.bool:
        arr = arr % 2 == 0
    for idx_shape in ((j, g), lead + (j, g)):
        idx = torch.randint(0, wp, idx_shape, generator=gen,
                            dtype=torch.int32)
        got = tpg.gather_planes_cuda(arr.to(cuda_device),
                                     idx.to(cuda_device)).cpu()
        assert torch.equal(got, tpg.gather_planes_plain(arr, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("e", [3, 12, 20])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_match_planes_kernel_matches_plain(cuda_device, e, dtype):
    gen = torch.Generator().manual_seed(e)
    g, j = 4224, 8
    vals = torch.randint(1, 999, (e, g), generator=gen, dtype=torch.int32)
    if dtype == torch.bool:
        vals = vals % 2 == 0
    keys = torch.randint(-1, e // 2 + 1, (e, g), generator=gen,
                         dtype=torch.int32)
    idx = torch.randint(-1, e, (j, g), generator=gen, dtype=torch.int32)
    got = tpg.match_planes_cuda(vals.to(cuda_device), keys.to(cuda_device),
                                idx.to(cuda_device)).cpu()
    assert torch.equal(got, tpg.match_planes_plain(vals, keys, idx))


def _card_array(shape, dtype, gen, dev, lo=-999, hi=999, offset=False):
    """A seeded array on the card; ``offset`` makes it a contiguous view
    one element into its storage, which no 16-byte vector load may read."""
    src = (torch.randint(0, 2, shape, generator=gen).bool()
           if dtype == torch.bool else
           torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32))
    if not offset:
        return src.to(dev)
    view = torch.empty(src.numel() + 1, dtype=dtype, device=dev)[1:]
    return view.view(shape).copy_(src)


@pytest.mark.cuda
@pytest.mark.parametrize("g", RAGGED_G + [4096])
@pytest.mark.parametrize("k", range(1, 9))
def test_gather_planes_many_kernel_matches_plain(cuda_device, k, g):
    """One launch of k mixed int32/bool arrays against the plain version:
    shared and per-lead index, indices out of [0, Wp), ragged G, and the
    first array as an unaligned view (scalar lanes)."""
    gen = torch.Generator().manual_seed(31 * k + g)
    dts = [(torch.int32, torch.bool)[(i + k) % 2] for i in range(k)]
    for lead, wp, j in (((3,), 8, 8), ((2, 3), 12, 9)):
        for perlead in (False, True):
            for offset in (False, True):
                arrs = [_card_array(lead + (wp, g), d, gen, cuda_device,
                                    offset=offset and i == 0)
                        for i, d in enumerate(dts)]
                idx = _card_array((lead if perlead else ()) + (j, g),
                                  torch.int32, gen, cuda_device, -2, wp + 3)
                got = tpg.gather_planes_many_cuda(arrs, idx)
                want = tpg.gather_planes_many_plain(
                    [a.cpu() for a in arrs], idx.cpu())
                assert len(got) == k
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("g", RAGGED_G + [4096])
@pytest.mark.parametrize("k", range(1, 5))
def test_match_planes_many_kernel_matches_plain(cuda_device, k, g):
    """One launch of k mixed int32/bool vals arrays sharing keys and index
    against the plain version, ragged G and an unaligned first array
    included; duplicate keys, where the highest entry wins."""
    gen = torch.Generator().manual_seed(17 * k + g)
    dts = [(torch.int32, torch.bool)[(i + k) % 2] for i in range(k)]
    for e, j in ((12, 8), (20, 32)):
        for offset in (False, True):
            vals = [_card_array((e, g), d, gen, cuda_device,
                                offset=offset and i == 0)
                    for i, d in enumerate(dts)]
            keys = _card_array((e, g), torch.int32, gen, cuda_device, -1,
                               e // 2)
            idx = _card_array((j, g), torch.int32, gen, cuda_device, -1, e)
            got = tpg.match_planes_many_cuda(vals, keys, idx)
            want = tpg.match_planes_many_plain([v.cpu() for v in vals],
                                               keys.cpu(), idx.cpu())
            assert len(got) == k
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_fused_launch_counts_once(cuda_device):
    arrs = [torch.zeros(3, 8, 64, dtype=d, device=cuda_device)
            for d in (torch.int32, torch.bool, torch.int32)]
    idx = torch.zeros(8, 64, dtype=torch.int32, device=cuda_device)
    tpg.reset_launches()
    tpg.gather_planes_many_cuda(arrs, idx)
    tpg.match_planes_many_cuda([a[0] for a in arrs], idx, idx)
    assert tpg.launches == {"gather_planes": 1, "match_planes": 1}


def test_host_slot_cmp_matches_reference():
    from gigapaxos_tpu import types as jtypes
    from gigapaxos_tpu_torch import types as ttypes

    vals = [int(v) for v in EDGE] + [7, -7, 2**30]
    for a in vals:
        for b in vals:
            assert ttypes.slot_cmp(a, b) == jtypes.slot_cmp(a, b)
    assert ttypes.NO_REQUEST == jtypes.NO_REQUEST
    assert (ttypes.INITIAL_BALLOT_NUM, ttypes.INITIAL_BALLOT_COORD) == \
        (jtypes.INITIAL_BALLOT_NUM, jtypes.INITIAL_BALLOT_COORD)
    assert {s.name: int(s) for s in ttypes.GroupStatus} == \
        {s.name: int(s) for s in jtypes.GroupStatus}
