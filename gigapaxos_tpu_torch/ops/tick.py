"""The fused consensus tick: one step of multi-decree Paxos over every group
at once, as a branch-free dataflow over dense tensors.

  phase 0  coordinator candidacy
  phase 1  prepare / promise + carryover of accepted pvalues
  phase 2  intake + slot assignment, accept, vote tally + quorum
  phase 3  decision sync (laggard catch-up from peers' decision rings)
  phase 4  in-order execution extraction

Message passing is implicit: every cross-replica read is a reduction or
broadcast over the leading replica axis.  All ring windows are
``[R, W, G]`` with G the minor axis; ring reads go through
``window.gather_planes_many`` and intake placement through
``window.match_planes_many``, which launch the hand-written CUDA kernels for
CUDA tensors (``ops/plane_gather.py``; a scripted tick on the CPU runs their
plain versions inside its program).  The arrays that share an index are
gathered in one call: five gathers and one match per tick, with or without
fast re-election (its four extra window-to-ring reads ride the carryover's
launch).

``inbox.alive`` is the failure detector's liveness view.  A dead replica
contributes nothing and its state freezes; flipping it back alive models
crash-recovery with intact local state.  The tick is deterministic given
(state, inbox).

Two optional ``[G]`` folds ride inside the tick: the read-lease columns
(:class:`LeaseState`: grant/renew/expiry and the write fence) and the
group-health columns (:class:`HealthState`: stall age, coordinator churn
and offered-load heat, reduced to an O(K) pack).  Register groups run the
same tick on a second state plane at W=1 (the mixed planes below); one
dispatch body, :func:`paxos_tick_health`, covers every combination of
the two planes and the two folds.

dtype discipline: every reduction that PyTorch would widen to int64 (sum,
cumsum, cumprod over int32 or bool) passes ``dtype=torch.int32``, so every
intermediate keeps the int32 wraparound arithmetic the slot and ballot
comparisons rely on.  The tick never writes its input state: it returns
fresh tensors.

The tick is written in the subset of Python that TorchScript compiles:
:func:`paxos_tick_health` runs it as one scripted program (an eager CPU
tick drops and retakes the interpreter lock at each of its ~640 torch
calls, and waits behind every other busy thread each time), and the eager
entry points run the same functions op by op.  So
the scripted functions spell their constants out (TorchScript takes no
global ints or dtypes) and define every variable on every branch.

A sharded group axis splits the tick between :func:`tick_front` and
:func:`tick_back`, where the shards exchange the exec budget's per-row
counts (``parallel/shard_tick.py``).
"""

import threading
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..paxos.state import PaxosState
from ..types import GroupStatus, NO_REQUEST
from .ballot import bal_ge, bal_gt
from . import plane_gather, window

I32 = torch.int32
BOOL = torch.bool
NEG_INF = -(2**31)
INT32_MAX = 2**31 - 1


class TickInbox(NamedTuple):
    """Per-tick inputs assembled by the host batcher.

    req:   int32 [R, P, G] — new client request ids that arrived at entry
           replica r for group g this tick (0 = empty slot).
    stop:  bool  [R, P, G] — request is a paxos stop (end-of-epoch).
    alive: bool  [R]       — failure-detector liveness per replica slot.
    """

    req: torch.Tensor
    stop: torch.Tensor
    alive: torch.Tensor


class TickOutbox(NamedTuple):
    """Per-tick outputs consumed by the host.

    exec_req:   int32 [R, W, G] — request ids executed this tick, plane j
                holds slot exec_base+j (0 = noop/empty).
    exec_stop:  bool  [R, W, G]
    exec_base:  int32 [R, G]    — first slot executed this tick.
    exec_count: int32 [R, G]    — number of slots executed this tick.
    intake_taken: bool [R, P, G] — which inbox requests got slots.
    coord_id:   int32 [G]       — current effective coordinator (-1 if none).
    decided_now: int32 [G]      — decisions reaching quorum this tick.
    lag:        int32 [R, G]    — how many slots this replica trails the live
                maximum (lag >= W needs a checkpoint transfer).
    donor:      int32 [R, G]    — best live member to copy from for that
                transfer (max post-tick exec over live members other than r,
                ties to the lowest id), or -1 when none is strictly ahead.
    donor_exec: int32 [R, G]    — the donor's post-tick exec watermark.
    donor_status: int32 [R, G]  — the donor's post-tick group status.
    """

    exec_req: torch.Tensor
    exec_stop: torch.Tensor
    exec_base: torch.Tensor
    exec_count: torch.Tensor
    intake_taken: torch.Tensor
    coord_id: torch.Tensor
    decided_now: torch.Tensor
    lag: torch.Tensor
    donor: torch.Tensor
    donor_exec: torch.Tensor
    donor_status: torch.Tensor


def _lexmax(n, c, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic (n, c) max along ``dim`` -> (n*, c*); masked entries
    must already be NEG_INF in ``n``."""
    nmax = n.amax(dim=dim, keepdim=True)
    cmax = torch.where(n == nmax, c, -2147483648).amax(dim=dim)
    return nmax.squeeze(dim), cmax


def _i32sum(x, dim: int):
    return x.sum(dim=dim, dtype=torch.int32)


def _excl_cumsum(x, dim: int):
    """Exclusive int32 prefix count along ``dim`` (x: bool or int32)."""
    xi = x.to(torch.int32)
    return torch.cumsum(xi, dim=dim, dtype=torch.int32) - xi


def _in_range_rows(rows, n: int, dev) -> torch.Tensor:
    """``rows`` as an int64 index on ``dev`` with out-of-range entries
    (batch padding) filtered out: the reference's ``mode="drop"`` scatter,
    which a torch index would refuse (CPU) or trap on (CUDA)."""
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows,
                   np.int64).reshape(-1)
    return torch.as_tensor(r[(r >= 0) & (r < n)], device=dev)


class LeaseState(NamedTuple):
    """Leader-lease columns: dense ``[G]`` lease state folded inside the
    tick, so grant/renew/expiry piggyback on the accept traffic the tick
    already computes.  Time is the lease clock itself (one tick = one
    unit), so lease decisions are a pure function of (state, inbox) and
    journal replay reproduces them bit for bit.

    clock:  int32 []   — lease clock; +1 per tick.
    holder: int32 [G]  — replica id holding the read lease (-1 = none).
    epoch:  int32 [G]  — grant counter; bumps whenever the holder changes.
    until:  int32 [G]  — expiry tick; reads are valid while clock < until.
    margin: int32 [G]  — skew allowance: a DIFFERENT coordinator may not
            admit new writes until ``clock >= until + margin`` (the
            write-side fence).
    """

    clock: torch.Tensor
    holder: torch.Tensor
    epoch: torch.Tensor
    until: torch.Tensor
    margin: torch.Tensor


#: lease_pack row indices (the [5, G] per-plane host summary of a lease
#: tick: one device-to-host copy per plane per tick)
LP_HOLDER, LP_EPOCH, LP_UNTIL, LP_ASN, LP_WAIT = range(5)


def init_lease(n_groups: int, margin_ticks: int = 0,
               device=None) -> LeaseState:
    dev = resolve_device(device)
    return LeaseState(
        clock=torch.zeros((), dtype=I32, device=dev),
        holder=torch.full((n_groups,), -1, dtype=I32, device=dev),
        epoch=torch.zeros((n_groups,), dtype=I32, device=dev),
        until=torch.zeros((n_groups,), dtype=I32, device=dev),
        margin=torch.full((n_groups,), margin_ticks, dtype=I32, device=dev),
    )


def lease_clear_rows(lease: LeaseState, rows) -> LeaseState:
    """Drop leases on ``rows`` in place (row lifecycle: create, remove,
    pause).  Out-of-range rows (padding) are ignored."""
    r = _in_range_rows(rows, lease.holder.shape[0], lease.holder.device)
    lease.holder[r] = -1
    lease.epoch[r] = 0
    lease.until[r] = 0
    return lease


class HealthState(NamedTuple):
    """Group-health columns: dense ``[G]`` per-group health facts folded
    inside the tick, reduced on the device to an O(K) pack.  Observation
    only: nothing here feeds back into consensus, so a health-on run
    journals the same bytes as a health-off run.

    clock:       int32 []  — health clock; +1 per tick.
    last_active: int32 [G] — last tick the group made commit/exec progress
                 or had no backlog; ``clock - last_active`` is the stall age.
    last_coord:  int32 [G] — last effective coordinator observed (-1 until
                 a first election).
    churn:       int32 [G] — decaying coordinator-handoff score, Q4 fixed
                 point (one handoff adds 16; each tick decays by
                 ``1/2**decay_shift`` of the current value).
    heat:        int32 [G] — decaying offered-intake EWMA, Q4 fixed point.
    """

    clock: torch.Tensor
    last_active: torch.Tensor
    last_coord: torch.Tensor
    churn: torch.Tensor
    heat: torch.Tensor


def init_health(n_groups: int, device=None) -> HealthState:
    dev = resolve_device(device)
    return HealthState(
        clock=torch.zeros((), dtype=I32, device=dev),
        last_active=torch.zeros((n_groups,), dtype=I32, device=dev),
        last_coord=torch.full((n_groups,), -1, dtype=I32, device=dev),
        churn=torch.zeros((n_groups,), dtype=I32, device=dev),
        heat=torch.zeros((n_groups,), dtype=I32, device=dev),
    )


def health_clear_rows(health: HealthState, rows) -> HealthState:
    """Reset health columns of freed rows in place: a recycled row must not
    inherit the previous occupant's stall age or churn score.  Out-of-range
    rows (padding) are ignored."""
    r = _in_range_rows(rows, health.heat.shape[0], health.heat.device)
    health.last_active[r] = health.clock
    health.last_coord[r] = -1
    health.churn[r] = 0
    health.heat[r] = 0
    return health


#: health_pack gauge indices (see :class:`HealthLayout`)
(HG_ALLOC, HG_BACKLOG, HG_WEDGED, HG_MAX_STALL, HG_MAX_CHURN,
 HG_LEASE_WAIT) = range(6)
HG_N = 6
#: log2 histogram buckets in the health pack — bucket i holds values with
#: ``int(v).bit_length() == i``; bucket 31 is the overflow tail
HB = 32


def _log2_hist(v, mask):
    """[G] int32 values -> [HB] int32 bucket counts over ``mask`` rows,
    bucketed by bit_length; a masked row with a negative value counts as
    0.  The bit length of a non-negative int32 is the exponent ``frexp``
    returns for it in float64 (exact for every int32), and one [HB, G]
    compare-and-count replaces the reference's 31 threshold count-sums.
    (``torch.bincount`` would size its output from a device-to-host read
    of the maximum, a sync in the middle of the tick; a scatter-add into
    HB bins serializes on its atomics: 0.39 ms at G=917,504 on an H100.)"""
    bits = torch.frexp(torch.clamp(v, min=0).to(torch.float64))[1]
    bucket = torch.where(mask, bits, 32)  # HB: unmasked, never counted
    ar = torch.arange(32, dtype=bits.dtype, device=v.device)
    return _i32sum(bucket[None, :] == ar[:, None], 1)


def _topk_rows(v, allocated, k: int):
    """The reference's f32 ``top_k`` ranking: values clamped at 2^24 (exact
    in f32), unallocated rows at -1, descending, ties to the LOWEST row
    (``torch.topk`` orders ties arbitrarily).  Each (value, row) pair is
    folded into one int64 key, unique per row, so one ``topk`` over the
    keys is exact.  Returns int32 ``(values[k], rows[k])``."""
    val = torch.where(allocated, torch.clamp(v, max=1 << 24), -1)
    rows = torch.arange(v.shape[0], dtype=torch.int64, device=v.device)
    key = ((val.to(torch.int64) + 1) << 32) | (0xFFFFFFFF - rows)
    top = torch.topk(key, k)[0]
    return (((top >> 32) - 1).to(torch.int32),
            (0xFFFFFFFF - (top & 0xFFFFFFFF)).to(torch.int32))


def _health_pack_impl(stall, churn, heat, backlog, allocated, wait_n,
                      wedge_ticks: int, topk: int):
    """Reduce the [G] health columns into the flat int32 host summary
    described by :class:`HealthLayout`: scalar gauges, two log2
    histograms, and the top-K (value, row) columns per anomaly
    criterion."""
    wedged = allocated & (stall >= wedge_ticks)
    gauges = torch.stack([
        _i32sum(allocated, 0),
        _i32sum(backlog, 0),
        _i32sum(wedged, 0),
        torch.where(allocated, stall, 0).amax(),
        torch.where(allocated, churn, 0).amax(),
        wait_n,
    ]).to(torch.int32)
    parts = [gauges, _log2_hist(stall, allocated),
             _log2_hist(churn >> 4, allocated)]
    for v in [stall, churn, heat]:
        top_v, top_r = _topk_rows(v, allocated, topk)
        parts.append(top_v)
        parts.append(top_r)
    return torch.cat(parts)


def _gather(arrs: List[torch.Tensor], idx: torch.Tensor
            ) -> List[torch.Tensor]:
    """The tick's ring gather: the hand kernel through
    ``window.gather_planes_many`` on CUDA and in the eager tick; a scripted
    tick on the CPU runs the plain version inside its own program."""
    if torch.jit.is_scripting() and not arrs[0].is_cuda:
        return plane_gather._take_many(arrs, idx)
    return window.tick_gather(arrs, idx)


def _match(vals_list: List[torch.Tensor], keys: torch.Tensor,
           idx: torch.Tensor) -> List[torch.Tensor]:
    """The tick's intake match, as :func:`_gather`."""
    if torch.jit.is_scripting() and not vals_list[0].is_cuda:
        return plane_gather._match_many(vals_list, keys, idx)
    return window.tick_match(vals_list, keys, idx)


class TickMid(NamedTuple):
    """What the tick's first half (phases 0-4 up to the execution mask)
    hands its second half (the exec budget, execution, freeze, outbox and
    the lease and health folds).  The tick splits there because a sharded
    group axis exchanges the exec budget's per-row counts between the
    halves (``parallel/shard_tick.py``); unsharded, both halves run back
    to back in one program.

    ``st`` is the state after phases 0-3 (``exec_slot`` and ``status``
    still the tick's input).  The lease fields are None without a lease."""

    st: PaxosState
    exec_mask: torch.Tensor  # bool [R, W, G], before the exec budget
    d_req: torch.Tensor      # int32 [R, W, G]: decisions in exec order
    d_stop: torch.Tensor     # bool [R, W, G]
    has_coord: torch.Tensor  # bool [G]
    w_c: torch.Tensor        # int32 [G]: the effective coordinator
    decided_now: torch.Tensor  # int32 [G]
    intake_taken: torch.Tensor  # bool [R, P, G]
    base_serve: torch.Tensor    # int32 [G]
    lclock: Optional[torch.Tensor]
    lease_expired: Optional[torch.Tensor]
    lease_wait: Optional[torch.Tensor]


def _alive_at(ids, alive):
    """Liveness lookup by node id (-1 -> False)."""
    out = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for r in range(alive.shape[0]):
        out = torch.where(ids == r, alive[r], out)
    return out


def tick_front(state: PaxosState, inbox: TickInbox, own_row: int = -1,
               fast_elect: bool = False,
               lease: Optional[LeaseState] = None) -> TickMid:
    """Phases 0-4 of the tick up to the in-order execution mask (see
    :func:`paxos_tick_impl`): 4 gathers and the match of the tick's 5 + 1
    kernel calls."""
    R, G = state.exec_slot.shape
    W = state.acc_req.shape[1]
    P = inbox.req.shape[1]
    RP = R * P
    Wm = W - 1
    NEG = -2147483648  # NEG_INF: TorchScript takes no global constants
    dev = state.exec_slot.device

    alive = inbox.alive
    r_idx = torch.arange(R, dtype=torch.int32, device=dev)[:, None]  # [R, 1]
    if own_row >= 0:
        own2 = r_idx == own_row
    else:
        own2 = torch.ones((R, 1), dtype=torch.bool, device=dev)
    member = state.member  # [R, G] bool
    is_active = state.status == 1  # GroupStatus.ACTIVE
    acc_ok = member & alive[:, None] & is_active  # live active member
    # serve_ok: may serve decisions from its ring even after STOPPED, so a
    # laggard that missed the stop decision can still learn it
    serve_ok = member & alive[:, None] & (state.status != 0)  # not FREE
    maj = torch.div(state.n_members, 2, rounding_mode="floor") + 1  # [G]
    r_full = r_idx.expand(R, G)

    # common window base: max exec slot among live members
    exec_rel = torch.where(acc_ok, state.exec_slot, NEG)
    any_live = acc_ok.any(dim=0)
    base = torch.where(any_live, exec_rel.amax(dim=0), 0)  # [G]
    base_serve = torch.where(
        serve_ok.any(dim=0),
        torch.where(serve_ok, state.exec_slot, NEG).amax(dim=0),
        0,
    )
    jw = torch.arange(W, dtype=torch.int32, device=dev)[:, None]  # [W, 1]
    s_j = base[None, :] + jw  # [W, G] absolute slots, window order
    i_j = torch.bitwise_and(s_j, Wm)  # [W, G] ring indices

    # ---------------- phase 0: candidacy ----------------
    coord_dead = ~_alive_at(state.bal_coord, alive)
    caught_up = (state.exec_slot - base[None, :]) >= 0
    cand_ok = acc_ok & caught_up
    first_live = torch.argmax(cand_ok.to(torch.int32), dim=0).to(
        torch.int32)  # first max
    im_cand = (r_idx == first_live[None, :]) & cand_ok
    have_auth = (state.coord_active | state.coord_preparing) & bal_ge(
        state.coord_bnum, r_idx, state.bal_num, state.bal_coord
    )
    start_any = im_cand & coord_dead & ~have_auth & own2
    fast_start = start_any  # rebound below when fast_elect
    if fast_elect:
        # consecutive-ballot takeover: my promise is already the group max
        # over member rows (mirrors only ever under-report), so the ballot
        # below is the predecessor's immediate successor: skip prepare
        gmax_bn = torch.where(member, state.bal_num, NEG).amax(dim=0)
        consec = (state.bal_num == gmax_bn[None, :]) & (
            state.bal_num >= state.coord_bnum)
        fast_start = start_any & consec
        start_prep = start_any & ~consec
    else:
        start_prep = start_any
    coord_bnum = torch.where(
        start_any,
        torch.maximum(state.bal_num, state.coord_bnum) + 1,
        state.coord_bnum,
    )
    coord_preparing = state.coord_preparing | start_prep
    coord_active = state.coord_active
    coord_fast = state.coord_fast

    # ---------------- phase 1: prepare / promise / carryover ----------------
    prep_mask = coord_preparing & acc_ok
    pn = torch.where(prep_mask, coord_bnum, NEG)
    best_pn, best_pc = _lexmax(pn, r_full, 0)  # [G]
    upgrade = (
        acc_ok
        & own2
        & (best_pn[None, :] != NEG)
        & bal_gt(best_pn[None, :], best_pc[None, :], state.bal_num,
                 state.bal_coord)
    )
    bal_num = torch.where(upgrade, best_pn[None, :], state.bal_num)
    bal_coord = torch.where(upgrade, best_pc[None, :], state.bal_coord)
    if fast_elect:
        # a fast winner promises its own new ballot at once
        bal_num = torch.where(fast_start, coord_bnum, bal_num)
        bal_coord = torch.where(fast_start, r_full, bal_coord)

    # promise match[r1, r2, g]: acceptor r2's promised ballot == candidate r1's
    match = (
        prep_mask[:, None, :]
        & acc_ok[None, :, :]
        & (bal_num[None, :, :] == coord_bnum[:, None, :])
        & (bal_coord[None, :, :] == r_idx[:, :, None])
    )
    promises = _i32sum(match, 1)  # [R, G]
    won = prep_mask & (promises >= maj[None, :]) & own2  # <= 1 winner per g

    # every replica's accepted window at the common base ring indices
    a_bnum, a_bcoord, a_req, a_slot, a_stop = _gather(
        [state.acc_bnum, state.acc_bcoord, state.acc_req, state.acc_slot,
         state.acc_stop], i_j)
    acc_here = (a_slot == s_j[None, :, :]) & (a_bnum >= 0)  # [R, W, G]

    # carryover: among the winner's promisers, max-ballot accepted pvalue
    promiser = (won[:, None, :] & match).any(dim=0)  # [R, G]
    # the adoption rule's source and the fast flags; rebound when fast_elect
    fast_any = won.any(dim=0)
    m_n, m_c, m_req, m_stop = s_j, s_j, s_j, won
    if fast_elect:
        # a fast winner has no promisers: its carryover source is every
        # member row of its mirrors (a stale mirror under-reports, which
        # only shortens the seeded prefix)
        fast_any = fast_start.any(dim=0)  # [G]
        sel_rows = torch.where(fast_any[None, :], member, promiser)
        eff = sel_rows[:, None, :] & acc_here
        # the adoption rule's source (phase 2a): the max-ballot accepted
        # pvalue per window slot over member rows, pre-tick facts only
        vis = member[:, None, :] & acc_here
        m_n, m_c = _lexmax(torch.where(vis, a_bnum, NEG), a_bcoord, 0)
        m_sel = vis & (a_bnum == m_n[None]) & (a_bcoord == m_c[None])
        m_req = torch.where(m_sel, a_req, 0).amax(dim=0)  # [W, G]
        m_stop = (m_sel & a_stop).any(dim=0)
    else:
        eff = promiser[:, None, :] & acc_here
    c_n, c_c = _lexmax(torch.where(eff, a_bnum, NEG), a_bcoord, 0)
    c_exists = eff.any(dim=0)
    sel = eff & (a_bnum == c_n[None]) & (a_bcoord == c_c[None])
    c_req = torch.where(sel, a_req, 0).amax(dim=0)
    c_stop = (sel & a_stop).any(dim=0)
    # noop-fill gaps below the highest carried slot so later slots commit
    hi = torch.where(c_exists, jw, -1).amax(dim=0)  # [G], -1 if none
    if fast_elect:
        # a fast winner also covers the predecessor's visible assignment
        # frontier (max member next_slot), capped at the ring's capacity:
        # slots assigned but unseen get noop proposals instead of gaps
        next_mem = torch.where(member, state.next_slot, NEG).amax(dim=0)
        fast_next = torch.minimum(torch.maximum(base + hi + 1, next_mem),
                                  base + W)  # [G]
        hi_eff = torch.where(fast_any, fast_next - base - 1, hi)
        ns_win = torch.where(fast_any, fast_next, base + hi + 1)
        c_valid = jw <= hi_eff[None, :]
    else:
        ns_win = base + hi + 1
        c_valid = jw <= hi[None, :]  # [W, G] window order
    # window order -> ring order: ring plane i holds window offset (i-base)%W
    j_of_i = torch.bitwise_and(jw - base[None, :], Wm)  # [W, G]
    ad_req, ad_stop, ad_n, ad_c = s_j, won, s_j, s_j  # rebound when fast
    if fast_elect:
        # the adoption rule's four ring reads share j_of_i: one launch
        (co_req, co_stop, co_valid, co_slot, ad_req, ad_stop, ad_n,
         ad_c) = _gather(
            [c_req, c_stop, c_valid, s_j, m_req, m_stop, m_n, m_c], j_of_i)
        won_any = won | fast_start
    else:
        co_req, co_stop, co_valid, co_slot = _gather(
            [c_req, c_stop, c_valid, s_j], j_of_i)
        won_any = won
    won3 = won_any[:, None, :]
    prop_req = torch.where(won3, co_req[None], state.prop_req)
    prop_slot = torch.where(won3, co_slot[None], state.prop_slot)
    prop_valid = torch.where(won3, co_valid[None], state.prop_valid)
    prop_stop = torch.where(won3, co_stop[None], state.prop_stop)
    next_slot = torch.where(won_any, ns_win[None, :], state.next_slot)

    coord_active = coord_active | won_any
    coord_preparing = coord_preparing & ~won
    if fast_elect:
        coord_fast = (coord_fast | fast_start) & ~won
    # retirement: somebody holds a promise above my ballot (preemption)
    pm_n, pm_c = _lexmax(
        torch.where(acc_ok, bal_num, NEG),
        torch.where(acc_ok, bal_coord, NEG), 0)
    retire = bal_gt(pm_n[None, :], pm_c[None, :], coord_bnum, r_idx)
    coord_active = coord_active & ~retire
    coord_preparing = coord_preparing & ~retire
    if fast_elect:
        coord_fast = coord_fast & ~retire
    prop_valid = prop_valid & ~retire[:, None, :]

    # ---------------- phase 2a: intake + slot assignment ----------------
    an = torch.where(coord_active & acc_ok, coord_bnum, NEG)
    w_n, w_c = _lexmax(an, r_full, 0)  # [G]
    has_coord = w_n != NEG
    is_win = (r_idx == w_c[None, :]) & has_coord[None, :] & own2  # [R, G]

    req_flat = inbox.req.reshape(RP, G)
    stop_flat = inbox.stop.reshape(RP, G)
    src_alive = alive[:, None, None].expand(R, P, G).reshape(RP, G)
    group_open = has_coord & (is_win & is_active).any(dim=0)
    lclock: Optional[torch.Tensor] = None
    lease_expired: Optional[torch.Tensor] = None
    lease_wait: Optional[torch.Tensor] = None
    if lease is not None:
        # lease write fence: a coordinator that is not the lease holder
        # admits no new write until the prior lease expired past its skew
        # margin; already-assigned proposals keep pushing (the holder's
        # frontier covers them)
        lclock_t = lease.clock + 1
        expired_t = lclock_t >= lease.until + lease.margin
        fence_ok = (lease.holder < 0) | (lease.holder == w_c) | expired_t
        lease_wait = group_open & ~fence_ok
        group_open = group_open & fence_ok
        lclock = lclock_t
        lease_expired = expired_t
    valid_in = (req_flat != 0) & src_alive & group_open[None, :]
    # FIFO admission without a sort: rank each valid entry by prefix count
    p_rank = _excl_cumsum(valid_in, 0)  # [RP, G] rank among valid
    k_total = _i32sum(valid_in, 0)  # [G]
    w_next = _i32sum(torch.where(is_win, next_slot, 0), 0)  # [G]
    w_exec = _i32sum(torch.where(is_win, state.exec_slot, 0), 0)
    space = torch.clamp(W - (w_next - w_exec), min=0)
    k = torch.minimum(k_total, space)  # [G]
    # stop fencing: nothing may be proposed after a taken stop
    taken_pre = valid_in & (p_rank < k[None, :])
    stop_taken = stop_flat & taken_pre
    stop_before = _excl_cumsum(stop_taken, 0)
    taken_flat = taken_pre & (stop_before == 0)  # [RP, G] index order
    k = _i32sum(taken_flat, 0)
    # rank among TAKEN entries == p_rank; non-taken entries leave the match
    q_key = torch.where(taken_flat, p_rank, -1)

    ji = torch.bitwise_and(jw - w_next[None, :], Wm)  # [W, G]
    new_at_i = ji < k[None, :]  # ring planes receiving new proposals
    nreq_i, nstop_i = _match([req_flat, stop_flat], q_key,
                                               ji)
    nslot_i = w_next[None, :] + ji
    wmask = is_win[:, None, :] & new_at_i[None, :, :]
    prop_req = torch.where(wmask, nreq_i[None], prop_req)
    prop_stop = torch.where(wmask, nstop_i[None], prop_stop)
    prop_slot = torch.where(wmask, nslot_i[None], prop_slot)
    prop_valid = prop_valid | wmask
    next_slot = torch.where(is_win, w_next[None, :] + k[None, :], next_slot)

    intake_taken = taken_flat.reshape(R, P, G)
    if fast_elect:
        # fast-coordinator adoption + consecutive bump: a proposal seeded
        # from stale mirrors may conflict with a higher-ballot accepted
        # value visible now.  Adopt the max-ballot accepted value strictly
        # below my ballot where it differs, and bump my ballot by one per
        # affected group (two values under one ballot would corrupt the
        # per-ballot tally; +1 keeps the reign consecutive, hence fast).
        # The window slot of ring plane i is to_ring(s_j) = co_slot.
        fastc = coord_fast & coord_active & own2  # [R, G]
        below = bal_gt(coord_bnum[:, None, :], r_idx[:, :, None],
                       ad_n[None], ad_c[None])
        adoptp = (
            fastc[:, None, :]
            & prop_valid
            & (ad_n[None] != NEG)
            & (prop_slot == co_slot[None])
            & below
            & (prop_req != ad_req[None])
        )
        prop_req = torch.where(adoptp, ad_req[None], prop_req)
        prop_stop = torch.where(adoptp, ad_stop[None], prop_stop)
        any_adopt = adoptp.any(dim=1)  # [R, G]
        coord_bnum = torch.where(any_adopt, coord_bnum + 1, coord_bnum)

    # ---------------- phase 2b: accept ----------------
    pushing = (coord_active & acc_ok)[:, None, :] & prop_valid  # [R, W, G]
    cand_n = torch.where(pushing, coord_bnum[:, None, :], NEG)
    cand_c = r_idx[:, :, None].expand(R, W, G)
    b_n, b_c = _lexmax(cand_n, cand_c, 0)  # [W, G] best pushed ballot
    psel = pushing & (cand_n == b_n[None]) & (cand_c == b_c[None])
    p_req = torch.where(psel, prop_req, 0).amax(dim=0)
    p_slot = torch.where(psel, prop_slot, NEG).amax(dim=0)
    p_stop = (psel & prop_stop).any(dim=0)
    exists = b_n != NEG

    d = p_slot[None, :, :] - state.exec_slot[:, None, :]  # [R, W, G]
    in_win = (d >= 0) & (d < W)
    acceptable = (
        exists[None]
        & in_win
        & bal_ge(b_n[None], b_c[None], bal_num[:, None, :],
                 bal_coord[:, None, :])
        & acc_ok[:, None, :]
        & own2[:, :, None]
    )
    conflict = acceptable  # rebound when fast_elect
    if fast_elect:
        # conflict refusal: a push under a fast ballot never overwrites a
        # DIFFERENT accepted value (the fast reign collected no promises);
        # the refusal still promises, so the coordinator can prove it
        src_fast = (psel & coord_fast[:, None, :]).any(dim=0)  # [W, G]
        conflict = (
            (state.acc_slot == p_slot[None])
            & (state.acc_bnum >= 0)
            & (state.acc_req != p_req[None])
            & src_fast[None]
        )  # [R, W, G]
        refused = acceptable & conflict
        acceptable = acceptable & ~conflict
        pr_mask = acceptable | refused
    else:
        pr_mask = acceptable
    # a pvalue for slot p_slot sits on its own ring plane already
    # (proposals are ring-indexed by slot), so accept in place
    acc_bnum = torch.where(acceptable, b_n[None], state.acc_bnum)
    acc_bcoord = torch.where(acceptable, b_c[None], state.acc_bcoord)
    acc_req = torch.where(acceptable, p_req[None], state.acc_req)
    acc_slot = torch.where(acceptable, p_slot[None], state.acc_slot)
    acc_stop = torch.where(acceptable, p_stop[None], state.acc_stop)
    # promise-on-accept (accepting raises the promised ballot)
    ab_n, ab_c = _lexmax(
        torch.where(pr_mask, b_n[None], NEG),
        torch.where(pr_mask, b_c[None], NEG), 1)  # [R, G]
    raise_p = (ab_n != NEG) & bal_gt(ab_n, ab_c, bal_num, bal_coord)
    bal_num = torch.where(raise_p, ab_n, bal_num)
    bal_coord = torch.where(raise_p, ab_c, bal_coord)
    if fast_elect:
        # liveness escape: a refusal PROVEN in my mirrors (a member's
        # promise at/above my pushed ballot while a conflicting lower
        # value stays accepted) demotes me to a full prepare at the next
        # ballot, which is always safe
        seen_refusal = (
            conflict
            & member[:, None, :]
            & bal_ge(bal_num[:, None, :], bal_coord[:, None, :],
                     b_n[None], b_c[None])
        )
        ref_plane = seen_refusal.any(dim=0)  # [W, G]
        mine = b_c[None] == r_idx[:, :, None]  # [R, W, G] my push planes
        demote = (coord_fast & coord_active & own2
                  & (ref_plane[None] & mine).any(dim=1))
        coord_active = coord_active & ~demote
        coord_fast = coord_fast & ~demote
        coord_preparing = coord_preparing | demote
        coord_bnum = torch.where(demote, coord_bnum + 1, coord_bnum)

    # ---------------- phase 2c: tally + quorum ----------------
    (A_bnum, A_bcoord, A_req, A_slot, A_stop, D_slot,
     D_valid) = _gather(
        [acc_bnum, acc_bcoord, acc_req, acc_slot, acc_stop, state.dec_slot,
         state.dec_valid], i_j)
    voteable = (A_slot == s_j[None]) & (A_bnum >= 0) & acc_ok[:, None, :]
    B_n, B_c = _lexmax(torch.where(voteable, A_bnum, NEG), A_bcoord, 0)
    votes = voteable & (A_bnum == B_n[None]) & (A_bcoord == B_c[None])
    cnt = _i32sum(votes, 0)  # [W, G]
    decided = (cnt >= maj[None, :]) & (B_n != NEG)  # window order
    v_req = torch.where(votes, A_req, 0).amax(dim=0)
    v_stop = (votes & A_stop).any(dim=0)
    already = ((D_slot == s_j[None]) & D_valid).any(dim=0)  # [W, G]
    decided_now = _i32sum(decided & ~already, 0)  # [G]

    de_req, de_stop, de_valid = _gather(
        [v_req, v_stop, decided], j_of_i)
    # the reference gathers to_ring(s_j) a second time here; s_j and j_of_i
    # have not changed since phase 1, so the values equal co_slot's
    de_slot = co_slot
    # write decisions, but never clobber a laggard's undelivered ring
    rel_w = de_slot[None] - state.exec_slot[:, None, :]
    dwrite = de_valid[None] & (rel_w >= 0) & (rel_w < W) & acc_ok[:, None, :]
    dec_req = torch.where(dwrite, de_req[None], state.dec_req)
    dec_slot = torch.where(dwrite, de_slot[None], state.dec_slot)
    dec_stop = torch.where(dwrite, de_stop[None], state.dec_stop)
    dec_valid = dwrite | state.dec_valid

    # ---------------- phase 3: decision sync (laggard catch-up) ----------------
    rel = torch.where(dec_valid & serve_ok[:, None, :],
                      dec_slot - base[None, None, :], NEG)
    rel_best = rel.amax(dim=0)  # [W, G]
    sel_l = rel == rel_best[None]
    l_req = torch.where(sel_l, dec_req, 0).amax(dim=0)
    l_stop = (sel_l & dec_stop).any(dim=0)
    l_slot = rel_best + base[None, :]  # [W, G] absolute
    have = dec_valid & (dec_slot == l_slot[None])
    d2 = l_slot[None] - state.exec_slot[:, None, :]
    adopt = (
        (rel_best[None] != NEG)
        & (d2 >= 0)
        & (d2 < W)
        & ~have
        & acc_ok[:, None, :]
    )
    dec_req = torch.where(adopt, l_req[None], dec_req)
    dec_slot = torch.where(adopt, l_slot[None], dec_slot)
    dec_stop = torch.where(adopt, l_stop[None], dec_stop)
    dec_valid = adopt | dec_valid

    # ---------------- phase 4: in-order execution ----------------
    s_own = state.exec_slot[:, None, :] + jw[None]  # [R, W, G]
    i_own = torch.bitwise_and(s_own, Wm)
    Dreq, Dslot, Dstop, Dval = _gather(
        [dec_req, dec_slot, dec_stop, dec_valid], i_own)
    ready = Dval & (Dslot == s_own) & acc_ok[:, None, :]
    run = torch.cumprod(ready.to(torch.int32), dim=1,
                        dtype=torch.int32).to(torch.bool)
    stop_hit = run & Dstop
    exec_mask = run & (_excl_cumsum(stop_hit, 1) == 0)

    mid = PaxosState(
        exec_slot=state.exec_slot, bal_num=bal_num, bal_coord=bal_coord,
        status=state.status, acc_bnum=acc_bnum, acc_bcoord=acc_bcoord,
        acc_req=acc_req, acc_slot=acc_slot, acc_stop=acc_stop,
        dec_req=dec_req, dec_slot=dec_slot, dec_valid=dec_valid,
        dec_stop=dec_stop, coord_active=coord_active,
        coord_preparing=coord_preparing, coord_fast=coord_fast,
        coord_bnum=coord_bnum, next_slot=next_slot, prop_req=prop_req,
        prop_slot=prop_slot, prop_valid=prop_valid, prop_stop=prop_stop,
        member=state.member, n_members=state.n_members, epoch=state.epoch)
    return TickMid(mid, exec_mask, Dreq, Dstop, has_coord, w_c, decided_now,
                   intake_taken, base_serve, lclock, lease_expired,
                   lease_wait)


def exec_row_counts(exec_mask):
    """``[W, R]`` counts of a tick's would-be executions per (j, r) row of
    the exec budget's (j, r, g) ranking: what a group shard hands the
    others in the rank exchange."""
    return _i32sum(exec_mask.transpose(0, 1), 2)


def tick_back(state: PaxosState, inbox: TickInbox, m: TickMid,
              exec_budget: int = 0, rank_base: Optional[torch.Tensor] = None,
              fast_elect: bool = False, lease: Optional[LeaseState] = None,
              lease_horizon: int = 0, health: Optional[HealthState] = None,
              wedge_ticks: int = 32, health_decay_shift: int = 6,
              health_topk: int = 8
              ) -> Tuple[PaxosState, TickOutbox, Optional[LeaseState],
                         Optional[torch.Tensor], Optional[HealthState],
                         Optional[torch.Tensor]]:
    """The tick's second half: the exec budget, execution, the freeze of
    dead replicas, the outbox with its laggard summary, and the lease and
    health folds.  Returns ``(state, outbox, lease, lease_pack, health,
    health_pack)`` with None for an absent fold.

    ``rank_base`` (``[W, R]``, a sharded group axis only): the executions
    ranked before each (j, r) row of this shard's block, over every row
    before it and the same row on earlier shards; None ranks the block as
    the whole group axis."""
    R, G = state.exec_slot.shape
    W = state.acc_req.shape[1]
    dev = state.exec_slot.device
    NEG = -2147483648
    alive = inbox.alive
    member = state.member
    r_full = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(
        R, G)
    exec_mask = m.exec_mask
    if exec_budget > 0:
        # global budget: rank would-be executions in (j, r, g) order and
        # keep the first exec_budget (per-group run prefixes survive)
        em_t = exec_mask.transpose(0, 1).reshape(-1)  # (j, r, g) order
        rank = _excl_cumsum(em_t, 0).reshape(W, R, G)
        if rank_base is not None:
            # G is one shard's block of the group axis: rebase the local
            # (j, r, g) rank onto the global one (the count before this
            # (j, r) row, on every shard, plus the same row on earlier
            # shards), exact, so budget decisions equal the unsharded tick
            blk = exec_row_counts(exec_mask).reshape(-1)
            row_start = (torch.cumsum(blk, 0, dtype=torch.int32)
                         - blk).reshape(W, R)
            rank = rank + (rank_base - row_start)[:, :, None]
        exec_mask = exec_mask & (rank.transpose(0, 1) < exec_budget)
    Dreq, Dstop = m.d_req, m.d_stop
    n_exec = _i32sum(exec_mask, 1)  # [R, G]
    exec_req_out = torch.where(exec_mask, Dreq, 0)  # NO_REQUEST
    exec_stop_out = exec_mask & Dstop
    exec_base = state.exec_slot
    exec_slot = state.exec_slot + n_exec
    stopped_now = (exec_mask & Dstop).any(dim=1)
    status = torch.where(stopped_now, 2, state.status)  # STOPPED

    mid = m.st
    # coordinator GC: stop pushing proposals already executed locally
    prop_valid = mid.prop_valid & (mid.prop_slot - exec_slot[:, None, :] >= 0)

    # ---------------- freeze dead replica slots ----------------
    al3 = alive[:, None, None]
    al2 = alive[:, None]
    if fast_elect:
        coord_fast = torch.where(al2, mid.coord_fast, state.coord_fast)
    else:
        coord_fast = state.coord_fast.clone()
    new_state = PaxosState(
        exec_slot=torch.where(al2, exec_slot, state.exec_slot),
        bal_num=torch.where(al2, mid.bal_num, state.bal_num),
        bal_coord=torch.where(al2, mid.bal_coord, state.bal_coord),
        status=torch.where(al2, status, state.status),
        acc_bnum=torch.where(al3, mid.acc_bnum, state.acc_bnum),
        acc_bcoord=torch.where(al3, mid.acc_bcoord, state.acc_bcoord),
        acc_req=torch.where(al3, mid.acc_req, state.acc_req),
        acc_slot=torch.where(al3, mid.acc_slot, state.acc_slot),
        acc_stop=torch.where(al3, mid.acc_stop, state.acc_stop),
        dec_req=torch.where(al3, mid.dec_req, state.dec_req),
        dec_slot=torch.where(al3, mid.dec_slot, state.dec_slot),
        dec_valid=torch.where(al3, mid.dec_valid, state.dec_valid),
        dec_stop=torch.where(al3, mid.dec_stop, state.dec_stop),
        coord_active=torch.where(al2, mid.coord_active, state.coord_active),
        coord_preparing=torch.where(al2, mid.coord_preparing,
                                    state.coord_preparing),
        coord_fast=coord_fast,
        coord_bnum=torch.where(al2, mid.coord_bnum, state.coord_bnum),
        next_slot=torch.where(al2, mid.next_slot, state.next_slot),
        prop_req=torch.where(al3, mid.prop_req, state.prop_req),
        prop_slot=torch.where(al3, mid.prop_slot, state.prop_slot),
        prop_valid=torch.where(al3, prop_valid, state.prop_valid),
        prop_stop=torch.where(al3, mid.prop_stop, state.prop_stop),
        member=state.member, n_members=state.n_members, epoch=state.epoch,
    )
    # ------------- laggard repair control summary (donor selection) --------
    # donor for laggard r = argmax post-tick exec over live members m != r,
    # ties to the lowest m: top-2 over the replica axis.
    post_exec = new_state.exec_slot
    d_cand = torch.where(member & alive[:, None], post_exec, NEG)
    t1_exec, t1_nid = _lexmax(d_cand, -r_full, 0)  # [G]
    t2_exec, t2_nid = _lexmax(
        torch.where(r_full == -t1_nid[None, :], NEG, d_cand), -r_full, 0)
    self_best = r_full == -t1_nid[None, :]
    d_exec = torch.where(self_best, t2_exec[None, :], t1_exec[None, :])
    d_id = torch.where(self_best, -t2_nid[None, :], -t1_nid[None, :])
    # a transfer only helps when the donor is STRICTLY ahead
    d_ok = d_exec > post_exec
    d_status = torch.gather(new_state.status, 0,
                            d_id.clamp(0, R - 1).to(torch.int64))
    has_coord, w_c = m.has_coord, m.w_c
    outbox = TickOutbox(
        exec_req=torch.where(al3, exec_req_out, 0),
        exec_stop=al3 & exec_stop_out,
        exec_base=exec_base,
        exec_count=torch.where(al2, n_exec, 0),
        intake_taken=m.intake_taken,
        coord_id=torch.where(has_coord, w_c, -1),
        decided_now=m.decided_now,
        lag=torch.where(
            member & (state.status != 0),
            torch.clamp(m.base_serve[None, :] - exec_slot, min=0),
            0,
        ),
        donor=torch.where(d_ok, d_id, -1),
        donor_exec=torch.where(d_ok, d_exec, 0),
        donor_status=torch.where(d_ok, d_status, 0),
    )
    new_lease: Optional[LeaseState] = None
    lease_pack: Optional[torch.Tensor] = None
    lease_wait = m.lease_wait
    if lease is not None:
        lclock = m.lclock
        lease_expired = m.lease_expired
        assert lclock is not None and lease_expired is not None
        assert lease_wait is not None
        # grant/renew: the effective winner renews by staying the winner;
        # a grant needs the previous lease gone (never held, or expired
        # past its margin)
        renew = has_coord & (lease.holder == w_c)
        grant = has_coord & ~renew & ((lease.holder < 0) | lease_expired)
        l_holder = torch.where(grant, w_c, lease.holder)
        l_epoch = torch.where(grant, lease.epoch + 1, lease.epoch)
        l_until = torch.where(renew | grant, lclock + lease_horizon,
                              lease.until)
        # accepted frontier: max assigned slot over MEMBER rows (dead
        # included); a read is local only when the holder executed it all
        asn = torch.where(member, new_state.next_slot, 0).amax(dim=0)
        lease_pack = torch.stack([l_holder, l_epoch, l_until, asn,
                                  lease_wait.to(torch.int32)])
        new_lease = LeaseState(lclock, l_holder, l_epoch, l_until,
                               lease.margin)
    new_health: Optional[HealthState] = None
    health_pack: Optional[torch.Tensor] = None
    if health is not None:
        # health fold: read-only w.r.t. consensus.  Backlog = offered
        # intake, an assignment frontier ahead of the exec frontier, or an
        # unresolved election (the quorum-lost case)
        hclock = health.clock + 1
        allocated = member.any(dim=0)
        offered_in = inbox.req.reshape(-1, G) != 0
        offered = offered_in.any(dim=0)
        asn_h = torch.where(member, new_state.next_slot, 0).amax(dim=0)
        done_h = torch.where(member, new_state.exec_slot, 0).amax(dim=0)
        electing = (member & alive[:, None]
                    & new_state.coord_preparing).any(dim=0)
        backlog = (offered | (asn_h > done_h) | electing) & allocated
        progress = (m.decided_now > 0) | (n_exec.amax(dim=0) > 0)
        h_last_active = torch.where(progress | ~backlog, hclock,
                                    health.last_active)
        # churn counts real handoffs only: a first election is not churn
        w_eff = torch.where(has_coord, w_c, -1)
        handoff = has_coord & (health.last_coord >= 0) & (
            w_eff != health.last_coord)
        h_last_coord = torch.where(has_coord, w_eff, health.last_coord)
        sh = health_decay_shift
        h_churn = (health.churn - (health.churn >> sh)
                   + (handoff.to(torch.int32) << 4))
        h_heat = (health.heat - (health.heat >> sh)
                  + (_i32sum(offered_in, 0) << 4))
        stall = torch.where(allocated & backlog, hclock - h_last_active, 0)
        if lease_wait is not None:
            wait_n = _i32sum(lease_wait, 0)
        else:
            wait_n = torch.zeros((), dtype=torch.int32, device=dev)
        health_pack = _health_pack_impl(
            stall, h_churn, h_heat, backlog, allocated, wait_n,
            wedge_ticks, health_topk)
        new_health = HealthState(hclock, h_last_active, h_last_coord,
                                 h_churn, h_heat)
    return new_state, outbox, new_lease, lease_pack, new_health, health_pack


def tick_core(state: PaxosState, inbox: TickInbox, own_row: int = -1,
              exec_budget: int = 0, fast_elect: bool = False,
              lease: Optional[LeaseState] = None, lease_horizon: int = 0,
              health: Optional[HealthState] = None, wedge_ticks: int = 32,
              health_decay_shift: int = 6, health_topk: int = 8
              ) -> Tuple[PaxosState, TickOutbox, Optional[LeaseState],
                         Optional[torch.Tensor], Optional[HealthState],
                         Optional[torch.Tensor]]:
    """Both halves of one unsharded tick, with fixed-arity results (see
    :func:`tick_back`)."""
    m = tick_front(state, inbox, own_row, fast_elect, lease)
    return tick_back(state, inbox, m, exec_budget, None, fast_elect, lease,
                     lease_horizon, health, wedge_ticks, health_decay_shift,
                     health_topk)


def paxos_tick_impl(state, inbox: TickInbox, own_row: int = -1,
                    exec_budget: int = 0, rank_base=None,
                    fast_elect: bool = False, lease: LeaseState = None,
                    lease_horizon: int = 0, health: HealthState = None,
                    wedge_ticks: int = 32, health_decay_shift: int = 6,
                    health_topk: int = 8):
    """One tick: returns ``(new_state, outbox)``, extended by ``(new_lease,
    lease_pack)`` when ``lease`` is given and by ``(new_health,
    health_pack)`` when ``health`` is (lease first).

    exec_budget: 0 = unlimited.  > 0 caps the TOTAL executions extracted
    this tick across all (replica, group) pairs, ranked in (j, r, g) order
    so every replica's first pending slot outranks anyone's second; the
    kept set is a per-group run prefix.  Deferred decisions stay in the
    decision ring (lossless backpressure).

    rank_base: the group-axis rank exchange of a sharded tick (see
    :func:`tick_back`); None when the block is the whole group axis.

    own_row: -1 for Mode A (all rows authoritative).  ``>= 0`` confines
    every state transition to that row (Mode B peer rows are mirrors).

    fast_elect: consecutive-ballot fast re-election.  Off, the tick is the
    classical election path, op for op.  On, three coupled rules apply:
    a candidate whose promised ballot already equals the group maximum
    over member rows takes over at the successor ballot without a prepare
    round (``coord_fast``), seeding its proposals from every member row's
    accepted window; an acceptor refuses a fast push that would overwrite a
    different accepted value (the refusal still raises its promise); and a
    fast coordinator that sees a higher-ballot accepted value differing
    from its proposal adopts it and bumps its ballot by one.  A refusal
    the coordinator can prove from its mirrors demotes it to a full
    prepare at the next ballot.  Either way a tick launches 5 gathers and
    1 match: the four ring reads of the adoption rule share the
    carryover's index and go in its launch (8 arrays).

    lease_horizon: ticks a grant or renewal keeps the lease valid.
    wedge_ticks / health_decay_shift / health_topk: the health fold's
    wedge threshold, EWMA decay and top-K width.

    This is the eager form; :func:`paxos_tick_health` runs the same two
    halves as one TorchScript program."""
    m = tick_front(state, inbox, own_row, fast_elect, lease)
    st, out, le, lp, he, hp = tick_back(
        state, inbox, m, exec_budget, rank_base, fast_elect, lease,
        lease_horizon, health, wedge_ticks, health_decay_shift, health_topk)
    res = (st, out)
    if lease is not None:
        res += (le, lp)
    if health is not None:
        res += (he, hp)
    return res


class HostOutbox(NamedTuple):
    """Numpy mirror of :class:`TickOutbox`, produced by
    :func:`unpack_outbox` from ONE device transfer."""

    exec_req: "np.ndarray"
    exec_stop: "np.ndarray"
    exec_base: "np.ndarray"
    exec_count: "np.ndarray"
    intake_taken: "np.ndarray"
    coord_id: "np.ndarray"
    decided_now: "np.ndarray"
    lag: "np.ndarray"
    donor: "np.ndarray"
    donor_exec: "np.ndarray"
    donor_status: "np.ndarray"


def pack_outbox_impl(out: TickOutbox) -> torch.Tensor:
    """Flatten every outbox field into one int32 vector (single transfer)."""
    return torch.cat([
        out.exec_req.reshape(-1),
        out.exec_stop.to(torch.int32).reshape(-1),
        out.exec_base.reshape(-1),
        out.exec_count.reshape(-1),
        out.intake_taken.to(torch.int32).reshape(-1),
        out.coord_id.reshape(-1),
        out.decided_now.reshape(-1),
        out.lag.reshape(-1),
        out.donor.reshape(-1),
        out.donor_exec.reshape(-1),
        out.donor_status.reshape(-1),
    ])


def unpack_outbox(flat, R: int, P: int, W: int, G: int) -> HostOutbox:
    """Host-side inverse of :func:`pack_outbox_impl` (views into ``flat``)."""
    flat = _host(flat)
    sizes = [R * W * G, R * W * G, R * G, R * G, R * P * G, G, G, R * G,
             R * G, R * G, R * G]
    offs = np.cumsum([0] + sizes)
    cut = [flat[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    return HostOutbox(
        exec_req=cut[0].reshape(R, W, G),
        exec_stop=cut[1].reshape(R, W, G).astype(bool),
        exec_base=cut[2].reshape(R, G),
        exec_count=cut[3].reshape(R, G),
        intake_taken=cut[4].reshape(R, P, G).astype(bool),
        coord_id=cut[5],
        decided_now=cut[6],
        lag=cut[7].reshape(R, G),
        donor=cut[8].reshape(R, G),
        donor_exec=cut[9].reshape(R, G),
        donor_status=cut[10].reshape(R, G),
    )


def _host(flat) -> np.ndarray:
    """A device buffer as a host numpy array (the device sync point)."""
    if isinstance(flat, torch.Tensor):
        return flat.cpu().numpy()
    return np.asarray(flat)


def paxos_tick_packed(state, inbox: TickInbox, own_row: int = -1,
                      exec_budget: int = 0, fast_elect: bool = False):
    """Tick + full outbox packed into one int32 buffer."""
    res = paxos_tick_health(state, None, None, None, None, None, inbox,
                            own_row, exec_budget, 0, 0, False,
                            fast_elect=fast_elect)
    return res[0], res[6]


def paxos_tick_packed_lease(state, lease: LeaseState, inbox: TickInbox,
                            own_row: int = -1, exec_budget: int = 0,
                            lease_horizon: int = 0,
                            fast_elect: bool = False):
    """Lease twin of :func:`paxos_tick_packed`: also returns the new
    :class:`LeaseState` and the [5, G] lease pack."""
    res = paxos_tick_health(state, None, lease, None, None, None, inbox,
                            own_row, exec_budget, 0, lease_horizon, False,
                            fast_elect=fast_elect)
    return res[0], res[2], res[6], res[8]


# --------------------------------------------------------------------------
# Compacted outbox: the bounded-transfer tick for the at-scale host path.
# The full outbox is O(R*W*G); at steady state the host needs only the
# executed decision stream (bounded by the exec budget), the intake bits,
# the rare laggards and the decision counter.  The device compacts exactly
# that with a prefix-sum scatter, so the device->host transfer is
# O(decisions), not O(state).
# --------------------------------------------------------------------------


class CompactHostOutbox(NamedTuple):
    """Host view of the compacted tick (all numpy, one transfer).

    Executed entries appear in flat (r, j, g) order — per (replica, group)
    they are slot-ordered.  ``n_exec == budget`` means the budget may have
    bitten; deferred work arrives on later ticks.
    """

    n_exec: int
    decided_total: int
    lag_n: int            # total laggards (may exceed the recorded list)
    taken_bits: "np.ndarray"  # i32 [R, G], bit p = inbox slot p was taken
    e_rid: "np.ndarray"   # i32 [n_exec]
    e_rep: "np.ndarray"   # i32 [n_exec]
    e_row: "np.ndarray"   # i32 [n_exec]
    e_slot: "np.ndarray"  # i32 [n_exec]
    e_stop: "np.ndarray"  # bool [n_exec]
    l_rep: "np.ndarray"   # i32 [min(lag_n, lag_budget)]
    l_row: "np.ndarray"   # i32 [min(lag_n, lag_budget)]
    l_donor: "np.ndarray"  # i32 — device-selected donor replica (-1 = none)
    l_dexec: "np.ndarray"  # i32 — donor's post-tick exec watermark
    l_dstat: "np.ndarray"  # i32 — donor's post-tick group status
    l_lexec: "np.ndarray"  # i32 — the laggard's own post-tick exec watermark


def _scatter_dest(mask, budget: int) -> torch.Tensor:
    """Destination of each flat entry in a ``budget``-long compacted column:
    its rank among the masked entries, or ``budget`` (a trash slot past the
    end) for unmasked entries and ranks the budget cannot hold.  This is the
    reference's out-of-bounds-drop scatter, with no device-to-host sync."""
    rank = _excl_cumsum(mask, 0)
    return torch.where(mask & (rank < budget), rank, budget).to(torch.int64)


def _scatter_into(dst, vals, budget: int) -> torch.Tensor:
    buf = torch.zeros(budget + 1, dtype=torch.int32, device=vals.device)
    buf.scatter_(0, dst, vals)
    return buf[:budget]


def _compact_outbox_impl(out: TickOutbox, exec_budget: int,
                         lag_budget: int, row_counts: bool = False
                         ) -> torch.Tensor:
    """The outbox compacted into one flat buffer (:class:`CompactLayout`).
    ``row_counts`` appends the executions of each (r, j) row, ``[R, W]``,
    which a mesh shard's host join needs to put its executions at their
    global rank (``parallel.shard_tick.join_compact``)."""
    R, W, G = out.exec_req.shape
    P = out.intake_taken.shape[1]
    E, Lb = exec_budget, lag_budget
    dev = out.exec_req.device
    i32 = torch.int32
    ji = torch.arange(W, dtype=i32, device=dev)[None, :, None]
    mask = ji < out.exec_count[:, None, :]  # [R, W, G]
    mf = mask.reshape(-1)
    dst = _scatter_dest(mf, E)
    slot = out.exec_base[:, None, :] + ji
    rep = torch.arange(R, dtype=i32, device=dev)[:, None, None].expand(R, W, G)
    row = torch.arange(G, dtype=i32, device=dev)[None, None, :].expand(R, W, G)
    meta = rep | (out.exec_stop.to(i32) << 8)
    n_exec = _i32sum(mf, 0)
    # intake: P bits per (r, g) — placed-and-taken
    pb = torch.arange(P, dtype=i32, device=dev)[None, :, None]
    taken_bits = _i32sum(out.intake_taken.to(i32) << pb, 1)  # [R, G]
    # laggards needing checkpoint transfer (lag >= W): compacted pair list
    lmask = (out.lag >= W).reshape(-1)
    ldst = _scatter_dest(lmask, Lb)
    rep2 = torch.arange(R, dtype=i32, device=dev)[:, None].expand(R, G)
    row2 = torch.arange(G, dtype=i32, device=dev)[None, :].expand(R, G)
    header = torch.stack([
        n_exec,
        _i32sum(out.decided_now, 0),
        _i32sum(lmask, 0),
    ])
    parts = [header, taken_bits.reshape(-1)]
    for v in [out.exec_req, meta, slot, row]:
        parts.append(_scatter_into(dst, v.reshape(-1).to(i32), E))
    # the last column is the laggard's post-tick exec
    for v in [rep2, row2, out.donor, out.donor_exec, out.donor_status,
              out.exec_base + out.exec_count]:
        parts.append(_scatter_into(ldst, v.reshape(-1), Lb))
    if row_counts:
        parts.append(_i32sum(mask, 2).reshape(-1))
    return torch.cat(parts)


def paxos_tick_compact(state, inbox: TickInbox, own_row: int,
                       exec_budget: int, lag_budget: int,
                       fast_elect: bool = False):
    """Tick + budgeted on-device compaction: one O(budget) buffer."""
    res = paxos_tick_health(state, None, None, None, None, None, inbox,
                            own_row, exec_budget, lag_budget, 0, True,
                            fast_elect=fast_elect)
    return res[0], res[6]


def paxos_tick_compact_lease(state, lease: LeaseState, inbox: TickInbox,
                             own_row: int, exec_budget: int, lag_budget: int,
                             lease_horizon: int, fast_elect: bool = False):
    """Lease twin of :func:`paxos_tick_compact`: the O(budget) compact
    buffer plus the O(G) lease pack."""
    res = paxos_tick_health(state, None, lease, None, None, None, inbox,
                            own_row, exec_budget, lag_budget, lease_horizon,
                            True, fast_elect=fast_elect)
    return res[0], res[2], res[6], res[8]


class CompactLayout:
    """Offsets of the compacted-outbox flat buffer: producers
    (:func:`_compact_outbox_impl`, and ``models.device_kv.fused_compact``,
    which appends its per-execution extras) and consumers
    (:func:`unpack_compact`, the manager, device-app replay) all slice
    through this one object.

    Section order: header[3] | taken_bits[R*G] | e_rid[E] | e_meta[E] |
    e_slot[E] | e_row[E] | l_rep[Lb] | l_row[Lb] | l_donor[Lb] |
    l_dexec[Lb] | l_dstat[Lb] | l_lexec[Lb] | app extras (device app:
    e_resp[E] | e_miss[E]; a mesh shard: the executions of each (r, j)
    row, counts[R*W])."""

    HEADER = 3  # n_exec, decided_total, lag_n

    LAG_COLS = 6  # rep, row, donor, donor exec, donor status, laggard exec

    def __init__(self, R: int, G: int, exec_budget: int, lag_budget: int):
        self.R, self.G = R, G
        self.E, self.Lb = exec_budget, lag_budget
        self.o_taken = self.HEADER
        self.o_exec = self.o_taken + R * G      # 4 E-sized exec columns
        self.o_lag = self.o_exec + 4 * self.E   # LAG_COLS Lb-sized columns
        self.base = self.o_lag + self.LAG_COLS * self.Lb  # app extras
        self.o_resp = self.base                 # device app: KV responses
        self.o_miss = self.base + self.E        # device app: descriptor miss
        self.o_counts = self.base               # a mesh shard: row counts
        self.total_plain = self.base
        self.total_device = self.base + 2 * self.E

    def kv_extras(self, flat):
        """Device-app extras aligned with the exec stream: (e_resp, e_miss)."""
        return (flat[self.o_resp:self.o_resp + self.E],
                flat[self.o_miss:self.o_miss + self.E])


def unpack_compact(flat, R: int, G: int, exec_budget: int,
                   lag_budget: int, own: bool = False) -> CompactHostOutbox:
    """Host-side inverse of :func:`_compact_outbox_impl`: views into the
    one transferred buffer, or with ``own`` copies of its used parts (the
    n_exec-long exec columns, taken_bits, the recorded laggard rows), so
    the buffer may be written again."""
    flat = _host(flat)
    L = CompactLayout(R, G, exec_budget, lag_budget)
    E, Lb = L.E, L.Lb
    n_exec, decided_total, lag_n = (int(flat[0]), int(flat[1]), int(flat[2]))

    def cut(o, n):
        return flat[o:o + n].copy() if own else flat[o:o + n]

    o = L.o_exec
    e_rid = cut(o, n_exec); o += E
    e_meta = flat[o:o + n_exec]; o += E
    e_slot = cut(o, n_exec); o += E
    e_row = cut(o, n_exec); o += E
    assert o == L.o_lag
    ln = min(lag_n, Lb)
    l_rep = cut(o, ln); o += Lb
    l_row = cut(o, ln); o += Lb
    l_donor = cut(o, ln); o += Lb
    l_dexec = cut(o, ln); o += Lb
    l_dstat = cut(o, ln); o += Lb
    l_lexec = cut(o, ln)
    return CompactHostOutbox(
        n_exec=n_exec,
        decided_total=decided_total,
        lag_n=lag_n,
        taken_bits=cut(L.o_taken, R * G).reshape(R, G),
        e_rid=e_rid,
        e_rep=e_meta & 0xFF,
        e_row=e_row,
        e_slot=e_slot,
        e_stop=(e_meta >> 8).astype(bool),
        l_rep=l_rep,
        l_row=l_row,
        l_donor=l_donor,
        l_dexec=l_dexec,
        l_dstat=l_dstat,
        l_lexec=l_lexec,
    )


# --------------------------------------------------------------------------
# Mixed log/register planes (register mode, RMWPaxos).
#
# Register groups run the SAME tick on a second dense state plane built
# with W=1: the ring degenerates to one in-place consensus cell (space caps
# at one outstanding proposal, prepare carryover is carry-forward, and
# exec_slot counts versions).  The composite row space the manager exposes
# is [0, G_log) log rows followed by [G_log, G_log + G_reg) register rows:
# the row index is the mode bit, so a tick splits the inbox at the plane
# boundary, runs paxos_tick_impl per plane, and the host merges the two
# outboxes back into the composite row space.
# --------------------------------------------------------------------------


def _split_inbox(inbox: TickInbox, g_log: int
                 ) -> Tuple[TickInbox, TickInbox]:
    """The composite inbox cut at the plane boundary, each half contiguous
    (the kernels take contiguous rows)."""
    return (
        TickInbox(inbox.req[:, :, :g_log].contiguous(),
                  inbox.stop[:, :, :g_log].contiguous(), inbox.alive),
        TickInbox(inbox.req[:, :, g_log:].contiguous(),
                  inbox.stop[:, :, g_log:].contiguous(), inbox.alive),
    )


def demand_fold(demand, per_row, decay: float):
    """The placement demand EWMA, ``decay * demand + per_row`` in float32
    with one rounding: the reference's XLA program fuses it into a
    multiply-add.  The product of two float32 values is exact in float64,
    so the fold runs there and rounds once."""
    dec = torch.full((), decay, dtype=torch.float32, device=demand.device)
    return (demand.to(torch.float64) * dec.to(torch.float64)
            + per_row.to(torch.float64)).to(torch.float32)


def tick_dispatch(state: PaxosState, rstate: Optional[PaxosState],
                  lease: Optional[LeaseState], rlease: Optional[LeaseState],
                  health: Optional[HealthState],
                  rhealth: Optional[HealthState], inbox: TickInbox,
                  own_row: int, exec_budget: int, lag_budget: int,
                  lease_horizon: int, compact: bool, wedge_ticks: int,
                  decay_shift: int, topk: int, scat_budget: int,
                  fast_elect: bool, demand: Optional[torch.Tensor],
                  demand_decay: float
                  ) -> Tuple[PaxosState, Optional[PaxosState],
                             Optional[LeaseState], Optional[LeaseState],
                             Optional[HealthState], Optional[HealthState],
                             torch.Tensor, Optional[torch.Tensor],
                             Optional[torch.Tensor], Optional[torch.Tensor],
                             Optional[torch.Tensor], Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """The body :func:`paxos_tick_health` scripts (its arguments, plus the
    placement demand fold): each plane's tick and outbox pack, and with
    ``demand`` the log plane's per-row intake folded into the decaying
    ``[G]`` float32 demand, ``d' = decay * d + sum(intake_taken)``.  Returns
    the 12-tuple of :func:`paxos_tick_health` and the new demand."""
    g_log = state.exec_slot.shape[1]
    ib_l = inbox
    ib_r = inbox
    if rstate is not None:
        ib_l, ib_r = _split_inbox(inbox, g_log)
    state, out_l, lease, lp_l, health, hp_l = tick_core(
        state, ib_l, own_row, exec_budget, fast_elect, lease, lease_horizon,
        health, wedge_ticks, decay_shift, min(topk, g_log))
    if compact:
        pk_l = _compact_outbox_impl(out_l, scat_budget, lag_budget)
    else:
        pk_l = pack_outbox_impl(out_l)
    new_demand: Optional[torch.Tensor] = None
    if demand is not None:
        new_demand = demand_fold(
            demand, out_l.intake_taken.to(torch.int32).sum(
                dim=(0, 1), dtype=torch.int32), demand_decay)
    pk_r: Optional[torch.Tensor] = None
    lp_r: Optional[torch.Tensor] = None
    hp_r: Optional[torch.Tensor] = None
    if rstate is not None:
        rstate, out_r, rlease, lp_r, rhealth, hp_r = tick_core(
            rstate, ib_r, own_row, exec_budget, fast_elect, rlease,
            lease_horizon, rhealth, wedge_ticks, decay_shift,
            min(topk, rstate.exec_slot.shape[1]))
        if compact:
            pk_r = _compact_outbox_impl(out_r, scat_budget, lag_budget)
        else:
            pk_r = pack_outbox_impl(out_r)
    return (state, rstate, lease, rlease, health, rhealth, pk_l, pk_r, lp_l,
            lp_r, hp_l, hp_r, new_demand)


_scripted = {}
_scripted_lock = threading.Lock()


def scripted(fn):
    """``fn`` (one of this module's tick functions) compiled by
    TorchScript, once a process, at its first call.  The program runs in
    the C++ interpreter with the interpreter lock released, retaken only
    for the CUDA kernel calls (``window.tick_gather`` / ``tick_match``, 5 +
    1 a plane; on the CPU the plain versions run inside the program), and
    the callers run it with the graph executor's optimisations off: the
    ops are the eager ones, in the same order, on every device."""
    with _scripted_lock:
        if fn.__name__ not in _scripted:
            with warnings.catch_warnings():
                # torch.jit.script warns of its deprecation at each call
                warnings.simplefilter("ignore", DeprecationWarning)
                _scripted[fn.__name__] = torch.jit.script(fn)
        return _scripted[fn.__name__]


def _own(res, classes):
    """TorchScript hands named tuples back as its own copies of their
    types: rebuild the leading entries of ``res`` as the package's
    ``classes`` (None entries stay None)."""
    res = list(res)
    for i, cls in enumerate(classes):
        if res[i] is not None:
            res[i] = cls(*res[i])
    return tuple(res)


def run_front(state, inbox: TickInbox, own_row: int = -1,
              fast_elect: bool = False, lease=None) -> TickMid:
    """One scripted :func:`tick_front`."""
    with torch.jit.optimized_execution(False):
        m = scripted(tick_front)(state, inbox, own_row, fast_elect, lease)
    return TickMid(PaxosState(*m[0]), *m[1:])


def run_back(state, inbox: TickInbox, m: TickMid, exec_budget: int = 0,
             rank_base=None, fast_elect: bool = False):
    """One scripted :func:`tick_back` without the lease and health folds:
    ``(state, outbox)``."""
    with torch.jit.optimized_execution(False):
        res = scripted(tick_back)(state, inbox, m, exec_budget, rank_base,
                                  fast_elect)
    return PaxosState(*res[0]), TickOutbox(*res[1])


def run_compact(out: TickOutbox, exec_budget: int, lag_budget: int,
                row_counts: bool = False):
    """One scripted :func:`_compact_outbox_impl`."""
    with torch.jit.optimized_execution(False):
        return scripted(_compact_outbox_impl)(out, exec_budget, lag_budget,
                                              row_counts)


def run_dispatch(state, rstate, lease, rlease, health, rhealth,
                 inbox: TickInbox, own_row: int, exec_budget: int,
                 lag_budget: int, lease_horizon: int, compact: bool,
                 wedge_ticks: int = 32, decay_shift: int = 6, topk: int = 8,
                 scat_budget: int = None, fast_elect: bool = False,
                 demand=None, demand_decay: float = 0.0):
    """One scripted :func:`tick_dispatch` (the 13-tuple)."""
    scat = exec_budget if scat_budget is None else scat_budget
    with torch.jit.optimized_execution(False):
        res = scripted(tick_dispatch)(
            state, rstate, lease, rlease, health, rhealth, inbox, own_row,
            exec_budget, lag_budget, lease_horizon, compact, wedge_ticks,
            decay_shift, topk, scat, fast_elect, demand, float(demand_decay))
    return _own(res, (PaxosState, PaxosState, LeaseState, LeaseState,
                      HealthState, HealthState))


def paxos_tick_health(state, rstate, lease, rlease, health, rhealth,
                      inbox: TickInbox, own_row: int, exec_budget: int,
                      lag_budget: int, lease_horizon: int, compact: bool,
                      wedge_ticks: int = 32, decay_shift: int = 6,
                      topk: int = 8, scat_budget: int = None,
                      fast_elect: bool = False):
    """The one dispatch body of every tick entry point: ticks the log
    plane (and the register plane when ``rstate`` is given), folds the
    lease columns when ``lease`` is given and the health columns when
    ``health`` is, per plane, and packs each plane's outbox compact or
    full.  Absent planes and folds are ``None``.  It runs as one
    TorchScript program (:func:`scripted`).

    Returns a fixed 12-tuple ``(state, rstate, lease, rlease, health,
    rhealth, out_l, out_r, lp_l, lp_r, hp_l, hp_r)`` with ``None`` in every
    absent position.  The per-plane top-K is ``min(topk, G_plane)``; the
    host unpacks with the same clamp.  ``scat_budget`` sizes the compact
    buffer when it differs from the exec budget (batched replay).
    ``fast_elect`` switches on fast re-election (see :func:`paxos_tick_impl`)
    in every plane."""
    return run_dispatch(state, rstate, lease, rlease, health, rhealth, inbox,
                        own_row, exec_budget, lag_budget, lease_horizon,
                        compact, wedge_ticks, decay_shift, topk, scat_budget,
                        fast_elect)[:12]


def paxos_tick_compact_demand(state, inbox: TickInbox, demand,
                              own_row: int, exec_budget: int,
                              lag_budget: int, decay: float,
                              fast_elect: bool = False):
    """Tick + compaction + the placement demand fold in one program:
    ``(state, flat, new_demand)``.  The fold reads the per-row intake (the
    ``taken_bits`` popcount a host fold would take), so the samples equal
    a host fold's."""
    res = run_dispatch(state, None, None, None, None, None, inbox, own_row,
                       exec_budget, lag_budget, 0, True,
                       fast_elect=fast_elect, demand=demand,
                       demand_decay=decay)
    return res[0], res[6], res[12]


def paxos_tick_mixed_packed(state, rstate, inbox: TickInbox,
                            own_row: int = -1, exec_budget: int = 0):
    """Mixed tick, full (packed) outbox per plane."""
    res = paxos_tick_health(state, rstate, None, None, None, None, inbox,
                            own_row, exec_budget, 0, 0, False)
    return res[0], res[1], res[6], res[7]


def paxos_tick_mixed_packed_lease(state, rstate, lease, rlease,
                                  inbox: TickInbox, own_row: int = -1,
                                  exec_budget: int = 0,
                                  lease_horizon: int = 0):
    """Lease twin of the mixed packed tick: each plane folds its own
    :class:`LeaseState`."""
    res = paxos_tick_health(state, rstate, lease, rlease, None, None, inbox,
                            own_row, exec_budget, 0, lease_horizon, False)
    return res[:4] + res[6:10]


def paxos_tick_mixed_compact(state, rstate, inbox: TickInbox, own_row: int,
                             exec_budget: int, lag_budget: int):
    """Mixed tick, budgeted compact outbox per plane.  The register plane's
    compaction flags laggards at lag >= 1: the lag threshold is the
    plane's own W."""
    res = paxos_tick_health(state, rstate, None, None, None, None, inbox,
                            own_row, exec_budget, lag_budget, 0, True)
    return res[0], res[1], res[6], res[7]


def paxos_tick_mixed_compact_lease(state, rstate, lease, rlease,
                                   inbox: TickInbox, own_row: int,
                                   exec_budget: int, lag_budget: int,
                                   lease_horizon: int):
    res = paxos_tick_health(state, rstate, lease, rlease, None, None, inbox,
                            own_row, exec_budget, lag_budget, lease_horizon,
                            True)
    return res[:4] + res[6:10]


def merge_outbox(out_l: HostOutbox, out_r: HostOutbox) -> HostOutbox:
    """Concatenate the two planes' full outboxes into the composite row
    space (every field is indexed by row, so concatenation along the group
    axis is the whole merge).  The register plane's W=1 exec ring is
    zero-padded to the log plane's W: consumers read only j < exec_count
    entries, and a register row executes at most one slot per tick."""
    R, W, _ = out_l.exec_req.shape
    Rr, Wr, Gr = out_r.exec_req.shape

    def wide(a):
        if Wr == W:
            return a
        pad = np.zeros((Rr, W - Wr, Gr), a.dtype)
        return np.concatenate([a, pad], axis=1)

    cat = np.concatenate
    return HostOutbox(
        exec_req=cat([out_l.exec_req, wide(out_r.exec_req)], axis=2),
        exec_stop=cat([out_l.exec_stop, wide(out_r.exec_stop)], axis=2),
        exec_base=cat([out_l.exec_base, out_r.exec_base], axis=1),
        exec_count=cat([out_l.exec_count, out_r.exec_count], axis=1),
        intake_taken=cat([out_l.intake_taken, out_r.intake_taken], axis=2),
        coord_id=cat([out_l.coord_id, out_r.coord_id]),
        decided_now=cat([out_l.decided_now, out_r.decided_now]),
        lag=cat([out_l.lag, out_r.lag], axis=1),
        donor=cat([out_l.donor, out_r.donor], axis=1),
        donor_exec=cat([out_l.donor_exec, out_r.donor_exec], axis=1),
        donor_status=cat([out_l.donor_status, out_r.donor_status], axis=1),
    )


def merge_compact_outbox(co_l: CompactHostOutbox, co_r: CompactHostOutbox,
                         g_log: int) -> CompactHostOutbox:
    """Merge two planes' compact outboxes into composite rows: counts sum,
    taken_bits stack along G, and the e_*/l_* columns (already trimmed to
    their valid length) concatenate with the register plane's rows offset
    by g_log."""
    cat = np.concatenate
    return CompactHostOutbox(
        n_exec=co_l.n_exec + co_r.n_exec,
        decided_total=co_l.decided_total + co_r.decided_total,
        lag_n=co_l.lag_n + co_r.lag_n,
        taken_bits=np.hstack([co_l.taken_bits, co_r.taken_bits]),
        e_rid=cat([co_l.e_rid, co_r.e_rid]),
        e_rep=cat([co_l.e_rep, co_r.e_rep]),
        e_row=cat([co_l.e_row, co_r.e_row + g_log]),
        e_slot=cat([co_l.e_slot, co_r.e_slot]),
        e_stop=cat([co_l.e_stop, co_r.e_stop]),
        l_rep=cat([co_l.l_rep, co_r.l_rep]),
        l_row=cat([co_l.l_row, co_r.l_row + g_log]),
        l_donor=cat([co_l.l_donor, co_r.l_donor]),
        l_dexec=cat([co_l.l_dexec, co_r.l_dexec]),
        l_dstat=cat([co_l.l_dstat, co_r.l_dstat]),
        l_lexec=cat([co_l.l_lexec, co_r.l_lexec]),
    )


# --------------------------------------------------------------------------
# Group-health plane, host side: the flat health_pack layout, its unpack
# and the composite-plane merge.
# --------------------------------------------------------------------------


class HealthLayout:
    """Offsets of the flat health_pack buffer: ``gauges[HG_N] |
    hist_stall[HB] | hist_churn[HB] | (val[K], row[K]) x (stuck, churny,
    hot)``."""

    def __init__(self, topk: int):
        self.K = topk
        self.o_hist_stall = HG_N
        self.o_hist_churn = self.o_hist_stall + HB
        self.o_top = self.o_hist_churn + HB


class HealthView(NamedTuple):
    """Host (numpy) view of one tick's health pack."""

    alloc: int          # allocated groups
    backlog: int        # groups with device-visible backlog this tick
    wedged: int         # backlogged groups stalled >= wedge_ticks
    max_stall: int      # worst stall age (ticks)
    max_churn: int      # worst churn score (Q4 fixed point)
    lease_wait: int     # coordinators write-fenced behind a prior lease
    hist_stall: "np.ndarray"  # [HB] log2 buckets of stall age
    hist_churn: "np.ndarray"  # [HB] log2 buckets of handoff score (whole)
    stuck_val: "np.ndarray"   # [K] desc; -1 entries = fewer than K rows
    stuck_row: "np.ndarray"
    churn_val: "np.ndarray"
    churn_row: "np.ndarray"
    heat_val: "np.ndarray"
    heat_row: "np.ndarray"


def unpack_health(flat, topk: int) -> HealthView:
    """Host-side inverse of :func:`_health_pack_impl` (views into the one
    transferred buffer)."""
    flat = _host(flat)
    L = HealthLayout(topk)
    o = L.o_top
    cols = []
    for _ in range(6):
        cols.append(flat[o:o + topk])
        o += topk
    return HealthView(
        alloc=int(flat[HG_ALLOC]),
        backlog=int(flat[HG_BACKLOG]),
        wedged=int(flat[HG_WEDGED]),
        max_stall=int(flat[HG_MAX_STALL]),
        max_churn=int(flat[HG_MAX_CHURN]),
        lease_wait=int(flat[HG_LEASE_WAIT]),
        hist_stall=flat[L.o_hist_stall:L.o_hist_stall + HB],
        hist_churn=flat[L.o_hist_churn:L.o_hist_churn + HB],
        stuck_val=cols[0], stuck_row=cols[1],
        churn_val=cols[2], churn_row=cols[3],
        heat_val=cols[4], heat_row=cols[5],
    )


def _merge_top(val_l, row_l, val_r, row_r, g_log: int, topk: int):
    """Merge two planes' top-K columns into composite-row top-K: register
    rows re-offset by g_log, then one stable sort over the 2K entries."""
    vals = np.concatenate([val_l, val_r])
    rows = np.concatenate([row_l, row_r + g_log])
    order = np.argsort(-vals, kind="stable")[:topk]
    return vals[order], rows[order]


def merge_health(hv_l: HealthView, hv_r: HealthView, g_log: int,
                 topk: int) -> HealthView:
    """Compose the two planes' health views into the composite row space
    (counts sum, maxima max, histograms add, top-K re-ranks)."""
    sv, sr = _merge_top(hv_l.stuck_val, hv_l.stuck_row,
                        hv_r.stuck_val, hv_r.stuck_row, g_log, topk)
    cv, cr = _merge_top(hv_l.churn_val, hv_l.churn_row,
                        hv_r.churn_val, hv_r.churn_row, g_log, topk)
    hv, hr = _merge_top(hv_l.heat_val, hv_l.heat_row,
                        hv_r.heat_val, hv_r.heat_row, g_log, topk)
    return HealthView(
        alloc=hv_l.alloc + hv_r.alloc,
        backlog=hv_l.backlog + hv_r.backlog,
        wedged=hv_l.wedged + hv_r.wedged,
        max_stall=max(hv_l.max_stall, hv_r.max_stall),
        max_churn=max(hv_l.max_churn, hv_r.max_churn),
        lease_wait=hv_l.lease_wait + hv_r.lease_wait,
        hist_stall=hv_l.hist_stall + hv_r.hist_stall,
        hist_churn=hv_l.hist_churn + hv_r.hist_churn,
        stuck_val=sv, stuck_row=sr,
        churn_val=cv, churn_row=cr,
        heat_val=hv, heat_row=hr,
    )


# --------------------------------------------------------------------------
# Batched WAL replay: K journaled ticks back to back on the device.
#
# Journal replay re-runs the SAME fused tick body as the live run.  A window
# of K tick inboxes arrives as padded COO columns (entry, lane, row, rid,
# stop — see wal/columnar.py); each tick scatters its dense inbox on the
# device, runs the tick and compacts its outbox, and the K compact buffers
# stay on the device until the window's one ``[K, total]`` copy to the host
# (made by the caller).  Nothing in the loop reads the device from the
# host.
#
# The tick is functional (it returns fresh tensors and never writes its
# input state), so the caller keeps the pre-window state: a budget overflow
# (a tick whose true n_exec exceeds the scatter budget — the compact header
# carries it) discards the window's outputs and re-runs it through the
# record-at-a-time arm without any loss.
# --------------------------------------------------------------------------


def _coo_inbox(x, R: int, P: int, g_total: int) -> TickInbox:
    """Scatter one tick's COO columns into the dense [R, P, G] inbox.
    Padding lanes target row == g_total, one past the row space: they land
    in a trash column that is sliced away, the equal of the host-side
    dense buffers the record-at-a-time arm builds.  Real (entry, lane, row)
    triples are unique per tick, so only padding repeats an index."""
    e, p, g = x["e"], x["p"], x["g"]
    dev = e.device
    req = torch.zeros((R, P, g_total + 1), dtype=I32, device=dev)
    req.index_put_((e, p, g), x["rid"])
    stop = torch.zeros((R, P, g_total + 1), dtype=BOOL, device=dev)
    stop.index_put_((e, p, g), x["stop"])
    return TickInbox(req[..., :g_total].contiguous(),
                     stop[..., :g_total].contiguous(), x["alive"])


def _replay_loop(state, rstate, lease, rlease, xs, P: int,
                 exec_budget: int, scat_budget: int, lag_budget: int,
                 lease_horizon: int):
    """The body every replay scan shares: K journaled ticks through
    :func:`paxos_tick_health`, each plane's compact buffer side by side in
    one row per tick.  Returns ``(state, rstate, lease, rlease, packs,
    lp_last, waits)``: ``lp_last`` the final tick's lease pack(s) (the
    host mirror only ever holds the latest), ``waits`` each tick's fenced
    group count."""
    R, g_log = state.exec_slot.shape
    g_total = g_log + (0 if rstate is None else rstate.exec_slot.shape[1])
    dev = state.exec_slot.device

    def col(name, dtype):
        v = xs[name]
        return torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v), dtype=dtype, device=dev)

    e, p, g = (col(k, torch.int64) for k in ("e", "p", "g"))
    rid, stop, alive = col("rid", I32), col("stop", BOOL), col("alive", BOOL)
    packs, waits, lp_last = [], [], None
    for k in range(e.shape[0]):
        x = {"e": e[k], "p": p[k], "g": g[k], "rid": rid[k],
             "stop": stop[k], "alive": alive[k]}
        (state, rstate, lease, rlease, _, _, pk_l, pk_r, lp_l, lp_r, _,
         _) = paxos_tick_health(
            state, rstate, lease, rlease, None, None,
            _coo_inbox(x, R, P, g_total), -1, exec_budget, lag_budget,
            lease_horizon, True, scat_budget=scat_budget)
        packs.append(pk_l if pk_r is None else torch.cat([pk_l, pk_r]))
        if lp_l is not None:
            lp_last = lp_l if lp_r is None else (lp_l, lp_r)
            w = _i32sum(lp_l[LP_WAIT], 0)
            waits.append(w if lp_r is None else w + _i32sum(lp_r[LP_WAIT], 0))
    return (state, rstate, lease, rlease, torch.stack(packs), lp_last,
            torch.stack(waits) if waits else None)


def replay_scan_ticks(state, xs, P: int, exec_budget: int,
                      scat_budget: int, lag_budget: int):
    """K journaled ticks on ``state``'s device.  ``xs``: the window's COO
    columns as ``[K, M]`` arrays (``e``, ``p``, ``g``, ``rid``, ``stop``)
    and ``alive [K, R]``, numpy or tensors.  Returns ``(state, packs)`` with
    ``packs`` the ``[K, total]`` compact buffers, still on the device."""
    res = _replay_loop(state, None, None, None, xs, P, exec_budget,
                       scat_budget, lag_budget, 0)
    return res[0], res[4]


def replay_scan_ticks_lease(state, lease, xs, P: int, exec_budget: int,
                            scat_budget: int, lag_budget: int,
                            lease_horizon: int):
    """Lease twin: returns ``(state, lease, packs, lp_last, waits)`` with
    the FINAL tick's lease pack and the per-tick fenced-group counts."""
    st, _, ls, _, packs, lp_last, waits = _replay_loop(
        state, None, lease, None, xs, P, exec_budget, scat_budget,
        lag_budget, lease_horizon)
    return st, ls, packs, lp_last, waits


def replay_scan_ticks_mixed(state, rstate, xs, P: int, exec_budget: int,
                            scat_budget: int, lag_budget: int):
    """Mixed-plane twin: per tick the two planes' compact buffers ride one
    ``[total_l + total_r]`` row (the host slices it per plane).  Returns
    ``(state, rstate, packs)``."""
    st, rst, _, _, packs, _, _ = _replay_loop(
        state, rstate, None, None, xs, P, exec_budget, scat_budget,
        lag_budget, 0)
    return st, rst, packs


def replay_scan_ticks_mixed_lease(state, rstate, lease, rlease, xs, P: int,
                                  exec_budget: int, scat_budget: int,
                                  lag_budget: int, lease_horizon: int):
    """Mixed-plane lease twin: returns ``(state, rstate, lease, rlease,
    packs, (lp_l, lp_r), waits)``."""
    return _replay_loop(state, rstate, lease, rlease, xs, P, exec_budget,
                        scat_budget, lag_budget, lease_horizon)


# --------------------------------------------------------------------------
# Sparse window replay: the tick fold is a pure per-group map — a row whose
# inbox is empty does not change AT ALL across a tick (no tick counter
# enters the fold, cross-replica reductions are row-local), so a replay
# window only needs the rows its journaled inboxes touch.  The replay
# gathers those rows into a narrow [R, .., A] state (G is the minor axis of
# every field), runs the same ticks at width A instead of G, and scatters
# the evolved columns back: per journaled tick the device fold costs
# O(active), not O(G).
# --------------------------------------------------------------------------


def _rows_on(rows, dev) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(np.asarray(rows, np.int64), device=dev)


def replay_gather_rows(state, rows):
    """Columns ``rows`` of the G (minor) axis of every field, as a narrow
    state of fresh tensors."""
    r = _rows_on(rows, state.exec_slot.device)
    return type(state)(*(t.index_select(t.dim() - 1, r) for t in state))


def replay_scatter_rows(full, compact, rows):
    """Inverse of :func:`replay_gather_rows`, written into ``full`` in
    place (``rows`` must be duplicate-free); returns ``full``."""
    r = _rows_on(rows, full.exec_slot.device)
    for f, c in zip(full, compact):
        f.index_copy_(f.dim() - 1, r, c)
    return full


# --------------------------------------------------------------------------
# Payload-sweep frontier: per-group reductions the manager's sweep reads,
# gathered back only for the rows that hold live records.
# --------------------------------------------------------------------------


def sweep_frontier(exec_slot, member, alive):
    """``(amin[G], base[G], live[G])`` device tensors:

    * ``amin``: min exec watermark over MEMBERS (dead included); int32 max
      where a group has no members;
    * ``base``: max exec watermark over members; int32 min where none;
    * ``live``: any member currently alive."""
    amin = torch.where(member, exec_slot, INT32_MAX).amin(dim=0)
    base = torch.where(member, exec_slot, NEG_INF).amax(dim=0)
    live = (member & alive[:, None]).any(dim=0)
    return amin, base, live


def frontier_rows(amin, base, live, rows):
    """O(rows) gather of a stashed frontier (indices clipped into range)."""
    r = torch.as_tensor(np.asarray(rows, np.int64), device=amin.device)
    r = r.clamp(0, amin.shape[0] - 1)
    return amin[r], base[r], live[r]


def make_inbox(n_replicas: int, n_groups: int, per_tick: int,
               device=None) -> TickInbox:
    """An empty inbox template (host fills rows it has traffic for)."""
    dev = resolve_device(device)
    return TickInbox(
        req=torch.zeros((n_replicas, per_tick, n_groups), dtype=I32,
                        device=dev),
        stop=torch.zeros((n_replicas, per_tick, n_groups), dtype=BOOL,
                         device=dev),
        alive=torch.ones((n_replicas,), dtype=BOOL, device=dev),
    )
