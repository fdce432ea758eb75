"""The fused chain-replication tick: every chain advances one hop per tick.

One branch-free device step over all chains:

* head intake orders new writes;
* each replica copies the window planes it lacks from its predecessor (the
  forward packet);
* each replica applies as its window fills;
* the tail's application watermark is the commit point (reads are served
  at the tail).

A dead mid-chain replica is routed around: live members re-link into a
sub-chain (pred = nearest *live* upstream member), so writes — including
the epoch stop the reconfiguration layer needs to remove the dead node —
keep committing at the live tail.  The log is one totally ordered window
(slots assigned once by the head), so a recovered member resumes copying
from its live predecessor at its own watermark.  A dead head still blocks
intake, and a dead member freezes ``min_applied``, so the window fills
after W more slots: bounded progress that a new epoch resolves.

G is the minor axis.  The three received-log rings are read in window
order through one ``window.gather_planes_many`` call over a per-replica
index, which launches the hand-written gather kernel once a tick for CUDA
tensors.  The tick never writes its input state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.tick import _host
from ..ops.window import gather_planes_many
from ..types import GroupStatus, NO_REQUEST

I32 = torch.int32
BOOL = torch.bool


class ChainInbox(NamedTuple):
    """req/stop: int32/bool [P, G] — new client requests per chain (the host
    routes all of a chain's traffic to its head).  alive: bool [R]."""

    req: torch.Tensor
    stop: torch.Tensor
    alive: torch.Tensor


class ChainOutbox(NamedTuple):
    """exec_*: application events per replica this tick (plane j = slot
    exec_base+j).  committed_now counts slots newly applied at the tail —
    the chain's commit signal.  head_id/tail_id let the host route and
    respond without recomputing chain order."""

    exec_req: torch.Tensor  # int32 [R, W, G]
    exec_stop: torch.Tensor  # bool [R, W, G]
    exec_base: torch.Tensor  # int32 [R, G]
    exec_count: torch.Tensor  # int32 [R, G]
    intake_taken: torch.Tensor  # bool [P, G]
    head_id: torch.Tensor  # int32 [G] (-1 if no members)
    tail_id: torch.Tensor  # int32 [G]
    committed_now: torch.Tensor  # int32 [G]


def _cumsum(x, dim=0):
    return torch.cumsum(x.to(I32), dim=dim, dtype=I32)


def chain_tick_impl(state, inbox: ChainInbox, own_row: int = -1):
    """One tick: returns ``(new_state, outbox)``.

    own_row: -1 for Mode A (the whole chain in one device program).  With
    ``own_row >= 0`` (one process per chain node) only the own row may
    take head intake; forward copy and apply read only facts a mirror
    holds (slots are ordered once by the head)."""
    R, G = state.applied.shape
    W = state.c_req.shape[1]
    P = inbox.req.shape[0]
    Wm = W - 1
    BIG = 1 << 30
    dev = state.applied.device

    alive = inbox.alive
    member = state.member
    live_m = member & alive[:, None]  # [R, G]
    r_idx = torch.arange(R, dtype=I32, device=dev)[:, None]  # [R, 1]
    jw = torch.arange(W, dtype=I32, device=dev)[:, None]  # [W, 1]
    has = state.n_members > 0

    # ---------------- chain topology from the member mask ----------------
    # the head is fixed by membership (only the head may order writes);
    # propagation and the commit point re-link over live members
    head = torch.where(member, r_idx, BIG).amin(dim=0)  # [G]
    head = torch.where(has, head, -1)
    tail = torch.where(live_m, r_idx, -1).amax(dim=0)  # [G]
    tail = torch.where(live_m.any(dim=0), tail, -1)
    # pred[r, g] = nearest live member slot below r (-1 for head/non-members)
    preds = []
    run = torch.full((G,), -1, dtype=I32, device=dev)
    for r in range(R):
        preds.append(run)
        run = torch.where(live_m[r], r, run)
    pred = torch.stack(preds)  # [R, G]

    def sel_r(arr_rg, idx_g):
        """arr_rg[idx_g[g], g] per group; an index out of [0, R) gives 0."""
        out = torch.zeros((G,), dtype=arr_rg.dtype, device=dev)
        for r in range(R):
            out = torch.where(idx_g == r, arr_rg[r], out)
        return out

    is_head = (r_idx == head[None, :]) & member  # [R, G]
    head_alive = (is_head & alive[:, None]).any(dim=0)  # [G]
    if own_row >= 0:
        is_head = is_head & (r_idx == own_row)
        head_alive = head_alive & is_head.any(dim=0)
    head_active = sel_r(state.status, head) == int(GroupStatus.ACTIVE)

    # ---------------- head intake: order new writes ----------------
    # window room is bounded by the slowest member: a plane may only be
    # overwritten once every member has applied it
    min_applied = torch.where(member, state.applied, BIG).amin(dim=0)
    min_applied = torch.where(has, min_applied, 0)
    space = torch.clamp(W - (state.next_slot - min_applied), min=0)  # [G]
    group_open = has & head_alive & head_active
    valid_in = (inbox.req != NO_REQUEST) & group_open[None, :]  # [P, G]
    # FIFO within the tick; truncate right after the first stop (nothing
    # may be ordered past a stop)
    taken_pre = valid_in & (_cumsum(valid_in) <= space[None, :])
    stop_taken = inbox.stop & taken_pre
    stop_before = _cumsum(stop_taken) - stop_taken.to(I32)
    taken = taken_pre & (stop_before == 0)  # [P, G]
    k = taken.sum(dim=0, dtype=I32)  # [G]
    # dense order of taken requests within the tick
    ord_in = _cumsum(taken) - 1  # [P, G]
    new_slot_p = state.next_slot[None, :] + ord_in  # [P, G] absolute slots
    # scatter into the head's ring: plane i receives the taken request whose
    # slot hashes to i
    tgt_i = torch.bitwise_and(new_slot_p, Wm)  # [P, G]
    one_hot = taken[None] & (tgt_i[None] == jw[:, None, :])  # [W, P, G]
    h_req = torch.where(one_hot, inbox.req[None], 0).sum(dim=1, dtype=I32)
    h_stop = (one_hot & inbox.stop[None]).any(dim=1)
    h_slot = torch.where(one_hot, new_slot_p[None], 0).sum(dim=1, dtype=I32)
    h_new = one_hot.any(dim=1)  # [W, G] planes written this tick
    next_slot = state.next_slot + k

    hmask = is_head[:, None, :] & h_new[None]
    c_req = torch.where(hmask, h_req[None], state.c_req)
    c_slot = torch.where(hmask, h_slot[None], state.c_slot)
    c_stop = torch.where(hmask, h_stop[None], state.c_stop)

    # ---------------- one-hop forward propagation ----------------
    # recv watermark: head = next_slot (owns everything it ordered); others
    # advance to their predecessor's *previous* applied watermark (one hop
    # per tick), but only while the predecessor is alive
    alive_rg = alive[:, None].expand(R, G)
    pred_applied = torch.stack([sel_r(state.applied, pred[r])
                                for r in range(R)])
    pred_alive = torch.stack([sel_r(alive_rg, pred[r]) for r in range(R)])
    recv_hi = torch.where(
        is_head, next_slot[None, :],
        torch.where(pred_alive, torch.maximum(pred_applied, state.applied),
                    state.applied))
    recv_hi = torch.where(member, recv_hi, 0)
    # copy the predecessor's ring planes covering [applied, recv_hi):
    # a select over the replica axis (R is small), plane-parallel
    pred3 = pred[:, None, :]  # [R, 1, G]
    p_req = torch.zeros((R, W, G), dtype=I32, device=dev)
    p_slot = torch.full((R, W, G), -1, dtype=I32, device=dev)
    p_stop = torch.zeros((R, W, G), dtype=BOOL, device=dev)
    for rp in range(R):
        m = pred3 == rp
        p_req = torch.where(m, c_req[rp][None], p_req)
        p_slot = torch.where(m, c_slot[rp][None], p_slot)
        p_stop = torch.where(m, c_stop[rp][None], p_stop)
    want = ((p_slot >= state.applied[:, None, :])
            & (p_slot < recv_hi[:, None, :]) & (p_slot >= 0)
            & member[:, None, :] & ~is_head[:, None, :])
    c_req = torch.where(want, p_req, c_req)
    c_slot = torch.where(want, p_slot, c_slot)
    c_stop = torch.where(want, p_stop, c_stop)

    # ---------------- apply ----------------
    can_apply = member & alive[:, None] & (
        state.status == int(GroupStatus.ACTIVE))
    new_applied = torch.where(can_apply, recv_hi, state.applied)
    exec_base = state.applied
    exec_count = torch.clamp(new_applied - exec_base, 0, W)
    # window-ordered exec planes: plane j = slot exec_base + j; the three
    # rings share the per-replica index, so one gather launch reads them
    s_j = exec_base[:, None, :] + jw[None]  # [R, W, G]
    i_j = torch.bitwise_and(s_j, Wm)
    e_req, e_slot, e_stop = gather_planes_many((c_req, c_slot, c_stop), i_j)
    live_j = (jw[None] < exec_count[:, None, :]) & (e_slot == s_j)
    exec_req = torch.where(live_j, e_req, NO_REQUEST)
    exec_stop = live_j & e_stop
    # count only planes actually present (a ring mismatch never counts)
    exec_count = live_j.sum(dim=1, dtype=I32)
    new_applied = exec_base + exec_count

    # a stop anywhere in the applied range stops this replica's chain state
    status = torch.where(exec_stop.any(dim=1), int(GroupStatus.STOPPED),
                         state.status)

    committed_now = torch.where(has, sel_r(exec_count, tail), 0)

    new_state = state._replace(
        applied=new_applied, status=status, c_req=c_req, c_slot=c_slot,
        c_stop=c_stop, next_slot=next_slot)
    out = ChainOutbox(
        exec_req=exec_req, exec_stop=exec_stop, exec_base=exec_base,
        exec_count=exec_count, intake_taken=taken, head_id=head,
        tail_id=torch.where(has, tail, -1), committed_now=committed_now)
    return new_state, out


def chain_tick(state, inbox: ChainInbox):
    return chain_tick_impl(state, inbox)


class HostChainOutbox(NamedTuple):
    """Numpy mirror of :class:`ChainOutbox` fetched in one device->host
    copy."""

    exec_req: "np.ndarray"
    exec_stop: "np.ndarray"
    exec_base: "np.ndarray"
    exec_count: "np.ndarray"
    intake_taken: "np.ndarray"
    head_id: "np.ndarray"
    tail_id: "np.ndarray"
    committed_now: "np.ndarray"


def pack_chain_outbox_impl(out: ChainOutbox) -> torch.Tensor:
    return torch.cat([
        out.exec_req.reshape(-1),
        out.exec_stop.to(I32).reshape(-1),
        out.exec_base.reshape(-1),
        out.exec_count.reshape(-1),
        out.intake_taken.to(I32).reshape(-1),
        out.head_id.reshape(-1),
        out.tail_id.reshape(-1),
        out.committed_now.reshape(-1),
    ])


def unpack_chain_outbox(flat, R: int, P: int, W: int,
                        G: int) -> HostChainOutbox:
    """Host-side inverse of :func:`pack_chain_outbox_impl` (the device
    sync point for a device buffer)."""
    flat = _host(flat)
    sizes = [R * W * G, R * W * G, R * G, R * G, P * G, G, G, G]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    cut = [flat[offs[i]:offs[i + 1]] for i in range(len(sizes))]
    return HostChainOutbox(
        exec_req=cut[0].reshape(R, W, G),
        exec_stop=cut[1].reshape(R, W, G).astype(bool),
        exec_base=cut[2].reshape(R, G),
        exec_count=cut[3].reshape(R, G),
        intake_taken=cut[4].reshape(P, G).astype(bool),
        head_id=cut[5],
        tail_id=cut[6],
        committed_now=cut[7],
    )


def chain_tick_packed(state, inbox: ChainInbox):
    """Tick + the whole outbox packed into one int32 buffer: O(R*W*G), so
    at 2^20 chains each tick copies ~200 MB back to the host."""
    state, out = chain_tick_impl(state, inbox)
    return state, pack_chain_outbox_impl(out)


def make_inbox(n_replicas: int, n_groups: int, per_tick: int,
               device=None) -> ChainInbox:
    """An empty inbox on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return ChainInbox(
        req=torch.zeros((per_tick, n_groups), dtype=I32, device=dev),
        stop=torch.zeros((per_tick, n_groups), dtype=BOOL, device=dev),
        alive=torch.ones((n_replicas,), dtype=BOOL, device=dev),
    )
