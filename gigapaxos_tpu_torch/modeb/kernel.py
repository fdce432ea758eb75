"""Per-node consensus step for Mode B (independent processes per replica).

Mode A runs the whole replica set as one device program (``ops/tick.py``);
Mode B gives every node its own process, disk and device state — the
reference's deployment shape (one ``PaxosManager`` per machine, replica
traffic over the network).

Design: each node holds the full ``[R, ...]`` state tensors but is
**authoritative only for its own row r**.  Peer rows are *mirrors*, updated
exclusively by replica frames received over the transport (``wire.py``).
The node step reuses the fused tick (``paxos_tick_impl``) and then keeps
only row r of the result — peer rows stay whatever the last frames said.

Why this is safe with stale mirrors: the tick runs with ``own_row=r``,
which confines every state *transition* — candidacy, promise upgrade,
prepare win, intake, accept — to row r.  Peer rows are pure frame-derived
snapshots, and every cross-replica read then consumes only *monotone
facts*:

* a promise in a mirror row means that acceptor really promised that ballot
  at its frame snapshot (promises only rise), so counting a prepare
  majority from mirrors counts real promises, and the carryover window
  rides the same frame snapshot;
* a vote (accepted pvalue) in a mirror is a historical fact: once a
  majority ever accepted (slot, ballot, value), that value is chosen —
  tallying stale votes can only *under*-count, never fabricate a quorum;
* a pushing peer coordinator (mirror coord_active + prop ring, shipped
  together in one frame) is a real ACCEPT in flight;
* decisions are facts by construction.

Staleness therefore costs latency (a decision needs a frame round-trip to
gather votes), never agreement.

Kernels: a node tick is one ``paxos_tick_impl`` with ``own_row=r``, so it
launches the tick's 5 plane gathers and 1 key match (fast re-election on or
off).  The frame gather (:func:`frame_extract`) and the mirror scatter
(:func:`mirror_apply_impl`) are plain indexing, like the reference's XLA
gathers and scatters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.device_kv import kv_apply, register_requests
from ..ops.tick import (TickInbox, _host, pack_outbox_impl, paxos_tick_impl,
                        unpack_outbox)
from .wire import (FLAG_COORD_ACTIVE, FLAG_COORD_FAST, FLAG_COORD_PREPARING,
                   RING_BITS, RINGS, SCALARS)

I32 = torch.int32

#: own-row state fields shipped in replica frames ([R, G] / [R, W, G])
FRAME_FIELDS_2D = ("exec_slot", "bal_num", "bal_coord", "status",
                   "coord_active", "coord_preparing", "coord_fast",
                   "coord_bnum", "next_slot")
FRAME_FIELDS_3D = ("acc_bnum", "acc_bcoord", "acc_req", "acc_slot",
                   "acc_stop", "dec_req", "dec_slot", "dec_valid",
                   "dec_stop", "prop_req", "prop_slot", "prop_valid",
                   "prop_stop")


def node_tick_impl(state, inbox: TickInbox, r: int, fast: bool = False):
    """One Mode-B node step: fused dataflow, own-row commit, change mask.

    Returns (state', outbox, changed[G]) where ``changed`` (bool) marks
    groups whose own-row frame fields differ from before: the delta-frame
    mask.  ``fast`` enables consecutive-ballot fast re-election; the
    ``coord_fast`` bit it maintains travels in the frame flags word, so
    peers' acceptors apply the conflict-refusal rule to this node's fast
    pushes."""
    new, out = paxos_tick_impl(state, inbox, own_row=r, fast_elect=fast)
    R = state.exec_slot.shape[0]
    row2 = (torch.arange(R, device=state.exec_slot.device) == r)[:, None]
    row3 = row2[:, :, None]                      # [R, 1, 1]

    merged = {}
    changed = torch.zeros(state.exec_slot.shape[1], dtype=torch.bool,
                          device=state.exec_slot.device)
    for f in FRAME_FIELDS_2D:
        old_a, new_a = getattr(state, f), getattr(new, f)
        merged[f] = torch.where(row2, new_a, old_a)
        changed = changed | (new_a[r] != old_a[r])
    for f in FRAME_FIELDS_3D:
        old_a, new_a = getattr(state, f), getattr(new, f)
        merged[f] = torch.where(row3, new_a, old_a)
        changed = changed | (new_a[r] != old_a[r]).any(dim=0)
    # member/n_members/epoch are config state managed by create/free ops,
    # identical on every node — the tick never writes them
    return state._replace(**merged), out, changed


@functools.lru_cache(maxsize=None)
def node_tick_packed(r: int, fast: bool = False):
    """Per-node step returning (state', flat_i32) where the flat buffer is
    pack_outbox(outbox) ++ changed: ONE device-to-host transfer per tick.
    The factory keeps the reference's call shape (``node_tick_packed(r,
    fast)(state, inbox)``)."""

    def impl(state, inbox):
        new, out, changed = node_tick_impl(state, inbox, r, fast)
        flat = torch.cat([pack_outbox_impl(out), changed.to(I32)])
        return new, flat

    return impl


def unpack_node_tick(flat, R: int, P: int, W: int, G: int):
    """Host inverse of :func:`node_tick_packed`'s flat buffer."""
    flat = _host(flat)
    out = unpack_outbox(flat[:-G], R, P, W, G)
    return out, flat[-G:].astype(bool)


@functools.lru_cache(maxsize=None)
def node_tick_device(r: int, K: int, fast: bool = False):
    """Per-node step with the device KV app fused behind it (the Mode-B
    twin of ``models.device_kv.fused_compact``): descriptor upload +
    consensus tick + own-row execution on the device in one call.

    The node's kv has replica-axis 1 (it executes only its own row).  Rows
    with ANY descriptor miss this tick — or held by the host (``hold``:
    rows whose execution stream is stalled on an unarrived payload) — are
    SUPPRESSED on the device: no kv write at all, because applying slot j+1
    while slot j is missing/stalled would break RSM order.  The host
    re-applies a suppressed row's batch in order through the scalar
    fallback.  reg_*: up to K new descriptors (rid 0 = empty).

    Returns (state', kv', flat) with flat = pack_outbox ++ changed[G] ++
    resp[W*G] ++ row_skip[G] (own row, window-major)."""

    def impl(state, kv, inbox, reg_rids, reg_ops, reg_keys, reg_vals, hold):
        kv = register_requests(kv, reg_rids, reg_ops, reg_keys, reg_vals,
                               mix=True)
        new, out, changed = node_tick_impl(state, inbox, r, fast)
        er = out.exec_req[r:r + 1]      # [1, W, G]
        ec = out.exec_count[r:r + 1]
        kv2, resp, miss = kv_apply(kv, er, ec, mix=True)
        hold = torch.as_tensor(hold, dtype=torch.bool, device=er.device)
        row_skip = miss[0].any(dim=0) | hold  # [G]
        # suppress every kv effect of a skipped row (host replays in order)
        keep = ~row_skip[None, :, None]
        kv2 = kv2._replace(
            key=torch.where(keep, kv2.key, kv.key),
            val=torch.where(keep, kv2.val, kv.val),
        )
        flat = torch.cat([
            pack_outbox_impl(out), changed.to(I32),
            resp[0].reshape(-1), row_skip.to(I32),
        ])
        return new, kv2, flat

    return impl


def unpack_node_tick_device(flat, R: int, P: int, W: int, G: int):
    """Host inverse of :func:`node_tick_device`: -> (outbox, changed[G],
    resp[W, G], row_skip[G])."""
    flat = _host(flat)
    tail = G + W * G + G
    out = unpack_outbox(flat[:-tail], R, P, W, G)
    changed = flat[-tail:-tail + G].astype(bool)
    resp = flat[-tail + G:-G].reshape(W, G)
    row_skip = flat[-G:].astype(bool)
    return out, changed, resp, row_skip


@functools.lru_cache(maxsize=None)
def frame_extract(r: int, K: int):
    """Own-row gather for frame building: selects ``K`` rows of every frame
    field and returns one flat i32 buffer (layout: scalars [S,K] ++ flags
    [K] ++ rings [NR,K,W] ++ bits [NB,K,W]), one device-to-host transfer
    for the ~21 fields.  K is pow2-padded by the caller (padding rows
    repeat row 0), and the whole buffer, padded tail included, equals the
    reference's."""

    def impl(state, rows):
        rows = torch.as_tensor(rows, device=state.exec_slot.device).long()
        parts = []
        for f in SCALARS:
            parts.append(getattr(state, f)[r, rows])                 # [K]
        flags = (state.coord_active[r, rows].to(I32) * FLAG_COORD_ACTIVE
                 + state.coord_preparing[r, rows].to(I32)
                 * FLAG_COORD_PREPARING
                 + state.coord_fast[r, rows].to(I32) * FLAG_COORD_FAST)
        parts.append(flags)
        for f in RINGS + RING_BITS:
            parts.append(getattr(state, f)[r][:, rows].T)            # [K, W]
        return torch.cat([p.to(I32).reshape(-1) for p in parts])

    return impl


def unpack_frame_extract(flat, n: int, K: int, W: int):
    """Host inverse of :func:`frame_extract`: -> (scalars dict, flags,
    rings dict, ring_bits dict) truncated to the first ``n`` rows."""
    flat = _host(flat)
    off = 0
    scalars = {}
    for f in SCALARS:
        scalars[f] = flat[off:off + K][:n]
        off += K
    flags = flat[off:off + K][:n]
    off += K
    rings = {}
    for f in RINGS:
        rings[f] = flat[off:off + K * W].reshape(K, W)[:n]
        off += K * W
    bits = {}
    for f in RING_BITS:
        bits[f] = flat[off:off + K * W].reshape(K, W)[:n].astype(bool)
        off += K * W
    return scalars, flags, rings, bits


def mirror_apply_impl(state, sr, rows, scalars, flags, rings, bits):
    """Apply one decoded replica frame to sender ``sr``'s mirror rows, in
    place, and return the state.

    rows: int [K], padded with G (the reference's out-of-bounds rows, which
    its scatter drops); scalars: i32 [S, K] in wire.SCALARS order; flags:
    i32 [K]; rings: i32 [NR, K, W] in wire.RINGS order; bits: bool [NB, K,
    W] in wire.RING_BITS order (numpy arrays or tensors).  A torch index
    has no drop mode (an out-of-range row raises on the CPU and traps on
    CUDA), so the out-of-range rows are filtered on the host before the
    writes; the rows are host data in every caller, K entries each."""
    dev = state.exec_slot.device
    G = state.exec_slot.shape[1]
    sr = int(sr)
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows,
                   np.int64).reshape(-1)
    keep = np.flatnonzero((r >= 0) & (r < G))
    if keep.size == 0:
        return state
    idx = torch.as_tensor(r[keep], device=dev)
    sel = torch.as_tensor(keep, device=dev)

    def col(a, dtype, axis):
        return torch.as_tensor(a, device=dev).to(dtype).index_select(axis,
                                                                     sel)

    scal = col(scalars, I32, 1)                          # [S, n]
    flg = col(flags, I32, 0)                             # [n]
    rng = col(rings, I32, 1)                             # [NR, n, W]
    bts = col(bits, torch.bool, 1)                       # [NB, n, W]
    for i, f in enumerate(SCALARS):
        getattr(state, f)[sr].index_copy_(0, idx, scal[i])
    state.coord_active[sr].index_copy_(0, idx, (flg & FLAG_COORD_ACTIVE) > 0)
    state.coord_preparing[sr].index_copy_(
        0, idx, (flg & FLAG_COORD_PREPARING) > 0)
    state.coord_fast[sr].index_copy_(0, idx, (flg & FLAG_COORD_FAST) > 0)
    for i, f in enumerate(RINGS):
        getattr(state, f)[sr].index_copy_(1, idx, rng[i].T.contiguous())
    for i, f in enumerate(RING_BITS):
        getattr(state, f)[sr].index_copy_(1, idx, bts[i].T.contiguous())
    return state


#: the reference's jitted name; the port writes the mirrors in place
mirror_apply = mirror_apply_impl


def ring_downstream(alive, r: int) -> int:
    """Next alive replica clockwise from ``r``: the dissemination-ring hop
    target (HT-Ring Paxos, arxiv 1507.04086).  The tick orders rids only
    (digest accepts); the payload bytes those rids reference travel along
    the ring this routing defines — one downstream send per node per tick
    regardless of R.  Returns -1 when no OTHER replica is alive (a
    singleton keeps its payloads staged until someone rejoins).  Host-side:
    ``alive`` is the node's numpy liveness mirror, never device state."""
    R = len(alive)
    for k in range(1, R):
        i = (r + k) % R
        if alive[i]:
            return i
    return -1
