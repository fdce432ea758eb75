"""Shared host plumbing for per-process consensus nodes (paxos + chain).

Both Mode B node flavors (``modeb/manager.py``, ``chain/modeb.py``) carry
the same subtle host-side machinery around their protocol kernels; fixes to
any of these must land in ONE place:

* the rid space (origin-tagged 24-bit sequences) and its regression guard;
* the bounded payload store and forwarded-rid dedup (``_routed``);
* the work-arrival wake hook for event-driven tick drivers;
* failure-detector attachment feeding the per-tick alive mask;
* the whois-birth gate (control-plane epoch groups must be born seeded);
* purging staged mirror frames when a group row is freed;
* log-before-respond callback flushing.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

import numpy as np

RID_SHIFT = 24
RID_MASK = (1 << RID_SHIFT) - 1


def rid_origin(rid: int) -> int:
    return rid >> RID_SHIFT


class ModeBCommon:
    """Mixin: expects the concrete node to define ``r``, ``members``,
    ``alive``, ``lock``, ``stats``, ``wal``, ``_pending_mirror``, and the
    collections initialized by :meth:`_init_common`."""

    def _init_common(self) -> None:
        self._next_seq = 1
        #: guards the rid sequence: next_rid runs on client threads (the
        #: lock-free propose fast path) while bump_seq runs on the tick
        self._seq_lock = threading.Lock()
        self.payloads: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict()
        )
        self._payload_cap = 1 << 16
        self._routed: "collections.OrderedDict[int, bool]" = (
            collections.OrderedDict()
        )
        self._held_callbacks: list = []
        #: extra (rid, stop, payload) items for the next frame broadcast —
        #: the digest-mode entry-replica payload dissemination channel
        self._extra_pay: list = []
        #: digest-only accepts off unless the concrete node wires it from
        #: cfg.paxos.digest_accepts
        self._digest_accepts = False
        #: ring payload dissemination (HT-Ring Paxos): when on, broadcast
        #: frames carry NO payload table at all — every payload rides the
        #: relay ring instead (one downstream send per tick).  Wired from
        #: cfg.paxos.ring_dissemination by nodes that implement the relay.
        self._ring_dissemination = False
        #: own payloads staged for the next downstream relay slab
        self._ring_out: list = []
        #: rids already pushed onto the ring from here (re-placement after a
        #: coordinator change must not re-disseminate; bounded like _routed)
        self._ring_sent: "collections.OrderedDict[int, bool]" = (
            collections.OrderedDict()
        )
        self._fd = None
        self.on_work: Optional[Callable[[], None]] = None
        self.whois_birth: Optional[Callable[[str], bool]] = None
        #: called with the list of freshly appended member ids after a
        #: runtime universe expansion (coordinators refresh their
        #: id<->slot caches here)
        self.on_expand: list = []

    # ------------------------------------------------------------- rid space
    def next_rid(self) -> int:
        with self._seq_lock:
            if self._next_seq >= RID_MASK:
                # the sequence would bleed into the origin bits and corrupt
                # rid routing — fail loudly instead of silently colliding
                raise RuntimeError(
                    f"{self.node_id}: rid sequence space exhausted "
                    f"({self._next_seq} >= 2^{RID_SHIFT})"
                )
            rid = (self.r << RID_SHIFT) | self._next_seq
            self._next_seq += 1
            return rid

    def bump_seq(self, rids) -> None:
        """Advance the local rid sequence past any observed own-origin rids
        (a rid forwarded to a remote never enters the local journal, so
        after recovery the counter could regress and a fresh proposal would
        collide with a committed rid)."""
        a = np.asarray(rids).ravel()
        if a.size == 0:
            return
        mine = a[(a >> RID_SHIFT) == self.r]
        if mine.size:
            with self._seq_lock:
                self._next_seq = max(self._next_seq,
                                     int(mine.max() & RID_MASK) + 1)

    # --------------------------------------------------------- payload store
    def _store_payload(self, rid: int, payload: bytes, stop: bool) -> None:
        self.payloads[rid] = (payload, stop)
        while len(self.payloads) > self._payload_cap:
            self.payloads.popitem(last=False)

    def _mark_routed(self, rid: int) -> bool:
        """Record a forwarded rid; False if it was already routed here
        (retransmission dedup at the same GC depth as the payload table)."""
        if rid in self._routed:
            return False
        self._routed[rid] = True
        while len(self._routed) > self._payload_cap:
            self._routed.popitem(last=False)
        return True

    # ------------------------------------------------------------ expansion
    def expand_universe(self, new_ids, _log: bool = True) -> bool:
        """Grow the replica universe at runtime: append ``new_ids`` as
        fresh slots (ReconfigureActiveNodeConfig analog,
        Reconfigurator.java:1044).  Every member node must apply the same
        expansion in the same order (drive it from a committed node-config
        record) so slot indices agree; the new node itself boots with the
        full expanded topology.  Existing groups are untouched — they adopt
        the new slots through ordinary epoch reconfiguration — and the new
        slots start dead until the failure detector hears from them.

        Flavor hooks: ``_pre_expand`` (e.g. drain a tick pipeline whose
        outbox shapes change with R), ``_expand_state(n_new)`` (grow the
        protocol state arrays), ``_reset_intake_buffers`` (re-size the
        per-tick staging)."""
        with self.lock:
            fresh = [nid for nid in new_ids if nid not in self.members]
            if not fresh:
                return False
            if self.R + len(fresh) > (1 << 6):
                raise ValueError("replica-slot space exceeds rid encoding")
            self._pre_expand()
            self.members.extend(fresh)
            self.R = len(self.members)
            self.alive = np.concatenate(
                [self.alive, np.zeros(len(fresh), bool)]
            )
            self._expand_state(len(fresh))
            self._reset_intake_buffers()
            if self._fd is not None:
                for nid in fresh:
                    self._fd.monitor(nid)
            # the jit re-specializes on the new shapes automatically; the
            # frame codec carries sender_r explicitly, and peers that have
            # not expanded yet drop frames with sender_r >= their R until
            # their own expansion commits (eventual agreement rides the
            # same committed node-config stream)
            self.stats["universe_expansions"] += 1
            if _log and self.wal is not None:
                self.wal.log_expand(fresh)
            for hook in self.on_expand:
                hook(fresh)
            return True

    def _pre_expand(self) -> None:  # overridable
        pass

    def _expand_state(self, n_new: int) -> None:
        raise NotImplementedError

    def _reset_intake_buffers(self) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------- liveness
    def set_alive(self, r: int, up: bool) -> None:
        self.alive[r] = up

    def attach_failure_detector(self, fd) -> None:
        """Feed the liveness mask from a keep-alive failure detector: every
        tick re-derives ``alive`` from ``fd.alive_mask`` (own row always
        up) — FailureDetection → candidacy/re-link wiring."""
        self._fd = fd
        for nid in self.members:
            fd.monitor(nid)

    def _refresh_alive(self) -> None:
        if self._fd is not None:
            mask = self._fd.alive_mask(self.members)
            mask[self.r] = True
            self.alive = mask

    # ----------------------------------------------------------------- wake
    def _wake(self) -> None:
        if self.on_work is not None:
            self.on_work()

    # ------------------------------------------------------------ frames (tx)
    #: soft budget per encoded frame; a full-state frame over a huge group
    #: population (or a tick placing large client payloads) fragments into
    #: several frames under this size instead of tripping transport
    #: MAX_FRAME (the PrepareReplyAssembler analog,
    #: gigapaxos/paxosutil/PrepareReplyAssembler.java:1-224)
    FRAME_BUDGET = 4 * 1024 * 1024

    def _frame_mask_and_payloads(self):
        """Select which group rows and payloads this tick's frames carry:
        dirty rows + the rotating anti-entropy slice (or every occupied row
        after a sync request), plus every payload placed this tick."""
        full = self._force_full
        if full:
            mask = self._occupied.copy()
        else:
            mask = self._dirty.copy()
            if self.anti_entropy_every > 0:
                # rotating anti-entropy: each tick re-ships the 1/N slice of
                # occupied rows with row % N == tick % N — the same per-row
                # refresh period as an every-N-ticks full frame, without the
                # O(G) burst
                mask |= self._occupied & (
                    self._ae_phase == self.tick_num % self.anti_entropy_every
                )
        digest = self._digest_accepts
        ring = digest and self._ring_dissemination
        pay = []
        for row, take in self._placed:
            for rid, _p in take:
                if digest and (rid >> RID_SHIFT) != self.r:
                    # digest mode: the ENTRY node broadcast this payload
                    # (see _forward); the coordinator's frames carry only
                    # the rid — the digest-only ACCEPT
                    # (PendingDigests.java:23) that cuts coordinator
                    # egress from (R-1)x payload to ~0
                    continue
                rec = self.outstanding.get(rid)
                if rec is not None:
                    item = (rid, rec.stop, rec.payload)
                elif rid in self.payloads:
                    pl, stop = self.payloads[rid]
                    item = (rid, stop, pl)
                else:
                    continue
                if ring:
                    # ring dissemination: locally-entered payloads ride the
                    # relay ring too — broadcast frames stay payload-free
                    self._stage_ring(item)
                else:
                    pay.append(item)
        extra = getattr(self, "_extra_pay", None)
        if extra:
            if ring:
                for item in extra:
                    self._stage_ring(item)
            else:
                pay.extend(extra)
            extra.clear()
        return full, mask, pay

    def _stage_ring(self, item) -> None:
        """Queue an own-origin payload for the next downstream relay slab,
        once per rid (placement can repeat across coordinator changes)."""
        rid = item[0]
        if rid in self._ring_sent:
            return
        self._ring_sent[rid] = True
        while len(self._ring_sent) > self._payload_cap:
            self._ring_sent.popitem(last=False)
        self._ring_out.append(item)

    def _build_frames_common(self, row_wire_bytes: int, extract, encode):
        """Shared fragmentation loop for both protocol flavors.

        ``extract(chunk_rows) -> fields`` gathers the frame columns for one
        chunk (one fused device program); ``encode(gids, fields, pay, full)
        -> bytes`` runs the wire codec.  Rows and payloads are chunked
        separately against FRAME_BUDGET, so each emitted frame is bounded by
        ~2x budget (a single oversized payload still ships alone; truly
        huge blobs belong on the net/bulk.py out-of-band path)."""
        from . import wire

        full, mask, pay = self._frame_mask_and_payloads()
        rows_idx = np.nonzero(mask)[0]
        if len(rows_idx) == 0 and not pay:
            return []
        self._force_full = False
        self._dirty = np.zeros(self.G, bool)
        gids = np.zeros(len(rows_idx), np.uint64)
        for i, row in enumerate(rows_idx):
            name = self.rows.name(int(row))
            gids[i] = wire.gid_of(name) if name is not None else 0
        known = gids != 0
        rows_idx, gids = rows_idx[known], gids[known]
        per_frame = max(1, self.FRAME_BUDGET // row_wire_bytes)
        pay_chunks: list = []
        acc, acc_bytes = [], 0
        for item in pay:
            sz = len(item[2]) + 16
            if acc and acc_bytes + sz > self.FRAME_BUDGET:
                pay_chunks.append(acc)
                acc, acc_bytes = [], 0
            acc.append(item)
            acc_bytes += sz
        if acc:
            pay_chunks.append(acc)
        frames: list = []
        n_total = len(rows_idx)
        row_chunks = [
            (rows_idx[lo:lo + per_frame], gids[lo:lo + per_frame])
            for lo in range(0, n_total, per_frame)
        ] or [(rows_idx[:0], gids[:0])]
        for ci in range(max(len(row_chunks), len(pay_chunks))):
            chunk_rows, chunk_gids = (
                row_chunks[ci] if ci < len(row_chunks)
                else (rows_idx[:0], gids[:0])
            )
            chunk_pay = pay_chunks[ci] if ci < len(pay_chunks) else []
            fields = extract(chunk_rows)
            buf = encode(chunk_gids, fields, chunk_pay, full)
            self.stats["frames_sent"] += 1
            self.stats["frame_groups"] += len(chunk_rows)
            self.stats["frame_bytes"] += len(buf)
            frames.append(buf)
        return frames

    # -------------------------------------------------------------- mirrors
    def _purge_staged_row(self, row: int) -> None:
        """Drop staged mirror-frame entries targeting a freed row: their row
        indices were resolved at frame-arrival time, and a group recreated
        into the recycled row must not inherit stale facts."""
        if not self._pending_mirror:
            return
        pend = []
        for sr, rows, keep, frame in self._pending_mirror:
            sel = rows != row
            if sel.all():
                pend.append((sr, rows, keep, frame))
            elif sel.any():
                pend.append((sr, rows[sel], keep[sel], frame))
        self._pending_mirror = pend

    # ------------------------------------------------------------ callbacks
    def _flush_callbacks(self) -> None:
        """Release client responses only once the WAL covering their tick is
        durable (log-before-respond, AbstractPaxosLogger.java:157-178)."""
        if not self._held_callbacks:
            return
        if self.wal is not None and not self.wal.is_synced():
            return
        held, self._held_callbacks = self._held_callbacks, []
        for cb, rid, resp in held:
            cb(rid, resp)
