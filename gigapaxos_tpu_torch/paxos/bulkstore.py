"""Columnar outstanding-request store for the high-throughput manager path.

The reference tracks outstanding requests in a per-request object map
(``PaxosManager.java:189-259`` ``outstanding.requests``); at the dense
design's operating point (10^5-10^6 requests in flight) a Python dict of
per-request objects costs more host time than the whole device tick.  This
store is the MultiArrayMap idea (``utils/MultiArrayMap.java:41``) applied to
the request path: one numpy column per field, request ids mapped to slots by
``rid & (capacity-1)``, every lifecycle step (admit, execute-dedup, respond,
free) a vectorized operation over index arrays.

Request ids are allocated as contiguous blocks by the manager, so a store
slot is reused only after ~capacity newer requests were admitted; ``alloc``
refuses to wrap onto a slot whose request is still live (the caller holds
the block back until the window drains — bounded-outstanding backpressure,
the analog of the reference's MAX_OUTSTANDING_REQUESTS throttle,
``PaxosManager.java:1298``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class BulkOverrun(RuntimeError):
    """Allocation would reuse a slot whose request is still outstanding."""


class BulkStore:
    def __init__(self, capacity: int):
        assert capacity & (capacity - 1) == 0, "capacity must be a power of 2"
        self.cap = capacity
        self.mask = capacity - 1
        self.row = np.zeros(capacity, np.int32)
        self.entry = np.zeros(capacity, np.int32)
        self.stop = np.zeros(capacity, bool)
        self.exec_mask = np.zeros(capacity, np.int64)  # bit r = replica r ran it
        self.responded = np.zeros(capacity, bool)
        self.slot = np.full(capacity, -1, np.int32)
        self.valid = np.zeros(capacity, bool)
        self.rid = np.zeros(capacity, np.int64)  # occupant (stale-slot guard)
        self.payload = np.empty(capacity, object)
        #: payload byte length, computed ONCE at admission — the execution
        #: side runs per replica (R passes) and a per-object len() there
        #: costs more than the whole vectorized lifecycle
        self.pay_len = np.zeros(capacity, np.int32)
        self.response = np.empty(capacity, object)
        #: lowest rid that may still be live (slots below are reclaimable)
        self.lo = 0
        self.hi = 0  # one past the highest rid ever admitted
        self.n_live = 0
        self.done = 0  # responded-and-fully-executed requests ever freed

    # ------------------------------------------------------------------ admit
    def idx_of(self, rids: np.ndarray) -> np.ndarray:
        return (rids & self.mask).astype(np.intp)

    def lookup(self, rids: np.ndarray) -> np.ndarray:
        """Index array for ``rids`` plus a mask of which are live here."""
        idx = self.idx_of(rids)
        ok = self.valid[idx] & (self.rid[idx] == rids)
        return idx, ok

    def _advance_lo(self) -> None:
        while self.lo < self.hi and not self.valid[self.lo & self.mask]:
            self.lo += 1

    def admit(self, rid0: int, rows: np.ndarray, entries: np.ndarray,
              stops: Optional[np.ndarray], payloads) -> np.ndarray:
        """Admit a contiguous rid block [rid0, rid0+n); returns the rids.

        ``payloads``: a sequence of bytes (len n) or one bytes object shared
        by every request (zero-copy fan-out for generated load).
        """
        n = len(rows)
        if rid0 + n - self.lo > self.cap:
            self._advance_lo()
            if rid0 + n - self.lo > self.cap:
                raise BulkOverrun(
                    f"{self.n_live} live requests; oldest rid {self.lo} "
                    f"not yet complete (capacity {self.cap})"
                )
        if self.hi == 0:
            self.lo = rid0
        self.hi = max(self.hi, rid0 + n)
        rids = rid0 + np.arange(n, dtype=np.int64)
        idx = self.idx_of(rids)
        self.row[idx] = rows
        self.entry[idx] = entries
        self.stop[idx] = False if stops is None else stops
        self.exec_mask[idx] = 0
        self.responded[idx] = False
        self.slot[idx] = -1
        self.valid[idx] = True
        self.rid[idx] = rids
        if isinstance(payloads, (bytes, bytearray)):
            self.payload[idx] = bytes(payloads)
            self.pay_len[idx] = len(payloads)
        else:
            self.payload[idx] = payloads
            self.pay_len[idx] = np.fromiter(
                (len(p) for p in payloads), np.int32, count=n
            )
        self.response[idx] = None
        self.n_live += n
        return rids

    def admit_at(self, rids: np.ndarray, rows, entries, stops,
                 payloads) -> np.ndarray:
        """Replay admission of explicit (possibly non-contiguous) rids.
        Rids already live keep their progress (a request admitted before a
        snapshot and placed after it appears in both); returns the mask of
        newly admitted entries."""
        rids = np.asarray(rids, np.int64)
        idx = self.idx_of(rids)
        new = ~(self.valid[idx] & (self.rid[idx] == rids))
        # config columns refresh for EVERY replayed rid: a re-placement
        # record may carry a re-homed entry replica (the original died
        # between two placements of the same rid); only progress columns
        # are preserved for already-live entries
        self.row[idx] = np.asarray(rows, np.int32)
        self.entry[idx] = np.asarray(entries, np.int32)
        self.stop[idx] = (np.zeros(len(rids), bool) if stops is None
                          else np.asarray(stops, bool))
        ni = idx[new]
        self.exec_mask[ni] = 0
        self.responded[ni] = False
        self.slot[ni] = -1
        self.valid[ni] = True
        self.rid[ni] = rids[new]
        if isinstance(payloads, (bytes, bytearray)):
            self.payload[ni] = bytes(payloads)
            self.pay_len[ni] = len(payloads)
        else:
            pa = np.empty(len(rids), object)
            pa[:] = list(payloads)
            self.payload[ni] = pa[new]
            self.pay_len[ni] = np.fromiter(
                (0 if p is None else len(p) for p in pa[new]), np.int32,
                count=len(ni),
            )
        self.response[ni] = None
        self.n_live += len(ni)
        if len(rids):
            self.lo = min(self.lo, int(rids.min())) if self.hi else int(rids.min())
            self.hi = max(self.hi, int(rids.max()) + 1)
        return new

    # ---------------------------------------------------------------- execute
    def mark_executed(self, idx: np.ndarray, r: int) -> np.ndarray:
        """Set replica r's executed bit at ``idx``; returns which entries
        were NEW (not already executed by r — the cross-tick duplicate-commit
        dedup that replaces the per-(r,row) ``_seen`` maps).  ``idx`` must be
        first-occurrence-filtered within the batch already."""
        bit = np.int64(1 << r)
        fresh = (self.exec_mask[idx] & bit) == 0
        fi = idx[fresh]
        self.exec_mask[fi] |= bit
        return fresh

    def free_done(self, idx: np.ndarray, full_mask: np.ndarray) -> int:
        """Release requests at ``idx`` whose every member executed and whose
        response duty is met.  full_mask: int64 member bitmask per entry."""
        done = (
            self.valid[idx]
            & self.responded[idx]
            & ((self.exec_mask[idx] & full_mask) == full_mask)
        )
        di = idx[done]
        if len(di):
            # a rid can appear twice in idx (duplicate commit in one batch);
            # free once per unique slot
            di = np.unique(di)
            di = di[self.valid[di]]
            self.valid[di] = False
            self.payload[di] = None
            self.response[di] = None
            self.n_live -= len(di)
            self.done += len(di)
        return int(done.sum())

    def fail(self, idx: np.ndarray) -> int:
        """Drop requests (group removed/stopped under them); returns how
        many live requests were dropped."""
        li = np.unique(idx)
        li = li[self.valid[li]]
        self.valid[li] = False
        self.payload[li] = None
        self.response[li] = None
        self.n_live -= len(li)
        return len(li)

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Dense snapshot of live entries only (for WAL checkpoints)."""
        live = np.nonzero(self.valid)[0]
        return {
            "rid": self.rid[live],
            "row": self.row[live],
            "entry": self.entry[live],
            "stop": self.stop[live],
            "exec_mask": self.exec_mask[live],
            "responded": self.responded[live],
            "slot": self.slot[live],
            "payload": list(self.payload[live]),
            "response": list(self.response[live]),
            "lo": self.lo,
            "hi": self.hi,
            "done": self.done,
        }

    def restore(self, snap: dict) -> None:
        self.__init__(self.cap)
        rids = np.asarray(snap["rid"], np.int64)
        idx = self.idx_of(rids)
        self.rid[idx] = rids
        self.row[idx] = snap["row"]
        self.entry[idx] = snap["entry"]
        self.stop[idx] = snap["stop"]
        self.exec_mask[idx] = snap["exec_mask"]
        self.responded[idx] = snap["responded"]
        self.slot[idx] = snap["slot"]

        def as_obj(items):  # keep bytes as bytes (numpy would S-array them)
            a = np.empty(len(rids), object)
            a[:] = list(items)
            return a

        self.payload[idx] = as_obj(snap["payload"])
        self.pay_len[idx] = np.fromiter(
            (0 if p is None else len(p) for p in snap["payload"]), np.int32,
            count=len(rids),
        )
        self.response[idx] = as_obj(snap.get("response", [None] * len(rids)))
        self.valid[idx] = True
        self.lo = int(snap["lo"])
        self.hi = int(snap["hi"])
        self.done = int(snap["done"])
        self.n_live = len(rids)
