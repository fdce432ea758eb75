"""The device KV app of a deployment: the manager's ``DeviceKVApp`` views
(``cfg.paxos.device_app``), each request an (op, key, value) descriptor
through ``propose_bulk_kv``.

``propose_bulk_kv`` takes per-request callbacks only, so every request
gets the one bound callback below, which appends its rid, response and
clock reading to lists that the harness folds into the ledger after each
tick; the first callback after a fold also notes where the journal stands
(all of one release come together, with no journal write between them).
The decided order, which the reference replays, is each tick's
executed stream as ``PaxosManager.tick`` returns it (rid, replica, row
and slot of every execution)."""

from __future__ import annotations

import struct
import time

import numpy as np

_RESP = struct.Struct("<i")


class Adapter:
    kind = "device_kv"

    def __init__(self, ledger):
        self.ledger = ledger
        self._rid: list = []
        self._resp: list = []
        self._t: list = []
        self.streams: list = []
        #: where the journal stands (``Run.journal_pos``); -1 without one
        self.journal_pos = lambda: -1
        self._jpos = -1

    def replicas(self, R: int, G: int):
        return [None] * R

    def attach(self, m) -> None:
        pass

    def _cb(self, rid, resp, _pc=time.perf_counter):
        if not self._t:
            self._jpos = self.journal_pos()
        self._t.append(_pc())
        self._rid.append(rid)
        self._resp.append(resp)

    def propose(self, m, rows, reqs, span) -> np.ndarray:
        return m.propose_bulk_kv(rows, reqs.op, reqs.key, reqs.val,
                                 callbacks=[self._cb] * len(rows))

    def after_tick(self, out, span) -> None:
        if out is not None and out.n_exec:
            n = out.n_exec
            self.streams.append(np.stack([
                out.e_rid[:n], out.e_rep[:n], out.e_row[:n],
                out.e_slot[:n]]).astype(np.int64))
        if not self._rid:
            return
        with span("sink"):
            rid = np.array(self._rid, np.int64)
            t = np.array(self._t)
            ok = np.array([r is not None for r in self._resp], bool)
            resp = np.array([_RESP.unpack(r)[0] for r in self._resp
                             if r is not None], np.int64)
            self._rid, self._resp, self._t = [], [], []
            if not ok.all():  # failure callbacks carry no response
                self.ledger.failed.append(rid[~ok])
            self.ledger.ack_rids(rid[ok], t[ok], resp, self._jpos)

    def exec_stream(self) -> np.ndarray:
        """[4, n] int64: rid, replica, row, slot of every execution."""
        if not self.streams:
            return np.zeros((4, 0), np.int64)
        return np.concatenate(self.streams, axis=1)

    def program_state(self, m) -> dict:
        return {"key": m.kv.key.cpu().numpy(), "val": m.kv.val.cpu().numpy(),
                "exec": self.exec_stream()}
