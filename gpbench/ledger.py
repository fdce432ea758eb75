"""What the client side saw of every request: what was sent, when it was
due, when it was proposed and admitted, and each acknowledgement with its
response.  Indexed by the manager's request id (ids are sequential from 1,
and this harness is the manager's only proposer)."""

from __future__ import annotations

import time

import numpy as np

#: response of an acknowledgement that carried none (a failure callback)
NO_RESPONSE = -(1 << 40)


class Ledger:
    FIELDS = (("group", np.int64, -1), ("op", np.int32, 0),
              ("key", np.int32, 0), ("val", np.int32, 0),
              ("delta", np.int64, 0), ("t_due", np.float64, np.nan),
              ("t_prop", np.float64, np.nan), ("t_ack", np.float64, np.nan),
              ("n_ack", np.int32, 0), ("resp", np.int64, NO_RESPONSE),
              ("jpos", np.int64, -1))

    def __init__(self, cap: int = 1 << 20):
        self.cap = cap
        for name, dt, fill in self.FIELDS:
            setattr(self, name, np.full(cap, fill, dt))
        self.top = 0           # highest rid admitted + 1
        self.refused = 0       # proposals the manager did not admit
        self.n_admitted = 0
        self.n_acked = 0       # rids acknowledged at least once
        self.failed = []       # rids whose callback reported a failure
        self.refused_due = []  # due times of refused open-loop requests

    def _grow(self, need: int) -> None:
        cap = self.cap
        while cap < need:
            cap *= 2
        for name, dt, fill in self.FIELDS:
            a = np.full(cap, fill, dt)
            a[:self.cap] = getattr(self, name)
            setattr(self, name, a)
        self.cap = cap

    def admit(self, rids, reqs, t_due, t_prop) -> np.ndarray:
        """Record a proposal block; returns the admitted mask."""
        adm = rids >= 0
        r = rids[adm]
        if r.size:
            hi = int(r.max()) + 1
            if hi > self.cap:
                self._grow(hi)
            self.group[r] = reqs.group[adm]
            self.op[r] = reqs.op[adm]
            self.key[r] = reqs.key[adm]
            self.val[r] = reqs.val[adm]
            self.delta[r] = reqs.delta[adm]
            self.t_due[r] = t_due if np.isscalar(t_due) else t_due[adm]
            self.t_prop[r] = t_prop
            self.top = max(self.top, hi)
            self.n_admitted += int(r.size)
        n_ref = int((~adm).sum())
        if n_ref:
            self.refused += n_ref
            if not np.isscalar(t_due):
                self.refused_due.append(np.asarray(t_due)[~adm])
        return adm

    def ack_block(self, rid0: int, offsets, responses, jpos=-1) -> None:
        rids = rid0 + np.asarray(offsets, np.int64)
        if responses is None:  # the manager failed these requests
            self.failed.append(rids)
            return
        self.ack_rids(rids, time.perf_counter(), None, jpos)

    def ack_rids(self, rids, t, resp, jpos=-1) -> None:
        """``jpos``: where the journal stood when the acknowledgement came
        (``Run.journal_pos``), or -1 without a journal."""
        first = self.n_ack[rids] == 0
        np.add.at(self.n_ack, rids, 1)
        self.n_acked += int(first.sum())
        tt = t if np.isscalar(t) else t[first]
        self.t_ack[rids[first]] = tt
        self.jpos[rids[first]] = jpos
        if resp is not None:
            self.resp[rids[first]] = resp[first]

    # ------------------------------------------------------------ queries
    def admitted(self) -> np.ndarray:
        """Every admitted rid."""
        return np.nonzero(self.group[:self.top] >= 0)[0]

    def acked_between(self, t0: float, t1: float) -> int:
        t = self.t_ack[:self.top]
        return int(((t >= t0) & (t < t1)).sum())

    def in_flight(self) -> int:
        return self.n_admitted - self.n_acked
