"""The host counter app of a deployment: ``DenseCounterApp`` at every
replica, each request an 8-byte little-endian increment of its group's
accumulator, acknowledged through ``propose_bulk``'s columnar sink."""

from __future__ import annotations

import numpy as np

from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp

#: distinct request bodies: increment ``d`` is ``BODIES[d]`` (a shared
#: bytes object each, so the generator builds no bytes per request)
MAX_DELTA = 1 << 12
BODIES = [int(d).to_bytes(8, "little", signed=True)
          for d in range(MAX_DELTA + 1)]


class Adapter:
    kind = "counter"

    def __init__(self, ledger):
        self.ledger = ledger
        self.apps = None
        #: where the journal stands (``Run.journal_pos``); -1 without one
        self.journal_pos = lambda: -1

    def replicas(self, R: int, G: int):
        self.apps = [DenseCounterApp(G) for _ in range(R)]
        return self.apps

    def attach(self, m) -> None:
        for a in self.apps:
            a.row_of = m.rows.row

    def propose(self, m, rows, reqs, span) -> np.ndarray:
        """Propose one block; returns the manager's rid array."""
        d = reqs.delta
        if d.min() < 0 or d.max() > MAX_DELTA:
            raise ValueError(f"counter increments lie in [0, {MAX_DELTA}]")
        bodies = [BODIES[x] for x in d.tolist()]
        led = self.ledger
        holder = [0]

        def sink(offsets, responses):
            with span("sink"):
                led.ack_block(holder[0], offsets, responses,
                              self.journal_pos())

        rids = m.propose_bulk(rows, bodies, batch_sink=sink)
        adm = rids >= 0
        if adm.any():
            holder[0] = int(rids[adm][0])
        return rids

    def after_tick(self, out, span) -> None:
        pass

    def program_state(self, m) -> dict:
        """The app state at every replica, indexed by group (row order is
        the group's row in the manager)."""
        return {"acc": np.stack([a.acc for a in self.apps]),
                "count": np.stack([a.count for a in self.apps])}
