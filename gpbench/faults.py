"""Planted faults for the checks' own tests and for the controls: each
breaks the served path underneath a run, so that the run's comparison
with the reference has something to catch.  The benchmark's runs never
install one (``run.py --fault`` is for the tests and the control runs).

* ``state_unchanged``: the app's step leaves its state as it was.
* ``half_batch``: the app's step applies only half of what it was given.
* ``answer_altered``: what the app produces is altered where it is made
  (a counter's increment, a KV response).
* ``replica_skips`` (the counter's control): replica R-1 skips one
  execution in 64, breaking "every replica executes every decided
  request".
* ``wal_dropped``: every 8th tick record that places requests is never
  journaled, breaking log-before-respond.
* ``wal_ack_early`` (the durable control): the journal syncs every 4th
  tick and the manager releases responses without waiting for it, so most
  are acknowledged before the fsync that covers them, which comes later.
"""

from __future__ import annotations

import numpy as np

NAMES = ("state_unchanged", "half_batch", "answer_altered", "replica_skips",
         "wal_dropped", "wal_ack_early")


def install(name: str, run) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    m = run.m
    if name.startswith("wal_"):
        if m.wal is None:
            raise ValueError(f"{name} needs a durable configuration")
        if name == "wal_dropped":
            _drop_wal_records(m.wal)
        else:
            m.wal.sync_every = 4
            m.wal.is_synced = lambda: True
    elif run.app.kind == "counter":
        _counter(name, run)
    else:
        _device_kv(name, run)


def _drop_wal_records(wal) -> None:
    orig = wal.log_inbox
    n = [0]

    def log_inbox(tick_num, alive):
        if wal.manager._bulk_placed is not None:
            n[0] += 1
            if n[0] % 8 == 0:
                # the tick's descriptor upload goes unjournaled with it
                wal.manager._kv_uploaded = None
                return
        orig(tick_num, alive)

    wal.log_inbox = log_inbox


def _counter(name: str, run) -> None:
    apps = run.app.apps
    targets = apps[-1:] if name == "replica_skips" else apps
    for app in targets:
        orig = app.execute_rows_batch

        def erb(rows, payloads, request_ids, lens=None, _o=orig):
            rows = np.asarray(rows)
            if name == "state_unchanged":
                return None
            if name == "half_batch":
                k = len(rows) // 2
                return _o(rows[:k], payloads[:k], request_ids[:k],
                          None if lens is None else lens[:k])
            if name == "replica_skips":
                keep = np.asarray(request_ids) % 64 != 0
                return _o(rows[keep], payloads[keep],
                          np.asarray(request_ids)[keep],
                          None if lens is None else lens[keep])
            # answer_altered: the first increment of the batch is off by one
            if len(payloads):
                payloads = payloads.copy()
                d = int.from_bytes(payloads[0], "little", signed=True) + 1
                payloads[0] = d.to_bytes(8, "little", signed=True)
            return _o(rows, payloads, request_ids, None)

        app.execute_rows_batch = erb


def _device_kv(name: str, run) -> None:
    import gigapaxos_tpu_torch.paxos.manager as mgr
    from gigapaxos_tpu_torch.ops.tick import CompactLayout

    if name == "replica_skips":
        raise ValueError("replica_skips is the counter app's control")
    orig = mgr.fused_compact
    m = run.m

    def fused(state, kv, inbox, *rest):
        new_state, kv2, flat = orig(state, kv, inbox, *rest)
        if name == "state_unchanged":
            kv2 = kv2._replace(key=kv.key, val=kv.val)
        elif name == "half_batch":
            h = kv.key.shape[1] // 2
            key, val = kv2.key.clone(), kv2.val.clone()
            key[:, :h] = kv.key[:, :h]
            val[:, :h] = kv.val[:, :h]
            kv2 = kv2._replace(key=key, val=val)
        else:  # answer_altered: every response's low bit flipped
            L = CompactLayout(m.R, m.G, m._exec_budget, m._lag_budget)
            flat = flat.clone()
            flat[L.o_resp:L.o_resp + L.E] ^= 1
        return new_state, kv2, flat

    mgr.fused_compact = fused
