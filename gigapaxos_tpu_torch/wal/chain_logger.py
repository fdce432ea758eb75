"""WAL + recovery for the chain data plane.

The journal format is the Paxos WAL's (OP_CREATE / OP_REMOVE / OP_TICK
records, snapshot + deterministic replay — ``logger.py``); only the
manager's snapshot metadata and the tick-replay inbox shape differ.
Journals and snapshots are byte-equal to the JAX package's chain logger, so
either package recovers the other's directory.
"""

from __future__ import annotations

import collections
import io

import numpy as np

from .logger import PaxosLogger, load_latest_snapshot, replay_journals


class ChainLogger(PaxosLogger):
    def _meta(self, m) -> dict:
        return {
            "tick_num": m.tick_num,
            "next_rid": m._next_rid,
            "rows": dict(m.rows.items()),
            # verbatim LIFO free-list — see PaxosLogger._meta for why order
            # must survive recovery
            "free_rows": list(m.rows._free),
            "stopped_rows": set(m._stopped_rows),
            "outstanding": [
                (r.rid, r.name, r.row, r.payload, r.stop,
                 sorted(r.executed_by), r.responded)
                for r in m.outstanding.values()
            ],
            "queues": {row: list(q) for row, q in m._queues.items() if q},
            "apps": [
                {name: m.apps[i].checkpoint(name) for name in m.rows.names()}
                for i in range(m.R)
            ],
        }


def recover_chain(cfg, n_replicas: int, apps, log_dir: str,
                  native: bool = True, device=None):
    """Rebuild a ChainManager from disk: snapshot + deterministic replay of
    the journaled ticks on ``device`` (default CUDA)."""
    import torch

    from ..chain.manager import ChainManager, ChainRequest
    from ..chain.state import ChainState, state_from_numpy
    from ..chain.tick import (ChainInbox, chain_tick_packed,
                              unpack_chain_outbox)

    logger = ChainLogger(log_dir, native=native)
    m = ChainManager(cfg, n_replicas, apps, device=device)
    snap = load_latest_snapshot(log_dir)
    start_seq = 0
    if snap is not None:
        snap_seq, (meta, npz_blob) = snap
        arrs = np.load(io.BytesIO(npz_blob))
        m.state = state_from_numpy([arrs[f] for f in ChainState._fields],
                                   device=m.device)
        m._member_np = np.array(arrs["member"])
        m._n_members_np = np.array(arrs["n_members"])
        m.tick_num = meta["tick_num"]
        m._next_rid = meta["next_rid"]
        m.rows.restore(meta["rows"], meta.get("free_rows"))
        m._stopped_rows = set(meta["stopped_rows"])
        for rid, name, row, payload, stop, eby, responded in \
                meta["outstanding"]:
            # executed_by was an int count in old snapshots: no index
            # information, so restore it as empty (the record is only
            # retained longer, until the sweep covers it)
            eby_set = set(eby) if isinstance(eby, (list, tuple, set)) \
                else set()
            m.outstanding[rid] = ChainRequest(
                rid, name, row, payload, stop, None, responded, eby_set)
        for row, rids in meta["queues"].items():
            m._queues[int(row)] = collections.deque(rids)
        for i in range(m.R):
            for name, blob in meta["apps"][i].items():
                m.apps[i].restore(name, blob)
        start_seq = snap_seq

    def make_record(m, rid, row, payload, stop, entry):
        return ChainRequest(rid, m.rows.name(row) or "?", row, payload, stop,
                            None)

    def new_buffers(m):
        return (np.zeros((m.P, m.G), np.int32), np.zeros((m.P, m.G), bool))

    def place(bufs, entry, p, row, rid, stop):
        bufs[0][p, row] = rid
        bufs[1][p, row] = stop

    def build_inbox(bufs, alive):
        dev = m.device
        return ChainInbox(torch.from_numpy(bufs[0]).to(dev),
                          torch.from_numpy(bufs[1]).to(dev),
                          torch.as_tensor(np.array(alive, bool), device=dev))

    def tick_host(state, inbox):
        state, packed = chain_tick_packed(state, inbox)
        return state, unpack_chain_outbox(packed, m.R, m.P, m.W, m.G)

    replay_journals(m, log_dir, start_seq, make_record, new_buffers, place,
                    build_inbox, tick_host)
    logger.attach(m)
    m.wal = logger
    return m
