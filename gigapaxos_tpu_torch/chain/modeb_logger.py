"""Per-node WAL + recovery for chain Mode B.

Same shape as the paxos flavor (``modeb/logger.py``): the chain node step is
deterministic given (state, staged frames, placed intake, alive mask), so
the journal records exactly those inputs in arrival order and recovery is
snapshot + in-order replay through the same node tick on the node's
device, followed by ``request_sync()`` to refresh mirrors from live peers.

Journals, snapshots and their metadata are byte-equal to the JAX package's
chain Mode B logger, so either package recovers a directory the other
wrote.
"""

from __future__ import annotations

import collections
import io

import numpy as np
import torch

from ..modeb.logger import ModeBLogger, replay_node_journals


class ChainBLogger(ModeBLogger):
    """Only the snapshot metadata differs from the paxos flavor — frame/
    ckpt/intake journaling (including the fsync group-commit policy) is
    inherited so durability fixes live in ONE place.  ModeBLogger's
    ``log_inbox`` already reads the shared ``_placed``/``outstanding``/
    ``payloads`` shapes both node flavors expose."""

    def _meta(self, m) -> dict:
        return {
            "tick_num": m.tick_num,
            "members": list(m.members),
            "next_seq": m._next_seq,
            "rows": dict(m.rows.items()),
            "free_rows": list(m.rows._free),
            "row_meta": dict(m._row_meta),
            "stopped_rows": set(m._stopped_rows),
            "tainted_rows": set(m._tainted_rows),
            "payloads": list(m.payloads.items()),
            "outstanding": [
                (r.rid, r.name, r.row, r.payload, r.stop, r.responded,
                 r.born_tick)
                for r in m.outstanding.values()
            ],
            "queues": {row: list(q) for row, q in m._queues.items() if q},
            "frame_applied": dict(m._frame_applied_tick),
            "app": {name: m.app.checkpoint(name) for name in m.rows.names()},
        }


def _restore_chain_node(node, meta, arrs) -> None:
    """Load a decoded snapshot into a fresh chain node (state tensors on
    the node's device, host bookkeeping verbatim)."""
    from ..modeb import wire
    from .modeb import ChainBRecord
    from .state import ChainState, state_from_numpy

    node.state = state_from_numpy([arrs[f] for f in ChainState._fields],
                                  device=node.device)
    node.tick_num = meta["tick_num"]
    node._next_seq = meta["next_seq"]
    node.rows.restore(meta["rows"], meta["free_rows"])
    for _row in meta["rows"].values():
        node._occupied[_row] = True  # frame-target mask (anti-entropy)
    node._gid_row = {wire.gid_of(n): row for n, row in meta["rows"].items()}
    node._row_meta = dict(meta["row_meta"])
    node._stopped_rows = set(meta["stopped_rows"])
    node._tainted_rows = set(meta.get("tainted_rows", ()))
    for rid, pl in meta["payloads"]:
        node.payloads[rid] = pl
    for rid, name, row, payload, stop, responded, born in meta[
        "outstanding"
    ]:
        rec = ChainBRecord(rid, name, row, payload, stop, None, born)
        rec.responded = responded
        node.outstanding[rid] = rec
    for row, rids in meta["queues"].items():
        node._queues[int(row)] = collections.deque(rids)
    node._frame_applied_tick = dict(meta["frame_applied"])
    for name, blob in meta["app"].items():
        node.app.restore(name, blob)


def recover_chain_modeb(cfg, member_ids, node_id, app, log_dir: str,
                        native: bool = True, device=None):
    """Rebuild a ChainModeBNode from its own disk; attach a messenger and
    call ``request_sync()`` afterwards to rejoin the chain set.

    ``device`` holds the rebuilt state and runs the replayed ticks (``None``
    = CUDA, like every entry point of the port)."""
    from ..modeb import wire
    from ..paxos.state import to_host
    from ..wal.logger import load_latest_snapshot
    from .modeb import (CH_BITS, CH_MAGIC, CH_RINGS, CH_SCALARS,
                        ChainModeBNode, unpack_chain_node_tick)
    from .tick import ChainInbox

    logger = ChainBLogger(log_dir, native=native)
    snap = load_latest_snapshot(log_dir)
    snap_seq = meta = npz_blob = None
    if snap is not None:
        snap_seq, (meta, npz_blob) = snap
    # a runtime-expanded universe supersedes the boot topology (see
    # modeb/logger.recover_modeb); journaled OP_EXPANDs extend it further
    members = list(meta.get("members", member_ids)) if meta else member_ids
    node = ChainModeBNode(cfg, members, node_id, app, device=device)
    start_seq = 0
    if snap_seq is not None:
        _restore_chain_node(node, meta, np.load(io.BytesIO(npz_blob)))
        start_seq = snap_seq

    dev = node.device

    def stage(raw: bytes) -> None:
        node._stage_frame(wire.decode_frame(
            raw, scalar_fields=CH_SCALARS, ring_fields=CH_RINGS,
            bit_fields=CH_BITS, magic=CH_MAGIC,
        ))

    def new_buffers():
        return (np.zeros((node.P, node.G), np.int32),
                np.zeros((node.P, node.G), bool))

    def place(bufs, p, row, rid, stop):
        bufs[0][p, row] = rid
        bufs[1][p, row] = stop

    def run_tick(bufs, alive):
        # the buffers are fresh per tick, so a CPU tensor may view them
        inbox = ChainInbox(torch.from_numpy(bufs[0]).to(dev),
                           torch.from_numpy(bufs[1]).to(dev),
                           torch.as_tensor(np.array(alive, bool), device=dev))
        node.state, packed = node._tick_packed(node.state, inbox)
        return unpack_chain_node_tick(packed, node.R, node.P, node.W, node.G)

    replay_node_journals(node, log_dir, start_seq, stage=stage,
                         new_buffers=new_buffers, place=place,
                         run_tick=run_tick)

    node._flush_mirrors()
    node._held_callbacks = []  # no live clients to answer during replay
    node._await_commit = []  # their clients are gone too; peers re-ack
    # close the rid-regression hole: any rid that could ever commit is
    # visible in some ring or payload/outstanding table (a rid forwarded to
    # the head never enters the local journal as intake); a host copy, as
    # a CPU tensor's numpy view would alias the live ring
    node.bump_seq(to_host(node.state.c_req))
    node.bump_seq(np.fromiter(node.payloads.keys(), np.int64,
                              len(node.payloads)))
    node.bump_seq(np.fromiter(node.outstanding.keys(), np.int64,
                              len(node.outstanding)))
    logger.attach(node)
    node.wal = logger
    node._force_full = True
    return node
