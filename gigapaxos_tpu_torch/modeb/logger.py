"""Per-node WAL + recovery for Mode B.

Each Mode-B node owns an independent journal+snapshot WAL — the reference's
one-log-per-machine shape (``SQLPaxosLogger`` instantiated per node,
gigapaxos/SQLPaxosLogger.java:123) rather than Mode A's single shared log.

The node step is deterministic given (state, applied frames, placed intake,
alive mask), so the journal records exactly those inputs in arrival order:

* OP_CREATE / OP_REMOVE — admin ops;
* OP_FRAME — every replica frame applied to the peer mirrors (raw bytes,
  already a compact SoA encoding);
* OP_TICK — the placed intake of one step, with payloads, plus the alive
  mask.

Recovery = snapshot + in-order replay of these records through the same
node tick on the node's device (the 3-pass recovery analog,
PaxosManager.java:1852-2055), after which the node re-wires its transport
and asks peers for anti-entropy full frames (``request_sync``) to refresh
its mirrors.

Journals, snapshots and their metadata are byte-equal to the JAX package's
Mode B logger, so either package recovers a directory the other wrote.
"""

from __future__ import annotations

import collections
import glob
import io
import logging
import os

import numpy as np
import torch

from ..obs.metrics import registry as _obs_registry
from ..wal import records
from ..wal.logger import (OP_CREATE, OP_PAUSE, OP_REMOVE, OP_TICK,
                          OP_UNPAUSE, PaxosLogger, WalQuarantinedError,
                          _load_op, quarantine_journal)
from .kernel import unpack_node_tick

OP_FRAME = 6
OP_CKPT = 7
OP_EXPAND = 8
OP_PAYLOAD = 9  # out-of-band payload arrival (undigest reply)
OP_TAINT = 10   # row marked not-authoritative (tainted epoch birth)

#: op byte -> (min_arity, max_arity): fail-closed whitelist applied to
#: every record decoded from disk (wal/records.py validate_op_record)
MODEB_OP_SCHEMA = {
    OP_CREATE: (4, 4),
    OP_REMOVE: (2, 2),
    OP_TICK: (4, 4),
    OP_PAUSE: (2, 2),
    OP_UNPAUSE: (2, 2),
    OP_FRAME: (2, 2),
    OP_CKPT: (3, 3),
    OP_EXPAND: (2, 2),
    OP_PAYLOAD: (4, 4),
    OP_TAINT: (2, 2),
}

#: ops that are safe to apply out of tick order after corruption cut the
#: deterministic replay short: externally-sourced data (frames, payloads,
#: adopted checkpoints) plus taint marks.  OP_TICK and admin ops are NOT
#: salvageable — their effects depend on every prior record.
_SALVAGE_OPS = frozenset({OP_FRAME, OP_PAYLOAD, OP_TAINT, OP_CKPT})

_log = logging.getLogger("gptpu.wal")


def replay_node_journals(node, log_dir, start_seq, stage, new_buffers,
                         place, run_tick) -> bool:
    """Shared Mode B journal-replay loop (paxos + chain node flavors).

    The protocol-specific parts are injected: ``stage`` decodes+stages one
    journaled frame's raw bytes, ``new_buffers``/``place`` shape the tick's
    intake, ``run_tick`` runs the node step and returns (out, changed).
    Everything else — create/remove/ckpt replay, the snapshot-boundary
    skip, rid-counter repair from placed intake, snapshot-queue dedup
    against journaled placements, mirror flushing — is identical across
    flavors and lives here once.

    Storage faults: a journal whose scan classifies as *scribble* (mid-log
    corruption with intact records after it — fsynced, possibly acked data
    was damaged) is quarantined aside and replay degrades: the intact
    prefix replays normally, then only externally-sourced records
    (_SALVAGE_OPS) are applied from the intact suffix and any later
    journals, because the deterministic tick stream is broken at the
    corruption point.  Returns True in that case — the caller must taint
    every own row so the existing laggard-repair machinery re-fetches
    authoritative state from peers (and must fail-stop instead when no
    peer exists).  Undecodable records are tolerated ONLY in the unsynced
    tail of the newest journal (past the last fsync barrier: never acked);
    anywhere else they are corruption, not a crash artifact."""
    from ..wal.journal import iter_scan_records, scan_journal
    from .common import RID_MASK, rid_origin

    corrupt_c = _obs_registry().counter(
        "wal_corrupt_records_total",
        help="corrupt journal records/regions found at recovery")
    tolerated_c = _obs_registry().counter(
        "wal_replay_tolerated_frames_total",
        help="undecodable records tolerated in the unsynced tail")
    degraded = False

    def dispatch(rec, idx, scan, newest):
        nonlocal degraded
        op = rec[0]
        if degraded and op not in _SALVAGE_OPS:
            return
        if op == OP_CREATE:
            _, name, members, epoch = rec
            if name not in node.rows:
                node.create_group(name, members, epoch)
        elif op == OP_EXPAND:
            node.expand_universe(rec[1], _log=False)
        elif op == OP_REMOVE:
            node.remove_group(rec[1])
        elif op == OP_PAUSE:
            node._do_pause([n for n in rec[1] if n in node.rows])
        elif op == OP_UNPAUSE:
            node._unpause(rec[1])
        elif op == OP_FRAME:
            try:
                stage(rec[1])
            except (ValueError, IndexError) as e:
                corrupt_c.inc()
                if newest and idx >= scan.n_synced:
                    # unsynced tail of the journal being appended at crash
                    # time: the frame was never covered by an fsync, so
                    # nothing acked depends on it
                    tolerated_c.inc()
                elif not degraded:
                    # mid-log: an fsynced frame decoded to garbage.  The
                    # live run staged it, so own state evolved from it —
                    # every tick after this point would diverge silently.
                    _log.error("journal frame %d is fsynced but "
                               "undecodable (%s): degrading to peer repair",
                               idx, e)
                    degraded = True
        elif op == OP_PAYLOAD:
            _, rid, pl, stop = rec
            if rid not in node.outstanding and rid not in node.payloads:
                node._store_payload(rid, pl, stop)
        elif op == OP_TAINT:
            # a tainted birth must survive the crash: an untainted
            # recovered row with empty state would serve bad reads AND
            # donate the empty state to tainted peers (state loss)
            row = node.rows.row(rec[1])
            if row is not None:
                node._tainted_rows.add(row)
        elif op == OP_CKPT:
            _, gid, packet = rec
            row = node._gid_row.get(gid)
            if row is not None:
                node._apply_ckpt(row, packet)
        elif op == OP_TICK:
            _, tick_num, placed, alive_b = rec
            if tick_num < node.tick_num:
                return  # already inside the snapshot
            bufs = new_buffers()
            node._placed = []
            for row, entries in placed:
                take = []
                placed_rids = set()
                for rid, p, payload, stop in entries:
                    if rid_origin(rid) == node.r:
                        node._next_seq = max(
                            node._next_seq, (rid & RID_MASK) + 1
                        )
                    placed_rids.add(rid)
                    # payload None = digest-only placement (the rid was
                    # placed before its payload arrived); replay places
                    # it identically and execution follows the same
                    # learned-payload / taint path as the live run
                    if payload is not None and (
                        rid not in node.outstanding
                        and rid not in node.payloads
                    ):
                        node._store_payload(rid, payload, stop)
                    place(bufs, p, row, rid, stop)
                    take.append((rid, p))
                node._placed.append((row, take))
                # snapshot queues may hold copies of rids whose placement
                # is journaled after it — drop or they commit twice
                if row in node._queues and placed_rids:
                    node._queues[row] = collections.deque(
                        r for r in node._queues[row]
                        if r not in placed_rids
                    )
            node._flush_mirrors()  # frames staged since the last tick
            out, changed = run_tick(
                bufs, np.frombuffer(alive_b, dtype=bool)
            )
            node._process_outbox(out)
            drain = getattr(node, "_drain_stalled", None)
            if drain is not None:  # digest-mode stalls release as the
                drain()            # journaled payload arrivals replay
            node._dirty |= changed
            node.tick_num = tick_num + 1

    paths = sorted(glob.glob(os.path.join(log_dir, "journal.*.log")))
    for path in paths:
        seq = int(os.path.basename(path).split(".")[1])
        if seq < start_seq:
            continue
        newest = path == paths[-1]
        # bounded-memory scan first (classification without materializing
        # payload copies); only the rare corrupt path re-scans collecting,
        # because salvage needs the intact suffix in memory
        scan = scan_journal(path, meta_only=True)
        if scan.kind != "clean":
            scan = scan_journal(path)
        # a tear is only innocent in the newest journal (the one being
        # appended at crash time); rolled journals were sealed by their
        # closing fsync, so missing bytes there are lost fsynced data
        bad = scan.kind == "scribble" or (
            scan.kind == "torn_tail" and not newest
            and scan.good_len < scan.file_size)
        for idx, raw in enumerate(iter_scan_records(path, scan)):
            try:
                rec = _load_op(raw, MODEB_OP_SCHEMA)
            except (ValueError, IndexError) as e:
                corrupt_c.inc()
                if newest and idx >= scan.n_synced and not degraded:
                    tolerated_c.inc()
                    _log.warning("journal %s: dropping undecodable record "
                                 "%d in the unsynced tail (%s)", path, idx,
                                 e)
                    break
                _log.error("journal %s: record %d is fsynced but "
                           "undecodable (%s): degrading to peer repair",
                           path, idx, e)
                degraded = True
                continue
            dispatch(rec, idx, scan, newest)
        if bad:
            corrupt_c.inc()
            quarantine_journal(path, scan)
            degraded = True
            # the intact suffix past the corrupt gap still holds
            # externally-sourced records worth keeping (frames, payloads,
            # adopted checkpoints); the tick stream is unrecoverable
            for raw in scan.suffix:
                try:
                    rec = _load_op(raw, MODEB_OP_SCHEMA)
                except (ValueError, IndexError):
                    corrupt_c.inc()
                    continue
                dispatch(rec, scan.n_records, scan, False)
    return degraded


class ModeBLogger(PaxosLogger):
    def log_expand(self, new_ids) -> None:
        """Journal a replica-universe expansion (node addition): replay
        must re-grow the state arrays before any later record that assumes
        the larger R."""
        self._append(records.dumps((OP_EXPAND, list(new_ids))))
        self._sync()

    def log_frame(self, payload: bytes) -> None:
        """Journal an applied replica frame (before mirror mutation; rides
        the next tick's group commit for fsync)."""
        self._append(records.dumps((OP_FRAME, payload)))

    def log_taint(self, name: str) -> None:
        """Journal a taint mark (out-of-tick mutation, like log_ckpt)."""
        self._append(records.dumps((OP_TAINT, name)))
        self._sync()

    def log_payload(self, rid: int, payload: bytes, stop: bool) -> None:
        """Journal an out-of-band payload fill (undigest reply): it changes
        what replay can execute, exactly like a frame's payload items."""
        self._append(records.dumps((OP_PAYLOAD, rid, payload, stop)))

    def log_ckpt(self, gid: int, packet: dict) -> None:
        """Journal an adopted checkpoint transfer — it mutates own-row state
        outside the deterministic tick, so replay must re-apply it."""
        self._append(records.dumps((OP_CKPT, gid, dict(packet))))
        self._sync()

    def log_inbox(self, tick_num: int, alive: np.ndarray) -> None:
        """Journal one node tick's placed intake.  ``alive`` is the host
        liveness vector the tick's inbox was built from (the port's
        ``PaxosLogger.log_inbox`` convention: the device copy is never read
        back), written as one byte a replica."""
        m = self.manager
        digest_meta = getattr(m, "_digest_meta", {})
        placed = []
        for row, take in m._placed:
            entries = []
            for rid, p in take:
                rec = m.outstanding.get(rid)
                if rec is not None:
                    entries.append((rid, p, rec.payload, rec.stop))
                elif rid in m.payloads:
                    pl, stop = m.payloads[rid]
                    entries.append((rid, p, pl, stop))
                elif rid in digest_meta:
                    # digest placement before its payload arrived: journal
                    # the placement itself (payload None) so replay's tick
                    # evolves state identically
                    entries.append((rid, p, None, digest_meta[rid]))
            if entries:
                placed.append((row, entries))
        rec_bytes = records.dumps((OP_TICK, tick_num, placed,
                                   np.asarray(alive, bool).tobytes()))
        self._append(rec_bytes)
        self._append_bytes.inc(len(rec_bytes))
        self._ticks_since_sync += 1
        if self._ticks_since_sync >= self.sync_every:
            self._sync()
            self._ticks_since_sync = 0

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
            "seen": {k: list(v.items()) for k, v in m._seen.items()},
            "payloads": list(m.payloads.items()),
            "outstanding": [
                (r.rid, r.name, r.row, r.payload, r.stop, r.responded,
                 r.born_tick)
                for r in m.outstanding.values()
            ],
            "queues": {row: list(q) for row, q in m._queues.items() if q},
            # digest-mode soft state: stop flags of payload-less queued
            # rids, and stalled execution buffers (their slots are already
            # inside the device exec watermark, so losing them would
            # silently skip executions)
            "digest_meta": list(getattr(m, "_digest_meta", {}).items()),
            "stalled": {row: list(q)
                        for row, q in getattr(m, "_stalled", {}).items()},
            "stall_tick": dict(getattr(m, "_stall_tick", {})),
            "coord_view": m._coord_view.tobytes(),
            "frame_applied": dict(m._frame_applied_tick),
            # paused names keep app state; the snapshot must carry both
            # the spilled records and their app projections (the journal
            # holding their OP_CREATE gets GC'd)
            "paused": self._paused_snapshot(m),
            # device-app nodes snapshot the device tensors verbatim
            # (dkv_* in the npz, written by the base checkpoint()); a
            # per-name projection would be redundant and lossy (key 0
            # sentinel)
            "app": ({
                name: m.app.checkpoint(name)
                for name in list(m.rows.names()) + list(m._paused)
            } if not getattr(m, "_device_app", False) else None),
            "kv_pending": (list(getattr(m, "_kv_pending", ()))
                           if getattr(m, "_device_app", False) else None),
        }


def _restore_node(node, meta, arrs) -> None:
    """Load a decoded snapshot into a fresh node (state tensors on the
    node's device, host bookkeeping verbatim)."""
    from ..paxos.state import PaxosState, state_from_numpy
    from . import wire
    from .manager import ModeBRecord

    node.state = state_from_numpy([arrs[f] for f in PaxosState._fields],
                                  device=node.device)
    if getattr(node, "_device_app", False):
        if any(k.startswith("dkv_") for k in arrs.files):
            from ..models.device_kv import DeviceKVState

            node.kv = DeviceKVState(*(
                torch.as_tensor(np.array(arrs["dkv_" + f]),
                                device=node.device)
                for f in DeviceKVState._fields))
        for item in meta.get("kv_pending") or ():
            node._kv_pending.append(tuple(item))
    node.tick_num = meta["tick_num"]
    node._next_seq = meta["next_seq"]
    node.rows.restore(meta["rows"], meta["free_rows"])
    for _row in meta["rows"].values():
        node._occupied[_row] = True  # frame-target mask (anti-entropy)
    node._gid_row = {wire.gid_of(n): row for n, row in meta["rows"].items()}
    node._row_meta = dict(meta["row_meta"])
    node._stopped_rows = set(meta["stopped_rows"])
    node._tainted_rows = set(meta.get("tainted_rows", ()))
    for k, items in meta["seen"].items():
        node._seen[k] = collections.OrderedDict(items)
    for rid, pl in meta["payloads"]:
        node.payloads[rid] = pl
    for rid, name, row, payload, stop, responded, born in meta[
        "outstanding"
    ]:
        rec = ModeBRecord(rid, name, row, payload, stop, None, born)
        rec.responded = responded
        node.outstanding[rid] = rec
    for row, rids in meta["queues"].items():
        node._queues[int(row)] = collections.deque(rids)
    for rid, stop in meta.get("digest_meta", ()):
        node._digest_meta[rid] = stop
    for row, items in (meta.get("stalled") or {}).items():
        node._stalled[int(row)] = collections.deque(
            tuple(e) for e in items
        )
    node._stall_tick = {int(r): t for r, t in
                        (meta.get("stall_tick") or {}).items()}
    node._coord_view = np.frombuffer(
        meta["coord_view"], dtype=np.int32
    ).copy()
    node._frame_applied_tick = dict(meta["frame_applied"])
    node._paused.update(meta.get("paused", {}))
    node._paused_gids = {wire.gid_of(n): n for n in node._paused}
    for name, blob in (meta["app"] or {}).items():
        node.app.restore(name, blob)


def recover_modeb(cfg, member_ids, node_id, app, log_dir: str,
                  native: bool = True, spill_ns=None,
                  allow_degraded: bool = True, peer_stream=None,
                  device=None):
    """Rebuild a ModeBNode from its own disk; attach a messenger and call
    ``request_sync()`` afterwards to rejoin the replica set.

    ``device`` holds the rebuilt state and runs the replayed ticks (``None``
    = CUDA, like every entry point of the port; a replay on a card never
    carries on on the CPU).

    If replay finds a scribbled journal (see ``replay_node_journals``),
    the journal is quarantined and — when peers exist and
    ``allow_degraded`` — every own row is tainted so the laggard-repair
    machinery re-fetches authoritative state via checkpoint transfer;
    otherwise recovery fail-stops with :class:`WalQuarantinedError`
    rather than silently serve a truncated log.

    ``peer_stream`` (a :class:`~gigapaxos_tpu_torch.modeb.manager.
    PeerCheckpointStreamer`) overlaps peer checkpoint fetches with the
    local journal replay: the fetch plan — every own row known at recovery
    start — is launched before replay, and the blobs are adopted afterwards
    through the watermark-checked transfer path, so a behind node reaches
    full service in max(replay, stream) instead of replay + serial
    repair."""
    from ..ops.tick import TickInbox
    from ..paxos.state import to_host
    from ..wal.logger import load_latest_snapshot
    from . import wire
    from .manager import ModeBNode

    logger = ModeBLogger(log_dir, native=native)
    snap = load_latest_snapshot(log_dir)
    snap_seq = meta = npz_blob = None
    if snap is not None:
        snap_seq, (meta, npz_blob) = snap
    # the universe may have been expanded at runtime (node additions): the
    # snapshot's member list supersedes the boot topology's, and journaled
    # OP_EXPAND records extend it further during replay
    members = list(meta.get("members", member_ids)) if meta else member_ids
    node = ModeBNode(cfg, members, node_id, app, spill_ns=spill_ns,
                     device=device)  # no messenger, no wal
    # stale pre-crash spill files must never pre-populate the pause store
    # (snapshot + journal are the authority for row allocation)
    node._paused.clear()
    start_seq = 0
    if snap_seq is not None:
        _restore_node(node, meta, np.load(io.BytesIO(npz_blob)))
        start_seq = snap_seq

    if peer_stream is not None:
        # launch the fetch plan NOW — every own row known at recovery
        # start — so peer transfers stream while the journal replays;
        # rows created later in the journal were born on this node and
        # need no repair
        peer_stream.start(wire.gid_of(name) for name in node.rows.names())

    dev = node.device

    def new_buffers():
        return (np.zeros((node.R, node.P, node.G), np.int32),
                np.zeros((node.R, node.P, node.G), bool))

    def place(bufs, p, row, rid, stop):
        bufs[0][node.r, p, row] = rid
        bufs[1][node.r, p, row] = stop

    def run_tick(bufs, alive):
        # the buffers are fresh per tick, so a CPU tensor may view them
        inbox = TickInbox(torch.from_numpy(bufs[0]).to(dev),
                          torch.from_numpy(bufs[1]).to(dev),
                          torch.as_tensor(np.array(alive, bool), device=dev))
        if getattr(node, "_device_app", False):
            hold = np.zeros(node.G, bool)
            if node._stalled:
                hold[list(node._stalled)] = True
            node.state, node.kv, packed = node._tick_device(
                node.state, node.kv, inbox, *node._take_kv_reg(), hold,
            )
            out, changed, extras = node._unpack_tick(packed)
            node._replay_extras = extras
            return out, changed
        node.state, packed = node._tick_packed(node.state, inbox)
        return unpack_node_tick(packed, node.R, node.P, node.W, node.G)

    if getattr(node, "_device_app", False):
        # route the replay's outbox processing through the device extras
        # exactly like the live tick (fast path per non-skipped row)
        _orig_process = node._process_outbox

        def _proc(out, placed=None, extras=None):
            _orig_process(out, placed,
                          node.__dict__.pop("_replay_extras", None))

        node._process_outbox = _proc

    degraded = replay_node_journals(
        node, log_dir, start_seq,
        stage=lambda raw: node._apply_frame(wire.decode_frame(raw)),
        new_buffers=new_buffers, place=place, run_tick=run_tick,
    )
    if "_process_outbox" in node.__dict__:
        del node._process_outbox
    if degraded:
        if not allow_degraded or len(node.members) < 2:
            raise WalQuarantinedError(
                f"WAL {log_dir}: scribbled journal quarantined and no peer "
                "can repair this node (allow_degraded="
                f"{allow_degraded}, members={list(node.members)}) — "
                "fail-stop rather than serve a truncated log")
        # the deterministic tick stream broke at the corruption point, so
        # every own row may be behind its acked state: taint them ALL and
        # let the existing laggard-repair machinery (peer checkpoint
        # transfer + anti-entropy request_sync) restore authority.  Until
        # repaired, tainted rows neither serve nor donate.
        for _name, row in node.rows.items():
            node._tainted_rows.add(row)
        node.recovered_degraded = True
        _log.error("node %s recovered DEGRADED from %s: %d own rows "
                   "tainted, awaiting peer checkpoint repair", node_id,
                   log_dir, len(node._tainted_rows))

    node._flush_mirrors()  # frames journaled after the last tick record
    node._held_callbacks = []  # no live clients to answer during replay
    # close the rid-regression hole: every rid that could ever commit is
    # visible in some ring or payload/outstanding table — never hand out a
    # sequence number at or below any of them (host copies: a CPU tensor's
    # numpy view would alias the live ring)
    for f in ("acc_req", "dec_req", "prop_req"):
        node.bump_seq(to_host(getattr(node.state, f)))
    node.bump_seq(np.fromiter(node.payloads.keys(), np.int64,
                              len(node.payloads)))
    node.bump_seq(np.fromiter(node.outstanding.keys(), np.int64,
                              len(node.outstanding)))
    # rows still stalled on a payload when replay ends get a fresh timeout
    # window: live undigest fetches resume once the messenger is attached
    for row in node._stalled:
        node._stall_tick[row] = node.tick_num
    logger.attach(node)
    node.wal = logger
    if degraded:
        # persist the blanket taint: a second crash before the peer repair
        # completes must come back still-tainted, not trusting stale state
        for name in list(node.rows.names()):
            logger.log_taint(name)
    if peer_stream is not None:
        # adopt the streamed blobs through the watermark-checked transfer
        # path: anything replay caught up past is dropped as stale, and a
        # degraded node's blanket taint clears row by row as authoritative
        # peer state lands
        peer_stream.apply(node)
    node._force_full = True  # re-announce our row to peers on rejoin
    return node
