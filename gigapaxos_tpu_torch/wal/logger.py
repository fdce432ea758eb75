"""PaxosLogger: durability + recovery for the dense data plane.

The reference logs every accept/decision before the correlated message leaves
the node (``AbstractPaxosLogger.logAndMessage``, AbstractPaxosLogger.java:157-178)
and recovers with a three-pass checkpoint+rollforward
(``PaxosManager.initiateRecovery``, PaxosManager.java:1852-2055).

The dense reformulation exploits that the fused tick is deterministic
given (state, inbox): instead of logging per-message, the journal records

  * admin ops (create/remove instance, pause/unpause, checkpoint transfer),
  * one record per tick: the placed requests (with payloads) + alive mask,

and recovery is: load the latest state snapshot, then *replay* the journaled
ticks through the very same tick, on the manager's device.  Durability
contract: the journal record for tick T is written (and group-commit fsynced
every ``sync_every_ticks``) before tick T's outputs are released to clients,
so any response ever sent is reproducible from disk.  Unplaced queued
requests may be lost on crash — clients retry those.

Checkpoints (``snapshot.<seq>.bin``: metadata + compressed state arrays)
bound replay length; journals older than the oldest kept snapshot are
garbage collected.

Journals, snapshots and metadata are byte-compatible with the JAX package's
logger: either package recovers a directory the other wrote.  Register-plane
writes ride ``OP_REG`` records and the register-mode bit the 5-field
``OP_CREATE``; the register plane and the lease columns snapshot under the
``reg_``, ``lease_`` and ``rlease_`` prefixes (health columns are observation
only and never journaled).  A device-app manager journals each tick's
descriptor upload in the ``OP_TICK`` record's ``kv_reg`` field and
snapshots its KV store and table under the ``dkv_`` prefix.  A targeted
create (``OP_CREATE_AT``) journals its row and the app seed blob, and replay
repeats the same targeted allocation.
"""

from __future__ import annotations

import glob
import io
import os
import struct
import time
import zlib
from typing import List, Optional

import numpy as np

from . import records
from .journal import iter_scan_records, scan_journal
from ..obs.metrics import registry as _obs_registry
from ..paxos.paystore import DEDUP_MIN_BYTES, payload_digest

#: fsyncs slower than this count as stalls (the cloud-variance signal).
FSYNC_STALL_S = float(os.environ.get("GPTPU_FSYNC_STALL_MS", "10")) / 1e3

#: snapshot generations kept before GC (corrupt-latest falls back one
#: generation at the cost of a longer replay)
SNAPSHOT_KEEP = int(os.environ.get("GPTPU_SNAPSHOT_KEEP", "2"))
#: free-bytes low watermark: below it the WAL sheds NEW writes with a
#: retriable error instead of running the disk to ENOSPC mid-fsync
#: (0 disables the check)
MIN_FREE_BYTES = int(os.environ.get("GPTPU_WAL_MIN_FREE_BYTES", "0"))
_FREE_CHECK_EVERY = 32  # statvfs on every Nth fsync, not every one

SNAP_MAGIC = b"GPTPUS01"
_SNAP_FTR = struct.Struct("<II")  # crc32(blob), len(blob); then SNAP_MAGIC

#: payload-slot marker for journal dedup: a body already journaled in this
#: checkpoint epoch is re-referenced as ``(_PAYREF, digest)`` instead of
#: carrying its bytes again.  Real payloads are always ``bytes``, so the
#: tuple is unambiguous; old journals (raw bodies only) decode unchanged.
_PAYREF = "\x00payref"



def _payref(digest: bytes) -> tuple:
    return (_PAYREF, digest)


def _is_payref(pl) -> bool:
    return isinstance(pl, tuple) and len(pl) == 2 and pl[0] == _PAYREF


class WalError(RuntimeError):
    """Base for storage-fault conditions the WAL surfaces loudly."""


class WalFailedError(WalError):
    """append/fsync raised OSError: the journal is failed and the node
    must stop acking (fsyncgate: a post-error retry may 'succeed' while
    the dirty pages were already dropped — fail-stop is the only sound
    response)."""


class WalQuarantinedError(WalError):
    """Recovery found a scribble it cannot repair locally (no peer copy
    of this WAL exists): fail-stop rather than silently serve a
    truncated log."""


class SnapshotCorruptError(WalError):
    """Snapshot blob failed its CRC/length footer check."""


def write_snapshot(path: str, blob: bytes) -> None:
    """Atomic snapshot write: blob + CRC/length footer, fsynced tmp,
    rename.  The footer makes a damaged snapshot *detectable* so recovery
    can fall back a generation instead of loading garbage state."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.write(_SNAP_FTR.pack(zlib.crc32(blob), len(blob)))
        f.write(SNAP_MAGIC)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_snapshot_blob(path: str) -> bytes:
    """Read + verify a snapshot blob.  Footer-less files (snapshots from
    before the footer) are returned as-is for compatibility — their
    corruption is still usually caught by the records codec."""
    with open(path, "rb") as f:
        raw = f.read()
    ftr = len(SNAP_MAGIC) + _SNAP_FTR.size
    if len(raw) >= ftr and raw[-len(SNAP_MAGIC):] == SNAP_MAGIC:
        crc, ln = _SNAP_FTR.unpack(raw[-ftr:-len(SNAP_MAGIC)])
        blob = raw[:-ftr]
        if ln != len(blob) or zlib.crc32(blob) != crc:
            raise SnapshotCorruptError(
                f"snapshot {path}: footer mismatch "
                f"(len {len(blob)} vs {ln})")
        return blob
    return raw


def load_latest_snapshot(log_dir: str):
    """Newest loadable snapshot as ``(seq, decoded)`` or ``None``.

    A snapshot that fails its checksum (or decode) is renamed aside to
    ``*.corrupt`` and the previous generation is tried — the generational
    GC in :meth:`PaxosLogger._gc` keeps SNAPSHOT_KEEP of them around for
    exactly this fallback, trading disk for a longer journal replay."""
    snaps = sorted(glob.glob(os.path.join(log_dir, "snapshot.*.bin")),
                   reverse=True)
    for path in snaps:
        try:
            decoded = records.loads(read_snapshot_blob(path))
        except (WalError, ValueError, OSError) as e:
            _obs_registry().counter(
                "snapshot_fallbacks_total",
                help="corrupt snapshots skipped at recovery",
            ).inc()
            os.replace(path, path + ".corrupt")
            import logging

            logging.getLogger("gptpu.wal").error(
                "snapshot %s corrupt (%s); falling back a generation",
                path, e)
            continue
        return int(os.path.basename(path).split(".")[1]), decoded
    return None


def quarantine_journal(path: str, scan=None) -> str:
    """Move a scribbled journal aside (``*.quarantined``) so it is out of
    the replay glob but preserved for forensics/repair, and count it."""
    dst = path + ".quarantined"
    os.replace(path, dst)
    _obs_registry().counter(
        "wal_quarantines_total",
        help="journals quarantined for mid-log corruption",
    ).inc()
    import logging

    logging.getLogger("gptpu.wal").error(
        "quarantined scribbled journal %s -> %s%s", path, dst,
        f" (corrupt at byte {scan.bad_offset}, {len(scan.suffix)} intact "
        f"records after the damage)" if scan is not None else "")
    return dst


OP_CREATE = 1
OP_REMOVE = 2
OP_TICK = 3
OP_PAUSE = 4
OP_UNPAUSE = 5
OP_SYNC = 6  # checkpoint transfer (laggard repair) — state change outside
             # the tick stream, so replay must re-apply it in sequence
OP_CREATE_AT = 7  # targeted create (placement migration; control-plane
                  # slice): carries the row AND the app seed blob
OP_REG = 8  # register-plane writes: placements onto register rows split
            # out of OP_TICK into a compact record of (row, entries) whose
            # bodies intern through the same payref dedup


#: test-only hook: the storage fault-injection plane wraps every journal
#: the loggers open (testing/faultdisk.py); None in production
_JOURNAL_WRAP = None


def set_journal_wrapper(fn) -> None:
    global _JOURNAL_WRAP
    _JOURNAL_WRAP = fn


def _new_journal(path: str, native: bool):
    """Open ``path`` with the native backend (``native=True``: the C++
    journal or an exception — never a silent fallback) or the pure-Python
    one."""
    if native:
        from .native_journal import NativeJournal

        j = NativeJournal(path)
    else:
        from .journal import PyJournal

        j = PyJournal(path)
    if _JOURNAL_WRAP is not None:
        j = _JOURNAL_WRAP(j, path)
    elif os.environ.get("GPTPU_WAL_FAULTS"):
        # cross-process injection (ProcChaosRunner workers): the plan file
        # lives next to the journal so the runner can arm faults in a
        # child it cannot reach in-process
        from ..testing.faultdisk import wrap_from_env

        j = wrap_from_env(j, path)
    return j


class PaxosLogger:
    def __init__(self, log_dir: str, sync_every_ticks: int = 1,
                 checkpoint_every_ticks: int = 1024, native: bool = True,
                 snapshot_keep: int = SNAPSHOT_KEEP,
                 min_free_bytes: int = MIN_FREE_BYTES,
                 payload_dedup: bool = True):
        self.dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.sync_every = max(1, sync_every_ticks)
        self.checkpoint_every = checkpoint_every_ticks
        self.native = native
        self.manager = None
        self.seq = 0
        self.journal = None
        self._ticks_since_sync = 0
        self._ticks_since_ckpt = 0
        #: journal payload dedup (cfg.paxos.wal_payload_dedup): once a
        #: body's bytes are journaled, later occurrences in the same
        #: checkpoint epoch append an 8-byte digest reference.  Starts
        #: empty on every (re)start — a fresh logger over an existing
        #: journal conservatively writes raw again.
        self.payload_dedup = bool(payload_dedup)
        self._pay_seen: set = set()
        self.snapshot_keep = max(1, snapshot_keep)
        self.min_free_bytes = max(0, min_free_bytes)
        #: append/fsync raised OSError: sticky — the node must fail-stop
        self.failed = False
        #: free-space low watermark tripped: shed NEW writes (retriable),
        #: keep serving reads; clears with hysteresis once space returns
        self.shedding = False
        self._syncs_since_free_check = 0
        # fsync observability: every durability point goes through _sync()
        self._fsync_h = _obs_registry().histogram(
            "wal_fsync_seconds", help="journal fsync wall time")
        self._fsync_stalls = _obs_registry().counter(
            "wal_fsync_stalls_total",
            help=f"fsyncs slower than {FSYNC_STALL_S * 1e3:.0f}ms")
        self._append_bytes = _obs_registry().counter(
            "wal_appended_bytes_total", help="journaled tick-record bytes")
        self._failstops = _obs_registry().counter(
            "wal_failstops_total",
            help="journals marked failed after an append/fsync OSError")
        self._disk_full_g = _obs_registry().gauge(
            "wal_disk_full",
            help="1 while the free-bytes low watermark is shedding writes")
        self._shed_writes = _obs_registry().counter(
            "wal_shed_writes_total",
            help="proposals shed (retriable) while below the watermark")

    # ---------------------------------------------------------- fault surface
    def accepting_writes(self) -> bool:
        """False once the WAL can no longer make new writes durable —
        failed (fail-stop) or below the disk-full watermark (shed with a
        retriable error; reads keep serving)."""
        return not (self.failed or self.shedding)

    def note_shed(self) -> None:
        self._shed_writes.inc()

    def _fail(self, exc: OSError) -> None:
        """fsyncgate discipline: after ANY append/fsync OSError the kernel
        may have dropped the dirty pages, so retrying could ack data that
        never hit disk.  Mark the journal failed (sticky) and fail-stop;
        a restarted node's recovery re-reads only what the disk holds."""
        self.failed = True
        self._failstops.inc()
        import logging

        logging.getLogger("gptpu.wal").critical(
            "WAL %s failed (%s): fail-stop — no further acks", self.dir, exc)
        raise WalFailedError(
            f"WAL {self.dir} append/fsync failed: {exc}") from exc

    def _append(self, rec: bytes) -> None:
        try:
            self.journal.append(rec)
        except OSError as e:
            self._fail(e)

    def _check_free_space(self) -> None:
        if self.min_free_bytes <= 0:
            return
        self._syncs_since_free_check += 1
        if self._syncs_since_free_check < _FREE_CHECK_EVERY and \
                not self.shedding:
            return
        self._syncs_since_free_check = 0
        try:
            st = os.statvfs(self.dir)
        except OSError:
            return
        avail = st.f_bavail * st.f_frsize
        if not self.shedding and avail < self.min_free_bytes:
            self.shedding = True
            self._disk_full_g.set(1)
            import logging

            logging.getLogger("gptpu.wal").error(
                "WAL %s below free-space watermark (%d < %d bytes): "
                "shedding new writes (retriable)", self.dir, avail,
                self.min_free_bytes)
        elif self.shedding and avail >= 2 * self.min_free_bytes:
            # 2x hysteresis so the gauge does not flap at the boundary
            self.shedding = False
            self._disk_full_g.set(0)

    def _sync(self) -> None:
        """The single durability point: fsync the journal, timed.  Slow
        fsyncs (> FSYNC_STALL_S) get their own counter.  An OSError here
        is fail-stop (see _fail)."""
        t0 = time.perf_counter()
        try:
            self.journal.sync()
        except OSError as e:
            self._fail(e)
        dt = time.perf_counter() - t0
        self._fsync_h.observe(dt)
        if dt >= FSYNC_STALL_S:
            self._fsync_stalls.inc()
        self._check_free_space()

    @property
    def backend(self):
        """Which journal backend is open: "native" (csrc/journal.cc),
        "python" (wal/journal.PyJournal), or None before one is."""
        from .native_journal import NativeJournal

        j = getattr(self.journal, "inner", self.journal)  # fault wrapper
        if j is None:
            return None
        return "native" if isinstance(j, NativeJournal) else "python"

    # ------------------------------------------------------------------ wiring
    def attach(self, manager) -> None:
        self.manager = manager
        if self.journal is None:
            # continue the NEWEST journal, which after a corrupt-snapshot
            # generation fallback is newer than the newest loadable
            # snapshot — appending to an older file would scramble the
            # replay order of the next recovery
            self.seq = max(journal_seqs(self.dir)
                           + [self._latest_snapshot_seq() or 0])
            self.journal = _new_journal(self._journal_path(self.seq),
                                        self.native)

    def _journal_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"journal.{seq:08d}.log")

    def _snapshot_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"snapshot.{seq:08d}.bin")

    def _latest_snapshot_seq(self) -> Optional[int]:
        snaps = sorted(glob.glob(os.path.join(self.dir, "snapshot.*.bin")))
        if not snaps:
            return None
        return int(os.path.basename(snaps[-1]).split(".")[1])

    # ----------------------------------------------------------------- logging
    def log_create(self, name: str, members: List[int], epoch: int,
                   register: bool = False) -> None:
        # the register-mode bit rides as an OPTIONAL 5th field: log-mode
        # creates keep the 4-tuple, so journals of runs that never touch
        # register mode stay byte-identical to journals without it
        rec = ((OP_CREATE, name, members, epoch, True) if register
               else (OP_CREATE, name, members, epoch))
        self._append(records.dumps(rec))
        self._sync()

    def log_creates(self, names, members: List[int], epoch: int) -> None:
        """Batched create logging: individual OP_CREATE records (replay is
        unchanged), ONE group-commit fsync."""
        for name in names:
            self._append(
                records.dumps((OP_CREATE, name, list(members), epoch))
            )
        self._sync()

    def log_create_at(self, name: str, members: List[int], epoch: int,
                      row: int, app_seed) -> None:
        """Targeted create (cell or placement migration).  Journals the
        destination row, which replay must reuse to keep the free list in
        step, and the app seed blob: for a migrated group the only durable
        copy of its history once the source epoch's row is removed."""
        self._append(records.dumps(
            (OP_CREATE_AT, name, members, epoch, row, app_seed)
        ))
        self._sync()

    def log_remove(self, name: str) -> None:
        self._append(records.dumps((OP_REMOVE, name)))
        self._sync()

    def log_pause(self, names) -> None:
        """Pause/unpause change row allocation, and journaled tick records
        address groups BY ROW — replay must re-apply the same spills in the
        same order or placements would land on the wrong groups."""
        self._append(records.dumps((OP_PAUSE, list(names))))

    def log_unpause(self, name: str) -> None:
        self._append(records.dumps((OP_UNPAUSE, name)))

    def log_sync(self, r: int, name: str, donor: int, donor_exec: int,
                 donor_status: int, ckpt: bytes) -> None:
        """The record carries the EXACT transferred values, not just the
        donor id: under pipelined ticks the sync is applied one tick after
        the OP_TICK appended at dispatch, so replay re-deriving the
        transfer from the donor's replay-time state would adopt a skewed
        watermark and diverge from the crash run.  The device
        control-summary path and the host scan journal the same record for
        the same repair, and replay applies either verbatim."""
        self._append(records.dumps(
            (OP_SYNC, r, name, donor, donor_exec, donor_status, ckpt)
        ))

    # ------------------------------------------------------- drill-down scan
    def tail_for_row(self, row: int, name: str, max_records: int = 8,
                     max_journals: int = 2) -> list:
        """Bounded newest-last scan of recent journaled ops touching one
        group.  The WAL journals INBOXES, not decisions, so the tail names
        the group's recent intake placements and admin ops — "what was
        this group last asked to do, and when" — without replaying
        anything.  Reads at most ``max_journals`` journal files, returns
        at most ``max_records`` entries, and treats every decode error as
        end-of-scan: this is an observability read, never a recovery path.
        """
        import collections as _collections

        out: _collections.deque = _collections.deque(maxlen=max_records)
        paths = sorted(glob.glob(os.path.join(self.dir, "journal.*.log")))
        for path in paths[-max_journals:]:
            try:
                scan = scan_journal(path)
            except Exception:
                continue
            for raw in scan.records:
                try:
                    rec = records.loads(raw)
                except Exception:
                    break
                op = rec[0]
                if op in (OP_TICK, OP_REG):
                    placed = rec[2]
                    for r, entries in placed:
                        if r != row:
                            continue
                        out.append({
                            "op": "tick" if op == OP_TICK else "reg",
                            "tick": int(rec[1]),
                            "placed": [
                                {"rid": int(e[0]), "entry": int(e[1]),
                                 "lane": int(e[2]), "stop": bool(e[4]),
                                 "bytes": (len(e[3]) if isinstance(
                                     e[3], (bytes, bytearray)) else None)}
                                for e in entries],
                        })
                elif op in (OP_CREATE, OP_CREATE_AT) and rec[1] == name:
                    out.append({"op": "create", "members": list(rec[2]),
                                "epoch": int(rec[3]),
                                "row": (int(rec[4]) if op == OP_CREATE_AT
                                        else None)})
                elif op == OP_REMOVE and rec[1] == name:
                    out.append({"op": "remove"})
                elif op == OP_PAUSE and name in rec[1]:
                    out.append({"op": "pause"})
                elif op == OP_UNPAUSE and rec[1] == name:
                    out.append({"op": "unpause"})
                elif op == OP_SYNC and rec[2] == name:
                    out.append({"op": "sync", "replica": int(rec[1]),
                                "donor": int(rec[3]),
                                "donor_exec": int(rec[4])})
        return list(out)

    def _ref_payload(self, pl):
        """Journal-side payload dedup: the first time a body is journaled
        in this checkpoint epoch its raw bytes go out; every later
        occurrence becomes an 8-byte ``(_PAYREF, digest)`` marker that
        replay resolves from the earlier record in the same journal.  The
        seen-set resets (empty) with every journal roll, keeping each
        journal a self-contained epoch — see checkpoint()."""
        if (not self.payload_dedup or not isinstance(pl, bytes)
                or len(pl) < DEDUP_MIN_BYTES):
            return pl
        d = payload_digest(pl)
        if d in self._pay_seen:
            return _payref(d)
        self._pay_seen.add(d)
        return pl

    def log_inbox(self, tick_num: int, alive: np.ndarray) -> None:
        """Called by the manager after dispatching a tick: record exactly
        what was placed, with payloads for replay.  ``alive`` is the host
        copy of the liveness vector the tick's inbox was built from (the
        device copy is never read back)."""
        m = self.manager
        # the chain manager journals through this method too: it has no
        # register plane, bulk store or device app
        g_log, has_reg = m.G, bool(getattr(m, "G_reg", 0))

        def _entries(take):
            out = []
            for rid, entry, p in take:
                rec = m.outstanding.get(rid)
                if rec is None:
                    continue
                out.append((rid, entry, p,
                            self._ref_payload(rec.payload), rec.stop))
            return out

        # register-plane placements intern FIRST: the OP_REG record is
        # appended (and at replay payref-resolved) before OP_TICK, so
        # first-appearance order must match record order
        reg_placed = []
        if has_reg:
            for row, take in m._placed:
                if row >= g_log:
                    entries = _entries(take)
                    if entries:
                        reg_placed.append((row, entries))
        placed_with_payloads = []
        for row, take in m._placed:
            if has_reg and row >= g_log:
                continue
            entries = _entries(take)
            if entries:
                placed_with_payloads.append((row, entries))
        if reg_placed:
            # appended BEFORE the tick record it belongs to; replay stashes
            # it and folds the rows into the same tick's inbox
            self._append(records.dumps((OP_REG, tick_num, reg_placed)))
        bulk = None
        bp = getattr(m, "_bulk_placed", None)
        if bp is not None:
            rids, be, bpp, br = bp
            idx = m.bulk.idx_of(rids)
            payloads = [self._ref_payload(pl) for pl in m.bulk.payload[idx]]
            bulk = (
                rids.astype(np.int64).tobytes(),
                be.astype(np.int32).tobytes(),
                bpp.astype(np.int32).tobytes(),
                br.astype(np.int32).tobytes(),
                m.bulk.stop[idx].tobytes(),
                list(payloads),
            )
        kv_reg = None
        up = getattr(m, "_kv_uploaded", None)
        if up is not None:
            # device app: descriptor uploads replay in upload order (they
            # are device-state writes, like the tick itself)
            kv_reg = tuple(a.tobytes() for a in up)
            m._kv_uploaded = None
        rec_bytes = records.dumps((OP_TICK, tick_num, placed_with_payloads,
                                   np.asarray(alive, bool).tobytes(), bulk,
                                   kv_reg))
        self._append(rec_bytes)
        self._append_bytes.inc(len(rec_bytes))
        self._ticks_since_sync += 1
        if self._ticks_since_sync >= self.sync_every:
            self._sync()
            self._ticks_since_sync = 0

    def is_synced(self) -> bool:
        """True when every logged tick is covered by an fsync (the manager
        holds client responses until this is true)."""
        return self._ticks_since_sync == 0

    def checkpoint_due(self) -> bool:
        """True when the next maybe_checkpoint() will snapshot — pipelined
        managers drain their pending outbox first so the snapshot's host
        metadata (app state, dedup, queues) covers every tick the device
        state does."""
        return self._ticks_since_ckpt + 1 >= self.checkpoint_every

    def maybe_checkpoint(self) -> None:
        """Called by the manager *after* a tick completes (so the snapshot
        covers it and the rolled journal starts at the next tick; rolling
        before the tick would strand its record in a GC'd journal)."""
        self._ticks_since_ckpt += 1
        if self._ticks_since_ckpt >= self.checkpoint_every:
            self._ticks_since_ckpt = 0
            self.checkpoint()

    # -------------------------------------------------------------- checkpoint
    def _meta(self, m) -> dict:
        """Manager snapshot metadata.  Keys, order and values are the JAX
        package's, so either package restores the other's snapshots."""
        return {
            "tick_num": m.tick_num,
            "next_rid": m._next_rid,
            "rows": dict(m.rows.items()),
            # verbatim LIFO free-list: replayed OP_CREATE/OP_UNPAUSE must
            # allocate the SAME rows the live run did (journaled OP_TICK
            # records address groups by row); reconstructing the free list
            # from rows alone loses the pop order after pause/remove churn
            "free_rows": m.rows.snapshot_free_rows(),
            "stopped_rows": set(m._stopped_rows),
            "seen": {k: list(v.items()) for k, v in m._seen.items()},
            "outstanding": [
                (r.rid, r.name, r.row, r.payload, r.stop, r.entry, r.slot,
                 sorted(r.executed_by), r.responded)
                for r in m.outstanding.values()
            ],
            "queues": {row: list(q) for row, q in m._queues.items() if q},
            # paused groups live only in the spill store + host app state:
            # a snapshot that dropped them would lose them forever once the
            # journal holding their OP_CREATE is GC'd.  peek() keeps cold
            # entries on disk instead of rewriting the whole cold tier.
            "paused": self._paused_snapshot(m),
            # bulk-path state: live columnar store entries + queued rids
            "bulk": m.bulk.snapshot() if m.bulk is not None else None,
            "bulk_queue": (
                np.concatenate(
                    ([m._bulk_leftover] if m._bulk_leftover.size else [])
                    + list(m._bulk_chunks)
                ) if m.bulk is not None
                and (m._bulk_leftover.size or m._bulk_chunks)
                else None
            ),
            # device app: staged-but-not-yet-uploaded descriptors and the
            # placement watermark (uploads already on the device replay
            # from the journal's kv_reg fields)
            "kv_chunks": (
                [tuple(a.tobytes() for a in c) for c in m._kv_chunks]
                if m._device_app else None
            ),
            "kv_watermark": m._kv_watermark if m._device_app else None,
            # device-app managers snapshot the device tensors verbatim
            # (dkv_* in the npz); the per-name app projection would be
            # redundant and lossy (key 0 is the empty-slot sentinel)
            "apps": [
                {
                    name: m.apps[i].checkpoint(name)
                    for name in list(m.rows.names()) + list(m._paused)
                }
                for i in range(m.R)
            ] if not m._device_app else None,
        }

    @staticmethod
    def _paused_snapshot(m) -> dict:
        paused = m._paused
        return {k: paused.peek(k) for k in list(paused)}

    def checkpoint(self) -> str:
        """Write a full snapshot and roll the journal; GC superseded files."""
        from ..paxos.state import PaxosState, to_host

        t_ckpt = time.perf_counter()
        m = self.manager
        self._sync()
        new_seq = m.tick_num
        path = self._snapshot_path(new_seq)
        # host COPIES (a CPU tensor's .numpy() is a view of live state); a
        # mesh manager's fields are joined on the host from its shards
        if getattr(m, "_res", None) is not None:
            state_np = {f: m._res.field_host(f) for f in PaxosState._fields}
        else:
            state_np = {f: to_host(getattr(m.state, f))
                        for f in m.state._fields}
        # (the chain manager snapshots through this method too: it has only
        # its state)
        if getattr(m, "rstate", None) is not None:
            # mixed planes: the register plane snapshots alongside under a
            # reg_ prefix
            for f in m.rstate._fields:
                state_np["reg_" + f] = to_host(getattr(m.rstate, f))
        if getattr(m, "kv", None) is not None:
            # device-app store and table beside the consensus arrays
            for f in m.kv._fields:
                state_np["dkv_" + f] = to_host(getattr(m.kv, f))
        if getattr(m, "_lease", None) is not None:
            # lease columns + the lockstep clock under lease_/rlease_;
            # journal replay re-evolves them tick for tick, so the snapshot
            # is their only root
            for f in m._lease._fields:
                state_np["lease_" + f] = to_host(getattr(m._lease, f))
            if m._rlease is not None:
                for f in m._rlease._fields:
                    state_np["rlease_" + f] = to_host(getattr(m._rlease, f))
            state_np["lease_pack"] = np.array(m._lease_np)
        meta = self._meta(m)
        # Reset the dedup epoch with the journal roll: each journal is
        # self-contained (every payref resolves to a raw body earlier in
        # the SAME file), so replay stays correct even when recovery falls
        # back a snapshot generation (snapshot_keep) — a seed derived from
        # THIS snapshot would dangle under that fallback, because a body
        # admitted since the last checkpoint but placed after this one is
        # carried nowhere else.
        self._pay_seen = set()
        buf = io.BytesIO()
        np.savez_compressed(buf, **state_np)
        blob = records.dumps((meta, buf.getvalue()))
        try:
            write_snapshot(path, blob)
            # roll journal
            self.journal.close()
        except OSError as e:
            self._fail(e)
        self.seq = new_seq
        self.journal = _new_journal(self._journal_path(new_seq), self.native)
        self._gc(new_seq)
        _obs_registry().histogram(
            "wal_checkpoint_seconds", help="snapshot+roll+GC wall time"
        ).observe(time.perf_counter() - t_ckpt)
        return path

    def _gc(self, keep_seq: int) -> None:
        """Generational GC: keep the newest ``snapshot_keep`` snapshots
        (so a corrupt latest can fall back a generation) and every journal
        a replay from the OLDEST kept snapshot would need."""
        snap_seqs = sorted(
            int(os.path.basename(f).split(".")[1])
            for f in glob.glob(os.path.join(self.dir, "snapshot.*.bin"))
        )
        kept = set(snap_seqs[-self.snapshot_keep:]) | {keep_seq}
        oldest_kept = min(kept)
        for f in glob.glob(os.path.join(self.dir, "snapshot.*.bin")):
            if int(os.path.basename(f).split(".")[1]) not in kept:
                os.remove(f)
        for f in glob.glob(os.path.join(self.dir, "journal.*.log")):
            if int(os.path.basename(f).split(".")[1]) < oldest_kept:
                os.remove(f)

    def close(self) -> None:
        if self.journal is not None:
            try:
                self.journal.close()
            except OSError:
                # a failed journal may refuse its final sync; the node is
                # fail-stopping anyway — never mask the original error
                pass
            self.journal = None


# ------------------------------------------------------------------ recovery
#: op byte -> (min_arity, max_arity) whitelist for replay: a
#: corrupt-but-CRC-valid record must fail closed before any dispatcher
#: indexes into it
OP_SCHEMA = {
    OP_CREATE: (4, 5),     # optional 5th field: register-mode bit
    OP_REMOVE: (2, 2),
    OP_TICK: (4, 6),       # legacy records lack bulk/kv_reg fields
    OP_PAUSE: (2, 2),
    OP_UNPAUSE: (2, 2),
    OP_SYNC: (4, 7),       # legacy donor-only records have arity 4
    OP_CREATE_AT: (6, 6),
    OP_REG: (3, 3),        # register-plane writes for the next OP_TICK
}


def journal_seqs(log_dir: str) -> List[int]:
    return sorted(
        int(os.path.basename(p).split(".")[1])
        for p in glob.glob(os.path.join(log_dir, "journal.*.log"))
    )


def _load_op(raw: bytes, schema):
    """Decode + whitelist-validate one journal record."""
    rec = records.loads(raw)
    records.validate_op_record(rec, schema)
    return rec


def _scan_for_replay(path: str, newest: bool, meta_only: bool = False):
    """Scan a journal for replay; scribbles fail-stop here (this WAL has
    no peer copy, so the intact suffix is unrecoverable locally — the one
    honest option is to refuse, loudly, with the file left in place as
    evidence).

    ``meta_only=True`` classifies without materializing record payloads
    (identical verdicts); pair with ``iter_scan_records`` to stream the
    records in bounded memory."""
    scan = scan_journal(path, meta_only=meta_only)
    if scan.kind == "scribble":
        _obs_registry().counter(
            "wal_corrupt_records_total",
            help="corrupt journal records/regions found at recovery",
        ).inc()
        raise WalQuarantinedError(
            f"journal {path}: mid-log corruption at byte "
            f"{scan.bad_offset} with {scan.n_suffix} intact records "
            "after it — fsynced (possibly acked) data was damaged and "
            "this WAL has no peer copy to repair from; refusing to "
            "silently truncate.  The file is left in place; inspect or "
            "restore it, or move it aside to accept the data loss.")
    if scan.kind == "torn_tail" and not newest and scan.file_size and \
            scan.good_len < scan.file_size:
        # a tear is only innocent in the journal being appended at crash
        # time; a rolled (older) journal was closed with a final barrier,
        # so bytes missing from it are lost fsynced data
        _obs_registry().counter(
            "wal_corrupt_records_total",
            help="corrupt journal records/regions found at recovery",
        ).inc()
        raise WalQuarantinedError(
            f"journal {path}: truncated/corrupt tail in a non-newest "
            f"journal (intact to byte {scan.good_len} of "
            f"{scan.file_size}) — rolled journals are sealed by their "
            "final fsync barrier, so this is lost fsynced data, not a "
            "crash tear.")
    return scan


def _tolerate_or_raise(path: str, idx: int, scan, newest: bool, exc) -> bool:
    """Shared record-decode failure policy: a CRC-valid record that fails
    decode/whitelist is tolerable ONLY in the unsynced tail of the newest
    journal (idx >= n_synced: past the last fsync barrier, so it was
    never acked).  Returns True to stop replaying this journal."""
    _obs_registry().counter(
        "wal_corrupt_records_total",
        help="corrupt journal records/regions found at recovery",
    ).inc()
    if newest and idx >= scan.n_synced:
        _obs_registry().counter(
            "wal_replay_tolerated_frames_total",
            help="undecodable records tolerated in the unsynced tail",
        ).inc()
        import logging

        logging.getLogger("gptpu.wal").warning(
            "journal %s: dropping undecodable record %d in the unsynced "
            "tail (%s)", path, idx, exc)
        return True
    raise WalQuarantinedError(
        f"journal {path}: record {idx} is CRC-valid but undecodable "
        f"({exc}) and lies in the fsynced region — corrupt acked data; "
        "refusing to silently skip it.") from exc


def _resolve_payload(pl, pay_tab: dict):
    """Undo journal payload dedup on one payload slot: harvest raw bodies
    into ``pay_tab`` and swap ``(_PAYREF, digest)`` markers for the bodies
    they reference.  An unresolvable reference raises ValueError so the
    caller's corrupt-record policy (_tolerate_or_raise) applies."""
    if _is_payref(pl):
        body = pay_tab.get(pl[1])
        if body is None:
            raise ValueError(
                f"dangling payload reference {pl[1].hex()}")
        return body
    if isinstance(pl, bytes) and len(pl) >= DEDUP_MIN_BYTES:
        pay_tab[payload_digest(pl)] = pl
    return pl


def _resolve_placed(placed, pay_tab: dict):
    return [
        (row, [(rid, entry, p, _resolve_payload(payload, pay_tab), stop)
               for rid, entry, p, payload, stop in entries])
        for row, entries in placed
    ]


def _resolve_tick_payrefs(rec, pay_tab: dict):
    """Undo journal payload dedup on a decoded OP_TICK record.  Runs on
    EVERY OP_TICK — including ticks the replay loop will skip as inside
    the snapshot — because a later record may reference a body first
    journaled in a skipped tick.  Ordering matches the writer (placed
    entries, then the bulk list)."""
    lst = list(rec)
    lst[2] = _resolve_placed(rec[2], pay_tab)
    if len(lst) > 4 and lst[4] is not None:
        bulk = lst[4]
        lst[4] = tuple(bulk[:5]) + (
            [_resolve_payload(pl, pay_tab) for pl in bulk[5]],)
    return tuple(lst)


def _decode_for_replay(raw: bytes, pay_tab: dict):
    """Decode one record for either replay arm: whitelist and payref
    resolution (OP_TICK and OP_REG)."""
    rec = _load_op(raw, OP_SCHEMA)
    op = rec[0]
    if op == OP_REG:
        # resolved even when its tick is snapshot-skipped: later records
        # may payref bodies first seen here
        return (OP_REG, rec[1], _resolve_placed(rec[2], pay_tab))
    if op == OP_TICK:
        rec = _resolve_tick_payrefs(rec, pay_tab)
    return rec


class ReplayProgress:
    """Recovery progress accounting + publication.

    Tracks records/bytes replayed vs. the scanned total, exposes them as
    ``wal_replay_*`` gauges, and (when ``log_dir`` is given) publishes a
    sidecar ``replay_progress.json`` next to the journals, so a long
    replay (single-threaded, unable to answer a health RPC) is
    distinguishable from a hung process."""

    SIDE_FILE = "replay_progress.json"

    def __init__(self, log_dir: Optional[str] = None,
                 min_interval_s: float = 0.25):
        self.log_dir = log_dir
        self.records_total = 0
        self.records_done = 0
        self.bytes_total = 0
        self.bytes_done = 0
        self._file_records = 1
        self._file_recs_done = 0
        self._file_bytes = 0
        self._file_done = 0
        self.phase = "scan"
        self._min_interval = min_interval_s
        self._last_pub = 0.0
        reg = _obs_registry()
        self._g_frac = reg.gauge(
            "wal_replay_progress",
            help="WAL replay progress: records replayed / records scanned")
        self._g_done = reg.gauge(
            "wal_replay_records_done", help="journal records replayed")
        self._g_total = reg.gauge(
            "wal_replay_records_total", help="journal records scanned")

    def begin(self, paths: List[str]) -> None:
        self.phase = "replay"
        self.bytes_total = sum(
            os.path.getsize(p) for p in paths if os.path.exists(p))
        self._publish(force=True)

    def file_scanned(self, path: str, scan) -> None:
        """A journal finished scanning: its record count joins the total
        and per-record byte sizes are approximated pro rata."""
        self.bytes_done += self._file_bytes - self._file_done
        self.records_total += scan.n_records
        self._file_records = max(1, scan.n_records)
        self._file_recs_done = 0
        self._file_bytes = scan.file_size
        self._file_done = 0
        self._publish(force=True)

    def advance(self, n_records: int = 1) -> None:
        self.records_done += n_records
        self._file_recs_done += n_records
        done = int(self._file_bytes
                   * min(1.0, self._file_recs_done / self._file_records))
        if done > self._file_done:
            self.bytes_done += done - self._file_done
            self._file_done = done
        self._publish()

    def finish(self) -> None:
        self.phase = "done"
        self.bytes_done += self._file_bytes - self._file_done
        self._file_done = self._file_bytes
        self._publish(force=True)

    def snapshot(self) -> dict:
        return {
            "phase": self.phase,
            "records_done": int(self.records_done),
            "records_total": int(self.records_total),
            "bytes_done": int(self.bytes_done),
            "bytes_total": int(self.bytes_total),
            "ts": time.time(),
        }

    def _publish(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_pub < self._min_interval:
            return
        self._last_pub = now
        tot = max(1, self.records_total)
        self._g_frac.set(self.records_done / tot)
        self._g_done.set(self.records_done)
        self._g_total.set(self.records_total)
        if self.log_dir is None:
            return
        import json

        path = os.path.join(self.log_dir, self.SIDE_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f)
            os.replace(tmp, path)
        except OSError:
            pass  # progress publication must never fail a recovery


def _stage_placed(m, placed, make_record, on_place=None):
    """Per-tick host staging shared by BOTH replay arms: rid-counter
    repair, outstanding-record creation, snapshot-queue dedup (a request
    queued in the snapshot and placed in the journal would commit twice),
    and the ``m._placed`` take-list the outbox fold re-queues rejects
    from.  ``on_place`` (reference arm only) scatters into the dense host
    inbox buffers; the batched arm ships COO columns instead."""
    import collections

    m._placed = []
    for row, entries in placed:
        take = []
        placed_rids = set()
        for rid, entry, p, payload, stop in entries:
            m._next_rid = max(m._next_rid, rid + 1)
            placed_rids.add(rid)
            if rid not in m.outstanding:
                m.outstanding[rid] = make_record(
                    m, rid, row, payload, stop, entry
                )
            if on_place is not None:
                on_place(entry, p, row, rid, stop)
            take.append((rid, entry, p))
        m._placed.append((row, take))
        if row in m._queues and placed_rids:
            m._queues[row] = collections.deque(
                r for r in m._queues[row] if r not in placed_rids
            )
    return m._placed


def _replay_admin_op(m, rec) -> None:
    """Re-apply one journaled admin op (everything except OP_TICK/OP_REG) —
    shared by both replay arms; in the batched arm these are the batch
    barriers, because they mutate rows/state outside the tick body."""
    op = rec[0]
    if op == OP_CREATE:
        _, name, members, epoch = rec[:4]
        register = bool(rec[4]) if len(rec) > 4 else False
        if name not in m.rows:
            if register:
                m.create_paxos_instance(name, members, epoch, register=True)
            else:  # (the chain manager takes no register bit)
                m.create_paxos_instance(name, members, epoch)
    elif op == OP_CREATE_AT:
        _, name, members, epoch, row, app_seed = rec
        if name not in m.rows:
            # the targeted create and the app seed: replay lands the
            # migrated group on the same row with the same state
            m.create_paxos_instance_at(name, members, epoch, row,
                                       app_seed=app_seed)
    elif op == OP_REMOVE:
        m.remove_paxos_instance(rec[1])
    elif op == OP_PAUSE:
        m._do_pause([n for n in rec[1] if n in m.rows])
    elif op == OP_UNPAUSE:
        m._unpause(rec[1])
    elif op == OP_SYNC:
        if len(rec) >= 7:  # exact record: apply verbatim
            _, r, name, _donor, d_exec, d_status, ckpt = rec[:7]
            m.apply_sync(r, name, d_exec, d_status, ckpt)
        else:  # legacy donor-only record
            _, r, name, donor = rec
            m.sync_laggard(r, name, donor=donor)


def _journal_paths(log_dir, start_seq, progress):
    paths = sorted(glob.glob(os.path.join(log_dir, "journal.*.log")))
    if progress is not None:
        progress.begin([p for p in paths
                        if int(os.path.basename(p).split(".")[1])
                        >= start_seq])
    return paths


def _fold_reg(pending_reg, rec):
    """Fold a stashed OP_REG (register-plane placements, appended just
    before its tick's OP_TICK) into that OP_TICK record."""
    if pending_reg is not None and pending_reg[0] == rec[1]:
        rec = rec[:2] + (list(rec[2]) + pending_reg[1],) + rec[3:]
    return rec


def _post_replay(m) -> None:
    # laggard repairs during replay come ONLY from OP_SYNC records, but the
    # replayed completions still queued the lag they observed — discard it,
    # or the first live tick bursts through a journal's worth of stale
    # (mostly already-repaired) transfer attempts.  (The chain manager has
    # no laggard repair.)
    if hasattr(m, "_lag_sync_due"):
        m._lag_sync_due.clear()
    # the repaired-last-call filter must not carry replay-era keys into the
    # first live tick: a key wrongly present would skip a genuinely due
    # repair (the filter is only valid for one completion's re-flags)
    if hasattr(m, "_repaired_last"):
        m._repaired_last.clear()


def replay_journals(m, log_dir, start_seq, make_record, new_buffers, place,
                    build_inbox, tick_fn, bulk_replay=None, progress=None):
    """Shared journal-replay loop (passes 2–3 of recovery).

    The protocol-specific parts are injected: ``make_record`` builds the
    outstanding-request record, ``new_buffers``/``place``/``build_inbox``
    shape the tick's inbox, ``tick_fn`` runs the device step.  Everything
    else — create/remove replay, snapshot-boundary skip, placed-rid dedup
    against snapshot queues, rid-counter repair — lives here once.

    This is the record-at-a-time REFERENCE arm: one device dispatch per
    journaled tick.  ``replay_journals_batched`` is the columnar fast arm;
    the two recover equal managers.
    """
    # payref resolution table: each journal is a self-contained dedup epoch
    # (writer resets _pay_seen at every roll), so an empty table fills in
    # from raw bodies as records — including snapshot-skipped ticks — decode
    pay_tab: dict = {}
    pending_reg = None  # OP_REG stash for the next OP_TICK
    paths = _journal_paths(log_dir, start_seq, progress)
    for path in paths:
        seq = int(os.path.basename(path).split(".")[1])
        if seq < start_seq:
            continue
        newest = path == paths[-1]
        scan = _scan_for_replay(path, newest, meta_only=True)
        if progress is not None:
            progress.file_scanned(path, scan)
        for idx, raw in enumerate(iter_scan_records(path, scan)):
            if progress is not None:
                progress.advance()
            try:
                rec = _decode_for_replay(raw, pay_tab)
            except (ValueError, IndexError) as e:
                if _tolerate_or_raise(path, idx, scan, newest, e):
                    break
            if rec[0] == OP_REG:
                pending_reg = (rec[1], rec[2])
                continue
            if rec[0] != OP_TICK:
                _replay_admin_op(m, rec)
                continue
            rec, pending_reg = _fold_reg(pending_reg, rec), None
            _, tick_num, placed, alive_b = rec[:4]
            bulk_rec = rec[4] if len(rec) > 4 else None
            if tick_num < m.tick_num:
                continue  # already inside the snapshot
            # the device app's descriptor upload of this tick (read by
            # its tick closure)
            m._replay_kv_reg = rec[5] if len(rec) > 5 else None
            _replay_one_tick(m, placed, bulk_rec,
                             np.frombuffer(alive_b, dtype=bool), tick_num,
                             make_record, new_buffers, place, build_inbox,
                             tick_fn, bulk_replay)
    _post_replay(m)


def _replay_one_tick(m, placed, bulk_rec, alive, tick_num, make_record,
                     new_buffers, place, build_inbox, tick_fn, bulk_replay):
    """One journaled tick through the record-at-a-time body: stage its
    placements (and bulk block) into fresh inbox buffers, run the device
    step, fold the outbox on the host."""
    bufs = new_buffers(m)
    bulk_placed = None
    if bulk_rec is not None and bulk_replay is not None:
        bulk_placed = bulk_replay(m, bufs, bulk_rec)
    _stage_placed(
        m, placed, make_record,
        on_place=lambda e, p, row, rid, stop: place(
            bufs, e, p, row, rid, stop))
    m.state, out = tick_fn(m.state, build_inbox(bufs, alive))
    proc = getattr(m, "_replay_process", None)
    if proc is not None:
        proc(out, bulk_placed)
    elif bulk_placed is not None:
        m._process_outbox(out, None, bulk_placed)
    else:
        m._process_outbox(out)
    m.tick_num = int(tick_num) + 1


#: scatter budget floor for the batched replay arm: replay outboxes must
#: hold a whole tick's executions, and journaled intake can burst past the
#: live exec budget, so the floor keeps overflow fallbacks rare
_REPLAY_SCAT_MIN = 4096

#: journaled ticks per batched replay window
_REPLAY_BATCH = 8

#: dense-vs-sparse crossover: a window goes sparse when its padded active
#: row count times this factor still fits under the full plane width
_SPARSE_FACTOR = 4


def _sparse_rows(acts: np.ndarray, width: int) -> np.ndarray:
    """The gathered row list: the window's active rows (sorted — the
    compact exec stream's rank order over the narrow plane must match the
    dense arm's global row order) padded to a power of two with idle rows
    (one width class per power of two).  Idle pads are provably no-ops
    under the tick fold, but they MUST be duplicate-free against the
    active set: a row gathered twice would scatter back in unspecified
    order.  A plane too small to be worth slicing is taken whole."""
    A = len(acts)
    Ap = 8
    while Ap < A:
        Ap *= 2
    if Ap >= width:
        return np.arange(width, dtype=np.int64)
    pads = np.setdiff1d(
        np.arange(min(width, Ap + A), dtype=np.int64), acts)[:Ap - A]
    return np.concatenate([acts, pads])


class _SparsePlan:
    """One window's sparse-replay geometry: the gathered row lists per
    plane, the composite-local row map for the COO columns and for mapping
    the compact outbox's exec/lag rows back to global."""

    def __init__(self, m, rows_l, rows_r):
        from ..ops.tick import CompactLayout

        self.rows_l, self.rows_r = rows_l, rows_r
        self.wl = len(rows_l)
        self.wr = len(rows_r) if rows_r is not None else 0
        # combined[i] is the GLOBAL composite row at sparse-local index i
        # (register rows ride at G + row, mirroring the dense layout)
        self.combined = (rows_l if rows_r is None else
                         np.concatenate([rows_l, m.G + rows_r]))
        self.width = self.wl + self.wr
        # inv[g] is the sparse-local index of global row g; padding (and
        # every row outside the plan) maps to the trash column `width`
        inv = np.full(m.G_total + 1, self.width, np.int32)
        inv[self.combined] = np.arange(self.width, dtype=np.int32)
        self.inv = inv
        self.layout_l = CompactLayout(m.R, self.wl, max(
            m._exec_budget, _REPLAY_SCAT_MIN), m._lag_budget)


class _BatchedReplay:
    """Window dispatcher for the columnar replay arm.

    Buffers decoded OP_TICK records and, K at a time, flattens them into a
    :class:`~.columnar.TickSlab`, ships the window as padded COO columns
    through one ``replay_scan_ticks*`` run on the device (both planes and
    the lease columns when present),
    then runs the host fold strictly in tick order over the per-tick
    compact rows.  The host ordering is the invariant that makes it equal
    to the reference arm: the device work for all K ticks is journal-
    determined (inboxes come from the log, not from host state), but
    staging (outstanding creation, queue dedup) and `_process_compact`
    (requeues, app execution, watermark folds) for tick k must complete
    before tick k+1's staging — so the dispatcher stages/processes per
    tick AFTER the one batched dispatch.

    Overflow safety: the compact header carries the TRUE pre-drop n_exec,
    and the tick never writes its input state, so a tick whose executions
    exceed the scatter budget discards the window's outputs and re-runs
    it through the exact record-at-a-time body."""

    def __init__(self, m, make_record, new_buffers, place, build_inbox,
                 tick_fn, bulk_replay, batch_ticks: int):
        from ..ops.tick import CompactLayout

        self.m = m
        self.make_record = make_record
        self.new_buffers = new_buffers
        self.place = place
        self.build_inbox = build_inbox
        self.tick_fn = tick_fn
        self.bulk_replay = bulk_replay
        self.K = max(2, int(batch_ticks))
        # state must evolve EXACTLY as the live run's did (same budget
        # semantics as the reference arm's tick closure)
        self.exec_budget = m._exec_budget if m._use_compact else 0
        self.scat = max(m._exec_budget, _REPLAY_SCAT_MIN)
        self.lagb = m._lag_budget
        self.mixed = m.rstate is not None
        self.layout_l = CompactLayout(m.R, m.G, self.scat, self.lagb)
        # sparse windows are sound only when idle rows are exact no-ops
        # under the tick fold: the lease countdown and the health heat
        # decay advance every row every tick, so those keep the dense scan
        self.lease = m._lease is not None
        self.health = m._health is not None
        self.pending: list = []
        self.windows = 0
        self.sparse_windows = 0
        self.overflows = 0

    def add(self, rec) -> None:
        self.pending.append(rec)
        if len(self.pending) >= self.K:
            chunk = self.pending[:self.K]
            del self.pending[:self.K]
            self._run_window(chunk)

    def flush(self) -> None:
        """Drain buffered ticks: full windows through the device run, the
        <K tail through the record-at-a-time body."""
        while len(self.pending) >= self.K:
            chunk = self.pending[:self.K]
            del self.pending[:self.K]
            self._run_window(chunk)
        if self.pending:
            from .columnar import build_tick_slab

            slab = build_tick_slab(self.pending, self.m.R, resolve=False)
            self.pending = []
            for t in range(len(slab)):
                self._reference_tick(slab, t)

    # ------------------------------------------------------------ internals

    def _scan(self, state, rstate, xs):
        """The window's ticks through the replay scan of this manager's
        planes: ``(state, rstate, lease, rlease, packs, lp_last, waits)``
        with the packs copied to the host."""
        from ..ops.tick import _host, _replay_loop

        m = self.m
        res = _replay_loop(state, rstate, m._lease, m._rlease, xs, m.P,
                           self.exec_budget, self.scat, self.lagb,
                           m._lease_horizon)
        # the window's one device-to-host copy of the compact buffers
        return res[:4] + (_host(res[4]),) + res[5:]

    def _overflowed(self, packs, layout_l) -> bool:
        over = packs[:, 0] > self.scat
        if self.mixed:
            over = over | (packs[:, layout_l.total_plain] > self.scat)
        return bool(over.any())

    def _adopt_lease(self, lp_last, waits, K: int) -> None:
        """The host mirror holds only the latest pack: adopt the FINAL
        tick's; the clock advances K in lockstep with the device fold, and
        the fenced counts accumulate per tick."""
        from ..ops.tick import LP_HOLDER, _host

        m = self.m
        if isinstance(lp_last, tuple):
            lp = np.concatenate([_host(lp_last[0]), _host(lp_last[1])],
                                axis=1)
        else:
            lp = _host(lp_last)
        m._lease_np = lp.copy()
        m._lease_clock += K
        m._lease_gauge.set(int((lp[LP_HOLDER] >= 0).sum()))
        w = int(_host(waits).sum())
        if w:
            m._lease_waits_c.inc(w)

    def _run_window(self, chunk) -> None:
        from .columnar import build_tick_slab, coo_window

        m = self.m
        K = len(chunk)
        slab = build_tick_slab(chunk, m.R, resolve=False)
        M = 8  # pow2 pad width
        while M < slab.max_entries():
            M *= 2
        e, p, g, rid, stop, alive = coo_window(slab, 0, K, m.G_total, M)
        xs = {"e": e, "p": p, "g": g, "rid": rid, "stop": stop,
              "alive": alive}
        self.windows += 1
        sp = self._sparse_plan(g)
        if sp is not None:
            if self._run_window_sparse(sp, xs, slab, K):
                return
            # a tick overflowed the scatter budget: pre-window state is
            # intact (gather copies, scatter never ran), so the whole
            # window re-runs through the exact unbudgeted body
            self.overflows += 1
            for t in range(K):
                self._reference_tick(slab, t)
            return
        st, rst, ls, rls, packs, lp_last, waits = self._scan(
            m.state, m.rstate, xs)
        if self._overflowed(packs, self.layout_l):
            # the tick never writes its input: pre-window state is intact,
            # so the whole window re-runs through the exact unbudgeted body
            self.overflows += 1
            for t in range(K):
                self._reference_tick(slab, t)
            return
        m.state, m.rstate = st, rst
        if ls is not None:
            m._lease, m._rlease = ls, rls
            self._adopt_lease(lp_last, waits, K)
        for k in range(K):
            self._host_tick(slab, k, packs[k])

    def _sparse_plan(self, g: np.ndarray):
        """Decide whether this window replays sparse, and build the plan.

        The window's active rows are exactly the COO row column's
        non-padding values (placed ∪ bulk — ``coo_window`` already folded
        both in).  Sparse wins when the padded active set is a small
        fraction of the plane; ``GPTPU_REPLAY_SPARSE`` forces it on
        (tests) or off (A/B)."""
        mode = os.environ.get("GPTPU_REPLAY_SPARSE", "auto")
        if mode in ("0", "off") or self.lease or self.health:
            return None
        m = self.m
        acts = np.unique(g[g < m.G_total]).astype(np.int64)
        if self.mixed:
            split = int(np.searchsorted(acts, m.G))
            rows_l = _sparse_rows(acts[:split], m.G)
            rows_r = _sparse_rows(acts[split:] - m.G, m.G_reg)
        else:
            rows_l, rows_r = _sparse_rows(acts, m.G), None
        sp = _SparsePlan(m, rows_l, rows_r)
        if mode not in ("1", "force") and (
                sp.width * _SPARSE_FACTOR >= m.G_total):
            return None
        return sp

    def _run_window_sparse(self, sp, xs, slab, K: int) -> bool:
        """Gather → K ticks at width A → scatter back.  Returns False on a
        scatter-budget overflow WITHOUT touching manager state (the
        caller re-runs the window record-at-a-time)."""
        import torch

        from ..ops.tick import replay_gather_rows, replay_scatter_rows

        m = self.m
        xs = dict(xs, g=sp.inv[xs["g"]])
        rows_l = torch.as_tensor(sp.rows_l, device=m.device)
        rows_r = (torch.as_tensor(sp.rows_r, device=m.device)
                  if self.mixed else None)
        st, rst, _, _, packs, _, _ = self._scan(
            replay_gather_rows(m.state, rows_l),
            replay_gather_rows(m.rstate, rows_r) if self.mixed else None,
            xs)
        if self._overflowed(packs, sp.layout_l):
            return False
        self.sparse_windows += 1
        m.state = replay_scatter_rows(m.state, st, rows_l)
        if self.mixed:
            m.rstate = replay_scatter_rows(m.rstate, rst, rows_r)
        for k in range(K):
            self._host_tick(slab, k, packs[k], sp)
        return True

    def _host_tick(self, slab, k: int, row, sp=None) -> None:
        """Tick k's host half, strictly in order: bulk admit, staging,
        compact fold, tick counter — the same sequence (and the same
        code) the reference arm runs around its per-tick dispatch."""
        from .columnar import resolved_placed

        m = self.m
        bulk_placed = None
        if slab.bulk[k] is not None and self.bulk_replay is not None:
            bulk_placed = self.bulk_replay(m, None, slab.bulk[k])
        _stage_placed(m, resolved_placed(slab, k), self.make_record)
        m._process_compact(self._unpack(row, sp), m._placed, bulk_placed)
        m.tick_num = int(slab.tick_nums[k]) + 1

    def _unpack(self, row, sp=None):
        from ..ops.tick import merge_compact_outbox, unpack_compact

        m = self.m
        wl = m.G if sp is None else sp.wl
        if self.mixed:
            tl = (self.layout_l if sp is None else sp.layout_l).total_plain
            co = merge_compact_outbox(
                unpack_compact(row[:tl], m.R, wl, self.scat, self.lagb),
                unpack_compact(row[tl:], m.R, m.G_reg if sp is None
                               else sp.wr, self.scat, self.lagb), wl)
        else:
            co = unpack_compact(row, m.R, wl, self.scat, self.lagb)
        if sp is None:
            return co
        # sparse window: map the exec and lag streams' rows back to global
        # composite rows and expand the intake bits into the full row
        # space (idle rows never take)
        taken = np.zeros((m.R, m.G_total), np.int32)
        taken[:, sp.combined] = co.taken_bits
        return co._replace(
            taken_bits=taken,
            e_row=sp.combined[np.asarray(co.e_row, np.int64)],
            l_row=sp.combined[np.asarray(co.l_row, np.int64)])

    def _reference_tick(self, slab, t: int) -> None:
        """Exact record-at-a-time tick body (tails + overflow fallback),
        reconstructed from the slab's columns."""
        from .columnar import resolved_placed

        _replay_one_tick(self.m, resolved_placed(slab, t), slab.bulk[t],
                         slab.alive[t], slab.tick_nums[t], self.make_record,
                         self.new_buffers, self.place, self.build_inbox,
                         self.tick_fn, self.bulk_replay)


def replay_journals_batched(m, log_dir, start_seq, make_record, new_buffers,
                            place, build_inbox, tick_fn, bulk_replay=None,
                            progress=None, batch_ticks=_REPLAY_BATCH):
    """Columnar fast arm of journal replay.

    Identical decode, payref resolution, staging and host fold as
    :func:`replay_journals`, but OP_TICK records are buffered and run on
    the device K at a time (:func:`~..ops.tick.replay_scan_ticks`) — one
    inbox upload and one ``[K, total]`` compact copy per window instead of
    one round trip per tick.  Admin ops are batch barriers: they mutate
    rows/state outside the tick body, so buffered ticks flush before one
    applies.  Returns the dispatcher (window / overflow counters)."""
    disp = _BatchedReplay(m, make_record, new_buffers, place, build_inbox,
                          tick_fn, bulk_replay, batch_ticks)
    pay_tab: dict = {}
    pending_reg = None  # OP_REG stash for the next OP_TICK
    paths = _journal_paths(log_dir, start_seq, progress)
    for path in paths:
        seq = int(os.path.basename(path).split(".")[1])
        if seq < start_seq:
            continue
        newest = path == paths[-1]
        scan = _scan_for_replay(path, newest, meta_only=True)
        if progress is not None:
            progress.file_scanned(path, scan)
        for idx, raw in enumerate(iter_scan_records(path, scan)):
            if progress is not None:
                progress.advance()
            try:
                rec = _decode_for_replay(raw, pay_tab)
            except (ValueError, IndexError) as e:
                if _tolerate_or_raise(path, idx, scan, newest, e):
                    # everything before the bad record still replays
                    disp.flush()
                    break
            if rec[0] == OP_REG:
                pending_reg = (rec[1], rec[2])
            elif rec[0] == OP_TICK:
                rec, pending_reg = _fold_reg(pending_reg, rec), None
                if rec[1] < m.tick_num:
                    continue  # already inside the snapshot
                disp.add(rec)
            else:
                disp.flush()  # admin ops mutate outside the tick body
                _replay_admin_op(m, rec)
    disp.flush()
    _post_replay(m)
    return disp


def _restore_snapshot(m, meta, arrs) -> None:
    """Load a decoded snapshot into a fresh manager ``m``."""
    import collections

    import torch

    from ..ops.tick import LeaseState
    from ..paxos.manager import RequestRecord
    from ..paxos.state import PaxosState, state_from_numpy, to_host

    m.load_state(state_from_numpy([arrs[f] for f in PaxosState._fields],
                                  device=m.device))
    if m.rstate is not None and any(k.startswith("reg_")
                                    for k in arrs.files):
        m.rstate = state_from_numpy(
            [arrs["reg_" + f] for f in PaxosState._fields], device=m.device)
    if m._lease is not None and any(k.startswith("lease_")
                                    for k in arrs.files):
        # both planes' lease columns, the host mirror and the lockstep
        # clock (== the device clock: both advance once per tick)
        def lease_of(prefix):
            return LeaseState(*(torch.as_tensor(np.array(arrs[prefix + f]),
                                                device=m.device)
                                for f in LeaseState._fields))

        m._lease = lease_of("lease_")
        if m._rlease is not None and "rlease_holder" in arrs.files:
            m._rlease = lease_of("rlease_")
        if "lease_pack" in arrs.files:
            m._lease_np = np.array(arrs["lease_pack"])
        m._lease_clock = int(arrs["lease_clock"])
    # checkpoints are taken pipeline-drained (host == device), so the
    # snapshot's device watermark IS the host-applied one; leaving
    # _host_exec at zero would disable the sweep's passed-branch until
    # every member executes again post-recovery
    m._host_exec = m._dev_exec_np().astype(np.int32)
    rplane = [m.rstate] if m.rstate is not None else []
    m._member_np = np.hstack([m._field_np("member")]
                             + [to_host(p.member) for p in rplane])
    m._n_members_np = np.hstack([m._field_np("n_members")]
                                + [to_host(p.n_members) for p in rplane])
    m.tick_num = meta["tick_num"]
    m._next_rid = meta["next_rid"]
    m.rows.restore(meta["rows"], meta.get("free_rows"))
    m._stopped_rows = set(meta["stopped_rows"])
    # rebuild the vectorized-path host mirrors from the restored config
    m._stopped_np[:] = False
    m._stopped_np[list(m._stopped_rows)] = True
    m._member_bits = (
        (np.int64(1) << np.arange(m.R, dtype=np.int64))[:, None]
        * m._member_np
    ).sum(axis=0)
    m._row_name_np[:] = None
    for name, row in m.rows.items():
        m._row_name_np[row] = name
    m._member_ord = None
    if meta.get("bulk") is not None:
        m._ensure_bulk().restore(meta["bulk"])
    if meta.get("bulk_queue") is not None:
        m._bulk_leftover = np.asarray(meta["bulk_queue"], np.int64)
    if m._device_app:
        from ..models.device_kv import DeviceKVState

        if any(k.startswith("dkv_") for k in arrs.files):
            m.kv = DeviceKVState(*(
                torch.as_tensor(np.array(arrs["dkv_" + f]), device=m.device)
                for f in DeviceKVState._fields))
        if meta.get("kv_watermark") is not None:
            m._kv_watermark = int(meta["kv_watermark"])
        for c in meta.get("kv_chunks") or []:
            m._kv_chunks.append(tuple(
                np.frombuffer(b, np.int32).copy() for b in c))
    for k, items in meta["seen"].items():
        m._seen[k] = collections.OrderedDict(items)
    for rid, name, row, payload, stop, entry, slot, eby, responded in meta[
        "outstanding"
    ]:
        m.outstanding[rid] = RequestRecord(rid, name, row, payload, stop,
                                           None, entry, slot, set(eby),
                                           responded)
    for row, rids in meta["queues"].items():
        m._queues[int(row)] = collections.deque(rids)
    # repopulate (not replace) the pause store — cleared before either the
    # snapshot load or journal-only replay runs
    m._paused.update(meta.get("paused", {}))
    # derived bookkeeping the snapshot does not carry directly
    m._row_outstanding = collections.Counter(
        rec.row for rec in m.outstanding.values()
    )
    for row in m.rows._row_to_name:
        m._last_active[row] = m.tick_num
    if meta.get("apps") is not None:
        for i in range(m.R):
            for name, blob in meta["apps"][i].items():
                m.apps[i].restore(name, blob)


def recover(cfg, n_replicas: int, apps, log_dir: str, native: bool = True,
            spill_ns: str = "default", replay_mode: Optional[str] = None,
            progress: Optional[ReplayProgress] = None, device=None):
    """Rebuild a PaxosManager from disk: snapshot + deterministic tick replay
    (the analog of the reference's 3-pass recovery,
    PaxosManager.java:1852-2055, where pass 2 re-drives logged messages
    through the normal handler path with markRecovered semantics).

    ``device`` defaults to CUDA like every entry point of the port: the
    restored state and the replayed ticks live there.  ``replay_mode``:
    ``"batched"`` (default, ``GPTPU_REPLAY_MODE``) or ``"reference"``."""
    import torch

    from ..ops.tick import (TickInbox, merge_outbox, paxos_tick_health,
                            unpack_outbox)
    from ..paxos.manager import PaxosManager, RequestRecord

    logger = PaxosLogger(
        log_dir, native=native,
        payload_dedup=getattr(cfg.paxos, "wal_payload_dedup", True),
    )
    m = PaxosManager(cfg, n_replicas, apps, spill_ns=spill_ns, device=device)
    # stale pre-crash spill files must never pre-populate the pause store:
    # they would make OP_CREATE replay return False and desync the row
    # allocation from the original run (snapshot/journal are the authority)
    m._paused.clear()
    snap = load_latest_snapshot(log_dir)
    start_seq = 0
    if snap is not None:
        snap_seq, (meta, npz_blob) = snap
        _restore_snapshot(m, meta, np.load(io.BytesIO(npz_blob)))
        start_seq = snap_seq

    def make_record(m, rid, row, payload, stop, entry):
        return RequestRecord(rid, m.rows.name(row) or "?", row, payload,
                             stop, None, entry)

    def new_buffers(m):
        # composite row space: register columns ride the same inbox
        return (np.zeros((m.R, m.P, m.G_total), np.int32),
                np.zeros((m.R, m.P, m.G_total), bool))

    def place(bufs, entry, p, row, rid, stop):
        bufs[0][entry, p, row] = rid
        bufs[1][entry, p, row] = stop

    def build_inbox(bufs, alive):
        dev = m.device
        return TickInbox(torch.from_numpy(bufs[0]).to(dev),
                         torch.from_numpy(bufs[1]).to(dev),
                         torch.as_tensor(np.array(alive, bool), device=dev))

    def tick_host(state, inbox):
        # replay must evolve state EXACTLY as the live run did, so the
        # exec budget (if the live run used the compact path) applies here
        # too even though replay consumes the full outbox; the lease
        # columns re-evolve tick for tick (their fold is a pure function
        # of (state, inbox)); health is observation only and not replayed
        budget = m._exec_budget if m._use_compact else 0
        (state, m.rstate, m._lease, m._rlease, _, _, pk_l, pk_r, lp_l, lp_r,
         _, _) = paxos_tick_health(
            state, m.rstate, m._lease, m._rlease, None, None, inbox, -1,
            budget, m._lag_budget, m._lease_horizon, False)
        if lp_l is not None:
            m._adopt_lease_pack(lp_l if lp_r is None else (lp_l, lp_r))
        out = unpack_outbox(pk_l, m.R, m.P, m.W, m.G)
        if pk_r is not None:
            out = merge_outbox(out, unpack_outbox(pk_r, m.R, m.P, 1,
                                                  m.G_reg))
        return state, out

    def bulk_replay(m, bufs, bulk_rec):
        rids_b, be_b, bp_b, br_b, stop_b, payloads = bulk_rec
        rids = np.frombuffer(rids_b, np.int64)
        be = np.frombuffer(be_b, np.int32)
        bp = np.frombuffer(bp_b, np.int32)
        br = np.frombuffer(br_b, np.int32)
        stops = np.frombuffer(stop_b, bool)
        store = m._ensure_bulk()
        m._next_rid = max(m._next_rid, int(rids.max()) + 1) if len(rids) \
            else m._next_rid
        store.admit_at(rids, br, be, stops, payloads)
        # a snapshot may hold queued copies of rids whose placement is
        # journaled after it; drop them or they place twice
        if m._bulk_leftover.size:
            m._bulk_leftover = m._bulk_leftover[
                ~np.isin(m._bulk_leftover, rids)
            ]
        if bufs is not None:  # batched arm ships COO, not dense buffers
            bufs[0][be, bp, br] = rids.astype(np.int32)
            bufs[1][be, bp, br] = stops
        return (rids, be, bp, br)

    mode = replay_mode or os.environ.get("GPTPU_REPLAY_MODE", "batched")
    if m._device_app:
        # device-app replay: the live run's fused call, with the journaled
        # descriptor uploads in order, on-device execution and the compact
        # host fold, record at a time (the upload of each tick threads
        # through the tick closure)
        from ..models.device_kv import fused_compact
        from ..ops.tick import CompactLayout, _host, unpack_compact

        E, Lb, K = m._exec_budget, m._lag_budget, m._kv_reg_budget
        layout = CompactLayout(m.R, m.G, E, Lb)

        def tick_host(state, inbox):
            reg = m._replay_kv_reg
            cols = [np.zeros(K, np.int32) for _ in range(4)]
            if reg is not None:
                for buf, dst in zip(reg, cols):
                    a = np.frombuffer(buf, np.int32)
                    dst[:len(a)] = a
                r0 = np.frombuffer(reg[0], np.int32)
                if len(r0):
                    m._kv_watermark = max(m._kv_watermark, int(r0.max()))
            state, m.kv, packed = fused_compact(state, m.kv, inbox, *cols,
                                                -1, E, Lb)
            flat = _host(packed)
            return state, (unpack_compact(flat, m.R, m.G, E, Lb),
                           *layout.kv_extras(flat))

        def _proc(out, bulk_placed):
            co, er, em = out
            m._process_compact(co, m._placed, bulk_placed, er, em)

        m._replay_process = _proc
        mode = "reference"
    elif m._res is not None:
        # a mesh replays record at a time through its own sharded tick on
        # the resident blocks (the batched arm's scan is a one-device
        # program): each record's inbox is cut on the host into the
        # shards' blocks, and the shards' packed outboxes are joined on
        # the host; only the exec budget's rank blocks cross devices
        from ..ops.tick import _host
        from ..parallel import shard_tick as _stk
        from ..parallel.mesh import shard_inbox

        mesh_tick = _stk.make_resident_tick(
            m.mesh, -1, m._exec_budget if m._use_compact else 0, 0,
            pack=True)

        def build_inbox(bufs, alive):
            return shard_inbox(TickInbox(
                torch.from_numpy(bufs[0]), torch.from_numpy(bufs[1]),
                torch.as_tensor(np.array(alive, bool))), m.mesh)

        def tick_host(state, inboxes):
            m._res.blocks, flats, _ = mesh_tick(m._res.blocks, inboxes)
            return state, _stk.join_full(
                {k: _host(f) for k, f in flats.items()}, m.mesh, m.R, m.P,
                m.W, m.G)

        mode = "reference"
    if progress is None:
        progress = ReplayProgress(log_dir)
    try:
        if mode == "batched":
            disp = replay_journals_batched(
                m, log_dir, start_seq, make_record, new_buffers, place,
                build_inbox, tick_host, bulk_replay=bulk_replay,
                progress=progress)
            # dispatcher counters survive for observability/tests: how
            # many windows ran, how many took the sparse gather path,
            # how many overflowed back to the reference body
            m._replay_windows = disp.windows
            m._replay_sparse_windows = disp.sparse_windows
            m._replay_overflows = disp.overflows
        else:
            replay_journals(
                m, log_dir, start_seq, make_record, new_buffers, place,
                build_inbox, tick_host, bulk_replay=bulk_replay,
                progress=progress)
    finally:
        progress.finish()
    m._replay_process = m._replay_kv_reg = None
    # reattach logging
    logger.attach(m)
    m.wal = logger
    return m
