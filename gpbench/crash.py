"""A run whose deployment loses power in the middle of its window and
restarts from its own snapshot and journal.

The schedule comes from the cell file's ``crash`` entry (``{"at": 0.25}``:
the share of the window after which the crash comes; every run replays
the requests of that much of the arrivals, the same for a seed):

1. set-up as in every run (creates, warm-up turns), then one snapshot
   through the program's own ``PaxosLogger.checkpoint()`` after
   ``drain_pipeline()`` (set-up step ``checkpoint_s``);
2. at the first loop turn boundary at or after ``w0 + at * seconds`` the
   power goes, as it finds the deployment: the last tick's record is
   fsynced and its outbox still pending, so that tick's answers never
   leave.  The manager is dropped without ``close()``, drain, flush or
   final sync, and every journal file is cut at the end of its last
   barrier frame (what was written after the last fsync is lost);
3. ``wal.logger.recover`` rebuilds the deployment in the same process
   (imports, CUDA context and built kernels survive, as ``setup_s`` holds
   them); the loop resumes, and the requests due during the outage are
   proposed then, with their due times.

Clients across the crash.  A client whose request was in flight at the
crash takes its answer from the recovered deployment where that holds
one (``bulk_response``), and otherwise sends the request again, with the
same operation, key and value, as a new request timed from its first due
time: nothing else tells it whether the request was lost or executed.  A
request sent again whose placement the cut journal keeps executes twice
(the recovered deployment executes its first sending too); the reference
counts it under ``crash_exec_twice``.

Ids.  The recovered deployment hands out request ids again from one past
the highest it found placed, which may reuse ids of requests admitted
before the crash and lost with it.  The ledger therefore files every id
the recovered deployment hands out ``shift`` places higher, where ``shift``
lifts its first new id to one past the highest id of the first life.

``recover_s`` runs from the restart (the manager dropped, collected and
the journal cut: the harness's own power loss, left out) to the first
acknowledgement from the recovered deployment; its parts are the
harness's spans ``recover.restore`` (``recover()`` entered to the
replay's begin: the manager build, the snapshot read and restore),
``recover.replay`` (the replay's begin to its finish) and
``recover.first_ack`` (``recover()`` returned to the first
acknowledgement: the backlog admitted and the first live ticks)."""

from __future__ import annotations

import gc
import glob
import math
import os
import struct
import time

import numpy as np

from . import traffic as tr
from .apps import device_kv
from .harness import Run
from .ledger import Ledger
from .trace import Slice

#: the harness spans of a crash run, which name the device's idle gaps
SPANS = ("recover.restore", "recover.replay", "recover.first_ack")

#: the crash cell's controls (``--fault``):
#: ``crash_drop_synced`` cuts the journal at the barrier before the last
#: tick record that placed an answered request (one barrier before the
#: last fsync under load), dropping fsynced records whose answers were
#: released; ``crash_repropose_durable`` has the clients send again also
#: what the recovered deployment answers, and what the last surviving
#: tick record placed
FAULTS = ("crash_drop_synced", "crash_repropose_durable")

_HDR = struct.Struct("<II")
_TICK_AT = struct.Struct("<BQBIBqBq")


class CrashLedger(Ledger):
    """A ledger that files the recovered deployment's request ids apart
    from the first life's (see the module's docstring)."""

    def __init__(self, cap: int = 1 << 20):
        super().__init__(cap)
        #: ids of the first life end below ``n0``; set at the crash
        self.n0 = None
        #: the recovered deployment's first new id; set at its first
        #: admission
        self.n1 = None
        self.shift = 0
        #: clock reading of the first acknowledgement after the crash
        self.first_ack = None
        #: the run's crash record (``CrashRun.crash``), for the readers
        self.crash = None

    def admit(self, rids, reqs, t_due, t_prop) -> np.ndarray:
        rids = np.asarray(rids, np.int64)
        if self.n0 is not None:
            adm = rids >= 0
            if self.n1 is None and adm.any():
                self.n1 = int(rids[adm].min())
                self.shift = max(0, self.n0 - self.n1)
            rids = np.where(adm, rids + self.shift, rids)
        return super().admit(rids, reqs, t_due, t_prop)

    def ack_rids(self, rids, t, resp, jpos=-1) -> None:
        if self.n0 is not None:
            rids = np.asarray(rids, np.int64) + self.shift
        self.ack_first_life(rids, t, resp, jpos)

    def ack_first_life(self, rids, t, resp, jpos=-1) -> None:
        """Acknowledge ledger rows as they are (no id filing)."""
        if self.n0 is not None and len(rids) and self.first_ack is None:
            self.first_ack = float(np.min(t))
        super().ack_rids(rids, t, resp, jpos)

    def file_ids(self, rids) -> np.ndarray:
        """Ledger rows of ids the recovered deployment reports: its new
        ids move up by ``shift``; ids below its first new one (the first
        life's, still held by it) and noops (0) stay."""
        rids = np.asarray(rids, np.int64)
        if self.n1 is None:
            return rids
        return np.where(rids >= self.n1, rids + self.shift, rids)


class CrashAdapter(device_kv.Adapter):
    """The device KV adapter, noting the tick of each outbox the first
    life folds."""

    def __init__(self, ledger, run):
        super().__init__(ledger)
        self.run = run

    def after_tick(self, out, span) -> None:
        n = len(self.streams)
        super().after_tick(out, span)
        if len(self.streams) > n and not self.run.crashed:
            # the outbox a tick() returns is of the tick before the one
            # it dispatched
            self.run.block_tick.append(self.run.m.tick_num - 2)


def recover_progress(log_dir, span):
    """A ``ReplayProgress`` that also closes the ``recover.restore`` span
    and opens ``recover.replay`` at the replay's begin, and closes it at
    its finish, noting the clock at each."""
    from gigapaxos_tpu_torch.wal.logger import ReplayProgress

    class _Progress(ReplayProgress):
        def __init__(self):
            super().__init__(log_dir)
            self.t_enter = self.t_begin = self.t_finish = None
            self._open = None

        def enter(self) -> None:
            self.t_enter = time.perf_counter()
            self._open = span("recover.restore")
            self._open.__enter__()

        def begin(self, paths) -> None:
            self._open.__exit__(None, None, None)
            self.t_begin = time.perf_counter()
            self._open = span("recover.replay")
            self._open.__enter__()
            super().begin(paths)

        def finish(self) -> None:
            super().finish()
            if self.t_begin is not None and self.t_finish is None:
                self._open.__exit__(None, None, None)
                self.t_finish = time.perf_counter()

    return _Progress()


def cut_at_last_barrier(log_dir: str, before: int = None) -> dict:
    """Cut every journal file at the end of its last barrier frame (with
    ``before``, a position, of its last barrier that ends before it: a
    control that drops fsynced records).  Walks the frame headers only.
    Returns the cut position of the newest file (its number times 2^40
    plus the byte offset, as ``Run.journal_pos``), the bytes cut, and the
    number and the last tick number of the tick records left."""
    cut_bytes, n_ticks, last_tick, cut_pos = 0, 0, -1, -1
    for path in sorted(glob.glob(os.path.join(log_dir, "journal.*.log"))):
        seq = int(os.path.basename(path).split(".")[1])
        size = os.path.getsize(path)
        ends, ticks = [], []  # barrier ends; (end, tick) of tick records
        with open(path, "rb") as f:
            pos = 8
            while pos + 8 + 9 <= size:
                f.seek(pos)
                head = f.read(8 + _TICK_AT.size)
                length = _HDR.unpack_from(head)[0]
                end = pos + 8 + length
                if end > size:
                    break
                body = head[8:]
                if body[0] == 1:
                    ends.append(end)
                elif length >= _TICK_AT.size:
                    _k, _s, t_tag, _n, i_tag, op, k_tag, tick = \
                        _TICK_AT.unpack(body)
                    if t_tag == 0x74 and i_tag == 0x69 and op == 3 \
                            and k_tag == 0x69:
                        ticks.append((end, tick))
                pos = end
        if before is not None:
            ends = [e for e in ends if (seq << 40) | e < before]
        keep = ends[-1] if ends else 8
        os.truncate(path, keep)
        cut_bytes += size - keep
        left = [t for e, t in ticks if e <= keep]
        n_ticks += len(left)
        if left:
            last_tick = left[-1]
        cut_pos = (seq << 40) | keep
    return {"cut_pos": cut_pos, "cut_bytes": cut_bytes,
            "tick_records": n_ticks, "last_tick": last_tick}


class CrashRun(Run):
    """A run of a durable device-KV deployment with one crash and
    recovery in its window (see the module's docstring)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.config["app"] != "device_kv" or not self.config.get("wal"):
            raise ValueError("a crash cell needs a durable device-KV "
                             "configuration")
        if self.arrivals is None:
            raise ValueError("a crash cell drives an open loop")
        if self.G != int(self.config["groups"]):
            # fewer groups (the CPU tests): the same load a group, so that
            # the outage's backlog drains as it does at the cell's size
            self.arrivals = tr.Arrivals(
                self.mix["rate"] * self.G / int(self.config["groups"]),
                self.seed)
        self.ledger = CrashLedger()
        self.app = CrashAdapter(self.ledger, self)
        #: tick number of each folded outbox, in order (first life only)
        self.block_tick: list = []
        self.crashed = False
        self.fault = None  # a control of FAULTS
        self.crash = None
        self._first = None  # the open recover.first_ack span
        self._slice = None  # the traced slice while it runs
        self._in_window = False
        self._traced = self.trace
        #: ledger rows of each request sent again after the crash, and of
        #: its first sending
        self._retry_new, self._retry_orig = [], []

    def build(self) -> None:
        super().build()
        self.cfg = self.m.cfg  # what ``recover`` rebuilds the manager with

    def _propose(self, reqs, t_due, orig=None) -> np.ndarray:
        """The base run's proposal, returning the manager's ids (refused
        < 0).  ``orig``: the first sending's ledger row of each request
        sent again."""
        with self.span("gen.propose"):
            t = time.perf_counter()
            rids = np.asarray(self.app.propose(self.m, self.rows[reqs.group],
                                               reqs, self.span), np.int64)
            self.ledger.admit(rids, reqs, t_due, t)
        adm = rids >= 0
        if orig is not None and adm.any():
            self._retry_orig.append(orig[adm])
            self._retry_new.append(rids[adm] + self.ledger.shift)
        return rids

    # ------------------------------------------------------------ set-up
    def warm(self) -> None:
        if self.trace:
            # the profiler's first start takes seconds: taken before the
            # load starts, it leaves no warm-up turn holding the arrivals
            # of those seconds
            sl = Slice(self.torch, self.device.type == "cuda")
            sl.start()
            sl.stop()
        super().warm()
        m = self.m
        with self.span("manager.drain"):
            m.drain_pipeline()
        self.app.after_tick(None, self.span)
        t = time.perf_counter()
        m.wal.checkpoint()
        self.setup_steps["checkpoint_s"] = time.perf_counter() - t
        #: requests admitted before the snapshot: their placements are in
        #: the journals the checkpoint removed, their effects in the store
        self.rid_ckpt = self.ledger.top

    # -------------------------------------------------------- the loop
    def _crash_due(self) -> float:
        return self.w0 + self.seconds * float(self.cell["crash"]["at"])

    def window(self) -> None:
        """The base run's loop, with the crash taken at the start of a turn
        (``_feed``).  The traced slice is this run's own: it runs from the
        crash to the turn that sees the first acknowledgement from the
        recovered deployment, so the base loop runs untraced."""
        self._in_window, self.trace = True, False
        try:
            super().window()
        finally:
            self.trace, self._in_window = self._traced, False

    def _feed(self, now: float) -> None:
        # warm() feeds too, before the window and its crash
        if self._in_window and not self.crashed \
                and now >= self._crash_due():
            if self._traced:
                self._start_slice()
            self._crash()
            now = time.perf_counter()
        elif self._first is not None and self.ledger.first_ack is not None:
            self._first_acked()
        super()._feed(now)

    def _start_slice(self) -> None:
        from .harness import _launches, _phases

        self._slice = Slice(self.torch, self.device.type == "cuda")
        self._slice.start()
        self.slice_t0 = time.perf_counter()
        self.slice_tick0 = self.ticks
        self.slice_ph0, self.slice_launch0 = _phases(), _launches()

    def _end_slice(self, sl) -> None:
        # the profiler's stop, seconds over the recovery's records, is
        # left out of the slice
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        t1 = time.perf_counter()
        super()._end_slice(sl)
        self.slice_t1 = t1

    def drain(self) -> None:
        if not self.crashed:
            raise RuntimeError("the window closed before the crash came")
        super().drain()
        if self._first is not None:
            # the window closed before the recovered deployment answered
            self._first_acked()

    def _first_acked(self) -> None:
        self._first.__exit__(None, None, None)
        self._first = None
        self.crash["first_ack"] = self.ledger.first_ack
        if self._slice is not None:
            self._end_slice(self._slice)
            self._slice = None

    def _crash(self) -> None:
        from gigapaxos_tpu_torch.wal.logger import recover

        led = self.ledger
        # the power goes: no drain, close, flush or final sync; the last
        # tick's record is fsynced, its outbox pending
        t_crash = time.perf_counter()
        self.crashed = True
        self.n_pre_blocks = len(self.app.streams)
        self.m = None
        gc.collect()
        t_collected = time.perf_counter()
        before = (self._last_placing(answered=True)[0]
                  if self.fault == "crash_drop_synced" else None)
        cut = cut_at_last_barrier(self.wal_dir, before)
        t_down = time.perf_counter()

        # restart: the recovery path of the program, in this process
        w = self.config["wal"]
        progress = recover_progress(self.wal_dir, self.span)
        progress.enter()
        m = recover(self.cfg, self.R, self.app.replicas(self.R, self.G),
                    self.wal_dir, native=w["native"], spill_ns="gpbench",
                    device=self.device, progress=progress)
        t_back = time.perf_counter()
        m.wal.sync_every = max(1, w["sync_every_ticks"])
        m.wal.checkpoint_every = w["checkpoint_every_ticks"]
        if w["native"] and m.wal.backend != "native":
            raise RuntimeError("the recovered WAL did not open the native "
                               "journal")
        self.app.attach(m)
        self.m = m

        # the clients of the requests in flight: answered where the
        # recovered deployment holds a response, sent again otherwise
        led.n0 = led.top
        adm = led.admitted()
        infl = adm[led.n_ack[adm] == 0]
        resp = [m.bulk_response(int(r)) for r in infl]
        has = np.array([r is not None for r in resp], bool)
        if has.any():
            led.ack_first_life(infl[has], time.perf_counter(),
                               np.array([int(r) for r in resp
                                         if r is not None], np.int64),
                               self.journal_pos())
        lost = infl[~has]
        if self.fault == "crash_repropose_durable":
            # clients that send again what the recovered deployment
            # answers, and what the last surviving record placed
            lost = np.union1d(infl, self._last_placing(answered=False)[1])
        reqs = tr.Requests(led.group[lost].copy(), led.op[lost].copy(),
                           led.key[lost].copy(), led.val[lost].copy(),
                           led.delta[lost].copy())
        t_due = led.t_due[lost].copy()
        # the first sending leaves the ledger: the retry is the request
        led.group[lost] = -1
        led.n_admitted -= len(lost)
        led.n_acked -= int((led.n_ack[lost] > 0).sum())
        if len(lost):
            self._propose(reqs, t_due, lost)
        self._first = self.span("recover.first_ack")
        self._first.__enter__()
        self.crash = {"t_crash": t_crash, "t_collected": t_collected,
                      "t_down": t_down, "t_enter": progress.t_enter,
                      "t_begin": progress.t_begin,
                      "t_finish": progress.t_finish, "t_back": t_back,
                      "first_ack": None, **cut,
                      "answered_after": int(has.sum()),
                      "resent": int(len(lost))}
        led.crash = self.crash

    def _last_placing(self, answered: bool):
        """For the controls: the end and the placed ids of the last tick
        record in the journal that placed a request of the first life (a
        request answered before the crash, with ``answered``)."""
        from .reference.journal import read_journal

        led = self.ledger
        adm = led.admitted()
        want = np.zeros(led.top, bool)
        want[adm[led.n_ack[adm] > 0] if answered else adm] = True
        last = (None, np.zeros(0, np.int64))
        for path in sorted(glob.glob(os.path.join(self.wal_dir,
                                                  "journal.*.log"))):
            for _tick, rids, _desc, end in read_journal(path)["ticks"]:
                r = rids[(rids > 0) & (rids < led.top)]
                if want[r].any():
                    last = (end, r[want[r]])
        return last

    @property
    def retry_orig(self) -> np.ndarray:
        return np.concatenate(self._retry_orig + [np.zeros(0, np.int64)])

    @property
    def retry_new(self) -> np.ndarray:
        return np.concatenate(self._retry_new + [np.zeros(0, np.int64)])
