"""One run of one cell: build the deployment, warm it up under its own
traffic, drive the measured window, drain, and hand everything the
readers and the reference need to ``run.py``.

The served path is the embedded ``PaxosManager`` of the port: each loop
turn proposes what the traffic has due (``propose_bulk``, or
``propose_bulk_kv`` for the device app) and then calls ``tick``; the
acknowledgements come back through the manager's completion sink or
callbacks."""

from __future__ import annotations

import gc
import importlib
import os
import resource
import shutil
import tempfile
import time

import numpy as np

from . import traffic as tr
from .ledger import Ledger
from .trace import Slice, span_factory

#: longest wait past the window's close for the requests due in it
DRAIN_LIMIT_S = 60.0


def make_cfg(config: dict):
    """A ``GigapaxosTpuConfig`` with the configuration file's sections
    (``paxos``, ``overload``) written over the defaults."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = config["groups"]
    cfg.paxos.window = config["window"]
    cfg.paxos.proposals_per_tick = config["proposals_per_tick"]
    for section in ("paxos", "overload"):
        sec = getattr(cfg, section)
        for k, v in config.get(section, {}).items():
            if not hasattr(sec, k):
                raise KeyError(f"config {section}.{k} is not a setting")
            setattr(sec, k, v)
    return cfg


class Run:
    def __init__(self, torch, device, config: dict, mix: dict, cell: dict,
                 seed: int, seconds: float, trace: bool, groups=None):
        self.torch, self.device = torch, device
        self.config, self.mix, self.cell = config, mix, cell
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.G = int(groups or config["groups"])
        self.R = int(config["replicas"])
        self.span = span_factory(torch, trace)
        self.ledger = Ledger()
        self.stream = tr.RequestStream(mix, seed, self.G)
        self.arrivals = (tr.Arrivals(mix["rate"], seed)
                         if mix["loop"] == "open" else None)
        app_mod = importlib.import_module(f"gpbench.apps.{config['app']}")
        self.app = app_mod.Adapter(self.ledger)
        self.ticks = 0
        self.wal_dir = None
        self.m = None

    # ------------------------------------------------------------ set-up
    def build(self) -> None:
        from gigapaxos_tpu_torch.paxos.manager import PaxosManager

        cfg = make_cfg(self.config)
        cfg.paxos.max_groups = self.G
        if self.config.get("exec_budget_headroom") is not None:
            cfg.paxos.exec_budget = (self.R * self.G
                                     + self.config["exec_budget_headroom"])
        if self.config.get("bulk_capacity_per_group") is not None:
            cfg.paxos.bulk_capacity = (self.config["bulk_capacity_per_group"]
                                       * self.G)
            cfg.overload.intake_hi = cfg.paxos.bulk_capacity
        wal = None
        w = self.config.get("wal")
        if w:
            from gigapaxos_tpu_torch.wal.logger import PaxosLogger

            self.wal_dir = tempfile.mkdtemp(prefix="gpbench-wal-")
            wal = PaxosLogger(self.wal_dir,
                              sync_every_ticks=w["sync_every_ticks"],
                              checkpoint_every_ticks=w["checkpoint_every_ticks"],
                              native=w["native"],
                              payload_dedup=w.get("payload_dedup", True))
        apps = self.app.replicas(self.R, self.G)
        t0 = time.perf_counter()
        m = PaxosManager(cfg, self.R, apps, wal=wal, spill_ns="gpbench",
                         device=self.device)
        if wal is not None and w["native"] and wal.backend != "native":
            raise RuntimeError("the WAL did not open the native journal")
        self.app.attach(m)
        if wal is not None:
            self.app.journal_pos = self.journal_pos
        t1 = time.perf_counter()
        names = [f"g{i}" for i in range(self.G)]
        if m.create_paxos_instances(names, list(range(self.R))) != self.G:
            raise RuntimeError("group creation fell short")
        self.rows = np.fromiter((m.rows.row(n) for n in names), np.int64,
                                count=self.G)
        self.m = m
        self.setup_steps = {"manager_s": t1 - t0,
                            "create_s": time.perf_counter() - t1}

    def journal_pos(self) -> int:
        """Where the journal stands: the current file's number times
        2^40 plus the bytes written to it.  A barrier frame that ends at or
        before it was written, and fsynced with it (the native journal
        holds its frames in a buffer that only a sync or an overflow
        writes out)."""
        wal = self.m.wal
        path = os.path.join(wal.dir, f"journal.{wal.seq:08d}.log")
        return (wal.seq << 40) | os.stat(path).st_size

    def journal_bytes(self) -> int:
        """Bytes in the run's journal files."""
        if self.wal_dir is None:
            return 0
        return sum(e.stat().st_size for e in os.scandir(self.wal_dir)
                   if e.name.startswith("journal."))

    # -------------------------------------------------------- the loop
    def _propose(self, reqs, t_due) -> None:
        with self.span("gen.propose"):
            t = time.perf_counter()
            rids = self.app.propose(self.m, self.rows[reqs.group], reqs,
                                    self.span)
            self.ledger.admit(rids, reqs, t_due, t)

    def _feed(self, now: float) -> None:
        if self.arrivals is None:
            need = self.mix["clients"] - self.ledger.in_flight()
            if need > 0:
                self._propose(self.stream.take(need), now)
        else:
            due = self.arrivals.until(now - self.t_load)
            if len(due):
                self._propose(self.stream.take(len(due)),
                              self.t_load + due)

    def _tick(self, name="manager.tick") -> None:
        with self.span(name):
            out = self.m.tick()
        self.app.after_tick(out, self.span)
        self.ticks += 1

    def warm(self) -> None:
        """The cell's own traffic until the loop is steady: ``warm_ticks``
        loop turns (each proposes what is due, then ticks)."""
        self.t_load = time.perf_counter()
        n = int(self.cell["warm_ticks"])
        turns = []
        for i in range(n):
            if self.trace and i == n - 1:
                # the profiler's first start takes seconds: take it here
                sl = Slice(self.torch, self.device.type == "cuda")
                sl.start()
            t = time.perf_counter()
            self._feed(t)
            self._tick()
            turns.append(time.perf_counter() - t)
        # the first turn scripts the tick program and builds the kernels
        self.setup_steps.update(first_turn_s=turns[0],
                                other_turns_s=sum(turns[1:]))
        if self.trace:
            sl.stop()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def window(self) -> None:
        """The measured window: feed and tick until ``seconds`` pass.  With
        tracing, the profiler covers the window's middle ``trace_seconds``."""
        led = self.ledger
        self.tick0, self.refused0 = self.ticks, led.refused
        t0 = time.perf_counter()
        t1 = t0 + self.seconds
        self.w0, self.w1 = t0, t1
        ts = min(float(self.cell.get("trace_seconds", 3.0)), self.seconds)
        tr0 = t0 + (self.seconds - ts) / 2
        self.slice = sl = None
        self.turns = []
        ru0, gc0, ph0 = _usage(), _collections(), _phases()
        while True:
            now = time.perf_counter()
            if now >= t1:
                break
            if self.trace and sl is None and now >= tr0:
                sl = Slice(self.torch, self.device.type == "cuda")
                sl.start()
                self.slice_t0 = time.perf_counter()
                self.slice_tick0 = self.ticks
                self.slice_ph0, self.slice_launch0 = _phases(), _launches()
            if sl is not None and self.slice is None and now >= tr0 + ts:
                self._end_slice(sl)
            self._feed(now)
            self._tick()
            self.turns.append(time.perf_counter() - now)
        self.window_ticks = self.ticks - self.tick0
        self.refused_in_window = led.refused - self.refused0
        # what the process went through in the window, for the stderr log
        self.window_usage = _diff(ru0, _usage())
        self.window_gc = _diff(gc0, _collections())
        self.window_phases = _diff(ph0, _phases())
        if sl is not None and self.slice is None:
            self._end_slice(sl)

    def _end_slice(self, sl) -> None:
        sl.stop()
        self.slice_t1 = time.perf_counter()
        self.slice_ticks = self.ticks - self.slice_tick0
        self.slice_ph = _diff(self.slice_ph0, _phases())
        self.slice_launch = _diff(self.slice_launch0, _launches())
        self.slice = sl

    def drain(self) -> None:
        """No new requests: tick until every admitted request is
        acknowledged and executed at every member, at most
        ``DRAIN_LIMIT_S`` past the window's close."""
        m, led = self.m, self.ledger
        limit = time.perf_counter() + DRAIN_LIMIT_S
        while time.perf_counter() < limit:
            st = m.bulk_stats()
            if (led.in_flight() == 0 and st["live"] == 0
                    and st["queued"] == 0):
                break
            self._tick("manager.drain")
        self.gave_up = time.perf_counter()
        # each call may release acknowledgements: fold them after each
        with self.span("manager.drain"):
            m.drain_pipeline()
        self.app.after_tick(None, self.span)
        with self.span("manager.drain"):
            out = m.tick()  # hands back the drained outbox
        self.app.after_tick(out, self.span)
        with self.span("manager.drain"):
            m.drain_pipeline()
        self.app.after_tick(None, self.span)

    def close(self) -> None:
        if self.m is not None and self.m.wal is not None:
            self.m.wal.close()

    def cleanup(self) -> None:
        if self.wal_dir is not None:
            shutil.rmtree(self.wal_dir, ignore_errors=True)
            self.wal_dir = None


def _usage() -> dict:
    """The process's CPU seconds, all threads."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"utime": ru.ru_utime, "stime": ru.ru_stime}


def _collections() -> dict:
    """Collections the garbage collector has made, by generation."""
    return {f"gen{i}": st["collections"]
            for i, st in enumerate(gc.get_stats())}


def _phases() -> dict:
    """(count, total seconds) of each Mode A tick phase, all planes."""
    from gigapaxos_tpu_torch.obs.metrics import registry

    out = {}
    for h in registry().find("tick_phase_seconds"):
        lb = dict(h.labels)
        if lb.get("driver") == "modea" and lb.get("plane") == "gpbench":
            out[lb["phase"]] = (h.count, h.total)
    return out


def _diff(a: dict, b: dict) -> dict:
    """``b - a`` key by key (tuples element by element)."""
    def sub(x, y):
        return (tuple(p - q for p, q in zip(x, y)) if isinstance(x, tuple)
                else x - y)

    return {k: sub(b[k], a[k]) if k in a else b[k] for k in b}


def _launches() -> dict:
    from gigapaxos_tpu_torch.ops import plane_gather

    return dict(plane_gather.launches)
