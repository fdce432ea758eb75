"""Declarative fault-schedule harness: scripted chaos over SimNet or
real OS processes, with a replayable event log and per-slot safety ledger.

The reference hand-codes each failure scenario (``TESTPaxosMain`` crashes
nodes at fixed request counts; JSONDelayEmulator adds one global delay).
This module makes scenarios *data*: a :class:`ChaosSchedule` is a JSON-able
list of ``(at_tick, action, args)`` events — crash/recover, partition/heal,
slow node, WAL-fsync stall, region cut — executed by an adapter against
either

* the deterministic in-process stack (:class:`SimChaosRunner` over
  ``testing.simnet.SimNet`` + ``ModeBNode``), where ``at_tick`` is the
  exact tick index and the whole run replays bit-identically from
  ``(seed, schedule)``; or
* the real multiprocess stack (:class:`ProcChaosRunner` over the
  ``tests/modeb_worker.py``-style process handles), where ``at_tick``
  maps to wall-clock offsets and crash/stall become SIGKILL/SIGSTOP.

Every run records the events it applied into a :class:`ChaosLog`
(JSON-serializable: seed + schedule + applied events + stats), and every
run carries a :class:`SafetyLedger` asserting the S1 invariant — no two
replicas ever execute different requests for the same (group, slot).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional

#: Actions understood by the SimNet adapter.  The process adapter supports
#: the subset in :data:`PROC_ACTIONS`; schedules are validated up front so
#: an unsupported scenario fails loudly, not silently mid-run.
SIM_ACTIONS = frozenset({
    "crash", "recover", "partition", "heal", "slow_node", "fsync_stall",
    "cut_region", "heal_region", "set_delay", "drop_pending",
    "mark_down", "mark_up", "propose",
    # storage faults (testing/faultdisk.py): the first two operate on a
    # CRASHED node's journal files; the last three arm the live shim
    "bit_flip", "torn_write", "fsync_error", "disk_full", "disk_ok",
})
PROC_ACTIONS = frozenset({
    "crash", "recover", "fsync_stall", "propose",
    "bit_flip", "torn_write", "fsync_error", "disk_full",
})


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault: at tick ``at_tick`` apply ``action(**args)``."""

    at_tick: int
    action: str
    args: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"at_tick": self.at_tick, "action": self.action,
                "args": dict(self.args)}


@dataclasses.dataclass
class ChaosSchedule:
    """A named, seeded, JSON-able fault scenario."""

    name: str
    events: List[ChaosEvent]
    seed: int = 0

    def validate(self, supported: frozenset = SIM_ACTIONS) -> None:
        for ev in self.events:
            if ev.action not in supported:
                raise ValueError(
                    f"schedule {self.name!r}: action {ev.action!r} not in "
                    f"{sorted(supported)}")

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "seed": self.seed,
            "events": [ev.to_dict() for ev in self.events],
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ChaosSchedule":
        d = json.loads(text)
        return cls(
            name=d["name"], seed=int(d.get("seed", 0)),
            events=[ChaosEvent(int(e["at_tick"]), e["action"],
                               dict(e.get("args", {})))
                    for e in d["events"]],
        )


class ChaosLog:
    """Replayable record of one run: every applied event plus outcome info.

    Two runs of the same ``(seed, schedule)`` over the Sim adapter must
    produce identical logs — that is the replay contract (and the same
    schedule gives the same log in the JAX package and in this one).
    """

    def __init__(self, schedule: ChaosSchedule):
        self.schedule = schedule
        self.records: List[dict] = []

    def record(self, tick: int, action: str, args: Mapping[str, object],
               **info) -> None:
        rec = {"tick": tick, "action": action, "args": dict(args)}
        if info:
            rec["info"] = info
        self.records.append(rec)

    def to_dict(self) -> dict:
        return {"schedule": json.loads(self.schedule.to_json()),
                "applied": self.records}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


class SafetyLedger:
    """S1 invariant across every replica of a run: for each (group, slot)
    at most ONE request id is ever executed, cluster-wide.  Noop fills
    count — a slot decided noop on one replica and a value on another is
    a real divergence.  (The same rid at two slots is legal: a request
    re-proposed across a coordinator change can decide twice and is
    deduped at execution.)"""

    def __init__(self):
        self.decided: Dict[tuple, int] = {}  # (name, slot) -> rid
        self.violations: List[dict] = []
        self.observations = 0

    def observe(self, node_id: str, name: str, slot: int, rid: int) -> None:
        self.observations += 1
        key = (name, int(slot))
        prev = self.decided.setdefault(key, int(rid))
        if prev != int(rid):
            self.violations.append({
                "node": node_id, "group": name, "slot": int(slot),
                "rid": int(rid), "prev_rid": prev,
            })

    def attach(self, node_id: str, node) -> None:
        """Tap ``node``'s execution stream (everything funnels through
        ``_execute_direct``, including drained digest stalls; checkpoint
        transfers replace app state wholesale and never claim slots, so
        they correctly don't appear here)."""
        orig = node._execute_direct

        def wrapped(row, name, rid, slot, is_stop, response=None,
                    _orig=orig, _nid=node_id):
            self.observe(_nid, name, slot, rid)
            return _orig(row, name, rid, slot, is_stop, response)

        node._execute_direct = wrapped

    def assert_safe(self) -> None:
        assert not self.violations, (
            f"S1 violated: two decided values per slot: {self.violations}")


# --------------------------------------------------------------------- sim
class SimChaosRunner:
    """Execute a schedule against a SimNet-backed ModeBNode cluster.

    ``nodes`` maps node id -> ``ModeBNode`` (ids in member-index order —
    index i is tick row i, which ``mark_down``/``mark_up`` need).  The
    runner owns the tick loop: crashed nodes stop ticking and are cut from
    the wire (their in-memory state survives, i.e. recovery is modeled as
    a perfect WAL restore); fsync-stalled nodes stop ticking but stay
    connected, so frames pile into their inbox exactly as a tick thread
    blocked in ``os.fsync`` would see.
    """

    def __init__(self, net, nodes: Mapping[str, object],
                 schedule: ChaosSchedule,
                 ledger: Optional[SafetyLedger] = None,
                 wal_dirs: Optional[Mapping[str, str]] = None,
                 injector=None,
                 restart: Optional[Callable[[str], object]] = None,
                 rng=None):
        """Storage-fault extras (all optional — pure network chaos needs
        none of them): ``wal_dirs`` maps node id -> WAL directory,
        ``injector`` is a ``faultdisk.Injector`` whose shims wrap the
        nodes' journals, ``restart(node_id) -> node`` rebuilds a crashed
        node from its (possibly damaged) WAL dir — real recovery instead
        of the perfect in-memory restore.  ``rng`` seeds bit_flip/
        torn_write placement."""
        schedule.validate(SIM_ACTIONS)
        self.net = net
        self.nodes = dict(nodes)
        self.ids = list(nodes)  # insertion order == member index order
        self.schedule = schedule
        self.log = ChaosLog(schedule)
        self.ledger = ledger or SafetyLedger()
        for nid, nd in self.nodes.items():
            self.ledger.attach(nid, nd)
        self._pending = sorted(schedule.events,
                               key=lambda e: (e.at_tick, e.action))
        self.crashed: set = set()
        self.stalled: Dict[str, int] = {}  # node -> remaining stalled ticks
        self.tick = 0
        self.proposals: List[dict] = []  # completions from 'propose' events
        self.wal_dirs = dict(wal_dirs or {})
        self.injector = injector
        self.restart = restart
        self.rng = rng
        self.failstops: List[dict] = []  # nodes that died on their disk

    # ------------------------------------------------------------- actions
    def _isolate(self, node: str) -> None:
        others = [n for n in self.ids if n != node]
        if others:
            self.net.partition({node}, set(others))

    def _reconnect(self, node: str) -> None:
        self.net._down = {(a, b) for (a, b) in self.net._down
                          if a != node and b != node}

    def _mark(self, node: str, up: bool) -> None:
        r = self.ids.index(node)
        for nid, nd in self.nodes.items():
            if nid != node and nid not in self.crashed:
                nd.set_alive(r, up)

    def _apply(self, ev: ChaosEvent) -> None:
        a, args = ev.action, dict(ev.args)
        info: dict = {}
        if a == "crash":
            node = args["node"]
            self.crashed.add(node)
            self._isolate(node)
            info["dropped"] = (self.net.drop_pending(src=node)
                               + self.net.drop_pending(dst=node))
            # survivors' failure detectors flip the node down after a
            # detection delay; model it as a scheduled mark_down
            detect = int(args.get("detect_after", 0))
            if detect >= 0:
                self._pending.append(ChaosEvent(
                    ev.at_tick + detect, "mark_down", {"node": node}))
                self._pending.sort(key=lambda e: (e.at_tick, e.action))
        elif a == "recover":
            node = args["node"]
            if self.restart is not None and node not in self.crashed:
                # the fault this recover was scheduled for never tripped
                # (e.g. an armed fsync_error with no traffic): replacing a
                # LIVE node with a disk image would itself lose state
                info["skipped"] = "node not down"
                self.log.record(ev.at_tick, a, args, **info)
                return
            if self.restart is not None:
                # real recovery: rebuild from the WAL dir, which chaos may
                # have damaged since the crash.  A quarantined-beyond-
                # repair log fail-stops right here — the node stays down,
                # which is the contract (never serve from doubted state).
                from ..wal.logger import WalError

                try:
                    fresh = self.restart(node)
                except WalError as e:
                    info["failstop"] = f"{type(e).__name__}: {e}"
                    self.failstops.append(
                        {"tick": self.tick, "node": node, "where": "recover",
                         "error": str(e)})
                    self.log.record(ev.at_tick, a, args, **info)
                    return
                self.nodes[node] = fresh
                self.ledger.attach(node, fresh)
                info["recovered_degraded"] = bool(
                    getattr(fresh, "recovered_degraded", False))
            self.crashed.discard(node)
            self._reconnect(node)
            self._mark(node, True)
            nd = self.nodes[node]
            if hasattr(nd, "request_sync"):
                nd.request_sync()
        elif a == "partition":
            sides = [set(s) for s in args["sides"]]
            named = set().union(*sides) - {"__REST__"}
            sides = [({n for n in self.ids if n not in named}
                      if s == {"__REST__"} else s) for s in sides]
            self.net.partition(*sides)
        elif a == "heal":
            self.net.heal()
        elif a == "slow_node":
            self.net.set_slow_node(args["node"],
                                   int(args.get("extra_rounds", 0)))
        elif a == "fsync_stall":
            self.stalled[args["node"]] = int(args.get("ticks", 1))
        elif a == "cut_region":
            info["cut"] = self.net.cut_region(args["region"])
        elif a == "heal_region":
            self.net.heal_region(args["region"])
        elif a == "set_delay":
            self.net.set_delay(args["src"], args["dst"],
                               int(args["rounds"]),
                               both_ways=bool(args.get("both_ways", True)))
        elif a == "drop_pending":
            info["dropped"] = self.net.drop_pending(
                args.get("src"), args.get("dst"))
        elif a == "mark_down":
            self._mark(args["node"], False)
        elif a == "mark_up":
            self._mark(args["node"], True)
        elif a == "bit_flip":
            # damage a CRASHED node's newest journal on disk — what a bad
            # disk does while the process is gone
            from . import faultdisk

            node = args["node"]
            path = args.get("path") or faultdisk.newest_journal(
                self.wal_dirs[node])
            if path is None:
                info["skipped"] = "no journal"
            else:
                info["offset"] = faultdisk.flip_byte(path, args.get("offset"),
                                                     rng=self.rng)
                info["path"] = path
        elif a == "torn_write":
            node = args["node"]
            if node in self.crashed:
                # post-crash view: truncate the dead node's newest journal
                from . import faultdisk

                path = args.get("path") or faultdisk.newest_journal(
                    self.wal_dirs[node])
                if path is None:
                    info["skipped"] = "no journal"
                else:
                    info["dropped"] = faultdisk.tear_tail(
                        path, args.get("drop_bytes"), rng=self.rng)
                    info["path"] = path
            else:
                # live shim: the next append tears mid-frame and the tick
                # loop fail-stops the node
                info["armed"] = bool(self.injector and self.injector.arm(
                    self.wal_dirs[node], "torn_write"))
        elif a == "fsync_error":
            node = args["node"]
            info["armed"] = bool(self.injector and self.injector.arm(
                self.wal_dirs[node], "fsync_error"))
        elif a == "disk_full":
            node = args["node"]
            if args.get("hard"):
                # actual ENOSPC from the write path: fail-stop territory
                info["armed"] = bool(self.injector and self.injector.arm(
                    self.wal_dirs[node], "disk_full"))
            else:
                # low-watermark breach: the node sheds new proposals with a
                # retriable error but keeps serving reads and acked work
                self.nodes[node].wal.shedding = True
        elif a == "disk_ok":
            node = args["node"]
            nd = self.nodes[node]
            if getattr(nd, "wal", None) is not None:
                nd.wal.shedding = False
            if self.injector is not None:
                self.injector.clear(self.wal_dirs[node], "disk_full")
        elif a == "propose":
            node, name = args["node"], args["group"]
            payload = str(args["payload"]).encode()
            done = {"tick": self.tick, "group": name,
                    "payload": args["payload"], "resp": None,
                    "resp_tick": None}
            self.proposals.append(done)

            def cb(_rid, resp, _d=done):
                _d["resp"] = None if resp is None else resp.decode(
                    "utf-8", "replace")
                _d["resp_tick"] = self.tick

            rid = self.nodes[node].propose(name, payload, cb)
            info["rid"] = rid
        self.log.record(ev.at_tick, a, args, **info)

    # ---------------------------------------------------------------- loop
    def run(self, ticks: int,
            on_tick: Optional[Callable[[int], None]] = None) -> ChaosLog:
        """Advance ``ticks`` ticks, applying due events before each one.
        ``on_tick(t)`` (if given) runs after each tick+pump — the hook the
        geo soak uses to timestamp commits."""
        from ..wal.logger import WalError

        for _ in range(ticks):
            while self._pending and self._pending[0].at_tick <= self.tick:
                self._apply(self._pending.pop(0))
            for nid, nd in self.nodes.items():
                if nid in self.crashed:
                    continue
                left = self.stalled.get(nid)
                if left is not None:
                    if left <= 1:
                        del self.stalled[nid]
                    else:
                        self.stalled[nid] = left - 1
                    continue  # tick thread blocked in fsync
                try:
                    nd.tick()
                except WalError as e:
                    # storage fail-stop: the node stops acking and leaves
                    # the cluster, exactly like a crash — except the event
                    # is logged as its own kind for the soak's accounting
                    self.crashed.add(nid)
                    self._isolate(nid)
                    self._mark(nid, False)
                    self.failstops.append(
                        {"tick": self.tick, "node": nid, "where": "tick",
                         "error": f"{type(e).__name__}: {e}"})
                    self.log.record(self.tick, "failstop", {"node": nid},
                                    error=str(e))
            self.net.pump()
            if on_tick is not None:
                on_tick(self.tick)
            self.tick += 1
        return self.log


# -------------------------------------------------------------------- proc
class ProcChaosRunner:
    """Execute a schedule against REAL OS processes.

    ``procs`` maps node id -> a handle with a ``proc`` (``subprocess.
    Popen``) attribute and a ``sigkill()`` method (the ``Worker`` class of
    ``tests/test_modeb_multiprocess.py``).  ``restart`` is a callable
    ``(node_id) -> handle`` used by ``recover``.  ``at_tick`` maps to wall
    clock as ``at_tick * tick_s`` seconds from :meth:`run` start.  Fault
    vocabulary maps to OS primitives: crash → SIGKILL, recover → restart
    from the node's own WAL dir, fsync_stall → SIGSTOP for the scaled
    duration then SIGCONT (a frozen process is indistinguishable from one
    blocked in ``os.fsync``).  Partitions need netfilter and are out of
    scope here — validate() rejects them up front.
    """

    def __init__(self, procs: Dict[str, object], schedule: ChaosSchedule,
                 restart: Optional[Callable[[str], object]] = None,
                 tick_s: float = 0.05,
                 wal_dirs: Optional[Mapping[str, str]] = None,
                 rng=None):
        """``wal_dirs`` (node id -> WAL directory) enables the storage
        actions: bit_flip / torn_write damage a killed worker's journal
        files directly; fsync_error / disk_full drop a ``FAULT.json`` plan
        the worker's journals pick up on their next (re)open — the worker
        must run with ``GPTPU_WAL_FAULTS=1`` for the plan to take effect
        (see testing/faultdisk.wrap_from_env)."""
        schedule.validate(PROC_ACTIONS)
        self.procs = procs
        self.schedule = schedule
        self.restart = restart
        self.tick_s = tick_s
        self.wal_dirs = dict(wal_dirs or {})
        self.rng = rng
        self.log = ChaosLog(schedule)
        self._stopped: Dict[str, float] = {}  # node -> resume deadline

    def _apply(self, ev: ChaosEvent) -> None:
        a, args = ev.action, dict(ev.args)
        info: dict = {}
        if a == "crash":
            h = self.procs[args["node"]]
            # the victim's continuously-persisted flight recorder (obs/
            # flight.py) survives the SIGKILL; thread its artifact path
            # into the chaos log so the soak leaves one postmortem per kill
            fp = getattr(h, "flight_path", None)
            if fp:
                info["flight"] = fp
            h.sigkill()
        elif a == "recover":
            if self.restart is None:
                raise RuntimeError("recover needs a restart factory")
            self.procs[args["node"]] = self.restart(args["node"])
        elif a == "fsync_stall":
            node = args["node"]
            self.procs[node].proc.send_signal(signal.SIGSTOP)
            self._stopped[node] = (time.monotonic()
                                   + int(args.get("ticks", 1)) * self.tick_s)
        elif a == "bit_flip":
            from . import faultdisk

            path = args.get("path") or faultdisk.newest_journal(
                self.wal_dirs[args["node"]])
            if path is None:
                info["skipped"] = "no journal"
            else:
                info["offset"] = faultdisk.flip_byte(path, args.get("offset"),
                                                     rng=self.rng)
                info["path"] = path
        elif a == "torn_write":
            from . import faultdisk

            path = args.get("path") or faultdisk.newest_journal(
                self.wal_dirs[args["node"]])
            if path is None:
                info["skipped"] = "no journal"
            else:
                info["dropped"] = faultdisk.tear_tail(
                    path, args.get("drop_bytes"), rng=self.rng)
                info["path"] = path
        elif a in ("fsync_error", "disk_full"):
            from . import faultdisk

            info["plan"] = faultdisk.write_plan(
                self.wal_dirs[args["node"]],
                {f"{a}_after": int(args.get("after", 0))})
        elif a == "propose":
            h = self.procs[args["node"]]
            h.send(f"propose {args['group']} "
                   f"{str(args['payload']).encode().hex()}")
        self.log.record(ev.at_tick, a, args, **info)

    def run(self) -> ChaosLog:
        pending = sorted(self.schedule.events, key=lambda e: e.at_tick)
        start = time.monotonic()
        while pending or self._stopped:
            now = time.monotonic()
            for node, deadline in list(self._stopped.items()):
                if now >= deadline:
                    del self._stopped[node]
                    try:
                        self.procs[node].proc.send_signal(signal.SIGCONT)
                    except (OSError, ProcessLookupError):
                        pass
            if pending and now - start >= pending[0].at_tick * self.tick_s:
                self._apply(pending.pop(0))
                continue
            time.sleep(min(self.tick_s, 0.05))
        return self.log


# ---------------------------------------------------------- stock schedules
def coordinator_crash(coord: str = "N0", crash_at: int = 30,
                      recover_at: int = 160, detect_after: int = 4,
                      seed: int = 0) -> ChaosSchedule:
    """Kill the initial coordinator, re-elect, then bring it back."""
    return ChaosSchedule("coordinator_crash", [
        ChaosEvent(crash_at, "crash",
                   {"node": coord, "detect_after": detect_after}),
        ChaosEvent(recover_at, "recover", {"node": coord}),
    ], seed=seed)


def region_outage(region: str = "use", cut_at: int = 40,
                  heal_at: int = 220, seed: int = 0) -> ChaosSchedule:
    """Cut a whole geo region (after ``apply_geo``), later heal it."""
    return ChaosSchedule("region_outage", [
        ChaosEvent(cut_at, "cut_region", {"region": region}),
        ChaosEvent(heal_at, "heal_region", {"region": region}),
    ], seed=seed)


def rolling_stall(nodes: Iterable[str], every: int = 40, ticks: int = 12,
                  seed: int = 0) -> ChaosSchedule:
    """WAL-fsync stalls sweep the cluster one node at a time."""
    evs = [ChaosEvent(10 + i * every, "fsync_stall",
                      {"node": n, "ticks": ticks})
           for i, n in enumerate(nodes)]
    return ChaosSchedule("rolling_stall", evs, seed=seed)


def partition_flap(minority: str = "N0", period: int = 50, flaps: int = 3,
                   detect_after: int = 4, seed: int = 0) -> ChaosSchedule:
    """Repeatedly isolate and re-admit one node (asymmetric flapping —
    the classic dueling-coordinator inducer)."""
    evs: List[ChaosEvent] = []
    for i in range(flaps):
        t = 20 + i * period
        evs.append(ChaosEvent(t, "partition",
                              {"sides": [[minority],
                                         ["__REST__"]]}))
        evs.append(ChaosEvent(t + detect_after, "mark_down",
                              {"node": minority}))
        evs.append(ChaosEvent(t + period // 2, "heal", {}))
        evs.append(ChaosEvent(t + period // 2, "mark_up",
                              {"node": minority}))
    return ChaosSchedule("partition_flap", evs, seed=seed)


def ring_crash(entry: str = "N1", victim: str = "N2", crash_at: int = 30,
               recover_at: int = 140, detect_after: int = 4,
               n_writes: int = 12, every: int = 2, group: str = "svc",
               seed: int = 0) -> ChaosSchedule:
    """SIGKILL the ring-upstream relay hop mid-dissemination (ordering/
    dissemination split): writes enter at ``entry`` whose downstream relay
    neighbor is ``victim`` (kernel.ring_downstream order), so slabs in
    flight when the victim dies never reach the third node — it commits
    the ordered rids digest-only and must fill the payloads through the
    undigest path.  S1 must hold throughout and a WAL replay of any
    surviving node must stay bit-identical."""
    evs: List[ChaosEvent] = [
        ChaosEvent(10 + i * every, "propose",
                   {"node": entry, "group": group,
                    "payload": f"PUT rk{i} rv{i}-" + "x" * 512})
        for i in range(n_writes)
    ]
    evs.append(ChaosEvent(crash_at, "crash",
                          {"node": victim, "detect_after": detect_after}))
    evs.append(ChaosEvent(recover_at, "recover", {"node": victim}))
    return ChaosSchedule("ring_crash", evs, seed=seed)
