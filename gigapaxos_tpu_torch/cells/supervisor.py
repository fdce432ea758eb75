"""Cell supervisor: spawn, pin, monitor and restart per-core Paxos cells.

One host runs N serving cells (``cells/worker.py`` processes); the
supervisor owns their lifecycle:

* **spawn** — one worker per cell with pre-allocated FIXED ports (a
  restarted cell rebinds the same endpoints, so peer nodemaps and clients
  never need re-wiring) and its own WAL directories;
* **pinning** — cell k is ``sched_setaffinity``-pinned to core k (workers
  pin themselves; ``CellsConfig.pin_cores`` gates it);
* **health** — the EWMA heartbeat detector (net/failure_detection.py) over
  a local control messenger pings every cell's AR0; process death is
  additionally caught directly by ``poll()`` in the supervision loop —
  the heartbeat covers live-but-wedged cells, the poll covers SIGKILL;
* **restart** — a dead cell is relaunched against the same WAL dirs after
  ``restart_backoff_s`` (capped at ``max_restarts``); WAL replay rebuilds
  its groups, client routing is untouched because the ports are stable;
* **drain** — ``stop()`` SIGTERMs every worker (the in-process handler
  drains the in-flight tick and flushes the WAL before exit), escalating
  to SIGKILL only past ``drain_timeout_s``.

The supervisor also carries the host's routing directory
(:class:`~gigapaxos_tpu_torch.cells.routing.CellRouter`) and builds clients
wired to it (``make_client``), so group->cell resolution needs zero RC hops.

Every cell's planes live on one torch device, CUDA unless the caller passes
``device="cpu"``: the cells of a host share its card.  A worker is a fresh
interpreter (``subprocess`` execs it), never a fork of a process that may
hold a CUDA context.  A worker that cannot start (a CUDA request without a
card, a kernel that does not build) answers ``startup_failed`` and
:meth:`CellSupervisor.start` raises with that line.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config import CellsConfig, GigapaxosTpuConfig, NodeConfig
from ..device import resolve_device
from ..net.failure_detection import FailureDetection
from ..net.messenger import Messenger, NodeMap
from ..obs.http import MetricsServer
from ..obs.metrics import NullRegistry, Registry, metrics_enabled
from ..obs.prom import merge_scrapes, render_registry
from ..utils import reqtrace
from .routing import CellRouter

SUP_ID = "SUP"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclass
class CellSpec:
    """Everything needed to (re)spawn one cell — ports and WAL dirs are
    allocated once, so a restart is exactly a respawn of the same spec."""

    cell: int
    n_cells: int
    actives: Dict[str, list]
    reconfigurators: Dict[str, list]
    peers: Dict[str, list]
    wal_dir: str
    rc_wal_dir: str
    core: Optional[int] = None
    edge: Optional[list] = None
    paxos: Dict[str, object] = field(default_factory=dict)
    cfg: Dict[str, object] = field(default_factory=dict)
    ledger: bool = False
    overrides: Dict[str, int] = field(default_factory=dict)
    drain_timeout_s: float = 10.0
    flight: Optional[str] = None
    stats_interval_s: float = 2.0
    device: str = "cuda"

    def to_json(self) -> str:
        return json.dumps({
            "cell": self.cell, "n_cells": self.n_cells,
            "actives": self.actives,
            "reconfigurators": self.reconfigurators,
            "peers": self.peers,
            "wal_dir": self.wal_dir, "rc_wal_dir": self.rc_wal_dir,
            "core": self.core, "edge": self.edge,
            "paxos": self.paxos, "cfg": self.cfg,
            "ledger": self.ledger, "overrides": self.overrides,
            "drain_timeout_s": self.drain_timeout_s,
            "flight": self.flight,
            "stats_interval_s": self.stats_interval_s,
            "device": self.device,
        })


class CellHandle:
    """One live worker process: line-protocol plumbing plus the ``proc`` /
    ``sigkill()`` surface ``testing.chaos.ProcChaosRunner`` drives."""

    def __init__(self, spec: CellSpec, python: Optional[str] = None):
        self.spec = spec
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.proc = subprocess.Popen(
            [python or sys.executable, "-m",
             "gigapaxos_tpu_torch.cells.worker", spec.to_json()],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env,
        )
        self.lines: "queue.Queue[str]" = queue.Queue()
        self._eof = threading.Event()
        threading.Thread(target=self._read, daemon=True,
                         name=f"cell{spec.cell}-out").start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.strip())
        self._eof.set()

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def expect(self, prefix: str, timeout: float = 60.0) -> str:
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"cell {self.spec.cell}: no '{prefix}' line")
            try:
                line = self.lines.get(timeout=min(left, 0.5))
            except queue.Empty:
                if self._eof.is_set() and self.lines.empty():
                    raise RuntimeError(
                        f"cell {self.spec.cell}: worker exited (code "
                        f"{self.proc.wait()}) before a '{prefix}' line")
                continue
            if line.startswith(prefix):
                return line
            if line.startswith("startup_failed"):
                raise RuntimeError(f"cell {self.spec.cell}: {line}")

    def rpc(self, cmd: str, prefix: str, timeout: float = 60.0) -> str:
        self.send(cmd)
        return self.expect(prefix, timeout)

    def db(self, r: int = 0, timeout: float = 30.0) -> dict:
        return json.loads(self.rpc(f"db {r}", "db ", timeout)[3:])

    def ledger(self, timeout: float = 30.0) -> list:
        return json.loads(self.rpc("ledger", "ledger ", timeout)[7:])

    def stats(self, timeout: float = 30.0) -> dict:
        return json.loads(self.rpc("stats", "stats ", timeout)[6:])

    def healthz(self, timeout: float = 30.0) -> dict:
        return json.loads(self.rpc("healthz", "healthz ", timeout)[8:])

    def health(self, timeout: float = 30.0):
        return json.loads(self.rpc("health", "health ", timeout)[7:])

    def group(self, name: str, timeout: float = 30.0):
        return json.loads(self.rpc(f"group {name}", "group ", timeout)[6:])

    def timeline(self, timeout: float = 30.0) -> dict:
        return json.loads(self.rpc("timeline", "timeline ", timeout)[9:])

    def metrics(self, timeout: float = 30.0) -> str:
        """This cell's Prometheus text body (every series cell-labelled)."""
        return json.loads(self.rpc("metrics", "metrics ", timeout)[8:])

    def trace(self, tid: Optional[str] = None, timeout: float = 30.0) -> dict:
        cmd = "trace" if tid is None else f"trace {tid}"
        return json.loads(self.rpc(cmd, "trace ", timeout)[6:])

    @property
    def flight_path(self) -> Optional[str]:
        """On-disk flight-recorder artifact (postmortem after a SIGKILL)."""
        return self.spec.flight

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self, timeout: float = 15.0) -> None:
        """Graceful stop: SIGTERM (the worker drains + flushes), SIGKILL
        only past the deadline."""
        if not self.alive():
            return
        try:
            self.proc.send_signal(signal.SIGTERM)
            self.proc.wait(timeout=timeout)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()


class CellSupervisor:
    """Spawn and babysit ``n_cells`` serving cells on this host."""

    def __init__(
        self,
        base_dir: str,
        cells: Optional[CellsConfig] = None,
        n_actives: Optional[int] = None,
        n_reconfigurators: Optional[int] = None,
        paxos_overrides: Optional[dict] = None,
        cfg_overrides: Optional[dict] = None,
        ledger: bool = False,
        edge: bool = False,
        python: Optional[str] = None,
        ready_timeout_s: float = 600.0,
        http_port: Optional[int] = None,
        trace_wire: Optional[bool] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cc = cells or CellsConfig(enabled=True)
        self.n_cells = self.cc.n_cells or max(1, (os.cpu_count() or 2) - 1)
        self.base_dir = base_dir
        self.python = python
        self.ready_timeout_s = ready_timeout_s
        n_ar = n_actives or self.cc.n_actives
        n_rc = n_reconfigurators or self.cc.n_reconfigurators
        self.restarts: Dict[int, int] = {k: 0 for k in range(self.n_cells)}
        self.fd_events: List[tuple] = []
        self._stopping = False

        # ---- fixed endpoint plan: every node of every cell, up front
        actives_by_cell: Dict[int, List[str]] = {}
        rcs_by_cell: Dict[int, List[str]] = {}
        addr: Dict[str, list] = {}
        for k in range(self.n_cells):
            actives_by_cell[k] = [f"c{k}.AR{i}" for i in range(n_ar)]
            rcs_by_cell[k] = [f"c{k}.RC{i}" for i in range(n_rc)]
            for nid in actives_by_cell[k] + rcs_by_cell[k]:
                addr[nid] = ["127.0.0.1", free_port()]
        self.addr = addr
        self.router = CellRouter(
            [actives_by_cell[k] for k in range(self.n_cells)],
            [rcs_by_cell[k] for k in range(self.n_cells)],
        )
        edge_port = (self.cc.edge_port or free_port()) if edge else None
        self.edge_addr = (["127.0.0.1", edge_port]
                          if edge_port is not None else None)

        # ---- control endpoint + heartbeats over it
        self._nodemap = NodeMap()
        for nid, (h, p) in addr.items():
            self._nodemap.add(nid, h, int(p))
        self.m = Messenger(SUP_ID, ("127.0.0.1", 0), self._nodemap)
        self.fd = FailureDetection(
            self.m, monitored=(),
            ping_interval_s=self.cc.heartbeat_interval_s,
            timeout_s=self.cc.heartbeat_timeout_s,
            on_change=self._on_fd_change,
        )

        # ---- per-cell specs
        self.specs: Dict[int, CellSpec] = {}
        for k in range(self.n_cells):
            own = set(actives_by_cell[k] + rcs_by_cell[k])
            peers = {n: a for n, a in addr.items() if n not in own}
            peers[SUP_ID] = ["127.0.0.1", self.m.port]
            self.specs[k] = CellSpec(
                cell=k, n_cells=self.n_cells,
                actives={n: addr[n] for n in actives_by_cell[k]},
                reconfigurators={n: addr[n] for n in rcs_by_cell[k]},
                peers=peers,
                wal_dir=os.path.join(base_dir, f"c{k}", "ar"),
                rc_wal_dir=os.path.join(base_dir, f"c{k}", "rc"),
                core=(k % (os.cpu_count() or 1)
                      if self.cc.pin_cores else None),
                edge=self.edge_addr,
                paxos=dict(paxos_overrides or {}),
                cfg=dict(cfg_overrides or {}),
                ledger=ledger,
                drain_timeout_s=self.cc.drain_timeout_s,
                flight=os.path.join(base_dir, f"c{k}", "flight.json"),
                device=str(self.device),
            )
        self.cells: Dict[int, CellHandle] = {}
        self._thread: Optional[threading.Thread] = None

        # ---- supervisor-side flight-deck gauges: a private registry (the
        # supervisor may share a process with tests/clients — its series
        # must not leak into theirs), same compile-out switch as everything
        self._reg: Registry = (Registry() if metrics_enabled()
                               else NullRegistry())
        self._g_up = {k: self._reg.gauge(
            "cell_up", help="1 if the cell's current incarnation is alive",
            cell=str(k)) for k in range(self.n_cells)}
        self._g_restarts = {k: self._reg.gauge(
            "cell_restarts_total", help="supervisor-initiated respawns",
            cell=str(k)) for k in range(self.n_cells)}
        self._g_core = {k: self._reg.gauge(
            "cell_core_pin", help="pinned CPU core (-1 when unpinned)",
            cell=str(k)) for k in range(self.n_cells)}
        for k in range(self.n_cells):
            core = self.specs[k].core
            self._g_core[k].set(-1 if core is None else int(core))
        self._reg.gauge(
            "supervisor_restart_backoff_seconds",
            help="respawn backoff between death and relaunch",
        ).set(float(self.cc.restart_backoff_s))
        self._reg.gauge(
            "supervisor_heartbeat_timeout_seconds",
            help="EWMA failure-detector timeout over the control messenger",
        ).set(float(self.cc.heartbeat_timeout_s))
        self._g_fd_down = self._reg.gauge(
            "supervisor_fd_down_events_total",
            help="heartbeat down-verdicts observed (fd timeouts)")
        self.metrics_server: Optional[MetricsServer] = None
        self._http_port = http_port
        self._trace_wire = trace_wire
        # supervisor-side timeline: events only (cell deaths, respawns, fd
        # verdicts) — unstarted sampler thread; the per-cell series come
        # from each worker's own recorder and merge in timeline()
        from ..obs.timeline import TimelineRecorder

        self.timeline_rec = TimelineRecorder(
            lambda: {}, node=SUP_ID)

    # ---------------------------------------------------------------- spawn
    def start(self) -> "CellSupervisor":
        try:
            for k in range(self.n_cells):
                self.cells[k] = CellHandle(self.specs[k], python=self.python)
            for k, h in self.cells.items():
                h.expect("ready", timeout=self.ready_timeout_s)
                self.fd.monitor(sorted(self.specs[k].actives)[0])
        except BaseException:
            # one cell that cannot start fails the host: stop the others
            self.stop()
            raise
        self._thread = threading.Thread(
            target=self._supervise, name="cell-supervisor", daemon=True)
        self._thread.start()
        if self._http_port is not None and self._http_port >= 0:
            self.metrics_server = MetricsServer(
                self.scrape, trace=self._trace_route,
                healthz=self.healthz, health=self.health,
                group=self.group_info, timeline=self.timeline,
                port=self._http_port)
        return self

    def _on_fd_change(self, node: str, up: bool) -> None:
        # heartbeat verdicts are advisory alongside the poll() watchdog: a
        # live-but-wedged cell surfaces here for operators/tests; actual
        # respawn keys off process death (deterministic under chaos)
        self.fd_events.append((time.monotonic(), node, up))
        self.timeline_rec.annotate("fd_change", target=node, up=up)
        if not up:
            self._g_fd_down.inc()

    def _supervise(self) -> None:
        backoff = max(self.cc.restart_backoff_s, 0.05)
        while not self._stopping:
            time.sleep(backoff / 2)
            for k, h in list(self.cells.items()):
                if self._stopping or h.alive():
                    continue
                if self.restarts[k] >= self.cc.max_restarts:
                    continue  # crash-looping cell: leave it down
                self.restarts[k] += 1
                self._g_restarts[k].set(self.restarts[k])
                self.timeline_rec.annotate("cell_death", cell=k,
                                           restarts=self.restarts[k])
                time.sleep(backoff)
                if self._stopping:
                    return
                try:
                    nh = CellHandle(self.specs[k], python=self.python)
                    nh.expect("ready", timeout=self.ready_timeout_s)
                    self.cells[k] = nh
                    self.timeline_rec.annotate("cell_restart", cell=k)
                except Exception:
                    continue  # next sweep retries, counted above

    def wait_cell_alive(self, k: int, timeout: float = 600.0) -> CellHandle:
        """Block until cell k's CURRENT incarnation is live (post-crash:
        until the supervision loop finished the respawn)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            h = self.cells.get(k)
            if h is not None and h.alive():
                return h
            time.sleep(0.05)
        raise TimeoutError(f"cell {k} not restarted in {timeout}s")

    # -------------------------------------------------------------- routing
    def merged_nodes(self) -> NodeConfig:
        """One NodeConfig spanning every cell's endpoints (clients resolve
        any cell's nodes by id)."""
        nc = NodeConfig()
        for k in range(self.n_cells):
            for n in self.router.actives_by_cell[k]:
                nc.actives[n] = tuple(self.addr[n])
            for n in self.router.rcs_by_cell[k]:
                nc.reconfigurators[n] = tuple(self.addr[n])
        return nc

    def make_client(self, **kw):
        from .. import client as client_mod

        if self._trace_wire is not None:
            kw.setdefault("trace_wire", self._trace_wire)
        return client_mod.ReconfigurableAppClient(
            self.merged_nodes(), placement_table=self.router, **kw)

    def broadcast_override(self, name: str, cell: int) -> None:
        """Install a migrated name's new owner everywhere: the router (for
        clients built from it) and every live worker's edge directory."""
        self.router.set_override(name, cell)
        for h in self.cells.values():
            if h.alive():
                try:
                    h.rpc(f"override {name} {cell}", "override_ok", 10)
                except Exception:
                    pass  # a dead cell re-learns via its restart spec

    # ------------------------------------------------------------ flight deck
    def scrape(self) -> str:
        """One host-level Prometheus body: supervisor gauges plus every
        live cell's export (each worker renders its own registry with a
        ``cell="k"`` label over the control socket), merged with HELP/TYPE
        metadata deduplicated.  Dead/backing-off cells are simply absent —
        their ``cell_up`` gauge says why."""
        bodies = []
        for k, h in sorted(self.cells.items()):
            up = h.alive()
            self._g_up[k].set(1 if up else 0)
            if not up:
                continue
            try:
                bodies.append(h.metrics(timeout=15))
            except Exception:
                self._g_up[k].set(0)  # died mid-scrape
        sup = render_registry(self._reg, extra_labels={"node": SUP_ID})
        return merge_scrapes([sup] + bodies)

    def trace(self, tid: Optional[str] = None) -> dict:
        """Cross-process timeline merge: this process's shared-namespace
        store (the client side usually lives here) plus every live cell's
        dump.  Hop clocks are per-process monotonic — entries keep their
        origin so consumers don't compare timestamps across processes."""
        merged: Dict[str, list] = {}

        def fold(origin: str, dump: dict) -> None:
            for rid, evs in dump.items():
                if tid is not None and rid != str(tid):
                    continue
                merged.setdefault(rid, []).extend(
                    [[origin] + list(ev) for ev in evs])

        fold(SUP_ID, reqtrace.dump_ns())
        for k, h in sorted(self.cells.items()):
            if not h.alive():
                continue
            try:
                fold(f"c{k}", h.trace(tid, timeout=15))
            except Exception:
                pass  # a cell dying mid-dump only narrows the timeline
        return merged

    def _trace_route(self, tid: Optional[str]) -> dict:
        # /trace -> recent ids; /trace/<tid> -> one merged timeline
        return self.trace(tid)

    # ------------------------------------------------------------ health plane
    def _replay_sidecar(self, k: int) -> Optional[dict]:
        """A cell mid-WAL-replay is single-threaded inside recovery and
        cannot answer the healthz RPC — but the replay publishes a
        ``replay_progress.json`` sidecar next to its journals.
        A fresh, unfinished sidecar distinguishes "long replay" from
        "hung cell"."""
        spec = self.specs.get(k)
        if spec is None:
            return None
        best = None
        for d in (spec.wal_dir, spec.rc_wal_dir):
            try:
                with open(os.path.join(d, "replay_progress.json")) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if doc.get("phase") == "done":
                continue
            if time.time() - float(doc.get("ts", 0)) > 15.0:
                continue  # stale: a replay that died mid-flight
            if best is None or doc.get("ts", 0) > best.get("ts", 0):
                best = doc
        return best

    def healthz(self) -> dict:
        """Host-level readiness: 200 only when every cell's current
        incarnation is up AND answers ok (not draining, WAL healthy) —
        the body names the cell that isn't.  A cell that is alive but
        still replaying its WAL reports ``recovering`` with progress
        read from the replay sidecar rather than a bare ``up: False``."""
        cells = {}
        ok = not self._stopping
        for k, h in sorted(self.cells.items()):
            doc = {"up": h.alive()}
            if doc["up"]:
                try:
                    doc.update(h.healthz(timeout=10))
                except Exception:
                    rep = self._replay_sidecar(k)
                    if rep is not None:
                        doc["recovering"] = True
                        tot = max(1, int(rep.get("records_total", 0)))
                        doc["wal_replay_progress"] = (
                            int(rep.get("records_done", 0)) / tot)
                        doc["replay"] = rep
                    else:
                        doc["up"] = False
            cells[str(k)] = doc
            if not (doc["up"] and doc.get("ok", False)):
                ok = False
        return {"ok": ok, "cells": cells}

    def health(self) -> Optional[dict]:
        """Merged group-health summary across cells (the `/health` body):
        counts sum, maxima max, top-K lists re-rank with a cell tag.
        None (404) when no cell runs the health fold."""
        docs = []
        for k, h in sorted(self.cells.items()):
            if not h.alive():
                continue
            try:
                d = h.health(timeout=15)
            except Exception:
                continue
            if d:
                d["cell"] = k
                docs.append(d)
        if not docs:
            return None
        merged = {
            "cells": {str(d["cell"]): d.get("clock", 0) for d in docs},
            "allocated": sum(d.get("allocated", 0) for d in docs),
            "backlogged": sum(d.get("backlogged", 0) for d in docs),
            "wedged": sum(d.get("wedged", 0) for d in docs),
            "max_stall_ticks": max(d.get("max_stall_ticks", 0)
                                   for d in docs),
            "max_churn": max(d.get("max_churn", 0) for d in docs),
            "wedge_ticks": max(d.get("wedge_ticks", 0) for d in docs),
        }
        for key in ("top_stuck", "top_churny", "top_hot"):
            # per-cell lists are already K-bounded; re-rank the union so
            # the host view is the top n_cells*K with cell provenance
            rows = [dict(e, cell=d["cell"])
                    for d in docs for e in d.get(key, [])]
            rows.sort(key=lambda e: -e["value"])
            merged[key] = rows
        hists = [d for d in docs if "hist_stall" in d]
        if hists:
            merged["hist_stall"] = [
                sum(h["hist_stall"][i] for h in hists)
                for i in range(len(hists[0]["hist_stall"]))]
        return merged

    def group_info(self, name: str) -> Optional[dict]:
        """Resolve ``name`` to its owner cell (override map first, static
        hash second — the same directory the edge uses) and drill down
        there; the answer is tagged with the owning cell."""
        k = self.router.cell(name)
        h = self.cells.get(k)
        if h is None or not h.alive():
            return {"name": name, "cell": k, "error": "cell down"}
        try:
            doc = h.group(name, timeout=15)
        except Exception as e:
            return {"name": name, "cell": k,
                    "error": f"{type(e).__name__}: {e}"}
        if doc is None:
            return None
        doc["cell"] = k
        return doc

    def timeline(self) -> dict:
        """Merged scenario timeline (the `/timeline` body): every live
        cell's sampled series plus this supervisor's lifecycle events
        (cell deaths, respawns, fd verdicts) on one wall clock."""
        from ..obs.timeline import merge_timelines

        snaps = [self.timeline_rec.snapshot()]
        for k, h in sorted(self.cells.items()):
            if not h.alive():
                continue
            try:
                snaps.append(h.timeline(timeout=15))
            except Exception:
                pass  # a cell dying mid-dump only narrows the timeline
        return merge_timelines(snaps)

    # ----------------------------------------------------------------- stop
    def stop(self) -> None:
        self._stopping = True
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
        for h in self.cells.values():
            h.terminate(timeout=self.cc.drain_timeout_s + 5)
        self.fd.close()
        self.m.close()

    def __enter__(self) -> "CellSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def build_supervisor(cfg: GigapaxosTpuConfig, base_dir: str,
                     **kw) -> CellSupervisor:
    """Config-driven constructor (server.py ``--cells`` bootstrap): the
    ``cfg.cells`` section sizes and tunes the plane; ``cfg.obs`` wires the
    host-level scrape endpoint."""
    obs = getattr(cfg, "obs", None)
    if obs is not None and obs.sup_http_port >= 0:
        kw.setdefault("http_port", obs.sup_http_port)
    if obs is not None and obs.trace_wire:
        kw.setdefault("trace_wire", True)
    return CellSupervisor(base_dir, cells=cfg.cells, **kw)
