"""Serving-cell worker process: one crash-isolated Mode A cluster per core.

A cell is a full :class:`~gigapaxos_tpu_torch.node.InProcessCluster`
(dense-device data plane + RC plane) running in its own OS process, pinned
to one CPU core, owning a static shard of the group space
(``routing.cell_of``), with its own WAL directories and transport
endpoints.  Its planes live on the spec's ``device`` (default ``"cuda"``:
every cell of a host shares the card); a CUDA request on a host without a
card fails the startup, as any other construction error does.  The
process is spawned and supervised by
:class:`~gigapaxos_tpu_torch.cells.supervisor.CellSupervisor`; node
ids are cell-qualified (``c{k}.AR0``, ``c{k}.RC0``) so every cell's
endpoints coexist in one merged NodeConfig for clients.

Spawned as ``python -m gigapaxos_tpu_torch.cells.worker '<spec json>'``
with::

  {"cell": 0, "n_cells": 2,
   "actives": {"c0.AR0": ["127.0.0.1", p]},        # THIS cell's nodes only
   "reconfigurators": {"c0.RC0": ["127.0.0.1", p]},
   "peers": {"c1.AR0": [...], "SUP": [...]},       # other cells + supervisor
   "wal_dir": "...", "rc_wal_dir": "...",
   "core": 0,                                       # sched_setaffinity pin
   "device": "cuda",                                # torch device (or "cpu")
   "edge": ["127.0.0.1", p],                        # SO_REUSEPORT shared edge
   "overrides": {"name": 1},                        # migrated-name directory
   "paxos": {"max_groups": 16},                     # cfg.paxos attr overrides
   "cfg": {"native_journal": true},                 # top-level cfg overrides
   "ledger": true,                                  # record (r,name,slot,rid)
   "flight": ".../flight.json",                     # crash recorder artifact
   "stats_interval_s": 2.0,                         # StatsReporter cadence
   "drain_timeout_s": 10.0}

Line protocol on stdin/stdout (the Mode B worker's idiom, extended):

  create <name>                 -> "created <name>" (direct local create)
  propose <name> <hex>          -> (async) "resp <rid> <hex|NONE>"
  db [r]                        -> "db <json>" (replica r's app state)
  stats                         -> "stats <json>" (with this process's
                                    kernel launch counts under "launches")
  metrics                       -> "metrics <json>" (Prometheus text body,
                                    every series labelled cell="k")
  trace [tid]                   -> "trace <json>" (cross-process trace dump)
  flight                        -> "flight <path>" (force a recorder dump)
  ledger                        -> "ledger <json>" (execution observations)
  drain                         -> "drained ok|timeout"
  override <name> <cell>        -> "override_ok <name>" (edge routing)
  migrate_out <name>            -> "migrated_out <name> <epoch> <hex>"
  migrate_in <name> <ep> <hex>  -> "migrated_in <name> <ep>"
  migrate_drop <name> <ep>      -> "migrate_dropped <name>"
  exit                          -> graceful shutdown, process exits

SIGTERM triggers the graceful path (drain in-flight tick, flush + close
WAL, close transports); SIGKILL emulates a core crash — the supervisor
restarts the cell against the same WAL dirs and replay rebuilds it.
"""

import json
import os
import sys
import threading
import time

# --------------------------------------------------------------- S1 ledger
#: execution observations [r, name, slot, rid, is_stop] — appended by the
#: class-level `_execute_one` wrap BELOW the WAL replay, so a restarted
#: worker's ledger covers replayed history too (tests feed pre-kill and
#: post-restart dumps into testing.chaos.SafetyLedger and assert no
#: (name, slot) ever decided two rids across the crash)
_LEDGER: list = []
_LEDGER_LOCK = threading.Lock()


def _install_ledger() -> None:
    from gigapaxos_tpu_torch.paxos import manager as mgr_mod

    orig = mgr_mod.PaxosManager._execute_one

    def _observed(self, r, row, name, rid, slot, is_stop):
        with _LEDGER_LOCK:
            _LEDGER.append([int(r), str(name), int(slot), int(rid),
                            bool(is_stop)])
        return orig(self, r, row, name, rid, slot, is_stop)

    mgr_mod.PaxosManager._execute_one = _observed


def _pin_core(core) -> None:
    """Pin this process to ``core``, then size torch's intra-op pool to
    the cores it may run on (else every worker starts a pool as wide as
    the host)."""
    import torch

    if core is not None and hasattr(os, "sched_setaffinity"):
        try:
            ncpu = os.cpu_count() or 1
            os.sched_setaffinity(0, {int(core) % ncpu})
        except OSError:
            pass  # cgroup-restricted masks: run unpinned rather than die
    if hasattr(os, "sched_getaffinity"):
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))))


def main() -> None:
    spec = json.loads(sys.argv[1])
    cell = int(spec["cell"])
    n_cells = int(spec.get("n_cells", 1))
    _pin_core(spec.get("core"))
    if spec.get("ledger"):
        _install_ledger()

    from gigapaxos_tpu_torch import overload as _overload
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.net.failure_detection import FailureDetection
    from gigapaxos_tpu_torch.net.messenger import Messenger
    from gigapaxos_tpu_torch.node import InProcessCluster
    from gigapaxos_tpu_torch.obs.metrics import registry as obs_registry
    from gigapaxos_tpu_torch.obs.flight import FlightRecorder
    from gigapaxos_tpu_torch.obs.prom import render_registry
    from gigapaxos_tpu_torch.ops import plane_gather
    from gigapaxos_tpu_torch.reconfiguration import packets as pkt
    from gigapaxos_tpu_torch.utils import reqtrace
    from gigapaxos_tpu_torch.utils.observability import (
        StatsReporter, node_stats_source, shard_load_source,
        transport_stats_source)

    from .routing import cell_of

    cfg = GigapaxosTpuConfig()
    for k, v in (spec.get("paxos") or {}).items():
        setattr(cfg.paxos, k, v)
    for k, v in (spec.get("cfg") or {}).items():
        setattr(cfg, k, v)
    cfg.nodes.actives = {n: tuple(a) for n, a in spec["actives"].items()}
    cfg.nodes.reconfigurators = {
        n: tuple(a) for n, a in spec["reconfigurators"].items()
    }

    out_lock = threading.Lock()

    def emit(line: str) -> None:
        with out_lock:
            sys.stdout.write(line + "\n")
            sys.stdout.flush()

    # a restart against a WAL directory that already holds state replays
    # before serving: note it so the timeline shows the recovery span and
    # healthz can report how much history was rolled forward
    def _has_state(d: str) -> bool:
        return os.path.isdir(d) and any(
            fn.startswith(("journal.", "snapshot.")) for fn in os.listdir(d))

    recovering = _has_state(spec["wal_dir"]) or _has_state(spec["rc_wal_dir"])
    recovery_t0 = time.time()
    try:
        device = spec.get("device", "cuda")
        if str(device).startswith("cuda"):
            # build (or load) the tick's kernels here, so that a failed
            # build is a startup failure and not a dead tick thread
            plane_gather._lib()
        cluster = InProcessCluster(
            cfg, KVApp,
            replicas_per_name=len(cfg.nodes.actives),
            rc_group_size=len(cfg.nodes.reconfigurators),
            wal_dir=spec["wal_dir"],
            rc_wal_dir=spec["rc_wal_dir"],
            device=device,
        )
        for d in (cluster.driver, cluster.rc_driver):
            if not d.wait_ready(0) or not d._thread.is_alive():
                raise RuntimeError("a tick driver stopped before serving")
    except Exception as e:  # startup must be observable, not a silent death
        emit(f"startup_failed {type(e).__name__}: {e}")
        sys.exit(1)
    recovery_t1 = time.time()

    # other cells' endpoints + the supervisor: reachable for edge forwarding
    # and control pings, but NOT part of this cell's consensus topology
    for nid, (host, port) in (spec.get("peers") or {}).items():
        cluster.nodemap.add(nid, host, int(port))

    active_ids = sorted(cluster.actives)
    ar0 = cluster.actives[active_ids[0]]
    # answering the supervisor's EWMA heartbeats only needs the PING handler
    # a (non-monitoring) detector registers on AR0's messenger
    fd = FailureDetection(ar0.m, monitored=())

    # ------------------------------------------------- flight deck
    # crash flight recorder: a SIGKILL'd cell leaves its last ring of
    # stats snapshots and events on disk for the supervisor/chaos log
    flight_path = spec.get("flight") or os.path.join(
        os.path.dirname(spec["wal_dir"]), "flight.json")
    flight = FlightRecorder(flight_path, cap=cfg.obs.flight_cap,
                            node=f"c{cell}")
    flight.install_signal()      # SIGUSR2 -> on-demand dump
    flight.install_excepthook()  # crash-by-exception -> dump
    flight.record("boot", cell=cell, pid=os.getpid(),
                  core=spec.get("core"))

    # storage fail-stop: a WalFailedError/WalQuarantinedError escaping a
    # tick loop means the WAL can no longer make acks durable — dump the
    # flight ring and die nonzero so the supervisor restarts this cell
    # onto intact storage (replay re-derives state from what DID reach
    # disk; anything unacked is the client's retry)
    from gigapaxos_tpu_torch.paxos import driver as _tick_driver_mod

    def _wal_failstop(exc: BaseException) -> None:
        flight.record("wal_failstop", error=f"{type(exc).__name__}: {exc}")
        flight.dump("wal_failstop")
        emit(f"wal_failstop {type(exc).__name__}: {exc}")
        os._exit(3)

    _tick_driver_mod.FATAL_HANDLER = _wal_failstop
    # group-health transitions (newly wedged/recovered, top-K churn) land
    # in the same ring — a SIGKILL'd cell's dump names its sick groups
    cluster.manager.flight = flight
    reporter = StatsReporter(
        f"c{cell}", interval_s=float(spec.get("stats_interval_s", 2.0)),
        sink=flight.snapshot_sink)
    reporter.add_source("ar", node_stats_source(cluster.manager))
    reporter.add_source("rc", node_stats_source(cluster.rc_manager))
    reporter.add_source("transport", transport_stats_source(ar0.m.transport))
    reporter.add_source("shards", shard_load_source(cluster.manager))
    reporter.start()

    # scenario timeline: sampled metric series vs wall clock, with event
    # annotations; the supervisor merges every cell's snapshot into one
    # host-level /timeline body
    from gigapaxos_tpu_torch.obs.timeline import (TimelineRecorder,
                                                  registry_sampler)

    timeline = TimelineRecorder(
        registry_sampler(
            "health_backlogged_groups", "health_wedged_groups",
            "overload_admission_shed_total", "overload_expired_drops_total",
            "reads_local_total", "tick_seconds"),
        interval_s=float(spec.get("timeline_interval_s", 0.25)),
        node=f"c{cell}")
    timeline.start()
    timeline.annotate("boot", cell=cell, pid=os.getpid())
    if recovering:
        # the replay ran before the recorder existed; the annotations carry
        # their own wall times so the span still renders correctly
        rep = obs_registry().gauge("wal_replay_records_done").value
        timeline.annotate("recovery_start", cell=cell, at=recovery_t0)
        timeline.annotate("recovery_finish", cell=cell, at=recovery_t1,
                          seconds=recovery_t1 - recovery_t0,
                          records=int(rep))
    # readiness state for the healthz command (503 while draining or after
    # a sticky WAL failure — supervisors stop routing, diagnostics stay up)
    ready_state = {"draining": False}

    def _healthz_doc() -> dict:
        wal_failed = any(
            getattr(getattr(p, "wal", None), "failed", False)
            for p in (cluster.manager, cluster.rc_manager))
        return {
            "ok": not ready_state["draining"] and not wal_failed,
            "cell": cell,
            "tick": int(cluster.manager.tick_num),
            "draining": ready_state["draining"],
            "wal_failed": wal_failed,
            # a worker answering this RPC is past replay by construction;
            # mid-replay the supervisor reads the replay_progress.json
            # sidecar instead and reports recovering=True for the cell
            "recovering": False,
            "wal_replay_progress": float(
                obs_registry().gauge("wal_replay_progress").value),
        }

    # migrated-name directory for edge routing, updated by `override` lines
    overrides: dict = {str(k): int(v)
                       for k, v in (spec.get("overrides") or {}).items()}

    # ------------------------------------------------- SO_REUSEPORT edge
    # every cell binds the SAME edge port; the kernel spreads incoming
    # client connections across cells, and a mis-routed first request is
    # forwarded to its owner cell, which answers the client directly
    # (reply_to + client_addr registration — zero extra hop once cached)
    edge_m = None
    if spec.get("edge"):
        host, port = spec["edge"]
        edge_m = Messenger(f"c{cell}.EDGE", (host, int(port)),
                           cluster.nodemap, reuse_port=True)

        xt = reqtrace.xtracer()

        def on_edge_request(sender: str, p: dict) -> None:
            name = p.get("name", "")
            if _overload.expired(p.get("deadline")):
                # dead on arrival at the edge: don't burn a cross-cell
                # forward (or an owner-cell propose) on abandoned work
                _overload.count_expired("edge_forward", f"c{cell}")
                return
            owner = overrides.get(name)
            if owner is None:
                owner = cell_of(name, n_cells)
            p.setdefault("reply_to", p.get("sender") or sender)
            if owner == cell:
                ar0._on_app_request(sender, p)
            else:
                tid = p.get("trace")
                if tid is not None:
                    xt.event(tid, "edge_forward", src=cell, dst=owner,
                             name=name)
                edge_m.send(f"c{owner}.AR0", p, cls=_overload.CLS_CLIENT)

        edge_m.register(pkt.APP_REQUEST, on_edge_request)

    cluster.install_sigterm(
        drain_timeout_s=float(spec.get("drain_timeout_s", 10.0)),
        on_exit=(edge_m.close if edge_m is not None else None),
    )
    emit("ready")

    m = cluster.manager
    coord = cluster.coordinator

    def pump() -> None:
        cluster.kick()
        time.sleep(0.002)

    for line in sys.stdin:
        parts = line.strip().split(" ")
        if not parts or not parts[0]:
            continue
        cmd = parts[0]
        try:
            if cmd == "create":
                coord.create_replica_group(parts[1], 0, b"", active_ids)
                emit(f"created {parts[1]}")
            elif cmd == "propose":
                name, payload = parts[1], bytes.fromhex(parts[2])
                epoch = coord.current_epoch(name)
                if epoch is None:
                    emit(f"err propose no_epoch:{name}")
                    continue

                def cb(rid, resp):
                    emit("resp %s %s" % (
                        rid, resp.hex() if resp is not None else "NONE"))

                if coord.coordinate_request(name, epoch, payload, cb) is None:
                    emit(f"err propose rejected:{name}")
                cluster.kick()
            elif cmd == "db":
                r = int(parts[1]) if len(parts) > 1 else 0
                emit("db " + json.dumps(m.apps[r].db, sort_keys=True))
            elif cmd == "stats":
                # both planes' locks: no tick is half counted, so the
                # launch counts and the tick numbers are of one moment
                with m.lock, cluster.rc_manager.lock:
                    doc = {
                        "pid": os.getpid(), "cell": cell,
                        "tick": int(m.tick_num),
                        "rc_tick": int(cluster.rc_manager.tick_num),
                        "groups": len(list(m.rows.names())),
                        "overrides": dict(overrides),
                        "launches": dict(plane_gather.launches),
                    }
                emit("stats " + json.dumps(doc, sort_keys=True))
            elif cmd == "metrics":
                # per-cell export for the supervisor's host-level scrape:
                # every series this process owns, labelled with its cell
                body = render_registry(obs_registry(),
                                       extra_labels={"cell": str(cell)})
                emit("metrics " + json.dumps(body))
            elif cmd == "trace":
                if len(parts) > 1:
                    tid = parts[1]
                    dump = {k: v for k, v in reqtrace.dump_ns().items()
                            if k == tid}
                else:
                    dump = reqtrace.dump_ns()
                emit("trace " + json.dumps(dump))
            elif cmd == "flight":
                emit("flight " + flight.dump("rpc"))
            elif cmd == "healthz":
                emit("healthz " + json.dumps(_healthz_doc(),
                                             sort_keys=True))
            elif cmd == "health":
                emit("health " + json.dumps(m.health_snapshot()))
            elif cmd == "group":
                emit("group " + json.dumps(m.group_info(parts[1])))
            elif cmd == "timeline":
                emit("timeline " + json.dumps(timeline.snapshot()))
            elif cmd == "ledger":
                with _LEDGER_LOCK:
                    emit("ledger " + json.dumps(_LEDGER))
            elif cmd == "drain":
                ready_state["draining"] = True
                timeline.annotate("drain", cell=cell)
                ok = cluster.drain(float(spec.get("drain_timeout_s", 10.0)))
                emit("drained " + ("ok" if ok else "timeout"))
            elif cmd == "override":
                name, dst = parts[1], int(parts[2])
                if dst == cell:
                    overrides.pop(name, None)
                else:
                    overrides[name] = dst
                emit(f"override_ok {name}")
            elif cmd == "migrate_out":
                name = parts[1]
                epoch = coord.current_epoch(name)
                if epoch is None:
                    emit(f"migrate_err {name} no_epoch")
                    continue
                coord.stop_replica_group(name, epoch, lambda ok: None)
                blob, ticks = coord.get_final_state(name, epoch), 0
                while blob is None and ticks < 1024:
                    pump()
                    ticks += 1
                    blob = coord.get_final_state(name, epoch)
                if blob is None:
                    emit(f"migrate_err {name} drain_timeout")
                else:
                    timeline.annotate("migrate_out", name=name, cell=cell)
                    emit(f"migrated_out {name} {epoch} {blob.hex()}")
            elif cmd == "migrate_in":
                name, epoch = parts[1], int(parts[2])
                blob = bytes.fromhex(parts[3])
                with m.lock:
                    row = m.rows.free_in_range(0, m.G)
                    ok = (row is not None
                          and coord.create_replica_group_at(
                              name, epoch, blob, active_ids, row))
                if ok:
                    overrides.pop(name, None)  # we ARE the owner now
                    timeline.annotate("migrate_in", name=name, cell=cell)
                    emit(f"migrated_in {name} {epoch}")
                else:
                    emit(f"migrate_err {name} no_row")
            elif cmd == "migrate_drop":
                coord.drop_final_state(parts[1], int(parts[2]))
                emit(f"migrate_dropped {parts[1]}")
            elif cmd == "exit":
                break
            else:
                emit(f"err unknown_cmd {cmd}")
        except Exception as e:
            emit(f"err {cmd} {type(e).__name__}: {e}")

    reporter.stop()
    timeline.stop()
    flight.dump("graceful_exit")
    fd.close()
    if edge_m is not None:
        edge_m.close()
    cluster.shutdown(float(spec.get("drain_timeout_s", 10.0)))


if __name__ == "__main__":
    main()
