"""Per-process deployment unit: the ``gpServer.sh`` / ``ReconfigurableNode``
analog.

The reference's unit of deployment is one process running the whole stack —
transport, ActiveReplica and/or Reconfigurator, coordinator, logger — built
by ``ReconfigurableNode.main``
(``reconfiguration/ReconfigurableNode.java:63,259-336,434``, launched by
``bin/gpServer.sh``).  :class:`ModeBServer` is that unit for the port: each
process owns

* a Messenger per role (actives and reconfigurators are distinct ids in the
  topology, like ``active.*`` / ``reconfigurator.*`` lines);
* an independent Mode B consensus node per plane, with its own WAL and
  device state (``modeb/``, or ``chain/modeb.py`` with the chain
  coordinator), replica traffic as SoA frames over TCP;
* the control-plane face for the role: :class:`ActiveReplica` over a
  :class:`ModeBReplicaCoordinator`, and/or :class:`Reconfigurator` over a
  :class:`ModeBRepliconfigurableDB`;
* a keep-alive failure detector feeding the node's liveness mask every
  tick (``FailureDetection.java:209-258`` → candidacy phase 0) — killing a
  coordinator process needs no manual liveness control anywhere;
* a TickDriver pumping each plane;
* optionally a stats reporter (``stats_interval_s``), a flight recorder
  and the scrape endpoint (``obs.flight_dir``, ``obs.http_port``).

Every plane's state lives on ``device`` (CUDA unless the caller asks for
the CPU).  Run from the CLI::

    python -m gigapaxos_tpu_torch.server --node AR0 \\
        --properties gigapaxos.properties --log-dir /var/lib/gptpu

or embed (several servers in one process on loopback, the
``TESTReconfigurationMain.startLocalServers`` strategy).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import logging
import os
import signal
import threading
from typing import Callable, Optional

from .config import GigapaxosTpuConfig, load_properties
from .device import resolve_device
from .models.replicable import KVApp, Replicable
from .modeb import ModeBLogger, ModeBNode, recover_modeb
from .modeb.coordinator import ModeBReplicaCoordinator, ModeBRepliconfigurableDB
from .net.failure_detection import FailureDetection
from .net.messenger import Messenger, NodeMap
from .net.security import TransportSecurity
from .paxos.driver import TickDriver
from .reconfiguration.active_replica import ActiveReplica
from .reconfiguration.demand import AbstractDemandProfile, DemandProfile
from .reconfiguration.rc_db import ReconfiguratorDB
from .reconfiguration.reconfigurator import Reconfigurator

log = logging.getLogger(__name__)

#: what the server refuses until the serving cells are ported
CELLS_UNPORTED = "not ported yet: the serving-cell host plane (the cells slice)"


class ModeBServer:
    """One OS process of a Mode B deployment (active and/or reconfigurator
    role, depending on which topology section names ``node_id``)."""

    def __init__(
        self,
        node_id: str,
        cfg: GigapaxosTpuConfig,
        app_factory: Callable[[], Replicable] = KVApp,
        log_dir: Optional[str] = None,
        start_fd: bool = True,
        replicas_per_name: int = 3,
        rc_group_size: int = 3,
        demand_profile_factory: Callable[[str], AbstractDemandProfile] = DemandProfile,
        coordinator: str = "paxos",
        device=None,
    ):
        """``coordinator``: "paxos" (ModeBNode data plane) or "chain"
        (ChainModeBNode — cross-host chain replication); both WAL-backed
        when ``log_dir`` is set, recovering from their own journals.
        Mirrors REPLICA_COORDINATOR_CLASS (ReconfigurableNode.java:203-218).
        ``device`` holds every plane's state and runs every recovery
        (``None`` = CUDA; see ``device.resolve_device``)."""
        self.device = resolve_device(device)
        self.node_id = node_id
        self.cfg = cfg
        self.nodemap = NodeMap(cfg.nodes)
        # Two distinct node lists: the replica-slot UNIVERSE (append-only,
        # committed NC order — data-plane member axis) and the live
        # placement POOL (current actives — what reconfigurators place new
        # names on).  The universe may retain removed nodes whose slots are
        # never recycled; the pool must not.
        universe_ids = cfg.nodes.universe_order()
        active_ids = cfg.nodes.active_ids()
        rc_ids = cfg.nodes.reconfigurator_ids()
        self.is_active = node_id in cfg.nodes.actives
        self.is_rc = node_id in cfg.nodes.reconfigurators
        if not (self.is_active or self.is_rc):
            raise ValueError(f"{node_id!r} is in neither topology section")
        log_dir = log_dir or cfg.log_dir
        security = TransportSecurity.from_config(cfg.ssl)

        self.fds: list = []
        self.drivers: list = []
        self.reporter = None
        if cfg.stats_interval_s > 0:
            from .utils.observability import StatsReporter

            self.reporter = StatsReporter(node_id, cfg.stats_interval_s)
        self.node = None
        self.rc_node: Optional[ModeBNode] = None
        self.timeline_rec = None
        self._closing = False
        self.active_replica: Optional[ActiveReplica] = None
        self.reconfigurator: Optional[Reconfigurator] = None
        self.app: Optional[Replicable] = None

        if self.is_active:
            bind = cfg.nodes.actives[node_id]
            m = Messenger(node_id, bind, self.nodemap, security=security)
            self.nodemap.add(node_id, bind[0], m.port)
            cfg.nodes.actives[node_id] = (bind[0], m.port)
            self.app = app_factory()
            if coordinator == "chain":
                from .chain.modeb import ChainModeBNode
                from .chain.modeb_logger import ChainBLogger, recover_chain_modeb

                wal_dir = (os.path.join(log_dir, f"{node_id}-chain")
                           if log_dir else None)
                if wal_dir and os.path.isdir(wal_dir) and os.listdir(wal_dir):
                    node = recover_chain_modeb(
                        cfg, universe_ids, node_id, self.app, wal_dir,
                        native=cfg.native_journal, device=self.device,
                    )
                    recovered = True
                else:
                    wal = (ChainBLogger(wal_dir, native=cfg.native_journal)
                           if wal_dir else None)
                    node = ChainModeBNode(cfg, universe_ids, node_id,
                                          self.app, wal=wal,
                                          device=self.device)
                    recovered = False
            elif coordinator == "paxos":
                node, recovered = self._make_node(
                    universe_ids, self.app,
                    os.path.join(log_dir, f"{node_id}-ar") if log_dir else None,
                    spill_ns=f"{node_id}-ar",
                )
                if cfg.paxos.device_app:
                    # device mode: the node built its own DeviceKVApp face
                    # over the device arrays; the control plane (epoch
                    # final-state, demand, tests) must see THAT app
                    self.app = node.app
            else:
                raise ValueError(f"unknown coordinator {coordinator!r}")
            self.coordinator = ModeBReplicaCoordinator(node)
            # ActiveReplica first: its BulkTransfer claims the raw-bytes
            # handler, and the node's frame handler must chain OVER it
            self.active_replica = ActiveReplica(
                node_id, m, self.coordinator, rc_ids,
                demand_profile_factory=demand_profile_factory,
                rc_group_size=rc_group_size,
            )
            node.attach_messenger(m)
            m.register("nc_universe_apply", self._on_nc_universe)
            if recovered:
                node.request_sync()
            if start_fd:
                fd = FailureDetection(
                    m, monitored=universe_ids,
                    ping_interval_s=cfg.fd.ping_interval_s,
                    timeout_s=cfg.fd.timeout_s,
                    adaptive=cfg.fd.adaptive,
                    adaptive_beta=cfg.fd.adaptive_beta,
                    adaptive_gain=cfg.fd.adaptive_gain,
                )
                node.attach_failure_detector(fd)
                self.fds.append(fd)
            self.node = node
            self.drivers.append(self._start_driver(node))
            if self.reporter is not None:
                from .utils.observability import (node_stats_source,
                                                  transport_stats_source)

                self.reporter.add_source("ar", node_stats_source(node))
                self.reporter.add_source(
                    "ar_net", transport_stats_source(m.transport)
                )

        if self.is_rc:
            bind = cfg.nodes.reconfigurators[node_id]
            m = Messenger(node_id, bind, self.nodemap, security=security)
            self.nodemap.add(node_id, bind[0], m.port)
            cfg.nodes.reconfigurators[node_id] = (bind[0], m.port)
            db = ReconfiguratorDB(node_id)
            rc_node, recovered = self._make_node(
                rc_ids, db,
                os.path.join(log_dir, f"{node_id}-rc") if log_dir else None,
                spill_ns=f"{node_id}-rc", rc_plane=True,
            )
            self.rdb = ModeBRepliconfigurableDB(rc_node, rc_ids, k=rc_group_size)
            fd = None
            if start_fd:
                fd = FailureDetection(
                    m, monitored=rc_ids,
                    ping_interval_s=cfg.fd.ping_interval_s,
                    timeout_s=cfg.fd.timeout_s,
                    adaptive=cfg.fd.adaptive,
                    adaptive_beta=cfg.fd.adaptive_beta,
                    adaptive_gain=cfg.fd.adaptive_gain,
                )
                self.fds.append(fd)
            self.reconfigurator = Reconfigurator(
                node_id, m, self.rdb, active_ids,
                replicas_per_name=replicas_per_name,
                demand_profile_factory=demand_profile_factory,
                is_node_up=fd.is_node_up if fd is not None else None,
            )
            rc_node.attach_messenger(m)
            if recovered:
                rc_node.request_sync()
            if fd is not None:
                rc_node.attach_failure_detector(fd)
            self.rc_node = rc_node
            self.drivers.append(self._start_driver(rc_node))
            if self.reporter is not None:
                from .utils.observability import (node_stats_source,
                                                  transport_stats_source)

                self.reporter.add_source("rc", node_stats_source(rc_node))
                self.reporter.add_source(
                    "rc_net", transport_stats_source(m.transport)
                )

        # ---------------------------------------------------- flight deck
        # per-node scrape endpoint + crash flight recorder (cfg.obs)
        self.metrics_server = None
        self.flight = None
        obs = getattr(cfg, "obs", None)
        if obs is not None and obs.flight_dir:
            from .obs.flight import FlightRecorder

            self.flight = FlightRecorder(
                os.path.join(obs.flight_dir, f"{node_id}-flight.json"),
                cap=obs.flight_cap, node=node_id)
            self.flight.install_excepthook()
            self.flight.record("boot", node=node_id, pid=os.getpid())
            if self.reporter is not None:
                self.reporter.sink = self.flight.snapshot_sink
            if self.node is not None:
                # health fold records wedge/recover transitions here
                self.node.flight = self.flight
        if obs is not None and obs.http_port >= 0:
            from .obs.http import MetricsServer
            from .obs.metrics import registry as _obs_registry
            from .obs.prom import render_registry
            from .obs.timeline import TimelineRecorder, registry_sampler
            from .utils import reqtrace as _reqtrace

            def _scrape() -> str:
                return render_registry(_obs_registry(),
                                       extra_labels={"node": node_id})

            def _trace(tid):
                d = _reqtrace.dump_ns()
                return (d if tid is None
                        else {k: v for k, v in d.items() if k == str(tid)})

            flight_cb = None
            if self.flight is not None:
                fr = self.flight
                flight_cb = lambda: fr.read(fr.persist())  # noqa: E731

            # health plane: readiness + group drill-down served off the
            # data-plane node; the RC plane is control traffic and reports
            # only through /healthz's wal check
            def _wal_failed() -> bool:
                for n in (self.node, self.rc_node):
                    if n is not None and getattr(n, "wal", None) is not None:
                        if getattr(n.wal, "failed", False):
                            return True
                return False

            def _healthz() -> dict:
                return {"ok": not _wal_failed() and not self._closing,
                        "node": node_id, "draining": self._closing,
                        "wal_failed": _wal_failed()}

            # a chain node has no health fold: /health and /group answer
            # 404 on a chain active instead of failing the server's boot
            health_cb = getattr(self.node, "health_snapshot", None)
            group_cb = getattr(self.node, "group_info", None)
            self.timeline_rec = TimelineRecorder(
                registry_sampler(
                    "health_backlogged_groups", "health_wedged_groups",
                    "overload_admission_shed_total", "tick_seconds"),
                interval_s=obs.timeline_interval_s,
                node=node_id).start()
            self.timeline_rec.annotate("boot", node=node_id)
            self.metrics_server = MetricsServer(
                _scrape, trace=_trace, flight=flight_cb,
                healthz=_healthz, health=health_cb, group=group_cb,
                timeline=self.timeline_rec.snapshot,
                port=obs.http_port)

        if self.reporter is not None:
            self.reporter.start()

    def _on_nc_universe(self, sender: str, p: dict) -> None:
        """A reconfigurator committed a node addition: adopt the new
        node's address and grow this plane's replica universe to match the
        committed slot order (idempotent; lost broadcasts are repaired by
        the next one, which carries the complete order)."""
        for nid, addr in (p.get("addrs") or {}).items():
            self.nodemap.add(nid, addr[0], int(addr[1]))
        uni = list(p.get("universe") or [])
        node = self.node
        if node is None or not hasattr(node, "expand_universe"):
            return
        with node.lock:
            known = list(node.members)
        if uni[: len(known)] != known:
            if uni == known[: len(uni)]:
                # stale broadcast (an earlier add, delivered late over a
                # different RC's connection): already applied, nothing to do
                return
            # a conflicting order would desync slot indices across nodes —
            # never apply it (this node's own WAL/boot order is authoritative
            # for the prefix it already has)
            log.warning("%s: nc universe %s conflicts with members %s",
                        self.node_id, uni, known)
            return
        fresh = uni[len(known):]
        if fresh:
            try:
                node.expand_universe(fresh)
            except ValueError:
                # cap enforcement lives in the NC apply; this guard keeps a
                # malformed broadcast from killing the handler thread
                log.exception("%s: universe expansion rejected", self.node_id)

    @staticmethod
    def _start_driver(node) -> TickDriver:
        """Event-driven pumping: long idle sleep (several planes may share
        few cores — an idle plane must not burn them), with work arrival
        (propose / forwarded proposal / inbound frame) kicking the driver
        awake immediately."""
        driver = TickDriver(node, idle_sleep_s=0.05)
        node.on_work = driver.kick
        return driver.start()

    def _make_node(self, member_ids, app, wal_dir, spill_ns=None,
                   rc_plane=False):
        """Build (or WAL-recover) one plane's ModeBNode, messenger-less —
        the caller attaches the messenger after the control-plane endpoint
        claims its handlers (3-pass recovery before live traffic,
        PaxosManager.initiateRecovery, PaxosManager.java:1852)."""
        cfg = self.cfg
        if rc_plane and cfg.paxos.device_app:
            # the RC DB is a host state machine: a device-app data plane
            # must not leak its mode into the control plane (node.py does
            # the same for Mode A)
            cfg = copy.copy(cfg)
            cfg.paxos = dataclasses.replace(cfg.paxos, device_app=False)
        if wal_dir and os.path.isdir(wal_dir) and os.listdir(wal_dir):
            node = recover_modeb(
                cfg, member_ids, self.node_id, app, wal_dir,
                native=cfg.native_journal, spill_ns=spill_ns,
                device=self.device,
            )
            return node, True
        wal = None
        if wal_dir:
            wal = ModeBLogger(wal_dir, native=cfg.native_journal)
        node = ModeBNode(
            cfg, member_ids, self.node_id, app, messenger=None,
            wal=wal, spill_ns=spill_ns, device=self.device,
        )
        return node, False

    # ------------------------------------------------------------------ admin
    def wait_ready(self, timeout_s: float = 180.0) -> bool:
        """Block until every plane ticked once (its kernels are built)."""
        return all(d.wait_ready(timeout_s) for d in self.drivers)

    def close(self) -> None:
        """Stop in dependency order: observability, failure detectors and
        tick drivers first (a tick sending frames after the messenger
        closed would die with SendFailure on the driver thread), then the
        control-plane faces and messengers, then each journal under its
        node's lock — a frame still arriving on a messenger thread appends
        to the journal under that lock, and must never meet a closed
        (freed) native journal."""
        self._closing = True
        if self.timeline_rec is not None:
            self.timeline_rec.stop()
        if self.metrics_server is not None:
            self.metrics_server.close()
        if self.reporter is not None:
            self.reporter.stop()
        if self.flight is not None:
            self.flight.dump("close")
        for fd in self.fds:
            fd.close()
        for d in self.drivers:
            d.stop()
        if self.active_replica is not None:
            self.active_replica.close()
        if self.reconfigurator is not None:
            self.reconfigurator.close()
        for n in (self.node, self.rc_node):
            if n is not None:
                n.close()
        for n in (self.node, self.rc_node):
            if n is not None and n.wal is not None:
                with n.lock:
                    n.wal.close()


def _run_cells(cfg: GigapaxosTpuConfig, log_dir: Optional[str]) -> None:
    """``--cells`` bootstrap: one supervised multi-core host plane of
    crash-isolated Mode A cells.  Not ported yet."""
    raise NotImplementedError(CELLS_UNPORTED)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="gigapaxos_tpu_torch per-process server (gpServer.sh "
                    "analog)"
    )
    ap.add_argument("--node", default=None, help="node id from the topology")
    ap.add_argument("--properties", required=True,
                    help="gigapaxos.properties-style topology/config file")
    ap.add_argument("--log-dir", default=None, help="WAL root directory")
    ap.add_argument("--no-fd", action="store_true",
                    help="disable the failure detector (tests only)")
    ap.add_argument("--cells", action="store_true",
                    help="boot the multi-core serving-cell plane for this "
                         "host (not ported yet: raises)")
    ap.add_argument("--device", default=None,
                    help="torch device of every plane (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_properties(args.properties)
    if args.cells or cfg.cells.enabled:
        _run_cells(cfg, args.log_dir)
        return
    if not args.node:
        ap.error("--node is required unless --cells is set")
    server = ModeBServer(
        args.node, cfg, log_dir=args.log_dir, start_fd=not args.no_fd,
        device=args.device,
    )
    server.wait_ready()
    print(f"gigapaxos_tpu_torch server {args.node} ready", flush=True)

    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    stop.wait()
    server.close()


if __name__ == "__main__":
    main()
