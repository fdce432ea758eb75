"""Node bootstrap: wire transport, data plane and control plane together.

Analog of ``reconfiguration/ReconfigurableNode.java:63`` (entry point that
builds a messenger, then an ActiveReplica and/or Reconfigurator per role)
plus ``TESTReconfigurationMain.startLocalServers``
(reconfiguration/testing/TESTReconfigurationMain.java:86), whose strategy —
instantiate every node of a cluster *in one process* on loopback ports with
real sockets — is exactly how our tests run (SURVEY §4).

Device shape (Mode A): all active replicas of one deployment share a single
dense-device data plane — node ids are replica slots of one mesh program —
so the cluster owns

* one active-side :class:`PaxosManager` (R = #actives) + TickDriver, or a
  :class:`~.chain.ChainManager` with ``coordinator="chain"``,
* one RC-side :class:`PaxosManager` (R = #reconfigurators) + TickDriver,
  whose apps are the :class:`ReconfiguratorDB` replicas,
* per active node id: a Messenger + :class:`ActiveReplica`,
* per RC node id: a Messenger + :class:`Reconfigurator`,
* failure detectors on every node feeding a shared liveness view.

Both planes live on one device: ``device=None`` means CUDA and raises where
there is no card (``device.resolve_device``); tests pass ``device="cpu"``.
With ``cfg.placement.enabled`` the data-plane manager keeps per-group
demand counters; :meth:`InProcessCluster.start_rebalancer` starts the
periodic placement loop (:class:`RebalancerDaemon`) over them.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from .config import GigapaxosTpuConfig
from .models.replicable import Replicable
from .net.failure_detection import FailureDetection
from .device import resolve_device
from .net.messenger import Messenger, NodeMap
from .net.security import TransportSecurity
from .paxos.driver import TickDriver
from .paxos.manager import PaxosManager
from .placement import GroupMigrator, MigrationStats, ShardRebalancer
from .reconfiguration.active_replica import ActiveReplica
from .reconfiguration.coordinator import PaxosReplicaCoordinator
from .reconfiguration.demand import AbstractDemandProfile, DemandProfile
from .reconfiguration.rc_db import (
    ReconfiguratorDB,
    RepliconfigurableReconfiguratorDB,
)
from .reconfiguration.reconfigurator import Reconfigurator


class RebalancerDaemon:
    """Periodic placement loop: ``ShardRebalancer.propose`` over the live
    demand snapshot, ``GroupMigrator.execute_plan`` through the epoch
    machinery.  OFF by default: started only by an explicit
    :meth:`InProcessCluster.start_rebalancer`; its lifecycle is tied to the
    node (``close()`` stops it)."""

    def __init__(self, cluster: "InProcessCluster", interval_s: float = 1.0,
                 *, table=None, stats: Optional[MigrationStats] = None,
                 migrator: Optional[GroupMigrator] = None,
                 rebalancer: Optional[ShardRebalancer] = None,
                 **rebalancer_kw):
        m = cluster.manager
        if getattr(m, "_placement", None) is None:
            raise RuntimeError(
                "rebalancer daemon needs cfg.placement.enabled demand "
                "counters on the data-plane manager"
            )
        gs, _per = m.shard_geometry()
        self.m = m
        self.driver = cluster.driver
        self.interval_s = float(interval_s)
        self.stats = stats or MigrationStats()
        self.migrator = migrator or GroupMigrator(
            cluster.coordinator, table=table, counters=m._placement,
            stats=self.stats,
        )
        self.rebalancer = rebalancer or ShardRebalancer(
            m.G, gs, **rebalancer_kw
        )
        self.moves_total = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="rebalancer", daemon=True
        )
        self._thread.start()

    def _pump(self) -> None:
        # the TickDriver owns the tick loop; the migrator just needs the
        # plane to advance while it waits for the stop/checkpoint to land
        self.driver.kick()
        time.sleep(0.002)

    def run_once(self) -> int:
        """One propose/execute round; returns groups moved."""
        demand = self.m.demand_snapshot()
        if demand is None:
            return 0
        plan = self.rebalancer.propose(
            self.m.tick_num, demand,
            free_rows_in_shard=self.m.free_rows_in_shard,
            blob_bytes=self.m.blob_bytes_of_row,
        )
        if not plan:
            return 0
        moved = self.migrator.execute_plan(plan, pump=self._pump)
        if moved:
            self.rebalancer.record_executed(moved)
        else:
            self.rebalancer.record_aborted()
        self.moves_total += moved
        return moved

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:
                # a transient failure (shutdown race, full destination)
                # must not kill the daemon; the next round re-plans
                pass

    def stop(self) -> None:
        self._stop.set()


class InProcessCluster:
    """A whole deployment in one process on loopback ports.

    ``cfg.nodes`` lists actives and reconfigurators with their bind
    addresses (the ``active.*``/``reconfigurator.*`` topology of
    ``gigapaxos.properties``); ``app_factory()`` builds one Replicable per
    active replica slot.
    """

    def __init__(
        self,
        cfg: GigapaxosTpuConfig,
        app_factory: Callable[[], Replicable],
        demand_profile_factory: Callable[[str], AbstractDemandProfile] = DemandProfile,
        replicas_per_name: int = 3,
        rc_group_size: int = 3,
        wal=None,
        rc_wal=None,
        start_fd: bool = False,
        coordinator: str = "paxos",
        spare_replica_slots: int = 0,
        spare_rc_slots: int = 0,
        wal_dir: Optional[str] = None,
        rc_wal_dir: Optional[str] = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        active_ids = cfg.nodes.active_ids()
        rc_ids = cfg.nodes.reconfigurator_ids()
        if not active_ids or not rc_ids:
            raise ValueError("topology needs >=1 active and >=1 reconfigurator")

        # ---------------- data plane (shared dense device state, Mode A)
        # the coordination protocol is pluggable exactly like the reference's
        # REPLICA_COORDINATOR_CLASS (ReconfigurableNode.java:203-218)
        # spare slots = provisioned-but-unbound replica capacity for runtime
        # active-node adds (elasticity binds node ids to spare slots)
        self._demand_profile_factory = demand_profile_factory
        self._rc_group_size = rc_group_size
        n_slots = len(active_ids) + spare_replica_slots
        apps = [app_factory() for _ in range(n_slots)]
        if coordinator == "chain":
            from .chain import ChainManager, ChainReplicaCoordinator

            self.manager = ChainManager(cfg, n_slots, apps, wal=wal,
                                        device=self.device)
            self.coordinator = ChainReplicaCoordinator(self.manager,
                                                       active_ids)
        elif coordinator == "paxos":
            if wal_dir is not None:
                if wal is not None:
                    raise ValueError("pass wal= or wal_dir=, not both")
                self.manager = self._open_plane(cfg, n_slots, apps,
                                                wal_dir, "ar", self.device)
            else:
                self.manager = PaxosManager(cfg, n_slots, apps, wal=wal,
                                            spill_ns="ar", device=self.device)
            self.coordinator = PaxosReplicaCoordinator(self.manager, active_ids)
            # a WAL-replayed manager has its groups back but the fresh
            # coordinator's epoch map is empty — re-adopt name#epoch rows so
            # recovered groups answer instead of "not_active"
            self.coordinator.adopt_live_epochs()
        else:
            raise ValueError(f"unknown coordinator {coordinator!r}")
        self.driver = TickDriver(self.manager).start()

        # ---------------- RC plane (the DB replicated on its own data plane)
        # spare RC slots = provisioned capacity for runtime RC-node adds
        # (Reconfigurator.handleReconfigureRCNodeConfig:1044)
        rc_apps = [ReconfiguratorDB(r) for r in rc_ids] + [
            ReconfiguratorDB(f"_spare{i}") for i in range(spare_rc_slots)
        ]
        # the RC DB is a host state machine: a device-app data plane must
        # not leak its mode into the control plane's manager
        rc_cfg = cfg
        if cfg.paxos.device_app:
            rc_cfg = copy.copy(cfg)
            rc_cfg.paxos = dataclasses.replace(cfg.paxos, device_app=False)
        if rc_wal_dir is not None:
            if rc_wal is not None:
                raise ValueError("pass rc_wal= or rc_wal_dir=, not both")
            self.rc_manager = self._open_plane(rc_cfg, len(rc_apps), rc_apps,
                                               rc_wal_dir, "rc", self.device)
        else:
            self.rc_manager = PaxosManager(rc_cfg, len(rc_apps), rc_apps,
                                           wal=rc_wal, spill_ns="rc",
                                           device=self.device)
        self.rdb = RepliconfigurableReconfiguratorDB(
            self.rc_manager, rc_ids, k=rc_group_size
        )
        self.rc_driver = TickDriver(self.rc_manager).start()

        # ---------------- per-node control plane endpoints
        security = TransportSecurity.from_config(cfg.ssl)
        self.nodemap = NodeMap(cfg.nodes)
        self.actives: Dict[str, ActiveReplica] = {}
        self.reconfigurators: Dict[str, Reconfigurator] = {}
        self.fds: Dict[str, FailureDetection] = {}
        self.rebalancer: Optional[RebalancerDaemon] = None
        self._liveness: Dict[str, bool] = {n: True for n in rc_ids + active_ids}

        for a in active_ids:
            m = Messenger(a, cfg.nodes.actives[a], self.nodemap,
                          security=security)
            # port 0 binds ephemerally: publish the real port, both in this
            # cluster's nodemap and back into cfg.nodes so clients built
            # from the same config resolve correctly
            self.nodemap.add(a, cfg.nodes.actives[a][0], m.port)
            cfg.nodes.actives[a] = (cfg.nodes.actives[a][0], m.port)
            self.actives[a] = ActiveReplica(
                a, m, self.coordinator, rc_ids,
                demand_profile_factory=demand_profile_factory,
                rc_group_size=rc_group_size,
            )
        for r in rc_ids:
            m = Messenger(r, cfg.nodes.reconfigurators[r], self.nodemap,
                          security=security)
            self.nodemap.add(r, cfg.nodes.reconfigurators[r][0], m.port)
            cfg.nodes.reconfigurators[r] = (cfg.nodes.reconfigurators[r][0], m.port)
            self.reconfigurators[r] = Reconfigurator(
                r, m, self.rdb, active_ids,
                replicas_per_name=replicas_per_name,
                demand_profile_factory=demand_profile_factory,
                is_node_up=lambda n: self._liveness.get(n, True),
            )
        # block until both planes ticked once (the kernels are built) —
        # otherwise the first client RPC races the build and times out
        self.driver.wait_ready()
        self.rc_driver.wait_ready()
        if start_fd:
            for r in rc_ids:
                self.fds[r] = FailureDetection(
                    self.reconfigurators[r].m, monitored=rc_ids,
                    ping_interval_s=cfg.fd.ping_interval_s,
                    timeout_s=cfg.fd.timeout_s,
                    adaptive=cfg.fd.adaptive,
                    adaptive_beta=cfg.fd.adaptive_beta,
                    adaptive_gain=cfg.fd.adaptive_gain,
                    on_change=self._fd_change,
                )

    @staticmethod
    def _open_plane(cfg, n_slots: int, apps, wal_dir: str, ns: str, device):
        """Build one plane's manager against an on-disk WAL directory:
        recover (snapshot + journal replay) when the directory already holds
        a journal, else start fresh with a new logger — the cell worker's
        crash-restart path (cells/worker.py) in one switch."""
        from .wal import logger as wal_logger

        os.makedirs(wal_dir, exist_ok=True)
        if any(fn.startswith(("journal.", "snapshot."))
               for fn in os.listdir(wal_dir)):
            return wal_logger.recover(cfg, n_slots, apps, wal_dir,
                                      native=cfg.native_journal, spill_ns=ns,
                                      device=device)
        wal = wal_logger.PaxosLogger(
            wal_dir, sync_every_ticks=cfg.paxos.sync_every_ticks,
            native=cfg.native_journal,
            payload_dedup=getattr(cfg.paxos, "wal_payload_dedup", True),
        )
        return PaxosManager(cfg, n_slots, apps, wal=wal, spill_ns=ns,
                            device=device)

    def _fd_change(self, node: str, up: bool) -> None:
        self._liveness[node] = up

    # ------------------------------------------------------------- elasticity
    def add_active_endpoint(self, node_id: str,
                            bind=("127.0.0.1", 0)) -> ActiveReplica:
        """Local wiring for a runtime active-node add: bind a spare replica
        slot and start the node's control-plane endpoint.  Pair with an
        admin ``add_active`` request to a reconfigurator so the RC pool
        learns the node (the committed NC change carries the address)."""
        slot = self.coordinator.bind_node(node_id)
        if slot is None:
            raise RuntimeError("no spare replica slots provisioned")
        self.manager.set_alive(slot, True)  # slot may be recycled from a remove
        m = Messenger(node_id, bind, self.nodemap)
        self.nodemap.add(node_id, bind[0], m.port)
        self.cfg.nodes.actives[node_id] = (bind[0], m.port)
        ar = ActiveReplica(
            node_id, m, self.coordinator, self.cfg.nodes.reconfigurator_ids(),
            demand_profile_factory=self._demand_profile_factory,
            rc_group_size=self._rc_group_size,
        )
        self.actives[node_id] = ar
        self._liveness[node_id] = True
        return ar

    def remove_active_endpoint(self, node_id: str) -> None:
        """Tear down a removed node's endpoint (after the admin
        ``remove_active`` request migrated its names away)."""
        ar = self.actives.pop(node_id, None)
        if ar is not None:
            ar.close()
        slot = self.coordinator.unbind_node(node_id)
        if slot is not None:
            self.manager.set_alive(slot, False)  # dead until rebound
        self.cfg.nodes.actives.pop(node_id, None)
        self._liveness[node_id] = False

    def add_rc_endpoint(self, node_id: str,
                        bind=("127.0.0.1", 0)) -> Reconfigurator:
        """Local wiring for a runtime RC-node add: bind a spare RC-plane
        slot and start the node's control endpoint.  Pair with an admin
        ``add_reconfigurator`` request so the committed NC-RC change splices
        the ring everywhere (Reconfigurator.java:1044)."""
        slot = self.rdb.bind_rc(node_id)
        if slot is None:
            raise RuntimeError("no spare RC slots provisioned")
        self.rc_manager.set_alive(slot, True)
        m = Messenger(node_id, bind, self.nodemap,
                      security=TransportSecurity.from_config(self.cfg.ssl))
        self.nodemap.add(node_id, bind[0], m.port)
        self.cfg.nodes.reconfigurators[node_id] = (bind[0], m.port)
        k = (next(iter(self.reconfigurators.values())).k
             if self.reconfigurators else 3)
        rc = Reconfigurator(
            node_id, m, self.rdb, self.cfg.nodes.active_ids(),
            replicas_per_name=k,
            demand_profile_factory=self._demand_profile_factory,
            is_node_up=lambda n: self._liveness.get(n, True),
        )
        self.reconfigurators[node_id] = rc
        self._liveness[node_id] = True
        return rc

    def remove_rc_endpoint(self, node_id: str) -> None:
        """Tear down a removed reconfigurator's endpoint (after the admin
        ``remove_reconfigurator`` request re-homed its records)."""
        rc = self.reconfigurators.pop(node_id, None)
        if rc is not None:
            rc.close()
        slot = self.rdb.unbind_rc(node_id)
        if slot is not None:
            self.rc_manager.set_alive(slot, False)
        self.cfg.nodes.reconfigurators.pop(node_id, None)
        self._liveness[node_id] = False

    # ------------------------------------------------------------- placement
    def start_rebalancer(self, interval_s: float = 1.0,
                         **kw) -> RebalancerDaemon:
        """Start the periodic rebalancer (off by default).  ``kw`` passes
        through to :class:`RebalancerDaemon` — ``table=`` to keep a
        placement-override table in step with moves, plus any
        :class:`ShardRebalancer` tuning (``skew_threshold``, ...)."""
        if self.rebalancer is not None:
            raise RuntimeError("rebalancer already running")
        self.rebalancer = RebalancerDaemon(self, interval_s, **kw)
        return self.rebalancer

    def stop_rebalancer(self) -> None:
        if self.rebalancer is not None:
            self.rebalancer.stop()
            self.rebalancer = None

    # ----------------------------------------------------------------- admin
    def kick(self) -> None:
        self.driver.kick()
        self.rc_driver.kick()

    def set_node_up(self, node: str, up: bool) -> None:
        """Test hook: mark a node's liveness (crash emulation, the analog of
        TESTPaxosConfig.crash, testing/TESTPaxosConfig.java:563-578)."""
        self._liveness[node] = up

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Quiesce both planes: kick the drivers until no proposal is
        outstanding and every journaled tick is fsync-covered (a response
        the client saw must never be lost by the shutdown that follows).
        Returns False if the deadline passed with work still in flight."""
        deadline = time.monotonic() + timeout_s
        planes = [(self.driver, self.manager), (self.rc_driver, self.rc_manager)]
        while True:
            busy = False
            for drv, m in planes:
                wal = getattr(m, "wal", None)
                if m.pending_count() > 0 or (wal is not None
                                             and not wal.is_synced()):
                    busy = True
                    drv.kick()
            if not busy:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def close(self) -> None:
        self.stop_rebalancer()
        for fd in self.fds.values():
            fd.close()
        # drivers stop BEFORE the messengers close: a tick flushing frames
        # after its transport died would fail sends mid-commit (the old
        # order); stop() also drains the execution pipeline
        self.driver.stop()
        self.rc_driver.stop()
        # final fsync + journal close: an acked commit must be disk-covered
        # before the process exits
        for m in (self.manager, self.rc_manager):
            wal = getattr(m, "wal", None)
            if wal is not None:
                try:
                    if wal.journal is not None:
                        wal._sync()
                    wal.close()
                except Exception:
                    pass
        for ar in self.actives.values():
            ar.close()
        for rc in self.reconfigurators.values():
            rc.close()

    def shutdown(self, drain_timeout_s: float = 10.0) -> bool:
        """Graceful stop: drain in-flight work, then close.  Returns the
        drain verdict (close happens either way)."""
        ok = self.drain(drain_timeout_s)
        self.close()
        return ok

    def install_sigterm(self, drain_timeout_s: float = 10.0,
                        on_exit: Optional[Callable[[], None]] = None) -> None:
        """SIGTERM = graceful cell shutdown (cells/worker.py, systemd stop):
        drain the in-flight tick, flush + close the WAL, close transports,
        then exit 0.  Main-thread only (signal module constraint)."""
        def _handler(signum, frame):
            try:
                self.shutdown(drain_timeout_s)
                if on_exit is not None:
                    on_exit()
            finally:
                os._exit(0)

        signal.signal(signal.SIGTERM, _handler)


def build_node(
    node_id: str,
    cfg: GigapaxosTpuConfig,
    app_factory: Callable[[], Replicable],
    **kw,
) -> InProcessCluster:
    """CLI-style single-entry bootstrap (ReconfigurableNode.main analog).

    Today every deployment is driven by one process per replica-mesh (Mode
    A), so this simply builds the cluster object; per-host Mode B spawning
    lands with the multi-host transport binding.
    """
    return InProcessCluster(cfg, app_factory, **kw)
