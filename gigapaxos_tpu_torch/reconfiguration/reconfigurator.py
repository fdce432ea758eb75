"""Reconfigurator: the control-plane brain.

Analog of ``reconfiguration/Reconfigurator.java:128``.  Handles client name
management (``handleCreateServiceName :505``, ``handleDeleteServiceName
:768``, ``handleRequestActiveReplicas :910``), demand-driven migration
(``handleDemandReport :332``), and drives the epoch-change workflow through
protocol tasks — the direct analogs of
``reconfigurationprotocoltasks/``:

* :class:`WaitAckStopEpoch` (WaitAckStopEpoch.java:38) — stop the old epoch
  at a majority of its actives;
* :class:`WaitAckStartEpoch` (WaitAckStartEpoch.java:50) — start the new
  epoch at a majority of the new actives;
* :class:`WaitAckDropEpoch` (WaitAckDropEpoch.java:45) — lazily GC the old
  epoch's final state (bounded retries);
* :class:`WaitPrimaryExecution` (WaitPrimaryExecution.java:60) — non-primary
  members of a name's RC group watchdog an in-flight reconfiguration and
  take over if the primary dies mid-workflow.

Every step is gated on a paxos-committed record mutation through the
replicated :mod:`rc_db` (RCRecordRequest intents/completes committed by
``CommitWorker``, CommitWorker.java:46 — here the commit liveness comes from
the data plane's own retry loop plus task restarts), so any RC replica can
resume the workflow from the record state alone.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..net.messenger import Messenger
from ..protocoltask.executor import ProtocolExecutor, ProtocolTask
from . import packets as pkt
from .consistent_hashing import ConsistentHashRing
from .demand import AbstractDemandProfile, DemandProfile
from .rc_db import NC_RC_RECORD, NC_RECORD, RepliconfigurableReconfiguratorDB
from .records import RCState


def _majority(n: int) -> int:
    return n // 2 + 1


class _WaitAcks(ProtocolTask):
    """Shared shape of the epoch ack-threshold tasks: multicast a packet to a
    node set, complete at a threshold of distinct acks (ThresholdProtocolTask
    analog, protocoltask/ThresholdProtocolTask.java)."""

    period_s = 0.5
    #: backup/watchdog instances set this so the initial schedule() sends
    #: nothing — only the first periodic restart does, giving the primary's
    #: own task a head start before duplicate packets go out
    first_delayed = False

    def __init__(self, targets: List[str], threshold: int,
                 on_done: Optional[Callable[[], None]] = None):
        self.targets = list(targets)
        self.threshold = threshold
        self.acked: set = set()
        self._on_done = on_done
        self._held_first = False

    def packet(self) -> dict:
        raise NotImplementedError

    def start(self):
        if self.first_delayed and not self._held_first:
            self._held_first = True
            return []
        p = self.packet()
        return [(t, dict(p)) for t in self.targets if t not in self.acked]

    def handle(self, event: dict):
        sender = event.get("sender")
        if sender in self.targets:
            self.acked.add(sender)
        return [], len(self.acked) >= self.threshold

    def on_done(self):
        if self._on_done is not None:
            self._on_done()


class WaitAckStopEpoch(_WaitAcks):
    def __init__(self, rc: "Reconfigurator", name: str, epoch: int,
                 actives: List[str], on_done):
        super().__init__(actives, _majority(len(actives)), on_done)
        self.rc, self.name, self.epoch = rc, name, epoch

    @property
    def key(self) -> str:
        return f"WaitAckStopEpoch:{self.name}:{self.epoch}"

    def packet(self) -> dict:
        return pkt.stop_epoch(self.name, self.epoch, self.rc.node_id)


class WaitAckStartEpoch(_WaitAcks):
    def __init__(self, rc: "Reconfigurator", name: str, epoch: int,
                 actives: List[str], prev_epoch: int, prev_actives: List[str],
                 initial_state: Optional[bytes], on_done):
        super().__init__(actives, _majority(len(actives)), on_done)
        self.rc, self.name, self.epoch = rc, name, epoch
        self.prev_epoch, self.prev_actives = prev_epoch, prev_actives
        self.initial_state = initial_state

    @property
    def key(self) -> str:
        return f"WaitAckStartEpoch:{self.name}:{self.epoch}"

    def packet(self) -> dict:
        return pkt.start_epoch(
            self.name, self.epoch, self.targets, self.rc.node_id,
            self.prev_epoch, self.prev_actives, self.initial_state,
        )


class WaitAckDropEpoch(_WaitAcks):
    """GC task: wants *all* acks but gives up after max_restarts (the
    reference's WaitAckDropEpoch similarly bounds retries)."""

    period_s = 1.0
    max_restarts = 8

    def __init__(self, rc: "Reconfigurator", name: str, epoch: int,
                 actives: List[str], on_done=None):
        super().__init__(actives, len(actives), on_done)
        self.rc, self.name, self.epoch = rc, name, epoch

    @property
    def key(self) -> str:
        return f"WaitAckDropEpoch:{self.name}:{self.epoch}"

    def packet(self) -> dict:
        return pkt.drop_epoch(self.name, self.epoch, self.rc.node_id)


class WaitPrimaryExecution(ProtocolTask):
    """Failover watchdog: a non-primary RC sees an intent commit and waits;
    if the record is still mid-reconfiguration after a grace period and the
    primary looks dead (or enough restarts pass), this RC re-drives the
    workflow — safe because every step is idempotent and record-gated."""

    period_s = 2.0
    max_restarts = 30

    def __init__(self, rc: "Reconfigurator", name: str, epoch: int,
                 takeover_after: int = 2):
        self.rc, self.name, self.epoch = rc, name, epoch
        self.takeover_after = takeover_after
        self._fires = 0

    @property
    def key(self) -> str:
        return f"WaitPrimaryExecution:{self.name}:{self.epoch}"

    def start(self):
        return []

    def restart(self):
        rec = self.rc.db.get(self.name)
        if rec is None or (rec.state == RCState.READY and rec.epoch > self.epoch):
            self.rc.executor.cancel(self.key)  # workflow finished
            return []
        self._fires += 1
        primary_dead = not self.rc.is_node_up(self.rc.rdb.primary_of(self.name))
        if primary_dead or self._fires >= self.takeover_after:
            self.rc.executor.cancel(self.key)
            self.rc._resume_workflow(self.name)
        return []

    def handle(self, event):
        return [], True  # explicit completion event (unused today)


class RCMigrateTask(ProtocolTask):
    """After an RC ring splice, sweep local records into their re-homed RC
    groups with idempotent ``record_install`` commits until every record
    this node should drive is installed (Reconfigurator.java:1044's record
    re-hash, made crash-tolerant by retrying sweeps)."""

    period_s = 1.0
    max_restarts = 30

    def __init__(self, rc: "Reconfigurator", change_epoch: int):
        self.rc = rc
        self.change_epoch = change_epoch

    @property
    def key(self) -> str:
        return f"RCMigrate:{self.change_epoch}"

    def start(self):
        self.rc._rc_migrate_once()
        return []

    def restart(self):
        if self.rc._rc_migrate_once() == 0:
            self.rc.executor.cancel(self.key)
        return []

    def handle(self, event):
        return [], True


class UniverseGossipTask(ProtocolTask):
    """Low-rate re-broadcast of the committed replica universe: closes the
    window where an active partitioned across an add_active only converges
    at the NEXT add (nc_universe_apply is idempotent, so over-delivery is
    free)."""

    period_s = 5.0
    max_restarts = 1 << 30

    def __init__(self, rc):
        self.rc = rc

    @property
    def key(self) -> str:
        return f"UniverseGossip:{self.rc.node_id}"

    def start(self):
        self.rc._broadcast_universe()
        return []

    def handle(self, event):
        return [], False


class NodeDrainTask(ProtocolTask):
    """Retrying drain of a removed active: sweeps until no record this RC
    can see still lists the node (names that were mid-reconfiguration at
    NC-commit time get migrated on a later sweep)."""

    period_s = 1.5
    max_restarts = 60

    def __init__(self, rc: "Reconfigurator", node: str):
        self.rc, self.node = rc, node

    @property
    def key(self) -> str:
        return f"NodeDrain:{self.node}"

    def start(self):
        self.rc._drain_node_once(self.node)
        return []

    def restart(self):
        if self.rc._drain_node_once(self.node) == 0:
            self.rc.executor.cancel(self.key)
        return []

    def handle(self, event):
        return [], True


class Reconfigurator:
    def __init__(
        self,
        node_id: str,
        messenger: Messenger,
        rdb: RepliconfigurableReconfiguratorDB,
        active_ids: List[str],
        replicas_per_name: int = 3,
        demand_profile_factory: Callable[[str], AbstractDemandProfile] = DemandProfile,
        is_node_up: Optional[Callable[[str], bool]] = None,
    ):
        self.node_id = node_id
        self.m = messenger
        self.rdb = rdb
        self.db = rdb.db_of(node_id)
        self.db.listener = self._on_db_commit
        self.actives_pool: List[str] = sorted(active_ids)
        self.actives_ring = ConsistentHashRing(self.actives_pool)
        self.k = replicas_per_name
        self.profile_factory = demand_profile_factory
        self._profiles: Dict[str, AbstractDemandProfile] = {}
        self._lock = threading.RLock()
        self.is_node_up = is_node_up or (lambda n: True)
        #: in-flight client replies: name -> (client_id, reply_packet_base)
        self._pending_reply: Dict[str, tuple] = {}
        #: records already re-homed after an RC ring splice (convergence
        #: marker for RCMigrateTask sweeps)
        self._rc_migrated: set = set()
        #: delegated create_batch sub-requests: sub-rid -> aggregation hook
        self._sub_batches: Dict[int, list] = {}
        self._sub_done: Dict[int, Callable[[dict], None]] = {}
        self._sub_next = 1 << 41  # disjoint from client and anycast rids
        #: optional placement-override table (placement/table.py): when the
        #: placement plane is live, overrides take precedence over the ring
        #: for name placement (set by the deployment wiring, not here)
        self.placement_table = None
        self.executor = ProtocolExecutor(self.m.send, name=f"rc-{node_id}")
        for ptype, h in [
            (pkt.CREATE_SERVICE_NAME, self._on_create),
            (pkt.CREATE_BATCH, self._on_create_batch),
            (pkt.CREATE_BATCH_RESPONSE, self._on_create_batch_response),
            (pkt.DELETE_SERVICE_NAME, self._on_delete),
            (pkt.REQUEST_ACTIVE_REPLICAS, self._on_request_actives),
            (pkt.CLIENT_RECONFIGURE, self._on_client_reconfigure),
            (pkt.DEMAND_REPORT, self._on_demand_report),
            (pkt.ACK_STOP_EPOCH, self._route_ack("WaitAckStopEpoch")),
            (pkt.ACK_START_EPOCH, self._route_ack("WaitAckStartEpoch")),
            (pkt.ACK_DROP_EPOCH, self._route_ack("WaitAckDropEpoch")),
            (pkt.ADD_ACTIVE, self._on_node_config),
            (pkt.REMOVE_ACTIVE, self._on_node_config),
            (pkt.ADD_RC, self._on_rc_node_config),
            (pkt.REMOVE_RC, self._on_rc_node_config),
        ]:
            self.m.register(ptype, h)

    def close(self) -> None:
        self.executor.stop()
        self.m.close()

    # ------------------------------------------------------------- placement
    def initial_actives(self, name: str) -> List[str]:
        """Default placement: consistent-hash the name onto the active pool
        (ReconfigurationConfig's default placement policy).  With a
        placement-override table attached, an overridden name's servers
        come from the table instead (lookup falls through to the same ring
        when no override exists)."""
        k = min(self.k, len(self.actives_pool))
        if self.placement_table is not None:
            return self.placement_table.lookup(name, k)
        return self.actives_ring.replicated_servers(name, k)

    def _ensure_owner(self, name: str, sender: str, p: dict) -> bool:
        """With more reconfigurators than k, a client packet may land on an
        RC outside the name's group — forward it to the primary with client
        reply routing preserved (the reference forwards RCRecordRequests to
        the responsible group the same way).  Returns True when this RC
        should handle the packet locally."""
        if self.node_id in self.rdb.rc_group_of(name):
            return True
        if p.get("rc_fwd"):
            return True  # one hop max: handle (and possibly fail) here
        p2 = dict(p)
        p2["reply_to"] = p.get("reply_to") or sender
        p2["rc_fwd"] = 1
        self.m.send(self.rdb.primary_of(name), p2)
        return False

    def _route_ack(self, task: str):
        def h(sender: str, p: dict) -> None:
            self.executor.handle_event(f"{task}:{p['name']}:{p['epoch']}", p)
        return h

    # ------------------------------------------------------------ name create
    def _on_create(self, sender: str, p: dict) -> None:
        pkt.register_client(self.m.nodemap, p)
        sender = p.get("reply_to") or sender
        name, rid = p["name"], p["rid"]
        if not self._ensure_owner(name, sender, p):
            return
        state = pkt.b64d(p["initial_state"]) or b""
        actives = self.initial_actives(name)

        def committed(result: dict) -> None:
            if not result.get("ok"):
                self.m.send(sender, {
                    "type": pkt.CREATE_RESPONSE, "rid": rid, "name": name,
                    "ok": False, "error": result.get("error", "failed"),
                })
                return

            def started() -> None:
                self.m.send(sender, {
                    "type": pkt.CREATE_RESPONSE, "rid": rid, "name": name,
                    "ok": True, "actives": actives,
                })

            # a recreated name continues at tombstone+1 (rc_db): the old
            # incarnation's still-in-flight DropEpoch must never be able
            # to address the new incarnation's data-plane group
            ep = int(result.get("epoch", 0))
            # a stale backup task from a previous incarnation of this name
            # would block this key and orphan the client response
            self.executor.cancel(f"WaitAckStartEpoch:{name}:{ep}")
            self.executor.schedule(WaitAckStartEpoch(
                self, name, ep, actives, -1, [], state, started
            ))

        # origin + initial_state ride inside the replicated command so any
        # RC-group member can re-send the creation StartEpoch if this RC
        # dies between the commit and the delivery (see _on_db_commit)
        self.rdb.commit(
            name,
            {"op": "create", "name": name, "actives": actives,
             "origin": self.node_id, "initial_state": p["initial_state"]},
            committed, proposer=self.node_id,
        )

    # ------------------------------------------------------------ batch create
    def _on_create_batch(self, sender: str, p: dict) -> None:
        """handleCreateServiceName's batched flavor: ONE paxos commit per RC
        group creates every record of the batch, then per-name StartEpochs
        run concurrently (BatchedCreateServiceName.java; issued by the
        client library which packs creates,
        ReconfigurableAppClientAsync.java:35)."""
        pkt.register_client(self.m.nodemap, p)
        sender = p.get("reply_to") or sender
        rid = p["rid"]
        # dedup by name: results are keyed by name, so duplicates would make
        # the completion count unreachable and strand the response
        creates = list({c["name"]: c for c in p.get("creates", [])}.values())
        if not creates:
            self.m.send(sender, {"type": pkt.CREATE_BATCH_RESPONSE,
                                 "rid": rid, "ok": False,
                                 "error": "empty_batch"})
            return
        results: Dict[str, dict] = {}
        total = len(creates)
        lock = threading.Lock()

        def name_done(n: str, entry: dict) -> None:
            with lock:
                if n in results:
                    return
                results[n] = entry
                finished = len(results) == total
            if finished:
                self.m.send(sender, {
                    "type": pkt.CREATE_BATCH_RESPONSE, "rid": rid,
                    "ok": all(r.get("ok") for r in results.values()),
                    "results": results,
                })

        # partition server-side by RC group: every partition is one commit
        parts: Dict[tuple, list] = {}
        for c in creates:
            key = tuple(self.rdb.rc_group_of(c["name"]))
            parts.setdefault(key, []).append({
                "name": c["name"],
                "actives": self.initial_actives(c["name"]),
                "initial_state": c.get("initial_state"),
            })

        # partitions whose group excludes this RC cannot commit here (a
        # non-member's proposal never fires its callback in Mode B):
        # delegate the sub-batch to that group's primary and fold its
        # response back into ours (_ensure_owner's batched analog)
        foreign = {g: e for g, e in parts.items()
                   if self.node_id not in g and not p.get("rc_fwd")}
        for group, entries in foreign.items():
            del parts[group]
            sub_rid = self._sub_rid()
            with self._lock:
                self._sub_batches[sub_rid] = [e["name"] for e in entries]

                def sub_done(results_by_name: dict, entries=entries) -> None:
                    for e in entries:
                        n = e["name"]
                        name_done(n, results_by_name.get(
                            n, {"ok": False, "error": "forward_failed"}
                        ))

                self._sub_done[sub_rid] = sub_done
            self.m.send(group[0], {
                "type": pkt.CREATE_BATCH, "rid": sub_rid, "rc_fwd": 1,
                "reply_to": self.node_id,
                "creates": [
                    {"name": e["name"],
                     "initial_state": e["initial_state"]}
                    for e in entries
                ],
            })

        for entries in parts.values():
            def committed(result: dict, entries=entries) -> None:
                if not result.get("ok"):
                    for e in entries:
                        name_done(e["name"], {
                            "ok": False,
                            "error": result.get("error", "failed"),
                        })
                    return
                per = result.get("results", {})
                for e in entries:
                    n = e["name"]
                    r = per.get(n, {"ok": False, "error": "failed"})
                    if not r.get("ok"):
                        name_done(n, dict(r))
                        continue
                    ep = int(r.get("epoch", 0))
                    self.executor.cancel(f"WaitAckStartEpoch:{n}:{ep}")
                    self.executor.schedule(WaitAckStartEpoch(
                        self, n, ep, e["actives"], -1, [],
                        pkt.b64d(e["initial_state"]) or b"",
                        lambda n=n, e=e: name_done(
                            n, {"ok": True, "actives": e["actives"]}
                        ),
                    ))

            self.rdb.commit(
                entries[0]["name"],
                {"op": "create_batch", "name": entries[0]["name"],
                 "creates": entries, "origin": self.node_id},
                committed, proposer=self.node_id,
            )

    def _sub_rid(self) -> int:
        with self._lock:
            self._sub_next += 1
            return self._sub_next

    def _on_create_batch_response(self, sender: str, p: dict) -> None:
        """Fold a delegated sub-batch's response into the original batch."""
        with self._lock:
            self._sub_batches.pop(p.get("rid"), None)
            hook = self._sub_done.pop(p.get("rid"), None)
        if hook is None:
            return
        hook(p.get("results") or {})

    # ------------------------------------------------------------ name delete
    def _on_delete(self, sender: str, p: dict) -> None:
        pkt.register_client(self.m.nodemap, p)
        sender = p.get("reply_to") or sender
        name, rid = p["name"], p["rid"]
        if not self._ensure_owner(name, sender, p):
            return

        def committed(result: dict) -> None:
            if not result.get("ok"):
                self.m.send(sender, {
                    "type": pkt.DELETE_RESPONSE, "rid": rid, "name": name,
                    "ok": False, "error": result.get("error", "failed"),
                })
                return
            rec = self.db.get(name)
            epoch = rec.epoch if rec is not None else int(result.get("epoch", 0))
            actives = list(rec.actives) if rec is not None else []

            def stopped() -> None:
                def deleted(res: dict) -> None:
                    self.m.send(sender, {
                        "type": pkt.DELETE_RESPONSE, "rid": rid, "name": name,
                        "ok": bool(res.get("ok")),
                    })

                def dropped() -> None:
                    # the record stays WAIT_DELETE until the old epoch's
                    # state is GC'd everywhere (or the drop task ages out —
                    # the MAX_FINAL_STATE_AGE grace), so a recreate at epoch
                    # 0 can never race an in-flight drop of the old instance
                    self.rdb.commit(
                        name, {"op": "delete_complete", "name": name},
                        deleted, proposer=self.node_id,
                    )

                if actives:
                    self.executor.schedule(
                        WaitAckDropEpoch(self, name, epoch, actives, dropped)
                    )
                else:
                    dropped()

            if actives:
                self.executor.schedule(
                    WaitAckStopEpoch(self, name, epoch, actives, stopped)
                )
            else:
                stopped()

        self.rdb.commit(
            name, {"op": "delete_intent", "name": name, "now": time.time()},
            committed, proposer=self.node_id,
        )

    # -------------------------------------------------------- actives lookup
    def _on_request_actives(self, sender: str, p: dict) -> None:
        pkt.register_client(self.m.nodemap, p)
        sender = p.get("reply_to") or sender
        name, rid = p["name"], p["rid"]
        if name != pkt.ALL_ACTIVES and not self._ensure_owner(name, sender, p):
            return
        if name == pkt.ALL_ACTIVES:
            # anycast pool resolution: the whole active set, no record
            # (ReconfigurableAppClientAsync.ALL_ACTIVES)
            addrs = {}
            for a in self.actives_pool:
                addr = self.m.nodemap(a)
                if addr is not None:
                    addrs[a] = [addr[0], addr[1]]
            self.m.send(sender, {
                "type": pkt.ACTIVES_RESPONSE, "rid": rid, "name": name,
                "ok": True, "epoch": -1, "actives": list(self.actives_pool),
                "addrs": addrs,
            })
            return
        rec = self.db.get(name)
        if rec is None or rec.state == RCState.WAIT_DELETE:
            self.m.send(sender, {
                "type": pkt.ACTIVES_RESPONSE, "rid": rid, "name": name,
                "ok": False, "error": "unknown_name",
            })
            return
        addrs = {}
        for a in rec.actives:
            addr = self.m.nodemap(a)
            if addr is not None:
                addrs[a] = [addr[0], addr[1]]
        self.m.send(sender, {
            "type": pkt.ACTIVES_RESPONSE, "rid": rid, "name": name, "ok": True,
            "epoch": rec.epoch, "actives": list(rec.actives), "addrs": addrs,
        })

    # -------------------------------------------------------- reconfiguration
    def _on_demand_report(self, sender: str, p: dict) -> None:
        """handleDemandReport (Reconfigurator.java:332): aggregate, ask the
        policy, and (primary only) kick off a migration."""
        name = p["name"]
        with self._lock:
            prof = self._profiles.get(name)
            if prof is None:
                prof = self._profiles[name] = self.profile_factory(name)
            prof.combine(p["stats"])
        if self.rdb.primary_of(name) != self.node_id:
            return
        rec = self.db.get(name)
        if rec is None or not rec.can_reconfigure():
            return
        new_actives = prof.reconfigure(list(rec.actives), self.actives_pool)
        if new_actives:
            new_actives = [a for a in new_actives if a in self.actives_pool]
        if new_actives and sorted(new_actives) != sorted(rec.actives):
            self._reconfigure(name, sorted(new_actives), on_done=prof.just_reconfigured)

    def _on_client_reconfigure(self, sender: str, p: dict) -> None:
        pkt.register_client(self.m.nodemap, p)
        sender = p.get("reply_to") or sender
        name, rid = p["name"], p["rid"]
        if not self._ensure_owner(name, sender, p):
            return
        requested = p.get("new_actives") or []
        bad = [a for a in requested if a not in self.actives_pool]
        if not requested or bad:
            # committing an unknown/empty active set would brick the name:
            # the old epoch gets stopped but no reachable new epoch starts
            self.m.send(sender, {
                "type": pkt.RECONFIGURE_RESPONSE, "rid": rid, "name": name,
                "ok": False, "error": f"bad_actives:{','.join(bad) or 'empty'}",
            })
            return
        rec = self.db.get(name)
        if rec is None or not rec.can_reconfigure():
            self.m.send(sender, {
                "type": pkt.RECONFIGURE_RESPONSE, "rid": rid, "name": name,
                "ok": False,
                "error": "unknown_name" if rec is None else "busy",
            })
            return

        def done() -> None:
            self.m.send(sender, {
                "type": pkt.RECONFIGURE_RESPONSE, "rid": rid, "name": name,
                "ok": True, "actives": sorted(p["new_actives"]),
            })

        ok = self._reconfigure(name, sorted(p["new_actives"]), on_done=done)
        if not ok:
            self.m.send(sender, {
                "type": pkt.RECONFIGURE_RESPONSE, "rid": rid, "name": name,
                "ok": False, "error": "busy",
            })

    def _reconfigure(self, name: str, new_actives: List[str],
                     on_done: Optional[Callable[[], None]] = None) -> bool:
        """Drive READY -> intent -> stop old -> complete -> start new
        (§3.4's full chain).  Returns False if the intent can't be placed."""
        rec = self.db.get(name)
        if rec is None or not rec.can_reconfigure():
            return False

        def intent_committed(result: dict) -> None:
            if not result.get("ok"):
                return  # raced with another workflow; watchdogs cover it
            self._drive_stop_then_start(name, on_done)

        self.rdb.commit(
            name,
            {"op": "reconfigure_intent", "name": name,
             "new_actives": new_actives},
            intent_committed, proposer=self.node_id,
        )
        return True

    def _drive_stop_then_start(
        self, name: str, on_done: Optional[Callable[[], None]] = None
    ) -> None:
        """From a committed WAIT_ACK_STOP record, run the rest of the epoch
        change.  Used by both the primary path and failover resume.

        Ordering: stop old -> start new -> commit reconfigure_complete ->
        GC old.  The complete is committed only after a majority of the new
        epoch acked StartEpoch, so the record stays WAIT_ACK_STOP for the
        whole in-flight window — which is exactly what lets
        WaitPrimaryExecution on any RC re-drive the workflow from the record
        alone if the driving RC crashes at any point (every step below is
        idempotent)."""
        rec = self.db.get(name)
        if rec is None or rec.state != RCState.WAIT_ACK_STOP:
            return
        old_epoch, old_actives = rec.epoch, list(rec.actives)
        new_actives = list(rec.new_actives)

        def stopped() -> None:
            def started() -> None:
                def completed(result: dict) -> None:
                    # ok=False means another RC completed it first — the
                    # epoch changed either way, so GC and finish
                    self.executor.schedule(
                        WaitAckDropEpoch(self, name, old_epoch, old_actives)
                    )
                    if on_done is not None:
                        on_done()

                self.rdb.commit(
                    name,
                    {"op": "reconfigure_complete", "name": name,
                     "epoch": old_epoch},
                    completed, proposer=self.node_id,
                )

            self.executor.schedule(WaitAckStartEpoch(
                self, name, old_epoch + 1, new_actives,
                old_epoch, old_actives, None, started,
            ))

        self.executor.schedule(
            WaitAckStopEpoch(self, name, old_epoch, old_actives, stopped)
        )

    def _resume_workflow(self, name: str) -> None:
        """Failover entry (WaitPrimaryExecution takeover): re-drive whatever
        the record state says is unfinished."""
        rec = self.db.get(name)
        if rec is None:
            return
        if rec.state == RCState.WAIT_ACK_STOP:
            self._drive_stop_then_start(name)
        elif rec.state == RCState.WAIT_DELETE:
            def stopped() -> None:
                def dropped() -> None:
                    # same drop-before-delete_complete gating as the primary
                    # delete path: a recreate at epoch 0 must never race an
                    # in-flight drop of the old instance
                    self.rdb.commit(
                        name, {"op": "delete_complete", "name": name},
                        proposer=self.node_id,
                    )
                self.executor.schedule(WaitAckDropEpoch(
                    self, name, rec.epoch, list(rec.actives), dropped
                ))
            self.executor.schedule(WaitAckStopEpoch(
                self, name, rec.epoch, list(rec.actives), stopped
            ))

    # ------------------------------------------------------- node elasticity
    def _on_node_config(self, sender: str, p: dict) -> None:
        """handleReconfigureRCNodeConfig analog (Reconfigurator.java:1044):
        add/remove an active node at runtime.  The change commits through
        the all-RC node-config record, so every reconfigurator updates its
        pool/ring deterministically from the commit stream; names placed on
        a removed node are migrated away as ordinary reconfigurations."""
        pkt.register_client(self.m.nodemap, p)
        node, rid = p.get("node"), p.get("rid")

        def reject(error: str) -> None:
            self.m.send(sender, {
                "type": pkt.NODE_CONFIG_RESPONSE, "rid": rid, "ok": False,
                "error": error,
            })

        if not node:
            reject("need node")
            return
        removing = p["type"] == pkt.REMOVE_ACTIVE
        if removing:
            if node not in self.actives_pool:
                reject("unknown_node")
                return
            if len(self.actives_pool) - 1 < self.k:
                # shrinking below replicas_per_name would silently
                # under-replicate every migrated name
                reject("pool_too_small")
                return
        cmd = {"op": "remove_active" if removing else "add_active",
               "name": NC_RECORD, "node": node, "addr": p.get("addr"),
               "seed_pool": sorted(self.actives_pool), "min_pool": self.k}

        def committed(result: dict) -> None:
            self.m.send(sender, {
                "type": pkt.NODE_CONFIG_RESPONSE, "rid": rid,
                "ok": bool(result.get("ok")), "node": node,
                "pool": result.get("pool"),
                # the committed replica-slot order: the operator puts this
                # in the new node's properties (``universe=...``) so its
                # boot slot indices match the incumbents'
                "universe": result.get("universe"),
            })

        self.rdb.commit(NC_RECORD, cmd, committed, proposer=self.node_id)

    def _apply_node_config(self, cmd: dict, record: Optional[dict]) -> None:
        node = cmd["node"]
        pool = sorted(record["actives"]) if record else self.actives_pool
        with self._lock:
            self.actives_pool = pool
            self.actives_ring = ConsistentHashRing(pool)
        if cmd["op"] == "add_active":
            addr = cmd.get("addr")
            if addr:
                # overwrite unconditionally: a node removed and re-added at
                # a new address must not keep its stale routing entry
                self.m.nodemap.add(node, addr[0], int(addr[1]))
            # push the committed slot order to every active so Mode B data
            # planes grow their replica universe in lockstep (idempotent:
            # each broadcast carries the complete order AND every address
            # this RC can resolve, so a server that missed an earlier add
            # catches up on both the slots and the routing from the next)
            universe = (record or {}).get("universe") or pool
            self._universe_committed = list(universe)
            self._broadcast_universe()
            # keep re-broadcasting at a low rate: an active partitioned
            # across THIS add would otherwise only converge when a future
            # add triggers the next broadcast
            self.executor.schedule(UniverseGossipTask(self))
            return
        # removal: drain the node with a retrying task, not a one-shot pass —
        # names mid-reconfiguration (or whose primary is down) at commit time
        # must still be migrated once they quiesce
        self.executor.schedule(NodeDrainTask(self, node))

    def _broadcast_universe(self) -> None:
        """Send the committed replica-slot order + resolvable addresses to
        every pool member (idempotent; see _apply_node_config)."""
        universe = getattr(self, "_universe_committed", None)
        if not universe:
            return
        addrs = {}
        for nid in universe:
            a_ = self.m.nodemap(nid)
            if a_ is not None:
                addrs[nid] = list(a_)
        for a in self.actives_pool:
            try:
                self.m.send(a, {
                    "type": "nc_universe_apply",
                    "universe": list(universe), "addrs": addrs,
                })
            except Exception:  # a down active learns from its WAL/boot
                pass

    def _drain_node_once(self, node: str) -> int:
        """One drain sweep: migrate off ``node`` every name this RC should
        drive.  Returns how many names still reference the node."""
        remaining = 0
        pool = self.actives_pool
        for name in self.db.names():
            rec = self.db.get(name)
            if rec is None or node not in rec.actives:
                continue
            remaining += 1
            primary = self.rdb.primary_of(name)
            drive = primary == self.node_id or not self.is_node_up(primary)
            if not drive or not rec.can_reconfigure():
                continue
            keep = [a for a in rec.actives if a != node]
            spare = [a for a in pool if a not in keep]
            new = sorted(keep + spare[: max(0, len(rec.actives) - len(keep))])
            if new and sorted(new) != sorted(rec.actives):
                self._reconfigure(name, new)
        return remaining

    # -------------------------------------------------- RC-node elasticity
    def _on_rc_node_config(self, sender: str, p: dict) -> None:
        """handleReconfigureRCNodeConfig (Reconfigurator.java:1044), RC
        side: splice a reconfigurator in/out of the pool.  The change
        commits on the all-RC ``_NC_RC`` record; every RC then updates its
        ring deterministically from the commit stream and re-homes records
        whose consistent-hash group changed (``RCMigrateTask``)."""
        pkt.register_client(self.m.nodemap, p)
        sender = p.get("reply_to") or sender
        node, rid = p.get("node"), p.get("rid")

        def reject(error: str) -> None:
            self.m.send(sender, {
                "type": pkt.NODE_CONFIG_RESPONSE, "rid": rid, "ok": False,
                "error": error,
            })

        if not node:
            reject("need node")
            return
        removing = p["type"] == pkt.REMOVE_RC
        pool = set(self.rdb.rc_ids)
        if removing and node not in pool:
            reject("unknown_node")
            return
        if removing and len(pool) - 1 < self.rdb.k:
            reject("pool_too_small")
            return
        if not removing and p.get("addr"):
            # learn the newcomer's address before the commit fans out
            self.m.nodemap.add(node, p["addr"][0], int(p["addr"][1]))
        cmd = {"op": "remove_rc" if removing else "add_rc",
               "name": NC_RC_RECORD, "node": node, "addr": p.get("addr"),
               "seed_pool": sorted(pool), "min_pool": self.rdb.k}

        def committed(result: dict) -> None:
            self.m.send(sender, {
                "type": pkt.NODE_CONFIG_RESPONSE, "rid": rid,
                "ok": bool(result.get("ok")), "node": node,
                "pool": result.get("pool"),
            })

        self.rdb.commit(NC_RC_RECORD, cmd, committed, proposer=self.node_id)

    def _apply_rc_node_config(self, cmd: dict, record: Optional[dict]) -> None:
        node = cmd["node"]
        pool = sorted(record["actives"]) if record else self.rdb.rc_ids
        if cmd["op"] == "add_rc":
            addr = cmd.get("addr")
            if addr:
                self.m.nodemap.add(node, addr[0], int(addr[1]))
            self.rdb.bind_rc(node)
        # splice the shared ring once (several Reconfigurator listeners may
        # share one rdb in-process; update_pool is idempotent)
        if sorted(pool) != sorted(self.rdb.rc_ids):
            self.rdb.update_pool(pool)
        epoch = record["epoch"] if record else 0
        self.executor.cancel(f"RCMigrate:{epoch}")
        self.executor.schedule(RCMigrateTask(self, epoch))

    def _rc_migrate_once(self) -> int:
        """One re-home sweep: install every local record whose new RC group
        this node primaries (or whose primary is down) into that group.
        Returns how many installs were issued (0 = converged)."""
        issued = 0
        pool_key = tuple(self.rdb.rc_ids)
        for name in self.db.names() + [NC_RECORD]:
            rec = self.db.get(name)
            if rec is None:
                continue
            # EVERY holder installs (no primary gate): after a splice the
            # re-homed group's primary may be the fresh node, which holds
            # nothing — only the old holders can carry the record over.
            # Duplicates are cheap no-op commits, deduped per holder below.
            key = (pool_key, name, rec.epoch)
            if key in self._rc_migrated:
                continue

            # confirm-on-success only: a lost proposal (no callback) keeps
            # the key unmarked, so the next sweep re-issues the idempotent
            # install instead of silently abandoning the record
            def installed(result: dict, key=key) -> None:
                if result.get("ok"):
                    self._rc_migrated.add(key)

            # re-commit into the (possibly new) group; the install is a
            # no-op wherever an equal-or-newer record already exists
            self.rdb.commit(
                name,
                {"op": "record_install", "name": name,
                 "record": rec.to_dict()},
                installed, proposer=self.node_id,
            )
            issued += 1
        # reincarnation tombstones re-home too: without them a recreate in
        # the new group would restart at epoch 0 and the old incarnation's
        # late DropEpoch could destroy it (see rc_db tombstones)
        for name, ep in list(self.db.tombstones.items()):
            key = (pool_key, name, "tomb", ep)
            if key in self._rc_migrated:
                continue

            def t_installed(result: dict, key=key) -> None:
                if result.get("ok"):
                    self._rc_migrated.add(key)

            self.rdb.commit(
                name,
                {"op": "tombstone_install", "name": name, "epoch": ep},
                t_installed, proposer=self.node_id,
            )
            issued += 1
        return issued

    # --------------------------------------------------------- commit events
    def _on_db_commit(self, cmd: dict, record: Optional[dict]) -> None:
        """Listener on this node's DB replica: non-primary RC-group members
        arm the failover watchdog when they see an intent commit."""
        name = cmd.get("name")
        if name is None:
            return
        if name == NC_RECORD:
            if cmd.get("op") in ("add_active", "remove_active"):
                self._apply_node_config(cmd, record)
            return
        if name == NC_RC_RECORD:
            if cmd.get("op") in ("add_rc", "remove_rc"):
                self._apply_rc_node_config(cmd, record)
            return
        op = cmd.get("op")
        if op == "delete_complete":
            with self._lock:
                self._profiles.pop(name, None)
            # kill any lingering start/drop tasks for the dead name so a
            # later recreate at epoch 0 neither collides on task keys nor
            # gets zombie-resurrected by a stale backup StartEpoch
            for key in self.executor.pending():
                if key.split(":")[0] in (
                    "WaitAckStartEpoch", "WaitPrimaryExecution"
                ) and key.split(":")[1:-1] == name.split(":"):
                    self.executor.cancel(key)
            return
        in_group = self.node_id in self.rdb.rc_group_of(name)
        if op in ("reconfigure_intent", "delete_intent"):
            if in_group and self.rdb.primary_of(name) != self.node_id:
                epoch = record["epoch"] if record else 0
                self.executor.schedule(WaitPrimaryExecution(self, name, epoch))
        elif op == "create_batch":
            if cmd.get("origin") == self.node_id:
                return
            created = cmd.get("_created") or {}
            for c in cmd.get("creates", []):
                n = c["name"]
                if n not in created:
                    # "exists" outcome: the record belongs to a live
                    # incarnation — a creation StartEpoch with the batch's
                    # stale initial_state would clobber it
                    continue
                if self.node_id not in self.rdb.rc_group_of(n):
                    continue
                t = WaitAckStartEpoch(
                    self, n, created[n], c["actives"], -1, [],
                    pkt.b64d(c.get("initial_state")) or b"", None,
                )
                t.first_delayed = True
                t.period_s = 2.0
                self.executor.cancel(t.key)
                self.executor.schedule(t)
        elif op == "create" and record is not None:
            if (in_group and cmd.get("origin") != self.node_id
                    and name in (cmd.get("_created") or {})):
                # backup creation driver: if the origin RC dies before its
                # StartEpochs go out, this (delayed, idempotent) task still
                # births the created group.  Gated on _created: an "exists"
                # outcome's record belongs to a live incarnation that this
                # command's stale initial_state must never touch
                t = WaitAckStartEpoch(
                    self, name, record["epoch"], record["actives"], -1, [],
                    pkt.b64d(cmd.get("initial_state")) or b"", None,
                )
                t.first_delayed = True
                t.period_s = 2.0
                # evict a stale same-key backup from a deleted incarnation
                # (it would otherwise block this one and push stale state)
                self.executor.cancel(t.key)
                self.executor.schedule(t)
