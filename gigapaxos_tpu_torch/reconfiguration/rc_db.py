"""The reconfigurator database — itself replicated on the data plane.

Reference analogs:

* ``AbstractReconfiguratorDB.java:77`` — application semantics over
  per-name :class:`ReconfigurationRecord`s, driven by deterministic
  RCRecordRequest commands;
* ``RepliconfigurableReconfiguratorDB.java:54`` — wraps that DB in a
  ``PaxosReplicaCoordinator`` so reconfigurator state is itself
  paxos-replicated ("the control plane runs *on* the data plane",
  SURVEY §3.4);
* ``SQLReconfiguratorDB.java:93`` — durability, which here falls out of the
  data plane's own WAL (commands are replayed into the DB app on recovery).

Design: :class:`ReconfiguratorDB` is a :class:`Replicable` whose requests
are JSON commands (create / delete_intent / delete_complete /
reconfigure_intent / reconfigure_complete).  One DB replica lives on each
reconfigurator node; commands commit through the RC nodes' own
:class:`PaxosManager`, one paxos group per consistent-hash RC group —
exactly the reference's RC group scheme (``ConsistentHashing.java:40-64``),
so a name's record is replicated on the k reconfigurators that own it.

Each DB replica invokes ``listener(command, record_dict)`` after applying a
command, which is how a Reconfigurator learns about commits it did not
propose (the basis of primary-failover, WaitPrimaryExecution.java:60).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Dict, List, Optional

from ..models.replicable import Replicable
from ..paxos.manager import PaxosManager
from .consistent_hashing import ConsistentHashRing
from .records import RCState, ReconfigurationRecord

#: paxos-group-name prefix for RC-group instances
RC_GROUP_PREFIX = "_RC:"
#: the special node-config record/group replicated on ALL reconfigurators
#: (the reference's AbstractReconfiguratorDB.RecordNames.AR_NODES)
NC_RECORD = "_NC"
#: the reconfigurator-pool record (RecordNames.RC_NODES — RC-node
#: add/remove at runtime, Reconfigurator.handleReconfigureRCNodeConfig:1044)
NC_RC_RECORD = "_NC_RC"


class ReconfiguratorDB(Replicable):
    """One reconfigurator node's replica of the record database.

    ``execute`` is deterministic over (records, command) — every replica of
    an RC group derives identical records from the committed command stream.
    Non-state inputs (wall time for delete aging) ride inside the command.
    """

    def __init__(self, node_id: str = "?"):
        self.node_id = node_id
        self.records: Dict[str, ReconfigurationRecord] = {}
        #: deleted names -> their final epoch (reincarnation tombstones).
        #: A recreate continues at tombstone+1 so the OLD incarnation's
        #: still-in-flight DropEpoch (async AR-side GC) can never address —
        #: and destroy — the new incarnation's data-plane group.  The
        #: reference retains deleted records for MAX_FINAL_STATE the same
        #: way.  Applied inside the replicated command stream, so every RC
        #: replica derives identical epochs.  Never evicted: any
        #: size-triggered eviction order would depend on how THIS node's
        #: several RC groups' command streams interleaved locally —
        #: non-deterministic across replicas — and a tombstone is ~50
        #: bytes per deleted name ever (recreates reclaim theirs).
        self.tombstones: Dict[str, int] = {}
        self._lock = threading.RLock()
        #: called (command_dict, record_dict_or_none) after each apply
        self.listener: Optional[Callable[[dict, Optional[dict]], None]] = None
        #: scope(service_name, paxos_group_name) -> bool; installed by
        #: RepliconfigurableReconfiguratorDB so checkpoint/restore of one RC
        #: paxos group only touches the records that group owns (a node in
        #: several RC groups must not clobber one group's records with a
        #: checkpoint of another's)
        self.scope: Optional[Callable[[str, str], bool]] = None

    # ----------------------------------------------------------- inspection
    def get(self, name: str) -> Optional[ReconfigurationRecord]:
        with self._lock:
            return self.records.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(n for n in self.records if n != NC_RECORD)

    # ------------------------------------------------------------ Replicable
    def execute(self, name: str, request: bytes, request_id: int) -> bytes:
        cmd = json.loads(request.decode())
        with self._lock:
            result = self._apply(cmd)
        if self.listener is not None:
            rec = self.get(cmd.get("name", ""))
            try:
                self.listener(cmd, rec.to_dict() if rec is not None else None)
            except Exception:
                # a listener bug must not poison the deterministic apply
                # (execute runs on the data-plane tick thread) — but it must
                # be visible: it can silently disable failover watchdogs
                logging.getLogger("gigapaxos_tpu_torch.rc_db").exception(
                    "DB listener failed on %s", cmd.get("op")
                )
        return json.dumps(result).encode()

    def _apply(self, cmd: dict) -> dict:
        op = cmd["op"]
        name = cmd["name"]
        rec = self.records.get(name)
        if op in ("add_rc", "remove_rc"):
            if name != NC_RC_RECORD:
                return {"ok": False, "error": "nc_rc_only"}
            if rec is None:
                rec = self.records[name] = ReconfigurationRecord(
                    name=name, actives=sorted(cmd.get("seed_pool", []))
                )
            node = cmd["node"]
            pool = set(rec.actives)  # the RC pool rides the actives field
            if op == "add_rc":
                pool.add(node)
            else:
                pool.discard(node)
                min_pool = int(cmd.get("min_pool", 1))
                if len(pool) < min_pool:
                    return {"ok": False, "error": "pool_too_small",
                            "pool": rec.actives}
            rec.actives = sorted(pool)
            rec.epoch += 1
            return {"ok": True, "pool": rec.actives, "epoch": rec.epoch}
        if op == "tombstone_install":
            # idempotent tombstone carry-over into a re-homed RC group (the
            # record_install twin for deleted names)
            if rec is not None:
                # the name was recreated meanwhile: its live record already
                # supersedes the tombstone
                return {"ok": True, "installed": False}
            ep = int(cmd["epoch"])
            if self.tombstones.get(name, -1) < ep:
                self.tombstones[name] = ep
            return {"ok": True, "installed": True}
        if op == "record_install":
            # idempotent record carry-over into a re-homed RC group after a
            # ring splice (the reference re-hashes record ownership the same
            # way when RC nodes change, Reconfigurator.java:1044)
            incoming = ReconfigurationRecord.from_dict(cmd["record"])
            if rec is not None and rec.epoch >= incoming.epoch:
                return {"ok": True, "installed": False, "epoch": rec.epoch}
            self.records[name] = incoming
            return {"ok": True, "installed": True, "epoch": incoming.epoch}
        if op in ("add_active", "remove_active"):
            if name != NC_RECORD:
                # node-config ops are only valid on the NC record; applied to
                # a service record they would desync its epoch from the live
                # paxos group and brick the name
                return {"ok": False, "error": "nc_only"}
            # node-config change on the NC record: rec.actives is the active
            # POOL (ReconfigureActiveNodeConfig analog); per-name membership
            # changes flow as ordinary reconfigurations afterwards
            if rec is None:
                # first NC change: seed the pool with the boot topology
                # (carried in the committed command so every replica derives
                # the identical record)
                rec = self.records[name] = ReconfigurationRecord(
                    name=name, actives=sorted(cmd.get("seed_pool", []))
                )
            node = cmd["node"]
            pool = set(rec.actives)
            if not rec.universe:
                # seed the ordered slot universe from the boot topology
                # (sorted — every node derives the same boot order)
                rec.universe = sorted(cmd.get("seed_pool", rec.actives))
            if op == "add_active":
                if (node not in rec.universe
                        and len(rec.universe) >= (1 << 6)):
                    # the rid encoding carries the replica slot in 6 bits
                    # (modeb/common.py RID_SHIFT): reject HERE, inside the
                    # totally ordered apply, or the commit would succeed
                    # while every data plane refuses to expand
                    return {"ok": False, "error": "universe_full",
                            "pool": rec.actives}
                pool.add(node)
                if node not in rec.universe:
                    # replica-slot order is append-only and totally ordered
                    # by this commit stream: Mode B universes derive their
                    # slot indices from it (expand_universe appends)
                    rec.universe.append(node)
            else:
                pool.discard(node)
                # the shrink invariant must hold HERE, inside the totally
                # ordered apply — the RC-side pre-check is only advisory
                # (two concurrent removals can each pass it)
                min_pool = int(cmd.get("min_pool", 0))
                if len(pool) < min_pool:
                    return {"ok": False, "error": "pool_too_small",
                            "pool": rec.actives}
                # the node leaves the placement POOL but its slot is never
                # recycled (a re-add reuses the same slot index)
            rec.actives = sorted(pool)
            rec.epoch += 1  # NC epoch counts config versions
            return {"ok": True, "pool": rec.actives, "epoch": rec.epoch,
                    "universe": list(rec.universe)}
        if op in ("placement_set", "placement_clear",
                  "placement_set_cell", "placement_clear_cell"):
            # placement-override table (placement/table.py): overrides ride
            # the special _PLACEMENT record's rc_epochs map, so they are
            # replicated and checkpointed like every other record.  The
            # import is deferred: reconfiguration.__init__ imports this
            # module, and placement.table imports consistent_hashing back.
            from ..placement.table import (PLACEMENT_RECORD,
                                           apply_placement_command)

            if name != PLACEMENT_RECORD:
                return {"ok": False, "error": "placement_record_only"}
            return apply_placement_command(
                self.records, cmd,
                lambda n: ReconfigurationRecord(name=n),
            )
        if op == "create":
            if rec is not None:
                return {"ok": False, "error": "exists", "epoch": rec.epoch}
            rec = ReconfigurationRecord(
                name=name,
                epoch=max(int(cmd.get("epoch", 0)),
                          self.tombstones.pop(name, -1) + 1),
                actives=sorted(cmd["actives"]),
            )
            self.records[name] = rec
            # side-channel for the commit LISTENER (same decoded dict): the
            # backup creation drivers must fire ONLY for names this command
            # actually created — an "exists" name's record belongs to a
            # live (possibly reconfigured) incarnation that a stale-state
            # creation StartEpoch would clobber
            cmd["_created"] = {name: rec.epoch}
            return {"ok": True, "epoch": rec.epoch}
        if op == "create_batch":
            # one committed command creates every record of the batch
            # (BatchedCreateServiceName.java applied atomically per RC group)
            results = {}
            created = {}
            for c in cmd.get("creates", []):
                n = c["name"]
                if n in self.records:
                    results[n] = {"ok": False, "error": "exists",
                                  "epoch": self.records[n].epoch}
                else:
                    ep = self.tombstones.pop(n, -1) + 1
                    self.records[n] = ReconfigurationRecord(
                        name=n, epoch=ep, actives=sorted(c["actives"]),
                    )
                    results[n] = {"ok": True, "epoch": ep}
                    created[n] = ep
            cmd["_created"] = created  # see the "create" op's note
            return {"ok": True, "results": results}
        if rec is None:
            return {"ok": False, "error": "unknown"}
        if op == "reconfigure_intent":
            # READY -> WAIT_ACK_STOP (RCRecordRequest RECONFIGURATION_INTENT)
            ok = rec.set_intent(cmd["new_actives"])
            return {"ok": ok, "epoch": rec.epoch,
                    "state": rec.state.value}
        if op == "reconfigure_complete":
            # WAIT_ACK_STOP -> READY @ epoch+1 (RECONFIGURATION_COMPLETE);
            # guarded so duplicate completes (failover re-runs) are no-ops
            if rec.state != RCState.WAIT_ACK_STOP or (
                rec.epoch != int(cmd["epoch"])
            ):
                return {"ok": False, "error": "wrong_state",
                        "state": rec.state.value, "epoch": rec.epoch}
            ok = rec.set_complete()
            return {"ok": ok, "epoch": rec.epoch}
        if op == "delete_intent":
            ok = rec.set_delete_intent(now=cmd.get("now"))
            return {"ok": ok, "state": rec.state.value, "epoch": rec.epoch}
        if op == "delete_complete":
            if rec.state != RCState.WAIT_DELETE:
                return {"ok": False, "error": "wrong_state",
                        "state": rec.state.value}
            self.tombstones[name] = rec.epoch
            del self.records[name]
            return {"ok": True}
        return {"ok": False, "error": f"bad op {op}"}

    def _in_scope(self, service_name: str, group_name: str) -> bool:
        return self.scope is None or self.scope(service_name, group_name)

    def checkpoint(self, name: str) -> bytes:
        with self._lock:
            return json.dumps({
                "__rcdb__": 2,
                "recs": {
                    n: r.to_dict() for n, r in self.records.items()
                    if self._in_scope(n, name)
                },
                "tombs": {
                    n: e for n, e in self.tombstones.items()
                    if self._in_scope(n, name)
                },
            }).encode()

    def restore(self, name: str, state: bytes) -> None:
        with self._lock:
            kept = {
                n: r for n, r in self.records.items()
                if not self._in_scope(n, name)
            }
            kept_t = {
                n: e for n, e in self.tombstones.items()
                if not self._in_scope(n, name)
            }
            if state:
                d = json.loads(state.decode())
                if isinstance(d, dict) and d.get("__rcdb__") == 2:
                    recs, tombs = d["recs"], d.get("tombs", {})
                else:  # pre-tombstone checkpoint: flat record map
                    recs, tombs = d, {}
                kept.update({
                    n: ReconfigurationRecord.from_dict(rd)
                    for n, rd in recs.items()
                })
                kept_t.update({n: int(e) for n, e in tombs.items()})
            self.records = kept
            self.tombstones = kept_t


class RepliconfigurableReconfiguratorDB:
    """The commit path: one shared RC-side PaxosManager whose replica slots
    are the reconfigurator nodes and whose apps are their DB replicas.

    RC paxos groups are created lazily per consistent-hash group (the
    reference creates them eagerly at boot from the ring,
    RepliconfigurableReconfiguratorDB.java:54); group ``_RC:A:B:C`` has
    members {A,B,C}.  ``commit`` proposes a command to the group owning the
    name and fires ``callback(result_dict)`` when it executes on the
    proposer's DB replica.
    """

    def __init__(
        self,
        manager: PaxosManager,
        rc_ids: List[str],
        k: int = 3,
    ):
        self.manager = manager
        self.rc_ids = sorted(rc_ids)
        self._slot = {n: i for i, n in enumerate(self.rc_ids)}
        self.ring = ConsistentHashRing(self.rc_ids)
        self.k = min(k, len(self.rc_ids))
        for app in manager.apps:
            if isinstance(app, ReconfiguratorDB):
                app.scope = (
                    lambda sname, gname: self._pax_group(self.rc_group_of(sname))
                    == gname
                )

    # ---------------------------------------------------------------- groups
    def rc_group_of(self, name: str) -> List[str]:
        """The k reconfigurators owning ``name`` (its RC group).  The
        node-config records are replicated on ALL reconfigurators (the
        reference's RC_NODES/AR_NODES groups span every RC,
        ReconfigurableNode.java:180-188)."""
        if name in (NC_RECORD, NC_RC_RECORD):
            return list(self.rc_ids)
        return self.ring.replicated_servers(name, self.k)

    def primary_of(self, name: str) -> str:
        return self.rc_group_of(name)[0]

    def _pax_group(self, rcs: List[str]) -> str:
        return RC_GROUP_PREFIX + ":".join(sorted(rcs))

    def _ensure_group(self, rcs: List[str]) -> str:
        gname = self._pax_group(rcs)
        slots = [self._slot[r] for r in rcs]
        self.manager.create_paxos_instance(gname, slots)  # idempotent (False if exists)
        return gname

    # ---------------------------------------------------------------- commit
    def commit(
        self,
        name: str,
        cmd: dict,
        callback: Optional[Callable[[dict], None]] = None,
        proposer: Optional[str] = None,
    ) -> Optional[int]:
        """Paxos-commit one record command for ``name``; the callback gets
        the decoded result dict (or ``{"ok": False, "error": "failed"}``)."""
        gname = self._ensure_group(self.rc_group_of(name))
        entry = self._slot.get(proposer) if proposer else None

        def cb(rid: int, resp: Optional[bytes]) -> None:
            if callback is None:
                return
            if resp is None:
                callback({"ok": False, "error": "failed"})
            else:
                callback(json.loads(resp.decode()))

        return self.manager.propose(
            gname, json.dumps(cmd).encode(),
            cb if callback is not None else None, entry=entry,
        )

    def db_of(self, rc_id: str) -> ReconfiguratorDB:
        return self.manager.apps[self._slot[rc_id]]

    # ------------------------------------------------- RC-node elasticity
    def bind_rc(self, node_id: str) -> Optional[int]:
        """Bind a new reconfigurator id to a spare RC-plane replica slot
        (the manager must have been provisioned with spare slots)."""
        if node_id in self._slot:
            return self._slot[node_id]
        used = set(self._slot.values())
        for s in range(self.manager.R):
            if s not in used:
                self._slot[node_id] = s
                app = self.manager.apps[s]
                if isinstance(app, ReconfiguratorDB):
                    app.node_id = node_id
                    app.scope = (
                        lambda sname, gname:
                        self._pax_group(self.rc_group_of(sname)) == gname
                    )
                return s
        return None

    def unbind_rc(self, node_id: str) -> Optional[int]:
        return self._slot.pop(node_id, None)

    def update_pool(self, pool: List[str]) -> None:
        """Splice the consistent-hash ring to a committed RC pool.  Slots
        for departed nodes stay bound until ``unbind_rc`` so in-flight
        commits through old groups still resolve."""
        self.rc_ids = sorted(pool)
        self.ring = ConsistentHashRing(self.rc_ids)
