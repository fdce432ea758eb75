"""Mode B bindings into the reconfiguration control plane.

Two classes make a per-process :class:`~gigapaxos_tpu_torch.modeb.ModeBNode` a
full deployment unit the way the reference's per-machine ``PaxosManager``
is (``reconfiguration/ReconfigurableNode.java:259-336``):

* :class:`ModeBReplicaCoordinator` — the ``AbstractReplicaCoordinator`` SPI
  over a local ModeBNode, so an ``ActiveReplica`` drives epochs/requests on
  an independent per-process data plane exactly as it does on the shared
  Mode A plane (``PaxosReplicaCoordinator.java:36`` analog);
* :class:`ModeBRepliconfigurableDB` — the RC-record commit path over a
  local ModeBNode whose app is this reconfigurator's
  :class:`~gigapaxos_tpu_torch.reconfiguration.rc_db.ReconfiguratorDB` replica
  ("the control plane runs *on* the data plane",
  ``RepliconfigurableReconfiguratorDB.java:54``) — RC state replicates
  across RC *processes* via Mode B frames.

Epoch naming matches the Mode A coordinator: epoch e of ``name`` is the
group ``name#e`` (one live epoch per name; the stopped previous epoch stays
fetchable until dropped, ``PaxosInstanceStateMachine.java:1678-1684``).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

from .. import overload as _ov
from ..paxos.paystore import PayloadStore
from ..reconfiguration.consistent_hashing import ConsistentHashRing
from ..reconfiguration.coordinator import AbstractReplicaCoordinator
from ..reconfiguration.rc_db import (
    NC_RC_RECORD,
    NC_RECORD,
    RC_GROUP_PREFIX,
    ReconfiguratorDB,
)
from .manager import ModeBNode


class ModeBReplicaCoordinator(AbstractReplicaCoordinator):
    """Bind the coordination SPI to one process's ModeBNode.

    The node's ``members`` list is the active-node universe; group
    membership is a subset of those replica slots.  Unlike Mode A (where
    one coordinator object serves every node id in-process), each process
    owns exactly one of these — ``node_id == node.node_id``.
    """

    def __init__(self, node: ModeBNode):
        self.node = node
        # every group on the AR plane is an epoch group whose birth must be
        # seeded by StartEpoch — whois self-birthing would create it empty
        # and silently lose the previous epoch's carried state
        node.whois_birth = lambda _name: False
        # content-addressed interning at the SPI ingress: hot-key fan-out
        # proposes the same body over and over; one shared bytes object per
        # unique body keeps outstanding/payload tables and the WAL dedup
        # epoch identity-stable (the Mode B face of paxos/paystore.py)
        self._paystore = PayloadStore()
        self.node_ids = list(node.members)
        self._slot: Dict[str, int] = {n: i for i, n in enumerate(self.node_ids)}
        # runtime node additions append replica slots; keep the id<->slot
        # view in lockstep (ReconfigureActiveNodeConfig analog)
        node.on_expand.append(self._on_expand)
        self._epoch: Dict[str, int] = {}
        # recovery: the node's rows came back from its own journal; rebuild
        # the live-epoch map from the `name#e` namespace (highest epoch wins
        # — the roll-forward of initiateRecovery, PaxosManager.java:1852)
        for pname, _row in node.rows.items():
            name, _, e = pname.rpartition("#")
            if not name:
                continue
            try:
                epoch = int(e)
            except ValueError:
                continue
            if epoch > self._epoch.get(name, -1):
                self._epoch[name] = epoch

    def _on_expand(self, _fresh) -> None:
        self.node_ids = list(self.node.members)
        self._slot = {n: i for i, n in enumerate(self.node_ids)}

    # ----------------------------------------------------------------- naming
    @staticmethod
    def _pax_name(name: str, epoch: int) -> str:
        return f"{name}#{epoch}"

    def slot_of(self, node_id: str) -> Optional[int]:
        return self._slot.get(node_id)

    def current_epoch(self, name: str) -> Optional[int]:
        return self._epoch.get(name)

    # ------------------------------------------------------------------- SPI
    def coordinate_request(
        self,
        name: str,
        epoch: int,
        payload: bytes,
        callback: Optional[Callable[[int, Optional[bytes]], None]] = None,
        entry: Optional[str] = None,
        deadline: Optional[int] = None,
    ) -> Optional[int]:
        if self._epoch.get(name) != epoch:
            return None  # wrong/old epoch: client must re-resolve actives
        pname = self._pax_name(name, epoch)
        # pre-check so a stopped/unknown group returns None (AR replies
        # not_active) instead of also firing the callback with a failure —
        # the entry node is this process, so no entry-slot indirection.
        # A tainted row (awaiting checkpoint repair) must not serve either:
        # its app copy is not authoritative yet — the client rotates to a
        # caught-up member meanwhile.
        if (self.node.rows.row(pname) is None or self.node.is_stopped(pname)
                or self.node.is_tainted(pname)):
            return None
        if isinstance(payload, bytes):
            payload = self._paystore.intern(payload)
        return self.node.propose(pname, payload, callback,
                                 deadline=deadline, cls=_ov.CLS_CLIENT)

    @property
    def intake_governor(self):
        """The node's IntakeGovernor (None when overload control is off) —
        the AR pre-checks it so scalar sheds NACK at ingress."""
        return getattr(self.node, "overload", None)

    def create_replica_group(
        self, name: str, epoch: int, initial_state: bytes, nodes: List[str],
        tainted: bool = False,
    ) -> bool:
        slots = [self._slot[n] for n in nodes if n in self._slot]
        if not slots:
            return False
        pname = self._pax_name(name, epoch)
        # birth + seed + taint atomically vs the tick AND messenger
        # threads: a decision executing between birth and seed would read
        # pre-seed state, and a peer's checkpoint request between birth
        # and taint would be DONATED the empty pre-state — which the peer
        # adopts, clears its own taint with, and re-donates (an
        # empty-state cascade that loses the epoch's data for good)
        with self.node.lock:
            ok = self.node.create_group(pname, slots, epoch)
            if not ok:
                return False
            # seed app state on THIS member only — every member process
            # runs its own StartEpoch (the reference delivers StartEpoch
            # per active too)
            self.node.app.restore(pname, initial_state)
            if tainted:
                # born without the carried state (previous epoch GC'd
                # under us): never serve or donate until checkpoint
                # transfer from a caught-up member of THIS epoch repairs
                self.node.mark_tainted(pname)
        live = self._epoch.get(name)
        if live is None or epoch > live:
            self._epoch[name] = epoch
        return True

    def delete_replica_group(self, name: str, epoch: int) -> bool:
        pname = self._pax_name(name, epoch)
        ok = self.node.remove_group(pname)
        if self._epoch.get(name) == epoch:
            del self._epoch[name]
        return ok

    def get_replica_group(self, name: str) -> Optional[List[str]]:
        e = self._epoch.get(name)
        if e is None:
            return None
        slots = self.node.group_members(self._pax_name(name, e))
        if slots is None:
            return None
        return [self.node_ids[s] for s in slots]

    # ------------------------------------------------------- epoch-change SPI
    def stop_replica_group(
        self, name: str, epoch: int, done: Callable[[bool], None]
    ) -> bool:
        if self._epoch.get(name) != epoch:
            done(self._epoch.get(name, -1) > epoch)
            return True
        pname = self._pax_name(name, epoch)
        if self.node.is_stopped(pname):
            done(True)
            return True

        def cb(rid: int, resp: Optional[bytes]) -> None:
            done(True)  # an earlier stop winning the race still stops it

        rid = self.node.propose_stop(pname, callback=cb)
        return rid is not None

    def get_final_state(self, name: str, epoch: int) -> Optional[bytes]:
        """Local-only donor check: in Mode B each process can vouch only for
        its own app copy.  Executing the stop implies executing everything
        before it (in-order phase 4), so a locally-stopped, untainted row IS
        the epoch-final state; otherwise return None and the fetch task
        round-robins to another previous active (WaitEpochFinalState).

        Atomic against :meth:`drop_final_state` (node lock): without it, a
        drop interleaving between the stopped-check and the checkpoint can
        free the app table first, making this donor serve found=True with
        EMPTY state — the asker then births the new epoch empty+untainted
        and silently diverges (the reference's null-checkpoint
        disambiguation hazard, PaxosManager.java:383-390)."""
        pname = self._pax_name(name, epoch)
        with self.node.lock:
            if not self.node.is_stopped(pname) or self.node.is_tainted(pname):
                return None
            return self.node.app.checkpoint(pname)

    def final_state_gone(self, name: str, epoch: int) -> bool:
        """True when this node can say the epoch's final state is GONE for
        good (dropped by GC) rather than merely not-stopped-yet.  A gone
        answer implies the reconfiguration COMPLETE committed (drop runs
        only after it), hence a majority of the NEW epoch holds the real
        state — the asker may safely birth tainted and repair from them."""
        pname = self._pax_name(name, epoch)
        with self.node.lock:
            if self.node.rows.row(pname) is not None:
                return False  # still hosted (stopped or not): transient
            if pname in getattr(self.node, "_paused", ()):
                return False  # spilled (ChainModeBNode has no pause tier)
            live = self._epoch.get(name, -1)
            # hosted later epoch, or dropped our last epoch entirely
            return live > epoch or live == -1

    def drop_final_state(self, name: str, epoch: int) -> bool:
        pname = self._pax_name(name, epoch)
        with self.node.lock:  # atomic vs get_final_state (see its docstring)
            if self._epoch.get(name) == epoch:
                del self._epoch[name]
            # remove the row BEFORE freeing app state: a donor query after
            # this block sees no row -> None (+ final_state_gone=True, the
            # safe tainted-birth path), never a freed app's empty
            # checkpoint.  A PAUSED (spilled) group counts as present — its
            # _paused record would otherwise keep answering is_stopped
            # forever while the app table below is freed
            # getattr: this binding also runs over ChainModeBNode
            # (server.py coordinator == "chain"), which has no pause tier
            present = (self.node.rows.row(pname) is not None
                       or pname in getattr(self.node, "_paused", ()))
            ok = self.node.remove_group(pname) if present else True
            self.node.app.restore(pname, b"")  # free app state
            return ok


class ModeBRepliconfigurableDB:
    """RC-record commit path over a per-process RC-plane ModeBNode.

    Same surface the :class:`~gigapaxos_tpu_torch.reconfiguration.reconfigurator.
    Reconfigurator` drives on the Mode A flavor (``commit`` / ``rc_group_of``
    / ``primary_of`` / ``db_of``), but the node's app is the ONE local
    ReconfiguratorDB replica and commits replicate to the other RC processes
    over frames.  RC paxos groups are created lazily on first commit; peer
    RCs that have not created the group self-heal via whois when its first
    frame arrives (missed-birthing, PaxosManager.java:2459-2469).
    """

    def __init__(self, node: ModeBNode, rc_ids: List[str], k: int = 3):
        self.node = node
        #: the process UNIVERSE (node.members) is fixed at boot; the live
        #: POOL may be a subset and may grow back toward the universe at
        #: runtime (pre-provisioned elasticity: list future RC ids in the
        #: topology, start their processes later, then add_reconfigurator)
        self.rc_ids = sorted(rc_ids)
        self._slot = {n: i for i, n in enumerate(node.members)}
        node.on_expand.append(
            lambda _fresh: self._slot.update(
                {n: i for i, n in enumerate(node.members)}
            )
        )
        self.ring = ConsistentHashRing(self.rc_ids)
        self.k = min(k, len(self.rc_ids))
        db = node.app
        if isinstance(db, ReconfiguratorDB):
            db.scope = (
                lambda sname, gname: self._pax_group(self.rc_group_of(sname))
                == gname
            )

    # ---------------------------------------------------------------- groups
    def rc_group_of(self, name: str) -> List[str]:
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
        self.node.create_group(gname, slots)  # idempotent (False if exists)
        return gname

    # ---------------------------------------------------------------- commit
    def commit(
        self,
        name: str,
        cmd: dict,
        callback: Optional[Callable[[dict], None]] = None,
        proposer: Optional[str] = None,
    ) -> Optional[int]:
        gname = self._ensure_group(self.rc_group_of(name))

        def cb(rid: int, resp: Optional[bytes]) -> None:
            if callback is None:
                return
            if resp is None:
                callback({"ok": False, "error": "failed"})
            else:
                callback(json.loads(resp.decode()))

        return self.node.propose(
            gname, json.dumps(cmd).encode(),
            cb if callback is not None else None,
        )

    def db_of(self, rc_id: str) -> ReconfiguratorDB:
        if rc_id != self.node.node_id:
            raise KeyError(
                f"Mode B process {self.node.node_id} has no local DB replica "
                f"for {rc_id}"
            )
        return self.node.app

    # ------------------------------------------------- RC-node elasticity
    def bind_rc(self, node_id: str):
        """Mode B flavor: an RC id can only be activated if it was
        pre-provisioned in the boot universe (node.members) — replica slots
        of independent processes cannot be conjured at runtime.  Returns
        the slot, or None for an unknown id (the splice still updates the
        ring; an unprovisioned id simply never wins proposals)."""
        return self._slot.get(node_id)

    def unbind_rc(self, node_id: str):
        return self._slot.get(node_id)  # universe membership is static

    def update_pool(self, pool) -> None:
        """Splice the ring to the committed RC pool (records re-home via
        RCMigrateTask, exactly as in Mode A)."""
        self.rc_ids = sorted(pool)
        self.ring = ConsistentHashRing(self.rc_ids)
        self.k = min(self.k, max(1, len(self.rc_ids)))
