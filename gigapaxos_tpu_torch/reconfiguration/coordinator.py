"""The replica-coordination SPI and its Paxos binding.

``AbstractReplicaCoordinator`` analog
(``reconfiguration/AbstractReplicaCoordinator.java:51-74``): the narrow
interface the reconfiguration layer drives —
``coordinate_request`` / ``create_replica_group`` / ``delete_replica_group``
plus the epoch-change helpers (stop, final-state fetch/restore).

``PaxosReplicaCoordinator`` (``PaxosReplicaCoordinator.java:36``) binds the
SPI to the dense-device ``PaxosManager``.  Epochs: the reference creates
paxos instances keyed (name, version); the dense manager keys rows by flat
string, so epoch e of service ``name`` lives in paxos group ``name#e``
(``_pax_name``).  One epoch is live per name at a time; the stopped previous
epoch's final state stays fetchable until dropped
(``copyEpochFinalCheckpointState``, PaxosInstanceStateMachine.java:1678-1684).

Node identity: the reconfiguration layer speaks string node ids; the device
speaks replica-slot ints.  The coordinator owns that mapping (``slot_of``)
— the IntegerMap idea (paxosutil/IntegerMap.java:40) applied to nodes.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, List, Optional

from .. import overload as _ov
from ..paxos.manager import PaxosManager


class AbstractReplicaCoordinator(abc.ABC):
    """Subclasses choose the coordination protocol (paxos, chain, ...).

    The reconfiguration layer (ActiveReplica) only ever calls these."""

    @abc.abstractmethod
    def coordinate_request(
        self,
        name: str,
        epoch: int,
        payload: bytes,
        callback: Optional[Callable[[int, Optional[bytes]], None]] = None,
        entry: Optional[str] = None,
    ) -> Optional[int]:
        """Totally order + execute one request in the name's current epoch.
        Returns a request id or None (unknown name / wrong epoch)."""

    @abc.abstractmethod
    def create_replica_group(
        self, name: str, epoch: int, initial_state: bytes, nodes: List[str],
        tainted: bool = False,
    ) -> bool:
        """``tainted``: the epoch is born WITHOUT its authoritative state
        (the previous epoch's final state was GC'd before this member could
        fetch it) — the member must not serve or donate until the plane's
        checkpoint-transfer repair pulls the state from a caught-up peer
        of the NEW epoch."""
        ...

    @abc.abstractmethod
    def delete_replica_group(self, name: str, epoch: int) -> bool:
        ...

    @abc.abstractmethod
    def get_replica_group(self, name: str) -> Optional[List[str]]:
        ...

    # ------------------------------------------------------- epoch-change SPI
    @abc.abstractmethod
    def stop_replica_group(
        self, name: str, epoch: int, done: Callable[[bool], None]
    ) -> bool:
        """Propose the epoch-final stop; ``done(ok)`` fires when the stop
        commits (all further proposals in the epoch are fenced)."""

    @abc.abstractmethod
    def get_final_state(self, name: str, epoch: int) -> Optional[bytes]:
        """Checkpoint of a *stopped* epoch (None until stopped/unknown)."""

    @abc.abstractmethod
    def drop_final_state(self, name: str, epoch: int) -> bool:
        """GC a stopped epoch's state (DropEpochFinalState)."""


class PaxosReplicaCoordinator(AbstractReplicaCoordinator):
    def __init__(self, manager: PaxosManager, node_ids: List[str]):
        """``node_ids[r]`` is the node occupying device replica slot r (the
        sorted active set in Mode A)."""
        self.manager = manager
        self.node_ids = list(node_ids)
        self._slot: Dict[str, int] = {n: i for i, n in enumerate(node_ids)}
        self._epoch: Dict[str, int] = {}  # name -> live epoch

    # ----------------------------------------------------------------- naming
    @staticmethod
    def _pax_name(name: str, epoch: int) -> str:
        return f"{name}#{epoch}"

    def slot_of(self, node_id: str) -> Optional[int]:
        return self._slot.get(node_id)

    def bind_node(self, node_id: str) -> Optional[int]:
        """Bind a new node id to a spare replica slot (runtime active-node
        add).  Replica slots are provisioned mesh-axis capacity: the manager
        was built with R slots, and elasticity binds/unbinds node ids to
        them — the dense-plane framing of ReconfigureActiveNodeConfig."""
        if node_id in self._slot:
            return self._slot[node_id]
        used = set(self._slot.values())
        for s in range(self.manager.R):
            if s not in used:
                self._slot[node_id] = s
                while len(self.node_ids) <= s:
                    self.node_ids.append(None)
                self.node_ids[s] = node_id
                return s
        return None  # no spare slots provisioned

    def unbind_node(self, node_id: str) -> Optional[int]:
        """Release a removed node's replica slot so it can be rebound.
        Control-plane only: any group rows still naming the slot are
        expected to have been migrated away first (the slot stays dead
        until rebound, so stragglers merely see one dead member)."""
        s = self._slot.pop(node_id, None)
        if s is not None and s < len(self.node_ids):
            self.node_ids[s] = None
        return s

    def current_epoch(self, name: str) -> Optional[int]:
        return self._epoch.get(name)

    def adopt_live_epochs(self) -> int:
        """Rebuild the name -> live-epoch map from a WAL-recovered manager.

        ``wal.logger.recover`` reproduces the manager's rows and paused set,
        but a coordinator constructed over it starts with an empty epoch map
        and would answer "not_active" for every recovered group.  Scan live
        + paused paxos names for ``name#epoch``, skip stopped epochs (their
        final state stays fetchable, they are not live), and adopt the max
        epoch per name.  Idempotent; a no-op on a fresh manager.  Returns
        how many names were adopted."""
        m = self.manager
        with m.lock:
            pnames = list(m.rows.names()) + [
                n for n in m._paused if n not in m.rows
            ]
            adopted = 0
            for pname in pnames:
                base, sep, etxt = pname.rpartition("#")
                if not sep or not base:
                    continue
                try:
                    epoch = int(etxt)
                except ValueError:
                    continue
                if m.is_stopped(pname):
                    continue
                cur = self._epoch.get(base)
                if cur is None or epoch > cur:
                    self._epoch[base] = epoch
                    adopted += 1
        return adopted

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
        slot = self._slot.get(entry) if entry is not None else None
        return self.manager.propose(
            self._pax_name(name, epoch), payload, callback, entry=slot,
            deadline=deadline, cls=_ov.CLS_CLIENT,
        )

    def coordinate_read(
        self,
        name: str,
        epoch: int,
        payload: bytes,
        callback: Optional[Callable[[int, Optional[bytes]], None]] = None,
        deadline: Optional[int] = None,
    ) -> Optional[int]:
        """Read-path twin of :meth:`coordinate_request`: answered from the
        lease holder's app when ``read_leases`` is on and the lease
        validates (rid 0), else a CLS_READ consensus round through the
        ordered stream."""
        if self._epoch.get(name) != epoch:
            return None  # wrong/old epoch: client must re-resolve actives
        return self.manager.read(
            self._pax_name(name, epoch), payload, callback, deadline=deadline,
        )

    @property
    def intake_governor(self):
        """The manager's overload governor (None when disabled) — the edge
        (ActiveReplica) consults it to NACK client work before decoding."""
        return getattr(self.manager, "overload", None)

    @property
    def supports_batch_sink(self) -> bool:
        """Columnar completion applies to the host-app bulk path; the
        device app's responses already ride its packed tick columns
        through per-rid callbacks."""
        return not getattr(self.manager, "_device_app", False)

    def coordinate_requests_batch(self, items, entry: Optional[str] = None,
                                  batch_sink=None):
        """Batch twin of :meth:`coordinate_request` feeding the manager's
        vectorized propose path (one columnar admission for the whole
        frame instead of a per-request staged propose).

        items: (name, epoch, payload, callback) tuples.  Returns a list of
        rids aligned with items (-1 = rejected: wrong epoch / unknown row /
        admission backpressure; no callback fires for those).

        ``batch_sink(offsets, responses_or_None)``: columnar completion —
        delivered in per-tick batches for the ADMITTED subset (offsets
        index it in item order) instead of one Python callback per
        request; per-item callbacks are ignored when a sink is given.
        Host-app path only (the device path returns responses through its
        own packed columns already)."""
        import numpy as np

        slot = self._slot.get(entry) if entry is not None else None
        rows = np.empty(len(items), np.int64)
        # cache keyed by (name, epoch): a batch straddling a reconfiguration
        # must reject stale-epoch entries exactly like coordinate_request
        row_cache: Dict[tuple, int] = {}
        payloads, cbs = [], []
        reject = []
        for i, (name, epoch, payload, cb) in enumerate(items):
            row = row_cache.get((name, epoch))
            if row is None:
                if self._epoch.get(name) != epoch:
                    row = -1
                else:
                    row = self.manager.rows.row(self._pax_name(name, epoch))
                    if row is None:
                        row = -1
                row_cache[(name, epoch)] = row
            if row < 0:
                reject.append(i)
            rows[i] = row
            payloads.append(payload)
            cbs.append(cb)
        sel = rows >= 0
        out = np.full(len(items), -1, np.int64)
        if sel.any():
            sel_payloads = [p for p, s in zip(payloads, sel) if s]
            sel_cbs = [c for c, s in zip(cbs, sel) if s]
            if getattr(self.manager, "_device_app", False):
                # device app: payloads ARE 12-byte descriptors; decode the
                # frame column by column and admit through the kv path.  A
                # malformed payload rejects individually (-3): it must not
                # black-hole the frame's valid requests
                from ..models.device_kv import DESC_LEN

                good = np.fromiter(
                    (len(p) == DESC_LEN for p in sel_payloads),
                    bool, len(sel_payloads),
                )
                si = np.nonzero(sel)[0]
                out[si[~good]] = -3
                if good.any():
                    gp = [p for p, g in zip(sel_payloads, good) if g]
                    d = np.frombuffer(b"".join(gp), np.int32).reshape(-1, 3)
                    out[si[good]] = self.manager.propose_bulk_kv(
                        rows[sel][good], d[:, 0], d[:, 1], d[:, 2],
                        callbacks=[c for c, g in zip(sel_cbs, good) if g],
                        entries=slot,
                    )
            else:
                out[sel] = self.manager.propose_bulk(
                    rows[sel], sel_payloads,
                    callbacks=None if batch_sink is not None else sel_cbs,
                    entries=slot, batch_sink=batch_sink,
                )
        return list(out)

    def create_replica_group(
        self, name: str, epoch: int, initial_state: bytes, nodes: List[str],
        tainted: bool = False,
    ) -> bool:
        # Mode A note: the shared in-process plane seeds every member from
        # one create, so the tainted fallback (remote final state GC'd)
        # cannot leave this plane stateless — accepted and ignored.
        slots = [self._slot[n] for n in nodes if n in self._slot]
        if not slots:
            return False
        pname = self._pax_name(name, epoch)
        # birth + seed atomically vs the tick thread (reentrant lock): an
        # execution between them would read/write pre-seed app state that
        # the restore then silently overwrites
        with self.manager.lock:
            ok = self.manager.create_paxos_instance(pname, slots, epoch)
            if not ok:
                return False
            # seed app state on every member replica (StartEpoch's
            # final-state hand-off; b"" = fresh name)
            for s in slots:
                self.manager.apps[s].restore(pname, initial_state)
        live = self._epoch.get(name)
        if live is None or epoch > live:
            self._epoch[name] = epoch
        return True

    def create_replica_group_at(
        self, name: str, epoch: int, initial_state: bytes, nodes: List[str],
        row: int,
    ) -> bool:
        """Targeted-row twin of :meth:`create_replica_group` (placement
        migration: the row selects the destination mesh shard).  The seed
        rides the manager's journaled targeted create (OP_CREATE_AT) —
        unlike the plain path's caller-side restore, a migrated epoch's
        blob must survive WAL replay because the source epoch's copy is
        dropped right after."""
        slots = [self._slot[n] for n in nodes if n in self._slot]
        if not slots:
            return False
        pname = self._pax_name(name, epoch)
        with self.manager.lock:
            ok = self.manager.create_paxos_instance_at(
                pname, slots, epoch, row, app_seed=initial_state
            )
        if not ok:
            return False
        live = self._epoch.get(name)
        if live is None or epoch > live:
            self._epoch[name] = epoch
        return True

    def delete_replica_group(self, name: str, epoch: int) -> bool:
        pname = self._pax_name(name, epoch)
        ok = self.manager.remove_paxos_instance(pname)
        if self._epoch.get(name) == epoch:
            del self._epoch[name]
        return ok

    def get_replica_group(self, name: str) -> Optional[List[str]]:
        e = self._epoch.get(name)
        if e is None:
            return None
        slots = self.manager.group_members(self._pax_name(name, e))
        if slots is None:
            return None
        return [self.node_ids[s] for s in slots]

    # ------------------------------------------------------- epoch-change SPI
    def stop_replica_group(
        self, name: str, epoch: int, done: Callable[[bool], None]
    ) -> bool:
        if self._epoch.get(name) != epoch:
            # already moved on: stopping an old epoch is trivially complete
            done(self._epoch.get(name, -1) > epoch)
            return True
        pname = self._pax_name(name, epoch)
        if self.manager.is_stopped(pname):
            done(True)
            return True

        def cb(rid: int, resp: Optional[bytes]) -> None:
            # a stop request that fails (rid -1 / None resp) means some
            # earlier stop won the race — the epoch is stopped either way
            done(True)

        rid = self.manager.propose_stop(pname, callback=cb)
        return rid is not None

    def get_final_state(self, name: str, epoch: int) -> Optional[bytes]:
        # Held under the manager lock to be atomic against
        # drop_final_state: a drop interleaving between the stopped-check
        # and the checkpoint would free the app table first and make this
        # donor serve found=True with EMPTY state — the asker then births
        # the new epoch empty+untainted and silently diverges (the
        # null-checkpoint disambiguation hazard, PaxosManager.java:383-390)
        pname = self._pax_name(name, epoch)
        with self.manager.lock:
            # pipelined mode: the device can be one tick ahead of the host
            # apps — the stop may have EXECUTED on device (is_stopped true,
            # watermarks advanced) while the final decisions of the epoch
            # sit in the undrained outbox.  Checkpointing the donor app now
            # would ship a state missing those writes; the lock is
            # re-entrant so the drain completes them here, atomically with
            # the donor selection below.  (ChainManager has no pipeline —
            # its ticks complete synchronously — hence the getattr.)
            drain = getattr(self.manager, "drain_pipeline", None)
            if drain is not None:
                drain()
            if not self.manager.is_stopped(pname):
                return None
            members = self.manager.group_members(pname)
            if not members:
                return None
            # The donor must be a member at the group's maximum execution
            # watermark: a just-revived laggard is alive but holds pre-stop
            # state, and checkpointing it would seed the next epoch with
            # lost writes.  If only dead members hold the final state,
            # return None and let the fetch task retry
            # (WaitEpochFinalState).
            marks = self.manager.exec_watermarks(pname)
            if marks is None:
                return None
            final = max(marks[s] for s in members)
            for s in members:
                if self.manager.alive[s] and marks[s] == final:
                    return self.manager.apps[s].checkpoint(pname)
            return None

    def drop_final_state(self, name: str, epoch: int) -> bool:
        pname = self._pax_name(name, epoch)
        with self.manager.lock:  # atomic vs get_final_state (see above)
            members = self.manager.group_members(pname) or []
            # dropping the live epoch (name deletion) must clear the epoch
            # map, or a later re-creation at epoch 0 looks like a duplicate
            # StartEpoch
            if self._epoch.get(name) == epoch:
                del self._epoch[name]
            # remove the row BEFORE freeing app state: a donor query after
            # this block sees no row -> None (the safe retry/tainted-birth
            # path), never a freed app's empty checkpoint.  A PAUSED
            # (spilled) group counts as present — its _paused record would
            # otherwise keep answering is_stopped/exec_watermarks forever
            # getattr: ChainManager shares this binding but has no pause
            # tier (chain/coordinator.py duck-types the manager surface)
            present = (self.manager.rows.row(pname) is not None
                       or pname in getattr(self.manager, "_paused", ()))
            ok = self.manager.remove_paxos_instance(pname) if present else True
            for s in members:
                self.manager.apps[s].restore(pname, b"")  # free app state
            return ok
