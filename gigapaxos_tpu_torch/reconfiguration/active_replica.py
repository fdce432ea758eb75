"""ActiveReplica: the data-plane node's control-plane face.

Analog of ``reconfiguration/ActiveReplica.java:131``: wraps a replica
coordinator and executes the epoch lifecycle ops sent by reconfigurators —

* ``handleStartEpoch`` (:891)  → :meth:`_on_start_epoch` (create the new
  epoch's group, fetching the previous epoch's final state if needed via
  ``WaitEpochFinalState``, reconfigurationprotocoltasks/WaitEpochFinalState.java:47);
* ``handleStopEpoch`` (:1012) → :meth:`_on_stop_epoch` (propose the epoch
  stop through the coordinator, ack when the fence commits);
* ``handleDropEpochFinalState`` (:1063) → :meth:`_on_drop_epoch`;
* ``handleRequestEpochFinalState`` (:1179) → :meth:`_on_request_final_state`;
* ``handleEchoRequest`` (:1126) → :meth:`_on_echo`;

plus the client-facing app-request path (coordinate + respond) and
demand reporting (``DemandReport`` sends to the name's RC group, §3.4).

Device shape: many ActiveReplica objects (one per active node id) share one
dense-device coordinator in-process — the node ids are replica *slots* of
one device program, so "create group on 3 actives" is one row insertion with a
3-bit member mask, and a StartEpoch raced by several ARs is naturally
idempotent.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import overload as _ov
from ..net import binbatch
from ..net.bulk import BulkTransfer
from ..net.messenger import Messenger
from ..net.transport import SendFailure
from ..obs.metrics import registry as _obs_registry
from ..utils.reqtrace import xtracer as _xtracer
from ..protocoltask.executor import ProtocolExecutor, ProtocolTask
from . import packets as pkt
from .consistent_hashing import ConsistentHashRing
from .coordinator import AbstractReplicaCoordinator
from .demand import AbstractDemandProfile, DemandProfile


#: batch-admission rejection codes -> client-visible errors.  "busy" is
#: transient backpressure: retry at the SAME active (re-resolving actives
#: on it would storm the RC plane for nothing); "not_active" means
#: re-resolve; "bad_request" is permanent.
_REJECT = {1: "not_active", 2: "busy", 3: "bad_request"}


class WaitEpochFinalState(ProtocolTask):
    """Fetch a stopped epoch's final state from its previous actives, then
    create the new epoch's group (WaitEpochFinalState.java:47)."""

    period_s = 0.5
    max_restarts = 240  # big states take a while; the RC retries anyway
    #: after a bulk announcement, hold off re-requesting for this long —
    #: every duplicate request triggers a full re-send of the state
    announce_patience_s = 30.0

    #: never conclude "the previous epoch was GC'd" before this much real
    #: time: a denial burst can just be the previous actives' stops still
    #: executing under load, and a premature empty birth costs a repair
    give_up_floor_s = 12.0

    def __init__(self, ar: "ActiveReplica", packet: dict):
        self.ar = ar
        self.p = packet
        self._i = 0
        self._gone = False  # some previous active reported the state GC'd
        self._born = time.monotonic()
        self._announced_at: Optional[float] = None

    @property
    def key(self) -> str:
        return f"WaitEpochFinalState:{self.p['name']}:{self.p['epoch']}"

    def start(self):
        if self._announced_at is not None:
            if time.monotonic() - self._announced_at < self.announce_patience_s:
                return []  # chunks in flight; don't provoke duplicate sends
            self._announced_at = None  # transfer presumably died: re-request
        name, prev = self.p["name"], self.p["prev_epoch"]
        # our own copy may have materialized since the last round (this
        # member's stop executed late): never poll remotely for state we
        # hold locally
        state = self.ar.coord.get_final_state(name, prev)
        if state is not None:
            self.ar.executor.handle_event(
                self.key, {"found": True, "state_bytes": state}
            )
            return []
        targets = [a for a in self.p["prev_actives"] if a != self.ar.node_id]
        if not targets:
            return []
        # round-robin over previous actives until one has the state
        dest = targets[self._i % len(targets)]
        self._i += 1
        return [(dest, pkt.request_epoch_final_state(name, prev, self.ar.node_id))]

    def handle(self, event: dict):
        if not event.get("found"):
            # Liveness hole this guards (the root cause of the
            # migrate/recreate stalls): the complete commits at a MAJORITY
            # of AckStarts, after which WaitAckDropEpoch GCs the previous
            # epoch — a slow member (typically the newcomer, the one that
            # must fetch remotely) could then find NO donor forever and
            # serve not_active for good.  A donor distinguishes "not
            # stopped yet" (transient; keep polling — giving up here could
            # taint EVERY new member and lose the state) from "dropped by
            # GC" (gone=True).  Gone implies the complete committed, which
            # implies a MAJORITY of the new epoch holds the real state —
            # so it is provably safe to birth EMPTY + TAINTED and let the
            # data plane's checkpoint transfer repair this member from a
            # caught-up peer (the tainted row refuses to serve/donate
            # until then).
            self._gone = self._gone or bool(event.get("gone"))
            if (self._gone
                    and time.monotonic() - self._born
                    >= self.give_up_floor_s):
                # one more local check: our own stop may have completed
                # while we were polling remotely
                state = self.ar.coord.get_final_state(
                    self.p["name"], self.p["prev_epoch"]
                )
                if state is not None:
                    self.ar._create_started_epoch(self.p, state)
                else:
                    self.ar._create_started_epoch(self.p, b"", tainted=True)
                return [], True
            return [], False
        if "state_bytes" in event:  # assembled bulk transfer
            state = event["state_bytes"]
        elif event.get("bulk"):
            self._announced_at = time.monotonic()
            return [], False  # announced; the chunks are still in flight
        else:
            state = pkt.b64d(event.get("state")) or b""
        self.ar._create_started_epoch(self.p, state)
        return [], True

    def on_done(self) -> None:
        # max_restarts exhausted without a donor (every previous active
        # denied for the whole budget): last-resort tainted birth so the
        # member regains liveness; checkpoint repair or a later epoch
        # supersedes.  No-op when the fetch completed normally.
        cur = self.ar.coord.current_epoch(self.p["name"])
        if cur is None or cur < self.p["epoch"]:
            self.ar._create_started_epoch(self.p, b"", tainted=True)


class ActiveReplica:
    def __init__(
        self,
        node_id: str,
        messenger: Messenger,
        coordinator: AbstractReplicaCoordinator,
        rc_ids: List[str],
        demand_profile_factory: Callable[[str], AbstractDemandProfile] = DemandProfile,
        rc_group_size: int = 3,
    ):
        self.node_id = node_id
        self.m = messenger
        self.coord = coordinator
        self.rc_ring = ConsistentHashRing(rc_ids)
        self.rc_k = min(rc_group_size, max(1, len(rc_ids)))
        self.profile_factory = demand_profile_factory
        self._profiles: Dict[str, AbstractDemandProfile] = {}
        self._plock = threading.Lock()
        self.executor = ProtocolExecutor(self.m.send, name=f"ar-{node_id}")
        # chunked out-of-band channel for big epoch-final checkpoints
        # (LargeCheckpointer analog, paxosutil/LargeCheckpointer.java:39)
        self.bulk = BulkTransfer(self.m)
        self.bulk.register_prefix("efs:", self._on_bulk_final_state)
        # binary batched-request frames (SoA wire, net/binbatch.py); the
        # deduped GBR2 kind shares the handler — decode sniffs the magic
        binbatch.chain_bytes_handler(self.m.demux, binbatch.REQ_MAGIC,
                                     self._on_binary_batch)
        binbatch.chain_bytes_handler(self.m.demux, binbatch.REQ2_MAGIC,
                                     self._on_binary_batch)
        # response egress coalesced per (client, tick): the manager's
        # callback flush opens a scope, every bid finished inside it stages,
        # and each client's frames leave as one generation-stamped list
        self._egress = binbatch.ClientEgress(self.m)
        mgr = getattr(coordinator, "manager", None)
        if mgr is not None and hasattr(mgr, "_flush_scope_hooks"):
            mgr._flush_scope_hooks.append(self._egress.open_scope)
        # (client, rid) -> None while in flight, response packet once done;
        # absorbs same-rid retransmissions (GCConcurrentHashMap analog)
        self._req_dedup: "collections.OrderedDict[tuple, Optional[dict]]" = (
            collections.OrderedDict()
        )
        self._dedup_cap = 4096
        #: insertion time of in-flight (None) markers: markers whose client
        #: died before the callback ever fires must age out, or a map full
        #: of in-flight entries grows unbounded
        self._dedup_born: Dict[tuple, float] = {}
        self._dedup_inflight_ttl_s = 60.0
        self._dedup_lock = threading.Lock()
        #: anycast forwards awaiting an actives answer: qrid -> (reply_to, p)
        self._any_pending: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict()
        )
        self._any_lock = threading.Lock()
        self._any_next = 1 << 40  # disjoint from client rids
        #: server-side commit-latency SLO histogram: request arrival at this
        #: replica -> response release (covers propose + tick + WAL + flush)
        self._lat_h = _obs_registry().histogram(
            "commit_latency_seconds",
            help="AR-observed request->response latency", node=node_id)
        #: cross-process tracing hop: records whenever a frame carries a
        #: trace id (presence IS the flag — the client side gates stamping)
        self._xt = _xtracer()
        for ptype, h in [
            (pkt.APP_REQUEST, self._on_app_request),
            (pkt.APP_READ, self._on_app_read),
            (pkt.APP_REQUEST_BATCH, self._on_app_request_batch),
            (pkt.ACTIVES_RESPONSE, self._on_actives_response),
            (pkt.STOP_EPOCH, self._on_stop_epoch),
            (pkt.START_EPOCH, self._on_start_epoch),
            (pkt.DROP_EPOCH, self._on_drop_epoch),
            (pkt.REQUEST_EPOCH_FINAL_STATE, self._on_request_final_state),
            (pkt.EPOCH_FINAL_STATE, self._on_epoch_final_state),
            (pkt.ECHO_REQUEST, self._on_echo),
        ]:
            self.m.register(ptype, h)

    def close(self) -> None:
        self.executor.stop()
        self.m.close()

    # ------------------------------------------------------------ app requests
    def _on_app_request(self, sender: str, p: dict) -> None:
        pkt.register_client(self.m.nodemap, p)
        name, rid = p["name"], p["rid"]
        if _ov.expired(p.get("deadline")):
            # dead on arrival: the client already gave up — never propose,
            # never respond (count-once: this stage detected it)
            _ov.count_expired("ar_ingress", self.node_id)
            return
        # anycast entry (sendRequestAnycast, ReconfigurableAppClientAsync
        # :1357): the client sent to an arbitrary active; if we don't host
        # the name, resolve its actives from the RC plane and forward — the
        # hosting replica answers the client directly via reply_to
        reply_to = p.get("reply_to") or sender
        if (p.get("anycast") and not p.get("fwd")
                and self.coord.current_epoch(name) is None):
            tid = p.get("trace")
            if tid is not None:  # dict forwarded verbatim: the id survives
                self._xt.event(tid, "ar_forward", node=self.node_id, req=rid)
            self._anycast_forward(reply_to, p)
            return
        sender = reply_to
        # retransmission dedup: the client reuses its rid on retry, so a
        # duplicate arriving while the first copy is in flight is dropped
        # (its response will carry the same rid) and one arriving after
        # completion gets the cached response instead of a second proposal
        key = (sender, rid)
        dup, cached = self._dedup_check_insert(key)
        if dup:
            if cached is not None:
                self.m.send(sender, cached, cls=_ov.CLS_CLIENT)
            return
        try:
            self._handle_app_request(sender, p, key)
        except Exception:
            # never strand the in-flight marker: a parse error (e.g. corrupt
            # base64 payload) must not black-hole every retransmission of
            # this rid forever
            with self._dedup_lock:
                self._req_dedup.pop(key, None)
                self._dedup_born.pop(key, None)
            raise

    def _dedup_check_insert(self, key):
        """Dedup-map admission shared by the scalar and batch paths.
        Returns (is_duplicate, cached_response_or_None); on a miss inserts
        the in-flight marker and enforces the cap: evict the oldest
        COMPLETED entry — dropping a live in-flight (None) marker would
        let a retransmission of a slow request start the second proposal
        the map exists to prevent — and when all entries are in-flight,
        age out markers past the max plausible commit latency."""
        now = time.monotonic()
        with self._dedup_lock:
            if key in self._req_dedup:
                return True, self._req_dedup[key]
            self._req_dedup[key] = None
            self._dedup_born[key] = now
            if len(self._req_dedup) > self._dedup_cap:
                victim = None
                for k in self._req_dedup:
                    if self._req_dedup[k] is not None:
                        victim = k
                        break
                if victim is not None:
                    del self._req_dedup[victim]
                else:
                    stale = [
                        k for k, born in self._dedup_born.items()
                        if now - born > self._dedup_inflight_ttl_s
                    ]
                    for k in stale:
                        self._req_dedup.pop(k, None)
                        self._dedup_born.pop(k, None)
        return False, None

    def _dedup_clear(self, key) -> None:
        with self._dedup_lock:
            self._req_dedup.pop(key, None)
            self._dedup_born.pop(key, None)

    def _handle_app_request(self, sender: str, p: dict, key) -> None:
        name, rid = p["name"], p["rid"]
        t0 = time.perf_counter()
        tid = p.get("trace")
        if tid is not None:
            self._xt.event(tid, "ar_recv", node=self.node_id, req=rid,
                           name=name)
        epoch = self.coord.current_epoch(name)
        if epoch is None:
            self._finish_request(sender, key, {
                "type": pkt.APP_RESPONSE, "rid": rid, "ok": False,
                "error": "not_active", "name": name,
            }, cache=False)
            return
        # classed admission: the scalar propose path both fires the callback
        # AND returns None on refusal, so shed HERE (one response, at the
        # edge) rather than mapping the manager's held RID_BUSY callback
        gov = getattr(self.coord, "intake_governor", None)
        if gov is not None and not gov.admit(_ov.CLS_CLIENT):
            _ov.count_shed(_ov.CLS_CLIENT, "ar_ingress", self.node_id)
            self._finish_request(sender, key, {
                "type": pkt.APP_RESPONSE, "rid": rid, "ok": False,
                "error": "busy", "name": name,
            }, cache=False)
            return
        self._register_demand(name, sender, epoch)
        need = p.get("need_response", True)
        dl = p.get("deadline")
        dl = dl if isinstance(dl, int) and dl > 0 else None

        def cb(req_id: int, resp: Optional[bytes]) -> None:
            if req_id == _ov.RID_EXPIRED:
                # deadline passed mid-pipeline (counted by the detecting
                # stage): settle the marker, never respond
                self._dedup_clear(key)
                return
            if not need:
                # fire-and-forget: still resolve the marker (cache success so
                # a retransmit doesn't re-commit; clear on failure)
                ok = req_id >= 0 and resp is not None
                with self._dedup_lock:
                    if ok:
                        self._req_dedup[key] = {"type": pkt.APP_RESPONSE,
                                                "rid": rid, "ok": True,
                                                "name": name}
                    else:
                        self._req_dedup.pop(key, None)
                    self._dedup_born.pop(key, None)
                return
            ok = not (req_id < 0 or resp is None)
            if ok and _ov.expired(dl):
                # committed but nobody is waiting: drop the response
                _ov.count_expired("egress", self.node_id)
                self._dedup_clear(key)
                return
            self._lat_h.observe(time.perf_counter() - t0)
            if tid is not None:
                self._xt.event(tid, "ar_responded", node=self.node_id,
                               req=rid, ok=ok)
            if not ok:
                # busy = transient admission NACK (retry same active);
                # anything else = epoch stopped underneath us (re-resolve)
                err = "busy" if req_id == _ov.RID_BUSY else "stopped"
                self._finish_request(sender, key, {
                    "type": pkt.APP_RESPONSE, "rid": rid, "ok": False,
                    "error": err, "name": name,
                }, cache=False)
            else:
                self._finish_request(sender, key, {
                    "type": pkt.APP_RESPONSE, "rid": rid, "ok": True,
                    "name": name, "response": pkt.b64e(resp),
                }, cache=True)

        r = self.coord.coordinate_request(
            name, epoch, pkt.b64d(p["payload"]) or b"", cb,
            entry=self.node_id, deadline=dl,
        )
        if r is None:
            if need:
                self._finish_request(sender, key, {
                    "type": pkt.APP_RESPONSE, "rid": rid, "ok": False,
                    "error": "not_active", "name": name,
                }, cache=False)
            else:
                with self._dedup_lock:
                    self._req_dedup.pop(key, None)
                    self._dedup_born.pop(key, None)

    def _on_app_read(self, sender: str, p: dict) -> None:
        """Lease-era read entry.  Reads are side-effect-free by
        contract, so retransmissions are harmless — no dedup-map traffic:
        a retried rid simply reads again.  Responses reuse APP_RESPONSE
        (same client callback path) but travel CLS_READ, so a read flood
        backpressures reads without touching writes or control."""
        pkt.register_client(self.m.nodemap, p)
        name, rid = p["name"], p["rid"]
        if _ov.expired(p.get("deadline")):
            _ov.count_expired("ar_ingress", self.node_id)
            return
        reply_to = p.get("reply_to") or sender

        def refuse(err: str) -> None:
            self.m.send(reply_to, {
                "type": pkt.APP_RESPONSE, "rid": rid, "ok": False,
                "error": err, "name": name}, cls=_ov.CLS_READ)

        epoch = self.coord.current_epoch(name)
        if epoch is None:
            refuse("not_active")
            return
        gov = getattr(self.coord, "intake_governor", None)
        if gov is not None and not gov.admit(_ov.CLS_READ):
            _ov.count_shed(_ov.CLS_READ, "ar_ingress", self.node_id)
            refuse("busy")
            return
        dl = p.get("deadline")
        dl = dl if isinstance(dl, int) and dl > 0 else None

        def cb(req_id: int, resp: Optional[bytes]) -> None:
            if req_id == _ov.RID_EXPIRED:
                return  # counted by the detecting stage; never respond
            if req_id < 0 or resp is None:
                refuse("busy" if req_id == _ov.RID_BUSY else "stopped")
                return
            if _ov.expired(dl):
                _ov.count_expired("egress", self.node_id)
                return
            self.m.send(reply_to, {
                "type": pkt.APP_RESPONSE, "rid": rid, "ok": True,
                "name": name, "response": pkt.b64e(resp),
                "local": req_id == 0}, cls=_ov.CLS_READ)

        payload = pkt.b64d(p["payload"]) or b""
        read = getattr(self.coord, "coordinate_read", None)
        if read is not None:
            r = read(name, epoch, payload, cb, deadline=dl)
        else:
            # coordinator without a lease plane (chain/Mode-B shims):
            # plain consensus read through the ordered stream
            r = self.coord.coordinate_request(
                name, epoch, payload, cb, entry=self.node_id, deadline=dl)
        if r is None:
            refuse("not_active")

    def _on_app_request_batch(self, sender: str, p: dict) -> None:
        """Coalesced client edge: one frame of requests in, one frame of
        responses out (RequestPacket.java:189-233 ``batched[]``).  Dedup is
        batch-granular — the batch id, not each rid, keys the
        retransmission cache, so absorbing a retransmitted batch costs one
        map lookup instead of len(batch)."""
        pkt.register_client(self.m.nodemap, p)
        reply_to = p.get("reply_to") or sender
        bid = p["bid"]
        dl = p.get("deadline")
        if _ov.expired(dl):
            # whole frame dead on arrival: the client gave up already
            _ov.count_expired("ar_ingress", self.node_id,
                              n=len(p.get("reqs") or ()))
            return
        key = (reply_to, ("b", bid))
        dup, cached = self._dedup_check_insert(key)
        if dup:
            if cached is not None:
                self.m.send(reply_to, cached, cls=_ov.CLS_CLIENT)
            return
        reqs = p["reqs"]
        dl = dl if isinstance(dl, int) and dl > 0 else None
        if not reqs:
            self._dedup_clear(key)
            self.m.send(reply_to, {"type": pkt.APP_RESPONSE_BATCH,
                                   "bid": bid, "results": []},
                        cls=_ov.CLS_CLIENT)
            return
        results: list = [None] * len(reqs)
        lock = threading.Lock()
        remaining = [len(reqs)]
        settled = [False] * len(reqs)

        def finish() -> None:
            resp = {"type": pkt.APP_RESPONSE_BATCH, "bid": bid,
                    "results": results}
            # like the scalar path, only all-success frames are cached for
            # retransmission replay; a frame with transient failures clears
            # the marker so a retry can re-coordinate
            with self._dedup_lock:
                if all(r[1] for r in results):
                    self._req_dedup[key] = resp
                else:
                    self._req_dedup.pop(key, None)
                self._dedup_born.pop(key, None)
            try:
                self.m.send(reply_to, resp, cls=_ov.CLS_CLIENT)
            except SendFailure:
                pass  # client/transport gone: completions delivered on the
                # tick thread must never kill the driver

        def settle(i: int, rid, entry) -> None:
            with lock:
                # idempotent per index: a manager that both fires the
                # failure callback AND returns a rejection (WAL shed,
                # admission shed) must not double-decrement the remainder
                if settled[i]:
                    return
                settled[i] = True
                results[i] = entry
                remaining[0] -= 1
                done = remaining[0] == 0
            if done:
                finish()

        # demand accounting once per (name, batch), not per request
        name_counts: Dict[str, int] = {}
        for name, _rid, _pl in reqs:
            name_counts[name] = name_counts.get(name, 0) + 1
        for name, cnt in name_counts.items():
            epoch = self.coord.current_epoch(name)
            if epoch is not None:
                self._register_demand_batch(name, reply_to, epoch, cnt)
        def make_cb(i: int, rid):
            def cb(req_id: int, resp) -> None:
                if req_id < 0 or resp is None:
                    err = ("busy" if req_id == _ov.RID_BUSY else
                           "expired" if req_id == _ov.RID_EXPIRED else
                           "stopped")
                    settle(i, rid, [rid, False, err])
                else:
                    settle(i, rid, [rid, True, pkt.b64e(resp)])

            return cb

        try:
            crb = getattr(self.coord, "coordinate_requests_batch", None)
            if crb is not None:
                # columnar admission: the whole frame enters the manager's
                # bulk path in one operation
                items, live_idx = [], []
                for i, (name, rid, payload_b64) in enumerate(reqs):
                    epoch = self.coord.current_epoch(name)
                    if epoch is None:
                        settle(i, rid, [rid, False, "not_active"])
                        continue
                    items.append((name, epoch, pkt.b64d(payload_b64) or b"",
                                  make_cb(i, rid)))
                    live_idx.append(i)
                if items:
                    rids2 = crb(items, entry=self.node_id)
                    for i, r2 in zip(live_idx, rids2):
                        if r2 < 0:
                            rid = reqs[i][1]
                            settle(i, rid, [rid, False, _REJECT[min(-r2, 3)]])
                return
            for i, (name, rid, payload_b64) in enumerate(reqs):
                epoch = self.coord.current_epoch(name)
                if epoch is None:
                    settle(i, rid, [rid, False, "not_active"])
                    continue
                r = self.coord.coordinate_request(
                    name, epoch, pkt.b64d(payload_b64) or b"",
                    make_cb(i, rid), entry=self.node_id, deadline=dl,
                )
                if r is None:
                    settle(i, rid, [rid, False, "not_active"])
        except Exception:
            # never strand the in-flight marker: a parse/admission error
            # must not black-hole every retransmission of this bid
            self._dedup_clear(key)
            raise

    def _on_binary_batch(self, sender: str, buf: bytes) -> None:
        """Binary twin of :meth:`_on_app_request_batch`: columnar decode,
        one bulk admission, columnar response frame."""
        (bid, dl, addr, client_id, names, name_idx, rids,
         payloads) = binbatch.decode_request(buf)
        if _ov.expired(dl):
            # whole frame dead on arrival (one deadline per frame: a client
            # tick's batch shares a send instant)
            _ov.count_expired("ar_ingress", self.node_id, n=len(rids))
            return
        if self.m.nodemap(client_id) is None:
            self.m.nodemap.add(client_id, addr[0], int(addr[1]))
        key = (client_id, ("bb", bid))
        dup, cached = self._dedup_check_insert(key)
        if dup:
            if cached is not None:
                self.m.send_bytes(client_id, cached, cls=_ov.CLS_CLIENT)
            return
        n = len(rids)
        if n == 0:
            self._dedup_clear(key)
            self.m.send_bytes(client_id,
                              binbatch.encode_response(bid, [], [], []),
                              cls=_ov.CLS_CLIENT)
            return
        statuses = np.zeros(n, np.uint8)
        bodies: list = [b""] * n
        lock = threading.Lock()
        remaining = [n]
        settled = np.zeros(n, bool)

        def finish() -> None:
            frame = binbatch.encode_response(bid, rids, statuses, bodies)
            # cache only all-success frames (see _on_app_request_batch)
            with self._dedup_lock:
                if statuses.all():
                    self._req_dedup[key] = frame
                else:
                    self._req_dedup.pop(key, None)
                self._dedup_born.pop(key, None)
            # in-scope (tick-thread callback flush): staged and sent as one
            # per-client frame list; off-scope: immediate.  Either way a
            # closing transport must never kill the driver — the response
            # is simply undeliverable (ClientEgress swallows SendFailure)
            self._egress.emit(client_id, frame)

        def settle(i: int, ok: bool, body: bytes) -> None:
            with lock:
                # idempotent per index (see _on_app_request_batch.settle)
                if settled[i]:
                    return
                settled[i] = True
                statuses[i] = 1 if ok else 0
                bodies[i] = body
                remaining[0] -= 1
                done = remaining[0] == 0
            if done:
                finish()

        epochs = [self.coord.current_epoch(nm) for nm in names]
        counts = np.bincount(name_idx, minlength=len(names))
        for j, nm in enumerate(names):
            if epochs[j] is not None and counts[j]:
                self._register_demand_batch(nm, client_id, epochs[j],
                                            int(counts[j]))

        def make_cb(i: int):
            def cb(req_id: int, resp) -> None:
                if req_id < 0 or resp is None:
                    err = (b"busy" if req_id == _ov.RID_BUSY else
                           b"expired" if req_id == _ov.RID_EXPIRED else
                           b"stopped")
                    settle(i, False, err)
                else:
                    settle(i, True, resp)

            return cb

        try:
            crb = getattr(self.coord, "coordinate_requests_batch", None)
            use_sink = (crb is not None
                        and getattr(self.coord, "supports_batch_sink", False))
            items, live_idx = [], []
            for i in range(n):
                ep = epochs[name_idx[i]]
                if ep is None:
                    settle(i, False, b"not_active")
                    continue
                if use_sink:
                    items.append((names[name_idx[i]], ep, payloads[i], None))
                    live_idx.append(i)
                elif crb is not None:
                    items.append((names[name_idx[i]], ep, payloads[i],
                                  make_cb(i)))
                    live_idx.append(i)
                else:
                    r = self.coord.coordinate_request(
                        names[name_idx[i]], ep, payloads[i], make_cb(i),
                        entry=self.node_id,
                        deadline=int(dl) if dl else None,
                    )
                    if r is None:
                        settle(i, False, b"not_active")
            if items and use_sink:
                # columnar completion: the manager delivers (offsets,
                # responses) per tick for the admitted block — zero
                # per-request callback objects on this edge.  Early fires
                # (completion racing this thread's index build) buffer.
                admitted: list = []
                early: list = []
                built = [False]

                def deliver(offs, resps) -> None:
                    fin = False
                    with lock:
                        for k2, off in enumerate(offs):
                            i2 = admitted[off]
                            r2 = None if resps is None else resps[k2]
                            if r2 is None:
                                # same semantics as the per-rid callback
                                # path: a None response is a retryable
                                # failure, never an empty success
                                bodies[i2] = b"stopped"
                            else:
                                statuses[i2] = 1
                                bodies[i2] = r2
                        remaining[0] -= len(offs)
                        fin = remaining[0] == 0
                    if fin:
                        finish()

                def sink(offs, resps) -> None:
                    with lock:
                        if not built[0]:
                            early.append((offs, resps))
                            return
                    deliver(offs, resps)

                out = crb(items, entry=self.node_id, batch_sink=sink)
                for j, r2 in enumerate(out):
                    i = live_idx[j]
                    if r2 < 0:
                        settle(i, False, _REJECT[min(-r2, 3)].encode())
                    else:
                        admitted.append(i)
                with lock:
                    built[0] = True
                    drain, early[:] = early[:], []
                for offs, resps in drain:
                    deliver(offs, resps)
            elif items:
                out = crb(items, entry=self.node_id)
                for i, r2 in zip(live_idx, out):
                    if r2 < 0:
                        settle(i, False, _REJECT[min(-r2, 3)].encode())
        except Exception:
            self._dedup_clear(key)
            raise

    def _anycast_forward(self, reply_to: str, p: dict) -> None:
        """Resolve the name's actives from its RC group, then re-send the
        request to a hosting replica with explicit client reply routing."""
        name = p["name"]
        with self._any_lock:
            qrid = self._any_next
            self._any_next += 1
            self._any_pending[qrid] = (reply_to, dict(p))
            while len(self._any_pending) > 1024:
                self._any_pending.popitem(last=False)
        rcs = self.rc_ring.replicated_servers(name, self.rc_k)
        # random member: a dead fixed target must not blackhole every retry
        import random as _random

        self.m.send(_random.choice(rcs), pkt.request_active_replicas(name, qrid))

    def _on_actives_response(self, sender: str, p: dict) -> None:
        with self._any_lock:
            ent = self._any_pending.pop(p.get("rid"), None)
        if ent is None:
            return
        reply_to, req = ent
        if not p.get("ok") or not p.get("actives"):
            self.m.send(reply_to, {
                "type": pkt.APP_RESPONSE, "rid": req["rid"], "ok": False,
                "error": "not_active", "name": req["name"],
            }, cls=_ov.CLS_CLIENT)
            return
        for a, addr in (p.get("addrs") or {}).items():
            if self.m.nodemap(a) is None:
                self.m.nodemap.add(a, addr[0], int(addr[1]))
        import random as _random

        # random hosting replica: client retries then spread across the
        # group instead of deterministically re-hitting a dead first member
        target = _random.choice(p["actives"])
        req["reply_to"] = reply_to
        req["fwd"] = 1
        self.m.send(target, req, cls=_ov.CLS_CLIENT)

    def _finish_request(self, sender: str, key, packet: dict,
                        cache: bool) -> None:
        """Answer an app request.  Successful responses are cached for
        retransmission replay; errors clear the pending marker so a retry
        after e.g. an epoch change gets a fresh attempt."""
        with self._dedup_lock:
            if cache:
                self._req_dedup[key] = packet
            else:
                self._req_dedup.pop(key, None)
            self._dedup_born.pop(key, None)
        self.m.send(sender, packet, cls=_ov.CLS_CLIENT)

    def _register_demand(self, name: str, sender: str, epoch: int) -> None:
        self._register_demand_batch(name, sender, epoch, 1)

    def _register_demand_batch(self, name: str, sender: str, epoch: int,
                               n: int) -> None:
        with self._plock:
            prof = self._profiles.get(name)
            if prof is None:
                prof = self._profiles[name] = self.profile_factory(name)
            if n == 1:
                prof.register_request(sender)
            else:
                prof.register_requests(sender, n)
            stats = prof.get_stats() if prof.should_report() else None
        if stats is not None:
            # ship to the name's RC group (handleDemandReport aggregates and
            # decides; sending to all k members tolerates RC failures)
            for rc in self.rc_ring.replicated_servers(name, self.rc_k):
                self.m.send(rc, pkt.demand_report(name, epoch, stats, self.node_id))

    # ---------------------------------------------------------- epoch lifecycle
    def _on_stop_epoch(self, sender: str, p: dict) -> None:
        name, epoch, initiator = p["name"], p["epoch"], p["initiator"]
        ack = {"type": pkt.ACK_STOP_EPOCH, "name": name, "epoch": epoch}
        cur = self.coord.current_epoch(name)
        if cur is None or cur > epoch:
            # unknown or already moved on — the stop is moot (idempotent ack)
            self.m.send(initiator, ack)
            return

        def done(ok: bool) -> None:
            self.m.send(initiator, ack)

        started = self.coord.stop_replica_group(name, epoch, done)
        if not started:
            self.m.send(initiator, ack)

    def _on_start_epoch(self, sender: str, p: dict) -> None:
        name, epoch = p["name"], p["epoch"]
        cur = self.coord.current_epoch(name)
        if cur is not None and cur >= epoch:
            self._ack_start(p)  # duplicate/raced StartEpoch
            return
        if p["prev_epoch"] < 0:
            # creation: seed with the client-provided initial state
            self._create_started_epoch(p, pkt.b64d(p["initial_state"]) or b"")
            return
        # migration: the previous epoch's final state may be local (shared
        # dense coordinator) or remote (fetch task)
        state = self.coord.get_final_state(name, p["prev_epoch"])
        if state is not None:
            self._create_started_epoch(p, state)
        elif [a for a in p["prev_actives"] if a != self.node_id]:
            self.executor.schedule(WaitEpochFinalState(self, p))
        else:
            # no previous active to ask and no local copy: born tainted,
            # repaired by checkpoint transfer from the new epoch's peers
            self._create_started_epoch(p, b"", tainted=True)

    def _create_started_epoch(self, p: dict, state: bytes,
                              tainted: bool = False) -> None:
        self.coord.create_replica_group(p["name"], p["epoch"], state,
                                        p["actives"], tainted=tainted)
        self._ack_start(p)

    def _ack_start(self, p: dict) -> None:
        self.m.send(p["initiator"], {
            "type": pkt.ACK_START_EPOCH, "name": p["name"], "epoch": p["epoch"],
        })

    def _on_drop_epoch(self, sender: str, p: dict) -> None:
        name, epoch = p["name"], p["epoch"]
        self.coord.drop_final_state(name, epoch)
        # drop the demand profile too: if the name migrated away or died,
        # the profile must not linger (it is recreated on the next request)
        with self._plock:
            self._profiles.pop(name, None)
        self.m.send(p["initiator"], {
            "type": pkt.ACK_DROP_EPOCH, "name": name, "epoch": epoch,
        })

    #: checkpoints above this ride the chunked bulk channel instead of one
    #: base64 JSON frame (LargeCheckpointer threshold idea)
    inline_state_limit = 256 * 1024

    def _on_request_final_state(self, sender: str, p: dict) -> None:
        name, epoch = p["name"], p["epoch"]
        state = self.coord.get_final_state(name, epoch)
        if state is None:
            # distinguish "not stopped yet" (asker keeps polling) from
            # "dropped by GC" (asker may give up and birth tainted — a
            # gone answer implies the complete committed, so a majority of
            # the new epoch holds the real state)
            fsg = getattr(self.coord, "final_state_gone", None)
            reply = pkt.epoch_final_state(name, epoch, None)
            if fsg is not None and fsg(name, epoch):
                reply["gone"] = True
            self.m.send(p["requester"], reply)
            return
        if len(state) > self.inline_state_limit:
            self.m.send(p["requester"], {
                "type": pkt.EPOCH_FINAL_STATE, "name": name, "epoch": epoch,
                "found": True, "bulk": True,
            })
            # epoch leads in the key: names may themselves contain ':'.
            # Worker thread: this handler runs on a transport reader thread,
            # and a paced multi-GB send must not stall inbound processing.
            threading.Thread(
                target=self.bulk.send,
                args=(p["requester"], f"efs:{epoch}:{name}", state),
                name=f"efs-send-{name}", daemon=True,
            ).start()
            return
        self.m.send(p["requester"], pkt.epoch_final_state(name, epoch, state))

    def _on_bulk_final_state(self, sender: str, key: str, data: bytes) -> None:
        epoch_s, name = key[len("efs:"):].split(":", 1)
        self.executor.handle_event(
            f"WaitEpochFinalState:{name}:{int(epoch_s) + 1}",
            {"found": True, "state_bytes": data},
        )

    def _on_epoch_final_state(self, sender: str, p: dict) -> None:
        self.executor.handle_event(
            f"WaitEpochFinalState:{p['name']}:{p['epoch'] + 1}", p
        )

    # ------------------------------------------------------------------- echo
    def _on_echo(self, sender: str, p: dict) -> None:
        pkt.register_client(self.m.nodemap, p)
        self.m.send(sender, {
            "type": pkt.ECHO_REPLY, "ts": p.get("ts", time.time()),
            "rid": p.get("rid"), "node": self.node_id,
        })
