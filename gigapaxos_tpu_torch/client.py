"""Async client library.

Analog of ``reconfiguration/ReconfigurableAppClientAsync.java:35`` (plus the
paxos-only ``PaxosClientAsync.java:48``): a client endpoint that

* manages names through any reconfigurator (create/delete/reconfigure,
  retrying across RCs);
* caches each name's active-replica set with a TTL and re-resolves on
  ``not_active``/``stopped`` errors (the actives cache + invalidate-on-error
  loop, ReconfigurableAppClientAsync.java:43 MIN_REQUEST_ACTIVES_INTERVAL);
* redirects each request to the lowest-latency active by EWMA RTT with
  occasional exploration (E2ELatencyAwareRedirector.java:18 +
  RTTEstimator.java:28);
* correlates responses by request id, with both sync helpers and async
  callbacks (RequestCallbackFuture analog).

The client binds its own ephemeral port and stamps ``client_addr`` on every
packet so servers can address it back over the node transport.
"""

from __future__ import annotations

import collections
import itertools
import random
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from . import overload as _overload
from .config import NodeConfig
from .net import binbatch
from .net.messenger import Messenger, NodeMap
from .obs.metrics import registry as _obs_registry
from .reconfiguration import packets as pkt
from .utils.reqtrace import XNS as _XNS
from .utils.reqtrace import new_trace_id, tracer as _tracer


class ClientError(Exception):
    pass


class ReconfigurableAppClient:
    def __init__(
        self,
        nodes: NodeConfig,
        client_id: Optional[str] = None,
        bind_host: str = "127.0.0.1",
        actives_ttl_s: float = 30.0,
        explore_prob: float = 0.1,
        security=None,
        placement_table=None,
        trace_wire: "bool | None" = None,
        retry_fraction: float = 0.1,
        breaker_threshold: int = 5,
        breaker_cooloff_s: float = 1.0,
        default_deadline_s: float = 15.0,
    ):
        """``security``: a ``TransportSecurity`` for TLS deployments — under
        MUTUAL_AUTH it must carry a CA-signed client certificate (the
        reference's mutual-auth client types,
        ReconfigurableAppClientAsync.java:35).

        ``placement_table``: an optional ``placement.PlacementTable`` fed by
        the deployment wiring (the http_edge idiom).  When present, names
        with a migration override route straight to the override's server —
        the actives cache and RC never need to chase the placement."""
        self.node_id = client_id or f"C{uuid.uuid4().hex[:8]}"
        self.nodemap = NodeMap(nodes)
        self.m = Messenger(self.node_id, (bind_host, 0), self.nodemap,
                           security=security)
        self.addr = (bind_host, self.m.port)
        self.rc_ids = list(nodes.reconfigurator_ids())
        if not self.rc_ids:
            raise ClientError("no reconfigurators in topology")
        self._rc_rr = itertools.cycle(self.rc_ids)
        self.actives_ttl_s = actives_ttl_s
        self.explore_prob = explore_prob
        self.placement_table = placement_table
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next_rid = random.randrange(1, 1 << 30)
        # bounded: late responses to abandoned rids and callbacks for
        # requests that never get answered must not accumulate forever
        # (the reference GC's its callback maps the same way,
        # GCConcurrentHashMap in ReconfigurableAppClientAsync)
        self._results: "collections.OrderedDict[int, dict]" = collections.OrderedDict()
        self._results_cap = 2048
        self._callbacks: Dict[int, Callable[[dict], None]] = {}
        self._cb_deadline: Dict[int, float] = {}
        self._cb_ttl_s = 120.0
        #: name -> (expiry_monotonic, actives list)
        self._actives: Dict[str, Tuple[float, List[str]]] = {}
        #: name -> (placement-table epoch at fill time, chosen target): the
        #: per-name route memo.  Entries die on a table epoch bump (a
        #: placement/cell override changed somewhere) or an explicit
        #: _drop_route (the target failed / redirected this client).
        self._route_cache: Dict[str, Tuple[int, str]] = {}
        self._route_cache_cap = 4096
        #: name -> current re-resolution backoff (full-jitter exponential,
        #: the _rpc_rc scheme applied per name): a moved/bouncing name must
        #: not hammer the RC with synchronized re-resolves
        self._route_backoff: Dict[str, float] = {}
        self._rtt: Dict[str, float] = {}  # active id -> EWMA seconds
        self._sent_at: Dict[int, Tuple[str, float]] = {}
        for t in (pkt.CREATE_RESPONSE, pkt.CREATE_BATCH_RESPONSE,
                  pkt.DELETE_RESPONSE,
                  pkt.ACTIVES_RESPONSE, pkt.RECONFIGURE_RESPONSE,
                  pkt.APP_RESPONSE, pkt.ECHO_REPLY,
                  pkt.NODE_CONFIG_RESPONSE):
            self.m.register(t, self._on_response)
        self.m.register(pkt.APP_RESPONSE_BATCH, self._on_batch_response)
        binbatch.chain_bytes_handler(self.m.demux, binbatch.RESP_MAGIC,
                                     self._on_binary_batch_response)
        # randomized like _next_rid: a restarted client with a stable id
        # must not hit the server's batch-dedup cache from its past life
        self._next_bid = random.randrange(1, 1 << 30)
        #: bid -> (target, send time): one RTT sample per batch FRAME (the
        #: per-rid _sent_at writes were the staging hot path's top cost)
        self._batch_sent: "collections.OrderedDict[int, tuple]" = (
            collections.OrderedDict()
        )
        #: commit-latency SLO histogram (client-observed RTT; the AR-side
        #: twin is commit_latency_seconds in reconfiguration/active_replica)
        self._lat_h = _obs_registry().histogram(
            "client_commit_latency_seconds",
            help="client-observed request->response latency")
        self._batch_lat_h = _obs_registry().histogram(
            "client_batch_rtt_seconds",
            help="per-batch-frame round-trip latency")
        #: read-latency SLO histogram: lease-local reads answer
        #: without a consensus round, so reads get their own distribution
        #: instead of polluting the commit-latency one
        self._read_lat_h = _obs_registry().histogram(
            "client_read_latency_seconds",
            help="client-observed read request->response latency")
        #: rids in flight on the READ path (routes the RTT sample to the
        #: read histogram; bounded by the same reaping as _sent_at)
        self._read_rids: set = set()
        #: cross-process tracing: when enabled (GPTPU_REQTRACE, or set
        #: ``client.trace.enabled = True``), app requests carry a trace id
        #: on the wire ("trace") that every hop records against — see
        #: utils/reqtrace.py "Cross-process tracing"
        self.trace = _tracer(_XNS)
        if trace_wire is not None:  # cfg.obs.trace_wire plumbs through here
            self.trace.enabled = bool(trace_wire)
        self._trace_ids: "collections.OrderedDict[int, int]" = (
            collections.OrderedDict()
        )
        # ---- overload plane: storm dampers + wire deadlines ----
        #: retry budget: retries spend from a bucket funded at
        #: ``retry_fraction`` per fresh request — a brownout triggers at
        #: most ~10% retry amplification instead of tries× (SRE retry
        #: budget; the transport's own frame retries are unaffected)
        self.retry_budget = _overload.TokenBucket(fraction=retry_fraction)
        #: per-active circuit breakers driven by NACK/timeout rate; consulted
        #: non-consumingly by the redirector so a browned-out destination is
        #: avoided for a cooloff instead of hammered
        self._breakers: Dict[str, _overload.CircuitBreaker] = {}
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooloff_s = float(breaker_cooloff_s)
        #: default wire deadline for async sends (sync paths derive the
        #: deadline from their own timeout argument)
        self.default_deadline_s = float(default_deadline_s)

    def close(self) -> None:
        self.m.close()

    def _wire_deadline(self) -> int:
        """Default async-path wire deadline; 0 (no deadline) when stamping
        is disabled with ``default_deadline_s <= 0``."""
        return (_overload.deadline_at(self.default_deadline_s)
                if self.default_deadline_s > 0 else 0)

    # ------------------------------------------------------------- plumbing
    def _rid(self) -> int:
        with self._lock:
            self._next_rid += 1
            return self._next_rid

    def _stamp(self, p: dict) -> dict:
        p["client_addr"] = [self.addr[0], self.addr[1]]
        if self.trace.enabled and p.get("type") == pkt.APP_REQUEST:
            rid = p.get("rid")
            with self._lock:
                # retries reuse the rid AND the trace id: one timeline
                tid = self._trace_ids.get(rid)
                if tid is None:
                    tid = self._trace_ids[rid] = new_trace_id()
                    while len(self._trace_ids) > 4096:
                        self._trace_ids.popitem(last=False)
            p["trace"] = tid
            self.trace.event(tid, "client_sent", req=rid, name=p.get("name"))
        return p

    def _on_response(self, sender: str, p: dict) -> None:
        rid = p.get("rid")
        cb = None
        with self._lock:
            if rid is not None:
                sa = self._sent_at.get(rid)
                if sa is not None and sa[0] == sender:
                    # only credit the RTT to the node that actually answered:
                    # with rid reuse across retries, a LATE response from
                    # attempt k must not consume (and mis-attribute) the
                    # timing entry written by attempt k+1
                    del self._sent_at[rid]
                    node, t0 = sa
                    rtt = time.monotonic() - t0
                    if rid in self._read_rids:
                        self._read_rids.discard(rid)
                        self._read_lat_h.observe(rtt)
                    else:
                        self._lat_h.observe(rtt)
                    prev = self._rtt.get(node)
                    self._rtt[node] = rtt if prev is None else 0.875 * prev + 0.125 * rtt
                tid = self._trace_ids.pop(rid, None)
                cb = self._callbacks.pop(rid, None)
                self._cb_deadline.pop(rid, None)
                if cb is None:
                    self._results[rid] = p
                    while len(self._results) > self._results_cap:
                        self._results.popitem(last=False)
                    self._cv.notify_all()
        if rid is not None and tid is not None:
            self.trace.event(tid, "client_responded", req=rid,
                             ok=bool(p.get("ok")))
        if cb is not None:
            cb(p)

    def _breaker(self, target: str) -> _overload.CircuitBreaker:
        with self._lock:
            br = self._breakers.get(target)
            if br is None:
                br = self._breakers[target] = _overload.CircuitBreaker(
                    threshold=self._breaker_threshold,
                    cooloff_s=self._breaker_cooloff_s)
            return br

    def _reap(self, rid: int) -> None:
        """Drop every per-rid map entry for an abandoned request.  Without
        this, a sustained-timeout workload (dead active, partitioned
        client) grows _sent_at/_trace_ids without bound — each timed-out
        rid's entries survived because only the response path popped them."""
        with self._lock:
            self._sent_at.pop(rid, None)
            self._callbacks.pop(rid, None)
            self._cb_deadline.pop(rid, None)
            self._trace_ids.pop(rid, None)
            self._read_rids.discard(rid)

    def _await(self, rid: int, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        with self._lock:
            while rid not in self._results:
                left = deadline - time.monotonic()
                if left <= 0:
                    # reap the rid's tracking entries (not just _sent_at):
                    # an abandoned rid must not leak its trace-id/callback
                    # bookkeeping when no response ever arrives
                    self._sent_at.pop(rid, None)
                    self._callbacks.pop(rid, None)
                    self._cb_deadline.pop(rid, None)
                    self._trace_ids.pop(rid, None)
                    raise TimeoutError(f"rid {rid}")
                self._cv.wait(timeout=left)
            return self._results.pop(rid)

    def _rc_cycle_for(self, name: Optional[str]):
        """The RC rotation for one name: with a cell-aware router attached
        (cells.CellRouter duck-types ``rc_ids``), only the owner cell's
        reconfigurators hold the name's records — rotating through foreign
        cells' RCs would answer unknown_name.  Plain tables / no table:
        the shared round-robin."""
        t = self.placement_table
        if name is not None and t is not None:
            fn = getattr(t, "rc_ids", None)
            if fn is not None:
                ids = [r for r in fn(name)
                       if r in self.rc_ids or self.nodemap(r) is not None]
                if ids:
                    return itertools.cycle(ids)
        return self._rc_rr

    def _rpc_rc(self, packet: dict, timeout: float, tries: int = 3,
                on_reply=None, name: Optional[str] = None) -> dict:
        """Send a control request to reconfigurators, rotating on timeout.

        ``on_reply(resp, retried)`` may map the response before it is
        returned; ``retried`` is True when an earlier attempt timed out
        (it may have committed server-side).  ``name``: scope the rotation
        to the name's owner-cell RCs when a cell router is attached.

        Retries back off exponentially with full random jitter (the AWS
        "full jitter" scheme): a failed-over RC otherwise gets every
        client's retry k at exactly t0 + k*per — a synchronized retry storm
        arriving the instant it is least able to absorb it.  The jittered
        sleep spreads the herd over the backoff window; the per-try await
        still bounds total latency."""
        last: Optional[Exception] = None
        per = max(timeout / tries, 0.5)
        retried = False
        backoff = 0.1
        rr = self._rc_cycle_for(name)
        for attempt in range(tries):
            if attempt > 0:
                # full jitter: uniform in (0, backoff]; doubles per retry
                time.sleep(random.uniform(0.0, backoff))
                backoff = min(backoff * 2, 2.0)
            rc = next(rr)
            p = dict(packet)
            p["rid"] = self._rid()
            try:
                self.m.send(rc, self._stamp(p))
                resp = self._await(p["rid"], per)
            except TimeoutError as e:
                last = e
                retried = True
                continue
            return on_reply(resp, retried) if on_reply else resp
        raise TimeoutError(str(last))

    # ------------------------------------------------------- name management
    def create(self, name: str, initial_state: bytes = b"",
               timeout: float = 15.0) -> dict:
        """Create a service name.

        Caveat on retried creates: if an attempt times out and a retry
        answers "exists", the result maps to ok=True with
        ``note="created_by_earlier_attempt"`` — the usual cause is our own
        first attempt committing late.  It is however AMBIGUOUS: another
        client may have created the name first, in which case OUR
        initial_state was silently not applied.  Callers that care must
        disambiguate (read the state back, or encode a creator token in
        initial_state); the reference client has the same hole
        (DUPLICATE_ERROR tolerance, ReconfigurableAppClientAsync.java:35).
        """
        def on_reply(resp: dict, retried: bool) -> dict:
            if (not resp.get("ok") and resp.get("error") == "exists"
                    and retried):
                # a retransmission racing our own earlier (slow) attempt:
                # the name exists because WE created it — idempotent success
                # (the reference's client tolerates DUPLICATE_ERROR on
                # retried creates the same way,
                # ReconfigurableAppClientAsync.java:35)
                return dict(resp, ok=True, note="created_by_earlier_attempt")
            return resp

        return self._rpc_rc(
            pkt.create_service_name(name, initial_state, 0), timeout,
            on_reply=on_reply, name=name,
        )

    def create_batch(self, items, timeout: float = 30.0) -> dict:
        """Create many names with one RC commit per RC group
        (BatchedCreateServiceName.java; the client partitions by the names'
        RC groups like ReconfigurableAppClientAsync does).

        items: iterable of ``name`` or ``(name, initial_state)``.
        Returns {"ok": all_ok, "results": {name: {...}}}.
        """
        from .reconfiguration.consistent_hashing import ConsistentHashRing

        creates = [
            (it, b"") if isinstance(it, str) else (it[0], it[1])
            for it in items
        ]
        ring = ConsistentHashRing(sorted(self.rc_ids))
        parts: Dict[str, list] = {}
        for n, s in creates:
            parts.setdefault(ring.replicated_servers(n, 1)[0], []).append((n, s))
        results: Dict[str, dict] = {}
        rids = []
        for primary, batch in parts.items():
            p = pkt.create_batch(batch, self._rid())
            rids.append((primary, p))
            self.m.send(primary, self._stamp(p))
        deadline = time.monotonic() + timeout
        for primary, p in rids:
            left = max(deadline - time.monotonic(), 0.5)
            try:
                resp = self._await(p["rid"], left)
            except TimeoutError:
                # one retry through a rotated RC (the commit is idempotent
                # per name: duplicates come back as per-name "exists")
                p2 = dict(p)
                p2["rid"] = self._rid()
                self.m.send(next(self._rc_rr), self._stamp(p2))
                resp = self._await(p2["rid"], max(deadline - time.monotonic(), 0.5))
            results.update(resp.get("results") or {})
        return {"ok": all(r.get("ok") for r in results.values()) and bool(results),
                "results": results}

    def delete(self, name: str, timeout: float = 15.0) -> dict:
        resp = self._rpc_rc(pkt.delete_service_name(name, 0), timeout,
                            name=name)
        with self._lock:
            self._actives.pop(name, None)
            self._route_cache.pop(name, None)
        return resp

    def reconfigure(self, name: str, new_actives: List[str],
                    timeout: float = 20.0) -> dict:
        resp = self._rpc_rc(pkt.client_reconfigure(name, new_actives, 0),
                            timeout, name=name)
        with self._lock:
            self._actives.pop(name, None)
            self._route_cache.pop(name, None)
        return resp

    # ------------------------------------------------------ node elasticity
    def add_active(self, node: str, host: str, port: int,
                   timeout: float = 15.0) -> dict:
        """Admin: add an active node to the deployment's pool
        (ReconfigureActiveNodeConfig analog)."""
        resp = self._rpc_rc({"type": pkt.ADD_ACTIVE, "node": node,
                             "addr": [host, port]}, timeout)
        if resp.get("ok"):
            self.nodemap.add(node, host, port)
        return resp

    def remove_active(self, node: str, timeout: float = 15.0) -> dict:
        resp = self._rpc_rc({"type": pkt.REMOVE_ACTIVE, "node": node}, timeout)
        with self._lock:
            self._actives.clear()  # placements may be migrating
        return resp

    def add_reconfigurator(self, node: str, host: str, port: int,
                           timeout: float = 15.0) -> dict:
        """Admin: splice a reconfigurator into the RC pool at runtime
        (ReconfigureRCNodeConfig analog, Reconfigurator.java:1044)."""
        resp = self._rpc_rc({"type": pkt.ADD_RC, "node": node,
                             "addr": [host, port]}, timeout)
        if resp.get("ok"):
            self.nodemap.add(node, host, port)
            if node not in self.rc_ids:
                self.rc_ids.append(node)
                self._rc_rr = itertools.cycle(sorted(self.rc_ids))
        return resp

    def remove_reconfigurator(self, node: str, timeout: float = 15.0) -> dict:
        resp = self._rpc_rc({"type": pkt.REMOVE_RC, "node": node}, timeout)
        if resp.get("ok") and node in self.rc_ids:
            self.rc_ids.remove(node)
            self._rc_rr = itertools.cycle(sorted(self.rc_ids))
        return resp

    def request_actives(self, name: str, timeout: float = 10.0,
                        force: bool = False) -> List[str]:
        with self._lock:
            hit = self._actives.get(name)
            if hit is not None and not force and hit[0] > time.monotonic():
                return list(hit[1])
        # cell router fast path: static hash placement + the override map
        # IS the directory, so the owner cell's actives come back with zero
        # RC round-trips (and a migrated name resolves even though the
        # destination cell's RC never heard of it).  force falls through —
        # a failing name deserves the authoritative RC answer.
        t = self.placement_table
        if t is not None and not force and name != pkt.ALL_ACTIVES:
            fn = getattr(t, "actives_of", None)
            if fn is not None:
                acts = fn(name)
                if acts:
                    return list(acts)
        resp = self._rpc_rc(pkt.request_active_replicas(name, 0), timeout,
                            name=name)
        if not resp.get("ok"):
            # a migrated name is unknown to its destination cell's RC (the
            # move rode the epoch machinery, not an RC create) — the router
            # override is the directory of record, so answer from it
            if t is not None and name != pkt.ALL_ACTIVES:
                fn = getattr(t, "actives_of", None)
                if fn is not None:
                    acts = fn(name)
                    if acts:
                        return list(acts)
            raise ClientError(resp.get("error", "unknown_name"))
        actives = resp["actives"]
        for a, addr in resp.get("addrs", {}).items():
            if self.nodemap(a) is None:
                self.nodemap.add(a, addr[0], int(addr[1]))
        with self._lock:
            self._actives[name] = (time.monotonic() + self.actives_ttl_s, actives)
        return list(actives)

    # ----------------------------------------------------------- app requests
    def attach_placement(self, table) -> None:
        """Wire a ``PlacementTable`` after construction (deployment wiring
        may build the client before the table exists)."""
        self.placement_table = table

    def _route(self, name: str, actives: List[str], avoid=()) -> str:
        """Placement-table answer when present, RC answer otherwise.

        A name with a migration override routes to the override's server
        even when it is not (yet) in the cached actives list — the table is
        newer truth than the RC answer, so a migrated group's requests reach
        the new shard without an RC round-trip.  Names without an override
        (and overrides whose server has already failed this request) fall
        through to the RTT redirector over the RC's actives.

        The pick is memoized per name, keyed by the table's version epoch:
        a placement/cell override committed anywhere bumps the epoch and
        every cached route re-resolves on next use (stale routes otherwise
        chase a migrated group through a full error round-trip first).  A
        target that failed this request (``avoid``) bypasses and drops the
        memo — the redirect path."""
        t = self.placement_table
        epoch = getattr(t, "epoch", None) if t is not None else None
        if epoch is not None:
            with self._lock:
                hit = self._route_cache.get(name)
                if hit is not None:
                    if (not avoid and hit[0] == epoch
                            and (hit[1] in actives
                                 or self.nodemap(hit[1]) is not None)):
                        return hit[1]
                    del self._route_cache[name]  # epoch bump / failed target
        target = None
        if t is not None:
            lead = t.lead_server(name)
            if (lead is not None and lead not in avoid
                    and (lead in actives or self.nodemap(lead) is not None)):
                target = lead
        if target is None:
            target = self._pick_active(actives, avoid)
        if epoch is not None and not avoid:
            with self._lock:
                self._route_cache[name] = (epoch, target)
                while len(self._route_cache) > self._route_cache_cap:
                    self._route_cache.pop(next(iter(self._route_cache)))
        return target

    def _drop_route(self, name: str) -> None:
        """Invalidate the name's memoized route + actives cache (cell-moved
        redirect, failed target): the next request re-resolves."""
        with self._lock:
            self._route_cache.pop(name, None)
            self._actives.pop(name, None)

    def _resolve_backoff_sleep(self, name: str) -> None:
        """Per-name full-jitter exponential backoff between re-resolution
        attempts (the _rpc_rc scheme, keyed by name): every client chasing
        one migrated group must not re-resolve in lockstep."""
        with self._lock:
            bo = self._route_backoff.get(name, 0.05)
            self._route_backoff[name] = min(bo * 2, 2.0)
        time.sleep(random.uniform(0.0, bo))

    def _resolve_backoff_reset(self, name: str) -> None:
        with self._lock:
            self._route_backoff.pop(name, None)

    def _pick_active(self, actives: List[str], avoid=()) -> str:
        """Lowest-EWMA-RTT active, with epsilon exploration so a recovered
        replica gets re-measured (E2ELatencyAwareRedirector's probe idea).
        ``avoid``: targets that already failed THIS request (e.g. answered
        not_active while still birthing the epoch) — excluded unless that
        empties the pool."""
        pool = [a for a in actives if a not in avoid] or list(actives)
        # breaker screen (non-consuming): skip destinations in cooloff.
        # Fail open when every candidate's breaker is open — some target
        # must carry the probe that lets a breaker half-open and close.
        with self._lock:
            live = [a for a in pool
                    if a not in self._breakers or self._breakers[a].allow()]
        pool = live or pool
        unknown = [a for a in pool if a not in self._rtt]
        if unknown or random.random() < self.explore_prob:
            return random.choice(unknown or pool)
        return min(pool, key=lambda a: self._rtt.get(a, float("inf")))

    def send_request(
        self,
        name: str,
        payload: bytes,
        callback: Callable[[dict], None],
        active: Optional[str] = None,
    ) -> int:
        """Fire one app request; the callback gets the raw response packet
        (``ok``/``response``/``error``).  Actives must be resolvable."""
        target = active or self._route(name, self.request_actives(name))
        rid = self._rid()
        now = time.monotonic()
        with self._lock:
            if len(self._callbacks) > 4096:
                dead = [r for r, d in self._cb_deadline.items() if d < now]
                for r in dead:
                    self._callbacks.pop(r, None)
                    self._cb_deadline.pop(r, None)
                    self._sent_at.pop(r, None)
            self._callbacks[rid] = callback
            self._cb_deadline[rid] = now + self._cb_ttl_s
            self._sent_at[rid] = (target, now)
        p = pkt.app_request(name, payload, rid)
        p["deadline"] = self._wire_deadline()
        self.m.send(target, self._stamp(p), cls=_overload.CLS_CLIENT)
        return rid

    def send_read(
        self,
        name: str,
        payload: bytes,
        callback: Callable[[dict], None],
        active: Optional[str] = None,
    ) -> int:
        """Fire one linearizable READ: travels CLS_READ end to
        end and is answered from the lease holder's local state when the
        server's lease validates (response carries ``local: true``), else
        through a consensus round.  ``payload`` must be side-effect-free
        under the app.  The callback gets the raw response packet."""
        target = active or self._route(name, self.request_actives(name))
        rid = self._rid()
        now = time.monotonic()
        with self._lock:
            if len(self._callbacks) > 4096:
                dead = [r for r, d in self._cb_deadline.items() if d < now]
                for r in dead:
                    self._callbacks.pop(r, None)
                    self._cb_deadline.pop(r, None)
                    self._sent_at.pop(r, None)
                    self._read_rids.discard(r)
            self._callbacks[rid] = callback
            self._cb_deadline[rid] = now + self._cb_ttl_s
            self._sent_at[rid] = (target, now)
            self._read_rids.add(rid)
        p = pkt.app_read(name, payload, rid)
        p["deadline"] = self._wire_deadline()
        self.m.send(target, self._stamp(p), cls=_overload.CLS_READ)
        return rid

    def _batch_rtt(self, bid) -> None:
        """Per-frame RTT sample for the redirector's EWMA."""
        ent = None
        with self._lock:
            ent = self._batch_sent.pop(bid, None)
        if ent is None:
            return
        target, t0 = ent
        rtt = time.monotonic() - t0
        self._batch_lat_h.observe(rtt)
        with self._lock:
            prev = self._rtt.get(target)
            self._rtt[target] = (rtt if prev is None
                                 else 0.875 * prev + 0.125 * rtt)

    def _on_batch_response(self, sender: str, p: dict) -> None:
        """Fan a batched response frame back out to the per-rid callbacks
        (same completion semantics as APP_RESPONSE, one frame for all)."""
        self._batch_rtt(p.get("bid"))
        for rid, ok, body in p.get("results") or []:
            if ok:
                self._on_response(sender, {"type": pkt.APP_RESPONSE,
                                           "rid": rid, "ok": True,
                                           "response": body})
            else:
                self._on_response(sender, {"type": pkt.APP_RESPONSE,
                                           "rid": rid, "ok": False,
                                           "error": body})

    def _stage_batch(self, items, callback, active):
        """Shared staging for the batch senders: group by target, assign
        rids, register callbacks, allocate batch ids.  Returns
        (by_target dict, rids in item order, first bid)."""
        by_target: Dict[str, list] = {}
        rids: List[int] = []
        now = time.monotonic()
        # one target per unique NAME per batch: rolling the epsilon-greedy
        # pick per item would fan a single hot name across several actives
        # and defeat the coalescing this path exists for
        target_of: Dict[str, str] = {}
        for name, payload in items:
            target = active or target_of.get(name)
            if target is None:
                target = self._route(name, self.request_actives(name))
                target_of[name] = target
            rid = self._rid()
            rids.append(rid)
            by_target.setdefault(target, []).append((name, rid, payload))
        with self._lock:
            if len(self._callbacks) > 4096:
                # same expired-callback sweep as send_request: lost
                # responses must not grow the maps without bound
                dead = [r for r, d in self._cb_deadline.items() if d < now]
                for r in dead:
                    self._callbacks.pop(r, None)
                    self._cb_deadline.pop(r, None)
                    self._sent_at.pop(r, None)
            ttl = now + self._cb_ttl_s
            for target, reqs in by_target.items():
                for _name, rid, _p in reqs:
                    self._callbacks[rid] = callback
                    self._cb_deadline[rid] = ttl
                    # no per-rid _sent_at: batch responses arrive as one
                    # columnar frame — per-request RTT attribution would
                    # cost a dict write per request on the hot path for a
                    # signal the redirector only needs per target
            bid = self._next_bid
            self._next_bid += len(by_target)
            # ONE per-frame RTT sample per target instead: batched traffic
            # must keep feeding the redirector's EWMA or a once-penalized
            # (since recovered) replica could never be re-measured
            for i, target in enumerate(by_target):
                self._batch_sent[bid + i] = (target, now)
            while len(self._batch_sent) > 1024:
                self._batch_sent.popitem(last=False)
        return by_target, rids, bid

    def send_request_batch(
        self,
        items,
        callback: Callable[[dict], None],
        active: Optional[str] = None,
    ) -> List[int]:
        """Fire many app requests in ONE frame per target active (the
        client half of the reference's request batching,
        RequestPacket.java:189-233).  ``items``: (name, payload) pairs;
        ``callback`` gets each raw per-request response packet.  Returns
        the assigned rids in item order."""
        by_target, rids, bid = self._stage_batch(items, callback, active)
        dl = self._wire_deadline()
        for i, (target, reqs) in enumerate(by_target.items()):
            p = pkt.app_request_batch(reqs, bid + i)
            p["deadline"] = dl  # one deadline per frame: shared send instant
            self.m.send(target, self._stamp(p), cls=_overload.CLS_CLIENT)
        return rids

    def read(self, name: str, payload: bytes = b"", timeout: float = 15.0,
             tries: int = 4) -> bytes:
        """Sync linearizable read: :meth:`request`'s
        redirection/retry loop over the CLS_READ wire path.  Lease-local
        on the server when valid, consensus fallback otherwise — either
        way the answer reflects every acked write.  ``payload`` must be
        side-effect-free under the app (it may execute once locally or R
        times via the fallback; retries are harmless)."""
        return self.request(name, payload, timeout, tries,
                            _mk=pkt.app_read, _cls=_overload.CLS_READ)

    def request(self, name: str, payload: bytes, timeout: float = 15.0,
                tries: int = 4, _mk=None, _cls=None) -> bytes:
        """Sync request with redirection: on not_active/stopped, invalidate
        the cache, re-resolve and retry (the client's reconfiguration-chase
        loop).

        Retransmissions reuse the SAME rid, so a retry to the same active is
        absorbed by its dedup cache instead of committing twice.  A retry to
        a *different* active after a timeout is still at-least-once (the
        original proposal may commit later), matching the reference client's
        semantics — use idempotent requests or app-level dedup if that
        matters.
        """
        per = max(timeout / tries, 0.5)
        last = "timeout"
        mk = _mk or pkt.app_request
        cls = _overload.CLS_CLIENT if _cls is None else _cls
        rid = self._rid()  # one rid for every attempt (retransmission dedup)
        if cls == _overload.CLS_READ:
            with self._lock:
                self._read_rids.add(rid)  # RTT sample -> read histogram
        # one wire deadline for the whole request: every attempt carries it,
        # and any stage that sees it expired drops the work instead of
        # finishing it for a caller that already gave up
        wire_deadline = _overload.deadline_at(timeout)
        self.retry_budget.deposit()  # fresh request funds the retry budget
        bad: set = set()  # targets that failed this request (rotate away:
        # after an epoch change one member may still be birthing the group,
        # and RTT-greedy picking would hammer it until the budget dies)
        # only overload signals (timeout, busy) spend the retry budget: a
        # not_active/stopped/wrong_cell redirect is a fast rejection from a
        # healthy node — chasing a migrated group must not starve the budget
        charge_retry = False
        try:
            for attempt in range(tries):
                if (attempt > 0 and charge_retry
                        and not self.retry_budget.take()):
                    # budget dry: fail fast rather than amplify a brownout
                    raise TimeoutError(
                        f"{name}: retry budget exhausted ({last})")
                try:
                    actives = self.request_actives(name, force=attempt > 0)
                except ClientError as e:
                    raise ClientError(f"{name}: {e}") from e
                target = self._route(name, actives, avoid=bad)
                with self._lock:
                    self._sent_at[rid] = (target, time.monotonic())
                p = mk(name, payload, rid)
                p["deadline"] = wire_deadline
                self.m.send(target, self._stamp(p), cls=cls)
                try:
                    resp = self._await(rid, per)
                except TimeoutError:
                    last = f"timeout via {target}"
                    charge_retry = True
                    self._penalize(target, per)
                    self._breaker(target).record(False)
                    bad.add(target)
                    self._drop_route(name)
                    self._resolve_backoff_sleep(name)
                    continue
                if resp.get("ok"):
                    self._resolve_backoff_reset(name)
                    self._breaker(target).record(True)
                    return pkt.b64d(resp["response"]) or b""
                last = resp.get("error", "error")
                # busy = the destination is shedding (overload NACK): a
                # breaker failure.  Other rejections mean the node is alive
                # and fast — routing signals, not overload.
                self._breaker(target).record(last != "busy")
                charge_retry = last == "busy"
                if last not in ("not_active", "stopped", "busy",
                                "wrong_cell"):
                    raise ClientError(f"{name}: {last}")
                # the target disowned the name (epoch change, cell move):
                # drop the memoized route and re-resolve under per-name
                # exponential backoff instead of a fixed lockstep sleep
                bad.add(target)
                self._drop_route(name)
                self._resolve_backoff_sleep(name)
            raise TimeoutError(f"{name}: {last}")
        finally:
            # a late response from an earlier attempt's target leaves the
            # newest _sent_at entry unconsumed (sender mismatch keeps it);
            # the sync path owns this rid end-to-end, so always reap it
            # (trace ids ride the rid too)
            self._reap(rid)

    def _penalize(self, target: str, timeout_s: float) -> None:
        """Feed a timeout into the target's EWMA as a huge latency sample —
        without this, a dead replica keeps its excellent pre-crash RTT and
        the lowest-RTT redirector keeps picking it forever (the reference's
        redirector learns failed probes the same way,
        E2ELatencyAwareRedirector.java:18)."""
        with self._lock:
            prev = self._rtt.get(target, 0.0)
            self._rtt[target] = max(prev * 4, timeout_s)

    def request_anycast(self, name: str, payload: bytes,
                        timeout: float = 15.0, tries: int = 4) -> bytes:
        """Send WITHOUT resolving the name's replica set: resolve the whole
        active pool once (cached) and send to a random active; a non-hosting
        active forwards to a hosting one, which answers us directly
        (sendRequestAnycast, ReconfigurableAppClientAsync.java:1357)."""
        per = max(timeout / tries, 0.5)
        last = "timeout"
        rid = self._rid()
        wire_deadline = _overload.deadline_at(timeout)
        self.retry_budget.deposit()
        charge_retry = False  # same rule as request(): redirects retry free
        try:
            for attempt in range(tries):
                if (attempt > 0 and charge_retry
                        and not self.retry_budget.take()):
                    raise TimeoutError(
                        f"{name}: retry budget exhausted ({last})")
                pool = self.request_actives(pkt.ALL_ACTIVES,
                                            force=attempt > 0)
                with self._lock:
                    live = [a for a in pool
                            if a not in self._breakers
                            or self._breakers[a].allow()]
                target = random.choice(live or pool)
                p = pkt.app_request(name, payload, rid)
                p["anycast"] = True
                p["deadline"] = wire_deadline
                with self._lock:
                    self._sent_at[rid] = (target, time.monotonic())
                self.m.send(target, self._stamp(p), cls=_overload.CLS_CLIENT)
                try:
                    resp = self._await(rid, per)
                except TimeoutError:
                    last = f"timeout via {target}"
                    charge_retry = True
                    self._penalize(target, per)
                    self._breaker(target).record(False)
                    continue
                if resp.get("ok"):
                    self._breaker(target).record(True)
                    return pkt.b64d(resp["response"]) or b""
                last = resp.get("error", "error")
                self._breaker(target).record(last != "busy")
                charge_retry = last == "busy"
                if last not in ("not_active", "stopped", "busy"):
                    raise ClientError(f"{name}: {last}")
                time.sleep(min(0.1 * (attempt + 1), 0.5))
            raise TimeoutError(f"{name}: {last}")
        finally:
            self._reap(rid)

    def _on_binary_batch_response(self, sender: str, buf: bytes) -> None:
        """Columnar response frame -> per-rid callbacks.  One lock
        acquisition covers the whole frame's bookkeeping."""
        _bid, rids, statuses, bodies = binbatch.decode_response(buf)
        self._batch_rtt(_bid)
        fire = []
        with self._lock:
            for rid, ok, body in zip(rids, statuses, bodies):
                rid = int(rid)
                self._sent_at.pop(rid, None)
                cb = self._callbacks.pop(rid, None)
                self._cb_deadline.pop(rid, None)
                if cb is not None:
                    if ok:
                        fire.append((cb, {"type": pkt.APP_RESPONSE,
                                          "rid": rid, "ok": True,
                                          "response_raw": body}))
                    else:
                        fire.append((cb, {"type": pkt.APP_RESPONSE,
                                          "rid": rid, "ok": False,
                                          "error": body.decode(
                                              "utf-8", "replace")}))
        for cb, p in fire:
            cb(p)

    def send_request_batch_binary(
        self,
        items,
        callback: Callable[[dict], None],
        active: Optional[str] = None,
    ) -> List[int]:
        """Binary twin of :meth:`send_request_batch` (net/binbatch.py SoA
        frames).  Successful responses carry raw bytes under
        ``response_raw`` (no base64 round-trip)."""
        by_target, rids, bid = self._stage_batch(items, callback, active)
        dl = self._wire_deadline()
        for i, (target, reqs) in enumerate(by_target.items()):
            self.m.send_bytes(target, binbatch.encode_request(
                bid + i, self.addr[0], self.addr[1], self.node_id, reqs,
                deadline=dl,
            ), cls=_overload.CLS_CLIENT)
        return rids

    def batching(self, max_batch: int = 128,
                 flush_interval_s: float = 0.002,
                 binary: bool = True) -> "BatchingSender":
        """A coalescing sender bound to this client (see BatchingSender)."""
        return BatchingSender(self, max_batch, flush_interval_s, binary)

    # ------------------------------------------------------------------ echo
    def echo(self, active: str, timeout: float = 5.0) -> float:
        """RTT-probe one active (handleEchoRequest analog); returns seconds."""
        rid = self._rid()
        t0 = time.monotonic()
        self.m.send(active, self._stamp({
            "type": pkt.ECHO_REQUEST, "ts": t0, "rid": rid,
        }))
        self._await(rid, timeout)
        rtt = time.monotonic() - t0
        prev = self._rtt.get(active)
        self._rtt[active] = rtt if prev is None else 0.875 * prev + 0.125 * rtt
        return rtt


class BatchingSender:
    """Auto-coalescing request front: submitted requests accumulate for up
    to ``flush_interval_s`` (or ``max_batch``) and leave as ONE
    APP_REQUEST_BATCH frame per target active — the client-side
    ``RequestBatcher`` (gigapaxos/RequestBatcher.java:25-60; batched
    RequestPacket, paxospackets/RequestPacket.java:189-233).  Per-frame JSON
    + syscall cost amortizes across the batch, which is what moves the
    loopback capacity knee (testing/capacity.py --batch).
    """

    def __init__(self, client: ReconfigurableAppClient, max_batch: int = 128,
                 flush_interval_s: float = 0.002, binary: bool = True):
        self.c = client
        self.max_batch = max_batch
        self.interval = flush_interval_s
        self.binary = binary
        self._buf: list = []  # (name, payload, callback)
        self._lock = threading.Lock()
        self._closed = False
        self._flusher = threading.Thread(target=self._run, daemon=True,
                                         name="batch-flusher")
        self._flusher.start()

    def submit(self, name: str, payload: bytes,
               callback: Callable[[dict], None]) -> None:
        flush_now = False
        with self._lock:
            self._buf.append((name, payload, callback))
            if len(self._buf) >= self.max_batch:
                flush_now = True
        if flush_now:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        # per-request callbacks ride the shared dispatcher; the rid->cb map
        # fills after the send returns (the loopback short-circuit can
        # deliver a response before this thread runs the fill loop).  Early
        # responses are BUFFERED, never block the client's demux thread —
        # a stalled send must not freeze unrelated responses for this
        # client, and a slow fill must not drop callbacks.
        cbs = {}
        early: list = []
        filled = [False]
        gate = threading.Lock()

        def dispatch(p: dict) -> None:
            with gate:
                if not filled[0]:
                    early.append(p)
                    return
            cb = cbs.pop(p.get("rid"), None)
            if cb is not None:
                cb(p)

        send = (self.c.send_request_batch_binary if self.binary
                else self.c.send_request_batch)
        try:
            rids = send([(n, pl) for n, pl, _ in buf], dispatch)
        except Exception as e:
            # resolve/send failure must not silently strand the whole
            # buffered batch: every callback gets an error packet.  Open
            # the gate with an empty cb map — a partially-sent batch's
            # real responses must be dropped (their callbacks just fired
            # with the error), not buffered in `early` forever
            with gate:
                filled[0] = True
                early[:] = []
            for _n, _p, cb in buf:
                try:
                    cb({"ok": False, "error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass
            return
        for rid, (_n, _p, cb) in zip(rids, buf):
            cbs[rid] = cb
        with gate:
            filled[0] = True
            drain, early[:] = early[:], []
        for p in drain:  # delivered on the flusher thread, in arrival order
            cb = cbs.pop(p.get("rid"), None)
            if cb is not None:
                cb(p)

    def _run(self) -> None:
        while not self._closed:
            time.sleep(self.interval)
            try:
                self.flush()
            except Exception:
                pass  # transient resolve/send errors: requests time out

    def close(self) -> None:
        self._closed = True
        self.flush()
