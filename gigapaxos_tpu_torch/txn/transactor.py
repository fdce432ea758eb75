"""Distributed transactions over multiple service names.

Analog of ``src/edu/umass/cs/txn`` (SURVEY §2.5, ~2k LoC, experimental in
the reference and tested only by a Noop app — same status here):

* ``DistTransactor`` (txn/DistTransactor.java:36) — extends the replica
  coordination SPI with multi-name transactions;
* lock/unlock (``TXLockerMap``, ``txpackets/LockRequest.java``) — here the
  lock table is *replicated state*: lock and unlock are coordinated
  requests executed by every replica of the participant group, so a lock
  survives replica failover exactly like app state (the reference inserts
  LockRequests through the same coordination path);
* 2PC shape (``CommitRequest``/``AbortRequest``): lock acquisition is the
  prepare phase, execution + unlock is the commit, releasing held locks on
  a failed acquire is the abort.  Deadlock freedom comes from acquiring in
  global (sorted-name) order, so no wait-for cycle can form.

Wire format: a transactional payload is ``TX_MAGIC + json + [0x00 + inner]``
understood by :class:`TxApp`, a :class:`Replicable` wrapper that owns the
per-name lock entry and passes everything else through to the real app.
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from ..models.replicable import Replicable

TX_MAGIC = b"\x01TX\x01"

#: lock denial marker returned by TxApp for ops on a locked name
TX_LOCKED = b"\x01TX_LOCKED"


def tx_payload(op: str, txid: str, inner: Optional[bytes] = None,
               now: Optional[int] = None,
               deadline: Optional[int] = None) -> bytes:
    """``now``/``deadline`` are wire deadlines (unix ms,
    overload.deadline_at): ``deadline`` on a lock op bounds how long the
    acquired lock may be held; ``now`` is the sender's clock stamp that
    lets participants expire stale locks deterministically (the stamp is
    part of the ordered payload bytes, so every replica sees the same
    value at the same slot — no local clock reads in the decision)."""
    meta: Dict[str, object] = {"op": op, "txid": txid}
    if now is not None:
        meta["now"] = int(now)
    if deadline is not None:
        meta["deadline"] = int(deadline)
    head = TX_MAGIC + json.dumps(meta).encode()
    return head + b"\x00" + inner if inner is not None else head


class TxApp(Replicable):
    """Replicable wrapper adding a transactional lock entry per name.

    Deterministic by construction: the lock table is derived purely from
    the totally-ordered request stream, so every replica agrees on it.

    Semantics (TXLockerMap analog):
    * ``lock``   — acquire for txid; idempotent re-acquire by the same txid
      succeeds; denial returns ``TX_LOCKED`` (the transactor aborts/retries);
    * ``unlock`` — release if held by txid (idempotent);
    * ``exec``   — run the inner request iff the lock is held by txid;
    * any non-transactional request on a locked name is refused with
      ``TX_LOCKED`` — the client retries after the transaction commits.

    Stale-lock expiry: a coordinator crashing between lock and
    commit would leave the lock held forever.  Lock ops may carry a
    ``deadline`` (unix ms) bounding the hold; any later *conflicting* tx
    op stamped with the sender's ``now`` auto-releases a lock whose
    deadline has passed before the normal logic runs.  Both stamps ride
    the ordered payload, so expiry is a pure function of the request
    stream — identical on every replica and under WAL replay.
    """

    def __init__(self, app: Replicable):
        self.app = app
        self.locks: Dict[str, str] = {}  # name -> holder txid
        self.lock_deadlines: Dict[str, int] = {}  # name -> unix-ms bound

    def execute(self, name: str, request: bytes, request_id: int) -> bytes:
        if not request.startswith(TX_MAGIC):
            if name in self.locks:
                return TX_LOCKED
            return self.app.execute(name, request, request_id)
        body = request[len(TX_MAGIC):]
        sep = body.find(b"\x00")
        meta = json.loads((body if sep < 0 else body[:sep]).decode())
        inner = None if sep < 0 else body[sep + 1:]
        op, txid = meta["op"], meta["txid"]
        holder = self.locks.get(name)
        # deterministic stale-lock expiry: a conflicting op whose ordered
        # now-stamp exceeds the holder's deadline releases the lock (the
        # holder's own ops never expire it — idempotent re-acquire and a
        # late commit by a live-but-slow coordinator both stay legal; its
        # exec after a rival expired the lock gets TX_LOCKED and aborts)
        if holder is not None and holder != txid:
            dl = self.lock_deadlines.get(name, 0)
            if 0 < dl < int(meta.get("now") or 0):
                del self.locks[name]
                self.lock_deadlines.pop(name, None)
                holder = None
        if op == "lock":
            if holder is None or holder == txid:
                self.locks[name] = txid
                dl = int(meta.get("deadline") or 0)
                if dl > 0:
                    self.lock_deadlines[name] = dl
                else:
                    self.lock_deadlines.pop(name, None)
                return b"TX_OK"
            return TX_LOCKED
        if op == "unlock":
            if holder == txid:
                del self.locks[name]
                self.lock_deadlines.pop(name, None)
            return b"TX_OK"
        if op == "exec":
            if holder != txid:
                return TX_LOCKED
            return self.app.execute(name, inner or b"", request_id)
        return b"TX_BADOP"

    def checkpoint(self, name: str) -> bytes:
        # ALWAYS envelope — an unwrapped inner blob that happened to begin
        # with TX_MAGIC would be misparsed as a lock header on restore
        inner = self.app.checkpoint(name)
        holder = self.locks.get(name)
        meta = {"holder": holder}
        dl = self.lock_deadlines.get(name)
        if holder is not None and dl:
            meta["deadline"] = dl
        return TX_MAGIC + json.dumps(meta).encode() + b"\x00" + inner

    def restore(self, name: str, state: bytes) -> None:
        if state.startswith(TX_MAGIC):
            body = state[len(TX_MAGIC):]
            sep = body.find(b"\x00")
            try:
                meta = json.loads(body[:sep].decode())
            except (ValueError, UnicodeDecodeError):
                meta = None  # raw client state that collides with the magic
            if meta is not None:
                if meta.get("holder") is None:
                    self.locks.pop(name, None)
                    self.lock_deadlines.pop(name, None)
                else:
                    self.locks[name] = meta["holder"]
                    dl = int(meta.get("deadline") or 0)
                    if dl > 0:
                        self.lock_deadlines[name] = dl
                    else:
                        self.lock_deadlines.pop(name, None)
                self.app.restore(name, body[sep + 1:])
                return
        # plain state (client-provided initial state / legacy checkpoint)
        self.locks.pop(name, None)
        self.lock_deadlines.pop(name, None)
        self.app.restore(name, state)


class TxResult:
    def __init__(self, txid: str):
        self.txid = txid
        self.committed = False
        self.aborted = False
        #: True when wait() gave up before the transaction finished — the
        #: background worker may STILL commit later; callers must not treat
        #: a timed-out result as a clean abort (retrying would double-apply)
        self.timed_out = False
        self.error: Optional[str] = None
        #: per-op results, aligned with the ops list (a name may appear in
        #: several ops; keying by name would drop all but the last)
        self.results: List[Optional[bytes]] = []
        self._ev = threading.Event()

    def result_for(self, name: str, ops=None) -> Optional[bytes]:
        """Convenience: the last result for ``name`` (ops optional when the
        transactor recorded them)."""
        ops = ops if ops is not None else self._ops
        for i in range(len(self.results) - 1, -1, -1):
            if ops[i][0] == name:
                return self.results[i]
        return None

    def wait(self, timeout: float = 30.0) -> "TxResult":
        self.timed_out = not self._ev.wait(timeout)
        return self

    def _finish(self) -> None:
        self._ev.set()


class DistTransactor:
    """Drives multi-name transactions through any coordinator SPI.

    ``coordinate(name, payload, callback)`` is the single dependency — bind
    it to ``AbstractReplicaCoordinator.coordinate_request`` (server side) or
    to an async client's ``send_request`` (client side).
    """

    def __init__(
        self,
        coordinate: Callable[[str, bytes, Callable[[Optional[bytes]], None]], object],
        max_lock_retries: int = 20,
        retry_delay_s: float = 0.05,
        lock_ttl_s: Optional[float] = None,
    ):
        """``lock_ttl_s``: bound every acquired lock's hold time (the
        wire-deadline unit under the hood).  A transactor that crashes
        between lock and commit then no longer wedges the participants —
        the next conflicting transaction's stamped op expires the stale
        lock.  None (default) keeps the original hold-forever semantics."""
        self.coordinate = coordinate
        self.max_lock_retries = max_lock_retries
        self.retry_delay_s = retry_delay_s
        self.lock_ttl_s = lock_ttl_s

    # ------------------------------------------------------------------ public
    def transact(
        self,
        ops: List[Tuple[str, bytes]],
        callback: Optional[Callable[[TxResult], None]] = None,
    ) -> TxResult:
        """Atomically execute ``ops`` = [(name, request), ...] across names.

        Runs asynchronously; returns a :class:`TxResult` whose ``wait()``
        blocks for completion.  All-or-nothing: either every op executes
        under locks (committed) or none do (aborted)."""
        txid = uuid.uuid4().hex[:16]
        res = TxResult(txid)
        res._ops = list(ops)
        t = threading.Thread(
            target=self._run, args=(ops, res, callback),
            name=f"tx-{txid}", daemon=True,
        )
        t.start()
        return res

    # ----------------------------------------------------------------- phases
    def _call(self, name: str, payload: bytes,
              timeout: float = 15.0) -> Optional[bytes]:
        ev = threading.Event()
        box: List[Optional[bytes]] = [None]

        def cb(*args) -> None:
            # server SPI callbacks are (rid, resp); client ones may be (resp)
            r = args[-1]
            if isinstance(r, dict):
                # client binding (send_request) delivers the raw response
                # packet {ok, response(b64), error}; unwrap to the app payload
                # so the TX_OK/TX_LOCKED comparisons below see real bytes
                from ..reconfiguration import packets as pkt

                r = (pkt.b64d(r.get("response")) or b"") if r.get("ok") else None
            box[0] = r
            ev.set()

        r = self.coordinate(name, payload, cb)
        if r is None:
            return None
        if not ev.wait(timeout):
            return None
        return box[0]

    def _run(self, ops, res: TxResult, callback) -> None:
        import time

        def now_ms() -> Optional[int]:
            # stamp ops only when expiry is enabled: unstamped payloads
            # keep the original bytes, so existing journals/tests are
            # byte-identical when lock_ttl_s is None
            return int(time.time() * 1000) if self.lock_ttl_s else None

        names = sorted({n for n, _ in ops})  # global order = deadlock freedom
        held: List[str] = []
        try:
            # ---- phase 1 (prepare): lock every participant, in order
            for n in names:
                # mark as possibly-held BEFORE the first attempt: a lock
                # proposal whose reply times out can still commit later, and
                # the abort path must unlock it or the name wedges forever
                # (unlock of a never-acquired lock is an idempotent no-op)
                held.append(n)
                acquired = False
                for attempt in range(self.max_lock_retries):
                    dl = (None if self.lock_ttl_s is None
                          else int(time.time() * 1000
                                   + self.lock_ttl_s * 1000))
                    r = self._call(n, tx_payload("lock", res.txid,
                                                 now=now_ms(), deadline=dl))
                    if r == b"TX_OK":
                        acquired = True
                        break
                    if r is None:
                        break  # unknown name / stopped epoch: abort
                    time.sleep(self.retry_delay_s * (attempt + 1))
                if not acquired:
                    res.aborted = True
                    res.error = f"lock failed on {n}"
                    return
            # ---- phase 2 (commit): execute under locks
            for n, payload in ops:
                r = self._call(n, tx_payload("exec", res.txid, payload,
                                             now=now_ms()))
                if r is None or r == TX_LOCKED:
                    # lock lost (epoch change mid-tx or our lease expired
                    # under a rival's stamp): abort — executed ops on
                    # other names are NOT rolled back, matching the
                    # experimental reference's semantics; see module doc
                    res.aborted = True
                    res.error = f"exec failed on {n}"
                    return
                res.results.append(r)
            res.committed = True
        finally:
            # release on abort covers the expired-txid case too: unlock is
            # holder-checked, so releasing a lock a rival already expired
            # and re-acquired is a no-op rather than a theft
            for n in held:
                self._call(n, tx_payload("unlock", res.txid, now=now_ms()))
            res._finish()
            if callback is not None:
                callback(res)
