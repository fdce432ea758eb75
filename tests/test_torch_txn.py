"""Transaction twin: the ten cases of the reference's ``tests/test_txn.py``
(atomic commits across names, conflicting transactions, locks that block
plain requests, aborts, lock state through checkpoints, the global lock
order, stale-lock expiry) on the port's ``DistTransactor`` and ``TxApp``
over its ``PaxosManager`` (CPU) against the JAX package's.

Tolerance: 0.  Each scenario records what it observed (commit and abort
flags, per-name results, replies to lock ops, every replica's app state
and lock table); the two packages' records are equal and the reference's
own assertions hold on both.  Transaction ids are random, so the records
hold outcomes, never ids.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu import txn as jtxn
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.paxos import driver as jdriver
from gigapaxos_tpu.paxos import manager as jmgr
from gigapaxos_tpu.txn import transactor as jtransactor
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch import txn as ttxn
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.paxos import driver as tdriver
from gigapaxos_tpu_torch.paxos import manager as tmgr
from gigapaxos_tpu_torch.txn import transactor as ttransactor

PKGS = {
    "ref": SimpleNamespace(config=jconfig, txn=jtxn, rep=jrep,
                           driver=jdriver, mgr=jmgr, tr=jtransactor, kw={}),
    "port": SimpleNamespace(config=tconfig, txn=ttxn, rep=trep,
                            driver=tdriver, mgr=tmgr, tr=ttransactor,
                            kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def counter_app(P):
    class CounterApp(P.rep.Replicable):
        """``ADD <delta>`` / ``GET`` per name."""

        def __init__(self):
            self.vals = {}

        def execute(self, name, request, request_id):
            parts = request.decode().split()
            if parts and parts[0] == "ADD":
                self.vals[name] = self.vals.get(name, 0) + int(parts[1])
                return str(self.vals[name]).encode()
            if parts and parts[0] == "GET":
                return str(self.vals.get(name, 0)).encode()
            return b"ERR"

        def checkpoint(self, name):
            return str(self.vals.get(name, 0)).encode()

        def restore(self, name, state):
            self.vals[name] = int(state) if state else 0

    return CounterApp


class Plane:
    """Three replicas of ``TxApp(app)`` under one driven manager."""

    def __init__(self, P, app_cls, names):
        cfg = P.config.GigapaxosTpuConfig()
        cfg.paxos.max_groups = 16
        self.mgr = P.mgr.PaxosManager(
            cfg, 3, [P.txn.TxApp(app_cls()) for _ in range(3)], **P.kw)
        for name in names:
            self.mgr.create_paxos_instance(name, [0, 1, 2])
        self.driver = P.driver.TickDriver(self.mgr).start()
        self.driver.wait_ready()

    def coordinate(self, name, payload, cb):
        r = self.mgr.propose(name, payload, cb)
        self.driver.kick()
        return r

    def call(self, name, payload):
        ev, got = threading.Event(), {}
        self.coordinate(name, payload,
                        lambda rid, r: (got.update(r=r), ev.set()))
        assert ev.wait(20)
        return got["r"]

    def close(self):
        self.driver.stop()


def twin(scenario, app="kv", names=("acct", "bank", "log")):
    """Run ``scenario(P, plane)`` on each package; the records, equal."""
    out = {}
    for key, P in PKGS.items():
        cls = P.rep.KVApp if app == "kv" else counter_app(P)
        plane = Plane(P, cls, names)
        try:
            out[key] = scenario(P, plane)
        finally:
            plane.close()
    assert out["ref"] == out["port"]
    return out["port"]


def kv_state(plane):
    return [(a.app.db, a.locks, a.lock_deadlines) for a in plane.mgr.apps]


def counter_state(plane):
    return [(a.app.vals, a.locks, a.lock_deadlines) for a in plane.mgr.apps]


def _res(res):
    return [res.committed, res.aborted, res.results]


def test_commit_across_names():
    def sc(P, plane):
        res = P.txn.DistTransactor(plane.coordinate).transact([
            ("acct", b"PUT alice 100"), ("bank", b"PUT total 100"),
            ("log", b"PUT last credit")]).wait()
        assert res.committed and not res.aborted
        assert res.result_for("acct") == b"OK"
        for a in plane.mgr.apps:
            assert a.app.db["acct"]["alice"] == "100" and a.locks == {}
        return _res(res) + [res.result_for("acct"), kv_state(plane)]

    assert twin(sc)[2] == [b"OK", b"OK", b"OK"]


def test_conflicting_txns_serialize():
    def sc(P, plane):
        tx = P.txn.DistTransactor(plane.coordinate, retry_delay_s=0.02)
        results = []

        def run(i):
            results.append(tx.transact([
                ("acct", f"PUT ctr {i}".encode()),
                ("bank", f"PUT ctr {i}".encode())]).wait())

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        [t.start() for t in ts]
        [t.join(timeout=60) for t in ts]
        assert len(results) == 4 and all(r.committed for r in results)
        db = plane.mgr.apps[0].app.db
        # which of the four wins is a race: record that both names agree
        return [sorted(r.committed for r in results),
                db["acct"]["ctr"] == db["bank"]["ctr"],
                [a.locks for a in plane.mgr.apps]]

    assert twin(sc)[1] is True


def test_lock_blocks_plain_requests():
    def sc(P, plane):
        return [plane.call("acct", P.txn.tx_payload("lock", "heldtx")),
                plane.call("acct", b"PUT x 1"),
                plane.call("acct", P.txn.tx_payload("unlock", "heldtx")),
                plane.call("acct", b"PUT x 1"), kv_state(plane)]

    r = twin(sc)
    assert r[:2] == [b"TX_OK", jtxn.TX_LOCKED] and r[3] == b"OK"


def test_abort_on_unknown_name():
    def sc(P, plane):
        tx = P.txn.DistTransactor(plane.coordinate, max_lock_retries=2,
                                  retry_delay_s=0.01)
        res = tx.transact([("acct", b"PUT a 1"), ("nosuch", b"PUT b 2")]
                          ).wait()
        assert res.aborted and not res.committed
        assert plane.mgr.apps[0].locks == {}
        assert "a" not in plane.mgr.apps[0].app.db.get("acct", {})
        return _res(res) + [kv_state(plane)]

    twin(sc)


def sc_checkpoint_carries_lock(P):
    app = P.txn.TxApp(P.rep.KVApp())
    out = [app.execute("n", b"PUT k v", 1),
           app.execute("n", P.txn.tx_payload("lock", "t1"), 2)]
    blob = app.checkpoint("n")
    fresh = P.txn.TxApp(P.rep.KVApp())
    fresh.restore("n", blob)
    assert fresh.locks["n"] == "t1" and fresh.app.db["n"]["k"] == "v"
    out += [blob, dict(fresh.locks), fresh.app.db]
    app.execute("n", P.txn.tx_payload("unlock", "t1"), 3)
    blob2 = app.checkpoint("n")
    assert blob2.startswith(b"\x01TX\x01")
    fresh.restore("n", blob2)
    assert "n" not in fresh.locks and fresh.app.db["n"]["k"] == "v"
    return out + [blob2, dict(fresh.locks)]


def test_txapp_checkpoint_carries_lock():
    assert sc_checkpoint_carries_lock(PKGS["ref"]) == \
        sc_checkpoint_carries_lock(PKGS["port"])


def test_counter_commit_and_sorted_lock_order():
    def sc(P, plane):
        magic = P.tr.TX_MAGIC
        lock_order = []

        def spying(name, payload, cb):
            if payload.startswith(magic):
                body = payload[len(magic):]
                sep = body.find(b"\x00")
                meta = json.loads((body if sep < 0 else body[:sep]).decode())
                if meta["op"] == "lock":
                    lock_order.append(name)
            return plane.coordinate(name, payload, cb)

        res = P.txn.DistTransactor(spying).transact(
            [("bbb", b"ADD 10"), ("aaa", b"ADD -10")]).wait()
        assert res.committed and lock_order == ["aaa", "bbb"]
        return _res(res) + [lock_order, counter_state(plane)]

    r = twin(sc, app="counter", names=("aaa", "bbb"))
    assert r[-1][0][0] == {"aaa": -10, "bbb": 10}


def test_counter_abort_on_locked():
    def sc(P, plane):
        out = [plane.call("bbb", P.txn.tx_payload("lock", "rivaltx"))]
        tx = P.txn.DistTransactor(plane.coordinate, max_lock_retries=2,
                                  retry_delay_s=0.01)
        res = tx.transact([("aaa", b"ADD 5"), ("bbb", b"ADD -5")]).wait()
        assert res.aborted and not res.committed
        assert plane.mgr.apps[0].locks == {"bbb": "rivaltx"}
        return out + _res(res) + [counter_state(plane)]

    twin(sc, app="counter", names=("aaa", "bbb"))


def test_crash_during_commit_releases_stale_locks():
    dead_dl = int(time.time() * 1000) - 1  # one stamp for both packages

    def sc(P, plane):
        out = [plane.call(n, P.txn.tx_payload("lock", "deadtx",
                                              now=dead_dl - 10,
                                              deadline=dead_dl))
               for n in ("aaa", "bbb")]
        out.append(plane.call("aaa", b"ADD 1"))
        tx = P.txn.DistTransactor(plane.coordinate, lock_ttl_s=30.0)
        res = tx.transact([("aaa", b"ADD 7"), ("bbb", b"ADD -7")]).wait()
        assert res.committed and not res.aborted
        for a in plane.mgr.apps:
            assert a.app.vals == {"aaa": 7, "bbb": -7}
            assert a.locks == {} and a.lock_deadlines == {}
        return out + _res(res) + [counter_state(plane)]

    r = twin(sc, app="counter", names=("aaa", "bbb"))
    assert r[:3] == [b"TX_OK", b"TX_OK", jtxn.TX_LOCKED]


def sc_expired_holder(P):
    stream = [
        P.txn.tx_payload("lock", "t1", now=1000, deadline=2000),
        P.txn.tx_payload("lock", "t2", now=3000, deadline=9000),
        P.txn.tx_payload("exec", "t1", b"ADD 1", now=3500),
        P.txn.tx_payload("unlock", "t1", now=3600),
        P.txn.tx_payload("exec", "t2", b"ADD 5", now=4000),
        P.txn.tx_payload("unlock", "t2", now=4100),
    ]
    outs = []
    for _ in range(2):
        app = P.txn.TxApp(counter_app(P)())
        outs.append([app.execute("n", p, i) for i, p in enumerate(stream)])
        assert app.locks == {} and app.lock_deadlines == {}
        assert app.app.vals["n"] == 5
    assert outs[0] == outs[1]
    return [stream, outs]


def test_expired_holder_exec_refused_and_replay_deterministic():
    r = sc_expired_holder(PKGS["port"])
    assert r == sc_expired_holder(PKGS["ref"])
    assert r[1][0][1] == b"TX_OK" and r[1][0][2] == jtxn.TX_LOCKED


def sc_checkpoint_deadline(P):
    app = P.txn.TxApp(counter_app(P)())
    out = [app.execute("n", P.txn.tx_payload("lock", "t1", now=10,
                                             deadline=500), 1)]
    fresh = P.txn.TxApp(counter_app(P)())
    fresh.restore("n", app.checkpoint("n"))
    assert fresh.locks["n"] == "t1" and fresh.lock_deadlines["n"] == 500
    out += [app.checkpoint("n"), dict(fresh.lock_deadlines),
            fresh.execute("n", P.txn.tx_payload("lock", "t2", now=501,
                                                deadline=900), 2),
            dict(fresh.locks)]
    assert fresh.locks["n"] == "t2"
    return out


def test_checkpoint_carries_lock_deadline():
    assert sc_checkpoint_deadline(PKGS["port"]) == \
        sc_checkpoint_deadline(PKGS["ref"])
