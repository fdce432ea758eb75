"""Capacity and overload twin: the port's capacity probe
(``testing/capacity.py``), open-loop harness (``testing/openloop.py``) and
test CA (``testing/certs.py``) on the CPU against the JAX package's, as
the reference's ``tests/test_capacity.py``, the non-slow cases of
``tests/test_overload_bench.py`` and those of ``tests/test_tls.py`` drive
them.

Tolerance: 0 on every verdict.  Load, latency and shed counts are timings
of this host, so each scenario records the reference test's verdicts
(probe passed, ladder monotone, a silent expired drop, a ``busy`` NACK
and its resumption, sheds past the knee and none of the control class,
TLS deliveries and rejections) and the two packages' records are equal.
The TLS cases skip where ``cryptography`` is missing, as the reference's
do.
"""

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from gigapaxos_tpu import overload as joverload
from gigapaxos_tpu import testing as jtesting
from gigapaxos_tpu.net import messenger as jmessenger
from gigapaxos_tpu.net import security as jsecurity
from gigapaxos_tpu.obs import metrics as jmetrics
from gigapaxos_tpu.reconfiguration import packets as jpkt
from gigapaxos_tpu.testing import openloop as jopenloop
from gigapaxos_tpu_torch import overload as toverload
from gigapaxos_tpu_torch import testing as ttesting
from gigapaxos_tpu_torch.net import messenger as tmessenger
from gigapaxos_tpu_torch.net import security as tsecurity
from gigapaxos_tpu_torch.obs import metrics as tmetrics
from gigapaxos_tpu_torch.reconfiguration import packets as tpkt
from gigapaxos_tpu_torch.testing import openloop as topenloop

PKGS = {
    "ref": SimpleNamespace(testing=jtesting, openloop=jopenloop,
                           overload=joverload, pkt=jpkt, metrics=jmetrics,
                           messenger=jmessenger, security=jsecurity,
                           certs="gigapaxos_tpu.testing.certs", kw={}),
    "port": SimpleNamespace(testing=ttesting, openloop=topenloop,
                            overload=toverload, pkt=tpkt, metrics=tmetrics,
                            messenger=tmessenger, security=tsecurity,
                            certs="gigapaxos_tpu_torch.testing.certs",
                            kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin(scenario):
    out = {key: scenario(P) for key, P in PKGS.items()}
    assert out["ref"] == out["port"]
    return out["port"]


# ------------------------------------------------------------ capacity
def test_loopback_probe_one_group():
    def sc(P):
        cluster, client = P.testing.make_loopback_cluster(n_groups=1,
                                                          **P.kw)
        try:
            r = P.testing.CapacityProbe(client, ["g0"]).run_once(
                load=100.0, duration_s=1.5)
            return [r.sent > 100, r.responded >= 0.9 * r.sent,
                    r.avg_latency_s < 1.0, r.passed(100.0)]
        finally:
            client.close()
            cluster.close()

    assert twin(sc) == [True] * 4


def test_probe_ladder_stops_on_failure():
    def sc(P):
        cluster, client = P.testing.make_loopback_cluster(n_groups=4,
                                                          **P.kw)
        try:
            probe = P.testing.CapacityProbe(client,
                                            [f"g{i}" for i in range(4)])
            runs = probe.probe(init_load=50.0, duration_s=1.0, max_runs=3)
            loads = [r.load for r in runs]
            return [1 <= len(runs) <= 3,
                    P.testing.CapacityProbe.capacity(runs) >= 0,
                    loads == sorted(loads), loads[0]]
        finally:
            client.close()
            cluster.close()

    assert twin(sc) == [True, True, True, 50.0]


# ------------------------------------------------------------ overload
@pytest.fixture(scope="module")
def overload_clusters():
    built = {}
    try:
        for key, P in PKGS.items():
            built[key] = P.openloop.make_overload_cluster(
                n_groups=2, intake_hi=64, **P.kw)
        yield built
    finally:
        for cluster, client in built.values():
            client.close()
            cluster.close()


def _expired_total(P, stage):
    return sum(int(m.value)
               for m in P.metrics.registry().find(
                   "overload_expired_drops_total")
               if dict(m.labels).get("stage") == stage)


def test_ar_ingress_drops_already_expired_silently(overload_clusters):
    def sc(P, client):
        before = _expired_total(P, "ar_ingress")
        fired = []
        rid = client._rid()
        with client._lock:
            client._callbacks[rid] = fired.append
            client._cb_deadline[rid] = time.monotonic() + 5.0
        p = P.pkt.app_request("g0", b"dead-on-arrival", rid)
        p["deadline"] = 1
        client.m.send("AR0", client._stamp(p), cls=P.overload.CLS_CLIENT)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if _expired_total(P, "ar_ingress") > before:
                break
            time.sleep(0.02)
        counted = _expired_total(P, "ar_ingress") - before
        time.sleep(0.3)
        with client._lock:
            client._callbacks.pop(rid, None)
            client._cb_deadline.pop(rid, None)
        return [counted, fired]

    out = {k: sc(P, overload_clusters[k][1]) for k, P in PKGS.items()}
    assert out["ref"] == out["port"] == [1, []]


def test_edge_nacks_busy_then_resumes(overload_clusters):
    def sc(P, cluster, client):
        gov = cluster.actives["AR0"].coord.intake_governor
        assert gov is not None

        def ask():
            got, ev = [], threading.Event()
            client.send_request("g0", b"probe",
                                lambda p: (got.append(p), ev.set()),
                                active="AR0")
            assert ev.wait(10), "no response from AR0"
            return got[0]

        hi, lo = gov.hi, gov.lo
        gov.hi = 0
        gov.lo = 0
        try:
            time.sleep(0.1)
            busy = ask()
        finally:
            gov.hi, gov.lo = hi, lo
            gov.update(0)
        again = ask()
        return [busy.get("ok"), busy.get("error"), again.get("ok")]

    out = {k: sc(P, *overload_clusters[k]) for k, P in PKGS.items()}
    assert out["ref"] == out["port"] == [False, "busy", True]


def test_open_loop_ramp_sheds_past_the_knee(overload_clusters):
    def sc(P, client):
        gen = P.openloop.OpenLoopGenerator(client, ["g0", "g1"],
                                           deadline_s=2.0)
        sheds0 = P.openloop.shed_totals()
        calm = gen.run_rung(n_clients=300, think_s=1.0, duration_s=0.8)
        over = gen.run_rung(n_clients=4000, think_s=1.0, duration_s=1.0,
                            drain_s=4.0)
        sheds1 = P.openloop.shed_totals()
        return [calm.admitted > 0, calm.lost, over.shed_busy > 0,
                over.admitted > 0, sheds1["client"] > sheds0["client"],
                sheds1["control"] - sheds0["control"],
                sheds0["control"]], over.to_dict()

    out = {k: sc(P, overload_clusters[k][1]) for k, P in PKGS.items()}
    rungs = {k: v[1] for k, v in out.items()}
    assert out["ref"][0] == out["port"][0] == [True, 0, True, True, True, 0,
                                               0], f"over the knee: {rungs}"


# ----------------------------------------------------------------- TLS
@pytest.fixture(scope="module")
def cas(tmp_path_factory):
    pytest.importorskip("cryptography")
    import importlib

    return {k: importlib.import_module(P.certs).make_test_ca(
        str(tmp_path_factory.mktemp(f"ca_{k}")), ("node", "client"))
        for k, P in PKGS.items()}


def _sec(P, ca, mode, who="node", with_cert=True):
    kw = {"mode": mode, "cafile": ca["ca"]}
    if with_cert:
        kw.update(certfile=ca[who][0], keyfile=ca[who][1])
    return P.security.TransportSecurity(**kw)


def _roundtrip(P, sec_a, sec_b, timeout):
    nm = P.messenger.NodeMap()
    ma = P.messenger.Messenger("A", ("127.0.0.1", 0), nm, security=sec_a)
    nm.add("A", "127.0.0.1", ma.port)
    mb = P.messenger.Messenger("B", ("127.0.0.1", 0), nm, security=sec_b)
    nm.add("B", "127.0.0.1", mb.port)
    try:
        got = []
        mb.register("hello", lambda s, p: got.append((s, p["x"])))
        ma.send("B", {"type": "hello", "x": 42})
        deadline = time.monotonic() + timeout
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        return got, mb.transport.stats.get("tls_rejects", 0) >= 1
    finally:
        ma.close()
        mb.close()


def test_test_ca_files_and_subjects(cas):
    from cryptography import x509

    def shape(ca):
        out = {}
        for k, v in sorted(ca.items()):
            path = v if k == "ca" else v[0]
            with open(path, "rb") as f:
                cert = x509.load_pem_x509_certificate(f.read())
            out[k] = (cert.subject.rfc4514_string(),
                      cert.issuer.rfc4514_string(),
                      sorted(e.oid.dotted_string for e in cert.extensions))
        return out

    assert shape(cas["ref"]) == shape(cas["port"])


@pytest.mark.parametrize("mode", ["SERVER_AUTH", "MUTUAL_AUTH"])
def test_tls_roundtrip(cas, mode):
    out = {}
    for k, P in PKGS.items():
        m = getattr(P.security.SSLMode, mode)
        sec = _sec(P, cas[k], m)
        out[k] = _roundtrip(P, sec, sec, 10.0)
    assert out["ref"] == out["port"] == ([("A", 42)], False)


def test_mutual_auth_rejects_certless_peer(cas):
    out = {}
    for k, P in PKGS.items():
        m = P.security.SSLMode.MUTUAL_AUTH
        out[k] = _roundtrip(P, _sec(P, cas[k], m, with_cert=False),
                            _sec(P, cas[k], m), 6.0)
    assert out["ref"] == out["port"] == ([], True)


def test_clear_client_cannot_reach_tls_server(cas):
    out = {}
    for k, P in PKGS.items():
        out[k] = _roundtrip(P, None,
                            _sec(P, cas[k], P.security.SSLMode.SERVER_AUTH),
                            6.0)[0]
    assert out["ref"] == out["port"] == []


def _tick_profile(n_ticks=50):
    """Torch calls of one eager manager tick program at the overload
    cluster's shape (R=3, W=8, P=4, G=64, compact), and the program's ms
    eager and scripted."""
    import numpy as np

    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as pst

    R, W, P, G = 3, 8, 4, 64
    state = pst.create_groups(pst.init_state(R, G, W, device="cpu"),
                              np.arange(G), np.ones((G, R), bool))
    req = torch.zeros((R, P, G), dtype=torch.int32)
    req[0, 0, :2] = torch.tensor([1, 2], dtype=torch.int32)
    inbox = pt.TickInbox(req, torch.zeros((R, P, G), dtype=torch.bool),
                         torch.ones(R, dtype=torch.bool))
    budget, lag = max(4096, 2 * G), 64

    def eager():
        st, out = pt.paxos_tick_impl(state, inbox, -1, budget)
        return st, pt._compact_outbox_impl(out, budget, lag)

    def scripted():
        return pt.paxos_tick_compact(state, inbox, -1, budget, lag)

    class Count(torch.overrides.TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        eager()
    out = {"torch_calls_eager": Count.n}
    for name, fn in (("eager", eager), ("scripted", scripted)):
        fn()
        t = time.perf_counter()
        for _ in range(n_ticks):
            fn()
        out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t) / n_ticks
    return out


class _PhaseTimes:
    """Per-package times of a manager tick's host phases and its device
    program, gathered by wrapping the managers' methods."""

    NAMES = ("tick", "_build_inbox", "_process_compact", "_complete_tick",
             "_flush_callbacks")

    def __init__(self):
        import collections

        self.t = collections.defaultdict(list)

    def wrap(self, key, obj, name, as_name=None):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.t[key, as_name or name].append(time.perf_counter() - t0)

        setattr(obj, name, timed)

    def take(self):
        out = {}
        for (key, name), xs in sorted(self.t.items()):
            xs = sorted(xs)
            out.setdefault(key, {})[name] = {
                "n": len(xs), "mean_ms": 1e3 * sum(xs) / len(xs),
                "p50_ms": 1e3 * xs[len(xs) // 2],
                "p99_ms": 1e3 * xs[int(0.99 * (len(xs) - 1))]}
        self.t.clear()
        return out


if __name__ == "__main__":
    # python -m tests.test_torch_capacity: the open-loop rungs of
    # test_open_loop_ramp_sheds_past_the_knee, both packages in one
    # process as the fixture builds them, with each package's tick phases
    # timed during every rung (the idle package's drivers keep ticking),
    # and the port's tick program alone (torch calls, ms eager and
    # scripted)
    import json

    import jax

    from gigapaxos_tpu.paxos import manager as jmanager
    from gigapaxos_tpu_torch.paxos import manager as tmanager

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    print(json.dumps({"tick_program": _tick_profile()}))
    phases = _PhaseTimes()
    for key, mod in (("ref", jmanager), ("port", tmanager)):
        for name in _PhaseTimes.NAMES:
            phases.wrap(key, mod.PaxosManager, name)
    phases.wrap("port", tmanager, "paxos_tick_health", "program")
    built = {k: P.openloop.make_overload_cluster(n_groups=2, intake_hi=64,
                                                 **P.kw)
             for k, P in PKGS.items()}
    try:
        time.sleep(1.0)
        phases.take()
        time.sleep(2.0)
        print(json.dumps({"idle_2s": phases.take()}))
        for k, P in PKGS.items():
            gen = P.openloop.OpenLoopGenerator(built[k][1], ["g0", "g1"],
                                               deadline_s=2.0)
            calm = gen.run_rung(n_clients=300, think_s=1.0, duration_s=0.8)
            phases.take()
            over = gen.run_rung(n_clients=4000, think_s=1.0, duration_s=1.0,
                                drain_s=4.0)
            print(json.dumps({"pkg": k, "calm": calm.to_dict(),
                              "over": over.to_dict(),
                              "phases_during_over": phases.take()}))
    finally:
        for cluster, client in built.values():
            client.close()
            cluster.close()
