"""Edge twin: the HTTP front ends, the DNS edge and the batched client edge
of the port (``reconfiguration/http_edge.py``, ``dns_edge.py``, the batch
frames through ``testing.capacity.make_loopback_cluster``) on the CPU
against the JAX package's, as the reference's ``tests/test_edges.py`` and
``tests/test_batch_edge.py`` drive them.

Tolerance: 0.  Each scenario records its status codes, JSON bodies, DNS
flags and answers, batch responses and execution counts; the two
packages' records are equal and the reference's assertions hold on both.
"""

import json
import socket
import struct
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from gigapaxos_tpu import client as jclient
from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu import node as jnode
from gigapaxos_tpu.models import replicable as jrep
from gigapaxos_tpu.reconfiguration import dns_edge as jdns
from gigapaxos_tpu.reconfiguration import http_edge as jhttp
from gigapaxos_tpu.reconfiguration import packets as jpkt
from gigapaxos_tpu.testing import capacity as jcap
from gigapaxos_tpu_torch import client as tclient
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch import node as tnode
from gigapaxos_tpu_torch.models import replicable as trep
from gigapaxos_tpu_torch.reconfiguration import dns_edge as tdns
from gigapaxos_tpu_torch.reconfiguration import http_edge as thttp
from gigapaxos_tpu_torch.reconfiguration import packets as tpkt
from gigapaxos_tpu_torch.testing import capacity as tcap

PKGS = {
    "ref": SimpleNamespace(client=jclient, config=jconfig, node=jnode,
                           rep=jrep, dns=jdns, http=jhttp, pkt=jpkt,
                           cap=jcap, kw={}),
    "port": SimpleNamespace(client=tclient, config=tconfig, node=tnode,
                            rep=trep, dns=tdns, http=thttp, pkt=tpkt,
                            cap=tcap, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stack:
    """One package's cluster, client, HTTP front ends and DNS edge."""

    def __init__(self, P):
        cfg = P.config.GigapaxosTpuConfig()
        cfg.paxos.max_groups = 64
        for i in range(3):
            cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
            cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
        self.cl = P.node.InProcessCluster(cfg, P.rep.KVApp, **P.kw)
        self.client = P.client.ReconfigurableAppClient(cfg.nodes)
        self.rc_http = P.http.HttpReconfigurator(self.client,
                                                 ("127.0.0.1", 0))
        self.ar_http = P.http.HttpActiveReplica(self.client,
                                                ("127.0.0.1", 0))
        self.dns = P.dns.DnsReconfigurator(self.client, ("127.0.0.1", 0))

    def close(self):
        self.dns.close()
        self.rc_http.close()
        self.ar_http.close()
        self.client.close()
        self.cl.close()


@pytest.fixture(scope="module")
def stacks():
    built = {}
    try:
        for key, P in PKGS.items():
            built[key] = Stack(P)
        yield built
    finally:
        for s in built.values():
            s.close()


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def dns_query(port, qname, qtype=1):
    q = struct.pack(">HHHHHH", 0x1234, 0x0100, 1, 0, 0, 0)
    for label in qname.split("."):
        q += bytes([len(label)]) + label.encode()
    q += b"\x00" + struct.pack(">HH", qtype, 1)  # IN
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(30)
    s.sendto(q, ("127.0.0.1", port))
    data, _ = s.recvfrom(512)
    s.close()
    _tid, flags, _qd, an, _ns, _ar = struct.unpack(">HHHHHH", data[:12])
    ips, off = [], 12
    while data[off]:
        off += 1 + data[off]
    off += 5
    for _ in range(an):
        off += 2  # name pointer
        _rt, _rc, ttl, rdlen = struct.unpack(">HHIH", data[off: off + 10])
        off += 10
        ips.append((socket.inet_ntoa(data[off: off + rdlen]), ttl))
        off += rdlen
    return flags, ips


def both(stacks, scenario):
    ref = scenario(stacks["ref"])
    port = scenario(stacks["port"])
    assert ref == port
    return port


# -------------------------------------------------------------- HTTP / DNS
def test_http_create_request_delete(stacks):
    def sc(s):
        rc, ar = s.rc_http.port, s.ar_http.port
        out = [_get(rc, "/?type=CREATE&name=Alice"),
               _get(ar, "/?name=Alice&qval=PUT%20k%20v1"),
               _get(ar, "/?name=Alice&qval=GET%20k")]
        code, resp = _get(rc, "/?type=REQ_ACTIVES&name=Alice")
        out.append((code, sorted(resp["ACTIVES"])))
        out += [_get(rc, "/?type=DELETE&name=Alice")[0],
                _get(rc, "/?type=REQ_ACTIVES&name=Alice")[0]]
        return out

    r = both(stacks, sc)
    assert r[0][0] == 200 and not r[0][1]["FAILED"]
    assert r[1][1]["RVAL"] == "OK" and r[2][1]["RVAL"] == "v1"
    assert r[2][1]["NAME"] == "Alice" and len(r[3][1]) == 3
    assert r[4:] == [200, 404]


def test_http_bad_request(stacks):
    r = both(stacks, lambda s: [_get(s.rc_http.port, "/?type=CREATE"),
                                _get(s.rc_http.port, "/?type=NOPE&name=x"),
                                _get(s.ar_http.port, "/?qval=GET%20k")])
    assert r[0][0] == 400


def test_dns_resolves_actives(stacks):
    def sc(s):
        return [s.client.create("web")["ok"],
                dns_query(s.dns.port, "web.gp"),
                sorted(s.client.request_actives("web"))]

    r = both(stacks, sc)
    flags, ips = r[1]
    assert r[0] is True and flags & 0x8000 and (flags & 0x000F) == 0
    assert len(ips) == 3 and all(ip == "127.0.0.1" for ip, _ in ips)


def test_dns_nxdomain_and_non_a_queries(stacks):
    r = both(stacks, lambda s: [dns_query(s.dns.port, "nosuch.gp"),
                                dns_query(s.dns.port, "web.gp", qtype=28)])
    assert (r[0][0] & 0x000F) == 3 and r[0][1] == []


# ------------------------------------------------------------- batch edge
def _collect(n):
    got, lock, ev = [], threading.Lock(), threading.Event()

    def cb(p):
        with lock:
            got.append(p)
            if len(got) >= n:
                ev.set()

    return got, cb, ev


def batch_twin(scenario, n_groups):
    out = {}
    for key, P in PKGS.items():
        cluster, client = P.cap.make_loopback_cluster(n_groups=n_groups,
                                                      **P.kw)
        try:
            out[key] = scenario(P, cluster, client)
        finally:
            client.close()
            cluster.close()
    assert out["ref"] == out["port"]
    return out["port"]


def test_batch_roundtrip():
    def sc(P, cluster, client):
        items = [(f"g{i % 4}", f"req{i}".encode()) for i in range(32)]
        got, cb, ev = _collect(32)
        rids = client.send_request_batch(items, cb)
        assert ev.wait(20), f"only {len(got)} responses"
        return [len(set(rids)), sorted(bool(p.get("ok")) for p in got),
                sorted(P.pkt.b64d(p["response"]) for p in got)]

    r = batch_twin(sc, 4)
    assert r[0] == 32 and all(r[1])
    assert r[2] == sorted(b"ok:" + f"req{i}".encode() for i in range(32))


def test_batch_error_isolation():
    def sc(P, cluster, client):
        actives = client.request_actives("g0")
        got, cb, ev = _collect(3)
        client.send_request_batch([("g0", b"a"), ("nope", b"b"),
                                   ("g1", b"c")], cb, active=actives[0])
        assert ev.wait(20)
        return sorted((bool(p.get("ok")), p.get("error")) for p in got)

    r = batch_twin(sc, 2)
    assert r == [(False, "not_active"), (True, None), (True, None)]


def test_batching_sender_coalesces():
    def sc(P, cluster, client):
        sender = client.batching(max_batch=16, flush_interval_s=0.01)
        got, cb, ev = _collect(64)
        for i in range(64):
            sender.submit(f"g{i % 4}", f"p{i}".encode(), cb)
        assert ev.wait(20), f"only {len(got)} responses"
        sender.close()
        return sorted((bool(p.get("ok")), p.get("response", ""))
                      for p in got)

    r = batch_twin(sc, 4)
    assert all(ok for ok, _ in r) and len(r) == 64


def test_batch_retransmission_dedup():
    def sc(P, cluster, client):
        got, cb, ev = _collect(2)
        client.send_request_batch([("g0", b"x1"), ("g0", b"x2")], cb)
        assert ev.wait(20)
        execs_before = cluster.manager.stats["executions"]
        reqs = [["g0", 999001, P.pkt.b64e(b"x1")],
                ["g0", 999002, P.pkt.b64e(b"x2")]]
        p = {"type": P.pkt.APP_REQUEST_BATCH, "bid": 424242, "reqs": reqs,
             "client_addr": [client.addr[0], client.addr[1]]}
        target = client.request_actives("g0")[0]
        out = []
        for _ in range(2):  # the frame, then the same frame again
            got2, cb2, ev2 = _collect(2)
            with client._lock:
                for r in (999001, 999002):
                    client._callbacks[r] = cb2
                    client._cb_deadline[r] = time.monotonic() + 30
            client.m.send(target, dict(p))
            assert ev2.wait(20)
            time.sleep(1.0)
            out.append((sorted((q["rid"], q.get("ok"),
                                P.pkt.b64d(q["response"])) for q in got2),
                        cluster.manager.stats["executions"] - execs_before))
        return out

    r = batch_twin(sc, 1)
    assert r[0][1] > 0 and r[1][1] == r[0][1]
