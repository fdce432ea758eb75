"""Cluster twin of the lease plane: an ``InProcessCluster`` of each package
with ``read_leases`` on answers GETs through the lease-local branch of the
manager's ``read`` (the response packet carries ``local: true``) with the
reference's responses.

Tolerance: 0 on the responses, less what the client picks at random (rid,
answering active).
"""

import base64
import threading
import time

import pytest

from test_torch_cluster import PKGS, make_cfg


class LeaseSide:
    """One package's cluster (read leases on) and client."""

    def __init__(self, pkg):
        cfg_cls, kv, cluster_cls, client_cls, _, _, kw = PKGS[pkg]
        cfg = make_cfg(cfg_cls)
        cfg.paxos.read_leases = True
        cfg.paxos.lease_ticks = 64
        cfg.paxos.lease_margin_ticks = 8
        self.cluster = cluster_cls(cfg, kv, **kw)
        self.client = client_cls(self.cluster.cfg.nodes)

    def close(self):
        self.client.close()
        self.cluster.close()

    def raw_read(self, name, payload, timeout=60.0):
        """One CLS_READ through the wire; the raw response packet."""
        got, done = {}, threading.Event()

        def cb(p):
            got.update(p)
            done.set()

        self.client.send_read(name, payload, cb)
        assert done.wait(timeout), "read timed out"
        return got


@pytest.fixture(scope="module")
def lease_sides():
    s = {}
    try:
        for pkg in PKGS:
            s[pkg] = LeaseSide(pkg)
        yield s
    finally:
        for side in s.values():
            side.close()


def _read_local(side, name, payload, tries=200):
    """Read until the answer comes from the lease holder's app (the lease
    is granted by the ticks after the group's first decision, and a read
    is local only once the group is quiescent)."""
    for _ in range(tries):
        p = side.raw_read(name, payload)
        if p.get("local"):
            return p
        time.sleep(0.02)
    raise AssertionError(f"no lease-local read of {name}: {p}")


#: generous client timeouts: the reference compiles its lease tick programs
#: at the first ticks, which on a loaded host takes longer than the
#: client's default 15 s
T = 120.0


def test_cluster_reads_served_locally_under_lease(lease_sides):
    out = {}
    for pkg, s in lease_sides.items():
        c = s.client
        steps = [c.create("lsvc", timeout=T)["ok"],
                 c.request("lsvc", b"PUT k v1", timeout=T)]
        p = _read_local(s, "lsvc", b"GET k")
        steps.append((base64.b64decode(p["response"]), p["local"],
                      p.get("name")))
        steps.append(c.request("lsvc", b"PUT k v2", timeout=T))
        p = _read_local(s, "lsvc", b"GET k")
        steps.append((base64.b64decode(p["response"]), p["local"]))
        steps.append(c.read("lsvc", b"GET missing", timeout=T))
        steps.append(s.cluster.manager.stats["local_reads"] > 0)
        out[pkg] = steps
    assert out["port"] == out["ref"]
    assert out["port"][0] and out["port"][1] == b"OK"
    assert out["port"][2][:2] == (b"v1", True)
    assert out["port"][4] == (b"v2", True)
    assert out["port"][5] == b"NF" and out["port"][6]
