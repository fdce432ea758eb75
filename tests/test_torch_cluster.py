"""Twin of the control-plane end-to-end suite: the reference
``InProcessCluster`` (JAX on the CPU) and the port's (``device="cpu"``) run
the same serial client script at the shape of
``tests/test_reconfiguration_e2e.py`` (5 actives, 3 reconfigurators,
``max_groups=64``, real sockets on loopback).

Each step's responses must be equal.  The packets' random request ids and
the reconfigurator that happened to answer are dropped before comparing:
the client picks both at random.  At the end both clusters are drained and
the per-replica ``KVApp`` checkpoints of every live name and the RC records
(epoch, actives, state) at every reconfigurator must be equal, with
``==``.

The tests that build no shared cluster run first, before the module's
clusters start ticking in the background.  The durable twin is in
``test_torch_cluster_wal.py``.
"""

import time

import pytest

from gigapaxos_tpu.client import ClientError as RefClientError
from gigapaxos_tpu.client import ReconfigurableAppClient as RefClient
from gigapaxos_tpu.config import GigapaxosTpuConfig as RefConfig
from gigapaxos_tpu.models.replicable import KVApp as RefKV
from gigapaxos_tpu.node import InProcessCluster as RefCluster
from gigapaxos_tpu.reconfiguration.demand import (
    RateBasedMigrationPolicy as RefPolicy,
)
from gigapaxos_tpu_torch.client import ClientError as PortClientError
from gigapaxos_tpu_torch.client import ReconfigurableAppClient as PortClient
from gigapaxos_tpu_torch.config import GigapaxosTpuConfig as PortConfig
from gigapaxos_tpu_torch.models.replicable import KVApp as PortKV
from gigapaxos_tpu_torch.node import InProcessCluster as PortCluster
from gigapaxos_tpu_torch.obs.metrics import registry as port_registry
from gigapaxos_tpu_torch.reconfiguration.demand import (
    RateBasedMigrationPolicy as PortPolicy,
)

PKGS = {
    "ref": (RefConfig, RefKV, RefCluster, RefClient, RefClientError,
            RefPolicy, {}),
    "port": (PortConfig, PortKV, PortCluster, PortClient, PortClientError,
             PortPolicy, {"device": "cpu"}),
}


def make_cfg(config_cls, n_active=5, n_rc=3):
    cfg = config_cls()
    cfg.paxos.max_groups = 64
    cfg.paxos.window = 8
    for i in range(n_active):
        cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
    for i in range(n_rc):
        cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
    return cfg


def test_unported_cluster_options_raise():
    """The placement plane, once refused here, now builds: the data-plane
    manager keeps demand counters over one shard, and the rebalancer
    daemon starts and stops."""
    cfg = make_cfg(PortConfig)
    cfg.placement.enabled = True
    cl = PortCluster(cfg, PortKV, device="cpu")
    try:
        assert cl.manager._placement is not None
        assert cl.manager.shard_geometry() == (1, 64)
        cl.start_rebalancer(interval_s=5.0)
        cl.stop_rebalancer()
        assert cl.rebalancer is None
    finally:
        cl.close()


def test_cluster_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortCluster(make_cfg(PortConfig), PortKV)


def test_chip_smoke_cluster_phase_on_cpu():
    """The ``cluster`` phase of chip_smoke.py at a small size on the CPU
    (max_groups 4,096, 256 names), every check included."""
    import os
    import sys

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from gigapaxos_tpu_torch.ops import plane_gather as pg

    out = chip_smoke.cluster_phase(torch, pg, torch.device("cpu"), 4096,
                                   n_names=256, serial=16, n_reconf=4,
                                   n_delete=4)
    assert out["names"] == 256 and out["reconfigurations"] == 4
    assert out["ticks"]["ar"] > 0 and out["ticks"]["rc"] > 0
    assert 0 < out["rc_share_of_tick_time"] < 1


class Side:
    """One package's cluster and client."""

    def __init__(self, pkg):
        self.pkg = pkg
        (cfg_cls, kv, cluster_cls, client_cls, self.ClientError, policy,
         kw) = PKGS[pkg]
        # migrate once after 25 requests (at most one more per 25 after):
        # the demand case sends 40, so both clusters migrate exactly once
        self.cluster = cluster_cls(
            make_cfg(cfg_cls), kv,
            demand_profile_factory=lambda name: policy(
                name, migrate_after=25, min_requests_between=25),
            **kw,
        )
        self.client = client_cls(self.cluster.cfg.nodes)

    def close(self):
        self.client.close()
        self.cluster.close()


@pytest.fixture(scope="module")
def sides():
    s = {}
    try:
        for pkg in PKGS:
            s[pkg] = Side(pkg)
        yield s
    finally:
        for side in s.values():
            side.close()


def _norm(resp):
    """Drop what the client chose at random (rid, answering RC)."""
    if isinstance(resp, dict):
        return {k: _norm(v) for k, v in resp.items()
                if k not in ("rid", "sender")}
    if isinstance(resp, (list, tuple)):
        return [_norm(v) for v in resp]
    return resp


def both(sides, step):
    out = {pkg: _norm(step(side)) for pkg, side in sides.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_create_and_request(sides):
    def step(s):
        c = s.client
        resp = c.create("svc0")
        actives = c.request_actives("svc0")
        return (resp, sorted(actives), c.request("svc0", b"PUT k v1"),
                c.request("svc0", b"GET k"))

    resp, actives, put, get = both(sides, step)
    assert resp["ok"] and len(actives) == 3
    assert (put, get) == (b"OK", b"v1")


def test_duplicate_create_fails(sides):
    assert both(sides, lambda s: s.client.create("svc0"))["ok"] is False


def test_unknown_name(sides):
    def step(s):
        with pytest.raises(s.ClientError) as e:
            s.client.request_actives("nope", force=True)
        return str(e.value)

    both(sides, step)


def test_many_names_spread(sides):
    def step(s):
        out = []
        for i in range(6):
            name = f"spread{i}"
            out.append((s.client.create(name)["ok"],
                        sorted(s.client.request_actives(name)),
                        s.client.request(name, b"PUT a 1")))
        return out

    out = both(sides, step)
    assert all(ok and put == b"OK" for ok, _, put in out)
    assert len({a for _, acts, _ in out for a in acts}) > 3


def test_client_reconfigure_preserves_state(sides):
    def step(s):
        c = s.client
        out = [c.create("mig"), c.request("mig", b"PUT city amherst")]
        old = set(c.request_actives("mig"))
        pool = set(s.cluster.cfg.nodes.active_ids())
        new = sorted((pool - old) | set(sorted(old)[:1]))[:3]
        out += [c.reconfigure("mig", new),
                sorted(c.request_actives("mig", force=True)) == new,
                c.request("mig", b"GET city"), c.request("mig", b"PUT t 2")]
        rc = s.cluster.reconfigurators[s.cluster.rdb.primary_of("mig")]
        rec = rc.db.get("mig")
        out.append((rec.epoch, rec.state.value, rec.actives))
        return out

    out = both(sides, step)
    assert out[2]["ok"] and out[3] is True
    assert out[4:6] == [b"amherst", b"OK"] and out[6][:2] == [1, "READY"]


def test_delete(sides):
    def step(s):
        c = s.client
        out = [c.create("gone"), c.request("gone", b"PUT x 1"),
               c.delete("gone")]
        with pytest.raises(s.ClientError):
            c.request_actives("gone", force=True)
        out += [c.create("gone"), c.request("gone", b"GET x")]
        return out

    out = both(sides, step)
    assert out[2]["ok"] and out[3]["ok"] and out[4] == b"NF"


def test_demand_driven_migration(sides):
    def step(s):
        c = s.client
        out = [c.create("hot")]
        before = sorted(c.request_actives("hot"))
        out += [c.request("hot", f"PUT k{i} {i}".encode()) for i in range(40)]
        # wait on the migration itself: the name's RC record at its primary
        # reconfigurator reaches epoch 1 and READY (it runs through the RC
        # plane's ticks, which a loaded host can slow a lot)
        rc = s.cluster.reconfigurators[s.cluster.rdb.primary_of("hot")]
        deadline = time.monotonic() + 120
        while True:
            rec = rc.db.get("hot")
            if rec is not None and rec.epoch >= 1 and \
                    rec.state.value == "READY":
                break
            assert time.monotonic() < deadline, (
                f"{s.pkg}: the migration of 'hot' did not reach epoch 1 "
                f"READY in 120 s (record: {rec})")
            time.sleep(0.1)
        # the other reconfigurators learn the record through the RC plane
        after = sorted(c.request_actives("hot", force=True))
        while after == before and time.monotonic() < deadline:
            time.sleep(0.1)
            after = sorted(c.request_actives("hot", force=True))
        out += [before, after, c.request("hot", b"GET k1")]
        return out

    out = both(sides, step)
    before, after, got = out[-3:]
    assert after != before and got == b"1"


def test_batched_creates(sides):
    names = [f"batch{i}" for i in range(8)]

    def step(s):
        c = s.client
        out = [c.create_batch(names)]
        for n in names[:3]:
            out.append((c.request(n, b"PUT x 1"), len(c.request_actives(n))))
        out.append(c.create_batch(names[:2]))
        return out

    out = both(sides, step)
    assert out[0]["ok"] and set(out[0]["results"]) == set(names)
    assert out[1:4] == [[b"OK", 3]] * 3
    assert not out[4]["ok"]
    assert all(r.get("error") == "exists" for r in out[4]["results"].values())


def test_anycast_request(sides):
    def step(s):
        c = s.client
        return ([c.create("anyc"), c.request("anyc", b"PUT k val")]
                + [c.request_anycast("anyc", b"GET k") for _ in range(6)])

    out = both(sides, step)
    assert out[1:] == [b"OK"] + [b"val"] * 6


def test_echo_rtt(sides):
    def step(s):
        rtt = s.client.echo(s.client.request_actives("svc0")[0])
        return 0 <= rtt < 5

    assert both(sides, step) is True


def test_read_takes_consensus_fallback(sides):
    fallback = port_registry().counter("reads_fallback_total", node="ar")
    n0 = fallback.value

    def step(s):
        c = s.client
        return [c.request("svc0", b"PUT r 7"), c.read("svc0", b"GET r"),
                c.read("mig", b"GET city"), c.read("hot", b"GET k39")]

    assert both(sides, step) == [b"OK", b"7", b"amherst", b"39"]
    assert fallback.value - n0 >= 3


def _final_state(side):
    cl = side.cluster
    assert cl.drain(30.0)
    rdb = next(iter(cl.reconfigurators.values())).db
    records, apps = {}, {}
    for rc_id, rc in sorted(cl.reconfigurators.items()):
        for name in rc.db.names():
            rec = rc.db.get(name)
            records[(rc_id, name)] = (rec.epoch, list(rec.actives),
                                      rec.state.value)
    for name in rdb.names():
        rec = rdb.get(name)
        pname = f"{name}#{rec.epoch}"
        for node in rec.actives:
            slot = cl.coordinator.slot_of(node)
            apps[(name, node)] = cl.manager.apps[slot].checkpoint(pname)
    return records, apps


def test_final_app_states_and_rc_records_equal(sides):
    ref_records, ref_apps = _final_state(sides["ref"])
    port_records, port_apps = _final_state(sides["port"])
    assert port_records == ref_records
    assert port_apps == ref_apps
    assert len(port_apps) == 3 * 19  # every name of the script, 3 members
    assert port_apps[("mig", port_records[("RC0", "mig")][1][0])] == \
        b'{"city": "amherst", "t": "2"}'
