"""``ModeBServer`` twin: six per-process deployment units of each package
(3 actives and 3 reconfigurators, 32 rows a plane) in this process on
loopback ports, on the CPU (the port with ``device="cpu"``), driven by each
package's ``ReconfigurableAppClient`` through the same scenarios — the
create, request and delete cases of the reference's
``tests/test_modeb_control_plane.py``, and one deployment with
chain-coordinated actives (its migrate and coordinator-death cases are in
``tests/test_torch_server_failover.py``, so that each file stays short).

Tolerance: 0.  Every response of a scenario equals the reference's, and so
does every member's app checkpoint of every name once it settles.  The
packages run one after the other (six servers alive at a time), each
scenario recording its results for the comparison; every wait is a loop
with its own deadline.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from gigapaxos_tpu import client as jclient
from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu import server as jserver
from gigapaxos_tpu.reconfiguration import packets as jpkt
from gigapaxos_tpu_torch import client as tclient
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch import server as tserver
from gigapaxos_tpu_torch.reconfiguration import packets as tpkt

PKGS = {"ref": (jconfig, jserver, jclient, jpkt, {}),
        "port": (tconfig, tserver, tclient, tpkt, {"device": "cpu"})}
ACTIVES = ["AR0", "AR1", "AR2"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCS = ["RC0", "RC1", "RC2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_cfg(mod):
    cfg = mod.GigapaxosTpuConfig()
    cfg.paxos.max_groups = 32
    cfg.paxos.window = 8
    cfg.fd.ping_interval_s = 0.05
    cfg.fd.timeout_s = 1.0
    for nid in ACTIVES:
        cfg.nodes.actives[nid] = ("127.0.0.1", _free_port())
    for nid in RCS:
        cfg.nodes.reconfigurators[nid] = ("127.0.0.1", _free_port())
    return cfg


def until(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out: {what}")


class Deployment:
    """One package's six servers and client."""

    def __init__(self, pkg, coordinator="paxos"):
        cfgmod, srvmod, climod, self.pkt, kw = PKGS[pkg]
        self.cfg = make_cfg(cfgmod)
        self.srv = {}
        for nid in ACTIVES + RCS:
            self.srv[nid] = srvmod.ModeBServer(
                nid, self.cfg, start_fd=True,
                coordinator=coordinator if nid in ACTIVES else "paxos", **kw)
        for s in self.srv.values():
            assert s.wait_ready(120)
        self.client = climod.ReconfigurableAppClient(self.cfg.nodes)
        self.closed = set()

    def actives(self, name, timeout=30):
        """The name's actives, asked again while the RC replica that
        answers has not executed the create yet."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return sorted(self.client.request_actives(name, force=True))
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def request(self, name, payload, timeout=30):
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.client.request(name, payload, timeout=10)
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def request_via(self, name, payload, active, timeout=30):
        """One request through a given active, retried on ``not_active``
        (a member may still be birthing the group)."""
        deadline = time.monotonic() + timeout
        box = {}
        while time.monotonic() < deadline:
            done = threading.Event()
            box = {}

            def cb(resp, box=box, done=done):
                box.update(resp)
                done.set()

            self.actives(name)
            self.client.send_request(name, payload, cb, active=active)
            if not done.wait(min(5.0, max(deadline - time.monotonic(), 0.5))):
                continue
            if box.get("ok"):
                return self.pkt.b64d(box.get("response")) or b""
            if box.get("error") not in ("not_active", "stopped"):
                break
            time.sleep(0.2)
        raise AssertionError(f"request via {active} failed: {box}")

    def checkpoints(self, name, members, want):
        """Each member's app checkpoint of ``name``'s live epoch, once it
        holds ``want`` (the members converge asynchronously)."""
        out = {}
        for a in sorted(members):
            s = self.srv[a]

            def ckpt(s=s):
                e = s.coordinator._epoch.get(name)
                if e is None:
                    return None
                blob = s.app.checkpoint(s.coordinator._pax_name(name, e))
                return (e, blob) if blob == want else None

            out[a] = until(ckpt, 60, f"{a} app of {name}")
        return out

    def close(self):
        self.client.close()
        for nid, s in self.srv.items():
            if nid not in self.closed:
                s.close()


def _kv(d):
    import json

    return json.dumps(d, sort_keys=True).encode()


def outcome(resp):
    """A delete's or a reconfiguration's whole verdict, ``ok`` and
    ``error`` (the replying RC and the request id vary from run to run)."""
    return resp.get("ok"), resp.get("error")


def sc_create_and_request(d):
    r = [d.client.create("svc0", timeout=60)["ok"]]
    members = d.actives("svc0")
    r += [members, d.request("svc0", b"PUT k v1"), d.request("svc0", b"GET k")]
    r.append(d.checkpoints("svc0", members, _kv({"k": "v1"})))
    return r


def sc_request_from_every_member(d):
    r = [d.client.create("multi", timeout=60)["ok"]]
    members = d.actives("multi")
    for i, a in enumerate(members):
        r.append(d.request_via("multi", f"PUT k{i} {i}".encode(), a))
    r += [d.request("multi", b"GET k0"), d.request("multi", b"GET k2")]
    r.append(d.checkpoints("multi", members,
                           _kv({f"k{i}": str(i) for i in range(3)})))
    return r


def sc_migrate(d):
    """Shrink the name to two members, then grow it back: the third
    member's epoch-2 state crosses processes (it held no epoch 1)."""
    r = [d.client.create("mig", timeout=60)["ok"],
         d.request("mig", b"PUT city amherst")]
    for new in (ACTIVES[:2], ACTIVES):
        r.append(outcome(d.client.reconfigure("mig", list(new),
                                              timeout=60)))
        until(lambda: d.actives("mig") == sorted(new), 120,
              f"mig on {new}")
        r.append(d.request("mig", b"GET city", timeout=60))
    r.append(d.request("mig", b"PUT t 2", timeout=60))
    r.append(d.checkpoints("mig", ACTIVES, _kv({"city": "amherst",
                                                  "t": "2"})))
    return r


def sc_delete_and_recreate(d):
    r = [d.client.create("gone", timeout=60)["ok"],
         d.request("gone", b"PUT x 1"), outcome(d.client.delete("gone"))]
    with pytest.raises(Exception):
        d.client.request_actives("gone", force=True)
    r += [d.client.create("gone", timeout=60)["ok"],
          d.request("gone", b"GET x")]
    return r


def sc_coordinator_death(d):
    """Close the name's coordinator; the survivors' failure detectors
    alone mark it dead and the next member takes over."""
    r = [d.client.create("failover", timeout=60)["ok"],
         d.request("failover", b"PUT pre 1")]
    members = d.actives("failover")
    coord = min(members, key=d.cfg.nodes.active_ids().index)
    d.srv[coord].close()
    d.closed.add(coord)
    survivors = [a for a in members if a != coord]
    deadline = time.monotonic() + 60
    i, ok = 0, None
    while time.monotonic() < deadline and ok != b"OK":
        try:
            ok = d.request_via("failover", b"PUT post 1",
                               survivors[i % 2], timeout=5)
        except AssertionError:
            pass
        i += 1
    r += [coord, ok, d.request("failover", b"GET post")]
    r.append(d.checkpoints("failover", survivors,
                           _kv({"pre": "1", "post": "1"})))
    return r


def sc_chain(d):
    """Chain-coordinated actives: create, PUT and read through every
    member, delete."""
    r = [d.client.create("csvc", timeout=60)["ok"]]
    members = d.actives("csvc")
    r.append(members)
    for i, a in enumerate(members):
        r.append(d.request_via("csvc", f"PUT k{i} c{i}".encode(), a))
    r += [d.request("csvc", b"GET k1")]
    r.append(d.checkpoints("csvc", members,
                           _kv({f"k{i}": f"c{i}" for i in range(3)})))
    r.append(outcome(d.client.delete("csvc")))
    return r


def run_scenarios(plan):
    """Run ``plan`` — (coordinator, scenarios) pairs — on each package in
    turn, one deployment alive at a time: -> {package: {scenario: result
    or the exception it raised}}."""
    out = {}
    for pkg in PKGS:
        out[pkg] = {}
        for coordinator, scenarios in plan:
            d = Deployment(pkg, coordinator)
            try:
                for sc in scenarios:
                    try:
                        out[pkg][sc.__name__] = sc(d)
                    except Exception as e:  # reported by its own test
                        out[pkg][sc.__name__] = e
            finally:
                d.close()
    return out


@pytest.fixture(scope="module")
def results():
    return run_scenarios([
        ("paxos", [sc_create_and_request, sc_request_from_every_member,
                   sc_delete_and_recreate]),
        ("chain", [sc_chain])])


def same(results, name):
    ref, port = results["ref"][name], results["port"][name]
    for side, v in (("reference", ref), ("port", port)):
        if isinstance(v, BaseException):
            raise AssertionError(f"{side} {name}: {v!r}") from v
    assert ref == port, name
    return port


def test_create_and_request(results):
    r = same(results, "sc_create_and_request")
    assert r[0] is True and r[2:4] == [b"OK", b"v1"]


def test_request_from_every_member(results):
    r = same(results, "sc_request_from_every_member")
    assert r[1:6] == [b"OK", b"OK", b"OK", b"0", b"2"]


def test_delete_and_recreate(results):
    r = same(results, "sc_delete_and_recreate")
    assert r == [True, b"OK", (True, None), True, b"NF"]


def test_chain_coordinator_deployment(results):
    r = same(results, "sc_chain")
    assert r[0] is True and r[2:6] == [b"OK", b"OK", b"OK", b"c1"]
    assert r[-1] == (True, None)


def _boot_cells(mod, props, log_dir, extra):
    """``python -m <mod> --cells`` on ``props``: -> its ready line, the
    cell directories it made and its exit code after SIGTERM."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", mod, "--properties", str(props), "--log-dir",
         str(log_dir)] + extra, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline().strip()
        dirs = sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []
    finally:
        proc.terminate()
        rc = proc.wait(timeout=120)
    return line, dirs, rc


def test_cells_are_refused(tmp_path):
    """Once refused, now the twin of the reference's ``--cells``
    bootstrap: the same properties boot a two-cell host plane in each
    package, which prints its ready line, makes a directory a cell and
    stops every worker on SIGTERM."""
    p = tmp_path / "gp.properties"
    p.write_text("active.AR0=127.0.0.1:0\nreconfigurator.RC0=127.0.0.1:0\n"
                 "cells.enabled=true\ncells.n_cells=2\n"
                 "cells.pin_cores=false\npaxos.max_groups=16\n")
    ref = _boot_cells("gigapaxos_tpu.server", p, tmp_path / "ref", [])
    port = _boot_cells("gigapaxos_tpu_torch.server", p, tmp_path / "port",
                       ["--device", "cpu"])
    assert ref[0] == "gigapaxos_tpu cells host ready: 2 cells"
    assert port[0] == "gigapaxos_tpu_torch cells host ready: 2 cells"
    assert ref[1:] == port[1:] == (["c0", "c1"], 0)


def test_server_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = make_cfg(tconfig)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.ModeBServer("AR0", cfg)
    with pytest.raises(ValueError, match="neither topology section"):
        tserver.ModeBServer("XX", cfg, device="cpu")


def measure_node_ticks(pkg):
    """Seconds of one create, PUT and delete, and the duration of every
    node tick meanwhile, in ``pkg``'s deployment of six servers: ->
    (seconds, tick durations).  The CPU-path table of ``PERF.md``
    (``python -m tests.test_torch_server``); each call waits up to 60 s
    here, since what is measured is the time, not the twin's verdict."""
    node_cls = {"ref": jserver.ModeBNode, "port": tserver.ModeBNode}[pkg]
    ticks, on = [], threading.Event()
    orig = node_cls.tick

    def tick(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return orig(self, *a, **k)
        finally:
            if on.is_set():
                ticks.append(time.perf_counter() - t0)

    node_cls.tick = tick
    d = Deployment(pkg)
    try:
        on.set()
        t = [time.perf_counter()]
        assert d.client.create("gone", timeout=60)["ok"]
        t.append(time.perf_counter())
        assert d.request("gone", b"PUT x 1", timeout=60) == b"OK"
        t.append(time.perf_counter())
        assert d.client.delete("gone", timeout=60)["ok"]
        t.append(time.perf_counter())
        on.clear()
    finally:
        node_cls.tick = orig
        d.close()
    return [b - a for a, b in zip(t, t[1:])], ticks


if __name__ == "__main__":
    torch.set_num_threads(1)
    for name in PKGS:
        secs, ticks = measure_node_ticks(name)
        mean = 1e3 * sum(ticks) / len(ticks)
        print(f"{name}: create / PUT / delete "
              + " / ".join(f"{x:.2f}" for x in secs)
              + f" s; {len(ticks)} node ticks, mean {mean:.1f} ms, max "
              f"{1e3 * max(ticks):.1f} ms", flush=True)
