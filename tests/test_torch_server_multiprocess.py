"""Twin of ``tests/test_server_multiprocess.py``: the full Mode B
deployment across real OS processes (4 active + 3 reconfigurator
``ModeBServer`` processes, and a device-app deployment of 3 + 1), driven
by the real client, with SIGKILLs of a group's coordinator process and of
the name's primary reconfigurator mid-reconfiguration — once with the
reference's worker (``tests/server_worker.py``) and once with the port's
(``python -m gigapaxos_tpu_torch.testing.server_worker``, ``device:
cpu``), each driven by its own package's client.

Tolerance: 0 on what each run reaches (responses, members, the migrated
set); timings are this host's and are not compared.
"""

import json
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from gigapaxos_tpu import client as jclient
from gigapaxos_tpu import config as jconfig
from gigapaxos_tpu.models import device_kv as jdkv
from gigapaxos_tpu.reconfiguration import consistent_hashing as jch
from gigapaxos_tpu.reconfiguration import packets as jpkt
from gigapaxos_tpu_torch import client as tclient
from gigapaxos_tpu_torch import config as tconfig
from gigapaxos_tpu_torch.models import device_kv as tdkv
from gigapaxos_tpu_torch.reconfiguration import consistent_hashing as tch
from gigapaxos_tpu_torch.reconfiguration import packets as tpkt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "ref": SimpleNamespace(
        cmd=[sys.executable, os.path.join(ROOT, "tests", "server_worker.py")],
        client=jclient, config=jconfig, dkv=jdkv, ch=jch, pkt=jpkt, spec={}),
    "port": SimpleNamespace(
        cmd=[sys.executable, "-m",
             "gigapaxos_tpu_torch.testing.server_worker"],
        client=tclient, config=tconfig, dkv=tdkv, ch=tch, pkt=tpkt,
        spec={"device": "cpu"}),
}
ACTIVES = ["A0", "A1", "A2", "A3"]
RCS = ["R0", "R1", "R2"]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ServerProc:
    def __init__(self, P, node_id: str, spec: dict):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT
        env.pop("JAX_PLATFORMS", None)
        self.node_id = node_id
        self.proc = subprocess.Popen(
            P.cmd + [node_id, json.dumps(dict(spec, **P.spec))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT,
        )
        self.lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.strip())

    def wait_ready(self, timeout: float = 600.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{self.node_id}: never ready")
            try:
                if self.lines.get(timeout=left) == "ready":
                    return
            except queue.Empty:
                continue

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("exit\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=15)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()


def request_via(client, name, payload, active, timeout=30.0):
    done = threading.Event()
    box = {}

    def cb(resp):
        box.update(resp)
        done.set()

    client.send_request(name, payload, cb, active=active)
    if not done.wait(timeout):
        raise TimeoutError(f"no response via {active}")
    return box


def _nodes(P, spec):
    nodes = P.config.GigapaxosTpuConfig().nodes
    for a, (h, pt) in spec["actives"].items():
        nodes.actives[a] = (h, pt)
    for r, (h, pt) in spec["rcs"].items():
        nodes.reconfigurators[r] = (h, pt)
    return nodes


def _full_deployment(P, log_dir):
    spec = {
        "actives": {a: ["127.0.0.1", free_port()] for a in ACTIVES},
        "rcs": {r: ["127.0.0.1", free_port()] for r in RCS},
        "fd_timeout": 2.0,
        "log_dir": log_dir,
    }
    procs = {nid: ServerProc(P, nid, spec) for nid in ACTIVES + RCS}
    facts = []
    try:
        for p in procs.values():
            p.wait_ready()
        client = P.client.ReconfigurableAppClient(_nodes(P, spec))
        resp = client.create("svc", timeout=180)
        facts.append(bool(resp["ok"] or resp.get("error") == "exists"))
        members = sorted(client.request_actives("svc"))
        facts.append(len(members))
        facts.append(client.request("svc", b"PUT a 1", timeout=60))
        facts.append(client.request("svc", b"GET a", timeout=60))
        # SIGKILL the coordinator process; failover by the FDs alone
        coord = min(members, key=ACTIVES.index)
        procs[coord].sigkill()
        deadline = time.monotonic() + 90
        committed = False
        while time.monotonic() < deadline and not committed:
            try:
                committed = client.request(
                    "svc", b"PUT post 2", timeout=10) == b"OK"
            except (P.client.ClientError, TimeoutError):
                time.sleep(0.5)
        facts.append(committed)
        # restart from its own WAL; it rejoins and serves
        procs[coord] = ServerProc(P, coord, spec)
        procs[coord].wait_ready()
        deadline = time.monotonic() + 120
        got = None
        while time.monotonic() < deadline:
            try:
                box = request_via(client, "svc", b"GET post", coord,
                                  timeout=10)
                if box.get("ok"):
                    got = P.pkt.b64d(box.get("response"))
                    if got == b"2":
                        break
            except TimeoutError:
                pass
            time.sleep(0.5)
        facts.append(got)
        # SIGKILL the primary RC mid-reconfiguration; the surviving RCs'
        # watchdog finishes the migration
        old = set(client.request_actives("svc", force=True))
        newcomer = sorted(set(ACTIVES) - old)
        new = sorted(sorted(old)[:2] + newcomer[:1])
        primary = P.ch.ConsistentHashRing(sorted(RCS)).replicated_servers(
            "svc", 3)[0]

        def fire():
            try:
                client.reconfigure("svc", new, timeout=5)
            except Exception:
                pass  # the primary died holding our response; expected

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        time.sleep(0.3)  # let the intent commit, then kill mid-workflow
        procs[primary].sigkill()
        deadline = time.monotonic() + 120
        migrated = False
        while time.monotonic() < deadline and not migrated:
            try:
                migrated = set(client.request_actives(
                    "svc", force=True)) == set(new)
            except P.client.ClientError:
                pass
            time.sleep(1.0)
        facts.append(migrated)
        facts.append(client.request("svc", b"GET a", timeout=60))
        client.close()
    finally:
        for p in procs.values():
            p.close()
    return facts


@pytest.mark.slow
def test_full_deployment_sigkill_coordinator_and_rc(tmp_path):
    out = {k: _full_deployment(P, str(tmp_path / k))
           for k, P in PKGS.items()}
    assert out["ref"] == out["port"]
    assert out["port"] == [True, 3, b"OK", b"1", True, b"2", True, b"1"]


def _device_app_deployment(P, log_dir):
    actives = ["A0", "A1", "A2"]
    spec = {
        "actives": {a: ["127.0.0.1", free_port()] for a in actives},
        "rcs": {"R0": ["127.0.0.1", free_port()]},
        "fd_timeout": 2.0,
        "device_app": True,
        "log_dir": log_dir,
    }
    pack = P.dkv.pack_desc
    procs = {nid: ServerProc(P, nid, spec) for nid in actives + ["R0"]}
    client = None
    facts = []
    try:
        for p in procs.values():
            p.wait_ready()
        client = P.client.ReconfigurableAppClient(_nodes(P, spec))
        resp = client.create("svc", timeout=180)
        facts.append(bool(resp["ok"] or resp.get("error") == "exists"))
        facts.append([client.request("svc", pack(P.dkv.OP_PUT, i + 1, 50 + i),
                                     timeout=60) for i in range(4)])
        facts.append(client.request("svc", pack(P.dkv.OP_GET, 2, 0),
                                    timeout=60))
        members = sorted(client.request_actives("svc"))
        coord = min(members, key=actives.index)
        procs[coord].sigkill()
        deadline = time.monotonic() + 90
        committed = False
        while time.monotonic() < deadline and not committed:
            try:
                committed = client.request(
                    "svc", pack(P.dkv.OP_PUT, 9, 999), timeout=10
                ) == struct.pack("<i", 999)
            except (P.client.ClientError, TimeoutError):
                time.sleep(0.5)
        facts.append(committed)
        procs[coord] = ServerProc(P, coord, spec)
        procs[coord].wait_ready()
        deadline = time.monotonic() + 120
        got = None
        while time.monotonic() < deadline:
            try:
                box = request_via(client, "svc", pack(P.dkv.OP_GET, 9, 0),
                                  coord, timeout=10)
                if box.get("ok"):
                    got = P.pkt.b64d(box.get("response"))
                    if got == struct.pack("<i", 999):
                        break
            except TimeoutError:
                pass
            time.sleep(0.5)
        facts.append(got)
        box = request_via(client, "svc", pack(P.dkv.OP_GET, 2, 0), coord,
                          timeout=30)
        facts.append(P.pkt.b64d(box.get("response")))
    finally:
        if client is not None:
            client.close()
        for p in procs.values():
            p.close()
    return facts


@pytest.mark.slow
def test_device_app_deployment_sigkill_recovery(tmp_path):
    out = {k: _device_app_deployment(P, str(tmp_path / k))
           for k, P in PKGS.items()}
    assert out["ref"] == out["port"]
    want = [True, [struct.pack("<i", 50 + i) for i in range(4)],
            struct.pack("<i", 51), True, struct.pack("<i", 999),
            struct.pack("<i", 51)]
    assert out["port"] == want
