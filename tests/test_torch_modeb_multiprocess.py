"""Twin of ``tests/test_modeb_multiprocess.py``: Mode B across real OS
processes — 3 nodes, SIGKILL the coordinator's process, the majority
commits, restart it from its own journal — once with the reference's
worker (``tests/modeb_worker.py``) and once with the port's
(``python -m gigapaxos_tpu_torch.testing.modeb_worker ... --device cpu``).

Tolerance: 0 on what each run reaches (the responses and every process's
converged table); the timings are this host's and are not compared.
"""

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = {
    "ref": [sys.executable, os.path.join(ROOT, "tests", "modeb_worker.py")],
    "port": [sys.executable, "-m", "gigapaxos_tpu_torch.testing.modeb_worker"],
}
EXTRA = {"ref": [], "port": ["--device", "cpu"]}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Worker:
    def __init__(self, pkg, node_id, topology, wal_dir):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT
        env.pop("JAX_PLATFORMS", None)
        self.node_id = node_id
        self.proc = subprocess.Popen(
            COMMANDS[pkg] + [node_id, json.dumps(topology), wal_dir]
            + EXTRA[pkg],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT,
        )
        self.lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line.strip())

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def expect(self, prefix: str, timeout: float = 60.0) -> str:
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{self.node_id}: no '{prefix}' line")
            try:
                line = self.lines.get(timeout=left)
            except queue.Empty:
                continue
            if line.startswith(prefix):
                return line

    def db(self, timeout: float = 30.0) -> dict:
        self.send("db")
        return json.loads(self.expect("db ", timeout)[3:])

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send("exit")
                self.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()


def _scenario(pkg, tmp_path):
    ids = ["P0", "P1", "P2"]
    topology = {nid: ["127.0.0.1", free_port()] for nid in ids}
    root = tmp_path / pkg
    workers = {nid: Worker(pkg, nid, topology, str(root / nid))
               for nid in ids}
    facts = []
    try:
        for w in workers.values():
            w.expect("ready", timeout=180)
        for nid in ids:
            workers[nid].send("create svc")
            workers[nid].expect("created")
        workers["P1"].send(f"propose svc {b'PUT a 1'.hex()}")
        facts.append(workers["P1"].expect("resp ", 60).split()[-1])
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(w.db().get("svc", {}).get("a") == "1"
                   for w in workers.values()):
                break
            time.sleep(0.25)
        facts.append([w.db() for w in workers.values()])
        # kill -9 the coordinator's process (slot 0): the survivors'
        # failure detectors mark it dead and the majority keeps committing
        workers["P0"].sigkill()
        workers["P1"].send(f"propose svc {b'PUT b 2'.hex()}")
        facts.append(workers["P1"].expect("resp ", 120).split()[-1])
        # restart from its own journal; it recovers and catches up
        workers["P0"] = Worker(pkg, "P0", topology, str(root / "P0"))
        workers["P0"].expect("ready", timeout=180)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            db = workers["P0"].db().get("svc", {})
            if db.get("a") == "1" and db.get("b") == "2":
                break
            time.sleep(0.25)
        facts.append(workers["P0"].db())
        workers["P0"].send(f"propose svc {b'PUT c 3'.hex()}")
        facts.append(workers["P0"].expect("resp ", 90).split()[-1])
    finally:
        for w in workers.values():
            w.close()
    return facts


@pytest.mark.slow
def test_three_processes_sigkill_and_recover(tmp_path):
    out = {pkg: _scenario(pkg, tmp_path) for pkg in COMMANDS}
    assert out["ref"] == out["port"]
    ok = b"OK".hex()
    assert out["port"][0] == out["port"][2] == out["port"][4] == ok
    assert all(db == {"svc": {"a": "1"}} for db in out["port"][1])
    assert out["port"][3] == {"svc": {"a": "1", "b": "2"}}
