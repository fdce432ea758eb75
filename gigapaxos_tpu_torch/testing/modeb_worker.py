"""One Mode B node in an OS process of its own (the deployment unit of the
reference's ``ReconfigurableNode.main``), for the process-level tests.

Run as ``python -m gigapaxos_tpu_torch.testing.modeb_worker <node id>
<topology json> <wal dir> [--device cpu]`` (the topology maps node ids to
``[host, port]``).  The device defaults to CUDA.

Line protocol on stdin/stdout:
  create <name>            -> "created <name>"
  propose <name> <hex>     -> (async) "resp <rid> <hex|NONE>"
  db                       -> "db <json>"
  exit                     -> process exits cleanly
The process prints "ready" after its first tick.  The node ticks
continuously on a background thread.  SIGKILL the process to emulate
machine death; restart it with the same WAL dir to recover from its own
journal.
"""

import argparse
import json
import os
import sys
import threading

from ..config import GigapaxosTpuConfig
from ..models.replicable import KVApp
from ..modeb import ModeBLogger, ModeBNode, recover_modeb
from ..net.failure_detection import FailureDetection
from ..net.messenger import Messenger, NodeMap
from ..paxos.driver import TickDriver


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="modeb_worker")
    ap.add_argument("node_id")
    ap.add_argument("topology")
    ap.add_argument("wal_dir")
    ap.add_argument("--device", default=None,
                    help="torch device of the node's state (default cuda)")
    args = ap.parse_args(argv)
    node_id, wal_dir = args.node_id, args.wal_dir
    topology = json.loads(args.topology)  # {node_id: [host, port]}
    ids = sorted(topology)
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = 16

    nodemap = NodeMap()
    for nid, (host, port) in topology.items():
        nodemap.add(nid, host, int(port))

    app = KVApp()
    out_lock = threading.Lock()

    def emit(line: str) -> None:
        with out_lock:
            sys.stdout.write(line + "\n")
            sys.stdout.flush()

    recovering = os.path.exists(wal_dir) and os.listdir(wal_dir)
    if recovering:
        node = recover_modeb(cfg, ids, node_id, app, wal_dir, native=False,
                             device=args.device)
        m = Messenger(node_id, tuple(topology[node_id]), nodemap)
        node.attach_messenger(m)
        node.request_sync()
    else:
        m = Messenger(node_id, tuple(topology[node_id]), nodemap)
        wal = ModeBLogger(wal_dir, native=False)
        node = ModeBNode(cfg, ids, node_id, app, m, wal=wal,
                         device=args.device)

    # keep-alive failure detection, like the real server: survivors mark a
    # SIGKILL'd peer dead on their own (no manual liveness anywhere)
    fd = FailureDetection(m, monitored=ids, ping_interval_s=0.2,
                          timeout_s=2.0)
    node.attach_failure_detector(fd)

    driver = TickDriver(node, idle_sleep_s=0.02)
    node.on_work = driver.kick
    driver.start()
    if not driver.wait_ready(600):
        emit("startup_failed")
        sys.exit(1)
    emit("ready")

    for line in sys.stdin:
        parts = line.strip().split(" ")
        if not parts or not parts[0]:
            continue
        cmd = parts[0]
        if cmd == "create":
            node.create_group(parts[1], list(range(len(ids))))
            emit(f"created {parts[1]}")
        elif cmd == "propose":
            name, payload = parts[1], bytes.fromhex(parts[2])

            def cb(rid, resp, _n=name):
                emit(f"resp {rid} "
                     f"{resp.hex() if resp is not None else 'NONE'}")

            node.propose(name, payload, cb)
        elif cmd == "db":
            emit("db " + json.dumps(app.db, sort_keys=True))
        elif cmd == "exit":
            break
    fd.close()
    driver.stop()
    node.close()


if __name__ == "__main__":
    main()
