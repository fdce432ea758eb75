"""One OS process of a Mode B deployment, for the process-level tests.

A thin wrapper over :class:`gigapaxos_tpu_torch.server.ModeBServer`: run as
``python -m gigapaxos_tpu_torch.testing.server_worker <node id> <spec
json>``, where the spec carries the static topology (``actives``, ``rcs``:
id -> ``[host, port]``, pre-assigned ports as a properties file would have
them) and optionally ``max_groups``, ``device_app``, ``fd_ping``,
``fd_timeout``, ``universe``, ``log_dir``, ``replicas_per_name`` and
``device`` (default CUDA).  Prints "ready" once every plane has ticked;
answers "stats" with a JSON line; exits on stdin "exit"/EOF.  SIGKILL the
process to emulate machine death; restart it with the same log dir to
recover from its journals.
"""

import json
import sys

from ..config import GigapaxosTpuConfig
from ..server import ModeBServer


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    node_id = argv[0]
    spec = json.loads(argv[1])
    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = int(spec.get("max_groups", 32))
    if spec.get("device_app"):
        cfg.paxos.device_app = True
    # gentle FD cadence: the processes share the host's cores, and 50 ms
    # pings across every pair are real CPU; ~2 s detection is plenty
    cfg.fd.ping_interval_s = float(spec.get("fd_ping", 0.2))
    cfg.fd.timeout_s = float(spec.get("fd_timeout", 2.0))
    for nid, (host, port) in spec["actives"].items():
        cfg.nodes.actives[nid] = (host, int(port))
    for nid, (host, port) in spec["rcs"].items():
        cfg.nodes.reconfigurators[nid] = (host, int(port))
    if spec.get("universe"):
        cfg.nodes.universe = list(spec["universe"])

    server = ModeBServer(
        node_id, cfg,
        log_dir=spec.get("log_dir"),
        replicas_per_name=int(spec.get("replicas_per_name", 3)),
        device=spec.get("device"),
    )
    server.wait_ready(600)
    print("ready", flush=True)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "exit":
            break
        if cmd == "stats":
            out = {}
            for tag, node in (("ar", server.node), ("rc", server.rc_node)):
                if node is None:
                    continue
                out[tag] = {
                    "alive": [bool(x) for x in node.alive],
                    "ticks": node.tick_num,
                    "stats": dict(node.stats),
                    "coord_view": {
                        name: int(node._coord_view[row])
                        for name, row in node.rows.items()
                    },
                }
            print("stats " + json.dumps(out), flush=True)
    server.close()


if __name__ == "__main__":
    main()
