"""Twins of the control-plane unit tests on the port's copies.

* Records, consistent hashing and demand profiles: the same operations on
  both packages give equal results (hash assignments name by name).
* The coordinator over each package's ``PaxosManager``: one scripted
  session (create, request, stop, final state, epoch bump, drop, delete,
  read) logs every observation; the two logs are equal.
* The reference's own cases of ``test_reconfiguration_core.py``,
  ``test_protocoltask.py``, ``test_transport.py`` and the deterministic
  cases of ``test_failure_detection.py`` run on the port: the reference
  source is loaded with every ``gigapaxos_tpu`` import bound to
  ``gigapaxos_tpu_torch`` (and the port's manager on the CPU).
"""

import functools
import re
from pathlib import Path

import pytest

from gigapaxos_tpu.config import GigapaxosTpuConfig as RefConfig
from gigapaxos_tpu.models.replicable import KVApp as RefKV
from gigapaxos_tpu.paxos.manager import PaxosManager as RefManager
from gigapaxos_tpu.reconfiguration import consistent_hashing as ref_ch
from gigapaxos_tpu.reconfiguration import coordinator as ref_coord
from gigapaxos_tpu.reconfiguration import demand as ref_demand
from gigapaxos_tpu.reconfiguration import records as ref_records
from gigapaxos_tpu_torch.config import GigapaxosTpuConfig as PortConfig
from gigapaxos_tpu_torch.models.replicable import KVApp as PortKV
from gigapaxos_tpu_torch.paxos.manager import PaxosManager as PortManager
from gigapaxos_tpu_torch.reconfiguration import consistent_hashing as port_ch
from gigapaxos_tpu_torch.reconfiguration import coordinator as port_coord
from gigapaxos_tpu_torch.reconfiguration import demand as port_demand
from gigapaxos_tpu_torch.reconfiguration import records as port_records

TESTS = Path(__file__).resolve().parent
_REF_IMPORT = re.compile(r"\bgigapaxos_tpu\b(?!_torch)")

#: reference cases of code the port deleted, with the import naming it:
#: ``utils/profiler.py`` (its delay EWMA and sampler; nothing in the port
#: read them)
_DELETED = {"test_protocoltask.py": (
    "from gigapaxos_tpu.utils.profiler import DelayProfiler, Sampler\n",
    ("test_profiler_ewma_and_stats", "test_sampler_gate"))}


def _on_port(filename):
    """The zero-argument ``test_*`` functions of a reference test file,
    compiled with every ``gigapaxos_tpu`` module name bound to the port's
    and ``PaxosManager`` pinned to the CPU, less the cases of code the
    port deleted."""
    path = TESTS / filename
    gone_import, gone = _DELETED.get(filename, ("", ()))
    src = path.read_text()
    assert gone_import in src
    src = _REF_IMPORT.sub("gigapaxos_tpu_torch", src.replace(gone_import, ""))
    ns = {"__name__": f"port_twin_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    if "PaxosManager" in ns:
        ns["PaxosManager"] = functools.partial(ns["PaxosManager"],
                                               device="cpu")
    return {k: v for k, v in ns.items()
            if k.startswith("test_") and callable(v)
            and v.__code__.co_argcount == 0 and k not in gone}


CORE = _on_port("test_reconfiguration_core.py")
PROTOCOLTASK = _on_port("test_protocoltask.py")
TRANSPORT = _on_port("test_transport.py")
FD = {k: v for k, v in _on_port("test_failure_detection.py").items()
      if k in ("test_on_change_edges",
               "test_adaptive_timeout_floor_and_lengthening",
               "test_adaptive_ewma_updates_and_unmonitor_resets",
               "test_self_always_up_and_unmonitor")}


def test_port_cases_were_loaded():
    assert len(CORE) == 15 and len(PROTOCOLTASK) == 5
    assert len(TRANSPORT) == 10 and len(FD) == 4
    mod = CORE["test_record_roundtrip"].__globals__
    assert mod["ReconfigurationRecord"] is port_records.ReconfigurationRecord
    assert mod["PaxosManager"].func is PortManager


@pytest.mark.parametrize("case", sorted(CORE))
def test_reconfiguration_core_on_port(case):
    CORE[case]()


@pytest.mark.parametrize("case", sorted(PROTOCOLTASK))
def test_protocoltask_on_port(case):
    PROTOCOLTASK[case]()


@pytest.mark.parametrize("case", sorted(TRANSPORT))
def test_transport_on_port(case):
    TRANSPORT[case]()


@pytest.mark.parametrize("case", sorted(FD))
def test_failure_detection_on_port(case):
    FD[case]()


# ------------------------------------------------------------ records twin
def _record_flow(rec_mod, flow):
    r = rec_mod.ReconfigurationRecord("svc", epoch=2, actives=["a", "b", "c"])
    out = []
    for op, arg in flow:
        if op == "intent":
            out.append(r.set_intent(arg))
        elif op == "complete":
            out.append(r.set_complete())
        elif op == "delete":
            out.append(r.set_delete_intent(now=arg))
        elif op == "aged":
            out.append(r.delete_aged(60.0, now=arg))
        out.append(r.to_dict())
    r2 = rec_mod.ReconfigurationRecord.from_dict(r.to_dict())
    out.append(r2.to_dict())
    return out


@pytest.mark.parametrize("flow", [
    [("intent", ["b", "d", "c"]), ("intent", ["x"]), ("complete", None)],
    [("delete", 100.0), ("intent", ["b"]), ("aged", 120.0), ("aged", 161.0)],
    [("complete", None), ("intent", ["e"]), ("delete", 5.0),
     ("complete", None), ("delete", 7.0)],
], ids=["reconfigure", "delete_aging", "refused_transitions"])
def test_records_equal(flow):
    assert _record_flow(ref_records, flow) == _record_flow(port_records, flow)


@pytest.mark.parametrize("nodes,k", [
    ([f"RC{i}" for i in range(3)], 3),
    ([f"AR{i}" for i in range(5)], 3),
    ([f"rc{i}" for i in range(6)], 1),
    (["a", "b"], 5),
], ids=["rc3", "ar5", "rc6_k1", "k_capped"])
def test_consistent_hashing_equal_name_by_name(nodes, k):
    ra, rp = ref_ch.ConsistentHashRing(nodes), port_ch.ConsistentHashRing(nodes)
    for i in range(500):
        name = f"name{i}"
        assert rp.replicated_servers(name, k) == ra.replicated_servers(name, k)
        assert rp.primary(name) == ra.primary(name)


def test_demand_profiles_equal():
    def run(mod):
        p = mod.RateBasedMigrationPolicy("svc", migrate_after=5,
                                         min_requests_between=1)
        out = []
        for i in range(4):
            p.register_request(f"c{i % 2}", now=float(i))
        p.register_requests("c2", 3, now=6.0)
        out.append(p.get_stats())
        p.combine({"nreqs": 4, "rate": 2.0, "by_sender": {"c": 4}})
        out.append(p.reconfigure(["n0", "n1", "n2"],
                                 [f"n{j}" for j in range(5)]))
        out.append((p.num_total, p.by_sender, p.inter_arrival_ewma))
        return out

    assert run(port_demand) == run(ref_demand)


# -------------------------------------------------------- coordinator twin
def _coordinator_session(pkg, pipelined):
    if pkg == "ref":
        cfg, kv, mgr_cls, co = RefConfig(), RefKV, RefManager, ref_coord
        kw = {}
    else:
        cfg, kv, mgr_cls, co = PortConfig(), PortKV, PortManager, port_coord
        kw = {"device": "cpu"}
    cfg.paxos.max_groups = 16
    cfg.paxos.pipeline_ticks = pipelined
    mgr = mgr_cls(cfg, 4, [kv() for _ in range(4)], **kw)
    nodes = [f"AR{i}" for i in range(4)]
    coord = co.PaxosReplicaCoordinator(mgr, nodes)
    log = []

    def cb(tag):
        return lambda rid, resp: log.append((tag, resp))

    def settle():
        mgr.run_ticks(4)
        mgr.drain_pipeline()

    log.append(coord.create_replica_group("svc", 0, b"", nodes[:3]))
    log.append(coord.create_replica_group("svc", 0, b"", nodes[:3]))
    log.append(coord.create_replica_group("other", 0, b"", nodes[1:]))
    for i in range(6):
        coord.coordinate_request("svc", 0, f"PUT k{i} v{i}".encode(),
                                 cb(f"put{i}"), entry=nodes[i % 3])
    log.append(coord.coordinate_read("svc", 0, b"GET k1", cb("read")) > 0)
    rids = coord.coordinate_requests_batch(
        [("svc", 0, b"PUT b 1", cb("b0")), ("svc", 1, b"PUT b 2", cb("b1")),
         ("other", 0, b"PUT o 1", cb("b2")), ("nope", 0, b"x", cb("b3"))])
    log.append([r >= 0 for r in rids])
    settle()
    log.append(coord.coordinate_request("svc", 1, b"PUT bad 1"))
    log.append(coord.get_final_state("svc", 0))
    done = []
    log.append(coord.stop_replica_group("svc", 0, done.append))
    settle()
    log.append(done)
    fs = coord.get_final_state("svc", 0)
    log.append(fs)
    log.append([int(x) for x in mgr.exec_watermarks("svc#0")])
    log.append(coord.create_replica_group("svc", 1, fs, nodes[1:]))
    log.append((coord.current_epoch("svc"), coord.get_replica_group("svc")))
    coord.coordinate_request("svc", 1, b"GET k5", cb("get5"))
    coord.coordinate_read("svc", 1, b"GET b", cb("getb"))
    settle()
    log.append(coord.coordinate_request("svc", 0, b"GET k0"))
    log.append(coord.drop_final_state("svc", 0))
    log.append(coord.get_final_state("svc", 0))
    log.append(coord.delete_replica_group("other", 0))
    log.append((coord.get_replica_group("other"),
                coord.coordinate_request("other", 0, b"x")))
    log.append([[app.checkpoint(p) for p in ("svc#0", "svc#1", "other#0")]
                for app in mgr.apps])
    return log


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["eager", "pipelined"])
def test_coordinator_session_equal(pipelined):
    ref = _coordinator_session("ref", pipelined)
    port = _coordinator_session("port", pipelined)
    assert ref == port
    assert ("read", b"v1") in port and ("getb", b"1") in port
    assert ("get5", b"v5") in port


def test_coordinator_unported_paths_raise():
    """Targeted creates, once refused here, land on the asked row as the
    reference's do (and refuse a taken row); a device-app batch is admitted
    through propose_bulk_kv, with a malformed descriptor refused alone
    (-3)."""
    import struct

    got_at = {}
    for key, (C, M, KV, co) in {
            "ref": (RefConfig, RefManager, RefKV, ref_coord),
            "port": (PortConfig, PortManager, PortKV, port_coord)}.items():
        c = C()
        c.paxos.max_groups = 8
        kw = {"device": "cpu"} if key == "port" else {}
        m = M(c, 3, [KV() for _ in range(3)], **kw)
        coord = co.PaxosReplicaCoordinator(m, ["A", "B", "C"])
        got_at[key] = [
            coord.create_replica_group_at("svc", 0, b"", ["A", "B"], row=3),
            m.rows.row("svc#0"), coord.current_epoch("svc"),
            coord.create_replica_group_at("two", 0, b"", ["A"], row=3)]
    assert got_at["ref"] == got_at["port"] == [True, 3, 0, False]
    cfg = PortConfig()
    cfg.paxos.max_groups = 8
    cfg.paxos.compact_outbox = True
    cfg.paxos.device_app = True
    mgr = PortManager(cfg, 3, [None] * 3, device="cpu")
    coord = port_coord.PaxosReplicaCoordinator(mgr, ["A", "B", "C"])
    assert coord.create_replica_group("svc", 0, b"", ["A", "B", "C"])
    got = []
    out = coord.coordinate_requests_batch([
        ("svc", 0, struct.pack("<iii", 1, 4, 40),
         lambda rid, resp: got.append(resp)),
        ("svc", 0, b"x" * 5, None),
        ("svc", 1, struct.pack("<iii", 1, 4, 41), None),
    ])
    assert out[0] > 0 and out[1:] == [-3, -1]
    for _ in range(6):
        mgr.tick()
    assert got == [struct.pack("<i", 40)]
