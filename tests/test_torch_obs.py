"""Observability twin: the port's ``obs/prom.py``, ``obs/http.py``,
``obs/timeline.py`` and ``utils/observability.py`` against the JAX
package's, on the CPU.

Tolerance: 0.  The Prometheus text of the same registry contents is
byte-equal to the reference's (``render_registry`` and ``merge_scrapes``),
and passes the Prometheus lint copied from ``tests/test_prom_lint.py``;
the scrape endpoint serves every route its docstring lists; the stats
reporter survives a failing sink and restarts after a stop; the node
stats source gives the reference's keys and values over both node
flavours; the timeline recorder samples and annotates.
"""

import json
import math
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from gigapaxos_tpu.obs import metrics as jmetrics
from gigapaxos_tpu.obs import prom as jprom
from gigapaxos_tpu.utils import observability as jobs
from gigapaxos_tpu_torch.obs import http as thttp
from gigapaxos_tpu_torch.obs import metrics as tmetrics
from gigapaxos_tpu_torch.obs import prom as tprom
from gigapaxos_tpu_torch.obs import timeline as ttimeline
from gigapaxos_tpu_torch.utils import observability as tobs

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the Prometheus lint (copy)
SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'          # metric name
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'  # labels
    r' (-?(?:[0-9.eE+-]+|Inf|NaN))$')       # value


def lint(body: str) -> None:
    """Assert ``body`` is a well-formed 0.0.4 exposition."""
    seen_meta = set()
    samples = {}
    for ln in body.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            parts = ln.split()
            kind, fam = parts[1], parts[2]
            key = (kind, fam)
            assert key not in seen_meta, f"duplicate metadata: {ln}"
            seen_meta.add(key)
            if kind == "TYPE":
                assert parts[3] in ("counter", "gauge", "histogram",
                                    "summary", "untyped"), ln
            continue
        assert not ln.startswith("#"), f"unknown comment line: {ln}"
        m = SAMPLE_RE.match(ln)
        assert m, f"unparseable sample line: {ln!r}"
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        key = (name, labels)
        assert key not in samples, f"duplicate sample: {ln}"
        samples[key] = float(val)
        assert "\n" not in labels
    buckets = {}
    for (name, labels), val in samples.items():
        if not name.endswith("_bucket"):
            continue
        fam = name[:-len("_bucket")]
        le = re.search(r'le="([^"]*)"', labels).group(1)
        rest = re.sub(r'le="[^"]*",?', "", labels).rstrip(",}") or "{}"
        buckets.setdefault((fam, rest), []).append(
            (math.inf if le == "+Inf" else float(le), val))
    for (fam, rest), bs in buckets.items():
        bs.sort()
        assert bs[-1][0] == math.inf, f"{fam}{rest}: no +Inf bucket"
        vals = [v for _, v in bs]
        assert vals == sorted(vals), \
            f"{fam}{rest}: non-monotone buckets {vals}"
        count = next((v for (n, l), v in samples.items()
                      if n == fam + "_count"
                      and l.rstrip(",}") == rest), None)
        if count is not None:
            assert vals[-1] == count, \
                f"{fam}{rest}: +Inf {vals[-1]} != _count {count}"


def fill(reg):
    """The same contents in either package's registry: escaped label
    values, several label sets a family, help text, a negative gauge, a
    spread histogram and an empty one."""
    reg.counter("lint_total", help='has "quotes" and \\slashes\\',
                node="n0", path='a"b\\c').inc(3)
    reg.counter("lint_total", node="n0", path="plain").inc(1)
    reg.counter("other_total", path="new\nline").inc(7)
    reg.gauge("lint_gauge", help="a gauge", node="n0").set(-2.5)
    reg.gauge("lint_gauge", node="n1").set(1e20)
    reg.gauge("ratio").set(0.125)
    h = reg.histogram("lint_seconds", help="spread", plane="a")
    for v in (1e-5, 3e-4, 0.002, 0.002, 0.6, 11.0):
        h.observe(v)
    reg.histogram("lint_seconds", plane="b").observe(0.25)
    reg.histogram("empty_seconds", help="nothing yet")
    reg.histogram("sizes", unit="", plane="a").observe(4096)
    return reg


@pytest.mark.parametrize("extra", [None, {"node": "n0", "cell": "7"},
                                   {"plane": "override-ignored"}])
def test_render_registry_equals_reference(extra):
    a = jprom.render_registry(fill(jmetrics.Registry()), extra_labels=extra)
    b = tprom.render_registry(fill(tmetrics.Registry()), extra_labels=extra)
    assert a == b
    lint(b)
    assert 'path="a\\"b\\\\c"' in b
    assert tprom.render_registry(tmetrics.Registry()) == ""


def test_merge_scrapes_equals_reference():
    bodies = []
    for mod_m, mod_p in ((jmetrics, jprom), (tmetrics, tprom)):
        b0 = mod_p.render_registry(fill(mod_m.Registry()),
                                   extra_labels={"cell": "0"})
        b1 = mod_p.render_registry(fill(mod_m.Registry()),
                                   extra_labels={"cell": "1"})
        bodies.append(mod_p.merge_scrapes([b0, b1, ""]))
    assert bodies[0] == bodies[1]
    lint(bodies[1])
    assert tprom.merge_scrapes([]) == ""


def test_lint_rejects_known_bad_bodies():
    with pytest.raises(AssertionError):
        lint("# TYPE x counter\n# TYPE x counter\nx 1\n")
    with pytest.raises(AssertionError):
        lint('x{b="1} broken\n')
    with pytest.raises(AssertionError):
        lint("x 1\nx 2\n")
    with pytest.raises(AssertionError):
        lint('h_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\n'
             'h_bucket{le="+Inf"} 6\nh_count 6\n')


def test_live_manager_scrape_lints_clean():
    """A port ``PaxosManager``'s process registry, after work with the
    health fold and leases on, renders to a clean scrape."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    cfg.paxos.group_health = True
    cfg.paxos.read_leases = True
    m = PaxosManager(cfg, 3, [KVApp() for _ in range(3)], device="cpu")
    m.create_paxos_instance("svc", [0, 1, 2])
    for i in range(6):
        m.propose("svc", f"PUT k v{i}".encode())
        for _ in range(2):
            m.tick()
    body = tprom.render_registry(tmetrics.registry(),
                                 extra_labels={"node": "lint"})
    lint(body)
    assert "tick_seconds" in body


# -------------------------------------------------------- the HTTP plane
def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_metrics_server_serves_every_route():
    state = {"ok": True}
    srv = thttp.MetricsServer(
        lambda: "x_total 1\n",
        trace=lambda tid: {"ids": []} if tid is None else {"tid": tid},
        flight=lambda: [{"kind": "boot"}],
        healthz=lambda: {"ok": state["ok"]},
        health=lambda: {"wedged": 0},
        group=lambda name: {"name": name} if name == "svc" else None,
        timeline=lambda: {"samples": [], "events": []},
        port=0)
    try:
        u = srv.url
        code, ctype, body = _get(u + "/metrics")
        assert (code, body) == (200, b"x_total 1\n")
        assert ctype.startswith("text/plain; version=0.0.4")
        assert json.loads(_get(u + "/trace")[2]) == {"ids": []}
        assert json.loads(_get(u + "/trace/42")[2]) == {"tid": "42"}
        assert json.loads(_get(u + "/flight")[2]) == [{"kind": "boot"}]
        assert _get(u + "/healthz")[0] == 200
        state["ok"] = False
        assert _get(u + "/healthz")[0] == 503
        assert json.loads(_get(u + "/health")[2]) == {"wedged": 0}
        assert json.loads(_get(u + "/group/svc")[2]) == {"name": "svc"}
        assert _get(u + "/group/nope")[0] == 404
        assert json.loads(_get(u + "/timeline/")[2])["events"] == []
        assert _get(u + "/nowhere")[0] == 404
        code, _, body = _get(u + "/metrics", method="HEAD")
        assert (code, body) == (200, b"")
    finally:
        srv.close()
    # a source that is off or broken answers 404 / 500, never kills serve
    srv = thttp.MetricsServer(lambda: 1 / 0, health=lambda: None, port=0)
    try:
        assert _get(srv.url + "/metrics")[0] == 500
        assert _get(srv.url + "/health")[0] == 404
        assert _get(srv.url + "/trace")[0] == 404
    finally:
        srv.close()


def test_every_http_route_is_documented_in_module_docstring():
    src = (ROOT / "gigapaxos_tpu_torch/obs/http.py").read_text()
    doc = thttp.__doc__
    handler = src[src.index("def do_GET"):src.index("do_HEAD")]
    routes = set(re.findall(r'"(/[a-z]+/?)"', handler))
    assert routes >= {"/metrics", "/trace", "/trace/", "/flight",
                      "/healthz", "/health", "/group/", "/timeline"}
    for route in routes:
        assert route.rstrip("/") in doc, route


# ---------------------------------------------------- stats and timeline
def test_stats_reporter_survives_sink_errors_and_restarts():
    got = []
    ev = threading.Event()

    def sink(snap):
        got.append(snap)
        if len(got) == 1:
            raise RuntimeError("broken sink")
        ev.set()

    rep = tobs.StatsReporter("n0", interval_s=0.01, sink=sink)
    assert rep.interval_s == 0.5  # the floor, as in the reference
    rep.add_source("ok", lambda: {"x": 1})
    rep.add_source("bad", lambda: 1 / 0)
    snap = rep.snapshot()
    assert snap["ok"] == {"x": 1} and snap["node"] == "n0"
    assert snap["bad"]["error"].startswith("ZeroDivisionError")
    rep.start()
    deadline = time.monotonic() + 30
    while not ev.is_set() and time.monotonic() < deadline:
        ev.wait(0.1)
    assert len(got) >= 2, "the loop died on the sink's error"
    rep.stop()
    n = len(got)
    ev.clear()
    rep.start()  # a stop/start cycle restarts the loop
    deadline = time.monotonic() + 30
    while len(got) == n and time.monotonic() < deadline:
        time.sleep(0.05)
    rep.stop()
    assert len(got) > n
    assert tobs.transport_stats_source(
        type("T", (), {"stats": {"sent": 3}})())() == {"sent": 3}


def _node_pairs():
    """A reference and a port node of each flavour over their SimNets,
    with one group and a few ticks of traffic."""
    from gigapaxos_tpu import config as jconfig
    from gigapaxos_tpu.chain.modeb import ChainModeBNode as JChain
    from gigapaxos_tpu.modeb import ModeBNode as JNode
    from gigapaxos_tpu.models import replicable as jrep
    from gigapaxos_tpu.testing.simnet import SimNet as JNet
    from gigapaxos_tpu_torch import config as tconfig
    from gigapaxos_tpu_torch.chain.modeb import ChainModeBNode as TChain
    from gigapaxos_tpu_torch.modeb import ModeBNode as TNode
    from gigapaxos_tpu_torch.models import replicable as trep
    from gigapaxos_tpu_torch.testing.simnet import SimNet as TNet

    ids = ["N0", "N1", "N2"]
    pairs = []
    for jcls, tcls in ((JNode, TNode), (JChain, TChain)):
        sides = []
        for cfgmod, rep, net, cls, kw in (
                (jconfig, jrep, JNet(seed=0), jcls, {}),
                (tconfig, trep, TNet(seed=0), tcls, {"device": "cpu"})):
            cfg = cfgmod.GigapaxosTpuConfig()
            cfg.paxos.max_groups = 8
            nodes = [cls(cfg, ids, n, rep.KVApp(), net.messenger(n), **kw)
                     for n in ids]
            for n in nodes:
                n.create_group("svc", [0, 1, 2])
            nodes[0].propose("svc", b"PUT a 1")
            for _ in range(6):
                for n in nodes:
                    n.tick()
                net.pump()
            sides.append(nodes[0])
        pairs.append(tuple(sides))
    return pairs


def test_node_stats_source_equals_reference_over_both_flavours():
    for jn, tn in _node_pairs():
        a = jobs.node_stats_source(jn)()
        b = tobs.node_stats_source(tn)()
        assert a == b, type(tn).__name__
        assert {"ticks", "groups", "outstanding", "alive", "stats"} <= set(b)
        assert b["groups"] == 1 and b["ticks"] == 6
    # a Mode A manager (a RowAllocator, a Counter) degrades field by field
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = 8
    m = PaxosManager(cfg, 3, [KVApp() for _ in range(3)], device="cpu")
    m.create_paxos_instance("svc", [0, 1, 2])
    snap = tobs.node_stats_source(m)()
    assert snap["groups"] == 1 and "ticks" in snap


def test_timeline_recorder_samples_and_annotates():
    reg = tmetrics.registry()
    c = reg.counter("timeline_probe_total", help="test", node="a")
    reg.counter("timeline_probe_total", node="b").inc(2)
    c.inc(3)
    reg.histogram("timeline_probe_seconds", node="a").observe(0.5)
    sample = ttimeline.registry_sampler("timeline_probe_total",
                                        "timeline_probe_seconds")
    rec = ttimeline.TimelineRecorder(sample, interval_s=0.001, cap=8,
                                     node="t0")
    assert rec.interval_s == 0.01
    row = rec.sample_once()
    assert row["timeline_probe_total"] == 5.0
    assert row["timeline_probe_seconds_p99"] > 0
    rec.annotate("crash", node="N2")
    bad = ttimeline.TimelineRecorder(lambda: 1 / 0, node="t1")
    assert bad.sample_once()["sample_error"] == 1
    rec.start()
    deadline = time.monotonic() + 30
    while len(rec.snapshot()["samples"]) < 8 and time.monotonic() < deadline:
        time.sleep(0.01)
    rec.stop()
    snap = rec.snapshot()
    assert len(snap["samples"]) == 8  # the ring's cap
    assert snap["events"][0]["kind"] == "crash" and snap["node"] == "t0"
