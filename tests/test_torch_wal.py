"""WAL twin, storage layer: the port's record codec, journals (pure Python
and native), columnar slabs and the replay device functions against the JAX
package's, from the same numpy-seeded inputs.

Tolerance: 0.  Encoded records and journal files must be equal byte for
byte (``bytes ==``); arrays, device states and compact buffers must be
equal element for element (``np.array_equal``).
"""

import os
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import tick as jtick
from gigapaxos_tpu.paxos import state as jst
from gigapaxos_tpu.wal import columnar as jcol
from gigapaxos_tpu.wal import journal as jjournal
from gigapaxos_tpu.wal import records as jrec
from gigapaxos_tpu_torch.ops import tick as ttick
from gigapaxos_tpu_torch.paxos import state as tst
from gigapaxos_tpu_torch.testing import faultdisk as tfault
from gigapaxos_tpu_torch.wal import columnar as tcol
from gigapaxos_tpu_torch.wal import journal as tjournal
from gigapaxos_tpu_torch.wal import logger as tlog
from gigapaxos_tpu_torch.wal import native_journal as tnative
from gigapaxos_tpu_torch.wal import records as trec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ record codec

def _random_value(rng: np.random.Generator, depth: int = 0):
    kinds = ["none", "bool", "int", "bigint", "float", "str", "bytes",
             "ndarray", "npint", "npbool"]
    if depth < 3:
        kinds += ["tuple", "list", "set", "dict"] * 2
    k = kinds[rng.integers(len(kinds))]
    if k == "none":
        return None
    if k == "bool":
        return bool(rng.integers(2))
    if k == "int":
        return int(rng.integers(-2**63, 2**63 - 1, dtype=np.int64))
    if k == "bigint":
        return int(rng.integers(1, 2**62)) * (1 << int(rng.integers(64, 130)))
    if k == "float":
        return float(rng.standard_normal())
    if k == "str":
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 5))
    if k == "bytes":
        return rng.bytes(int(rng.integers(0, 40)))
    if k == "ndarray":
        dt = ["<i4", "<i8", "|b1", "<f8", "|u1"][rng.integers(5)]
        shape = tuple(int(s) for s in rng.integers(0, 4, rng.integers(0, 3)))
        return (rng.integers(-9, 9, shape) if dt != "|b1"
                else rng.integers(0, 2, shape)).astype(dt)
    if k == "npint":
        return np.int32(rng.integers(-1000, 1000))
    if k == "npbool":
        return np.bool_(rng.integers(2))
    n = int(rng.integers(0, 5))
    if k == "tuple":
        return tuple(_random_value(rng, depth + 1) for _ in range(n))
    if k == "list":
        return [_random_value(rng, depth + 1) for _ in range(n)]
    if k == "set":
        return {int(x) for x in rng.integers(-50, 50, n)}
    return {(int(rng.integers(100)), str(i)): _random_value(rng, depth + 1)
            for i in range(n)}


def _walk(v):
    yield v
    if isinstance(v, (list, tuple, set)):
        for x in v:
            yield from _walk(x)
    elif isinstance(v, dict):
        for k, x in v.items():
            yield from _walk(k)
            yield from _walk(x)


def _same(a, b):
    """Structural equality that compares arrays by dtype and content."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("seed", range(8))
def test_records_dumps_bytes_equal_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        v = _random_value(rng)
        b = trec.dumps(v)
        assert b == jrec.dumps(v)
        back = trec.loads(b)
        assert _same(back, jrec.loads(b))
        # a decoded set may iterate in another order: re-encode both
        # packages' decodes and compare those
        assert trec.dumps(back) == jrec.dumps(jrec.loads(b)) or any(
            isinstance(x, set) for x in _walk(back))


def test_records_of_the_mode_a_path_bytes_equal():
    rng = np.random.default_rng(11)
    rids = rng.integers(1, 2**31, 6).astype(np.int64)
    bulk = (rids.tobytes(), rng.integers(0, 3, 6).astype(np.int32).tobytes(),
            np.zeros(6, np.int32).tobytes(),
            rng.integers(0, 64, 6).astype(np.int32).tobytes(),
            np.zeros(6, bool).tobytes(),
            [b"x" * 40, ("\x00payref", b"\x01" * 8), b"short"] * 2)
    recs = [
        (tlog.OP_CREATE, "svc", [0, 1, 2], 0),
        (tlog.OP_REMOVE, "svc"),
        (tlog.OP_TICK, 7, [(3, [(12, 1, 0, b"PUT k v", False)])],
         np.ones(3, bool).tobytes(), bulk, None),
        (tlog.OP_PAUSE, ["a", "b"]),
        (tlog.OP_UNPAUSE, "a"),
        (tlog.OP_SYNC, 2, "svc", 0, 40, 1, b"{}"),
    ]
    for r in recs:
        assert trec.dumps(r) == jrec.dumps(r)
        assert trec.validate_op_record(trec.loads(trec.dumps(r)),
                                       tlog.OP_SCHEMA) == r[0]


@pytest.mark.parametrize("bad", [
    [], (), ("x",), (True,), (99,), (3, 1), (2, "a", "b"),
])
def test_validate_op_record_refuses_like_the_reference(bad):
    from gigapaxos_tpu.wal.logger import OP_SCHEMA as JSCHEMA

    assert tlog.OP_SCHEMA == JSCHEMA
    with pytest.raises(trec.SchemaError):
        trec.validate_op_record(bad, tlog.OP_SCHEMA)
    with pytest.raises(jrec.SchemaError):
        jrec.validate_op_record(bad, JSCHEMA)


# ---------------------------------------------------------------- journals

def _script(seed: int):
    rng = random.Random(seed)
    out = []
    for _ in range(rng.randrange(3, 14)):
        out.append(("append", bytes(rng.randrange(256)
                                    for _ in range(rng.randrange(0, 90)))))
        if rng.random() < 0.4:
            out.append(("sync", None))
    return out


def _run_script(j, script):
    for op, payload in script:
        if op == "append":
            j.append(payload)
        else:
            j.sync()
    j.close()


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", range(6))
def test_pyjournal_bytes_equal(tmp_path, seed):
    script = _script(seed)
    a, b = str(tmp_path / "ref.log"), str(tmp_path / "port.log")
    _run_script(jjournal.PyJournal(a), script)
    _run_script(tjournal.PyJournal(b), script)
    assert _read(a) == _read(b)
    # reopen continues the same seq in both
    _run_script(jjournal.PyJournal(a), [("append", b"more"), ("sync", None)])
    _run_script(tjournal.PyJournal(b), [("append", b"more"), ("sync", None)])
    assert _read(a) == _read(b)


def _scan_fields(s):
    return (s.version, s.kind, s.records, s.n_synced, s.suffix, s.good_len,
            s.bad_offset, s.resync_offset, s.last_seq, s.file_size,
            s.n_records, s.n_suffix)


def test_scan_classification_randomized_matches_reference(tmp_path):
    """Randomized tear / bit flip / garbage tail: the port's scanner gives
    the reference's verdict field for field, the meta-only scan agrees,
    and the reopen decision follows it (tears repaired, scribbles
    refused with the file untouched)."""
    for seed in range(24):
        rng = random.Random(seed)
        p = str(tmp_path / f"j{seed}.log")
        j = tjournal.PyJournal(p)
        recs = []
        for _ in range(rng.randrange(4, 12)):
            r = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
            j.append(r)
            recs.append(r)
            if rng.random() < 0.4:
                j.sync()
        j.close()
        size = os.path.getsize(p)
        mutation = rng.choice(("tear", "flip", "garbage"))
        if mutation == "tear":
            tfault.tear_tail(p, rng.randrange(1, size - 8), rng=rng)
        elif mutation == "flip":
            tfault.flip_byte(p, rng.randrange(8, size), rng=rng)
        else:
            with open(p, "ab") as f:
                f.write(bytes(rng.randrange(256)
                              for _ in range(rng.randrange(1, 12))))
        scan = tjournal.scan_journal(p)
        assert _scan_fields(scan) == _scan_fields(jjournal.scan_journal(p))
        meta = tjournal.scan_journal(p, meta_only=True)
        assert (meta.kind, meta.good_len, meta.n_records, meta.n_suffix) == \
            (scan.kind, scan.good_len, scan.n_records, scan.n_suffix)
        assert list(tjournal.iter_scan_records(p, meta)) == scan.records
        assert scan.records == recs[:len(scan.records)], (seed, mutation)
        if mutation == "garbage":
            assert scan.kind == "torn_tail", seed
        if scan.kind == "scribble":
            before = _read(p)
            with pytest.raises(tjournal.JournalCorruptError):
                tjournal.PyJournal(p)
            with pytest.raises(tjournal.JournalCorruptError):
                tnative.NativeJournal(p)
            assert _read(p) == before, (seed, mutation)
        else:
            q = p + ".ref"
            with open(q, "wb") as f:
                f.write(_read(p))
            _run_script(tjournal.PyJournal(p), [("append", b"post")])
            _run_script(jjournal.PyJournal(q), [("append", b"post")])
            assert _read(p) == _read(q)
            assert tjournal.read_journal(p) == scan.records + [b"post"]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 65537])
def test_native_crc32_equals_zlib(n):
    data = np.random.default_rng(n).bytes(n)
    assert tnative.crc32(data) == zlib.crc32(data)
    assert tnative.crc32(data, 0xDEADBEEF) == zlib.crc32(data, 0xDEADBEEF)


@pytest.mark.parametrize("seed", range(6))
def test_native_journal_bytes_equal_both_pyjournals(tmp_path, seed):
    """The port's C++ journal, built here with g++, writes the bytes both
    packages' pure-Python journals write, and repairs the same tear to
    the same bytes."""
    script = _script(100 + seed)
    paths = {k: str(tmp_path / f"{k}.log") for k in ("ref", "port", "nat")}
    _run_script(jjournal.PyJournal(paths["ref"]), script)
    _run_script(tjournal.PyJournal(paths["port"]), script)
    _run_script(tnative.NativeJournal(paths["nat"]), script)
    want = _read(paths["ref"])
    assert _read(paths["port"]) == want
    assert _read(paths["nat"]) == want
    drop = random.Random(seed).randrange(1, max(2, min(32, len(want) - 9)))
    for p in paths.values():
        tfault.tear_tail(p, drop)
    _run_script(jjournal.PyJournal(paths["ref"]), [("append", b"after")])
    _run_script(tjournal.PyJournal(paths["port"]), [("append", b"after")])
    _run_script(tnative.NativeJournal(paths["nat"]), [("append", b"after")])
    want = _read(paths["ref"])
    assert _read(paths["port"]) == want
    assert _read(paths["nat"]) == want


def test_native_true_never_falls_back(tmp_path, monkeypatch):
    """``native=True`` opens the C++ journal or raises: a failed build is
    an error, not a silent switch to the Python backend."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LOAD_ERROR", None)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "build" / "libgpjournal-x.so")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    wal = tlog.PaxosLogger(str(tmp_path / "wal"), native=True)
    with pytest.raises(tnative.NativeUnavailable):
        wal.attach(object())
    assert wal.backend is None  # nothing opened
    py = tlog.PaxosLogger(str(tmp_path / "w2"), native=False)
    py.attach(object())
    assert py.backend == "python"
    py.close()


# ----------------------------------------------------------- columnar slabs

def _tick_records(seed: int, R=3, G=64, P=2, T=6, with_bulk=True):
    """Decoded OP_TICK records with unique (entry, lane, row) per tick,
    payref markers and bulk columns, as the manager writes them."""
    rng = np.random.default_rng(seed)
    recs, rid, seen = [], 1, False
    big = [bytes([65 + i]) * 40 for i in range(3)]
    for t in range(T):
        triples = rng.permutation(R * P * G)[:int(rng.integers(0, 12))]
        by_row = {}
        for k in sorted(triples):
            e, rest = divmod(int(k), P * G)
            p, g = divmod(rest, G)
            pl = (big[int(rng.integers(3))] if rng.integers(2)
                  else f"PUT k{rid}".encode())
            by_row.setdefault(g, []).append((rid, e, p, pl,
                                             bool(rng.integers(5) == 0)))
            rid += 1
        placed = sorted(by_row.items())
        for _g, ents in placed:  # writer order: dedup a body seen before
            for i, (r_, e_, p_, pl, s_) in enumerate(ents):
                if seen and pl is big[0] and rng.integers(2):
                    ents[i] = (r_, e_, p_, ("\x00payref", jrec_digest(pl)),
                               s_)
                seen = seen or pl is big[0]
        bulk = None
        if with_bulk and rng.integers(2):
            used = {(e, p, g) for g, ents in placed for _, e, p, _, _ in ents}
            free = [k for k in range(R * P * G)
                    if (k // (P * G), (k % (P * G)) // G, k % G) not in used]
            pick = rng.permutation(free)[:int(rng.integers(1, 6))]
            n = len(pick)
            rids = np.arange(rid, rid + n, dtype=np.int64)
            rid += n
            bulk = (rids.tobytes(),
                    np.array([k // (P * G) for k in pick], np.int32).tobytes(),
                    np.array([(k % (P * G)) // G for k in pick],
                             np.int32).tobytes(),
                    np.array([k % G for k in pick], np.int32).tobytes(),
                    np.zeros(n, bool).tobytes(),
                    [big[1]] * n)
        alive = np.ones(R, bool)
        alive[int(rng.integers(R))] = bool(rng.integers(2))
        recs.append((tlog.OP_TICK, 100 + t, placed, alive.tobytes(), bulk,
                     None))
    return recs


def jrec_digest(b):
    from gigapaxos_tpu_torch.paxos.paystore import payload_digest

    return payload_digest(b)


@pytest.mark.parametrize("seed", range(4))
def test_build_tick_slab_and_coo_window_equal(seed):
    recs = _tick_records(seed)
    pay_j, pay_t = {}, {}
    sj = jcol.build_tick_slab(recs, 3, pay_j)
    sp = tcol.build_tick_slab(recs, 3, pay_t)
    for f in ("tick_nums", "offsets", "entry", "lane", "row", "rid", "stop",
              "alive"):
        a, b = getattr(sj, f), getattr(sp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert sj.payloads == sp.payloads and pay_j == pay_t
    assert sj.row_groups == sp.row_groups and sj.bulk == sp.bulk
    assert sj.max_entries() == sp.max_entries()
    for t in range(len(recs)):
        assert jcol.resolved_placed(sj, t) == tcol.resolved_placed(sp, t)
    M = 8
    while M < sp.max_entries():
        M *= 2
    for a, b in zip(jcol.coo_window(sj, 1, 5, 64, M),
                    tcol.coo_window(sp, 1, 5, 64, M)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dangling_payref_raises_in_both():
    recs = [(tlog.OP_TICK, 0, [(1, [(5, 0, 0, ("\x00payref", b"\x02" * 8),
                                     False)])], np.ones(3, bool).tobytes())]
    with pytest.raises(ValueError, match="dangling"):
        tcol.build_tick_slab(recs, 3)
    with pytest.raises(ValueError, match="dangling"):
        jcol.build_tick_slab(recs, 3)


# --------------------------------------------------- replay device functions

R, W, P, G = 3, 8, 2, 48


def _busy_states(seed: int):
    """The same busy state in both packages: groups created, then a few
    loaded ticks through the reference tick."""
    rng = np.random.default_rng(seed)
    s = jst.create_groups(jst.init_state(R, G, W), np.arange(G, dtype=np.int32),
                          rng.random((G, R)) < 0.9)
    for t in range(4):
        req = np.where(rng.random((R, P, G)) < 0.3,
                       rng.integers(1, 2**31 - 1, (R, P, G)), 0)
        s, _ = jtick.paxos_tick_packed(
            s, jtick.TickInbox(jnp.asarray(req, jnp.int32),
                               jnp.zeros((R, P, G), bool),
                               jnp.asarray(rng.random(R) < 0.9)), -1, 0)
    return s, tst.state_from_numpy([np.asarray(f) for f in s], device="cpu")


def _window(seed: int, K: int, g_total: int, M: int = 16):
    """K ticks of COO columns: unique real (entry, lane, row) per tick,
    the rest padding at row g_total."""
    rng = np.random.default_rng(seed)
    e = np.zeros((K, M), np.int32)
    p = np.zeros((K, M), np.int32)
    g = np.full((K, M), g_total, np.int32)
    rid = np.zeros((K, M), np.int32)
    stop = np.zeros((K, M), bool)
    for k in range(K):
        n = int(rng.integers(0, M))
        pick = rng.permutation(R * P * g_total)[:n]
        e[k, :n] = pick // (P * g_total)
        p[k, :n] = (pick % (P * g_total)) // g_total
        g[k, :n] = pick % g_total
        rid[k, :n] = rng.integers(1, 2**31 - 1, n)
        stop[k, :n] = rng.random(n) < 0.05
    alive = rng.random((K, R)) < 0.85
    return {"e": e, "p": p, "g": g, "rid": rid, "stop": stop, "alive": alive}


def _assert_states(js, ts):
    for name, a, b in zip(tst.PaxosState._fields, js, tst.state_to_numpy(ts)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_coo_inbox_equals_reference():
    xs = _window(3, 4, G)
    for k in range(4):
        xj = {key: jnp.asarray(v[k]) for key, v in xs.items()}
        ib_j = jtick._coo_inbox(xj, R, P, G)
        xt = {key: torch.as_tensor(v[k], dtype=torch.int64
                                   if key in "epg" else None)
              for key, v in xs.items()}
        ib_t = ttick._coo_inbox(xt, R, P, G)
        assert ib_t.req.is_contiguous() and ib_t.stop.is_contiguous()
        for a, b in zip(ib_j, ib_t):
            assert np.array_equal(np.asarray(a), b.numpy())
            assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("budget", ["unlimited", "biting"])
def test_replay_scan_ticks_window_equals_reference(budget):
    js, ts = _busy_states(5)
    K = 6
    xs = _window(9, K, G)
    eb = 0 if budget == "unlimited" else 20
    scat, lagb = 64, 16
    sj, pj = jtick.replay_scan_ticks(
        js, {k: jnp.asarray(v) for k, v in xs.items()}, P, eb, scat, lagb)
    before = tst.state_to_numpy(ts)
    st_, pt_ = ttick.replay_scan_ticks(ts, xs, P, eb, scat, lagb)
    assert pt_.shape == (K, np.asarray(pj).shape[1])
    assert np.array_equal(np.asarray(pj), pt_.numpy())
    _assert_states(sj, st_)
    # functional: the pre-window state is untouched (overflow fallback)
    for a, b in zip(before, tst.state_to_numpy(ts)):
        assert np.array_equal(a, b)


def test_replay_gather_scatter_rows_equal_reference():
    js, ts = _busy_states(7)
    rows = np.array([5, 0, 17, 40, 2, 33, 9, 47], np.int64)
    cj = jtick.replay_gather_rows(js, jnp.asarray(rows, jnp.int32))
    ct = ttick.replay_gather_rows(ts, rows)
    _assert_states(cj, ct)
    # evolve the narrow states identically, then scatter back
    xs = _window(11, 3, len(rows), M=8)
    cj2, _ = jtick.replay_scan_ticks(
        cj, {k: jnp.asarray(v) for k, v in xs.items()}, P, 0, 64, 16)
    ct2, _ = ttick.replay_scan_ticks(ct, xs, P, 0, 64, 16)
    _assert_states(cj2, ct2)
    fj = jtick.replay_scatter_rows(js, cj2, jnp.asarray(rows, jnp.int32))
    ft = ttick.replay_scatter_rows(ts, ct2, torch.as_tensor(rows))
    assert ft is ts
    _assert_states(fj, ft)

