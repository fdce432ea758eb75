"""The generator: a seed fixes every arrival, group, operation and key."""

import json

import numpy as np

from gpbench import traffic as tr
from gpbench.tests.gpbench_helpers import ROOT

MIXES = sorted((ROOT / "gpbench" / "traffic").glob("*.json"))


def _draw(mix, seed, n=100_000, G=1 << 20):
    s = tr.RequestStream(mix, seed, G)
    parts = [s.take(k) for k in (1, 999, 30_000, n - 31_000)]
    return tr.Requests.concat(parts)


def test_same_seed_same_requests_whatever_the_take_sizes():
    mix = tr.load(ROOT / "gpbench" / "traffic" / "closed-100k-ycsba.json")
    a = _draw(mix, 2**40 + 3)
    b = tr.RequestStream(mix, 2**40 + 3, 1 << 20).take(100_000)
    for f in tr.Requests.__slots__:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    c = _draw(mix, 2**40 + 4)
    assert not np.array_equal(a.group, c.group)


def test_ycsba_mix_shares_keys_and_ranges():
    mix = tr.load(ROOT / "gpbench" / "traffic" / "closed-100k-ycsba.json")
    r = _draw(mix, 99)
    assert set(np.unique(r.op).tolist()) == {tr.OP_PUT, tr.OP_GET}
    assert abs((r.op == tr.OP_PUT).mean() - 0.5) < 0.01
    assert r.key.min() >= 1 and r.group.min() >= 0
    assert r.group.max() < 1 << 20
    # a group's requests name at most keys_per_group keys, fixed by seed
    g = r.group[0]
    k = np.unique(r.key[r.group == g])
    assert len(k) <= mix["keys_per_group"]
    want = tr.group_keys(99, np.full(8, g), np.arange(8))
    assert set(k.tolist()) <= set(want.tolist())
    assert r.val.min() >= 1


def test_counter_mix_increments():
    mix = tr.load(ROOT / "gpbench" / "traffic" / "closed-100k.json")
    r = _draw(mix, 5)
    assert (r.op == tr.OP_INC).all()
    lo, hi = mix["delta"]
    assert r.delta.min() >= lo and r.delta.max() <= hi


def test_arrivals_repeat_and_keep_rate():
    a = tr.Arrivals(50_000.0, 2**33 + 1)
    b = tr.Arrivals(50_000.0, 2**33 + 1)
    x = np.concatenate([a.until(0.1), a.until(0.1), a.until(2.0)])
    y = b.until(2.0)
    assert np.array_equal(x, y)
    assert np.all(np.diff(y) >= 0) and y[-1] <= 2.0
    assert abs(len(y) / 2.0 / 50_000 - 1) < 0.02


def test_every_mix_file_loads():
    for p in MIXES:
        mix = tr.load(p)
        assert mix["loop"] in ("closed", "open")
        json.dumps(mix)
        tr.RequestStream(mix, 1, 1024).take(10)
