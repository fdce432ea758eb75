"""The one request generator: every traffic mix is a data file it reads.

A mix (``traffic/<name>.json``) states the loop, its size and the request
contents:

* ``"loop": "closed"`` with ``"clients"``: that many requests are kept in
  flight; the next is sent when one is acknowledged.
* ``"loop": "open"`` with ``"rate"`` (requests/s): Poisson arrivals at that
  rate, each request timed from its due time.
* ``"groups"``: ``{"dist": "uniform"}``, the target group of each request.
* ``"ops"``: the share of each operation (``inc`` for a counter app, ``put``
  and ``get`` for a key-value app).
* ``"keys_per_group"``: how many distinct keys a group's requests name; the
  keys themselves are a fixed hash of the seed, the group and the key's
  index, spread over [1, 2^31).
* ``"delta"``: ``[lo, hi]``, the range of a counter increment, and
  ``"value"``: the same for a PUT's value.

The stream is a function of the seed alone: request ``i`` is the same
whatever the loop consumes around it, so the same seed gives the same
requests and the same arrival times.  Requests are drawn in fixed chunks
from ``numpy.random.Generator`` streams keyed by the seed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

#: operation codes of a generated request (a key-value app's PUT and GET
#: are the wire codes of the device KV app: PUT=1, GET=2)
OP_INC, OP_PUT, OP_GET = 0, 1, 2
OP_NAMES = {"inc": OP_INC, "put": OP_PUT, "get": OP_GET}

CHUNK = 1 << 16
_KEY_SPACE = (1 << 31) - 1


def load(path) -> dict:
    with open(path) as f:
        mix = json.load(f)
    mix["name"] = Path(path).stem
    if mix["loop"] not in ("closed", "open"):
        raise ValueError(f"{path}: loop is {mix['loop']!r}")
    if mix.get("groups", {"dist": "uniform"})["dist"] != "uniform":
        raise ValueError(f"{path}: only uniform groups are generated")
    return mix


def _splitmix(x: np.ndarray) -> np.ndarray:
    """SplitMix64's finaliser over uint64 (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def group_keys(seed: int, groups, index) -> np.ndarray:
    """Key ``index`` of each group in ``groups``: int32 in [1, 2^31)."""
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    h = _splitmix(_splitmix(np.asarray(groups, np.uint64) ^ s)
                  + np.asarray(index, np.uint64))
    return (1 + (h % np.uint64(_KEY_SPACE))).astype(np.int32)


class Requests:
    """Column arrays of a block of generated requests."""

    __slots__ = ("group", "op", "key", "val", "delta")

    def __init__(self, group, op, key, val, delta):
        self.group, self.op, self.key = group, op, key
        self.val, self.delta = val, delta

    def __len__(self) -> int:
        return len(self.group)

    @staticmethod
    def concat(parts) -> "Requests":
        return Requests(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in Requests.__slots__))


class RequestStream:
    """Request ``i`` of a seed, handed out in order by :meth:`take`."""

    def __init__(self, mix: dict, seed: int, n_groups: int):
        self.mix, self.seed, self.G = mix, int(seed), int(n_groups)
        ops = mix.get("ops", {"inc": 1.0})
        self._codes = np.array([OP_NAMES[k] for k in ops], np.int32)
        share = np.array(list(ops.values()), np.float64)
        self._cum = np.cumsum(share / share.sum())
        self._kpg = int(mix.get("keys_per_group", 1))
        self._delta = mix.get("delta", [1, 256])
        self._value = mix.get("value", [1, _KEY_SPACE])
        self._rng = np.random.default_rng([self.seed, 1])
        self._buf: list = []
        self._have = 0
        self.taken = 0

    def _chunk(self) -> Requests:
        rng = self._rng
        g = rng.integers(0, self.G, CHUNK, dtype=np.int64)
        u = rng.random(CHUNK)
        op = self._codes[np.minimum(np.searchsorted(self._cum, u, "right"),
                                    len(self._codes) - 1)]
        kidx = rng.integers(0, self._kpg, CHUNK, dtype=np.int64)
        val = rng.integers(self._value[0], self._value[1], CHUNK,
                           dtype=np.int64).astype(np.int32)
        delta = rng.integers(self._delta[0], self._delta[1] + 1, CHUNK,
                             dtype=np.int64)
        return Requests(g, op, group_keys(self.seed, g, kidx), val, delta)

    def take(self, n: int) -> Requests:
        """The next ``n`` requests of the stream."""
        while self._have < n:
            c = self._chunk()
            self._buf.append(c)
            self._have += len(c)
        parts, need = [], n
        while need:
            c = self._buf[0]
            if len(c) <= need:
                parts.append(self._buf.pop(0))
                need -= len(c)
            else:
                parts.append(Requests(*(getattr(c, f)[:need]
                                        for f in Requests.__slots__)))
                self._buf[0] = Requests(*(getattr(c, f)[need:]
                                          for f in Requests.__slots__))
                need = 0
        self._have -= n
        self.taken += n
        if len(parts) == 1:
            return parts[0]
        return Requests.concat(parts)


class Arrivals:
    """Due times (seconds from the start of the load) of an open loop's
    requests: a Poisson process at the mix's rate, drawn from its own
    stream so that the request contents do not depend on the rate."""

    def __init__(self, rate: float, seed: int):
        self.rate = float(rate)
        self._rng = np.random.default_rng([int(seed), 2])
        self._t = 0.0
        self._due = np.zeros(0)
        self._pos = 0

    def until(self, t: float) -> np.ndarray:
        """Due times of every arrival not handed out yet that is due at or
        before ``t``, in order."""
        while not len(self._due) or self._due[-1] <= t:
            gaps = self._rng.exponential(1.0 / self.rate, CHUNK)
            new = self._t + np.cumsum(gaps)
            self._t = float(new[-1])
            self._due = np.concatenate([self._due[self._pos:], new])
            self._pos = 0
        end = int(np.searchsorted(self._due, t, "right"))
        out = self._due[self._pos:end]
        self._pos = end
        return out
