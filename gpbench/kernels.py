"""Bytes the plane-select kernels must move in one Paxos tick, and the
peak bandwidth of the card they run on.

A tick makes five gather launches and one match launch (the tick's sets
S1-S5 and M).  Each launch reads each input once (the shared index once)
and writes each output once; a gather's output has its input's shape, a
match's outputs are ``[W, G]``.  Elements are int32 (4 bytes) or bool (1).
The sets, with R replicas, window W, G groups and P proposals a tick
(E = R * P intake entries):

  S1 phase 1             4 int32 + 1 bool [R, W, G], index [W, G]
  S2 carryover to ring   2 int32 + 2 bool [W, G],    index [W, G]
  S3 tally               5 int32 + 2 bool [R, W, G], index [W, G]
  S4 decisions to ring   1 int32 + 2 bool [W, G],    index [W, G]
  S5 execution           2 int32 + 2 bool [R, W, G], index [R, W, G]
  M  intake match        vals 1 int32 + 1 bool [E, G], keys int32 [E, G],
                         index [W, G]; outputs 1 int32 + 1 bool [W, G]
"""

from __future__ import annotations

I32, BOOL = 4, 1

#: device records of the two kernels, by the kernel function's name
GATHER_KERNEL = "gather_planes_kernel"
MATCH_KERNEL = "match_planes_kernel"

#: peak device-memory bandwidth (bytes/s) by card name, most specific
#: first (NVIDIA's data sheets: H100 SXM 3.35 TB/s, H100 NVL 3.9 TB/s,
#: H100 PCIe 2.0 TB/s, H200 4.8 TB/s)
PEAK_BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                  ("H100 PCIe", 2.0e12), ("H100 80GB HBM3", 3.35e12),
                  ("H100 SXM", 3.35e12))


def peak_bandwidth(card: str) -> float:
    """The card's peak bandwidth; an unknown card raises (no fallback)."""
    for key, bw in PEAK_BANDWIDTH:
        if key in card:
            return bw
    raise ValueError(f"no peak bandwidth known for the card {card!r}")


def _gather(n_i32: int, n_bool: int, elems: int, idx_elems: int) -> int:
    per = n_i32 * I32 + n_bool * BOOL
    return 2 * per * elems + I32 * idx_elems


def gather_bytes(R: int, W: int, G: int) -> int:
    """Bytes of the five gather launches of one tick."""
    rwg, wg = R * W * G, W * G
    return (_gather(4, 1, rwg, wg) + _gather(2, 2, wg, wg)
            + _gather(5, 2, rwg, wg) + _gather(1, 2, wg, wg)
            + _gather(2, 2, rwg, rwg))


def match_bytes(R: int, W: int, G: int, P: int) -> int:
    """Bytes of the match launch of one tick."""
    eg, wg = R * P * G, W * G
    return ((I32 + BOOL) * eg + I32 * eg + I32 * wg
            + (I32 + BOOL) * wg)


GATHERS_PER_TICK, MATCHES_PER_TICK = 5, 1
