#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gigapaxos_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a).  It

1. builds the port's CUDA kernels from ``gigapaxos_tpu_torch/csrc``;
2. kernels phase: holds each hand-written kernel against its plain PyTorch
   version on small edge cases (ragged G, unaligned views, out-of-range
   indices, 1..8 arrays a launch) and at every shape the tick gives it:
   the one-array classes and the five gather sets and one match set that
   share an index, with inputs shaped as the tick makes them (exact
   equality).  It times each case with CUDA events, with the L2 cache
   flushed before every timed launch: one fused launch, one launch per
   array, the plain version and, for the gather, ``torch.gather`` per
   array (a yardstick the port never calls).  It holds the Mode A inbox
   scatter (``gp_scatter_inbox``) against its plain version at the
   one-card cells' inbox (R=3, P=4, G=2^20) with ~2,800 and 100,000
   placements, and times it beside the bare ``index_put_``;
3. tick phase: the fused tick at R=3, W=8, P=4, G=2^20 with bench.py's
   load (one fresh request per group per tick), compact outbox; checks the
   kernel launch counts, that every taken request executes exactly once
   at each replica in slot order, and that the first ticks equal a CPU run
   of the same inputs byte for byte;
4. manager phase: ``PaxosManager`` at stack_bench's shape (G=2^17, compact
   outbox, pipelined ticks, three ``DenseCounterApp``s) under
   ``propose_bulk`` load with completion sinks, then a ``KVApp`` leg;
5. wal phase, two legs on the native journal (``csrc/journal.cc``, built
   with g++): ``wal-128k`` makes the manager phase's deployment durable
   (fsync every tick, one checkpoint mid-run), crashes it, recovers it on
   the card through both replay arms and holds both against each other and
   against the drained live manager (every acked request present at every
   replica, the first ticks' journal byte-equal to a CPU run);
   ``recovery-1M-sparse`` journals 8 busy groups on a 2^20-group plane,
   crashes, recovers through the sparse batched replay, and serves a probe.
   Each replayed tick must launch 5 gathers and 1 match;
6. cluster phase: the port's ``InProcessCluster`` with 5 actives and 3
   reconfigurators on loopback ports, 2^20 rows on each plane (``KVApp``,
   3 replicas per name), driven through ``ReconfigurableAppClient``:
   64 names created in batches, one PUT each through batched sends,
   every name read back (16 of them one at a time for latency), 4 names
   reconfigured onto a rotated 3-of-5 set, 4 deleted, the survivors read
   back again and their app states held equal at every member; 32 names
   also go through the DNS edge (an ``A`` query each, answered with the
   name's actives) and the HTTP edge (a PUT and a GET each, answered as
   the client is).  Every tick of both planes must launch 5 gathers and 1
   match;
7. planes phase, two legs: ``mixed-1M`` ticks register_bench.py's mixed
   shape (2^17 log rows at W=8 beside 917,504 register rows at W=1) through
   ``paxos_tick_health`` with one fresh request per group per tick, once
   with the lease and health folds on and once with both off, the first
   ticks held against the CPU; ``reads-128k`` runs read_bench.py's 95/5
   closed loop on a durable 2^17 + 2^17 manager with leases and health on
   (local reads), crashes it and recovers it through both replay arms,
   then runs one round with leases off.  Every mixed tick must launch 10
   gathers and 2 matches, and each leg reports the device's idle share
   over a profiled window;
8. device-kv phase: ``device-kv-1M`` runs bench.py's device_kv_1m stage
   (R=3, W=8, P=4, G=2^20, a PUT registered on the device per fresh
   request) through ``models.device_kv.fused_compact``, the first ticks
   held against the CPU, every PUT's response its value, every slot its
   last PUT; ``device-kv-128k`` runs the device-app ``PaxosManager`` at
   stack_bench.py --device's shape under ``propose_bulk_kv``;
   ``baselines-128k`` the unreplicated and lazy baselines with
   ``DenseCounterApp``; ``device-kv-recover`` a durable device-app manager
   crashed and recovered, equal to the drained live one.  Each tick of
   these paths must launch 5 gathers and 1 match;
9. chain phase: ``chain-1M`` ticks 2^20 chains of 3 with one request each
   per tick at the head, the first ticks held against the CPU, every
   request applied once at every replica and committed once at the tail;
   ``chain-128k`` a ``ChainManager`` at G=2^17 with 8,192 busy chains, its
   middle replica down for W/2 ticks, and a durable leg recovered with
   ``recover_chain``; ``chain-cluster`` an
   ``InProcessCluster(coordinator="chain")`` on 2^17-row planes (128
   names).  Each chain tick must launch 1 gather and no match;
10. modeb phase: ``modeb-1M`` runs benchmarks/modeb_scale.py's shape —
   three ``ModeBNode``s on loopback ``Messenger``s, each with its own
   2^20-group state on the card (W=4, P=4, anti-entropy every 32 ticks,
   cut from the benchmark's 256 for the run's time):
   bulk create, the election of every group, a warm and a steady wave
   (frame bytes per node tick), a hot wave on 2^14 groups and a mass
   laggard of 2^16 groups that N2 misses and catches up after
   ``request_sync()``; N0's first ticks held against the CPU, every acked
   commit executed exactly once at every node, the nodes' exec_slot
   equal.  ``modeb-fast`` runs a coordinator failover over ``SimNet`` at
   2^17 rows with 4,096 busy groups, fast re-election off and on (the fast
   leg takes over in 1 tick and is quicker; both counts equal a small run
   on the CPU).  ``modeb-device-128k`` runs three device-app nodes over
   ``SimNet``: 4,096 PUTs a tick for 16 ticks, one forced down the miss
   path; equal KV tables, every acked write read back.
   ``modeb-wal-128k`` makes three loopback nodes of 2^17 groups durable
   (``ModeBLogger`` on the native journal, an fsync a tick, a forced
   checkpoint): a hot wave of 2^14 PUTs, N2 crashed, 2^12 PUTs while it is
   down, its recovery (``recover_modeb`` with a ``PeerCheckpointStreamer``)
   to a replayed state equal to its pre-crash copy field by field, a
   second crash with a flipped byte in its journal and a degraded
   recovery (quarantine, taint, repair), then a ``SimChaosRunner``
   coordinator crash on three durable nodes with real restarts; every
   acked write reads back on every node.  Every node tick, fast
   re-election on or off, live or replayed, must launch 5 gathers and 1
   match;
11. chain Mode B and server phase: ``chain-modeb-128k`` runs the chain
   deployment ``ModeBServer(coordinator="chain")`` builds — three
   ``ChainModeBNode``s on loopback ``Messenger``s with 2^17-row states,
   ``ChainBLogger`` on the native journal (an fsync a tick): 2^12 chains
   created one ``create_group`` a name, a checkpoint, a hot wave of 4
   rounds of PUTs entering at every node (two thirds forwarded to the
   head), 2^12 chains a round, the tail C2 crashed after round 2 (the
   commit point moves to C1; the last two rounds on 2^10 chains),
   recovered with ``recover_chain_modeb`` to its pre-crash state field by
   field, rejoined, repaired by checkpoint transfers and serving; C0's
   first ticks held against the CPU.
   ``server-128k`` boots six ``ModeBServer``s (3 actives, 3
   reconfigurators, 2^17 rows a plane, durable, failure detectors on, the
   scrape endpoint on one active) and drives them through the client:
   8 names in batches, a PUT and a read each (4 serial), 2
   reconfigurations and 2 deletes, the coordinator's server closed (a PUT
   commits once the failure detectors declare it dead) and re-opened from
   its log dir, every name read back, one ``/metrics`` scrape.
   ``server-chain`` does the same with chain-coordinated actives (4
   names).  Every chain node tick, live or replayed, must launch 1 gather
   and no match; every Paxos Mode B node tick of the servers 5 and 1;
12. cells, transaction and capacity phase: ``cells-1M`` starts a
   ``CellSupervisor`` of 4 cells (each a journaled ``InProcessCluster`` of
   3 actives and 1 reconfigurator with 2^18 rows a plane, so the host
   holds 2^20 groups) in 4 worker processes on the card, creates 512
   names through ``sup.make_client()`` with a PUT each, reads every one
   back, moves 8 names to another cell with ``CellMigrator``, SIGKILLs one
   cell during traffic (the supervisor restarts it; its WAL replay must
   give the DB dump taken before the kill and a clean S1 ledger over both
   incarnations), reads every acked write back and takes one host scrape;
   the workers' ``stats`` replies carry their kernel launches, 5 gathers
   and 1 match a plane tick.  ``txn-128k`` runs 2,048 two-name
   ``DistTransactor`` transactions (a quarter contending) over 4,096 names
   of a 2^17-row ``PaxosManager``: every committed one shows on both
   names, every aborted one on neither, no lock is left.
   ``capacity-128k`` walks ``CapacityProbe``'s ladder over 1,024 groups of
   a 2^17-row loopback cluster for at most 30 s;
13. placement and mesh phase: ``placement-128k`` runs manager-128k's
   deployment with ``placement.enabled`` (``sample_every_ticks=1``): the
   demand EWMA folds inside the scripted compact tick, every tick
   launches 5 gathers and 1 match, the sampled demand must equal a host
   fold of the same ticks' intake bit for bit, and the demand tick's
   device ms is timed against the plain compact tick's on the same state
   and load.  ``mesh-1M`` runs tick-1M's shape (R=3, W=8, P=4, G=2^20,
   bench.py's load) through the sharded tick on ``make_mesh([cuda] *
   8)``: eight group shards of 2^17, all on the one card, 8 x (5 + 1)
   launches a tick, every joined outbox and the final state equal to an
   unsharded run of the same inputs on the card; ``mesh-128k-r4`` the
   same at R=4 with 2 replica x 4 group shards (``tests/test_sharding.py``'s
   layout) at G=2^17.  ``mesh-placement-128k`` runs a ``KVApp`` manager on
   that 8-shard mesh with placement on: 32 names born in shard 0, skewed
   traffic, one ``ShardRebalancer.propose`` and one
   ``GroupMigrator.execute_plan``; shard 0's share of the demand must fall
   and every acknowledged write read back.

The kernels phase also holds both kernels against their plain versions at
the narrow widths sparse replay gives them (A=8 groups, W=4), at the
128k deployment's shapes (G=2^17, W=8, P=2) that the manager phase, the
durable manager and its dense replay give them, and at the cluster's two
planes (R=5 and R=3, W=4, P=4, G=2^20), and at the planes phase's shapes
(the W=1 register planes at G=917,504 and G=2^17, the log planes at W=8,
G=2^17, P=1 and P=4), the chain cluster's reconfigurator plane (R=3,
W=4, G=2^17), the chain tick's one gather (three rings over a
per-replica index) at chain-1M, chain-128k, the chain cluster's active
plane and a chain Mode B node (R=3, W=4, G=2^17), a fast re-election
tick's carryover launch (eight ``[W, G]`` arrays) at the Mode B node's
widths, and the cells' two planes (R=3 and R=1, W=4, P=4, G=2^18).

It prints the card, the build, each phase's numbers, the run's total
seconds, one ``{"kernels": ...}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero without that line.  With no CUDA card, or
without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: device-memory bandwidth (bytes/s) by card name (NVIDIA data sheets)
BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
#: int32 compare/select operations/s of an H100 SXM.  The published float32
#: rate outside the tensor cores (67 TFLOP/s) counts an FMA as two
#: operations on 128 FP32 lanes per SM and clock; Hopper has 64 INT32 lanes
#: per SM, each doing one compare or select per clock: 67e12 / 2 / 2.
INT32_OPS = 67e12 / 4


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bandwidth_of(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    return BANDWIDTH[-1][1]


class L2Flush:
    """Empties the card's L2 cache (50 MB on an H100) between timed
    launches, so that an input under 50 MB is read from device memory as it
    is in the tick.  It writes a 256 MB scratch buffer, then reads another,
    which writes the dirty lines back before the timed launch starts."""

    def __init__(self, torch, dev, nbytes: int = 256 << 20):
        self.dirty = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        self.clean = torch.zeros(nbytes, dtype=torch.uint8, device=dev)

    def __call__(self):
        self.dirty.fill_(1)
        self.clean.max()


def time_ms(torch, fn, reps: int, flush=None, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events), with
    ``flush()`` run outside the events before each timed call."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


# ------------------------------------------------------------ kernels phase

class Case:
    """One kernel call: ``arrs`` (the gather's arrays or the match's vals)
    with a shared ``idx`` (and ``keys`` for the match)."""

    def __init__(self, name, label, arrs, idx, keys=None, tick_set=None):
        self.name, self.label, self.tick_set = name, label, tick_set
        self.arrs, self.idx, self.keys = tuple(arrs), idx, keys

    def fused(self, pg):
        if self.name == "gather_planes":
            return pg.gather_planes_many_cuda(self.arrs, self.idx)
        return pg.match_planes_many_cuda(self.arrs, self.keys, self.idx)

    def per_array(self, pg):
        if self.name == "gather_planes":
            return [pg.gather_planes_cuda(a, self.idx) for a in self.arrs]
        return [pg.match_planes_cuda(a, self.keys, self.idx)
                for a in self.arrs]

    def plain(self, pg):
        if self.name == "gather_planes":
            return pg.gather_planes_many_plain(self.arrs, self.idx)
        return pg.match_planes_many_plain(self.arrs, self.keys, self.idx)

    def inputs(self):
        return (*self.arrs, self.idx) + ((self.keys,) if self.keys is not None
                                         else ())


def kernel_cases(torch, dev, R, W, P, G):
    """Seeded inputs at every shape the tick gives the kernels: the
    one-array classes (random indices), then the five gather sets and the
    match set of one tick, each array and index shaped and made as the tick
    makes them (ring indices are rotations ``(base + j) & (W-1)``)."""
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def ints(shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def bools(shape):
        return (torch.rand(shape, generator=gen) < 0.5).to(dev)

    def rotation(base, sign=1):  # [..., G] -> [..., W, G]
        jw = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
        return torch.bitwise_and(sign * jw + base.unsqueeze(-2), W - 1)

    cases = []
    for dtype in ("int32", "bool"):
        mk = ints if dtype == "int32" else bools
        cases.append(Case("gather_planes", f"[{R},{W},G] shared idx {dtype}",
                          [mk((R, W, G))], ints((W, G), 0, W)))
        cases.append(Case("gather_planes", f"[{W},G] lead 1 {dtype}",
                          [mk((W, G))], ints((W, G), 0, W)))
        cases.append(Case("gather_planes", f"[{R},{W},G] per-lead idx {dtype}",
                          [mk((R, W, G))], ints((R, W, G), 0, W)))
    E = R * P
    # intake keys as the tick makes them: ranks of taken entries, -1 holes
    keys = torch.where(bools((E, G)), ints((E, G), 0, E), -1)
    idx = ints((W, G), 0, W)
    cases.append(Case("match_planes", f"[{E},G] int32",
                      [ints((E, G), 1, 2**31 - 1)], idx, keys))
    cases.append(Case("match_planes", f"[{E},G] bool", [bools((E, G))], idx,
                      keys))

    rwg, wg = (R, W, G), (W, G)
    base = ints((G,), 0, 2**30)
    i_j = rotation(base)               # ring index of window offset j
    j_of_i = rotation(-base)           # window offset of ring plane i
    i_own = rotation(ints((R, G), 0, 2**30))
    sets = [
        ("S1", "phase 1", [ints(rwg) for _ in range(4)] + [bools(rwg)], i_j),
        ("S2", "carryover to_ring", [ints(wg), ints(wg), bools(wg),
                                     bools(wg)], j_of_i),
        ("S3", "tally", [ints(rwg) for _ in range(5)]
         + [bools(rwg), bools(rwg)], i_j),
        ("S4", "decisions to_ring", [ints(wg), bools(wg), bools(wg)], j_of_i),
        ("S5", "execution per-lead", [ints(rwg), ints(rwg), bools(rwg),
                                      bools(rwg)], i_own),
    ]
    for tag, what, arrs, ix in sets:
        shape = "x".join(str(d) for d in arrs[0].shape[:-1])
        cases.append(Case("gather_planes",
                          f"{tag} {what} {len(arrs)}x[{shape},G]", arrs, ix,
                          tick_set=tag))
    ji = rotation(-ints((G,), 0, 2**30))
    cases.append(Case("match_planes", f"M intake 2x[{E},G]",
                      [ints((E, G), 1, 2**31 - 1), bools((E, G))], ji, keys,
                      tick_set="M"))
    return cases


def edge_cases(torch, pg, dev):
    """Every kernel path at small sizes against the plain version: ragged G
    (scalar lanes), a contiguous view with a storage offset (unaligned, so
    scalar lanes), indices out of [0, Wp), Wp and J beyond the kernel's
    register chunks, and 1..8 gather arrays (1..4 match arrays) a launch,
    int32 and bool mixed.  Returns the number of calls checked."""
    gen = torch.Generator(device="cpu").manual_seed(99)

    def mk(shape, dtype, lo=-999, hi=999, offset=False):
        src = (torch.randint(0, 2, shape, generator=gen).bool()
               if dtype == torch.bool else
               torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32))
        if offset:
            n = src.numel()
            return torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(
                shape).copy_(src)
        return src.to(dev)

    def same(got, want, what):
        check(len(got) == len(want), f"{what}: output count")
        for a, b in zip(got, want):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"{what}: kernel != plain")

    n = 0
    for g in (1, 3, 130, 4099, 4096):
        for lead, wp, j in (((3,), 8, 8), ((), 12, 8), ((2, 3), 32, 12)):
            for k in range(1, 9):
                dts = [(torch.int32, torch.bool)[(i + k) % 2]
                       for i in range(k)]
                for perlead in (False, True):
                    arrs = [mk(lead + (wp, g), d, offset=i == 0 and g == 4096)
                            for i, d in enumerate(dts)]
                    idx = mk((lead if perlead else ()) + (j, g), torch.int32,
                             -2, wp + 3)
                    same(pg.gather_planes_many_cuda(arrs, idx),
                         pg.gather_planes_many_plain(arrs, idx),
                         f"gather g={g} lead={lead} wp={wp} k={k}")
                    n += 1
        for e, j in ((6, 8), (12, 8), (20, 32)):
            for k in range(1, 5):
                dts = [(torch.int32, torch.bool)[(i + k) % 2]
                       for i in range(k)]
                vals = [mk((e, g), d, offset=i == 0 and g == 4096)
                        for i, d in enumerate(dts)]
                keys = mk((e, g), torch.int32, -1, e // 2)
                idx = mk((j, g), torch.int32, -1, e)
                same(pg.match_planes_many_cuda(vals, keys, idx),
                     pg.match_planes_many_plain(vals, keys, idx),
                     f"match g={g} e={e} k={k}")
                n += 1
    torch.cuda.synchronize()
    return n


def launches_now(pg, path: str, want: dict, placing=None) -> dict:
    """Read the launch counts of one main-path run (set to 0 just before
    it) and hold them to ``want``; with them, as ``scatter_inbox``, its
    inbox scatters: one a one-device Mode A manager tick that places
    anything, so never more than its match launches, and ``placing`` where
    the path counted its placing ticks."""
    got = dict(pg.launches)
    check(got == want, f"{path}: launches {got}, expected {want}")
    n = pg.scatter_launches
    check(n <= want["match_planes"], f"{path}: {n} inbox scatters, more "
          f"than its {want['match_planes']} manager ticks")
    check(placing is None or n == placing,
          f"{path}: {n} inbox scatters, expected {placing} (one a tick "
          "that places)")
    return {**got, "scatter_inbox": n}


def path_launches(pg, path: str, n_ticks: int, planes: int = 1,
                  placing=None) -> dict:
    """The launch check of a Paxos path: every tick of every state plane
    launches 5 gathers (one per set of arrays that share an index) and 1
    match; a mixed tick has two planes."""
    return launches_now(pg, f"{path} phase, {n_ticks} ticks of {planes} "
                        "plane(s)", {"gather_planes": 5 * planes * n_ticks,
                                     "match_planes": planes * n_ticks},
                        placing)


#: (R, W, G, P, label prefix) of the shapes the other paths give the
#: kernels: the recovery-1M-sparse leg's 8 active groups at W=4 (sparse
#: replay), the 128k deployment at P=2 (the manager phase, the durable
#: manager and its dense replay), and the cluster's two 2^20-row planes at
#: the default W=4, P=4 (5 actives, 3 reconfigurators); the 2^17-row W=4
#: P=4 shape is also every live and replayed node tick of modeb-wal-128k
#: and of the servers' Paxos planes (server-128k's actives, every RC plane);
#: placement-128k ticks manager-128k's shape, a mesh-1M shard the reads
#: log plane's [3, 8, 2^17] at P=4, and the R=4 mesh's shards tick their
#: replica-gathered [4, 8, 2^15] blocks
PATH_SHAPES = ((3, 4, 8, 4, "replay A=8 W=4: "),
               (3, 8, 1 << 17, 2, "replay/manager/placement 128k: "),
               (5, 4, 1 << 20, 4, "cluster AR R=5 W=4: "),
               (3, 4, 1 << 20, 4, "cluster RC R=3 W=4: "),
               (3, 8, 1 << 17, 1, "mixed log W=8 P=1: "),
               (3, 1, 917_504, 1, "mixed reg W=1 P=1: "),
               (3, 8, 1 << 17, 4, "reads log 128k P=4, mesh-1M shard: "),
               (4, 8, 1 << 15, 4, "mesh R=4 rs=2 shard tick block: "),
               (3, 1, 1 << 17, 4, "reads reg W=1 128k P=4: "),
               (3, 4, 1 << 17, 4, "chain cluster RC, modeb-wal, its "
                "replay and the servers' planes R=3 W=4 128k: "),
               (3, 4, 1 << 18, 4, "cells AR R=3 W=4 2^18: "),
               (1, 4, 1 << 18, 4, "cells RC R=1 W=4 2^18: "))

#: (R, W, G, label prefix) of the chain tick's one gather launch: its three
#: rings over the per-replica window index, at chain-1M, chain-128k, the
#: chain cluster's active plane (5 actives, the default W=4) and a chain
#: Mode B node (chain-modeb-128k, server-chain's actives: 3 nodes, W=4)
CHAIN_SHAPES = ((3, 8, 1 << 20, "chain 1M: "),
                (3, 8, 1 << 17, "chain 128k: "),
                (5, 4, 1 << 17, "chain cluster AR R=5 W=4: "),
                (3, 4, 1 << 17, "chain Mode B node R=3 W=4 128k: "))


def chain_case(torch, dev, R, W, G, prefix):
    """The chain tick's gather, shaped and made as the tick makes it:
    c_req int32, c_slot int32 and c_stop bool ``[R, W, G]`` over a
    per-replica rotation ``(applied + j) & (W-1)``."""
    gen = torch.Generator(device="cpu").manual_seed(4321 + G + W)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    applied = ints((R, 1, G), 0, 2**30)
    jw = torch.arange(W, dtype=torch.int32, device=dev)[None, :, None]
    i_j = torch.bitwise_and(applied + jw, W - 1)
    arrs = [ints((R, W, G), 0, 2**31 - 1), ints((R, W, G), -1, 2**30),
            (torch.rand((R, W, G), generator=gen) < 0.01).to(dev)]
    return Case("gather_planes", f"{prefix}C chain rings 3x[{R},{W},G] "
                "per-lead", arrs, i_j)


#: (W, G, label prefix) of a fast re-election tick's carryover set on the
#: Mode B paths: modeb-1M (W=4, 2^20), the fast failover leg (W=8, 2^17),
#: and the other widths the node tick takes (W=8 at 2^20, W=4 at 2^17)
FAST_SHAPES = ((4, 1 << 20, "modeb fast W=4 1M: "),
               (8, 1 << 20, "modeb fast W=8 1M: "),
               (4, 1 << 17, "modeb fast W=4 128k: "),
               (8, 1 << 17, "modeb fast W=8 128k: "))


def fast_case(torch, dev, W, G, prefix):
    """A fast tick's carryover launch, shaped and made as the tick makes
    it: the carryover's c_req, c_stop, c_valid and s_j and the adoption
    rule's m_req, m_stop, m_n and m_c, eight ``[W, G]`` arrays over the
    window-to-ring rotation ``j_of_i = (j - base) & (W-1)``."""
    gen = torch.Generator(device="cpu").manual_seed(777 + G + W)

    def ints(lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, (W, G), generator=gen,
                             dtype=torch.int32).to(dev)

    def bools():
        return (torch.rand((W, G), generator=gen) < 0.5).to(dev)

    base = torch.randint(0, 2**30, (G,), generator=gen,
                         dtype=torch.int32).to(dev)
    jw = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    j_of_i = torch.bitwise_and(jw - base[None, :], W - 1)
    arrs = [ints(), bools(), bools(), ints(0, 2**30), ints(), bools(),
            ints(), ints(-1, 64)]
    return Case("gather_planes", f"{prefix}S2f carryover+adoption "
                f"8x[{W},G]", arrs, j_of_i)


def kernels_phase(torch, pg, dev, R, W, P, G, bw):
    flush = L2Flush(torch, dev)
    rows = []
    cases = kernel_cases(torch, dev, R, W, P, G)
    for r, w, g, p, prefix in PATH_SHAPES:
        for c in kernel_cases(torch, dev, r, w, p, g):
            c.label, c.tick_set = prefix + c.label, None
            cases.append(c)
    cases += [chain_case(torch, dev, r, w, g, prefix)
              for r, w, g, prefix in CHAIN_SHAPES]
    cases += [fast_case(torch, dev, w, g, prefix)
              for w, g, prefix in FAST_SHAPES]
    for c in cases:
        what = f"{c.name} {c.label}"
        got = c.fused(pg)
        want = c.plain(pg)
        singles = c.per_array(pg)
        torch.cuda.synchronize()
        err = 0
        for a, b, s1 in zip(got, want, singles):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{what}: dtype/shape differ")
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
            check(torch.equal(a, b), f"{what}: kernel != plain "
                                     f"(max abs err {err})")
            check(torch.equal(s1, b), f"{what}: one-array launch != plain")
        ms = time_ms(torch, lambda: c.fused(pg), reps=25, flush=flush)
        k_ms = time_ms(torch, lambda: c.per_array(pg), reps=25, flush=flush)
        plain_ms = time_ms(torch, lambda: c.plain(pg), reps=5, flush=flush)
        lib_ms = None
        if c.name == "gather_planes":
            idx64 = c.idx.to(torch.int64).expand(
                c.arrs[0].shape[:-2] + c.idx.shape[-2:])
            for a, b in zip(c.arrs, want):
                check(torch.equal(torch.gather(a, -2, idx64), b),
                      f"torch.gather {c.label} differs")
            lib_ms = time_ms(torch, lambda: [torch.gather(a, -2, idx64)
                                             for a in c.arrs],
                             reps=25, flush=flush)
        # each input (the shared index once) read once, each output written
        # once; a compare and a select for each plane (Wp of arr, E of
        # vals) per output element
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*c.inputs(), *got))
        ops = sum(2 * c.arrs[0].shape[-2] * o.numel() for o in got)
        t_bytes, t_ops = nbytes / bw * 1e3, ops / INT32_OPS * 1e3
        bound = max(t_bytes, t_ops)
        rows.append({
            "name": c.name, "case": c.label, "set": c.tick_set,
            "arrays": len(c.arrs), "max_abs_err": err, "ms": ms,
            "k_launch_ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes": nbytes, "bound_ms": bound, "bound_share": bound / ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        print(f"kernel {c.name:13s} {c.label:34s} equal=True err={err} "
              f"ms={ms:.4f} k_launch_ms={k_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={bound:.4f} share={bound / ms:.2f} "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
    rows += scatter_rows(torch, pg, dev, bw, flush)
    del flush
    return rows


#: (placements, label) of the inbox scatter's cases at the one-card cells'
#: inbox: counter open's ~2,800 a tick (90,000 req/s, a ~31 ms turn) and
#: 100,000, the closed cells' window placed at once
SCATTER_CASES = ((2_800, "upload [3,4,2^20] n=2,800: "),
                 (100_000, "upload [3,4,2^20] n=100,000: "))


def scatter_rows(torch, pg, dev, bw, flush, R=3, P=4, G=1 << 20):
    """``gp_scatter_inbox`` against its plain version
    (``scatter_inbox_plain``) into a zeroed ``[R, P, G]`` inbox, exact,
    at each of ``SCATTER_CASES`` (distinct slots, 1% stops), timed beside
    the plain version and the bare library call (``index_put_`` of
    prepared int64 indices and bool stops).  Its byte bound: the 12 bytes
    a placement read and the 5 it scatters."""
    rows = []
    shape, total = (R, P, G), R * P * G
    gen = torch.Generator(device="cpu").manual_seed(2718)
    for n, label in SCATTER_CASES:
        what = f"scatter_inbox {label}"
        idx = torch.randperm(total, generator=gen)[:n].to(torch.int32)
        rid = torch.randint(1, 2**31 - 1, (n,), generator=gen,
                            dtype=torch.int32)
        stop = (torch.rand(n, generator=gen) < 0.01).to(torch.int32)
        idx, rid, stop = idx.to(dev), rid.to(dev), stop.to(dev)
        got = (torch.zeros(shape, dtype=torch.int32, device=dev),
               torch.zeros(shape, dtype=torch.bool, device=dev))
        want = (torch.zeros_like(got[0]), torch.zeros_like(got[1]))
        pg.scatter_inbox_cuda(idx, rid, stop, *got)
        pg.scatter_inbox_plain(idx, rid, stop, *want)
        torch.cuda.synchronize()
        err = int((got[0].to(torch.int64) - want[0].to(torch.int64))
                  .abs().max())
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{what}: kernel != plain (max abs err {err})")
        check(int((got[0] != 0).sum()) == n
              and int(got[1].sum()) == int(stop.sum()),
              f"{what}: not {n} placements")
        i64, on = idx.to(torch.int64), stop != 0

        def library():
            want[0].view(-1).index_put_((i64,), rid)
            want[1].view(-1).index_put_((i64,), on)

        ms = time_ms(torch, lambda: pg.scatter_inbox_cuda(idx, rid, stop,
                                                          *got),
                     reps=25, flush=flush)
        plain_ms = time_ms(torch, lambda: pg.scatter_inbox_plain(
            idx, rid, stop, *want), reps=25, flush=flush)
        lib_ms = time_ms(torch, library, reps=25, flush=flush)
        nbytes = 17 * n
        bound = nbytes / bw * 1e3
        rows.append({
            "name": "scatter_inbox", "case": label, "set": "upload",
            "arrays": 3, "max_abs_err": err, "ms": ms, "k_launch_ms": None,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes,
            "bound_ms": bound, "bound_share": bound / ms, "bound_by": "bytes",
        })
        print(f"kernel scatter_inbox {label:34s} equal=True err={err} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={bound:.6f} share={bound / ms:.4f} "
              f"({nbytes / 1e6:.3f} MB)", flush=True)
    return rows


# --------------------------------------------------------------- tick phase

def load_inbox(torch, pt, R, P, G, base, dev, empty=False):
    """bench.py's load: rid ``base + g`` at entry replica ``g % R``."""
    req = torch.zeros((R, P, G), dtype=torch.int32, device=dev)
    if not empty:
        g = torch.arange(G, dtype=torch.int32, device=dev)
        r = torch.arange(R, dtype=torch.int32, device=dev)
        req[:, 0, :] = torch.where(g[None, :] % R == r[:, None], base + g, 0)
    return pt.TickInbox(req, torch.zeros((R, P, G), dtype=torch.bool,
                                         device=dev),
                        torch.ones(R, dtype=torch.bool, device=dev))


def tick_phase(torch, dev, R, W, P, G, warm, timed, cpu_ticks, exec_budget,
               lag_budget=1024):
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as st

    def fresh(device):
        s = st.init_state(R, G, W, device=device)
        return st.create_groups(s, np.arange(G), np.ones((G, R), bool))

    state = fresh(dev)
    cpu_state = fresh("cpu") if cpu_ticks else None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n_rids = (warm + timed) * G
    taken = np.zeros(n_rids, bool)
    stream_check = StreamCheck(R, G, n_rids)
    lat, decided_timed = [], 0
    tick = 0
    idle = 0
    entry = np.arange(G) % R
    while True:
        loading = tick < warm + timed
        base = 1 + tick * G
        if tick == warm:
            sync()
        t0 = time.perf_counter()
        inbox = load_inbox(torch, pt, R, P, G, base, dev, empty=not loading)
        state, flat = pt.paxos_tick_compact(state, inbox, -1, exec_budget,
                                            lag_budget)
        host = flat.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        co = pt.unpack_compact(host, R, G, exec_budget, lag_budget)
        if warm <= tick < warm + timed:
            decided_timed += co.decided_total
        if loading:
            taken[tick * G:(tick + 1) * G] = \
                (co.taken_bits[entry, np.arange(G)] & 1).astype(bool)
        stream_check.update(co.e_rid, co.e_rep, co.e_row, co.e_slot)
        if tick < cpu_ticks:
            cpu_in = pt.TickInbox(*(t.cpu() for t in inbox))
            cpu_state, cpu_flat = pt.paxos_tick_compact(
                cpu_state, cpu_in, -1, exec_budget, lag_budget)
            check(np.array_equal(cpu_flat.numpy(), host),
                  f"tick {tick}: compact buffer differs from the CPU run")
            for name, a, b in zip(st.PaxosState._fields,
                                  st.state_to_numpy(state),
                                  st.state_to_numpy(cpu_state)):
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"tick {tick}: state.{name} differs from the CPU run")
            if tick == cpu_ticks - 1:
                cpu_state = None
        tick += 1
        if not loading:
            idle = idle + 1 if co.n_exec == 0 and co.decided_total == 0 else 0
            if idle >= 2:
                break
            check(tick < warm + timed + 8 * W, "drain did not finish")
    stream_check.finish(taken)
    # each tick is closed-loop (its outbox is on the host before the next
    # tick starts), so the timed ticks' latencies sum to the phase's time;
    # the host-side checks between ticks are not in it
    timed_lat = np.array(lat[warm:warm + timed]) * 1e3
    t_phase = timed_lat.sum() / 1e3
    return {
        "R": R, "W": W, "P": P, "G": G, "exec_budget": exec_budget,
        "ticks_timed": timed, "ticks_total": tick,
        "ms_per_tick": t_phase / timed * 1e3,
        "dec_per_s": decided_timed / t_phase,
        "tick_latency_p50_ms": float(np.percentile(timed_lat, 50)),
        "tick_latency_p99_ms": float(np.percentile(timed_lat, 99)),
        "taken": int(taken.sum()), "offered": n_rids,
    }


class StreamCheck:
    """Incremental check of the executed streams: per (replica, group) the
    slots run consecutively from 0 and the rids rise with the slot; at the
    end every taken rid was executed exactly once at each replica and no
    other rid was."""

    def __init__(self, R, G, n_rids):
        self.R, self.G, self.n_rids = R, G, n_rids
        self.counts = np.zeros((R, n_rids + 1), np.uint8)
        self.expected = np.zeros(R * G, np.int64)
        self.last_rid = np.zeros(R * G, np.int64)

    def update(self, rid, rep, row, slot):
        n = len(rid)
        if not n:
            return
        rid = rid.astype(np.int64)
        key = rep.astype(np.int64) * self.G + row
        order = np.argsort(key, kind="stable")
        ks, sl, rs = key[order], slot.astype(np.int64)[order], rid[order]
        rank = np.arange(n) - np.searchsorted(ks, ks, "left")
        check(np.array_equal(sl, self.expected[ks] + rank),
              "a replica executed out of slot order")
        real = rs != 0
        prev = np.where(rank == 0, self.last_rid[ks], np.roll(rs, 1))
        check(bool(np.all(rs[real] > prev[real])), "rids do not rise with slot")
        check(bool(np.all(rs <= self.n_rids)), "unknown rid executed")
        self.expected += np.bincount(ks, minlength=self.R * self.G)
        self.last_rid[ks[real]] = rs[real]  # ks sorted: the last write wins
        if not real.any():
            return
        lo, hi = int(rs[real].min()), int(rs[real].max())
        for r in range(self.R):
            sel = (rep[order] == r) & real
            self.counts[r, lo:hi + 1] += np.bincount(
                rs[sel] - lo, minlength=hi - lo + 1).astype(np.uint8)

    def finish(self, taken):
        check(np.array_equal(self.counts[:, 1:],
                             np.broadcast_to(taken, (self.R, self.n_rids))),
              "a taken rid was not executed exactly once at every replica "
              "(or an untaken one was executed)")


# ------------------------------------------------------------ manager phase

def stack_cfg(cfg, R, W, G):
    """benchmarks/stack_bench.py's configuration."""
    cfg.paxos.max_groups = G
    cfg.paxos.window = W
    cfg.paxos.proposals_per_tick = 2
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.exec_budget = R * G + 4096  # steady-state demand + headroom
    cfg.paxos.bulk_capacity = 8 * G
    cfg.paxos.deactivation_ticks = 0
    # the intake governor stays on, with its watermark above the load
    cfg.overload.intake_hi = cfg.paxos.bulk_capacity
    return cfg


def manager_phase(torch, dev, R, W, G, ticks):
    import struct

    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = stack_cfg(GigapaxosTpuConfig(), R, W, G)
    apps = [DenseCounterApp(G) for _ in range(R)]
    m = PaxosManager(cfg, R, apps, spill_ns="smoke", device=dev)
    for a in apps:
        a.row_of = m.rows.row
    check(m.create_paxos_instances([f"g{i}" for i in range(G)],
                                   list(range(R))) == G, "create failed")
    rows = np.array([m.rows.row(f"g{i}") for i in range(G)], np.int64)
    payload = struct.pack("<q", 1)
    acks = []  # per admitted block: (rids, ack counts)

    def sink_for(k):
        def sink(offsets, responses):
            np.add.at(acks[k][1], offsets, 1)
        return sink

    placing = 0  # ticks whose inbox held a placement (one scatter each)

    def placed():
        return bool(m._placed) or m._bulk_placed is not None

    t0 = time.perf_counter()
    admitted = 0
    for t in range(ticks):
        k = len(acks)
        acks.append([None, np.zeros(G, np.int64)])
        rids = m.propose_bulk(rows, payload, batch_sink=sink_for(k))
        acks[k][0] = rids
        admitted += int((rids >= 0).sum())
        m.tick()
        placing += placed()
    m.drain_pipeline()
    elapsed = time.perf_counter() - t0
    decided = m.stats["decisions"]
    phases = host_phases("smoke")
    drain = 0
    while True:
        m.tick()
        placing += placed()
        m.drain_pipeline()
        drain += 1
        if not m.bulk_stats()["queued"] and not m.bulk.n_live:
            break
        check(drain < 64, f"manager drain did not finish: "
                          f"{m.bulk_stats()}")
    per_row = np.zeros(G, np.int64)
    for rids, cnt in acks:
        ok = rids >= 0
        check(bool(np.all(cnt[ok] == 1)) and bool(np.all(cnt[~ok] == 0)),
              "an admitted request was not acked exactly once")
        np.add.at(per_row, rows[ok], 1)
    for a in apps[1:]:
        check(np.array_equal(a.acc, apps[0].acc)
              and np.array_equal(a.count, apps[0].count),
              "replica app states differ")
    check(np.array_equal(apps[0].acc[rows], per_row),
          "app state does not match the acked writes per group")
    return {"G": G, "R": R, "W": W, "ticks": ticks, "drain_ticks": drain,
            "ticks_total": ticks + drain, "placing_ticks": placing,
            "admitted": admitted, "acked": int(per_row.sum()),
            "dec_per_s": decided / elapsed,
            "ms_per_tick": elapsed / ticks * 1e3,
            "host_ms_per_tick_by_phase": phases}


def host_phases(plane: str) -> dict:
    """Mean host milliseconds per tick of each manager phase (the port's
    phase clock, ``obs/phase.py``)."""
    from gigapaxos_tpu_torch.obs.metrics import registry

    out = {}
    for h in registry().find("tick_phase_seconds"):
        labels = dict(h.labels)
        if labels.get("plane") == plane and h.count:
            out[labels["phase"]] = h.total / h.count * 1e3
    return out


def kv_leg(torch, dev, R, W, n_groups=8):
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = 64
    cfg.paxos.window = W
    apps = [KVApp() for _ in range(R)]
    m = PaxosManager(cfg, R, apps, device=dev)
    put, got = {}, {}
    for i in range(n_groups):
        m.create_paxos_instance(f"kv{i}", list(range(R)))
        m.propose(f"kv{i}", f"PUT k v{i}".encode(),
                  lambda rid, resp, i=i: put.__setitem__(i, resp))
    m.run_ticks(4)  # the PUTs are acked before any GET is proposed
    check(put == {i: b"OK" for i in range(n_groups)}, f"KV PUT: {put}")
    for i in range(n_groups):
        m.propose(f"kv{i}", b"GET k",
                  lambda rid, resp, i=i: got.__setitem__(i, resp))
    m.run_ticks(4)
    check(got == {i: f"v{i}".encode() for i in range(n_groups)},
          f"KV GET after PUT: {got}")
    for i in range(n_groups):
        for r in range(R):
            check(apps[r].execute(f"kv{i}", b"GET k", 0) == f"v{i}".encode(),
                  f"replica {r} lost kv{i}")
    return n_groups


# ---------------------------------------------------------------- wal phase

def assert_same_manager(torch, a, b, what):
    """Two managers are equal field by field: device state (the register
    plane and the lease columns too), the host lease mirror, host exec
    watermark, apps, rows, request records, queues, tick and rid
    counters."""
    for plane in ("state", "rstate", "_lease", "_rlease"):
        pa, pb = getattr(a, plane), getattr(b, plane)
        check((pa is None) == (pb is None), f"{what}: {plane} present once")
        for name, x, y in zip(pa._fields if pa is not None else (),
                              pa or (), pb or ()):
            check(x.dtype == y.dtype and torch.equal(x, y.to(x.device)),
                  f"{what}: {plane}.{name} differs")
    check((a._lease_np is None and b._lease_np is None)
          or np.array_equal(a._lease_np, b._lease_np),
          f"{what}: lease mirror differs")
    check(a._lease_clock == b._lease_clock, f"{what}: lease clock differs")
    check(np.array_equal(a._host_exec, b._host_exec),
          f"{what}: host exec watermark differs")
    for r, (x, y) in enumerate(zip(a.apps, b.apps)):
        if hasattr(x, "db"):
            check(x.db == y.db, f"{what}: replica {r} app differs")
        else:
            check(np.array_equal(x.acc, y.acc)
                  and np.array_equal(x.count, y.count),
                  f"{what}: replica {r} app differs")
    check(dict(a.rows.items()) == dict(b.rows.items()),
          f"{what}: rows differ")
    check(sorted(a.outstanding) == sorted(b.outstanding),
          f"{what}: outstanding requests differ")
    qa = {k: list(v) for k, v in a._queues.items() if v}
    qb = {k: list(v) for k, v in b._queues.items() if v}
    check(qa == qb, f"{what}: queues differ")
    check(a.tick_num == b.tick_num and a._next_rid == b._next_rid,
          f"{what}: tick {a.tick_num}/{b.tick_num} rid "
          f"{a._next_rid}/{b._next_rid}")


def timed_recover(torch, pg, dev, cfg, R, apps, log_dir, mode, from_tick,
                  planes=1):
    """``recover`` on the card with the launch counts set to 0 just
    before it; each replayed tick must launch 5 gathers and 1 match per
    state plane.  Returns (manager, seconds, launches)."""
    from gigapaxos_tpu_torch.wal.logger import recover

    pg.reset_launches()
    t0 = time.perf_counter()
    m = recover(cfg, R, apps, log_dir, native=True, replay_mode=mode,
                device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = None
    if dev.type == "cuda":  # the plain versions run on the CPU
        got = path_launches(pg, f"replay ({mode})", m.tick_num - from_tick,
                            planes)
    check(m.wal.backend == "native", "recovery did not open the native "
                                     "journal")
    return m, dt, got


def replay_stats(m):
    return {"windows": m._replay_windows,
            "sparse_windows": m._replay_sparse_windows,
            "overflows": m._replay_overflows}


def checkpoint_stats() -> tuple:
    from gigapaxos_tpu_torch.obs.metrics import registry

    (h,) = registry().find("wal_checkpoint_seconds") or (None,)
    return (h.count, h.total) if h is not None else (0, 0.0)


def journal_bytes(log_dir) -> int:
    return sum(os.path.getsize(p)
               for p in glob.glob(os.path.join(log_dir, "journal.*.log")))


def wal_dense_leg(torch, dev, R, W, G, ticks, work, cpu_ticks=3,
                  manager_ms=None):
    """``wal-128k``: the manager phase's deployment with the port's WAL
    (native journal, fsync every tick, one checkpoint mid-run), crashed by
    closing the WAL with no drain, recovered on the card through the
    batched and the record-at-a-time arms."""
    import struct

    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
    from gigapaxos_tpu_torch.obs.metrics import registry
    from gigapaxos_tpu_torch.ops import plane_gather as pg
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.wal.logger import PaxosLogger

    cfg = stack_cfg(GigapaxosTpuConfig(), R, W, G)
    names = [f"g{i}" for i in range(G)]
    rows = np.arange(G, dtype=np.int64)
    payload = struct.pack("<q", 1)

    def apps():  # group g<i> sits on row i (checked below)
        return [DenseCounterApp(G, row_of=lambda n: int(n[1:]))
                for _ in range(R)]

    def durable(device, log_dir):
        wal = PaxosLogger(log_dir, sync_every_ticks=1,
                          checkpoint_every_ticks=ticks // 2 + 1,
                          native=True)  # one checkpoint, mid-run
        m = PaxosManager(cfg, R, apps(), wal=wal, spill_ns="smoke-wal",
                         device=device)
        check(wal.backend == "native", "the WAL did not open the native "
                                       "journal")
        check(m.create_paxos_instances(names, list(range(R))) == G,
              "create failed")
        return m

    live_dir = os.path.join(work, "live")
    m = durable(dev, live_dir)
    backend = m.wal.backend
    check(all(m.rows.row(n) == i for i, n in enumerate(names)),
          "rows not in creation order")
    appended = registry().counter("wal_appended_bytes_total")
    b0 = appended.value
    c0 = checkpoint_stats()
    acks = np.zeros(G, np.int64)  # acked requests per group

    def sink(offsets, responses):
        # one block per tick over every row in order: offset i is row i
        np.add.at(acks, offsets, 1)

    prefix = None
    admitted = 0
    t0 = time.perf_counter()
    for t in range(ticks):
        rids = m.propose_bulk(rows, payload, batch_sink=sink)
        check(bool((rids >= 0).all()), "bulk admission refused")
        admitted += len(rids)
        m.tick()
        if t == cpu_ticks - 1:  # fsynced: every tick syncs
            with open(os.path.join(live_dir, "journal.00000000.log"),
                      "rb") as f:
                prefix = f.read()
    elapsed = time.perf_counter() - t0
    c1 = checkpoint_stats()
    tick_bytes = appended.value - b0
    phases = host_phases("smoke-wal")
    snaps = glob.glob(os.path.join(live_dir, "snapshot.*.bin"))
    check(len(snaps) == 1 and c1[0] == c0[0] + 1, "expected one checkpoint")
    snap_tick = int(os.path.basename(snaps[0]).split(".")[1])
    snap_mb = os.path.getsize(snaps[0]) / 1e6
    jbytes = journal_bytes(live_dir)
    m.wal.close()  # crash: no drain, the pending outbox is lost
    acked = acks.copy()
    copy_dir = os.path.join(work, "copy")
    shutil.copytree(live_dir, copy_dir)

    mb, t_b, launches = timed_recover(torch, pg, dev, cfg, R, apps(),
                                      copy_dir, "batched", snap_tick)
    check(mb._replay_overflows == 0, "batched replay overflowed")
    mr, t_r, _ = timed_recover(torch, pg, dev, cfg, R, apps(), live_dir,
                               "reference", snap_tick)
    m.drain_pipeline()
    assert_same_manager(torch, mb, mr, "batched vs reference recovery")
    assert_same_manager(torch, m, mb, "drained live vs batched recovery")
    for r in range(R):
        check(bool(np.all(mb.apps[r].count >= acked)),
              f"an acked request is missing at replica {r}")
    check(int(acked.sum()) > 0, "nothing was acked before the crash")

    # the first ticks' journal equals a CPU run of the same inputs
    cpu_dir = os.path.join(work, "cpu")
    mc = durable("cpu", cpu_dir)
    for t in range(cpu_ticks):
        mc.propose_bulk(rows, payload)
        mc.tick()
    mc.wal.close()
    with open(os.path.join(cpu_dir, "journal.00000000.log"), "rb") as f:
        check(f.read() == prefix, f"the first {cpu_ticks} ticks' journal "
                                  "differs from the CPU run")
    ckpt_s = c1[1] - c0[1]
    return {
        "G": G, "R": R, "W": W, "ticks": ticks, "backend": backend,
        "admitted": admitted, "acked": int(acked.sum()),
        "journal_mb_at_crash": jbytes / 1e6,
        "tick_record_mb": tick_bytes / 1e6,
        "bytes_per_request": tick_bytes / admitted,
        "wal_fsync_ms_per_tick": phases.get("wal_fsync"),
        "ms_per_tick": elapsed / ticks * 1e3,
        "ms_per_tick_without_checkpoint": (elapsed - ckpt_s) / ticks * 1e3,
        "manager_phase_ms_per_tick": manager_ms,
        "snapshot_mb": snap_mb, "checkpoint_s": ckpt_s,
        "snapshot_tick": snap_tick, "replayed_ticks": mb.tick_num - snap_tick,
        "replay_s": {"batched": t_b, "reference": t_r},
        "replay": replay_stats(mb), "launches": launches,
        "host_ms_per_tick_by_phase": phases,
    }


def wal_sparse_leg(torch, dev, R, W, G, ticks, work, groups=8):
    """``recovery-1M-sparse``: benchmarks/recovery_bench.py's fast-restart
    shape (W=4, exec budget 8192, ``groups`` busy services with 2-3
    proposals each per tick on a G-group plane), crashed and recovered
    through the sparse batched replay; then one probe PUT is served."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.ops import plane_gather as pg
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.wal.logger import PaxosLogger

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.window = W
    cfg.paxos.compact_outbox = True
    cfg.paxos.exec_budget = 8192
    live_dir = os.path.join(work, "live")
    m = PaxosManager(cfg, R, [KVApp() for _ in range(R)], device=dev,
                     wal=PaxosLogger(live_dir, native=True))
    check(m.wal.backend == "native", "the WAL did not open the native "
                                     "journal")
    for s in range(groups):
        check(m.create_paxos_instance(f"svc{s}", list(range(R))),
              "create failed")
    acked = []
    t0 = time.perf_counter()
    for t in range(ticks):
        for s in range(groups):
            for j in range(2 + (t + s) % 2):
                m.propose(f"svc{s}", f"PUT k{t}.{j} v{s}.{t}.{j}".encode(),
                          lambda rid, resp: acked.append(rid))
        m.tick()
    t_live = time.perf_counter() - t0
    jbytes = journal_bytes(live_dir)
    m.wal.close()  # crash: the journal is the whole state
    copy_dir = os.path.join(work, "copy")
    shutil.copytree(live_dir, copy_dir)

    mb, t_b, launches = timed_recover(torch, pg, dev, cfg, R,
                                      [KVApp() for _ in range(R)],
                                      copy_dir, "batched", 0)
    stats = replay_stats(mb)
    check(stats["sparse_windows"] > 0, f"sparse replay never ran: {stats}")
    check(stats["overflows"] == 0, "batched replay overflowed")
    mr, t_r, _ = timed_recover(torch, pg, dev, cfg, R,
                               [KVApp() for _ in range(R)], live_dir,
                               "reference", 0)
    assert_same_manager(torch, mb, mr, "sparse batched vs reference")
    check(mb.tick_num == ticks, f"replayed {mb.tick_num} of {ticks} ticks")
    # every acked request is in every replica's app (each PUT key once)
    n_keys = sum(len(t) for t in mb.apps[0].db.values())
    for r in range(R):
        check(mb.apps[r].db == mb.apps[0].db, f"replica {r} differs")
    check(n_keys >= len(acked) > 0, f"{len(acked)} acked, {n_keys} present")
    served = []
    t1 = time.perf_counter()
    mb.propose("svc0", b"PUT probe 1", lambda rid, resp: served.append(resp))
    for _ in range(64):
        mb.tick()
        if served:
            break
    t_probe = time.perf_counter() - t1
    check(served == [b"OK"], f"probe not served: {served}")
    check(mb.wal.is_synced(), "probe acked before its fsync")
    return {
        "G": G, "R": R, "W": W, "groups": groups, "ticks": ticks,
        "backend": mb.wal.backend, "acked": len(acked),
        "journal_mb": jbytes / 1e6,
        "live_s": t_live, "replay_s": {"batched": t_b, "reference": t_r},
        "crash_to_first_served_s": t_b + t_probe, "probe_s": t_probe,
        "replay": stats, "launches": launches,
    }


def wal_phase(torch, dev, R, W, manager_ms):
    """Both legs on the card, in a temporary directory removed after."""
    work = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    try:
        # 20 ticks, cut from 30 for the run's time: a checkpoint at tick
        # 11, then 9 replayed ticks in each replay arm
        dense = wal_dense_leg(torch, dev, R, W, 1 << 17, ticks=20,
                              work=os.path.join(work, "dense"),
                              manager_ms=manager_ms)
        sparse = wal_sparse_leg(torch, dev, R, 4, 1 << 20, ticks=16,
                                work=os.path.join(work, "sparse"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dense, sparse


# ------------------------------------------------------------ cluster phase

def cluster_cfg(G):
    """TESTReconfigurationMain's shape (``benchmarks/reconfig_rate.py``,
    ``tests/test_reconfiguration_e2e.py``): 5 actives and 3 reconfigurators
    on loopback ports, ``G`` rows on each plane, the default window,
    proposals per tick and exec budget, the at-scale outbox settings."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = True
    for i in range(5):
        cfg.nodes.actives[f"AR{i}"] = ("127.0.0.1", 0)
    for i in range(3):
        cfg.nodes.reconfigurators[f"RC{i}"] = ("127.0.0.1", 0)
    return cfg


class Responses:
    """Collects the per-request response packets of batched sends."""

    def __init__(self):
        self.got = {}
        self.cv = threading.Condition()

    def __call__(self, p):
        with self.cv:
            self.got[p["rid"]] = p
            self.cv.notify_all()

    def wait(self, rids, timeout_s):
        deadline = time.monotonic() + timeout_s
        with self.cv:
            while not all(r in self.got for r in rids):
                left = deadline - time.monotonic()
                check(left > 0, f"{sum(r not in self.got for r in rids)} "
                                "batched responses never arrived")
                self.cv.wait(left)
            return [self.got.pop(r) for r in rids]


def batch_round(client, items, timeout_s=120.0):
    """``items`` through ``send_request_batch``; the response bodies in
    item order (None where the request was refused)."""
    from gigapaxos_tpu_torch.reconfiguration import packets as pkt

    sink = Responses()
    rids = client.send_request_batch(items, sink)
    return [pkt.b64d(p["response"]) or b"" if p.get("ok") else None
            for p in sink.wait(rids, timeout_s)]


def plane_tick_ms(torch, dev, m, n):
    """Host milliseconds of ``n`` ticks of one plane run back to back with
    its driver held off (manager lock) and the other plane's driver held
    off by the caller, each tick ending in a device sync."""
    out = []
    with m.lock:
        for _ in range(n):
            t0 = time.perf_counter()
            m.tick()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append((time.perf_counter() - t0) * 1e3)
        _drain_pipeline(m)
    return statistics.median(out)


def _drain_pipeline(m):
    """Finish a pipelined manager's pending tick (a chain manager has no
    pipeline)."""
    drain = getattr(m, "drain_pipeline", None)
    if drain is not None:
        drain()


def dns_a(port, name, zone="gp"):
    """One DNS ``A`` query for ``name.zone`` to the edge on ``port``:
    -> (rcode, the answers' IPv4 strings)."""
    import socket
    import struct

    q = struct.pack(">HHHHHH", 0x2a2a, 0x0100, 1, 0, 0, 0)
    for label in f"{name}.{zone}".split("."):
        q += bytes([len(label)]) + label.encode()
    q += b"\x00" + struct.pack(">HH", 1, 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(60)
    try:
        s.sendto(q, ("127.0.0.1", port))
        data, _ = s.recvfrom(512)
    finally:
        s.close()
    flags, an = struct.unpack(">H", data[2:4])[0], data[6:8]
    off = 12
    while data[off]:
        off += 1 + data[off]
    off += 5
    ips = []
    for _ in range(struct.unpack(">H", an)[0]):
        off += 2
        rdlen = struct.unpack(">H", data[off + 8: off + 10])[0]
        off += 10
        ips.append(socket.inet_ntoa(data[off: off + rdlen]))
        off += rdlen
    return flags & 0xF, ips


def edges_leg(client, names, value):
    """``names`` through the DNS edge (one ``A`` query each) and the HTTP
    active-replica edge (a PUT of the value the name already holds, then a
    GET), over ``client``: each DNS answer must be the name's actives'
    addresses, each HTTP answer the client's own response."""
    import urllib.parse
    import urllib.request

    from gigapaxos_tpu_torch.reconfiguration.dns_edge import (
        DnsReconfigurator)
    from gigapaxos_tpu_torch.reconfiguration.http_edge import (
        HttpActiveReplica)

    dns = DnsReconfigurator(client, ("127.0.0.1", 0))
    http = HttpActiveReplica(client, ("127.0.0.1", 0))

    def get(q):
        url = (f"http://127.0.0.1:{http.port}/?"
               + urllib.parse.urlencode(q))
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read().decode())

    dns_ms, http_ms = [], []
    try:
        for n in names:
            t0 = time.perf_counter()
            rcode, ips = dns_a(dns.port, n)
            dns_ms.append((time.perf_counter() - t0) * 1e3)
            want = sorted(client.nodemap(a)[0]
                          for a in client.request_actives(n))
            check(rcode == 0 and sorted(ips) == want,
                  f"DNS {n}: rcode {rcode}, {ips} against {want}")
            t0 = time.perf_counter()
            put = get({"name": n, "qval": "PUT k " + value[n].decode()})
            got = get({"name": n, "qval": "GET k"})
            http_ms.append((time.perf_counter() - t0) * 1e3)
            mine = client.request(n, b"GET k")
            check(put[0] == 200 and put[1].get("RVAL") == "OK",
                  f"HTTP PUT {n}: {put}")
            check(got[0] == 200 and got[1].get("RVAL") == mine.decode()
                  == value[n].decode(), f"HTTP GET {n}: {got}, client "
                                        f"{mine!r}")
    finally:
        dns.close()
        http.close()
    return {"names": len(names), "dns_p50_ms": statistics.median(dns_ms),
            "http_put_get_p50_ms": statistics.median(http_ms)}


def cluster_phase(torch, pg, dev, G, n_names=4096, create_batch=256,
                  put_batch=512, serial=256, n_reconf=16, n_delete=16,
                  coordinator="paxos", edges=0):
    """The port's ``InProcessCluster`` driven through its client: create
    ``n_names`` names, PUT one value each, read every one back (all through
    batches, ``serial`` of them one at a time for latency), reconfigure
    ``n_reconf`` onto a rotated 3-of-5 active set, delete ``n_delete``, read
    the survivors back again and hold every member's app state equal.
    ``coordinator="chain"`` puts the names on chains (the active plane is
    a ``ChainManager``, whose tick launches one gather and no match).
    ``edges`` names also go through the DNS and HTTP edges
    (:func:`edges_leg`) after the serial reads.  A
    chain manager has no bulk admission (neither package's has), so its
    PUTs and reads go one request at a time."""
    from gigapaxos_tpu_torch.client import ClientError, ReconfigurableAppClient
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.node import InProcessCluster

    names = [f"svc{i}" for i in range(n_names)]
    value = {n: f"{n}-v1".encode() for n in names}
    batched = coordinator != "chain"

    def send(client, items):
        if batched:
            return batch_round(client, items)
        return [client.request(n, body, timeout=120) for n, body in items]

    out = {"G": G, "actives": 5, "reconfigurators": 3, "names": n_names,
           "coordinator": coordinator}
    pg.reset_launches()
    t_start = time.perf_counter()
    cl = InProcessCluster(cluster_cfg(G), KVApp, coordinator=coordinator,
                          device=dev)
    client = ReconfigurableAppClient(cl.cfg.nodes)
    try:
        out["start_s"] = time.perf_counter() - t_start
        for m in (cl.manager, cl.rc_manager):
            for f, t in zip(m.state._fields, m.state):
                check(t.device.type == dev.type,
                      f"state.{f} of a plane is on {t.device}")
        t0 = time.perf_counter()
        for k in range(0, n_names, create_batch):
            resp = client.create_batch(names[k:k + create_batch],
                                       timeout=120)
            check(resp["ok"], f"create batch at {k} failed: "
                              f"{str(resp)[:300]}")
        out["names_per_s"] = n_names / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        refused = []
        for k in range(0, n_names, put_batch):
            chunk = names[k:k + put_batch]
            got = send(client, [(n, b"PUT k " + value[n]) for n in chunk])
            refused += [n for n, r in zip(chunk, got) if r != b"OK"]
        out["put_req_per_s"] = n_names / (time.perf_counter() - t0)
        out["put_refused_in_batches"] = len(refused)
        for n in refused:  # a refused PUT is retried until acked
            check(client.request(n, b"PUT k " + value[n]) == b"OK",
                  f"PUT {n} not acked")

        def read_back(which, what):
            for k in range(0, len(which), put_batch):
                chunk = which[k:k + put_batch]
                got = send(client, [(n, b"GET k") for n in chunk])
                for n, r in zip(chunk, got):
                    check(r == value[n], f"{what}: GET {n} gave {r!r}")

        t0 = time.perf_counter()
        read_back(names, "read back")
        out["get_req_per_s"] = n_names / (time.perf_counter() - t0)
        lat = []
        for n in names[:serial]:
            t0 = time.perf_counter()
            r = client.request(n, b"GET k")
            lat.append((time.perf_counter() - t0) * 1e3)
            check(r == value[n], f"serial GET {n} gave {r!r}")
        out["serial_requests"] = serial
        out["serial_p50_ms"] = float(np.percentile(lat, 50))
        out["serial_p99_ms"] = float(np.percentile(lat, 99))
        if edges:
            out["edges"] = edges_leg(client, names[:edges], value)

        pool = sorted(cl.cfg.nodes.active_ids())
        secs = []
        for n in names[:n_reconf]:
            cur = sorted(client.request_actives(n))
            i = pool.index(cur[0])
            new = sorted(pool[(i + 1 + j) % len(pool)] for j in range(3))
            check(new != cur, f"rotation of {n} is its current set")
            t0 = time.perf_counter()
            resp = client.reconfigure(n, new, timeout=120)
            secs.append(time.perf_counter() - t0)
            check(resp["ok"], f"reconfigure {n} failed: {resp}")
            check(sorted(client.request_actives(n, force=True)) == new,
                  f"{n} is not on {new} after its reconfiguration")
        out["reconfigurations"] = n_reconf
        out["s_per_reconfiguration"] = statistics.mean(secs)

        gone = names[n_reconf:n_reconf + n_delete]
        for n in gone:
            check(client.delete(n, timeout=120)["ok"], f"delete {n} failed")
            try:
                client.request_actives(n, force=True)
                check(False, f"deleted {n} still resolves")
            except ClientError:
                pass
        out["deletes"] = n_delete
        live = [n for n in names if n not in set(gone)]
        read_back(live, "read back after reconfigurations and deletes")

        # every member executes what its group decided: poll until the
        # pipelined planes have completed their last ticks
        rdb = cl.reconfigurators["RC0"].db
        deadline = time.monotonic() + 60
        while True:
            with cl.manager.lock:
                _drain_pipeline(cl.manager)
                moved, differ = 0, []
                for n in live:
                    rec = rdb.get(n)
                    moved += rec.epoch
                    want = json.dumps({"k": value[n].decode()}).encode()
                    differ += [(n, node) for node in rec.actives
                               if cl.manager.apps[cl.coordinator.slot_of(
                                   node)].checkpoint(f"{n}#{rec.epoch}")
                               != want]
            if not differ or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        check(not differ, f"app states differ at {differ[:8]}")
        check(moved == n_reconf, f"{moved} epochs advanced, "
                                 f"{n_reconf} reconfigured")
        for drv in (cl.driver, cl.rc_driver):
            check(drv._thread.is_alive() and drv.fatal is None,
                  f"a tick driver stopped: {drv.fatal}")
        # each plane's own tick, the other held off
        with cl.rc_manager.lock:
            out["ar_tick_ms_alone"] = plane_tick_ms(torch, dev, cl.manager, 10)
        with cl.manager.lock:
            out["rc_tick_ms_alone"] = plane_tick_ms(torch, dev,
                                                    cl.rc_manager, 10)
    finally:
        client.close()
        cl.close()
    elapsed = time.perf_counter() - t_start
    ticks = {"ar": cl.manager.tick_num, "rc": cl.rc_manager.tick_num}
    out["ticks"] = ticks
    out["seconds"] = elapsed
    for plane in ("ar", "rc"):
        out[f"{plane}_ms_per_tick"] = elapsed / ticks[plane] * 1e3
        out[f"{plane}_host_phases"] = host_phases(plane)
    ar_dev = ticks["ar"] * out["ar_tick_ms_alone"]
    rc_dev = ticks["rc"] * out["rc_tick_ms_alone"]
    out["rc_share_of_tick_time"] = rc_dev / (ar_dev + rc_dev)
    out["launches"] = None
    if dev.type == "cuda" and coordinator == "chain":
        # a chain tick launches one gather; the RC plane's Paxos tick 5 + 1
        out["launches"] = launches_now(
            pg, "chain cluster", {"gather_planes": ticks["ar"]
                                  + 5 * ticks["rc"],
                                  "match_planes": ticks["rc"]})
    elif dev.type == "cuda":  # the plain versions run on the CPU
        out["launches"] = path_launches(pg, "cluster",
                                        ticks["ar"] + ticks["rc"])
    return out


# ------------------------------------------------------------- planes phase

#: benchmarks/register_bench.py's dec_per_s_1m_mixed shape: 2^17 log rows
#: at W=8 beside 917,504 register rows (W=1), 2^20 groups in all
MIXED_LOG, MIXED_REG = 1 << 17, 917_504
#: leases 64/8 (read_bench.py), health top-K 8 and wedge 32 (the defaults)
LEASE_TICKS, LEASE_MARGIN, HEALTH_TOPK, HEALTH_WEDGE = 64, 8, 8, 32


def _dev_ms(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) / 1e3


def idle_window(torch, dev, fn, n_top=12):
    """Run ``fn`` under the profiler, device activity only (the kernel and
    copy records: host-op records would slow the host side of the window
    they measure); the device's busy time is the sum of its records.
    Returns ``(fn's result, wall s, device-busy s, idle share, top device
    ops)``; busy, idle and top are None when the profiler recorded no
    device time, and on the CPU, where ``fn`` runs unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None, None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and _dev_ms(e) > 0),
                    key=_dev_ms, reverse=True)
    busy = sum(_dev_ms(e) for e in events) / 1e3
    if busy <= 0:
        return out, wall, None, None, None
    top = [{"name": e.key[:72], "calls": e.count, "ms": _dev_ms(e)}
           for e in events[:n_top]]
    top.append({"name": "all kernels (no copies)", "calls": sum(
        e.count for e in events if not e.key.startswith("Memcpy")),
                "ms": sum(_dev_ms(e) for e in events
                          if not e.key.startswith("Memcpy"))})
    return out, wall, busy, 1 - busy / wall, top


def mixed_planes(pt, st, R, GL, GR, device, folds):
    """Both planes fully created, with the lease and health columns when
    ``folds``: the six state arguments of ``paxos_tick_health``."""
    s = st.create_groups(st.init_state(R, GL, 8, device=device),
                         np.arange(GL), np.ones((GL, R), bool))
    r = st.create_groups(st.init_state(R, GR, 1, device=device),
                         np.arange(GR), np.ones((GR, R), bool))
    if not folds:
        return [s, r, None, None, None, None]
    return [s, r, pt.init_lease(GL, LEASE_MARGIN, device),
            pt.init_lease(GR, LEASE_MARGIN, device),
            pt.init_health(GL, device), pt.init_health(GR, device)]


def _same_planes(torch, a, b, what):
    for i, (pa, pb) in enumerate(zip(a, b)):
        if pa is None:
            check(pb is None, f"{what}: plane {i} present once")
            continue
        for name, x, y in zip(pa._fields, pa, pb):
            check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()),
                  f"{what}: plane {i} field {name} differs")


def mixed_leg(torch, pg, dev, folds, GL=MIXED_LOG, GR=MIXED_REG, warm=3,
              timed=30, profiled=10, cpu_ticks=3):
    """``mixed-1M``: both planes through ``paxos_tick_health`` (compact
    outboxes, exec budget R*G_total+4096) under register_bench.py's load,
    one fresh request per composite group per tick entered at replica
    ``g % 3``; leases and health on when ``folds``.  Each tick is closed
    loop: its compact buffers, lease packs and health packs are on the
    host before the next one starts; the host-side checks between ticks
    are not in the tick's time.  The first ``cpu_ticks`` ticks are held
    against the CPU's plain path (``torch.equal``) and every executed
    stream is checked.  The timed window is followed by ``profiled`` more
    loaded ticks under the profiler for the device's idle share, their
    checks deferred until the profiler stops."""
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as st

    R, P, GT = 3, 1, GL + GR
    E, LB = R * GT + 4096, 1024
    planes = mixed_planes(pt, st, R, GL, GR, dev, folds)
    cpu = mixed_planes(pt, st, R, GL, GR, "cpu", folds) if cpu_ticks else None
    loaded = warm + timed + profiled
    n_rids = loaded * GT
    taken = np.zeros(n_rids, bool)
    stream = StreamCheck(R, GT, n_rids)
    entry, cols = np.arange(GT) % R, np.arange(GT)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lat, decided, tick, idle = [], [0, 0], 0, 0
    wedged_seen = lease_holders = 0

    def step(planes, inbox):
        res = pt.paxos_tick_health(*planes, inbox, -1, E, LB, LEASE_TICKS,
                                   True, HEALTH_WEDGE, 6, HEALTH_TOPK)
        return list(res[:6]), list(res[6:])

    def one_tick(planes, tick):
        loading = tick < loaded
        t0 = time.perf_counter()
        inbox = load_inbox(torch, pt, R, P, GT, 1 + tick * GT, dev,
                           empty=not loading)
        planes, outs = step(planes, inbox)
        host = [None if o is None else o.cpu().numpy() for o in outs]
        lat.append(time.perf_counter() - t0)
        return planes, inbox, outs, host

    def window(planes, tick, n, deferred=None):
        for _ in range(n):
            planes, _, _, host = one_tick(planes, tick)
            if deferred is None:
                consume(host, tick)
            else:
                deferred.append((host, tick))
            tick += 1
        return planes, tick

    def consume(host, tick):
        nonlocal wedged_seen, lease_holders
        check(int(host[0][0]) <= E and int(host[1][0]) <= E,
              "a plane's executions overflowed the exec budget")
        co = pt.merge_compact_outbox(
            pt.unpack_compact(host[0], R, GL, E, LB),
            pt.unpack_compact(host[1], R, GR, E, LB), GL)
        if warm <= tick < warm + timed:
            decided[0] += co.decided_total
        decided[1] += co.decided_total
        if tick < loaded:
            taken[tick * GT:(tick + 1) * GT] = \
                (co.taken_bits[entry, cols] & 1).astype(bool)
        stream.update(co.e_rid, co.e_rep, co.e_row, co.e_slot)
        if folds:
            lp = np.concatenate([host[2], host[3]], axis=1)
            lease_holders = int((lp[pt.LP_HOLDER] >= 0).sum())
            hv = pt.merge_health(pt.unpack_health(host[4], HEALTH_TOPK),
                                 pt.unpack_health(host[5], HEALTH_TOPK),
                                 GL, HEALTH_TOPK)
            check(hv.alloc == GT, f"health: {hv.alloc} allocated of {GT}")
            wedged_seen = max(wedged_seen, hv.wedged)

    pg.reset_launches()
    for tick in range(warm):
        planes, inbox, outs, host = one_tick(planes, tick)
        consume(host, tick)
        if tick < cpu_ticks:
            cin = pt.TickInbox(*(t.cpu() for t in inbox))
            cpu, couts = step(cpu, cin)
            _same_planes(torch, planes, cpu, f"mixed tick {tick} vs CPU")
            for i, (o, c) in enumerate(zip(outs, couts)):
                check((o is None) == (c is None)
                      and (o is None or torch.equal(o.cpu(), c)),
                      f"mixed tick {tick}: output {i} differs from the CPU")
    cpu = None
    tick = warm
    sync()
    planes, tick = window(planes, tick, timed)
    deferred = []
    (planes, tick), wall, busy, idle_share, top = idle_window(
        torch, dev, lambda: window(planes, tick, profiled, deferred))
    for host, t in deferred:
        consume(host, t)
    del deferred
    while True:
        planes, _, _, host = one_tick(planes, tick)
        consume(host, tick)
        co_idle = (int(host[0][0]) + int(host[1][0]) == 0
                   and int(host[0][1]) + int(host[1][1]) == 0)
        tick += 1
        idle = idle + 1 if co_idle else 0
        if idle >= 2:
            break
        check(tick < loaded + 64, "mixed drain did not finish")
    stream.finish(taken)
    launches = None
    if dev.type == "cuda":  # the CPU's plain path launches nothing
        launches = path_launches(pg, "mixed", tick, planes=2)
    timed_lat = np.array(lat[warm:warm + timed]) * 1e3
    t_timed = timed_lat.sum() / 1e3
    out = {
        "folds": "lease+health" if folds else "off",
        "G_log": GL, "W_log": 8, "G_reg": GR, "W_reg": 1, "R": R, "P": P,
        "exec_budget": E, "ticks_timed": timed, "ticks_total": tick,
        "ms_per_tick": t_timed / timed * 1e3,
        "dec_per_s": decided[0] / t_timed,
        "tick_latency_p50_ms": float(np.percentile(timed_lat, 50)),
        "tick_latency_p99_ms": float(np.percentile(timed_lat, 99)),
        "taken": int(taken.sum()), "offered": n_rids,
        "profiled_ticks": profiled,
        "profiled_ms_per_tick": wall / profiled * 1e3,
        "device_busy_ms_per_tick": (None if busy is None
                                    else busy / profiled * 1e3),
        "device_idle_share": idle_share,
        # the device's busy time a tick against the unprofiled tick time
        "device_idle_share_vs_timed": (
            None if busy is None
            else 1 - busy / profiled / (t_timed / timed)),
        "top_device_ops": top, "launches": launches,
    }
    if folds:
        out["lease_holders"] = lease_holders
        out["health_wedged_max"] = wedged_seen
        check(lease_holders == GT, f"{lease_holders} of {GT} groups hold "
                                   "a lease")
    return out


def reads_cfg(G, leases, n_reg):
    """read_bench.py's shape (2^17 log groups, W=8, compact outbox, leases
    64/8) with the register plane fully allocated and the health fold on."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig

    cfg = GigapaxosTpuConfig()
    p = cfg.paxos
    p.max_groups, p.window, p.compact_outbox = G, 8, True
    p.register_groups = n_reg
    p.read_leases = leases
    p.lease_ticks, p.lease_margin_ticks = LEASE_TICKS, LEASE_MARGIN
    p.group_health = True
    p.health_topk, p.health_wedge_ticks = HEALTH_TOPK, HEALTH_WEDGE
    return cfg


def reads_manager(dev, G, leases, log_dir, n_reg, hot_reg, spill_ns):
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.wal.logger import PaxosLogger

    cfg = reads_cfg(G, leases, n_reg)
    wal = PaxosLogger(log_dir, sync_every_ticks=1,
                      checkpoint_every_ticks=1 << 30, native=True)
    m = PaxosManager(cfg, 3, [KVApp() for _ in range(3)], wal=wal,
                     spill_ns=spill_ns, device=dev)
    check(wal.backend == "native", "the WAL did not open the native journal")
    names = [f"g{i}" for i in range(G)]
    for i in range(0, G, 8192):
        m.create_paxos_instances(names[i:i + 8192], [0, 1, 2])
    regs = [f"r{i}" for i in range(hot_reg)]
    for n in regs:  # register groups are created one at a time
        check(m.create_paxos_instance(n, [0, 1, 2], register=True),
              f"register create {n} failed")
    return cfg, m, names, regs


def _drive(m, pending, what, max_ticks=20000):
    ticks = 0
    while pending[0] > 0:
        m.tick()
        m.drain_pipeline()
        ticks += 1
        check(ticks < max_ticks, f"{what}: {pending[0]} ops never completed")
    return ticks


def reads_round(m, hot, ops, seed, acked, wseq):
    """read_bench.py's 95/5 closed loop: ``ops`` operations over the hot
    set (every 20th a write of a unique key), then ticks until every
    callback fired.  Acked writes land in ``acked``."""
    rng = np.random.default_rng(seed)
    lat, pending = [], [0]
    reads = writes = 0
    local0 = m.stats["local_reads"]
    t0 = time.perf_counter()
    gidx = rng.integers(0, len(hot), size=ops)
    for i in range(ops):
        name = hot[int(gidx[i])]
        pending[0] += 1
        if i % 20 == 0:
            writes += 1
            k, v = f"w{wseq[0]}", str(wseq[0])
            wseq[0] += 1

            def wcb(r, resp, _n=name, _k=k, _v=v):
                pending[0] -= 1
                if resp == b"OK":
                    acked[(_n, _k)] = _v
            m.propose(name, f"PUT {k} {v}".encode(), wcb)
        else:
            reads += 1
            ts = time.perf_counter()

            def rcb(r, resp, _ts=ts):
                pending[0] -= 1
                lat.append(time.perf_counter() - _ts)
                check(resp is not None, "a read failed")
            m.read(name, b"GET k", rcb)
    ticks = _drive(m, pending, "reads round")
    dt = time.perf_counter() - t0
    lat_ms = np.array(lat) * 1e3
    local = int(m.stats["local_reads"] - local0)
    return {"ops": reads + writes, "reads": reads, "writes": writes,
            "ticks": ticks, "seconds": dt, "ops_per_s": (reads + writes) / dt,
            "local_reads": local, "local_read_fraction": local / reads,
            "read_p50_ms": float(np.percentile(lat_ms, 50)),
            "read_p99_ms": float(np.percentile(lat_ms, 99))}


def reads_warm(m, hot):
    """One committed write per hot group, then a tick for the leases."""
    pending = [0]
    for n in hot:
        pending[0] += 1
        m.propose(n, b"PUT k 0",
                  lambda r, resp: pending.__setitem__(0, pending[0] - 1))
    _drive(m, pending, "warm")
    m.tick()
    m.drain_pipeline()


def reads_leg(torch, pg, dev, work, G=1 << 17, hot_log=128, hot_reg=128,
              ops=1 << 15, rounds=2, probe=4096):
    """``reads-128k``: read_bench.py's 95/5 closed loop on a hot set of
    ``hot_log`` log + ``hot_reg`` register groups of a G + G plane, leases
    on, durable (native journal, fsync every tick, one checkpoint after the
    first round); the last round runs under the profiler for the device's
    idle share.  Then a uniform local-read probe over every log group, a
    crash with no drain, recovery through both replay arms held against
    each other and against the drained live manager, every acked write
    read back at every replica, and one round with leases off on a fresh
    manager."""
    out = {"G_log": G, "G_reg": G, "hot_log": hot_log, "hot_reg": hot_reg,
           "ops_per_round": ops, "rounds": rounds}
    live_dir = os.path.join(work, "live")
    pg.reset_launches()
    t0 = time.perf_counter()
    cfg, m, names, regs = reads_manager(dev, G, True, live_dir, G, hot_reg,
                                        "smoke-reads")
    out["build_s"] = time.perf_counter() - t0
    hot = names[:hot_log] + regs
    reads_warm(m, hot)
    acked, wseq, legs = {}, [0], []
    snap_tick = None
    for k in range(rounds):
        if k == rounds - 1:
            res, wall, busy, idle, top = idle_window(
                torch, dev,
                lambda: reads_round(m, hot, ops, k, acked, wseq))
            res["device_idle_share"] = idle
            res["device_busy_s"] = busy
            res["top_device_ops"] = top
        else:
            res = reads_round(m, hot, ops, k, acked, wseq)
        legs.append(res)
        if k == 0:  # one checkpoint mid-run
            m.drain_pipeline()
            m.wal.checkpoint()
            snap_tick = m.tick_num
    out["leases"] = legs
    secs = sum(r["seconds"] for r in legs)
    out["leases_ops_per_s"] = sum(r["ops"] for r in legs) / secs
    # uniform probe: every created log group elected and holds a lease
    rng = np.random.default_rng(7)
    local0, pending = m.stats["local_reads"], [0]
    for i in rng.integers(0, G, size=probe):
        pending[0] += 1
        m.read(names[int(i)], b"GET k",
               lambda r, resp: pending.__setitem__(0, pending[0] - 1))
    _drive(m, pending, "uniform probe")
    out["uniform_probe_local_fraction"] = (
        (m.stats["local_reads"] - local0) / probe)
    out["host_ms_per_tick_by_phase"] = host_phases("smoke-reads")
    out["ticks"] = m.tick_num
    launches = None
    if dev.type == "cuda":
        launches = path_launches(pg, "reads", m.tick_num, planes=2)
    check(len(acked) > 0, "no write was acked")
    check(legs[-1]["local_read_fraction"] > 0.5,
          f"reads were not served locally: {legs[-1]}")
    m.wal.close()  # crash: no drain
    copy_dir = os.path.join(work, "copy")
    shutil.copytree(live_dir, copy_dir)

    def apps():
        from gigapaxos_tpu_torch.models.replicable import KVApp
        return [KVApp() for _ in range(3)]

    mb, t_b, rl = timed_recover(torch, pg, dev, cfg, 3, apps(), copy_dir,
                                "batched", snap_tick, planes=2)
    mr, t_r, _ = timed_recover(torch, pg, dev, cfg, 3, apps(), live_dir,
                               "reference", snap_tick, planes=2)
    check(mb._replay_sparse_windows == 0,
          "a lease run replayed a sparse window")
    m.drain_pipeline()
    # a local read leaves no journal record; KVApp's GET of a group never
    # written (the probe's) adds an empty table, which replay cannot see
    for a in m.apps:
        for n in [n for n, t in a.db.items() if not t]:
            del a.db[n]
    assert_same_manager(torch, mb, mr, "reads: batched vs reference")
    assert_same_manager(torch, m, mb, "reads: drained live vs batched")
    for (name, k), v in acked.items():
        for r in range(3):
            check(mb.apps[r].execute(name, f"GET {k}".encode(), 0)
                  == v.encode(), f"acked {name} {k} lost at replica {r}")
    out["acked_writes"] = len(acked)
    out["replay_s"] = {"batched": t_b, "reference": t_r}
    out["replayed_ticks"] = mb.tick_num - snap_tick
    out["replay"] = replay_stats(mb)
    out["replay_launches"] = rl
    del m, mb, mr

    # the same round with leases off (every read a consensus round)
    pg.reset_launches()
    _, m0, names0, regs0 = reads_manager(dev, G, False,
                                         os.path.join(work, "off"), G,
                                         hot_reg, "smoke-reads-off")
    hot0 = names0[:hot_log] + regs0
    reads_warm(m0, hot0)
    out["leases_off"] = reads_round(m0, hot0, ops, 0, {}, [0])
    check(out["leases_off"]["local_reads"] == 0, "a local read without "
                                                 "leases")
    if dev.type == "cuda":
        got = path_launches(pg, "reads (leases off)", m0.tick_num, planes=2)
        launches = {k: launches[k] + got[k] for k in launches}
    m0.wal.close()
    out["launches"] = launches
    return out


def planes_phase(torch, pg, dev):
    """Both legs; the mixed arms in turns (on, then off: cut from on, off,
    off, on for the run's time) so the two are compared within one call,
    the CPU check in each; the reads leg in a temporary directory removed
    after."""
    mixed = [mixed_leg(torch, pg, dev, folds, cpu_ticks=3)
             for folds in (True, False)]
    work = tempfile.mkdtemp(prefix="chip_smoke_reads_")
    try:
        reads = reads_leg(torch, pg, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return mixed, reads


# --------------------------------------------------------- device-kv phase

def device_kv_1m_leg(torch, pg, dev, R, W, P, G, warm=3, timed=30,
                     cpu_ticks=3, slots=8):
    """``device-kv-1M``: bench.py's device_kv_1m stage (``bench.py:182-200``)
    through the port's ``fused_compact``: every tick registers, on the
    device, a PUT ``key=(g & 7)+1, val=rid`` for each of its G fresh rids
    (one per group at entry replica ``g % R``), then ticks, executes the
    store and compacts (exec budget R*G+4096) in one call.  Closed loop:
    each tick's buffer is on the host before the next starts.  The first
    ``cpu_ticks`` ticks are held against the same ticks on the CPU
    (``torch.equal`` on state, store, table and buffer); every executed
    stream is checked, every PUT's response is its value, no descriptor
    misses, and at the end each (replica, group)'s slot holds the rid of
    the last PUT it executed."""
    from gigapaxos_tpu_torch.models import device_kv as dk
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as st

    E, LB = R * G + 4096, 1024
    L = pt.CompactLayout(R, G, E, LB)
    table = 1 << max(16, (4 * G - 1).bit_length())

    def fresh(device):
        s = st.create_groups(st.init_state(R, G, W, device=device),
                             np.arange(G), np.ones((G, R), bool))
        return s, dk.init_kv(R, G, slots, table, device=device)

    state, kv = fresh(dev)
    cpu = list(fresh("cpu")) if cpu_ticks else None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = torch.arange(G, dtype=torch.int32, device=dev)
    keys = torch.bitwise_and(g, slots - 1) + 1
    ops = torch.full((G,), dk.OP_PUT, dtype=torch.int32, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    n_rids = (warm + timed) * G
    taken = np.zeros(n_rids, bool)
    stream = StreamCheck(R, G, n_rids)
    entry = np.arange(G) % R
    lat, copy, decided, tick, idle = [], [], 0, 0, 0
    pg.reset_launches()
    while True:
        loading = tick < warm + timed
        base = 1 + tick * G
        if tick == warm:
            sync()
        t0 = time.perf_counter()
        inbox = load_inbox(torch, pt, R, P, G, base, dev, empty=not loading)
        reg = ((base + g, ops, keys, base + g) if loading
               else (none, none, none, none))
        state, kv, flat = dk.fused_compact(state, kv, inbox, *reg, -1, E, LB)
        sync()
        t1 = time.perf_counter()
        host = flat.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        copy.append(time.perf_counter() - t1)
        co = pt.unpack_compact(host, R, G, E, LB)
        e_resp, e_miss = L.kv_extras(host)
        n = co.n_exec
        check(not e_miss[:n].any(), f"tick {tick}: descriptor misses")
        real = co.e_rid[:n] != 0
        check(np.array_equal(e_resp[:n][real], co.e_rid[:n][real]),
              f"tick {tick}: a PUT's response is not its value")
        if warm <= tick < warm + timed:
            decided += co.decided_total
        if loading:
            taken[tick * G:(tick + 1) * G] = \
                (co.taken_bits[entry, np.arange(G)] & 1).astype(bool)
        stream.update(co.e_rid, co.e_rep, co.e_row, co.e_slot)
        if tick < cpu_ticks:
            cpu[0], cpu[1], cflat = dk.fused_compact(
                cpu[0], cpu[1], pt.TickInbox(*(t.cpu() for t in inbox)),
                *(t.cpu() for t in reg), -1, E, LB)
            check(np.array_equal(cflat.numpy(), host),
                  f"device-kv tick {tick}: buffer differs from the CPU run")
            _same_planes(torch, [state, kv], cpu,
                         f"device-kv tick {tick} vs the CPU run")
            if tick == cpu_ticks - 1:
                cpu = None
        tick += 1
        if not loading:
            idle = idle + 1 if co.n_exec == 0 and co.decided_total == 0 else 0
            if idle >= 2:
                break
            check(tick < warm + timed + 8 * W, "drain did not finish")
    launches = None
    if dev.type == "cuda":  # the plain versions run on the CPU
        launches = path_launches(pg, "device-kv-1M", tick)
    stream.finish(taken)
    # each (replica, group)'s slot holds its last executed PUT's rid
    last = stream.last_rid.reshape(R, G)
    slot = (np.arange(G) & (slots - 1)) + 1 & (slots - 1)
    kh = kv.key.cpu().numpy()
    vh = kv.val.cpu().numpy()
    rr, gg = np.meshgrid(np.arange(R), np.arange(G), indexing="ij")
    check(np.array_equal(vh[rr, gg, slot[None, :]], last),
          "a slot does not hold its last PUT's rid")
    want_key = np.where(last > 0, (np.arange(G) & (slots - 1)) + 1, 0)
    check(np.array_equal(kh[rr, gg, slot[None, :]], want_key),
          "a slot does not hold its PUT's key")
    check(int((kh != 0).sum()) == int((last > 0).sum()),
          "a key was written outside its slot")
    timed_lat = np.array(lat[warm:warm + timed]) * 1e3
    t_phase = timed_lat.sum() / 1e3
    return {
        "R": R, "W": W, "P": P, "G": G, "slots": slots, "table": table,
        "exec_budget": E, "ticks_timed": timed, "ticks_total": tick,
        "ms_per_tick": t_phase / timed * 1e3,
        "dec_per_s": decided / t_phase,
        "tick_latency_p50_ms": float(np.percentile(timed_lat, 50)),
        "tick_latency_p99_ms": float(np.percentile(timed_lat, 99)),
        "copy_ms_per_tick": float(np.mean(copy[warm:warm + timed])) * 1e3,
        "buffer_mb": host.nbytes / 1e6,
        "taken": int(taken.sum()), "offered": n_rids,
        "kv_store_mb": 2 * kv.key.numel() * 4 / 1e6,
        "table_mb": 4 * table * 4 / 1e6, "launches": launches,
    }


def kv_cfg(R, W, G):
    """stack_bench.py --device: manager-128k's shape with the device app."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig

    cfg = stack_cfg(GigapaxosTpuConfig(), R, W, G)
    cfg.paxos.device_app = True
    return cfg


class KVLoad:
    """stack_bench.py --device's load: one PUT per group per tick, key
    ``g % (slots-1) + 1``, value ``1 + t*G + g``; every ``sample``-th group
    carries a completion callback that records its response."""

    def __init__(self, m, G, sample=16):
        self.m, self.G = m, G
        self.rows = np.arange(G, dtype=np.int64)
        self.keys = (np.arange(G) % (m.cfg.paxos.kv_slots - 1) + 1).astype(
            np.int32)
        self.ops = np.ones(G, np.int32)  # OP_PUT
        self.sample = sample
        self.acked = {}  # rid -> (group, value, response)
        self.admitted = 0
        self.last_val = np.zeros(G, np.int64)  # the last admitted value

    def propose(self, t):
        vals = (1 + t * self.G + np.arange(self.G)).astype(np.int32)
        cbs = [None] * self.G
        for gi in range(0, self.G, self.sample):
            cbs[gi] = (lambda rid, resp, gi=gi, v=int(vals[gi]):
                       self.acked.__setitem__(rid, (gi, v, resp)))
        rids = self.m.propose_bulk_kv(self.rows, self.ops, self.keys, vals,
                                      callbacks=cbs)
        ok = rids >= 0
        self.admitted += int(ok.sum())
        self.last_val[ok] = vals[ok]
        return rids

    def check_acks(self, what):
        import struct

        for rid, (gi, v, resp) in self.acked.items():
            check(resp == struct.pack("<i", v),
                  f"{what}: rid {rid} acked {resp!r}, its value is {v}")
        check(len(self.acked) > 0, f"{what}: nothing was acked")


def _drain_manager(m, what, limit=64):
    n = 0
    while True:
        m.tick()
        m.drain_pipeline()
        n += 1
        if not m.bulk_stats()["queued"] and not m.bulk.n_live:
            return n
        check(n < limit, f"{what}: drain did not finish: {m.bulk_stats()}")


def device_kv_128k_leg(torch, pg, dev, R, W, G, ticks):
    """``device-kv-128k``: manager-128k's ``PaxosManager`` with
    ``device_app=True`` (stack_bench.py --device) under ``propose_bulk_kv``
    with one PUT per group per tick."""
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    m = PaxosManager(kv_cfg(R, W, G), R, [None] * R, spill_ns="smoke-kv",
                     device=dev)
    check(m.create_paxos_instances([f"g{i}" for i in range(G)],
                                   list(range(R))) == G, "create failed")
    check(all(m.rows.row(f"g{i}") == i for i in (0, G - 1)),
          "rows not in creation order")
    load = KVLoad(m, G)
    pg.reset_launches()
    t0 = time.perf_counter()
    for t in range(ticks):
        load.propose(t)
        m.tick()
    m.drain_pipeline()
    elapsed = time.perf_counter() - t0
    decided = m.stats["decisions"]
    phases = host_phases("smoke-kv")
    drain = _drain_manager(m, "device-kv-128k")
    launches = None
    if dev.type == "cuda":
        launches = path_launches(pg, "device-kv-128k", m.tick_num)
    load.check_acks("device-kv-128k")
    check(m.bulk_stats()["done"] == load.admitted == ticks * G,
          f"device-kv-128k: {m.bulk_stats()} of {load.admitted} admitted")
    check(m.stats["kv_misses"] == 0, "device-kv-128k: descriptor misses")
    slot = load.keys & (m.cfg.paxos.kv_slots - 1)
    vh = m.kv.val.cpu().numpy()
    for r in range(R):
        check(np.array_equal(vh[r, np.arange(G), slot], load.last_val),
              f"device-kv-128k: replica {r} does not hold the last PUTs")
    return {"G": G, "R": R, "W": W, "ticks": ticks, "drain_ticks": drain,
            "admitted": load.admitted, "acked": len(load.acked),
            "dec_per_s": decided / elapsed,
            "ms_per_tick": elapsed / ticks * 1e3,
            "host_ms_per_tick_by_phase": phases, "launches": launches}


def baseline_leg(torch, pg, dev, R, W, G, ticks, flag, manager_dps=None):
    """``baselines-128k``: manager-128k with ``DenseCounterApp`` under one
    of the two measurement baselines (stack_bench.py --baseline):
    ``emulate_unreplicated`` executes each request once, at its entry
    replica, at admission (no tick runs); ``lazy_propagation`` executes at
    the entry at admission and still replicates through the ticks.  The
    closed-loop run of the same requests gives every replica one
    execution of delta 1 per request (manager phase); unreplicated replicas
    together, and each lazy replica alone, must hold exactly that."""
    import struct

    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = stack_cfg(GigapaxosTpuConfig(), R, W, G)
    setattr(cfg.paxos, flag, True)
    apps = [DenseCounterApp(G) for _ in range(R)]
    m = PaxosManager(cfg, R, apps, spill_ns=f"smoke-{flag}", device=dev)
    for a in apps:
        a.row_of = m.rows.row
    check(m.create_paxos_instances([f"g{i}" for i in range(G)],
                                   list(range(R))) == G, "create failed")
    rows = np.arange(G, dtype=np.int64)
    payload = struct.pack("<q", 1)
    acks = np.zeros(G, np.int64)

    def sink(offsets, responses):
        np.add.at(acks, offsets, 1)

    replicated = flag != "emulate_unreplicated"
    pg.reset_launches()
    t0 = time.perf_counter()
    admitted = 0
    for t in range(ticks):
        rids = m.propose_bulk(rows, payload, batch_sink=sink)
        check(bool((rids >= 0).all()), f"{flag}: admission refused")
        admitted += len(rids)
        if replicated:
            m.tick()
    if replicated:
        m.drain_pipeline()
    elapsed = time.perf_counter() - t0
    decided = m.stats["decisions"]
    drain = _drain_manager(m, flag) if replicated else 0
    launches = None
    if dev.type == "cuda":
        launches = (path_launches(pg, flag, m.tick_num) if replicated else
                    launches_now(pg, flag, {"gather_planes": 0,
                                            "match_planes": 0}))
    expect = np.full(G, ticks, np.int64)  # the closed-loop replica state
    check(np.array_equal(acks, expect), f"{flag}: acks per group")
    if replicated:
        for r, a in enumerate(apps):
            check(np.array_equal(a.acc, expect)
                  and np.array_equal(a.count, expect),
                  f"{flag}: replica {r} differs from the closed-loop state")
    else:
        check(np.array_equal(sum(a.acc for a in apps), expect)
              and np.array_equal(sum(a.count for a in apps), expect),
              f"{flag}: the replicas together differ from one closed-loop "
              "replica")
    return {"flag": flag, "G": G, "ticks": ticks, "drain_ticks": drain,
            "admitted": admitted, "dec_per_s": decided / elapsed,
            "ms_per_round": elapsed / ticks * 1e3,
            "manager_128k_dec_per_s": manager_dps, "launches": launches}


def device_kv_recover_leg(torch, pg, dev, R, W, G, ticks, work):
    """``device-kv-recover``: device-kv-128k made durable (native journal,
    an fsync every tick, one checkpoint mid-run), crashed with no drain and
    recovered on the card (a device-app journal replays record at a
    time).  The recovered state, store and table equal the drained live
    manager's; every acked PUT reads back at every replica."""
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.wal.logger import PaxosLogger, recover

    cfg = kv_cfg(R, W, G)
    live_dir = os.path.join(work, "live")
    wal = PaxosLogger(live_dir, sync_every_ticks=1,
                      checkpoint_every_ticks=ticks // 2 + 1, native=True)
    m = PaxosManager(cfg, R, [None] * R, wal=wal, spill_ns="smoke-kv-wal",
                     device=dev)
    check(wal.backend == "native", "the WAL did not open the native journal")
    check(m.create_paxos_instances([f"g{i}" for i in range(G)],
                                   list(range(R))) == G, "create failed")
    load = KVLoad(m, G)
    t0 = time.perf_counter()
    for t in range(ticks):
        load.propose(t)
        m.tick()
    live_s = time.perf_counter() - t0
    snaps = glob.glob(os.path.join(live_dir, "snapshot.*.bin"))
    check(len(snaps) == 1, f"expected one checkpoint, found {len(snaps)}")
    snap_tick = int(os.path.basename(snaps[0]).split(".")[1])
    jbytes = journal_bytes(live_dir)
    m.wal.close()  # crash: no drain, the pending outbox is lost
    acked = dict(load.acked)
    pg.reset_launches()
    t0 = time.perf_counter()
    mr = recover(cfg, R, [None] * R, live_dir, native=True, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = None
    if dev.type == "cuda":
        launches = path_launches(pg, "device-kv replay",
                                 mr.tick_num - snap_tick)
    m.drain_pipeline()
    _same_planes(torch, [m.state, m.kv], [mr.state, mr.kv],
                 "device-kv: drained live vs recovered")
    check(mr.tick_num == m.tick_num and mr._kv_watermark == m._kv_watermark,
          "device-kv: recovered tick or watermark differs")
    backend = mr.wal.backend
    check(backend == "native", "recovery did not open the native journal")
    slot = load.keys & (cfg.paxos.kv_slots - 1)
    vh = mr.kv.val.cpu().numpy()
    kh = mr.kv.key.cpu().numpy()
    for rid, (gi, v, resp) in acked.items():
        for r in range(R):
            # the group's one key takes rising values: a later PUT may
            # have replaced an acked one, never an earlier one
            check(kh[r, gi, slot[gi]] == load.keys[gi]
                  and vh[r, gi, slot[gi]] >= v,
                  f"device-kv: acked PUT {rid} lost at replica {r}")
    check(len(acked) > 0, "device-kv: nothing was acked before the crash")
    mr.wal.close()
    return {"G": G, "R": R, "ticks": ticks, "backend": backend,
            "admitted": load.admitted, "acked_read_back": len(acked),
            "snapshot_tick": snap_tick,
            "replayed_ticks": mr.tick_num - snap_tick,
            "journal_mb_at_crash": jbytes / 1e6,
            "live_ms_per_tick": live_s / ticks * 1e3,
            "replay_s": replay_s, "launches": launches}


def device_kv_phase(torch, pg, dev, work, G_1m=1 << 20, G_128k=1 << 17,
                    ticks_1m=30, ticks_128k=30, manager_dps=None):
    """The four device-kv legs; the durable one in ``work``."""
    R, W, P = 3, 8, 4
    out = {"device-kv-1M": device_kv_1m_leg(
        torch, pg, dev, R, W, P, G_1m, timed=ticks_1m,
        cpu_ticks=3 if ticks_1m >= 3 else ticks_1m)}
    out["device-kv-128k"] = device_kv_128k_leg(torch, pg, dev, R, W, G_128k,
                                               ticks_128k)
    out["baselines-128k"] = {
        arm: baseline_leg(torch, pg, dev, R, W, G_128k, ticks_128k, flag,
                          manager_dps)
        for arm, flag in (("unreplicated", "emulate_unreplicated"),
                          ("lazy", "lazy_propagation"))}
    out["device-kv-recover"] = device_kv_recover_leg(
        torch, pg, dev, R, W, G_128k, max(4, ticks_128k * 2 // 3),
        os.path.join(work, "kv-wal"))
    return out


# ------------------------------------------------------------- chain phase

def chain_1m_leg(torch, pg, dev, R, W, P, G, warm=3, timed=30, cpu_ticks=3):
    """``chain-1M``: ``chain_tick_packed`` over G chains of R members with
    one fresh request per chain per tick at its head (inbox row 0, rid
    ``base + g``), closed loop: each tick's packed outbox (O(R*W*G)) is on
    the host before the next starts.  The first ``cpu_ticks`` ticks are
    held against the CPU; at the end every taken request was applied once
    at every replica (counts and rid sums) and committed once at the
    tail; each tick launches one gather and no match."""
    from gigapaxos_tpu_torch.chain import state as cs
    from gigapaxos_tpu_torch.chain import tick as ct

    def fresh(device):
        return cs.create_groups(cs.init_state(R, G, W, device=device),
                                np.arange(G), np.ones((G, R), bool))

    state = fresh(dev)
    cpu = fresh("cpu") if cpu_ticks else None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = torch.arange(G, dtype=torch.int32, device=dev)
    stop = torch.zeros((P, G), dtype=torch.bool, device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    lat, copy, commits, tick, idle = [], [], 0, 0, 0
    taken_n = taken_sum = committed = 0
    exec_n = np.zeros(R, np.int64)
    exec_sum = np.zeros(R, np.int64)
    pg.reset_launches()
    while True:
        loading = tick < warm + timed
        base = 1 + tick * G
        if tick == warm:
            sync()
        t0 = time.perf_counter()
        req = torch.zeros((P, G), dtype=torch.int32, device=dev)
        if loading:
            req[0] = base + g
        inbox = ct.ChainInbox(req, stop, alive)
        state, packed = ct.chain_tick_packed(state, inbox)
        sync()
        t1 = time.perf_counter()
        host = packed.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        copy.append(time.perf_counter() - t1)
        out = ct.unpack_chain_outbox(host, R, P, W, G)
        if warm <= tick < warm + timed:
            commits += int(out.committed_now.sum())
        committed += int(out.committed_now.sum())
        if loading:
            tk = out.intake_taken[0]
            taken_n += int(tk.sum())
            taken_sum += int((base + np.arange(G, dtype=np.int64))[tk].sum())
        exec_n += out.exec_count.sum(axis=1)
        exec_sum += out.exec_req.sum(axis=(1, 2), dtype=np.int64)
        if tick < cpu_ticks:
            cpu, cflat = ct.chain_tick_packed(
                cpu, ct.ChainInbox(*(t.cpu() for t in inbox)))
            check(np.array_equal(cflat.numpy(), host),
                  f"chain tick {tick}: outbox differs from the CPU run")
            _same_planes(torch, [state], [cpu],
                         f"chain tick {tick} vs the CPU run")
            if tick == cpu_ticks - 1:
                cpu = None
        tick += 1
        if not loading:
            idle = idle + 1 if not out.exec_count.any() else 0
            if idle >= 2:
                break
            check(tick < warm + timed + 8 * W, "chain drain did not finish")
    launches = None
    if dev.type == "cuda":
        launches = launches_now(pg, "chain-1M",
                                {"gather_planes": tick, "match_planes": 0})
    check(committed == taken_n > 0, f"chain-1M: {committed} committed of "
                                    f"{taken_n} taken")
    check(bool(np.all(exec_n == taken_n)) and bool(np.all(
        exec_sum == taken_sum)), "chain-1M: a replica did not apply every "
                                 "taken request once")
    timed_lat = np.array(lat[warm:warm + timed]) * 1e3
    t_phase = timed_lat.sum() / 1e3
    return {"R": R, "W": W, "P": P, "G": G, "ticks_timed": timed,
            "ticks_total": tick, "ms_per_tick": t_phase / timed * 1e3,
            "commits": commits, "commits_per_s": commits / t_phase,
            "tick_latency_p50_ms": float(np.percentile(timed_lat, 50)),
            "tick_latency_p99_ms": float(np.percentile(timed_lat, 99)),
            "copy_ms_per_tick": float(np.mean(copy[warm:warm + timed])) * 1e3,
            "taken": taken_n, "state_mb": sum(
                t.numel() * t.element_size() for t in state) / 1e6,
            "outbox_mb": host.nbytes / 1e6, "launches": launches}


def _chain_manager(dev, G, W, P, wal=None):
    from gigapaxos_tpu_torch.chain import ChainManager
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.window = W
    cfg.paxos.proposals_per_tick = P
    return cfg, ChainManager(cfg, 3, [KVApp() for _ in range(3)], wal=wal,
                             device=dev)


def _chain_load(m, names, ticks, acked, outage=None):
    """One PUT ``k<t> <t>`` per busy chain per tick, acks recorded with
    whether replica 1 was down; replica 1 is down for the ticks in
    ``outage`` (shorter than the window: a dead member freezes the
    chain's window room); then ticks until every request responded."""
    for t in range(ticks):
        if outage is not None:
            m.set_alive(1, t not in outage)
        for n in names:
            m.propose(n, f"PUT k{t} {t}".encode(),
                      lambda rid, resp, n=n, t=t: acked.append(
                          (n, t, resp, not m.alive[1])))
        m.tick()
    extra = 0
    while any(not r.responded for r in m.outstanding.values()) \
            or m.pending_count():
        m.tick()
        extra += 1
        check(extra < 64, "chain drain did not finish")
    return extra


def chain_128k_leg(torch, pg, dev, G, W, P, ticks, busy, work,
                   durable_busy=512, durable_ticks=16):
    """``chain-128k``: ``ChainManager`` over a G-row plane with ``KVApp``;
    ``busy`` chains take one PUT each per tick; the middle replica is
    killed halfway for W/2 ticks, the chains relink around it (writes keep
    committing at the tail), it rejoins and catches up from its live
    predecessor, and every acked write reads back at every member.  Then a durable leg (``ChainLogger``,
    native journal, one checkpoint) is crashed and recovered with
    ``recover_chain``: the recovered state and apps equal the live ones."""
    from gigapaxos_tpu_torch.chain.state import ChainState
    from gigapaxos_tpu_torch.wal.chain_logger import (ChainLogger,
                                                      recover_chain)

    cfg, m = _chain_manager(dev, G, W, P)
    names = [f"c{i}" for i in range(busy)]
    for n in names:
        check(m.create_paxos_instance(n, [0, 1, 2]), "chain create failed")
    acked = []
    pg.reset_launches()
    t0 = time.perf_counter()
    outage = range(ticks // 2, ticks // 2 + W // 2)
    extra = _chain_load(m, names, ticks, acked, outage=outage)
    elapsed = time.perf_counter() - t0
    launches = None
    if dev.type == "cuda":
        launches = launches_now(pg, "chain-128k",
                                {"gather_planes": m.tick_num,
                                 "match_planes": 0})
    check(len(acked) == busy * ticks, f"chain-128k: {len(acked)} acked of "
                                      f"{busy * ticks}")
    dead = 0
    for n, t, resp, down in acked:
        check(resp == b"OK", f"chain-128k: PUT on {n} answered {resp!r}")
        for r in range(3):
            check(m.apps[r].db[n][f"k{t}"] == str(t),
                  f"chain-128k: acked write {n} k{t} lost at replica {r}")
        dead += down
    check(dead > 0, "chain-128k: nothing committed while replica 1 was "
                    "down")
    res = {"G": G, "W": W, "P": P, "busy_chains": busy, "ticks": ticks,
           "drain_ticks": extra, "acked": len(acked),
           "acked_while_member_down": dead,
           "ms_per_tick": elapsed / m.tick_num * 1e3,
           "commits_per_s": m.stats["decisions"] / elapsed,
           "launches": launches}

    live_dir = os.path.join(work, "chain-wal")
    wal = ChainLogger(live_dir, sync_every_ticks=1,
                      checkpoint_every_ticks=durable_ticks // 2 + 1,
                      native=True)
    cfg, d = _chain_manager(dev, G, W, P, wal=wal)
    check(wal.backend == "native", "the chain WAL did not open the native "
                                   "journal")
    dnames = names[:durable_busy]
    for n in dnames:
        check(d.create_paxos_instance(n, [0, 1, 2]), "chain create failed")
    dacked = []
    t0 = time.perf_counter()
    _chain_load(d, dnames, durable_ticks, dacked)
    durable_s = time.perf_counter() - t0
    check(len(glob.glob(os.path.join(live_dir, "snapshot.*.bin"))) >= 1,
          "chain: expected a checkpoint")
    d.wal.close()  # crash
    t0 = time.perf_counter()
    rec = recover_chain(cfg, 3, [type(a)() for a in d.apps], live_dir,
                        native=True, device=dev)
    replay_s = time.perf_counter() - t0
    for name, x, y in zip(ChainState._fields, d.state, rec.state):
        check(torch.equal(x, y), f"chain: recovered {name} differs")
    check([a.db for a in d.apps] == [a.db for a in rec.apps],
          "chain: recovered apps differ")
    check(rec.tick_num == d.tick_num, "chain: recovered tick differs")
    rec.wal.close()
    res.update({"durable_chains": durable_busy,
                "durable_ticks": d.tick_num,
                "durable_ms_per_tick": durable_s / d.tick_num * 1e3,
                "acked_read_back": len(dacked) + len(acked),
                "replay_s": replay_s})
    return res


def chain_phase(torch, pg, dev, work, G_1m=1 << 20, G_128k=1 << 17,
                ticks_1m=30, ticks_128k=30, busy=8192, cluster_groups=1 << 17,
                n_names=256, n_reconf=4, n_delete=4):
    """The three chain legs; the durable one in ``work``."""
    out = {"chain-1M": chain_1m_leg(torch, pg, dev, 3, 8, 4, G_1m,
                                    timed=ticks_1m,
                                    cpu_ticks=min(3, ticks_1m))}
    out["chain-128k"] = chain_128k_leg(torch, pg, dev, G_128k, 8, 2,
                                       ticks_128k, min(busy, G_128k), work)
    out["chain-cluster"] = cluster_phase(
        torch, pg, dev, cluster_groups, n_names=n_names,
        create_batch=n_names, put_batch=n_names, serial=min(64, n_names),
        n_reconf=n_reconf, n_delete=n_delete, coordinator="chain")
    return out


# --------------------------------------------------------------- modeb phase

MODEB_IDS = ("N0", "N1", "N2")


def _exec_count_app():
    """NoopApp that counts each executed request's payload (every payload
    of the Mode B legs is unique, so a count of 1 is exactly-once)."""
    import collections

    from gigapaxos_tpu_torch.models.replicable import NoopApp

    class Counted(NoopApp):
        def __init__(self):
            self.count = collections.Counter()

        def execute(self, name, request, request_id):
            self.count[bytes(request)] += 1
            return super().execute(name, request, request_id)

    return Counted()


def modeb_cfg(G, **paxos):
    """cfg defaults (W=4, P=4) with ``max_groups`` G and no deactivation,
    as ``benchmarks/modeb_scale.py`` runs its nodes."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.deactivation_ticks = 0
    for k, v in paxos.items():
        setattr(cfg.paxos, k, v)
    return cfg


class _ModeBRun:
    """Three nodes ticked in turn (then the SimNet pumped, when there is
    one), with per-node tick times and the node-tick count for the launch
    check."""

    def __init__(self, nodes, net=None):
        self.nodes, self.net = nodes, net
        self.tick_ms = []

    def node_ticks(self):
        return sum(n.tick_num for n in self.nodes.values())

    def spin(self, k=1, only=None):
        for _ in range(k):
            for nid, n in self.nodes.items():
                if only is None or nid in only:
                    t0 = time.perf_counter()
                    n.tick()
                    self.tick_ms.append((time.perf_counter() - t0) * 1e3)
            if self.net is not None:
                self.net.pump()

    def wave(self, at, names, payloads, limit, only=None, tag="wave"):
        """Propose ``payloads[i]`` on ``names[i]`` at node ``at``, tick until
        every one is answered; -> (acked payloads, rounds, seconds)."""
        done = []
        t0 = time.perf_counter()
        for name, p in zip(names, payloads):
            rid = self.nodes[at].propose(
                name, p, lambda _r, resp, p=p: done.append((p, resp)))
            check(rid is not None, f"{tag}: propose refused on {name}")
        rounds = 0
        while len(done) < len(names):
            self.spin(1, only=only)
            rounds += 1
            check(rounds <= limit, f"{tag}: {len(done)} of {len(names)} "
                  f"answered after {limit} rounds")
        wall = time.perf_counter() - t0
        check(all(r is not None for _p, r in done), f"{tag}: a request "
              "failed")
        return [p for p, _r in done], rounds, wall


def modeb_1m_leg(torch, pg, dev, G=1 << 20, warm=64, hot=1 << 14,
                 laggard=1 << 16, cpu_ticks=3, ae=64):
    """``modeb-1M`` after ``benchmarks/modeb_scale.py:40-125``: three
    ``ModeBNode``s in this process on loopback ``Messenger``s, each with
    its own ``[3, W, G]`` state on ``dev``, ``NoopApp``-shaped apps,
    anti-entropy every ``ae`` ticks (256 in the benchmark; cut to 64 for
    the run's time: at 2^20 groups the full-state batch is over the 64 MB
    frame cap, so the births take one anti-entropy cycle, 260 rounds and
    123 s at 256 on an H100).  Bulk create, the election of every
    group, a warm and a steady wave of ``warm`` commits, a hot wave of one
    request on each of ``hot`` groups, then the mass laggard: N2 stops
    ticking while ``laggard`` groups commit once each, and rejoins with
    ``request_sync()``.  N0's first ``cpu_ticks`` node ticks are held
    against the same ticks on the CPU."""
    from gigapaxos_tpu_torch.modeb import ModeBNode
    from gigapaxos_tpu_torch.modeb import kernel as mk
    from gigapaxos_tpu_torch.net.messenger import Messenger, NodeMap
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as st

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = modeb_cfg(G)
    W, P = cfg.paxos.window, cfg.paxos.proposals_per_tick
    nodemap = NodeMap()
    msgs, apps, nodes = {}, {}, {}
    for nid in MODEB_IDS:
        msgs[nid] = Messenger(nid, ("127.0.0.1", 0), nodemap)
        nodemap.add(nid, "127.0.0.1", msgs[nid].port)
    try:
        for nid in MODEB_IDS:
            apps[nid] = _exec_count_app()
            nodes[nid] = ModeBNode(cfg, list(MODEB_IDS), nid, apps[nid],
                                   msgs[nid], anti_entropy_every=ae,
                                   device=dev)
        n0, n2 = nodes["N0"], nodes["N2"]
        probe = {"ticks": 0, "copy_ms": [], "bytes": 0, "cpu_equal": 0}
        inner = n0._tick_packed

        def packed(state, inbox):
            k = probe["ticks"]
            probe["ticks"] += 1
            before = None
            if k < cpu_ticks:
                before = (st.PaxosState(*(t.cpu().clone() for t in state)),
                          pt.TickInbox(*(t.cpu().clone() for t in inbox)))
            new, flat = inner(state, inbox)
            sync()
            t0 = time.perf_counter()
            host = flat.cpu()
            probe["copy_ms"].append((time.perf_counter() - t0) * 1e3)
            probe["bytes"] = flat.numel() * flat.element_size()
            if before is not None:
                cs, cflat = mk.node_tick_packed(n0.r, False)(*before)
                check(torch.equal(cflat, host), f"modeb-1M: N0 tick {k}'s "
                      "packed outbox differs from the CPU's")
                for f, a, b in zip(st.PaxosState._fields, new, cs):
                    check(torch.equal(a.cpu(), b), f"modeb-1M: N0 tick {k} "
                          f"field {f} differs from the CPU's")
                probe["cpu_equal"] += 1
            return new, host

        n0._tick_packed = packed
        run = _ModeBRun(nodes)
        names = [f"g{i}" for i in range(G)]
        t0 = time.perf_counter()
        for n in nodes.values():
            check(n.create_groups_bulk(names, [0, 1, 2]) == G,
                  "modeb-1M: bulk create")
        create_s = time.perf_counter() - t0
        pg.reset_launches()
        ticks0 = run.node_ticks()
        # every group elects N0; at 2^20 rows the first tick's full frame
        # batch is over the transport's frame cap, so the births ride the
        # rotating anti-entropy slices
        t0 = time.perf_counter()
        elect_rounds = 0
        while not all((n._coord_view == 0).all() for n in nodes.values()):
            run.spin(1)
            elect_rounds += 1
            check(elect_rounds <= 400, "modeb-1M: election did not finish")
        elect_s = time.perf_counter() - t0
        acked = []
        p, warm_rounds, _ = run.wave("N0", names[:warm],
                                     [f"w{i}".encode() for i in range(warm)],
                                     200, tag="warm")
        acked += p
        for n in nodes.values():
            n.stats["frame_bytes_sent"] = 0
            n.stats["frame_groups"] = 0
            n.stats["frames_sent"] = 0
        t_before = run.node_ticks()
        p, steady_rounds, _ = run.wave("N0", names[:warm],
                                       [f"x{i}".encode()
                                        for i in range(warm)],
                                       200, tag="steady")
        acked += p
        st_ticks = run.node_ticks() - t_before
        st_bytes = sum(n.stats["frame_bytes_sent"] for n in nodes.values())
        st_rows = sum(n.stats["frame_groups"] for n in nodes.values())
        # O(dirty): the anti-entropy slice (G/ae rows) plus the dirty rows
        # of the wave, never the G-row state
        check(st_rows / st_ticks <= G // ae + 4 * warm,
              f"modeb-1M: {st_rows / st_ticks} frame rows a node tick")
        run.tick_ms.clear()
        p, hot_rounds, hot_s = run.wave(
            "N0", names[:hot], [f"h{i}".encode() for i in range(hot)], 400,
            tag="hot")
        acked += p
        hot_ms = sorted(run.tick_ms)
        # the mass laggard: N2 misses one commit on each of `laggard` groups
        p, lag_rounds, lag_s = run.wave(
            "N0", names[:laggard], [f"m{i}".encode() for i in range(laggard)],
            800, only=("N0", "N1"), tag="laggard")
        acked += p
        for n in nodes.values():
            n.stats["frame_bytes_sent"] = 0
            n.stats["send_failures"] = 0
        t0 = time.perf_counter()
        n2.request_sync()
        conv_rounds = 0
        want = st.to_host(n0.state.exec_slot[n0.r])
        while True:
            run.spin(1)
            conv_rounds += 1
            if (st.to_host(n2.state.exec_slot[n2.r]) >= want).all():
                break
            check(conv_rounds <= 2000, "modeb-1M: N2 did not converge")
        conv_s = time.perf_counter() - t0
        residual = int(np.clip(want - st.to_host(n2.state.exec_slot[n2.r]),
                               0, None).sum())
        check(residual == 0, f"modeb-1M: residual lag {residual}")
        sync_failures = sum(n.stats["send_failures"] for n in nodes.values())
        rx_bytes = sum(n.stats["frame_bytes_sent"] for n in nodes.values())
        run.spin(4)  # the last decisions reach every node's app
        node_ticks = run.node_ticks() - ticks0
        launches = None
        if dev.type == "cuda":
            launches = launches_now(pg, f"modeb-1M, {node_ticks} node ticks",
                                    {"gather_planes": 5 * node_ticks,
                                     "match_planes": node_ticks})
        for nid in MODEB_IDS:
            cnt = apps[nid].count
            bad = [q for q in acked if cnt[q] != 1]
            check(not bad, f"modeb-1M: {len(bad)} acked commits not "
                  f"executed exactly once at {nid} (e.g. {bad[:3]})")
        ex = [st.to_host(n.state.exec_slot[n.r]) for n in nodes.values()]
        check(all(np.array_equal(ex[0], e) for e in ex[1:]),
              "modeb-1M: the nodes' exec_slot differ")
        check(probe["cpu_equal"] == cpu_ticks, "modeb-1M: CPU ticks held")
        # the leg's node ticks are the first of the run's Mode B planes
        phases = {nid: host_phases(nid) for nid in MODEB_IDS}
        return {
            "G": G, "W": W, "P": P, "anti_entropy_every": ae,
            "create_bulk_s": create_s,
            "elect": {"rounds": elect_rounds, "s": elect_s},
            "warm": {"commits": warm, "rounds": warm_rounds},
            "steady": {"commits": warm, "rounds": steady_rounds,
                       "frame_bytes_per_node_tick": st_bytes / st_ticks,
                       "frame_rows_per_node_tick": st_rows / st_ticks},
            "hot": {"commits": hot, "rounds": hot_rounds, "s": hot_s,
                    "commits_per_s": hot / hot_s,
                    "node_tick_ms_mean": statistics.fmean(hot_ms),
                    "node_tick_ms_p50": hot_ms[len(hot_ms) // 2],
                    "node_tick_ms_p99": hot_ms[int(0.99 * (len(hot_ms)
                                                           - 1))]},
            "laggard": {"commits": laggard, "rounds": lag_rounds,
                        "s": lag_s, "converge_rounds": conv_rounds,
                        "converge_s": conv_s, "residual_lag_slots": residual,
                        "frame_bytes_total": rx_bytes,
                        "full_sync_send_failures": sync_failures},
            "packed_outbox_bytes": probe["bytes"],
            "packed_copy_ms_median": statistics.median(probe["copy_ms"]),
            "cpu_ticks_equal": probe["cpu_equal"],
            "acked": len(acked), "node_ticks": node_ticks,
            "cut": {"hot_groups": hot, "laggard_groups": laggard,
                    "why": "one Python propose per request"},
            "host_ms_per_node_tick_by_phase": phases,
            "launches": launches,
        }
    finally:
        for m in msgs.values():
            m.close()


def _fast_failover(dev, G, busy, fast, W=8):
    """``modeb-fast``'s schedule after ``tests/test_fast_reelection.py:
    200-230``, widened: three nodes over ``SimNet`` with G rows, ``busy``
    groups committed once at N0 (their coordinator), then N0 cut off and
    marked dead at N1/N2 and one request proposed at N1 on each busy
    group.  -> (ticks until N1 coordinates every busy group, ticks until
    N1's first commit, ticks until all commit, the leg's node ticks)."""
    from gigapaxos_tpu_torch.modeb import ModeBNode
    from gigapaxos_tpu_torch.testing.simnet import SimNet

    net = SimNet(seed=1)
    cfg = modeb_cfg(G, window=W, fast_reelection=fast)
    nodes = {n: ModeBNode(cfg, list(MODEB_IDS), n, _exec_count_app(),
                          net.messenger(n), anti_entropy_every=8,
                          device=dev) for n in MODEB_IDS}
    names = [f"g{i}" for i in range(G)]
    for n in nodes.values():
        n.create_groups_bulk(names, [0, 1, 2])
    run = _ModeBRun(nodes, net)
    run.wave("N0", names[:busy], [f"a{i}".encode() for i in range(busy)],
             100, tag="modeb-fast warm")
    rows = np.array([nodes["N1"].rows.row(n) for n in names[:busy]])
    check((nodes["N1"]._coord_view[rows] == 0).all(), "modeb-fast: N0 leads")
    net.partition({"N0"}, {"N1", "N2"})
    for nid in ("N1", "N2"):
        nodes[nid].set_alive(0, False)
    done = []
    for i, name in enumerate(names[:busy]):
        nodes["N1"].propose(name, f"b{i}".encode(),
                            lambda _r, x: done.append(x))
    t_coord = t_first = t_all = None
    for t in range(1, 201):
        run.spin(1, only=("N1", "N2"))
        if t_coord is None and (nodes["N1"]._coord_view[rows] == 1).all():
            t_coord = t
        if t_first is None and done:
            t_first = t
        if len(done) == busy:
            t_all = t
            break
    check(t_all is not None
          and all(x is not None and x.startswith(b"ok:b") for x in done),
          f"modeb-fast (fast={fast}): {len(done)} of {busy} committed")
    return t_coord, t_first, t_all, run.node_ticks()


def modeb_fast_leg(torch, pg, dev, G=1 << 17, busy=4096, cpu_G=256,
                   cpu_busy=64):
    """``modeb-fast``: the failover schedule with fast re-election off and
    on; the fast leg must take over in 1 tick and be strictly quicker on
    both counts, and both legs' counts must equal the same schedule's at
    ``cpu_G`` rows on the CPU.  Each leg is a counted path: 5 gathers + 1
    match a node tick, fast re-election on or off."""
    out = {"G": G, "busy": busy, "W": 8}
    launches = {}
    for fast in (False, True):
        pg.reset_launches()
        t0 = time.perf_counter()
        t_coord, t_first, t_all, nt = _fast_failover(dev, G, busy, fast)
        wall = time.perf_counter() - t0
        if dev.type == "cuda":
            launches["fast" if fast else "full"] = launches_now(
                pg, f"modeb-fast (fast={fast}), {nt} node ticks",
                {"gather_planes": 5 * nt, "match_planes": nt})
        cpu = _fast_failover(torch.device("cpu"), cpu_G, cpu_busy, fast)
        check(cpu[:2] == (t_coord, t_first), f"modeb-fast (fast={fast}): "
              f"({t_coord}, {t_first}) ticks on {dev}, {cpu[:2]} on the CPU")
        out["fast" if fast else "full"] = {
            "ticks_to_coordinator": t_coord, "ticks_to_first_commit": t_first,
            "ticks_to_all_commits": t_all, "leg_s": wall,
            "node_ticks": nt}
    f, c = out["fast"], out["full"]
    check(f["ticks_to_coordinator"] == 1, "modeb-fast: takeover not in 1 "
          "tick")
    check(f["ticks_to_coordinator"] < c["ticks_to_coordinator"]
          and f["ticks_to_first_commit"] < c["ticks_to_first_commit"],
          f"modeb-fast: fast {f} not quicker than full {c}")
    out["launches"] = launches or None
    return out


def modeb_device_leg(torch, pg, dev, G=1 << 17, busy=4096, ticks=16):
    """``modeb-device-128k``: three device-app nodes over ``SimNet``, one
    PUT a tick on each of ``busy`` groups (entering at node g % 3) for
    ``ticks`` ticks, one of them forced down the miss path at N0 (its
    descriptor never uploads there, so N0 applies it on the host); the
    three KV tables must be equal and every acked write read back."""
    import struct

    from gigapaxos_tpu_torch.models.device_kv import OP_GET, OP_PUT, pack_desc
    from gigapaxos_tpu_torch.modeb import ModeBNode
    from gigapaxos_tpu_torch.testing.simnet import SimNet

    net = SimNet(seed=2)
    reg = 4 * busy
    cfg = modeb_cfg(G, device_app=True, kv_reg_budget=reg)
    nodes = {n: ModeBNode(cfg, list(MODEB_IDS), n, None, net.messenger(n),
                          anti_entropy_every=64, device=dev)
             for n in MODEB_IDS}
    names = [f"g{i}" for i in range(G)]
    for n in nodes.values():
        n.create_groups_bulk(names, [0, 1, 2])
    run = _ModeBRun(nodes, net)
    run.spin(4)  # elect
    n0 = nodes["N0"]
    scalar = {"n": 0}
    inner_exec = n0.app.execute

    def counted(name, request, rid):
        scalar["n"] += 1
        return inner_exec(name, request, rid)

    n0.app.execute = counted
    acked = {}
    pg.reset_launches()
    ticks0 = run.node_ticks()
    t0 = time.perf_counter()
    miss_rid = None
    for t in range(ticks):
        key = t % 4 + 1
        for g in range(busy):
            val = t * busy + g + 1
            at = MODEB_IDS[g % 3]
            rid = nodes[at].propose(
                names[g], pack_desc(OP_PUT, key, val),
                lambda _r, x, g=g, key=key, val=val: acked.__setitem__(
                    (g, key, val), x))
            check(rid is not None, "modeb-device: propose refused")
            if t == ticks // 2 and g == 0:
                miss_rid = rid
                n0._kv_known[rid] = True  # never uploaded at N0
        run.spin(1)
    rounds = 0
    while len(acked) < ticks * busy:
        run.spin(1)
        rounds += 1
        check(rounds <= 200, f"modeb-device: {len(acked)} acked")
    wall = time.perf_counter() - t0
    run.spin(6)
    node_ticks = run.node_ticks() - ticks0
    launches = None
    if dev.type == "cuda":
        launches = launches_now(pg, f"modeb-device, {node_ticks} node ticks",
                                {"gather_planes": 5 * node_ticks,
                                 "match_planes": node_ticks})
    check(miss_rid is not None and scalar["n"] >= 1,
          "modeb-device: the miss path never ran at N0")
    bad = [k for k, x in acked.items() if x != struct.pack("<i", k[2])]
    check(not bad, f"modeb-device: {len(bad)} PUT responses wrong")
    keys = [n.kv.key[0].cpu().numpy() for n in nodes.values()]
    vals = [n.kv.val[0].cpu().numpy() for n in nodes.values()]
    rows = [np.array([n.rows.row(x) for x in names[:busy]])
            for n in nodes.values()]
    for i in (1, 2):
        check(np.array_equal(keys[0][rows[0]], keys[i][rows[i]])
              and np.array_equal(vals[0][rows[0]], vals[i][rows[i]]),
              f"modeb-device: {MODEB_IDS[i]}'s KV table differs from N0's")
    # every acked write reads back: each key's last PUT is in the table
    S = n0.kv.slots
    last = {}
    for (g, key, val) in acked:
        last[(g, key)] = max(last.get((g, key), 0), val)
    for (g, key), val in last.items():
        r = rows[0][g]
        check(keys[0][r, key & (S - 1)] == key
              and vals[0][r, key & (S - 1)] == val,
              f"modeb-device: group {g} key {key} lost its last PUT")
    # and through consensus: a GET on a few groups
    got = {}
    for g in range(0, busy, max(1, busy // 16)):
        nodes["N1"].propose(names[g], pack_desc(OP_GET, 1, 0),
                            lambda _r, x, g=g: got.__setitem__(g, x))
    for _ in range(40):
        run.spin(1)
        if len(got) == len(range(0, busy, max(1, busy // 16))):
            break
    for g, x in got.items():
        check(x == struct.pack("<i", last[(g, 1)]),
              f"modeb-device: GET on group {g} read {x!r}")
    check(got, "modeb-device: no GET answered")
    return {"G": G, "busy": busy, "ticks": ticks, "kv_reg_budget": reg,
            "acked": len(acked), "drain_rounds": rounds, "s": wall,
            "puts_per_s": len(acked) / wall,
            "miss_path_scalar_execs_N0": scalar["n"],
            "gets_read_back": len(got), "node_ticks": node_ticks,
            "launches": launches}


# ------------------------------------------------- Mode B durability leg

def _journal_tally(wal, tally):
    """Count the bytes of every record ``wal`` appends by op (a record is
    a ``records`` tuple: tag, u32 count, then its first item, the op, as
    ``'i'`` + int64, so byte 6 is the op)."""
    inner = wal._append

    def counted(rec, _inner=inner):
        tally[rec[6]] = tally.get(rec[6], 0) + len(rec)
        _inner(rec)

    wal._append = counted


def _timed(obj, name, samples):
    """Wrap ``obj.name`` to append each call's wall milliseconds."""
    inner = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            samples.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, timed)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[int(q * (len(xs) - 1))] if xs else None


class _Launches:
    """Launch counts of one main path read in segments: each segment sets
    the counts to 0 before it runs and adds them after, against
    ``gathers`` gathers + ``matches`` matches per node tick of the segment
    (5 + 1 a Paxos Mode B node tick, 1 + 0 a chain one)."""

    def __init__(self, pg, on, gathers=5, matches=1):
        self.pg, self.on = pg, on
        self.per_tick = {"gather_planes": gathers, "match_planes": matches}
        self.got = {"gather_planes": 0, "match_planes": 0}
        self.ticks = 0

    def begin(self):
        self.pg.reset_launches()

    def end(self, what, node_ticks):
        if not self.on:
            return
        launches_now(self.pg, what, {k: n * node_ticks
                                     for k, n in self.per_tick.items()})
        for k in self.got:
            self.got[k] += self.pg.launches[k]
        self.ticks += node_ticks
        self.pg.reset_launches()

    def result(self):
        return dict(self.got) if self.on else None


class _ReplayProbe:
    """Times the replay's packed-outbox copy (``unpack_node_tick`` is the
    replay's one device-to-host copy a tick) and counts replayed ticks."""

    def __init__(self, torch, dev):
        from gigapaxos_tpu_torch.modeb import logger as mlog

        self.mlog, self.inner = mlog, mlog.unpack_node_tick
        self.sync = (torch.cuda.synchronize if dev.type == "cuda"
                     else (lambda: None))
        self.copy_ms = []

    def __enter__(self):
        def timed(flat, *a):
            self.sync()
            t0 = time.perf_counter()
            host = flat.cpu()
            self.copy_ms.append((time.perf_counter() - t0) * 1e3)
            return self.inner(host, *a)

        self.mlog.unpack_node_tick = timed
        return self

    def __exit__(self, *exc):
        self.mlog.unpack_node_tick = self.inner


def _same_state(a_np, b_np, what):
    from gigapaxos_tpu_torch.paxos import state as st

    for f, a, b in zip(st.PaxosState._fields, a_np, b_np):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"{what}: field {f} differs from the pre-crash copy")


def _read_back(nodes, acked, what):
    """Every acked PUT (group, key) -> value reads back from each node's
    KVApp."""
    for nid, n in nodes.items():
        db = n.app.db
        bad = [k for k, v in acked.items() if db.get(k[0], {}).get(k[1]) != v]
        check(not bad, f"{what}: {len(bad)} acked writes missing at {nid} "
              f"(e.g. {bad[:3]})")


def _chaos_traffic(chaos, sched, n=9, every=25, start=5):
    """``tests/test_chaos.py:49``'s ``with_traffic``: ``n`` PUTs on group
    ``svc`` entering at the nodes in turn."""
    sched.events = sched.events + [
        chaos.ChaosEvent(start + i * every, "propose",
                         {"node": MODEB_IDS[i % 3], "group": "svc",
                          "payload": f"PUT k{i} v{i}"})
        for i in range(n)]
    return sched


def _modeb_wal_chaos(torch, dev, G, groups, work, ticks, ae, live_l,
                     replay_l, probe, gap):
    """The leg's chaos run and degraded recovery: three durable nodes of G
    rows on ``SimNet``, with
    ``groups`` groups (a depth cut: the blanket taint of a degraded
    recovery journals one record, and one fsync, per group).  First the
    chaos run: ``coordinator_crash("N0", 30, 160)`` with traffic, where
    ``recover`` rebuilds N0 with ``recover_modeb`` (its replayed ticks
    are the ``modeb_replay`` path); then N2 crashes, the others commit one
    PUT on each of ``gap`` groups, one byte in the fsynced region of N2's
    newest journal flips, and N2 recovers degraded: the journal
    quarantined byte for byte, every row tainted, then repaired by
    checkpoint transfers as the nodes tick."""
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.modeb import ModeBLogger, ModeBNode
    from gigapaxos_tpu_torch.modeb import recover_modeb
    from gigapaxos_tpu_torch.testing import chaos, faultdisk
    from gigapaxos_tpu_torch.testing.simnet import SimNet
    from gigapaxos_tpu_torch.wal.journal import scan_journal

    net = SimNet(seed=0)
    cfg = modeb_cfg(G)
    dirs = {n: os.path.join(work, "chaos", n) for n in MODEB_IDS}
    live = {"ticks": 0}

    def counted(n):
        inner = n.tick

        def tick():
            live["ticks"] += 1
            return inner()

        n.tick = tick
        return n

    nodes = {n: counted(ModeBNode(cfg, list(MODEB_IDS), n, KVApp(),
                                  net.messenger(n),
                                  wal=ModeBLogger(dirs[n], native=True),
                                  anti_entropy_every=ae, device=dev))
             for n in MODEB_IDS}
    names = ["svc"] + [f"g{i}" for i in range(1, groups)]
    for n in nodes.values():
        check(n.create_groups_bulk(names, [0, 1, 2]) == groups,
              "modeb-wal chaos: bulk create")
        # a deployment past its first checkpoint: recovery reads the
        # snapshot instead of replaying every create one by one
        n.wal.checkpoint()

    def recover(nid, **kw):
        live_l.end("modeb-wal chaos live ticks", live["ticks"])
        live["ticks"] = 0
        before = len(probe.copy_ms)
        t0 = time.perf_counter()
        n = recover_modeb(cfg, list(MODEB_IDS), nid, KVApp(), dirs[nid],
                          native=True, device=dev, **kw)
        secs = time.perf_counter() - t0
        replayed = len(probe.copy_ms) - before
        replay_l.end(f"modeb-wal replay of {nid}", replayed)
        n.attach_messenger(net.messenger(nid))
        return counted(n), replayed, secs

    replay = {}

    def restart(nid):
        n, replay["ticks"], replay["s"] = recover(nid)
        return n

    sched = _chaos_traffic(chaos, chaos.coordinator_crash(
        "N0", crash_at=30, recover_at=160))
    runner = chaos.SimChaosRunner(net, nodes, sched, wal_dirs=dirs,
                                  restart=restart)
    live_l.begin()
    t0 = time.perf_counter()
    runner.run(ticks)
    drain = 0
    while True:  # the recovered coordinator catches up on what it missed
        dbs = [runner.nodes[n].app.db for n in MODEB_IDS]
        if dbs[0] == dbs[1] == dbs[2]:
            break
        drain += 1
        check(drain <= 400, f"modeb-wal chaos: DBs differ after {drain} "
              "drain ticks")
        runner.run(1)
    runner.ledger.assert_safe()
    ok = [p for p in runner.proposals if p["resp"] == "OK"]
    check(len(ok) >= 7, f"modeb-wal chaos: {len(ok)} of 9 proposals OK")
    rec = [r for r in runner.log.records if r["action"] == "recover"]
    check(rec and rec[0].get("info") == {"recovered_degraded": False},
          f"modeb-wal chaos: recover record {rec}")
    out = {"rows": G, "groups": groups, "ticks": ticks, "drain_ticks": drain,
           "s": time.perf_counter() - t0, "proposals_ok": len(ok),
           "ledger_observations": runner.ledger.observations,
           "replayed_ticks": replay["ticks"], "replay_s": replay["s"]}
    acked = {("svc", p["payload"].split()[1]): p["payload"].split()[2]
             for p in ok}

    # ---- N2 crashes and its journal is scribbled: a degraded recovery
    nodes = runner.nodes

    def spin(only=MODEB_IDS):
        for m in only:
            nodes[m].tick()
        net.pump()

    nodes["N2"].m.close()
    net.drop_pending(dst="N2")
    net.drop_pending(src="N2")
    for m in ("N0", "N1"):
        nodes[m].set_alive(2, False)
    done = {}
    for i in range(1, gap + 1):
        nodes["N0"].propose(names[i], f"PUT d d{i}".encode(),
                            lambda _r, x, i=i: done.__setitem__(i, x))
    rounds = 0
    while len(done) < gap:
        spin(("N0", "N1"))
        rounds += 1
        check(rounds <= 200, f"modeb-wal degraded: {len(done)} of {gap} "
              "PUTs answered while N2 was down")
    check(all(x == b"OK" for x in done.values()),
          "modeb-wal degraded: a PUT failed")
    acked.update({(names[i], "d"): f"d{i}" for i in done})
    path = faultdisk.newest_journal(dirs["N2"])
    off = faultdisk.flip_byte(path, os.path.getsize(path) // 2,
                              rng=random.Random(0))
    check(scan_journal(path).kind == "scribble",
          "modeb-wal: the flipped journal does not scan as a scribble")
    with open(path, "rb") as f:
        damaged = f.read()
    n2, replayed, secs = recover("N2", allow_degraded=True)
    check(getattr(n2, "recovered_degraded", False),
          "modeb-wal: the damaged journal did not degrade recovery")
    with open(path + ".quarantined", "rb") as f:
        check(f.read() == damaged, "modeb-wal: the quarantined journal "
              "differs from the damaged one")
    tainted = len(n2._tainted_rows)
    check(tainted == groups, f"modeb-wal degraded: {tainted} rows tainted")
    nodes["N2"] = n2
    for m in ("N0", "N1"):
        nodes[m].set_alive(2, True)
    n2.request_sync()
    t0 = time.perf_counter()
    rounds = 0
    while n2._tainted_rows:
        spin()
        rounds += 1
        check(rounds <= 3000, f"modeb-wal degraded: {len(n2._tainted_rows)}"
              " rows still tainted")
    clear_s = time.perf_counter() - t0
    for _ in range(4):
        spin()
    live_l.end("modeb-wal chaos and degraded live ticks", live["ticks"])
    _read_back(nodes, acked, "modeb-wal after the degraded recovery")
    for n in nodes.values():
        n.wal.close()
    out["degraded"] = {
        "groups_tainted": tainted, "flipped_offset": off,
        "ticks_replayed": replayed, "recover_s": secs,
        "taint_clear_rounds": rounds, "taint_clear_s": clear_s,
        "ckpt_transfers": n2.stats["ckpt_transfers"],
        "acked_read_back": len(acked)}
    return out


def modeb_wal_leg(torch, pg, dev, work, G=1 << 17, hot=1 << 14,
                  gap=1 << 12, ae=64, chaos_ticks=300, chaos_groups=1 << 12,
                  count=None):
    """``modeb-wal-128k``: three ``ModeBNode``s on loopback ``Messenger``s,
    each with its own [3, 4, G] state on ``dev`` (W=4, P=4), a ``KVApp``
    and a ``ModeBLogger(native=True)`` as ``ModeBServer`` gives it (an
    fsync every tick, a checkpoint every 1,024 ticks); anti-entropy every
    ``ae`` ticks (the node's default).  Bulk create of G groups, election,
    a hot wave (one PUT on each of ``hot`` groups at N0), a forced
    checkpoint, the crash of N2 (its state copied to the host after its
    last fsync), a gap wave of ``gap`` PUTs while it is down, its recovery
    with a ``PeerCheckpointStreamer`` over N0 and N1 (the replayed state
    held equal to the copy, field by field) and its rejoin; then three
    durable nodes of G rows and ``chaos_groups`` groups on ``SimNet``: a
    ``SimChaosRunner`` coordinator crash with real restarts, and a
    degraded recovery (see ``_modeb_wal_chaos``).  ``count`` (default: on
    a CUDA device) checks 5 gathers + 1 match per live and per replayed
    node tick."""
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.modeb import (ModeBLogger, ModeBNode,
                                           PeerCheckpointStreamer,
                                           recover_modeb)
    from gigapaxos_tpu_torch.modeb.logger import OP_FRAME
    from gigapaxos_tpu_torch.net.messenger import Messenger, NodeMap
    from gigapaxos_tpu_torch.paxos import state as st
    from gigapaxos_tpu_torch.wal.logger import OP_TICK

    count = dev.type == "cuda" if count is None else count
    live_l = _Launches(pg, count)
    replay_l = _Launches(pg, count)
    cfg = modeb_cfg(G)
    W, P = cfg.paxos.window, cfg.paxos.proposals_per_tick
    dirs = {n: os.path.join(work, n) for n in MODEB_IDS}
    nodemap = NodeMap()
    msgs, nodes = {}, {}
    tally = {n: {} for n in MODEB_IDS}
    fsync_ms, ckpt_ms = [], []

    def messenger(nid):
        msgs[nid] = Messenger(nid, ("127.0.0.1", 0), nodemap)
        nodemap.add(nid, "127.0.0.1", msgs[nid].port)
        return msgs[nid]

    def instrument(nid, n):
        _journal_tally(n.wal, tally[nid])
        _timed(n.wal, "log_inbox", fsync_ms)
        _timed(n.wal, "checkpoint", ckpt_ms)
        return n

    for nid in MODEB_IDS:
        messenger(nid)
    out = {"G": G, "W": W, "P": P, "anti_entropy_every": ae,
           "sync_every_ticks": 1, "checkpoint_every_ticks": 1024}
    try:
        for nid in MODEB_IDS:
            nodes[nid] = instrument(nid, ModeBNode(
                cfg, list(MODEB_IDS), nid, KVApp(), msgs[nid],
                wal=ModeBLogger(dirs[nid], native=True),
                anti_entropy_every=ae, device=dev))
        check(all(n.wal.backend == "native" for n in nodes.values()),
              "modeb-wal: the native journal did not open")
        run = _ModeBRun(nodes)
        ticks = {"n": 0}  # node ticks of the live path (crashes included)
        spin = run.spin

        def counted_spin(k=1, only=None):
            for _ in range(k):
                ticks["n"] += sum(1 for m in nodes
                                  if only is None or m in only)
                spin(1, only=only)

        run.spin = counted_spin
        names = [f"g{i}" for i in range(G)]
        t0 = time.perf_counter()
        for n in nodes.values():
            check(n.create_groups_bulk(names, [0, 1, 2]) == G,
                  "modeb-wal: bulk create")
        out["create_bulk_s"] = time.perf_counter() - t0
        live_l.begin()
        t_before = ticks["n"]
        t0 = time.perf_counter()
        rounds = 0
        while not all((n._coord_view == 0).all() for n in nodes.values()):
            run.spin(1)
            rounds += 1
            check(rounds <= 400, "modeb-wal: election did not finish")
        out["elect"] = {"rounds": rounds, "s": time.perf_counter() - t0}
        acked = {}

        def wave(at, sel, key, tag, only=None):
            payloads = [f"PUT {key} {tag}{i}".encode() for i in sel]
            got, r, s = run.wave(at, [names[i] for i in sel], payloads,
                                 400, only=only, tag=f"modeb-wal {tag}")
            check(len(got) == len(sel), f"modeb-wal {tag}: lost answers")
            for i in sel:
                acked[(names[i], key)] = f"{tag}{i}"
            return r, s

        for t in tally.values():
            t.clear()
        fsync_ms.clear()
        run.tick_ms.clear()
        t_hot = ticks["n"]
        hot_rounds, hot_s = wave("N0", range(hot), "h", "h")
        hot_ticks = ticks["n"] - t_hot
        tick_b = sum(t.get(OP_TICK, 0) for t in tally.values())
        frame_b = sum(t.get(OP_FRAME, 0) for t in tally.values())
        all_b = sum(sum(t.values()) for t in tally.values())
        out["hot"] = {"commits": hot, "rounds": hot_rounds, "s": hot_s,
                      "commits_per_s": hot / hot_s,
                      "node_tick_ms_p50": _pct(run.tick_ms, 0.5),
                      "node_tick_ms_p99": _pct(run.tick_ms, 0.99)}
        out["journal"] = {
            "bytes_per_node_tick": all_b / hot_ticks,
            "op_tick_bytes_per_node_tick": tick_b / hot_ticks,
            "op_frame_bytes_per_node_tick": frame_b / hot_ticks,
            "bytes_per_request": all_b / hot,
            "wal_fsync_ms_p50": _pct(fsync_ms, 0.5),
            "wal_fsync_ms_p99": _pct(fsync_ms, 0.99)}
        # a checkpoint inside the next tick of every node (the tick's own
        # maybe_checkpoint), so recovery reads a snapshot, then a tail
        for n in nodes.values():
            n.wal._ticks_since_ckpt = n.wal.checkpoint_every - 1
        run.spin(1)
        check(len(ckpt_ms) == 3, f"modeb-wal: {len(ckpt_ms)} checkpoints")
        snap = sorted(glob.glob(os.path.join(dirs["N2"], "snapshot.*")))
        out["snapshot"] = {"mb": os.path.getsize(snap[-1]) / 1e6,
                           "checkpoint_s_max": max(ckpt_ms) / 1e3}
        run.spin(3)  # a journal tail after the snapshot

        n2_tick = {}

        def quiesce_and_crash(nid):
            """Stop ticking; let N2 take the frames of the last round, tick
            it once more (its last fsync), cut it off and copy its state:
            -> (host state copy, crash time)."""
            n = nodes[nid]
            others = [m for m in MODEB_IDS if m != nid]
            deadline = time.monotonic() + 60
            while not all(n._frame_applied_tick.get(MODEB_IDS.index(m))
                          == nodes[m].tick_num for m in others):
                check(time.monotonic() < deadline,
                      f"modeb-wal: {nid} never got the last frames")
                time.sleep(0.005)
            n.tick()
            ticks["n"] += 1
            msgs[nid].close()
            t_crash = time.perf_counter()
            with n.lock:
                copy = st.state_to_numpy(n.state)
                n2_tick["n"] = n.tick_num
            del nodes[nid]
            for m in others:
                nodes[m].set_alive(MODEB_IDS.index(nid), False)
                nodes[m].m.transport.reset_peer(nid)
            return copy, t_crash

        pre, t_crash = quiesce_and_crash("N2")
        pre_tick = n2_tick["n"]
        live_l.end("modeb-wal live ticks before the crash",
                   ticks["n"] - t_before)
        gap_sel = range(hot, hot + gap)
        live_l.begin()
        t_gap = ticks["n"]
        wave("N0", gap_sel, "g", "gap", only=("N0", "N1"))
        live_l.end("modeb-wal gap wave", ticks["n"] - t_gap)

        def recover():
            """Recover N2 with a stream over N0 and N1 (its fetches overlap
            the replay); -> (node, stream, replay probe, seconds, replayed
            state, sub-timings)."""
            ps = PeerCheckpointStreamer(
                {m: nodes[m].donate_ckpt for m in ("N0", "N1")}, window=4)
            # the replayed state, before the stream's blobs are adopted
            replayed, marks = {}, {}
            adopt, worker = ps.apply, ps._worker

            def apply(node):
                marks["adopt_start"] = time.perf_counter()
                replayed["state"] = st.state_to_numpy(node.state)
                replayed["tick_num"] = node.tick_num
                return adopt(node)

            def timed_worker():
                worker()
                marks["fetch_end"] = max(marks.get("fetch_end", 0.0),
                                         time.perf_counter())

            ps.apply, ps._worker = apply, timed_worker
            replay_l.begin()
            t0 = time.perf_counter()
            with _ReplayProbe(torch, dev) as probe:
                n2 = recover_modeb(cfg, list(MODEB_IDS), "N2", KVApp(),
                                   dirs["N2"], native=True, peer_stream=ps,
                                   device=dev)
            rec_s = time.perf_counter() - t0
            marks = {k: v - t0 for k, v in marks.items()}
            replay_l.end("modeb-wal replay", len(probe.copy_ms))
            check(ps.stats["failed"] == 0, f"modeb-wal: stream {ps.stats}")
            return n2, ps, probe, rec_s, replayed, marks

        def rejoin(n2, what, t_crash):
            """Attach, request_sync, a probe PUT at N2 (first served), then
            every gap-wave group on N2 (full service)."""
            nodes["N2"] = instrument("N2", n2)
            n2.attach_messenger(messenger("N2"))
            for m in ("N0", "N1"):
                nodes[m].set_alive(2, True)
            n2.request_sync()
            live_l.begin()
            t_live = ticks["n"]
            pr, _ = wave("N2", [G - 1], "p", f"probe-{what}-")
            first = time.perf_counter() - t_crash
            rounds = 0
            while any(n2.app.db.get(names[i], {}).get("g") != f"gap{i}"
                      for i in gap_sel):
                run.spin(1)
                rounds += 1
                check(rounds <= 400, f"modeb-wal {what}: N2 never served "
                      "the gap wave")
            full = time.perf_counter() - t_crash
            run.spin(4)
            live_l.end(f"modeb-wal after {what}", ticks["n"] - t_live)
            _read_back(nodes, acked, f"modeb-wal after {what}")
            return {"crash_to_first_served_s": first,
                    "crash_to_full_service_s": full,
                    "probe_rounds": pr, "full_service_rounds": rounds}

        # ---- recovery 1: snapshot + journal tail, with the peer stream
        n2, ps, probe, rec_s, replayed, marks = recover()
        check(replayed["tick_num"] == pre_tick, "modeb-wal replay: tick "
              f"{replayed['tick_num']}, crashed at {pre_tick}")
        _same_state(pre, replayed["state"], "modeb-wal replay")
        out["recovery"] = {
            "ticks_replayed": len(probe.copy_ms), "recover_s": rec_s,
            "packed_copy_ms_per_replayed_tick": (
                statistics.median(probe.copy_ms) if probe.copy_ms
                else None),
            "stream": dict(ps.stats), "stream_marks_s": marks,
            **rejoin(n2, "recovery", t_crash)}
        out["acked"] = len(acked)
    finally:
        for m in msgs.values():
            m.close()
        # under each node's lock: a frame still arriving on a messenger
        # thread appends to the journal under it, and must never meet a
        # closed (freed) native journal
        for n in nodes.values():
            with n.lock:
                n.wal.close()
    # ---- the chaos run: three durable nodes on SimNet
    with _ReplayProbe(torch, dev) as probe:
        out["chaos"] = _modeb_wal_chaos(
            torch, dev, G, min(G, chaos_groups), work, chaos_ticks, ae,
            live_l, replay_l, probe, gap=min(gap, chaos_groups - 1))
    out["live_node_ticks"] = live_l.ticks
    out["replayed_node_ticks"] = replay_l.ticks
    out["launches"] = live_l.result()
    out["replay_launches"] = replay_l.result()
    return out


def modeb_phase(torch, pg, dev, G_1m=1 << 20, hot=1 << 14, laggard=1 << 16,
                ae_1m=32, G_fast=1 << 17, busy_fast=4096, G_dev=1 << 17,
                busy_dev=4096, dev_ticks=16, cpu_ticks=3, G_wal=1 << 17,
                hot_wal=1 << 14, gap_wal=1 << 12, chaos_groups=1 << 10):
    """The four Mode B legs; each Mode B path's launches in ``launches``
    (``modeb``: the 1M leg, the fast leg's classical half and the device
    leg; ``modeb_fast``: the fast leg's fast half; ``modeb_wal`` and
    ``modeb_replay``: the durable leg's live and replayed node ticks)."""
    t0 = time.perf_counter()
    # anti-entropy every 32 for the run's time (the births wait one
    # cycle: 68 rounds, 55.3-85.8 s, at 64 on an H100)
    out = {"modeb-1M": modeb_1m_leg(torch, pg, dev, G_1m, hot=hot,
                                    laggard=laggard, cpu_ticks=cpu_ticks,
                                    ae=ae_1m)}
    out["modeb-fast"] = modeb_fast_leg(torch, pg, dev, G_fast, busy_fast)
    out["modeb-device-128k"] = modeb_device_leg(torch, pg, dev, G_dev,
                                                busy_dev, dev_ticks)
    work = tempfile.mkdtemp(prefix="chip_smoke_modeb_wal_")
    try:
        t1 = time.perf_counter()
        # chaos groups cut from 2^12 for the run's time (the degraded
        # recovery's taint repair took 512 rounds, 45.4 s, on an H100)
        wal = modeb_wal_leg(torch, pg, dev, work, G_wal, hot_wal, gap_wal,
                            chaos_groups=chaos_groups)
        wal["leg_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the same hot wave's rate without a journal, at 2^20 rows
    wal["hot"]["modeb_1m_commits_per_s_without_journal"] = (
        out["modeb-1M"]["hot"]["commits_per_s"])
    out["modeb-wal-128k"] = wal
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------- chain Mode B and the servers

CHAIN_IDS = ("C0", "C1", "C2")


class _ChainReplayProbe:
    """Counts the replayed chain node ticks of a recovery that runs on this
    thread: ``recover_chain_modeb``'s replayed tick ends in
    ``unpack_chain_node_tick``, and live ticks on other threads (a
    server's tick drivers) are not counted."""

    def __init__(self):
        from gigapaxos_tpu_torch.chain import modeb as cm

        self.cm, self.inner = cm, cm.unpack_chain_node_tick
        self.me = threading.get_ident()
        self.ticks = 0

    def __enter__(self):
        def counted(*a):
            if threading.get_ident() == self.me:
                self.ticks += 1
            return self.inner(*a)

        self.cm.unpack_chain_node_tick = counted
        return self

    def __exit__(self, *exc):
        self.cm.unpack_chain_node_tick = self.inner


def _same_chain_state(a_np, b_np, what):
    from gigapaxos_tpu_torch.chain import state as cst

    for f, a, b in zip(cst.ChainState._fields, a_np, b_np):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"{what}: field {f} differs from the pre-crash copy")


def _progress(leg, what, **kw):
    """One progress line of a leg (its numbers so far, so a later failure
    still leaves them in the log)."""
    print(f"{leg}: {what} " + json.dumps(kw, default=str), flush=True)


def chain_modeb_leg(torch, pg, dev, work, G=1 << 17, n_chains=None,
                    hot=1 << 14, rounds=4, crash_after=2, outage=1 << 10,
                    ae=64, cpu_ticks=3, count=None):
    """``chain-modeb-128k``: the chain deployment ``ModeBServer(
    coordinator="chain")`` builds (``server.py:57-400``), three
    ``ChainModeBNode``s on loopback ``Messenger``s, each with its own
    ``[3, 4, G]`` chain state on ``dev`` (W=4, P=4), a ``KVApp`` and a
    ``ChainBLogger(native=True)`` (an fsync a tick), anti-entropy every
    ``ae`` ticks.  ``n_chains`` chains ``[0, 1, 2]`` (default G) created on
    every node one ``create_group`` a name (the three nodes in parallel),
    then a checkpoint.  A hot wave of ``rounds`` rounds: one PUT on each
    of ``hot`` chains a round entering at node ``i % 3`` (two thirds
    forwarded to the head, C0).  After ``crash_after`` rounds the tail C2
    crashes at a tick boundary with no frame in flight (after
    ``tests/test_chain_modeb.py:146-158``): the commit point moves to C1
    and the other rounds commit on C0 and C1, on the first ``outage``
    chains (a depth cut: C2 never saw those requests' payloads, so it
    repairs each such chain by a checkpoint transfer, 16 a tick, as the
    reference does); C2 recovers with
    ``recover_chain_modeb`` (its replayed state held equal to its
    pre-crash copy, field by field), rejoins with ``request_sync()`` and
    serves; every acked PUT reads back at every node.  C0's first
    ``cpu_ticks`` node ticks are held against the CPU.  ``count``
    (default: on a CUDA device) checks 1 gather and no match per live and
    per replayed node tick."""
    from gigapaxos_tpu_torch.chain import modeb as cm
    from gigapaxos_tpu_torch.chain import state as cst
    from gigapaxos_tpu_torch.chain.modeb_logger import (ChainBLogger,
                                                        recover_chain_modeb)
    from gigapaxos_tpu_torch.chain.tick import ChainInbox
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.modeb.logger import OP_FRAME
    from gigapaxos_tpu_torch.net.messenger import Messenger, NodeMap
    from gigapaxos_tpu_torch.wal.logger import OP_TICK

    count = dev.type == "cuda" if count is None else count
    n_chains = G if n_chains is None else n_chains
    live_l = _Launches(pg, count, gathers=1, matches=0)
    replay_l = _Launches(pg, count, gathers=1, matches=0)
    cfg = modeb_cfg(G)
    W, P = cfg.paxos.window, cfg.paxos.proposals_per_tick
    dirs = {n: os.path.join(work, n) for n in CHAIN_IDS}
    nodemap = NodeMap()
    msgs, nodes = {}, {}
    tally = {n: {} for n in CHAIN_IDS}
    fsync_ms = []

    def messenger(nid):
        msgs[nid] = Messenger(nid, ("127.0.0.1", 0), nodemap)
        nodemap.add(nid, "127.0.0.1", msgs[nid].port)
        return msgs[nid]

    def instrument(nid, n):
        _journal_tally(n.wal, tally[nid])
        _timed(n.wal, "log_inbox", fsync_ms)
        return n

    for nid in CHAIN_IDS:
        messenger(nid)
    out = {"G": G, "W": W, "P": P, "chains": n_chains,
           "anti_entropy_every": ae, "sync_every_ticks": 1}
    try:
        for nid in CHAIN_IDS:
            nodes[nid] = instrument(nid, cm.ChainModeBNode(
                cfg, list(CHAIN_IDS), nid, KVApp(), msgs[nid],
                wal=ChainBLogger(dirs[nid], native=True),
                anti_entropy_every=ae, device=dev))
        check(all(n.wal.backend == "native" for n in nodes.values()),
              "chain-modeb: the native journal did not open")
        c0 = nodes["C0"]
        probe = {"k": 0, "cpu_equal": 0}
        inner = c0._tick_packed

        def packed(state, inbox):
            k = probe["k"]
            probe["k"] += 1
            before = None
            if k < cpu_ticks:
                before = (cst.ChainState(*(t.cpu().clone() for t in state)),
                          ChainInbox(*(t.cpu().clone() for t in inbox)))
            new, flat = inner(state, inbox)
            if before is not None:
                cs, cflat = cm.chain_node_tick_packed(c0.r)(*before)
                check(torch.equal(cflat, flat.cpu()), f"chain-modeb: C0 "
                      f"tick {k}'s packed outbox differs from the CPU's")
                for f, a, b in zip(cst.ChainState._fields, new, cs):
                    check(torch.equal(a.cpu(), b), f"chain-modeb: C0 tick "
                          f"{k} field {f} differs from the CPU's")
                probe["cpu_equal"] += 1
            return new, flat

        c0._tick_packed = packed
        names = [f"c{i}" for i in range(n_chains)]
        errors = []

        def create_all(n):
            try:
                made = sum(n.create_group(nm, [0, 1, 2]) for nm in names)
                if made != n_chains:
                    errors.append(f"{n.node_id} created {made}")
            except Exception as e:  # surfaced by the check below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=create_all, args=(n,))
                   for n in nodes.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["create_s"] = time.perf_counter() - t0
        check(not errors, f"chain-modeb create: {errors}")
        out["creates_per_s_per_node"] = n_chains / out["create_s"]
        # a deployment past its first checkpoint: recovery reads the
        # snapshot instead of replaying every create one by one
        t0 = time.perf_counter()
        for n in nodes.values():
            n.wal.checkpoint()
        out["checkpoint_s"] = time.perf_counter() - t0
        _progress("chain-modeb-128k", "created", create_s=out["create_s"],
                  checkpoint_s=out["checkpoint_s"])
        run = _ModeBRun(nodes)
        ticks = {"n": 0}
        spin = run.spin

        def counted_spin(k=1, only=None):
            for _ in range(k):
                ticks["n"] += sum(1 for m in nodes
                                  if only is None or m in only)
                spin(1, only=only)

        run.spin = counted_spin
        live_l.begin()
        t_live = 0
        run.spin(4)  # the full frames of the creates reach every node
        acked = {}
        hot_names = names[:hot]

        def quiesce_and_crash(nid):
            """Let ``nid`` take the frames of the last round, tick it once
            more (its last fsync), cut it off and copy its state."""
            n = nodes[nid]
            others = [m for m in CHAIN_IDS if m != nid]
            deadline = time.monotonic() + 60
            while not all(n._frame_applied_tick.get(CHAIN_IDS.index(m))
                          == nodes[m].tick_num for m in others):
                check(time.monotonic() < deadline,
                      f"chain-modeb: {nid} never got the last frames")
                time.sleep(0.005)
            n.tick()
            ticks["n"] += 1
            msgs[nid].close()
            t_crash = time.perf_counter()
            with n.lock:
                copy = cst.state_to_numpy(n.state)
                tick_num = n.tick_num
                n.wal.close()
            del nodes[nid]
            for m in others:
                nodes[m].set_alive(CHAIN_IDS.index(nid), False)
                nodes[m].m.transport.reset_peer(nid)
            return copy, tick_num, t_crash

        for t in tally.values():
            t.clear()
        fsync_ms.clear()
        run.tick_ms.clear()
        wave_nodes = dict(nodes)  # the crashed C2 keeps its own stats
        fb0 = {nid: n.stats["frame_bytes"] for nid, n in nodes.items()}
        wave_s, wave_ticks, round_rounds, commits = 0.0, 0, [], 0
        pre = None
        for rnd in range(rounds):
            if rnd == crash_after:
                pre, pre_tick, t_crash = quiesce_and_crash("C2")
                tail = nodes["C0"]._live_tail_of(nodes["C0"].rows.row(
                    hot_names[0]))
                check(tail == 1, f"chain-modeb: the live tail is {tail} "
                      "after C2's crash, not C1")
            done = {}
            t_round, k_round = time.perf_counter(), ticks["n"]
            sel = hot_names if pre is None else hot_names[:outage]
            for i, nm in enumerate(sel):
                at = CHAIN_IDS[i % 3]
                at = at if at in nodes else "C1"
                rid = nodes[at].propose(
                    nm, f"PUT r{rnd} v{rnd}-{i}".encode(),
                    lambda _r, resp, i=i: done.__setitem__(i, resp))
                check(rid is not None, f"chain-modeb: propose refused on {nm}")
            spins = 0
            while len(done) < len(sel):
                run.spin(1)
                spins += 1
                check(spins <= 400, f"chain-modeb round {rnd}: {len(done)} "
                      f"of {len(sel)} answered after 400 rounds")
            wave_s += time.perf_counter() - t_round
            wave_ticks += ticks["n"] - k_round
            round_rounds.append(spins)
            commits += len(sel)
            check(all(r == b"OK" for r in done.values()),
                  f"chain-modeb round {rnd}: a PUT failed")
            for i, nm in enumerate(sel):
                acked[(nm, f"r{rnd}")] = f"v{rnd}-{i}"
            _progress("chain-modeb-128k", f"round {rnd}", commits=len(sel),
                      spins=spins, s=time.perf_counter() - t_round,
                      tick_ms_p50=_pct(run.tick_ms, 0.5))
        frame_b = sum(n.stats["frame_bytes"] - fb0[nid]
                      for nid, n in wave_nodes.items())
        tick_b = sum(t.get(OP_TICK, 0) for t in tally.values())
        jframe_b = sum(t.get(OP_FRAME, 0) for t in tally.values())
        all_b = sum(sum(t.values()) for t in tally.values())
        out["wave"] = {
            "rounds": rounds, "chains": hot, "outage_chains": outage,
            "commits": commits, "crash_after_round": crash_after,
            "s": wave_s, "commits_per_s": commits / wave_s,
            "node_ticks": wave_ticks, "spins_per_round": round_rounds,
            "node_tick_ms_p50": _pct(run.tick_ms, 0.5),
            "node_tick_ms_p99": _pct(run.tick_ms, 0.99),
            "frame_bytes_per_node_tick": frame_b / wave_ticks}
        out["journal"] = {
            "bytes_per_node_tick": all_b / wave_ticks,
            "op_tick_bytes_per_node_tick": tick_b / wave_ticks,
            "op_frame_bytes_per_node_tick": jframe_b / wave_ticks,
            "bytes_per_request": all_b / commits,
            "wal_fsync_ms_p50": _pct(fsync_ms, 0.5),
            "wal_fsync_ms_p99": _pct(fsync_ms, 0.99)}
        live_l.end("chain-modeb live ticks", ticks["n"] - t_live)

        # ---- C2 recovers from its own journal and rejoins
        replay_l.begin()
        t0 = time.perf_counter()
        with _ChainReplayProbe() as rp:
            c2 = recover_chain_modeb(cfg, list(CHAIN_IDS), "C2", KVApp(),
                                     dirs["C2"], native=True, device=dev)
        replay_s = time.perf_counter() - t0
        _progress("chain-modeb-128k", "recovered", replay_s=replay_s,
                  ticks=rp.ticks)
        replay_l.end("chain-modeb replay", rp.ticks)
        check(c2.tick_num == pre_tick, f"chain-modeb replay: tick "
              f"{c2.tick_num}, crashed at {pre_tick}")
        _same_chain_state(pre, cst.state_to_numpy(c2.state),
                          "chain-modeb replay")
        # the survivors' transports drop what they queued for C2 over the
        # outage (their retries exhausted, as in a long outage): C2 learns
        # the outage rounds from ring copies and checkpoint transfers
        for m in ("C0", "C1"):
            nodes[m].m.transport.reset_peer("C2")
        nodes["C2"] = instrument("C2", c2)
        c2.attach_messenger(messenger("C2"))
        for m in ("C0", "C1"):
            nodes[m].set_alive(2, True)
        c2.request_sync()
        live_l.begin()
        t_live = ticks["n"]
        first = {}
        c2.propose(names[-1], b"PUT p probe",
                   lambda _r, resp: first.__setitem__("resp", resp))
        spins = 0
        while "resp" not in first:
            run.spin(1)
            spins += 1
            check(spins <= 400, "chain-modeb: C2 never served its probe")
        check(first["resp"] == b"OK", f"chain-modeb probe: {first}")
        first_s = time.perf_counter() - t_crash
        acked[(names[-1], "p")] = "probe"
        _progress("chain-modeb-128k", "first served",
                  s=time.perf_counter() - t_crash)
        spins = 0
        db = c2.app.db
        while any(db.get(k[0], {}).get(k[1]) != v for k, v in acked.items()):
            run.spin(1)
            spins += 1
            check(spins <= 400, f"chain-modeb: C2 never caught up "
                  f"({len(c2._tainted_rows)} rows tainted)")
        full_s = time.perf_counter() - t_crash
        run.spin(2)
        live_l.end("chain-modeb after the recovery", ticks["n"] - t_live)
        _read_back(nodes, acked, "chain-modeb")
        out["recovery"] = {
            "ticks_replayed": rp.ticks, "replay_s": replay_s,
            "crash_to_first_served_s": first_s,
            "crash_to_full_service_s": full_s, "catch_up_rounds": spins,
            "ckpt_transfers": c2.stats["ckpt_transfers"],
            "orphan_execs": c2.stats["orphan_execs"]}
        check(probe["cpu_equal"] == cpu_ticks, "chain-modeb: CPU ticks held")
        out["cpu_ticks_equal"] = probe["cpu_equal"]
        out["acked"] = len(acked)
        out["host_ms_per_node_tick_by_phase"] = {
            nid: host_phases(nid) for nid in CHAIN_IDS}
    finally:
        for m in msgs.values():
            m.close()
        for n in list(nodes.values()):
            with n.lock:
                if n.wal is not None:
                    n.wal.close()
    out["live_node_ticks"] = live_l.ticks
    out["replayed_node_ticks"] = replay_l.ticks
    out["launches"] = live_l.result()
    out["replay_launches"] = replay_l.result()
    return out


SERVER_ACTIVES = ("AR0", "AR1", "AR2")
SERVER_RCS = ("RC0", "RC1", "RC2")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def server_cfg(G):
    """``ModeBServer``'s deployment as a properties file gives it: 3
    actives and 3 reconfigurators at fixed loopback ports, ``G`` rows a
    plane, the defaults otherwise (W=4, P=4, the failure detector's 0.1 s
    pings and 3 s timeout, the native journal)."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    for nid in SERVER_ACTIVES:
        cfg.nodes.actives[nid] = ("127.0.0.1", _free_port())
    for nid in SERVER_RCS:
        cfg.nodes.reconfigurators[nid] = ("127.0.0.1", _free_port())
    return cfg


def _tick_hist():
    """(count, total seconds) of every plane's ``tick_seconds`` series, by
    (driver, plane)."""
    from gigapaxos_tpu_torch.obs.metrics import registry

    out = {}
    for h in registry().find("tick_seconds"):
        lab = dict(h.labels)
        out[(lab.get("driver"), lab.get("plane"))] = (h.count, h.total)
    return out


def _scrape_ok(url):
    """GET ``url``'s ``/metrics`` once: every line parses as 0.0.4 text,
    and ``tick_seconds`` has a ``driver="modeb"`` series.  -> (bytes,
    lines)."""
    import re
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        check(r.status == 200, f"/metrics answered {r.status}")
        body = r.read().decode("utf-8")
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
                        r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*'
                        r'\})? -?(?:[0-9.eE+-]+|Inf|NaN)$')
    lines = body.splitlines()
    bad = [ln for ln in lines if ln and not ln.startswith("# ")
           and not sample.match(ln)]
    check(not bad, f"/metrics: unparseable lines {bad[:3]}")
    check(any(ln.startswith("tick_seconds_count{")
              and 'driver="modeb"' in ln for ln in lines),
          "/metrics: no tick_seconds series of driver modeb")
    return len(body), len(lines)


def server_leg(torch, pg, dev, work, G=1 << 17, n_names=64, batch=16,
               serial=16, n_reconf=4, n_delete=4, coordinator="paxos"):
    """``server-128k`` (``coordinator="paxos"``) and ``server-chain``
    (``"chain"`` on the actives): six ``ModeBServer``s
    (``server.py:57-400``) in this process on loopback ports, 3 actives
    and 3 reconfigurators, ``G`` rows a plane, W=4, P=4, ``KVApp``,
    durable (``log_dir``), failure detectors on, the scrape endpoint on
    AR1, driven through the port's ``ReconfigurableAppClient``.

    Paxos: ``n_names`` names created in batches of ``batch``, one PUT each,
    every name read back (``serial`` of them one at a time for latency),
    ``n_reconf`` reconfigurations (a name shrunk to two actives, then
    grown back, for each pair) and ``n_delete`` deletes; then AR0, the coordinator of
    every three-member name, closes, and a PUT commits on the survivors
    once their failure detectors alone declare it dead; AR0 re-opens from
    its log dir (``recover_modeb``) and serves; every name reads back; one
    ``/metrics`` scrape.  Chain: ``n_names`` names, a PUT and a read
    through every member, then AR2 (every chain's tail) closes and
    re-opens from its log dir (``recover_chain_modeb``), and every name
    reads back.  Counted: every live and replayed node tick of every
    plane, 5 gathers + 1 match a Paxos Mode B node tick and 1 gather a
    chain one."""
    import copy

    from gigapaxos_tpu_torch.client import ClientError, ReconfigurableAppClient
    from gigapaxos_tpu_torch.server import ModeBServer

    chain = coordinator == "chain"
    cfg = server_cfg(G)
    http_cfg = copy.deepcopy(cfg)
    http_cfg.obs.http_port = 0
    out = {"G": G, "W": cfg.paxos.window, "P": cfg.paxos.proposals_per_tick,
           "actives": len(SERVER_ACTIVES), "reconfigurators": len(SERVER_RCS),
           "coordinator": coordinator, "names": n_names}
    hist0 = _tick_hist()
    pg.reset_launches()
    replayed = {"modeb": 0, "chain_modeb": 0}
    srv = {}

    def boot(nid):
        kind = coordinator if nid in SERVER_ACTIVES else "paxos"
        return ModeBServer(nid, http_cfg if nid == "AR1" else cfg,
                           log_dir=work, coordinator=kind, device=dev)

    def request_via(client, name, payload, active, timeout):
        """One request through ``active``, asked again while it answers
        ``not_active``, or nothing at all."""
        from gigapaxos_tpu_torch.reconfiguration import packets as pkt

        deadline = time.monotonic() + timeout
        box = {}
        while time.monotonic() < deadline:
            done = threading.Event()
            box = {}

            def cb(resp, box=box, done=done):
                box.update(resp)
                done.set()

            client.send_request(name, payload, cb, active=active)
            # a send on a link whose peer re-opened can vanish: ask again
            # after 3 s (a duplicate PUT writes the same value)
            if not done.wait(min(3.0, max(deadline - time.monotonic(),
                                          0.5))):
                continue
            if box.get("ok"):
                return pkt.b64d(box.get("response")) or b""
            if box.get("error") not in ("not_active", "stopped"):
                break
            time.sleep(0.1)
        raise SmokeFailure(f"server: request via {active} failed: {box}")

    t_start = time.perf_counter()
    client = None
    try:
        for nid in SERVER_ACTIVES + SERVER_RCS:
            srv[nid] = boot(nid)
        for nid, s in srv.items():
            check(s.wait_ready(300), f"server {nid} never ticked")
            for n in (s.node, s.rc_node):
                if n is not None:
                    check(n.state.applied.device.type == dev.type
                          if chain and n is s.node else
                          n.state.exec_slot.device.type == dev.type,
                          f"server {nid}: a plane is not on {dev}")
        out["boot_s"] = time.perf_counter() - t_start
        client = ReconfigurableAppClient(cfg.nodes)
        names = [f"s{i}" for i in range(n_names)]
        value = {n: f"{n}-v1" for n in names}
        t0 = time.perf_counter()
        for k in range(0, n_names, batch):
            resp = client.create_batch(names[k:k + batch], timeout=120)
            check(resp["ok"], f"server create batch at {k}: "
                  f"{str(resp)[:300]}")
        out["names_per_s"] = n_names / (time.perf_counter() - t0)
        # a create is acked by its primary RC; another RC replica may not
        # have executed it yet, so ask until every name resolves
        deadline = time.monotonic() + 120
        for n in names:
            while True:
                try:
                    client.request_actives(n, force=True)
                    break
                except ClientError:
                    check(time.monotonic() < deadline,
                          f"server: {n} never resolved after its create")
                    time.sleep(0.1)
        _progress(f"server-{coordinator}", "created",
                  s=time.perf_counter() - t_start)

        def put_all(which):
            if chain:  # every chain member takes a write in turn
                for i, n in enumerate(which):
                    got = request_via(client, n, f"PUT k {value[n]}".encode(),
                                      SERVER_ACTIVES[i % 3], 120)
                    check(got == b"OK", f"server PUT {n}: {got!r}")
                return
            got = batch_round(client, [(n, f"PUT k {value[n]}".encode())
                                       for n in which])
            for n, r in zip(which, got):
                if r != b"OK":  # a refused PUT is retried until acked
                    check(client.request(n, f"PUT k {value[n]}".encode(),
                                         timeout=120) == b"OK",
                          f"server PUT {n} not acked")

        def read_all(which, what):
            if chain:
                got = [client.request(n, b"GET k", timeout=120)
                       for n in which]
            else:
                got = batch_round(client, [(n, b"GET k") for n in which])
            for n, r in zip(which, got):
                check(r == value[n].encode(), f"{what}: GET {n} gave {r!r}")

        t0 = time.perf_counter()
        put_all(names)
        out["put_req_per_s"] = n_names / (time.perf_counter() - t0)
        lat = []
        for n in names[:serial]:
            t0 = time.perf_counter()
            r = client.request(n, b"GET k", timeout=120)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(r == value[n].encode(), f"serial GET {n} gave {r!r}")
        out["serial_requests"] = serial
        out["serial_p50_ms"] = float(np.percentile(lat, 50))
        out["serial_p99_ms"] = float(np.percentile(lat, 99))
        read_all(names[serial:], "server read back")
        _progress(f"server-{coordinator}", "read back",
                  s=time.perf_counter() - t_start)
        live = list(names)
        if not chain:
            secs = []
            for j in range(n_reconf):
                n = names[j // 2]
                new = (sorted(set(SERVER_ACTIVES) - {SERVER_ACTIVES[j // 2]})
                       if j % 2 == 0 else sorted(SERVER_ACTIVES))
                t0 = time.perf_counter()
                resp = client.reconfigure(n, new, timeout=120)
                check(resp["ok"], f"reconfigure {n} onto {new}: {resp}")
                deadline = time.monotonic() + 120
                while True:
                    try:  # an RC replica may lag the committed record
                        if sorted(client.request_actives(
                                n, force=True)) == new:
                            break
                    except ClientError:
                        pass
                    check(time.monotonic() < deadline,
                          f"{n} is not on {new} after its reconfiguration")
                    time.sleep(0.1)
                secs.append(time.perf_counter() - t0)
                # a fresh value after the epoch change: a recovered node's
                # app lacks an epoch's seed (ROADMAP, Queue 3)
                value[n] = f"{n}-e{j + 1}"
                check(client.request(n, f"PUT k {value[n]}".encode(),
                                     timeout=120) == b"OK",
                      f"PUT {n} after its reconfiguration")
            out["reconfigurations"] = n_reconf
            out["s_per_reconfiguration"] = statistics.mean(secs)
            _progress(f"server-{coordinator}", "reconfigured",
                      s=time.perf_counter() - t_start)
            gone = names[n_reconf:n_reconf + n_delete]
            ambiguous = 0
            t0 = time.perf_counter()
            for n in gone:
                resp = client.delete(n, timeout=120)
                # a retried delete whose first attempt committed late finds
                # the name gone ("no such name"): the name must not resolve
                ambiguous += not resp["ok"]
                try:
                    client.request_actives(n, force=True)
                    check(False, f"deleted {n} still resolves ({resp})")
                except ClientError:
                    pass
            out["deletes"] = n_delete
            out["s_per_delete"] = (time.perf_counter() - t0) / n_delete
            out["deletes_answered_not_ok"] = ambiguous
            live = [n for n in names if n not in set(gone)]
            out["scrape_bytes"], out["scrape_lines"] = _scrape_ok(
                srv["AR1"].metrics_server.url)
        _progress(f"server-{coordinator}", "served", **out)
        # ---- one active closes, then re-opens from its log dir; a
        # checkpoint first, as a server that ran a while has one
        victim = "AR2" if chain else "AR0"
        vnode = srv[victim].node
        with vnode.lock:
            vnode.wal.checkpoint()
        t_close = time.perf_counter()
        srv.pop(victim).close()
        if not chain:
            # the survivors' failure detectors alone take AR0's groups
            n = live[-1]
            value[n] = f"{n}-failover"
            got = request_via(client, n, f"PUT k {value[n]}".encode(),
                              "AR1", 120)
            check(got == b"OK", f"server failover PUT {n}: {got!r}")
            out["close_to_failover_commit_s"] = (time.perf_counter()
                                                 - t_close)
        t0 = time.perf_counter()
        if chain:
            with _ChainReplayProbe() as rp:
                srv[victim] = boot(victim)
            replayed["chain_modeb"] += rp.ticks
        else:
            with _ReplayProbe(torch, dev) as rp:
                srv[victim] = boot(victim)
            replayed["modeb"] += len(rp.copy_ms)
        check(srv[victim].wait_ready(300), f"{victim} never ticked again")
        out["reopen_s"] = time.perf_counter() - t0
        out["replayed_ticks"] = sum(replayed.values())
        check(srv[victim].node.tick_num > 0, f"{victim} recovered no ticks")
        probe_name = live[-1]
        got = request_via(client, probe_name, b"GET k", victim, 120)
        check(got == value[probe_name].encode(),
              f"{victim} after its re-open: GET {probe_name} gave {got!r}")
        out["close_to_reopened_served_s"] = time.perf_counter() - t_close
        read_all(live, f"server read back after {victim} re-opened")
        out["read_back"] = len(live)
    finally:
        if client is not None:
            client.close()
        for s in srv.values():
            s.close()
    out["s"] = time.perf_counter() - t_start
    hist1 = _tick_hist()
    ticks = {}
    for key, (c, tot) in hist1.items():
        c0, t0 = hist0.get(key, (0, 0.0))
        if key[1] in SERVER_ACTIVES + SERVER_RCS and c > c0:
            ticks[key] = (c - c0, tot - t0)
    pax = sum(c for (d, _p), (c, _t) in ticks.items() if d == "modeb")
    chn = sum(c for (d, _p), (c, _t) in ticks.items() if d == "chain_modeb")
    for plane, ids in (("ar", SERVER_ACTIVES), ("rc", SERVER_RCS)):
        c = sum(v[0] for (d, p), v in ticks.items() if p in ids)
        tot = sum(v[1] for (d, p), v in ticks.items() if p in ids)
        out[f"{plane}_node_ticks"] = c
        out[f"{plane}_ms_per_node_tick"] = tot / c * 1e3 if c else None
    out["replayed"] = dict(replayed)
    out["launches"] = None
    if dev.type == "cuda":
        g = 5 * (pax + replayed["modeb"]) + chn + replayed["chain_modeb"]
        out["launches"] = launches_now(
            pg, f"server ({coordinator}), {pax} + {replayed['modeb']} Paxos "
            f"and {chn} + {replayed['chain_modeb']} chain node ticks",
            {"gather_planes": g, "match_planes": pax + replayed["modeb"]})
    out["host_ms_per_node_tick_by_phase"] = {
        nid: host_phases(nid) for nid in ("AR0", "RC0")}
    return out


def chain_server_phase(torch, pg, dev, G=1 << 17, n_chains=1 << 12,
                       hot=1 << 12, rounds=4, n_names=8, serial=4,
                       n_reconf=2, n_delete=2, chain_names=4):
    """The three legs of the chain Mode B and server slice: the durable
    three-node chain deployment, then six servers with the Paxos
    coordinator and six with chain-coordinated actives.  Depth cuts (a
    first run at 2^17 chains, 64 and 16 names, 16 serial reads, 4
    reconfigurations and 4 deletes took 718 s for the three legs on an
    H100, 700 W; with 2^14 chains, 16 names, 8 serial reads, 2 and 2,
    the whole run took 973.5 s on one machine and was on course for
    1,040 s on another; with the cells, transaction and capacity legs
    1,234 s, so 2^12 chains, 8 names, 4 serial reads and 4 chain names):
    ``n_chains`` chains created and ``hot`` in the
    wave (a create is a journal record and its fsync: 325–491 a second a
    node), ``n_names`` Paxos names
    with ``serial`` serial reads, ``n_reconf`` reconfigurations and
    ``n_delete`` deletes, ``chain_names`` chain names."""
    t0 = time.perf_counter()
    out = {}
    for leg, fn in (
            ("chain-modeb-128k", lambda w: chain_modeb_leg(
                torch, pg, dev, w, G, n_chains=n_chains, hot=hot,
                rounds=rounds)),
            ("server-128k", lambda w: server_leg(
                torch, pg, dev, w, G, n_names=n_names, batch=8,
                serial=serial, n_reconf=n_reconf, n_delete=n_delete)),
            ("server-chain", lambda w: server_leg(
                torch, pg, dev, w, G, n_names=chain_names, serial=serial,
                coordinator="chain"))):
        work = tempfile.mkdtemp(prefix=f"chip_smoke_{leg}_")
        try:
            t1 = time.perf_counter()
            out[leg] = fn(work)
            out[leg]["leg_s"] = time.perf_counter() - t1
        finally:
            shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------- cells, txn, capacity

def _pmap(fn, items, threads=32):
    """``fn`` over ``items`` on ``threads`` threads, results in order; the
    first exception is raised."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=threads) as ex:
        return list(ex.map(fn, items))


def _ms_pcts(lat):
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def _cell_launch_check(pg, dev, what, s0, s1):
    """The launch counts between two ``stats`` replies of one worker
    process: 5 gathers and 1 match a tick of either plane.  -> (ticks,
    launches)."""
    ticks = (s1["tick"] - s0["tick"]) + (s1["rc_tick"] - s0["rc_tick"])
    got = {k: s1["launches"][k] - s0["launches"][k] for k in s1["launches"]}
    if dev.type == "cuda":  # the plain versions run on the CPU
        check(got == {"gather_planes": 5 * ticks, "match_planes": ticks},
              f"{what}: launches {got} over {ticks} plane ticks, expected "
              "5 gathers and 1 match a tick")
    return ticks, got


def cells_leg(torch, pg, dev, work, G=1 << 18, n_cells=4, n_names=512,
              serial=32, n_move=8, pin=True):
    """``cells-1M``: a ``CellSupervisor`` of ``n_cells`` cells (3 actives
    and 1 reconfigurator each, the ``CellsConfig`` defaults; ``G`` rows a
    plane; journaled; every worker's planes on ``dev``), driven through
    ``sup.make_client()``: ``n_names`` creates, a PUT each, every one read
    back, ``serial`` serial GETs; ``n_move`` names moved to another cell
    with ``CellMigrator`` and read back; the owner cell of the first name
    drained, dumped and SIGKILLed while PUTs run on the other cells, the
    supervisor's restart replaying its WAL to the same DB dump and a clean
    S1 ledger over both incarnations; one host scrape.  Each worker's
    ``stats`` reply carries its process's kernel launches: every plane
    tick of every cell launches 5 gathers and 1 match."""
    from gigapaxos_tpu_torch.cells.migrator import CellMigrator
    from gigapaxos_tpu_torch.cells.supervisor import CellSupervisor
    from gigapaxos_tpu_torch.config import CellsConfig
    from gigapaxos_tpu_torch.testing.chaos import SafetyLedger

    out = {"cells": n_cells, "G": G, "groups_on_host": n_cells * G,
           "actives": 3, "reconfigurators": 1, "names": n_names}
    cc = CellsConfig(enabled=True, n_cells=n_cells, n_actives=3,
                     n_reconfigurators=1, pin_cores=pin,
                     restart_backoff_s=0.2)
    t0 = time.perf_counter()
    sup = CellSupervisor(work, cells=cc, paxos_overrides={"max_groups": G},
                         ledger=True, device=str(dev), ready_timeout_s=600)
    try:
        sup.start()
    except RuntimeError as e:  # a startup_failed line, or a dead worker
        print(f"cells: {e}", flush=True)
        raise SmokeFailure(f"cells-1M: a cell did not start: {e}")
    client = sup.make_client()
    try:
        out["alive_s"] = time.perf_counter() - t0
        s0 = {k: h.stats() for k, h in sup.cells.items()}
        names = [f"cn{i}" for i in range(n_names)]
        value = {n: f"{n}-v1" for n in names}

        def create(n):
            return client.create(n, timeout=120).get("ok")

        t1 = time.perf_counter()
        made = _pmap(create, names)
        out["names_per_s"] = n_names / (time.perf_counter() - t1)
        check(all(made), f"{made.count(False)} cell creates failed")

        def put(n):
            return client.request(n, f"PUT k {value[n]}".encode(),
                                  timeout=120)

        t1 = time.perf_counter()
        got = _pmap(put, names)
        out["put_req_per_s"] = n_names / (time.perf_counter() - t1)
        check(all(r == b"OK" for r in got), "a cell PUT was not acked")

        def read_back(what):
            got = _pmap(lambda n: client.request(n, b"GET k", timeout=120),
                        names)
            bad = [n for n, r in zip(names, got) if r != value[n].encode()]
            check(not bad, f"{what}: {len(bad)} names read back wrong, "
                           f"first {bad[:4]}")

        read_back("cells read back")
        lat = []
        for n in names[:serial]:
            t1 = time.perf_counter()
            r = client.request(n, b"GET k", timeout=60)
            lat.append((time.perf_counter() - t1) * 1e3)
            check(r == value[n].encode(), f"serial GET {n} gave {r!r}")
        out["serial_get"] = _ms_pcts(lat)
        per_cell = {k: h.stats()["groups"] for k, h in sup.cells.items()}
        check(sum(per_cell.values()) == n_names,
              f"groups per cell {per_cell} do not sum to {n_names}")
        out["groups_per_cell"] = per_cell

        # cross-cell moves
        mig = CellMigrator(sup, timeout_s=120)
        victim = sup.router.cell(names[0])
        movers = [n for n in names[1:] if sup.router.cell(n) != victim]
        movers = movers[:n_move]
        secs = []
        for n in movers:
            dst = (sup.router.cell(n) + 1) % n_cells
            t1 = time.perf_counter()
            ok = mig.migrate(n, dst)
            secs.append(time.perf_counter() - t1)
            check(ok, f"migration of {n} to cell {dst} aborted")
            check(sup.router.cell(n) == dst, f"{n} not routed to {dst}")
            r = client.request(n, b"GET k", timeout=120)
            check(r == value[n].encode(), f"moved {n} read {r!r}")
            check(any(k.startswith(f"{n}#") for k in sup.cells[dst].db()),
                  f"cell {dst} does not hold {n}")
        out["moves"] = len(movers)
        out["s_per_move"] = statistics.mean(secs)

        # SIGKILL during traffic, restart with WAL replay
        for h in sup.cells.values():
            check(h.rpc("drain", "drained ", 120).endswith("ok"),
                  "a cell did not drain")
        vh = sup.cells[victim]
        s_kill = vh.stats()
        pre_db = [vh.db(r) for r in range(3)]
        pre_ledger = vh.ledger()
        others = [n for n in names if sup.router.cell(n) != victim]
        stop, acked, errors = threading.Event(), [], []

        def traffic():
            i = 0
            while not stop.is_set():
                n = others[i % len(others)]
                try:
                    if client.request(n, f"PUT t{i} x".encode(),
                                      timeout=60) == b"OK":
                        acked.append((n, f"t{i}"))
                except Exception as e:  # counted, and checked below
                    errors.append(repr(e))
                i += 1

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        time.sleep(0.5)
        t_kill = time.perf_counter()
        vh.sigkill()
        nh = sup.wait_cell_alive(victim, 300)
        out["kill_to_alive_s"] = time.perf_counter() - t_kill
        # a request sent into the dead incarnation's connection is lost,
        # and the client retries it only when its try times out: short
        # tries, so that the first one the new incarnation sees is timed
        r, tries = None, 0
        while r is None and time.perf_counter() - t_kill < 300:
            tries += 1
            try:
                r = client.request(names[0], b"GET k", timeout=3)
            except Exception:
                pass
        out["kill_to_served_s"] = time.perf_counter() - t_kill
        out["served_after_tries"] = tries
        check(r == value[names[0]].encode(),
              f"{names[0]} after the restart read {r!r}")
        stop.set()
        th.join(timeout=120)
        check(not errors, f"traffic on the live cells failed: {errors[:3]}")
        out["acked_during_kill"] = len(acked)
        check(sup.restarts[victim] == 1,
              f"restarts {sup.restarts}, expected one of cell {victim}")
        post_db = [nh.db(r) for r in range(3)]
        check(post_db == pre_db, "the restarted cell's DB differs from "
                                 "its dump before the kill")
        post_ledger = nh.ledger()
        led = SafetyLedger()
        for r_, name, slot, rid, _stop in pre_ledger:
            led.observe(f"pre/r{r_}", name, slot, rid)
        for r_, name, slot, rid, _stop in post_ledger:
            led.observe(f"post/r{r_}", name, slot, rid)
        check(led.observations > 0, "the S1 ledger is empty")
        try:
            led.assert_safe()
        except AssertionError as e:
            raise SmokeFailure(f"cells-1M S1 ledger: {e}")
        out["ledger_observations"] = led.observations
        got = _pmap(lambda a: client.request(a[0], f"GET {a[1]}".encode(),
                                             timeout=120), acked)
        check(all(r == b"x" for r in got),
              "a PUT acked during the kill did not read back")
        read_back("cells read back after the moves and the kill")

        t1 = time.perf_counter()
        body = sup.scrape()
        out["scrape_ms"] = (time.perf_counter() - t1) * 1e3
        out["scrape_bytes"] = len(body)
        for k in range(n_cells):
            check(f'cell="{k}"' in body, f"the scrape has no cell {k}")

        # kernel launches a plane tick, from each worker's own counters:
        # the first incarnation of each cell up to the end (the victim up
        # to its kill), the restarted one from its ready line to the end
        s1 = {k: h.stats() for k, h in sup.cells.items()}
        ticks, launches = 0, {"gather_planes": 0, "match_planes": 0}
        spans = [(k, s0[k], s1[k]) for k in s0 if k != victim]
        spans.append((victim, s0[victim], s_kill))
        restarted = s1[victim]
        for k, a, b in spans:
            t, n = _cell_launch_check(pg, dev, f"cell {k}", a, b)
            ticks += t
            for key in launches:
                launches[key] += n[key]
        out["restarted_cell"] = {"cell": victim, "tick": restarted["tick"],
                                 "rc_tick": restarted["rc_tick"],
                                 "launches": restarted["launches"]}
        out["plane_ticks"] = ticks
        out["launches"] = launches
        out["launches_per_plane_tick"] = {
            k: v / max(ticks, 1) for k, v in launches.items()}
    finally:
        client.close()
        sup.stop()
    check(all(not h.alive() for h in sup.cells.values()),
          "a cell worker outlived the supervisor's stop")
    out["seconds"] = time.perf_counter() - t0
    return out


def txn_leg(torch, pg, dev, G=1 << 17, n_tx=2048, n_names=4096,
            hot_names=64, contending=0.25, window=128, seed=7):
    """``txn-128k``: ``DistTransactor`` over a ``PaxosManager`` of ``G``
    rows on ``dev`` (``TxApp(KVApp())`` replicas, a ``TickDriver``):
    ``n_tx`` two-name transactions over ``n_names`` names, a quarter of
    them on pairs drawn from ``hot_names`` shared names (they contend for
    locks), the rest on disjoint pairs, ``window`` in flight.  Each writes
    one key on both names; a committed one must show on both, an aborted
    one on neither, and no lock may be left."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.paxos.driver import TickDriver
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.txn import DistTransactor, TxApp

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    names = [f"tx{i}" for i in range(n_names)]
    t0 = time.perf_counter()
    m = PaxosManager(cfg, 3, [TxApp(KVApp()) for _ in range(3)], device=dev)
    check(m.create_paxos_instances(names, [0, 1, 2]) == n_names,
          "txn: creates failed")
    driver = TickDriver(m).start()
    check(driver.wait_ready(600), "txn: the tick driver never ticked")
    out = {"G": G, "transactions": n_tx, "names": n_names,
           "start_s": time.perf_counter() - t0}
    rng = random.Random(seed)
    n_hot = int(n_tx * contending)
    hot = names[n_names - hot_names:]
    pairs = [tuple(rng.sample(hot, 2)) for _ in range(n_hot)]
    pairs += [(names[2 * i], names[2 * i + 1]) for i in range(n_tx - n_hot)]
    rng.shuffle(pairs)

    def coordinate(name, payload, cb):
        r = m.propose(name, payload, cb)
        driver.kick()
        return r

    tx = DistTransactor(coordinate, retry_delay_s=0.02)
    with m.lock:  # no tick half counted
        pg.reset_launches()
        tick0 = m.tick_num
    results, lat = [None] * n_tx, [0.0] * n_tx
    slots = threading.Semaphore(window)
    done = threading.Event()
    left = [n_tx]
    lock = threading.Lock()

    def finish(i, t_start):
        def cb(res):
            lat[i] = (time.perf_counter() - t_start) * 1e3
            results[i] = res
            slots.release()
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        return cb

    try:
        t1 = time.perf_counter()
        for i, (a, b) in enumerate(pairs):
            slots.acquire()
            tx.transact([(a, f"PUT t{i} {i}".encode()),
                         (b, f"PUT t{i} {i}".encode())],
                        callback=finish(i, time.perf_counter()))
        check(done.wait(600), f"txn: {left[0]} transactions never ended")
        secs = time.perf_counter() - t1
    finally:
        driver.stop()
    ticks = m.tick_num - tick0
    committed = [r.committed for r in results]
    out["committed"] = sum(committed)
    out["aborted"] = sum(r.aborted for r in results)
    check(out["committed"] + out["aborted"] == n_tx,
          "txn: a transaction neither committed nor aborted")
    out["tx_per_s"] = n_tx / secs
    out.update(_ms_pcts(lat))
    out["contending"] = n_hot
    for r_, app in enumerate(m.apps):
        check(app.locks == {}, f"txn: replica {r_} holds locks "
                               f"{dict(list(app.locks.items())[:4])}")
        db = app.app.db
        for i, ((a, b), ok) in enumerate(zip(pairs, committed)):
            key = f"t{i}"
            on = [db.get(f"{n}", {}).get(key) == str(i) for n in (a, b)]
            check(on == [ok, ok], f"txn {i} on {a},{b}: committed={ok} "
                                  f"but the writes show as {on}")
    out["ticks"] = ticks
    if dev.type == "cuda":
        out["launches"] = path_launches(pg, "txn", ticks)
    out["seconds"] = time.perf_counter() - t0
    return out


def capacity_leg(torch, pg, dev, n_groups=1024, G=1 << 17, init_load=25.0,
                 factor=1.5, run_s=1.5, ramp_s=30.0):
    """``capacity-128k``: ``CapacityProbe`` (the TESTPaxos probe) on
    ``make_loopback_cluster`` (3 actives, 1 reconfigurator, ``NoopApp``,
    pipelined compact planes of ``G`` rows on ``dev``) over ``n_groups``
    names: open-loop runs of ``run_s`` seconds from ``init_load`` req/s,
    the load times ``factor`` after each passing run, for at most
    ``ramp_s`` seconds; the capacity is the last passing load.  The names
    are created in batches (the harness creates one at a time)."""
    from gigapaxos_tpu_torch.testing import (CapacityProbe,
                                             make_loopback_cluster)

    t0 = time.perf_counter()
    cluster, client = make_loopback_cluster(n_groups=0, max_groups=G,
                                            device=dev)
    out = {"G": G, "groups": n_groups}
    try:
        names = [f"g{i}" for i in range(n_groups)]
        for k in range(0, n_groups, 256):
            resp = client.create_batch(names[k:k + 256], timeout=120)
            check(resp["ok"], f"capacity: create batch at {k} failed")
        probe = CapacityProbe(client, names)
        out["setup_s"] = time.perf_counter() - t0
        with cluster.manager.lock, cluster.rc_manager.lock:
            pg.reset_launches()
            ticks0 = (cluster.manager.tick_num
                      + cluster.rc_manager.tick_num)
        runs, load, t1 = [], init_load, time.perf_counter()
        while time.perf_counter() - t1 < ramp_s:
            r = probe.run_once(load, run_s)
            runs.append({"load": load, "sent": r.sent,
                         "responded": r.responded, "errors": r.errors,
                         "response_rate": r.response_rate,
                         "p50_ms": r.p50_latency_s() * 1e3,
                         "avg_ms": r.avg_latency_s * 1e3,
                         "passed": r.passed(load)})
            if not r.passed(load):
                break
            load *= factor
        passing = [r for r in runs if r["passed"]]
        check(passing, f"capacity: no run passed, first {runs[:1]}")
        out["runs"] = runs
        out["capacity_req_per_s"] = passing[-1]["load"]
        out["p50_ms_at_capacity"] = passing[-1]["p50_ms"]
        out["ramp_s"] = time.perf_counter() - t1
        with cluster.manager.lock, cluster.rc_manager.lock:
            for m in (cluster.manager, cluster.rc_manager):
                _drain_pipeline(m)
            ticks = (cluster.manager.tick_num + cluster.rc_manager.tick_num
                     - ticks0)
            if dev.type == "cuda":
                out["launches"] = path_launches(pg, "capacity", ticks)
        out["ticks"] = ticks
    finally:
        client.close()
        cluster.close()
    out["seconds"] = time.perf_counter() - t0
    return out


def host_plane_phase(torch, pg, dev, card, cells_G=1 << 18, n_cells=4,
                     n_names=512, txn_G=1 << 17, n_tx=2048, cap_G=1 << 17):
    """The cells, transaction and capacity legs, each with the launch
    counts set to 0 just before it and printed as it ends."""
    t0 = time.perf_counter()
    out = {}

    def cells(dev_):
        work = tempfile.mkdtemp(prefix="chip_smoke_cells_")
        try:
            return cells_leg(torch, pg, dev_, work, G=cells_G,
                             n_cells=n_cells, n_names=n_names)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    for leg, fn in (("cells-1M", cells),
                    ("txn-128k", lambda d: txn_leg(torch, pg, d, G=txn_G,
                                                   n_tx=n_tx)),
                    ("capacity-128k", lambda d: capacity_leg(
                        torch, pg, d, G=cap_G))):
        pg.reset_launches()
        out[leg] = fn(dev)
        out[leg]["card"] = card
        print(leg + " " + json.dumps(out[leg]), flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------ profile (opt-in)

# ------------------------------------------------- placement and mesh phase

def _leg_ms(torch, dev, fn, reps):
    """Median ms of one call of ``fn``: CUDA events on the card, the host
    clock on the CPU (the legs' CPU rehearsal)."""
    if dev.type == "cuda":
        return time_ms(torch, fn, reps=reps)
    fn()
    xs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        xs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(xs)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _host_demand_fold(demand, per_row, decay):
    """The demand fold on the host, rounded as the device rounds it (one
    float64 multiply-add a tick, then float32)."""
    dec = np.float64(np.float32(decay))
    return (demand.astype(np.float64) * dec
            + per_row.astype(np.float64)).astype(np.float32)


def placement_leg(torch, pg, dev, R=3, W=8, G=1 << 17, ticks=20, reps=10):
    """placement-128k: manager-128k's deployment with the placement plane
    on (``sample_every_ticks=1``): the demand EWMA folds inside the
    scripted compact tick.  Every tick launches 5 gathers and 1 match;
    the sampled demand equals a host fold of the same ticks' intake; the
    demand tick's device ms against the plain compact tick's on the same
    state and load."""
    import struct

    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.dense_apps import DenseCounterApp
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager

    cfg = stack_cfg(GigapaxosTpuConfig(), R, W, G)
    cfg.placement.enabled = True
    cfg.placement.sample_every_ticks = 1
    apps = [DenseCounterApp(G) for _ in range(R)]
    m = PaxosManager(cfg, R, apps, spill_ns="smoke-placement", device=dev)
    check(m._demand_dev is not None, "placement-128k: no device fold")
    for a in apps:
        a.row_of = m.rows.row
    check(m.create_paxos_instances([f"g{i}" for i in range(G)],
                                   list(range(R))) == G, "create failed")
    rows = np.array([m.rows.row(f"g{i}") for i in range(G)], np.int64)
    payload = struct.pack("<q", 1)
    # the host fold of every completed tick's intake (taken_bits popcount)
    host = np.zeros(G, np.float32)
    real = m._process_compact

    def spy(co, *a, **k):
        nonlocal host
        bits = co.taken_bits.astype(np.int64)
        per_row = np.zeros(bits.shape[1], np.int64)
        for _ in range(m.P):
            per_row += (bits & 1).sum(axis=0)
            bits >>= 1
        host = _host_demand_fold(host, per_row[:G], m._placement.decay)
        return real(co, *a, **k)

    m._process_compact = spy
    skew = np.arange(G) % 4 == 0  # a quarter of the groups runs hot
    pg.reset_launches()
    t0 = time.perf_counter()
    for t in range(ticks):
        sel = rows if t % 2 == 0 else rows[skew]
        m.propose_bulk(sel, payload)
        m.tick()
    m.drain_pipeline()
    elapsed = time.perf_counter() - t0
    n_ticks = m.tick_num
    # a CPU rehearsal runs the plain versions inside the scripted program
    launches = (path_launches(pg, "placement-128k", n_ticks)
                if dev.type == "cuda" else None)
    dev_demand = m._placement.sample_device()
    check(np.array_equal(dev_demand.view(np.uint32), host.view(np.uint32)),
          "placement-128k: device demand != host fold of the same intake")
    check(float(dev_demand.sum()) > 0, "placement-128k: no demand")
    # the demand tick against the plain compact tick: same state, same load
    inbox = load_inbox(torch, pt, R, cfg.paxos.proposals_per_tick, G,
                       1 << 24, dev)
    demand = torch.zeros(G, dtype=torch.float32, device=dev)
    E, Lb = m._exec_budget, m._lag_budget
    state = m.state
    ms_plain = _leg_ms(torch, dev, lambda: pt.paxos_tick_compact(
        state, inbox, -1, E, Lb), reps)
    ms_demand = _leg_ms(torch, dev, lambda: pt.paxos_tick_compact_demand(
        state, inbox, demand, -1, E, Lb, m._placement.decay), reps)
    ms_plain2 = _leg_ms(torch, dev, lambda: pt.paxos_tick_compact(
        state, inbox, -1, E, Lb), reps)
    loads = m._placement.shard_loads()
    return {
        "R": R, "W": W, "G": G, "P": cfg.paxos.proposals_per_tick,
        "ticks_total": n_ticks, "ms_per_tick": elapsed / n_ticks * 1e3,
        "decisions": int(m.stats["decisions"]),
        "demand_tick_ms": ms_demand,
        "plain_compact_tick_ms": [ms_plain, ms_plain2],
        "demand_sum": float(dev_demand.sum()),
        "demand_equals_host_fold": True,
        "shard_loads": [float(x) for x in loads],
        "launches": launches,
    }


def _mesh_run(torch, pg, pt, st, tick_fn, R, W, P, G, ticks, dev,
              exec_budget, lag_budget):
    """``ticks`` loaded ticks and W drain ticks of ``tick_fn`` from a fresh
    state; returns (final state, flat buffers on the card, ms a tick)."""
    s = st.create_groups(st.init_state(R, G, W, device=dev), np.arange(G),
                         np.ones((G, R), bool))
    flats = []
    _sync(torch, dev)
    t0 = time.perf_counter()
    for t in range(ticks + W):
        inbox = load_inbox(torch, pt, R, P, G, 1 + t * G, dev,
                           empty=t >= ticks)
        s, flat = tick_fn(s, inbox)
        flats.append(flat)
    _sync(torch, dev)
    return s, flats, (time.perf_counter() - t0) / (ticks + W) * 1e3


def mesh_case(torch, pg, dev, R, W, P, G, rs, ticks):
    """The sharded tick on ``make_mesh([dev] * 8, rs)`` over resident
    blocks: its launches (8 shards x (5 + 1) a tick), its state and every
    tick's joined compacted outbox against an unsharded run of the same
    inputs on the card."""
    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.parallel import mesh as pm
    from gigapaxos_tpu_torch.parallel import shard_tick as stk
    from gigapaxos_tpu_torch.paxos import state as st

    E, Lb = R * G + 4096, 1024
    mesh = pm.make_mesh([dev] * 8, replica_shards=rs)
    stk.validate_mesh_for(mesh, R, G)
    res_tick = stk.make_resident_tick(mesh, -1, E, Lb)
    held = {}

    def shard(s, inbox):
        # the blocks stay resident from the first tick on; the global
        # view ``s`` is cut once
        if "blocks" not in held:
            held["blocks"] = pm.shard_state(s, mesh)
        held["blocks"], flats, _ = res_tick(held["blocks"],
                                            pm.shard_inbox(inbox, mesh))
        return s, flats

    pg.reset_launches()
    _, f_sh, ms_sh = _mesh_run(torch, pg, pt, st, shard, R, W, P, G,
                               ticks, dev, E, Lb)
    s_sh = pm.gather_state(held["blocks"], mesh, dev)
    n = ticks + W
    gs = mesh.groups_shards
    launches = None
    if dev.type == "cuda":
        launches = launches_now(
            pg, f"mesh R={R} rs={rs}, {n} ticks of {8} shards",
            {"gather_planes": 5 * 8 * n, "match_planes": 8 * n})
    s_un, f_un, ms_un = _mesh_run(
        torch, pg, pt, st,
        lambda s, ib: pt.paxos_tick_compact(s, ib, -1, E, Lb),
        R, W, P, G, ticks, dev, E, Lb)
    joined = [stk.join_compact({k: f.cpu().numpy() for k, f in a.items()},
                               mesh, R, W, G, E, Lb) for a in f_sh]
    for t, (a, b) in enumerate(zip(joined, f_un)):
        want = pt.unpack_compact(b.cpu().numpy(), R, G, E, Lb)
        check(all(np.array_equal(x, y) for x, y in zip(a, want)),
              f"mesh R={R} rs={rs}: tick {t}'s joined outbox differs from "
              "the unsharded run's")
    for name, a, b in zip(st.PaxosState._fields, s_sh, s_un):
        check(torch.equal(a, b), f"mesh R={R} rs={rs}: state.{name} "
              "differs from the unsharded run")
    co = joined[ticks - 1]
    check(co.n_exec > 0, f"mesh R={R} rs={rs}: nothing executed")
    return {
        "R": R, "W": W, "P": P, "G": G, "replica_shards": rs,
        "groups_shards": gs, "shard_block": [R // rs, W, G // gs],
        "tick_block": [R, W, G // gs],
        "devices": f"{len(mesh.devices)} x {dev} (every shard on the one "
                   "card)",
        "ticks_total": n, "ms_per_tick": ms_sh,
        "unsharded_ms_per_tick": ms_un,
        "equal_to_unsharded": True, "launches": launches,
        "launches_per_tick": (None if launches is None else
                              {k: v / n for k, v in launches.items()}),
    }


def mesh_placement_case(torch, pg, dev, R=3, W=4, G=1 << 17, n_names=32,
                        rounds=16, moves=8):
    """Placement on the mesh: a manager on ``make_mesh([dev] * 8)`` with
    ``KVApp``s; every name is born in shard 0's rows, traffic skews onto
    it, then one ``ShardRebalancer.propose`` and one
    ``GroupMigrator.execute_plan`` through the epoch machinery.  Every
    acknowledged write reads back afterwards."""
    from gigapaxos_tpu_torch.config import GigapaxosTpuConfig
    from gigapaxos_tpu_torch.models.replicable import KVApp
    from gigapaxos_tpu_torch.parallel import mesh as pm
    from gigapaxos_tpu_torch.paxos.manager import PaxosManager
    from gigapaxos_tpu_torch.placement import (GroupMigrator, MigrationStats,
                                              ShardRebalancer)
    from gigapaxos_tpu_torch.reconfiguration.coordinator import (
        PaxosReplicaCoordinator)

    cfg = GigapaxosTpuConfig()
    cfg.paxos.max_groups = G
    cfg.paxos.window = W
    cfg.paxos.compact_outbox = True
    cfg.paxos.pipeline_ticks = True
    cfg.paxos.deactivation_ticks = 0
    cfg.placement.enabled = True
    cfg.placement.sample_every_ticks = 1
    apps = [KVApp() for _ in range(R)]
    m = PaxosManager(cfg, R, apps, device=dev,
                     mesh=pm.make_mesh([dev] * 8))
    nodes = [f"AR{i}" for i in range(R)]
    coord = PaxosReplicaCoordinator(m, nodes)
    for i in range(n_names):
        check(coord.create_replica_group(f"svc{i}", 0, b"", nodes),
              "mesh placement: create failed")
    acked = {}

    def traffic(tag):
        for i in range(rounds):
            for g in range(n_names):
                name = f"svc{g}"
                key = f"{tag}{i}"
                coord.coordinate_request(
                    name, coord.current_epoch(name),
                    f"PUT {key} {g}".encode(),
                    lambda r, x, k=(name, key, str(g)): acked.__setitem__(
                        k, x))
            m.tick()
        m.drain_pipeline()

    traffic("a")
    demand = m.demand_snapshot()
    loads0 = m._placement.shard_loads()
    reb = ShardRebalancer(m.G, 8, skew_threshold=2.0, min_interval_ticks=0,
                          max_moves_per_plan=moves)
    plan = reb.propose(m.tick_num, demand,
                       free_rows_in_shard=m.free_rows_in_shard,
                       blob_bytes=m.blob_bytes_of_row)
    check(bool(plan), "mesh placement: the rebalancer planned nothing")
    stats = MigrationStats()
    mig = GroupMigrator(coord, counters=m._placement, stats=stats)
    t0 = time.perf_counter()
    moved = mig.execute_plan(plan, pump=m.tick)
    move_s = time.perf_counter() - t0
    check(moved >= 1, "mesh placement: no group moved")
    traffic("b")
    m.demand_snapshot()
    loads1 = m._placement.shard_loads()
    skew0 = ShardRebalancer.skew(loads0, 1e-3)
    skew1 = ShardRebalancer.skew(loads1, 1e-3)
    # every name was born in shard 0: its share of the demand must fall
    share0 = float(loads0[0] / loads0.sum())
    share1 = float(loads1[0] / loads1.sum())
    check(share1 < share0, f"mesh placement: shard 0 holds {share0:.3f} "
          f"of the demand before the moves and {share1:.3f} after")
    check(all(x == b"OK" for x in acked.values()),
          "mesh placement: a write was not acknowledged OK")
    _gs, per = m.shard_geometry()
    homes = sorted({m.rows.row(f"svc{g}#{coord.current_epoch(f'svc{g}')}")
                    // per for g in range(n_names)})
    for (name, key, val) in acked:
        db = json.loads(apps[0].checkpoint(
            f"{name}#{coord.current_epoch(name)}") or b"{}")
        check(db.get(key) == val, f"mesh placement: {name} lost {key}")
    return {
        "R": R, "W": W, "G": G, "groups_shards": 8, "names": n_names,
        "skew_before": float(skew0), "skew_after": float(skew1),
        "shard0_share_before": share0, "shard0_share_after": share1,
        "shard_loads_before": [float(x) for x in loads0],
        "shard_loads_after": [float(x) for x in loads1],
        "planned_moves": len(plan.moves), "groups_moved": int(moved),
        "bytes_transferred": stats.bytes_transferred,
        "execute_plan_s": move_s, "shards_holding_names": homes,
        "acked_writes": len(acked),
    }


def placement_mesh_phase(torch, pg, dev, card, G_128k=1 << 17,
                         G_1m=1 << 20, mesh_ticks=10, names=32):
    """placement-128k and mesh-1M (see the module docstring)."""
    t0 = time.perf_counter()
    plc = placement_leg(torch, pg, dev, G=G_128k)
    plc["card"] = card
    print("placement-128k " + json.dumps(plc), flush=True)
    mesh = mesh_case(torch, pg, dev, 3, 8, 4, G_1m, rs=1, ticks=mesh_ticks)
    mesh["card"] = card
    print("mesh-1M " + json.dumps(mesh), flush=True)
    mesh4 = mesh_case(torch, pg, dev, 4, 8, 4, G_128k, rs=2,
                      ticks=max(2, mesh_ticks // 2))
    mesh4["card"] = card
    print("mesh-128k-r4 " + json.dumps(mesh4), flush=True)
    mpl = mesh_placement_case(torch, pg, dev, G=G_128k, n_names=names)
    mpl["card"] = card
    print("mesh-placement-128k " + json.dumps(mpl), flush=True)
    return {"placement-128k": plc, "mesh-1M": mesh, "mesh-128k-r4": mesh4,
            "mesh-placement-128k": mpl,
            "phase_s": time.perf_counter() - t0}


def profile_tick(torch, dev, R, W, P, G, exec_budget, lag_budget=1024,
                 warm=3, ticks=3):
    """Where a loaded tick's time goes: device time of the tick program
    (CUDA events), the device-to-host copy of its compact buffer alone,
    and a ``torch.profiler`` trace of ``ticks`` closed-loop ticks (device
    time by kernel and the device's busy share of the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from gigapaxos_tpu_torch.ops import tick as pt
    from gigapaxos_tpu_torch.paxos import state as st

    state = st.create_groups(st.init_state(R, G, W, device=dev),
                             np.arange(G), np.ones((G, R), bool))
    for t in range(warm):
        inbox = load_inbox(torch, pt, R, P, G, 1 + t * G, dev)
        state, flat = pt.paxos_tick_compact(state, inbox, -1, exec_budget,
                                            lag_budget)
        flat.cpu()
    base = 1 + warm * G
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    inbox = load_inbox(torch, pt, R, P, G, base, dev)
    state, flat = pt.paxos_tick_compact(state, inbox, -1, exec_budget,
                                        lag_budget)
    ev1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat.cpu()
    copy_ms = (time.perf_counter() - t0) * 1e3
    device_ms = ev0.elapsed_time(ev1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(ticks):
            inbox = load_inbox(torch, pt, R, P, G, base + (t + 1) * G, dev)
            state, flat = pt.paxos_tick_compact(state, inbox, -1,
                                                exec_budget, lag_budget)
            flat.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    # device-side events only (kernels, copies, memsets): the host-side
    # aten ops carry the same device time again
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and dev_ms(e) > 0),
                    key=dev_ms, reverse=True)
    check(events, "the profiler recorded no device time")
    busy_ms = sum(dev_ms(e) for e in events)
    top = [{"name": e.key[:80], "calls_per_tick": e.count / ticks,
            "ms_per_tick": dev_ms(e) / ticks} for e in events[:25]]
    return {"G": G, "tick_device_ms": device_ms, "d2h_copy_ms": copy_ms,
            "compact_buffer_mb": flat.numel() * 4 / 1e6,
            "profiled_wall_ms_per_tick": wall_ms / ticks,
            "device_busy_ms_per_tick": busy_ms / ticks,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "top_device_ops": top}


# --------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the loaded tick (torch.profiler)")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from gigapaxos_tpu_torch.ops import cuda_build
        from gigapaxos_tpu_torch.ops import plane_gather as pg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    bw = bandwidth_of(kind)
    R, W, P, G = 3, 8, 4, 1 << 20

    def stamp(what):
        """The run's seconds so far, after each phase (for the depth
        budget)."""
        print(f"elapsed after {what}: {time.perf_counter() - t_start:.1f} s",
              flush=True)

    try:
        t0 = time.perf_counter()
        log = cuda_build.build("plane_gather") or ""
        print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}")
        print(f"edge cases: {edge_cases(torch, pg, dev)} calls equal to "
              "the plain versions", flush=True)
        rows = kernels_phase(torch, pg, dev, R, W, P, G, bw)
        stamp("kernels")
        # each main path runs with the counts set to 0 just before it
        pg.reset_launches()
        tick = tick_phase(torch, dev, R, W, P, G, warm=3, timed=30,
                          cpu_ticks=3, exec_budget=R * G + 4096)
        launches = {"tick": path_launches(pg, "tick", tick["ticks_total"])}
        print("tick " + json.dumps(tick), flush=True)
        stamp("tick")
        pg.reset_launches()
        mgr = manager_phase(torch, dev, R, W, 1 << 17, ticks=30)
        launches["manager"] = path_launches(pg, "manager",
                                            mgr["ticks_total"],
                                            placing=mgr["placing_ticks"])
        print("manager " + json.dumps(mgr), flush=True)
        print("kv " + json.dumps({"groups": kv_leg(torch, dev, R, W)}),
              flush=True)
        stamp("manager")
        dense, sparse = wal_phase(torch, dev, R, W, mgr["ms_per_tick"])
        print("wal-128k " + json.dumps(dense), flush=True)
        print("recovery-1M-sparse " + json.dumps(sparse), flush=True)
        stamp("wal")
        # the replay path: both legs' batched recoveries
        launches["replay"] = {k: dense["launches"][k] + sparse["launches"][k]
                              for k in dense["launches"]}
        # depth cut: at 2,048 names and 256 serial requests, the whole run
        # with the modeb phase took up to 1,024.7 s on an H100 (700 W); at
        # 512 and 64 with the chain Mode B and server phase, 973.5 s in one
        # run and 1,396 s in another; at 256 names, 8 reconfigurations and
        # 8 deletes with the cells, transaction and capacity legs, 1,234 s;
        # at 128 and 32 with the placement and mesh phase, 1,045.4 s
        clu = cluster_phase(torch, pg, dev, 1 << 20, n_names=64,
                            serial=16, n_reconf=4, n_delete=4, edges=32)
        clu["card"] = card
        launches["cluster"] = clu["launches"]
        print("cluster " + json.dumps(clu), flush=True)
        stamp("cluster")
        mixed, reads = planes_phase(torch, pg, dev)
        for leg in mixed:
            leg["card"] = card
            print("mixed-1M " + json.dumps(leg), flush=True)
        reads["card"] = card
        print("reads-128k " + json.dumps(reads), flush=True)
        stamp("planes")
        launches["mixed"] = {k: sum(leg["launches"][k] for leg in mixed)
                             for k in launches["tick"]}
        launches["reads"] = reads["launches"]
        launches["replay"] = {k: launches["replay"][k]
                              + reads["replay_launches"][k]
                              for k in launches["replay"]}
        work = tempfile.mkdtemp(prefix="chip_smoke_kv_chain_")
        try:
            kvp = device_kv_phase(torch, pg, dev, work, ticks_128k=16,
                                  manager_dps=mgr["dec_per_s"])
            stamp("device-kv")
            chp = chain_phase(torch, pg, dev, work, n_names=64)
            stamp("chain")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for leg, res in list(kvp.items()) + list(chp.items()):
            res["card"] = card
            print(leg + " " + json.dumps(res), flush=True)
        mbp = modeb_phase(torch, pg, dev)
        for leg in ("modeb-1M", "modeb-fast", "modeb-device-128k",
                    "modeb-wal-128k"):
            mbp[leg]["card"] = card
            print(leg + " " + json.dumps(mbp[leg]), flush=True)
        print(f"modeb phase {mbp['phase_s']:.1f} s", flush=True)
        stamp("modeb")
        csp = chain_server_phase(torch, pg, dev)
        for leg in ("chain-modeb-128k", "server-128k", "server-chain"):
            csp[leg]["card"] = card
            print(leg + " " + json.dumps(csp[leg]), flush=True)
        print(f"chain-modeb and server phase {csp['phase_s']:.1f} s",
              flush=True)
        stamp("chain-modeb and servers")
        hpp = host_plane_phase(torch, pg, dev, card)
        print(f"cells, txn and capacity phase {hpp['phase_s']:.1f} s",
              flush=True)
        stamp("cells, txn and capacity")
        pmp = placement_mesh_phase(torch, pg, dev, card)
        print(f"placement and mesh phase {pmp['phase_s']:.1f} s",
              flush=True)
        stamp("placement and mesh")

        def total(*runs):
            return {k: sum(r[k] for r in runs) for k in launches["tick"]}

        # the device app's main path (its 1M tick run, the manager's and
        # its replay), the lazy baseline's ticks, the chain's two runs and
        # the chain cluster's (chain active plane, Paxos RC plane)
        launches["device_kv"] = total(
            *(kvp[k]["launches"] for k in ("device-kv-1M", "device-kv-128k",
                                           "device-kv-recover")))
        launches["baselines"] = kvp["baselines-128k"]["lazy"]["launches"]
        launches["chain"] = total(chp["chain-1M"]["launches"],
                                  chp["chain-128k"]["launches"])
        launches["chain_cluster"] = chp["chain-cluster"]["launches"]
        # Mode B: every node tick of the 1M leg, the classical failover
        # leg and the device-app leg; the fast failover leg on its own
        launches["modeb"] = total(
            mbp["modeb-1M"]["launches"],
            mbp["modeb-fast"]["launches"]["full"],
            mbp["modeb-device-128k"]["launches"])
        launches["modeb_fast"] = mbp["modeb-fast"]["launches"]["fast"]
        # the durable leg: live node ticks, and the replayed ones
        launches["modeb_wal"] = mbp["modeb-wal-128k"]["launches"]
        launches["modeb_replay"] = mbp["modeb-wal-128k"]["replay_launches"]
        # chain over Mode B: the durable deployment's live node ticks and
        # its replayed ones (1 gather, no match each); the servers: every
        # node tick of every plane, live or replayed (5 + 1 a Paxos Mode B
        # node tick, 1 + 0 a chain one)
        launches["chain_modeb"] = csp["chain-modeb-128k"]["launches"]
        launches["chain_modeb_replay"] = (
            csp["chain-modeb-128k"]["replay_launches"])
        launches["server"] = csp["server-128k"]["launches"]
        launches["server_chain"] = csp["server-chain"]["launches"]
        # the cells: every plane tick of every cell's first incarnation
        # (read from the workers' stats), the transactor's manager, the
        # capacity probe's two planes
        launches["cells"] = hpp["cells-1M"]["launches"]
        launches["txn"] = hpp["txn-128k"]["launches"]
        launches["capacity"] = hpp["capacity-128k"]["launches"]
        # the demand tick's manager run (5 + 1 a tick); the sharded ticks
        # of mesh-1M and of the R=4 mesh (8 shards x (5 + 1) a tick)
        launches["placement"] = pmp["placement-128k"]["launches"]
        launches["mesh"] = pmp["mesh-1M"]["launches"]
        launches["mesh_r4"] = pmp["mesh-128k-r4"]["launches"]
        print("launches " + json.dumps(launches), flush=True)
        if args.profile:
            prof = profile_tick(torch, dev, R, W, P, G, R * G + 4096)
            print("profile " + json.dumps(prof), flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the inbox scatter replaces no TPU kernel: the JAX package uploads the
    # dense inbox whole
    replaces = {
        "gather_planes": "gigapaxos_tpu/ops/pallas_gather.py:41",
        "match_planes": "gigapaxos_tpu/ops/pallas_gather.py:108",
        "scatter_inbox": None,
    }
    # launches: the north-star tick run, whose shapes the times are taken
    # at; for the scatter the manager run (the tick run's inboxes are made
    # on the card); launches_by_path: each main path's own run (None where
    # the counts come from other processes or leave the scatter out)
    counted_in = {"gather_planes": "tick", "match_planes": "tick",
                  "scatter_inbox": "manager"}
    kernels = []
    for name in ("gather_planes", "match_planes", "scatter_inbox"):
        mine = [r for r in rows if r["name"] == name]
        # the JSON row of a kernel is its largest launch on the tick's path
        head = max((r for r in mine if r["set"]), key=lambda r: r["bytes"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/plane_gather.cu",
            "replaces": replaces[name],
            "launches": launches[counted_in[name]][name],
            "launches_by_path": {p: n.get(name)
                                 for p, n in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # the yardsticks: one torch.gather per array of the gather's
            # set; index_put_ of the scatter's placements
            "library_ms": head["library_ms"], "case": head["case"],
            "cases": [{k: r[k] for k in ("case", "arrays", "ms",
                                         "k_launch_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_share")}
                      for r in mine],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
