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
   array (a yardstick the port never calls);
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
   2,048 names created in batches, one PUT each through batched sends,
   every name read back (256 of them one at a time for latency), 16 names
   reconfigured onto a rotated 3-of-5 set, 16 deleted, the survivors read
   back again and their app states held equal at every member.  Every tick
   of both planes must launch 5 gathers and 1 match;
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
   ``InProcessCluster(coordinator="chain")`` on 2^17-row planes (256
   names).  Each chain tick must launch 1 gather and no match.

The kernels phase also holds both kernels against their plain versions at
the narrow widths sparse replay gives them (A=8 groups, W=4), at the
128k deployment's shapes (G=2^17, W=8, P=2) that the manager phase, the
durable manager and its dense replay give them, and at the cluster's two
planes (R=5 and R=3, W=4, P=4, G=2^20), and at the planes phase's shapes
(the W=1 register planes at G=917,504 and G=2^17, the log planes at W=8,
G=2^17, P=1 and P=4), the chain cluster's reconfigurator plane (R=3,
W=4, G=2^17), and the chain tick's one gather (three rings over a
per-replica index) at chain-1M, chain-128k and the chain cluster's active
plane.

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


def launches_now(pg, path: str, want: dict) -> dict:
    """Read the launch counts of one main-path run (set to 0 just before
    it) and hold them to ``want``."""
    got = dict(pg.launches)
    check(got == want, f"{path}: launches {got}, expected {want}")
    return got


def path_launches(pg, path: str, n_ticks: int, planes: int = 1) -> dict:
    """The launch check of a Paxos path: every tick of every state plane
    launches 5 gathers (one per set of arrays that share an index) and 1
    match; a mixed tick has two planes."""
    return launches_now(pg, f"{path} phase, {n_ticks} ticks of {planes} "
                        "plane(s)", {"gather_planes": 5 * planes * n_ticks,
                                     "match_planes": planes * n_ticks})


#: (R, W, G, P, label prefix) of the shapes the other paths give the
#: kernels: the recovery-1M-sparse leg's 8 active groups at W=4 (sparse
#: replay), the 128k deployment at P=2 (the manager phase, the durable
#: manager and its dense replay), and the cluster's two 2^20-row planes at
#: the default W=4, P=4 (5 actives, 3 reconfigurators)
PATH_SHAPES = ((3, 4, 8, 4, "replay A=8 W=4: "),
               (3, 8, 1 << 17, 2, "replay/manager 128k: "),
               (5, 4, 1 << 20, 4, "cluster AR R=5 W=4: "),
               (3, 4, 1 << 20, 4, "cluster RC R=3 W=4: "),
               (3, 8, 1 << 17, 1, "mixed log W=8 P=1: "),
               (3, 1, 917_504, 1, "mixed reg W=1 P=1: "),
               (3, 8, 1 << 17, 4, "reads log 128k P=4: "),
               (3, 1, 1 << 17, 4, "reads reg W=1 128k P=4: "),
               (3, 4, 1 << 17, 4, "chain cluster RC R=3 W=4 128k: "))

#: (R, W, G, label prefix) of the chain tick's one gather launch: its three
#: rings over the per-replica window index, at chain-1M, chain-128k and the
#: chain cluster's active plane (5 actives, the default W=4)
CHAIN_SHAPES = ((3, 8, 1 << 20, "chain 1M: "),
                (3, 8, 1 << 17, "chain 128k: "),
                (5, 4, 1 << 17, "chain cluster AR R=5 W=4: "))


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
        ms = time_ms(torch, lambda: c.fused(pg), reps=50, flush=flush)
        k_ms = time_ms(torch, lambda: c.per_array(pg), reps=50, flush=flush)
        plain_ms = time_ms(torch, lambda: c.plain(pg), reps=10, flush=flush)
        lib_ms = None
        if c.name == "gather_planes":
            idx64 = c.idx.to(torch.int64).expand(
                c.arrs[0].shape[:-2] + c.idx.shape[-2:])
            for a, b in zip(c.arrs, want):
                check(torch.equal(torch.gather(a, -2, idx64), b),
                      f"torch.gather {c.label} differs")
            lib_ms = time_ms(torch, lambda: [torch.gather(a, -2, idx64)
                                             for a in c.arrs],
                             reps=50, flush=flush)
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
    del flush
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

    t0 = time.perf_counter()
    admitted = 0
    for t in range(ticks):
        k = len(acks)
        acks.append([None, np.zeros(G, np.int64)])
        rids = m.propose_bulk(rows, payload, batch_sink=sink_for(k))
        acks[k][0] = rids
        admitted += int((rids >= 0).sum())
        m.tick()
    m.drain_pipeline()
    elapsed = time.perf_counter() - t0
    decided = m.stats["decisions"]
    phases = host_phases("smoke")
    drain = 0
    while True:
        m.tick()
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
            "ticks_total": ticks + drain,
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
        dense = wal_dense_leg(torch, dev, R, W, 1 << 17, ticks=30,
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


def cluster_phase(torch, pg, dev, G, n_names=4096, create_batch=256,
                  put_batch=512, serial=256, n_reconf=16, n_delete=16,
                  coordinator="paxos"):
    """The port's ``InProcessCluster`` driven through its client: create
    ``n_names`` names, PUT one value each, read every one back (all through
    batches, ``serial`` of them one at a time for latency), reconfigure
    ``n_reconf`` onto a rotated 3-of-5 active set, delete ``n_delete``, read
    the survivors back again and hold every member's app state equal.
    ``coordinator="chain"`` puts the names on chains (the active plane is
    a ``ChainManager``, whose tick launches one gather and no match).  A
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
    """Both legs; the mixed arms in turns (on, off, off, on) so the two
    are compared within one call, the CPU check in the first of each; the
    reads leg in a temporary directory removed after."""
    mixed = [mixed_leg(torch, pg, dev, folds, cpu_ticks=3 if i < 2 else 0)
             for i, folds in enumerate((True, False, False, True))]
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


# ------------------------------------------------------ profile (opt-in)

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
        # each main path runs with the counts set to 0 just before it
        pg.reset_launches()
        tick = tick_phase(torch, dev, R, W, P, G, warm=3, timed=30,
                          cpu_ticks=3, exec_budget=R * G + 4096)
        launches = {"tick": path_launches(pg, "tick", tick["ticks_total"])}
        print("tick " + json.dumps(tick), flush=True)
        pg.reset_launches()
        mgr = manager_phase(torch, dev, R, W, 1 << 17, ticks=30)
        launches["manager"] = path_launches(pg, "manager",
                                            mgr["ticks_total"])
        print("manager " + json.dumps(mgr), flush=True)
        print("kv " + json.dumps({"groups": kv_leg(torch, dev, R, W)}),
              flush=True)
        dense, sparse = wal_phase(torch, dev, R, W, mgr["ms_per_tick"])
        print("wal-128k " + json.dumps(dense), flush=True)
        print("recovery-1M-sparse " + json.dumps(sparse), flush=True)
        # the replay path: both legs' batched recoveries
        launches["replay"] = {k: dense["launches"][k] + sparse["launches"][k]
                              for k in dense["launches"]}
        clu = cluster_phase(torch, pg, dev, 1 << 20, n_names=2048)
        clu["card"] = card
        launches["cluster"] = clu["launches"]
        print("cluster " + json.dumps(clu), flush=True)
        mixed, reads = planes_phase(torch, pg, dev)
        for leg in mixed:
            leg["card"] = card
            print("mixed-1M " + json.dumps(leg), flush=True)
        reads["card"] = card
        print("reads-128k " + json.dumps(reads), flush=True)
        launches["mixed"] = {k: sum(leg["launches"][k] for leg in mixed)
                             for k in launches["tick"]}
        launches["reads"] = reads["launches"]
        launches["replay"] = {k: launches["replay"][k]
                              + reads["replay_launches"][k]
                              for k in launches["replay"]}
        work = tempfile.mkdtemp(prefix="chip_smoke_kv_chain_")
        try:
            kvp = device_kv_phase(torch, pg, dev, work,
                                  manager_dps=mgr["dec_per_s"])
            chp = chain_phase(torch, pg, dev, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for leg, res in list(kvp.items()) + list(chp.items()):
            res["card"] = card
            print(leg + " " + json.dumps(res), flush=True)

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
        print("launches " + json.dumps(launches), flush=True)
        if args.profile:
            prof = profile_tick(torch, dev, R, W, P, G, R * G + 4096)
            print("profile " + json.dumps(prof), flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = {
        "gather_planes": "gigapaxos_tpu/ops/pallas_gather.py:41",
        "match_planes": "gigapaxos_tpu/ops/pallas_gather.py:108",
    }
    kernels = []
    for name in ("gather_planes", "match_planes"):
        mine = [r for r in rows if r["name"] == name]
        # the JSON row of a kernel is its largest launch on the tick's path
        head = max((r for r in mine if r["set"]), key=lambda r: r["bytes"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gigapaxos_tpu_torch/csrc/plane_gather.cu",
            # launches: the north-star tick run, whose shapes the times
            # are taken at; launches_by_path: each main path's own run
            "replaces": replaces[name], "launches": launches["tick"][name],
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # the gather's yardstick: one torch.gather per array of the set
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
