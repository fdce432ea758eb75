"""Host-side shard rebalancer: skew detection + greedy bin-pack plans.

The decision plane runs entirely host-side off the dense demand counters
(HT-Paxos's separation of placement decisions from the consensus hot path):
the device tick never waits on it.  Guards mirror the demand SPI's rate
limits (``reconfiguration/demand.py`` ``_rate_limited``): a *trigger*
threshold with *hysteresis* (after a plan fires, the trigger re-arms when
its moves are confirmed executed, or once skew settles below
``skew_threshold / hysteresis`` for a plan that was dropped), plus a
min-interval in ticks and an optional min-moves spacing, so a noisy
workload can't thrash groups back and forth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class MigrationPlan:
    """One rebalancing decision: ordered row moves, hottest first."""

    tick: int
    #: (row, src_shard, dst_shard) per move
    moves: List[tuple] = field(default_factory=list)
    #: diagnostics recorded at plan time
    skew_before: float = 0.0
    skew_predicted: float = 0.0

    def __bool__(self) -> bool:
        return bool(self.moves)


class ShardRebalancer:
    """Detects hot/cold shards and emits greedy migration plans.

    ``propose(tick, demand, free_by_shard)`` returns a :class:`MigrationPlan`
    (possibly empty).  Execution is the migrator's job; the rebalancer only
    decides.  ``record_executed`` / ``record_aborted`` feed the guards.
    """

    def __init__(self, n_groups: int, groups_shards: int, *,
                 skew_threshold: float = 2.0, hysteresis: float = 1.25,
                 min_interval_ticks: int = 64, min_moves_between: int = 0,
                 max_moves_per_plan: int = 4, min_shard_load: float = 1e-3,
                 blob_tolerance: float = 0.9):
        self.n_groups = int(n_groups)
        self.groups_shards = int(groups_shards)
        self.rows_per_shard = self.n_groups // self.groups_shards
        self.skew_threshold = float(skew_threshold)
        self.hysteresis = float(hysteresis)
        self.min_interval_ticks = int(min_interval_ticks)
        self.min_moves_between = int(min_moves_between)
        self.max_moves_per_plan = int(max_moves_per_plan)
        self.min_shard_load = float(min_shard_load)
        #: when a ``blob_bytes`` estimator is supplied to :meth:`propose`,
        #: rows within this demand fraction of the hot shard's hottest row
        #: count as "equally hot" and the cheapest-to-move one is shed
        self.blob_tolerance = float(blob_tolerance)
        self._last_plan_tick: Optional[int] = None
        self._armed = True  # hysteresis state: trigger armed?
        self._moves_since_plan = 0
        self.plans_emitted = 0

    # --------------------------------------------------------------- guards
    def _rate_limited(self, tick: int) -> bool:
        if self._last_plan_tick is None:
            return False
        if tick - self._last_plan_tick < self.min_interval_ticks:
            return True
        if self._moves_since_plan < self.min_moves_between:
            return True
        return False

    @staticmethod
    def skew(loads: np.ndarray, floor: float) -> float:
        """max/min shard-load ratio with the min-load floor applied, so an
        all-idle mesh reads as balanced instead of 0/0."""
        lo = max(float(loads.min()), floor)
        return float(loads.max()) / lo

    # ------------------------------------------------------------- planning
    def propose(self, tick: int, demand: np.ndarray,
                free_rows_in_shard, blob_bytes=None) -> MigrationPlan:
        """Plan up to ``max_moves_per_plan`` moves off the hottest shard.

        ``demand`` is the [G] EWMA snapshot; ``free_rows_in_shard(k)`` must
        return how many free rows destination shard ``k`` has — a move is
        only planned into capacity that exists.

        ``blob_bytes`` (optional, ``row -> int``) estimates the checkpoint
        blob a migration of that row would transfer (the quantity
        ``MigrationStats.bytes_transferred`` records after the fact).  When
        given, rows within ``blob_tolerance`` of the hot shard's top demand
        are treated as equally hot and the LIGHTEST blob among them is shed
        — a heavy-state group is passed over for an equally hot light one,
        since either move sheds the same load but the light one stops the
        world for a fraction of the transfer.  The tolerance bounds the
        heat sacrificed, so skew convergence is unaffected.
        """
        plan = MigrationPlan(tick=tick)
        gs, per = self.groups_shards, self.rows_per_shard
        loads = demand.reshape(gs, per).sum(axis=1)
        plan.skew_before = self.skew(loads, self.min_shard_load)

        # hysteresis: after a plan fires the trigger disarms; it re-arms when
        # the mesh settles below threshold/hysteresis OR when the caller
        # confirms the plan's moves executed (record_executed) — the load
        # distribution changed, so the next propose re-evaluates it fresh.
        # A plan that was emitted but never executed keeps the trigger
        # disarmed until the skew settles: guards against a caller that
        # drops plans re-planning the same moves every min-interval.
        if not self._armed:
            if plan.skew_before <= self.skew_threshold / self.hysteresis:
                self._armed = True
            else:
                return plan
        if plan.skew_before < self.skew_threshold or self._rate_limited(tick):
            return plan

        work = loads.astype(np.float64).copy()
        budget = {k: int(free_rows_in_shard(k)) for k in range(gs)}
        # hottest groups on the (current) hottest shard, moved one at a time
        # to the then-coldest shard with capacity; loads updated greedily so
        # a single plan doesn't overshoot and invert the skew.
        for _ in range(self.max_moves_per_plan):
            src = int(work.argmax())
            order = np.argsort(work, kind="stable")
            dst = next((int(k) for k in order
                        if int(k) != src and budget.get(int(k), 0) > 0), None)
            if dst is None:
                break
            lo, hi = src * per, (src + 1) * per
            seg = demand[lo:hi]
            row = lo + int(seg.argmax())
            if blob_bytes is not None and float(seg[row - lo]) > 0.0:
                near = np.nonzero(
                    seg >= self.blob_tolerance * float(seg[row - lo])
                )[0]
                if len(near) > 1:
                    # ties (and near-ties) go to the cheapest transfer;
                    # index breaks exact byte ties for determinism
                    row = lo + int(min(
                        near, key=lambda j: (int(blob_bytes(lo + int(j))),
                                             int(j))
                    ))
            d = float(demand[row])
            if d <= 0.0:
                break  # nothing hot left to shed
            # stop if the move would overshoot: moving the group should
            # shrink |src-dst| gap, not flip it past balanced.
            if work[src] - d < work[dst] + d and len(plan.moves) > 0:
                break
            plan.moves.append((row, src, dst))
            work[src] -= d
            work[dst] += d
            budget[dst] -= 1
            demand = demand.copy()
            demand[row] = 0.0  # don't pick the same row twice
        plan.skew_predicted = self.skew(work.astype(np.float32),
                                        self.min_shard_load)
        if plan.moves:
            self.plans_emitted += 1
            self._last_plan_tick = tick
            self._moves_since_plan = 0
            self._armed = False
        return plan

    # ------------------------------------------------------------- feedback
    def record_executed(self, n_moves: int = 1) -> None:
        self._moves_since_plan += int(n_moves)
        if n_moves > 0:
            # the moves landed: the distribution the planner saw is gone, so
            # the trigger re-arms (min_interval still paces the next plan).
            self._armed = True

    def record_aborted(self) -> None:
        # an aborted plan re-arms immediately: the mesh didn't change.
        self._armed = True
