"""Per-group demand counters: dense EWMA request rates, reduced per shard.

Two intake paths feed one facade:

* **Device fold** (compact paths): per-group ``decided_now`` [G] never
  reaches the host in compact mode (only its sum survives the flat buffer),
  so the EWMA fold runs on the device and the demand array (a float32
  ``[G]`` tensor on the plane's device) stays there; the host pulls a
  snapshot only every ``sample_every_ticks`` ticks.  The mesh path folds
  ``decided_now`` (``d' = decay*d + decided_now``) in each shard column's
  body, one ``[G/gs]`` block on each column's device
  (``parallel/shard_tick.py``); the single-device path
  folds the per-row intake (``sum(intake_taken)``, what a host popcount of
  ``taken_bits`` gives) inside the scripted tick program
  (``ops.tick.paxos_tick_compact_demand``).
* **Host fold** (full-outbox path, and the device-app compact path whose
  fused program predates the fold): the host sees per-row intake
  (``intake_taken`` sums, or ``taken_bits`` popcounts in compact mode), so
  ``observe_intake`` folds the same EWMA in numpy.

Counters are ADVISORY: they are excluded from WAL/snapshot on purpose — a
recovered node restarts with cold counters and simply waits out the
rebalancer's min-interval guard, while the migrations themselves are
journaled and replay exactly.
"""

from __future__ import annotations

import numpy as np


class PlacementCounters:
    """EWMA per-group demand ([G] float) + per-shard reductions."""

    def __init__(self, n_groups: int, groups_shards: int,
                 decay: float = 0.9, sample_every_ticks: int = 8):
        if n_groups % max(groups_shards, 1) != 0:
            raise ValueError(
                f"n_groups={n_groups} not divisible by "
                f"groups_shards={groups_shards}"
            )
        self.n_groups = int(n_groups)
        self.groups_shards = max(int(groups_shards), 1)
        self.decay = float(decay)
        self.sample_every_ticks = max(int(sample_every_ticks), 1)
        #: host mirror of the demand array; refreshed by observe_intake
        #: (host fold) or adopt_device (device fold sample).
        self.demand = np.zeros(self.n_groups, dtype=np.float32)
        #: device-resident demand (a float32 tensor) when the device fold
        #: is active; threaded through the compact dispatch by the manager.
        self.device_demand = None
        self.ticks_observed = 0
        self._since_sample = 0

    # ------------------------------------------------------------ host fold
    def observe_intake(self, per_row: np.ndarray) -> None:
        """Fold one tick of per-row intake counts (host path).

        ``per_row`` is any [G] count vector — popcounted ``taken_bits``
        columns, ``intake_taken`` sums, or ``bulkstore.live_by_row`` — the
        EWMA makes them comparable across ticks regardless of source.
        """
        self.ticks_observed += 1
        self.demand *= self.decay
        np.add(self.demand, per_row.astype(np.float32), out=self.demand)

    # ---------------------------------------------------------- device fold
    def adopt_device(self, device_demand) -> None:
        """Track the device-resident demand array (fold ran on device; a
        mesh's list of its columns' blocks)."""
        self.device_demand = device_demand
        self.ticks_observed += 1
        self._since_sample += 1

    def should_sample(self) -> bool:
        return self._since_sample >= self.sample_every_ticks

    def sample_device(self) -> np.ndarray:
        """Pull the device demand to host (one transfer per sample window)."""
        if self.device_demand is not None:
            # a copy: on the CPU .numpy() is a view of the device tensor,
            # and move_row/observe_intake write into the host mirror.  A
            # mesh hands one block a shard column, in row order
            dd = self.device_demand
            parts = dd if isinstance(dd, (list, tuple)) else (dd,)
            self.demand = np.concatenate(
                [p.detach().cpu().numpy() for p in parts]).astype(
                    np.float32, copy=True)
        self._since_sample = 0
        return self.demand

    # ------------------------------------------------------------- readouts
    def demand_snapshot(self) -> np.ndarray:
        """Current host-visible per-group demand [G] (no device pull)."""
        return self.demand

    def shard_loads(self) -> np.ndarray:
        """Per-shard load [gs]: sum of group demand over each contiguous
        row range (shard k owns rows [k*G/gs, (k+1)*G/gs))."""
        gs = self.groups_shards
        return self.demand.reshape(gs, self.n_groups // gs).sum(axis=1)

    def shard_of_row(self, row: int) -> int:
        return int(row) // (self.n_groups // self.groups_shards)

    def shard_range(self, shard: int) -> tuple:
        per = self.n_groups // self.groups_shards
        return shard * per, (shard + 1) * per

    # --------------------------------------------------------------- motion
    def move_row(self, old_row: int, new_row: int) -> None:
        """Carry a migrated group's EWMA to its new row so the rebalancer
        sees the load move immediately instead of re-learning it (and the
        source shard doesn't look hot for another decay horizon)."""
        self.demand[new_row] = self.demand[old_row]
        self.demand[old_row] = 0.0
        if self.device_demand is not None:
            # host mirror is authoritative for planning; the device copy
            # re-converges within one decay horizon, so we only patch host.
            pass

    def clear_row(self, row: int) -> None:
        self.demand[row] = 0.0
