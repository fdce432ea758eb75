"""Config registry: the sections the managers, the Mode B nodes, the
control plane and the per-process server read, and the properties loader.

Copies of the reference's dataclasses, with the same fields, the same
defaults and the same checks, so one properties file configures either
package.

:func:`load_properties` reads a ``gigapaxos.properties``-style file (the
``active.*`` / ``reconfigurator.*`` topology lines, ``universe=``, flat
``section.field=value`` tuning keys), then applies the environment
overrides ``GPTPU_<SECTION>_<FIELD>`` (e.g. ``GPTPU_PAXOS_WINDOW=16``,
:func:`apply_env_overrides`); every override path re-runs the dataclass
checks (:func:`validate`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class PaxosTuning:
    """Data-plane knobs (analog of PaxosConfig.PC, PaxosConfig.java:208)."""

    # Max groups per shard (rows in the dense state arrays).
    max_groups: int = 1024
    # Out-of-order window W per group: ring-buffer depth for accepted pvalues
    # and undelivered decisions (replaces the reference's sparse
    # accepted/committed maps, PaxosAcceptor.java:108-115).  Power of two.
    # Default 4: tick cost scales with W (the ring gathers do W-way selects
    # over W planes).  Raise it for
    # workloads with deep per-group pipelining or laggy replicas: a replica
    # more than W slots behind can no longer catch up from the decision
    # ring and needs a full checkpoint transfer (gap-sync; see README
    # "Choosing the window").
    window: int = 4
    # Max replicas per group (padding width of the member table).
    max_replicas: int = 3
    # Register-mode group capacity (RMWPaxos, arxiv 2001.03362): rows for
    # groups whose consensus runs IN PLACE on a single-cell register
    # (W=1 ring) instead of a slot log.  The manager holds them in a
    # second dense plane alongside the log plane; a new decision
    # overwrites the register (carry-forward), so per-group HBM is ~W×
    # smaller and checkpoint size stops growing with decision count.
    # Laggard repair ships the register (checkpoint transfer), never slot
    # replay.  0 = no register plane (bit-identical to pre-register
    # builds).  Composite rows [0, max_groups) are log mode and
    # [max_groups, max_groups + register_groups) are register mode — the
    # row index IS the mode bit.
    register_groups: int = 0
    # Max new proposals accepted per group per tick at each entry replica.
    proposals_per_tick: int = 4
    # Checkpoint every this many executed slots per group
    # (PaxosInstanceStateMachine.java:123-130 CHECKPOINT_INTERVAL analog).
    checkpoint_interval: int = 400
    # How many ticks of inbox log between forced journal fsyncs.
    sync_every_ticks: int = 1
    # Deactivation: spill groups idle for this many ticks to host (pause
    # analog, PaxosManager.java:2284-2365).
    deactivation_ticks: int = 10_000
    # Demand-paged pause store (DiskMap analog, utils/DiskMap.java:97):
    # paused-group records beyond spill_cache page to spill_dir ("" = RAM
    # only — the paused set is then bounded by host memory).
    spill_dir: str = ""
    spill_cache: int = 4096
    # Pipelined ticks (SURVEY §2.2 item 3, the BatchedLogger/RequestBatcher
    # stage overlap): process tick N-1's decision stream (host app
    # execution) while the device computes tick N and the WAL drains.
    # Costs one tick of response latency; checkpoints drain synchronously.
    pipeline_ticks: bool = False
    # Compacted outbox: the device prefix-sum-compacts the executed
    # decision stream to O(decisions) instead of shipping the full
    # O(R*W*G) outbox, and the manager's host loop goes vectorized
    # (bulk store + execute_batch).  Required to run the REAL manager
    # stack at 100k-1M groups; leave off for tiny-G control planes where
    # the full outbox is cheaper than a second compiled program.
    compact_outbox: bool = False
    # Per-tick cap on executions the device extracts (0 = auto: 2 *
    # max_groups, min 4096).  Bounds the compacted transfer; overflow is
    # deferred in-ring, not dropped (lossless backpressure).
    exec_budget: int = 0
    # Compacted laggard list size (lag >= window -> checkpoint transfer).
    lag_budget: int = 1024
    # Compact path: automatically run checkpoint transfers for replicas the
    # device reports >= window behind (the reference's laggards repair
    # automatically too, via handleSyncDecisionsPacket -> checkpoint
    # transfer, PaxosInstanceStateMachine.java:1852).  Transfers are
    # journaled (OP_SYNC) so WAL replay reproduces them.
    auto_laggard_sync: bool = True
    # Compact path: use the tick's device-computed donor summary (donor id,
    # donor exec watermark/status, laggard exec — the l_* columns of the
    # compact buffer) for those transfers, so repair scheduling never pulls
    # [R, G] state to the host.  Off = legacy host scan re-derives the donor
    # from a full exec_slot transfer (kept for A/B bit-identity tests; both
    # paths journal the same OP_SYNC records).
    device_donor_sel: bool = True
    # Bulk request-store capacity (0 = auto: 4 * max_groups, min 65536,
    # rounded up to a power of two).  Bounds requests in flight on the
    # propose_bulk path (MAX_OUTSTANDING_REQUESTS analog).
    bulk_capacity: int = 0
    # Device-resident application (models/device_kv.py): the manager owns
    # a DeviceKVState, request descriptors upload inside the fused tick,
    # and decisions execute ON DEVICE — the decision stream never crosses
    # to the host except as the compacted bookkeeping/response arrays.
    # Requires compact_outbox.
    device_app: bool = False
    # KV slots per group (power of two) and descriptor-table size
    # (0 = auto: 4 * max_groups rounded up to a power of two, min 65536).
    kv_slots: int = 8
    kv_table: int = 0
    # Max descriptor uploads per tick (0 = auto: 2 * max_groups).  Staged
    # admissions beyond it defer (their placement waits with them).
    kv_reg_budget: int = 0
    # Digest-only accepts (PendingDigests, paxosutil/PendingDigests.java:23;
    # match/release PaxosInstanceStateMachine.java:1089-1102, undigest
    # :1257-1268): the ENTRY node broadcasts a request's payload once; the
    # coordinator's frames place only the rid (the ring columns are already
    # digest-shaped), and a receiver holding a rid without its payload
    # resolves it with an undigest fetch before execution.  Off by default
    # (SURVEY: bandwidth on ICI is cheap); turn on for fat payloads on
    # thin DCN links.
    digest_accepts: bool = False
    # How many ticks a rid-without-payload may stall its row's execution
    # stream (undigest fetches retried underneath) before the node gives
    # up and repairs by checkpoint transfer instead.
    undigest_timeout_ticks: int = 256
    # Digest ordering becomes the DEFAULT at scale: a Mode B node whose
    # boot universe has at least this many members turns digest_accepts on
    # by itself (HT-Paxos, arxiv 1407.1237 — acceptors order ids, payload
    # dissemination is a separate concern).  Coordinator egress otherwise
    # grows linearly in R because every decision's payload fans out to
    # R-1 peers.  0 disables the threshold; evaluated once at construction
    # (a runtime expand_universe past the threshold does not flip a
    # running cluster's wire protocol mid-flight).
    digest_min_replicas: int = 5
    # Ring payload dissemination (HT-Ring Paxos, arxiv 1507.04086): with
    # digest ordering on, payload bytes leave a node on exactly ONE
    # downstream link per tick — a columnar relay slab forwarded around
    # the alive members in id order — instead of fanning out to R-1
    # peers.  Each payload crosses each peer link at most once, so entry
    # egress stays ~flat in R.  A slab lost to a crash mid-relay falls
    # back to the undigest fetch + anti-entropy path.  No effect unless
    # digest ordering is on (explicitly or via digest_min_replicas).
    ring_dissemination: bool = True
    # Mode A WAL payload dedup: log_inbox journals a payload's bytes once
    # per checkpoint epoch; re-proposals of the same bytes journal an
    # 8-byte digest reference instead (resolved during replay from the
    # snapshot + earlier journal records, so recovery stays bit-identical).
    # Pairs with the digest-keyed payload interning in paxos/manager.py.
    wal_payload_dedup: bool = True
    # MEASUREMENT-ONLY baseline modes for attributing replication cost
    # (PaxosManager.java:1751-1799 emulateUnreplicated/emulateLazyPropagation,
    # EXECUTE_UPON_ACCEPT PaxosInstanceStateMachine.java:1077).  Never set
    # on a real deployment: both break agreement/durability by design.
    # unreplicated: propose_bulk executes at the entry replica immediately
    # and responds — no coordination, no journal, nothing replicated.
    emulate_unreplicated: bool = False
    # lazy_propagation: the entry replica executes + responds immediately;
    # the request still rides the normal consensus stream so OTHER replicas
    # converge eventually (response latency excludes the quorum round).
    lazy_propagation: bool = False
    # Sharded data plane (parallel/shard_tick): partition the dense state
    # over a (replica, groups) device mesh and run the tick as a shard_map
    # program — each shard computes on its concrete local block (the pallas
    # ring gather stays enabled per-shard) and cross-replica quorum exchange
    # is an explicit all_gather over the replica mesh axis.  0 = off
    # (single-device program); -1 = all visible devices; N > 0 = first N
    # devices.  Device count must be divisible by mesh_replica_shards, and
    # the replica/group dims by their shard counts.
    mesh_devices: int = 0
    # How many shards the replica axis splits into (the rest of the mesh
    # devices form the groups axis, which never communicates).  1 = pure
    # group-data-parallelism, zero collectives in the hot phases (the
    # v5e-4 deployment shape).
    mesh_replica_shards: int = 1
    # Consecutive-ballot fast re-election (arxiv 2006.01885): a candidate
    # whose promised ballot is the group-max among member rows takes over
    # at the predecessor's successor ballot WITHOUT a prepare round —
    # straight to coord_active, seeding proposals from its own mirrors.
    # Safety is preserved by marking such ballots "fast" (coord_fast):
    # acceptors refuse a fast push that would overwrite a *different*
    # accepted value, and the fast coordinator adopts any higher-ballot
    # accepted value it can see, bumping its (still consecutive) ballot.
    # Mode B only (Mode A elections already complete same-tick); default
    # off — the legacy election path is bit-identical when disabled.
    fast_reelection: bool = False
    # Leader leases (ISSUE 17): a lease-holding replica answers reads
    # locally (no consensus round) iff its lease is valid AND the group is
    # quiescent (executed frontier == accepted frontier).  Lease state is
    # dense [G] device columns folded inside the fused tick; time is the
    # tick clock itself, so lease decisions replay deterministically from
    # the WAL.  Default off — the lease-off build runs the literal
    # pre-lease tick program, bit for bit (the register_groups=0 pattern).
    read_leases: bool = False
    # Lease horizon in ticks: a grant/renewal is valid for this many ticks.
    lease_ticks: int = 64
    # Skew margin in ticks: a coordinator other than the holder may not
    # admit new writes until margin ticks past expiry, so a holder whose
    # clock runs up to margin ticks slow still stops serving reads before
    # any conflicting write can be acked.
    lease_margin_ticks: int = 8
    # Group-health plane (ISSUE 18): per-group last-commit age,
    # coordinator-churn score, wedge detection and intake heat folded
    # inside the fused tick, reduced on device into log2 histograms +
    # scalar gauges + top-K anomaly columns (one O(K) host pull per tick).
    # Observation-only: the fold never feeds back into consensus, and with
    # the flag off the tick programs are the literal pre-health functions,
    # bit for bit (the read_leases=off pattern).
    group_health: bool = False
    # Top-K rows shipped per criterion (stuckest / churniest / hottest).
    health_topk: int = 8
    # A group with device-visible backlog and no commit/exec progress for
    # this many consecutive ticks counts as wedged.
    health_wedge_ticks: int = 32
    # EWMA decay shift for the churn/heat scores: per tick each score
    # loses 1/2**shift of itself (shift 6 ~ a 64-tick window).
    health_decay_shift: int = 6
    # Tick coalescing: minimum spacing between driver ticks while busy.
    # Each tick has a fixed host cost (admission, placement, compaction
    # unpack); spacing ticks lets requests accumulate so that cost
    # amortizes — the RequestBatcher's adaptive-sleep idea
    # (RequestBatcher.java:25-60) as a pacing floor.  Adds up to this much
    # commit latency; 0 = tick as fast as possible.
    min_tick_interval_s: float = 0.0

    def __post_init__(self) -> None:
        if self.window < 2 or (self.window & (self.window - 1)):
            raise ValueError(
                f"window must be a power of two >= 2, got {self.window}"
            )
        if self.register_groups < 0:
            raise ValueError(
                f"register_groups must be >= 0, got {self.register_groups}"
            )
        if self.read_leases and self.lease_ticks < 1:
            raise ValueError(
                f"lease_ticks must be >= 1, got {self.lease_ticks}"
            )
        if self.lease_margin_ticks < 0:
            raise ValueError(
                f"lease_margin_ticks must be >= 0, got "
                f"{self.lease_margin_ticks}"
            )
        if self.group_health:
            if self.health_topk < 1:
                raise ValueError(
                    f"health_topk must be >= 1, got {self.health_topk}"
                )
            if self.health_wedge_ticks < 1:
                raise ValueError(
                    f"health_wedge_ticks must be >= 1, got "
                    f"{self.health_wedge_ticks}"
                )
            if not (0 <= self.health_decay_shift <= 15):
                raise ValueError(
                    f"health_decay_shift must be in [0, 15], got "
                    f"{self.health_decay_shift}"
                )
        if self.compact_outbox and self.proposals_per_tick > 31:
            # taken_bits packs the P intake slots into one int32 lane
            raise ValueError(
                "compact_outbox packs intake acceptance into 31 bits; "
                f"proposals_per_tick={self.proposals_per_tick} exceeds it"
            )


@dataclass
class ObsConfig:
    """Flight-deck plane (obs/): scrape endpoints, tracing, flight recorder.

    Properties keys: ``obs.http_port=9464``, ``obs.trace_wire=true``, ...
    Metric *recording* is compiled in/out by the ``GPTPU_METRICS`` env var
    (read once at process start — it swaps no-op metric objects in at
    construction time, so it cannot be a config field).
    """

    # Per-node Prometheus scrape endpoint port (server.py / ModeBServer):
    # -1 = off, 0 = ephemeral (tests; actual port is logged), >0 = fixed.
    http_port: int = -1
    # Host-level supervisor scrape endpoint (cells): one /metrics merging
    # every cell with per-cell labels + supervisor gauges.  Same semantics.
    sup_http_port: int = -1
    # Stamp client app requests with a cross-process trace id ("trace" wire
    # key); equivalent to GPTPU_REQTRACE on the client process.
    trace_wire: bool = False
    # Opt-in exact device phase timing: block on the dispatch result and
    # record a "device_step" phase (costs the pipeline overlap — bench-style
    # measurement, not for production).
    blocking_phases: bool = False
    # Flight recorder: ring capacity and artifact directory ("" = alongside
    # the WAL / base dir of whatever plane hosts the recorder).
    flight_cap: int = 256
    flight_dir: str = ""
    # Scenario timeline recorder sample interval (obs/timeline.py); the
    # /timeline route serves the sampled series + event annotations.
    timeline_interval_s: float = 0.25

    def __post_init__(self) -> None:
        if self.flight_cap < 8:
            raise ValueError(f"obs.flight_cap must be >= 8, got {self.flight_cap}")


@dataclass
class OverloadConfig:
    """Overload-robustness plane (ISSUE 14): classed admission control,
    deadline propagation, and client-side retry damping.

    Properties keys: ``overload.intake_hi=4096``, env overrides
    ``GPTPU_OVERLOAD_<FIELD>``.  The invariant: finish or refuse fast,
    never silently drop or do dead work.
    """

    # Master switch for the node-side intake governor (deadline drops and
    # per-class transport budgets are always on — they are pure wins).
    enabled: bool = True
    # Watermark-with-hysteresis admission at the node intake, measured in
    # outstanding client requests (staged + in-flight).  Crossing
    # ``intake_hi`` starts shedding client-class proposes with a retriable
    # busy NACK; shedding stops below ``intake_lo`` (0 = intake_hi // 2).
    intake_hi: int = 4096
    intake_lo: int = 0
    # Client retry budget: each fresh request funds ``retry_fraction``
    # retry tokens (the ~10%% rule); ``retry_initial`` seeds a cold-start
    # burst, ``retry_cap`` bounds banking.
    retry_fraction: float = 0.1
    retry_initial: float = 3.0
    retry_cap: float = 50.0
    # Per-destination circuit breaker: trip after ``breaker_threshold``
    # consecutive NACK/timeout failures (or >= 50%% of a sliding window),
    # avoid the destination for ``breaker_cooloff_s`` (doubling, capped).
    breaker_threshold: int = 5
    breaker_cooloff_s: float = 1.0
    # Default wire deadline stamped on client requests that give none
    # (<= 0 disables stamping; explicit per-call deadlines always win).
    default_deadline_s: float = 15.0
    # Transport send-queue budget for client-class frames, as a fraction
    # of ``paxos.send_queue_cap`` (control class keeps the full cap, so
    # liveness traffic always has headroom a client flood cannot take).
    client_queue_frac: float = 0.75
    # Transport send-queue budget for read-class frames (ISSUE 17): reads
    # get their own bounded lane so a read flood backpressures reads, not
    # writes (and control stays untouched as ever).
    read_queue_frac: float = 0.5

    def __post_init__(self) -> None:
        if self.intake_hi < 2:
            raise ValueError(
                f"overload.intake_hi must be >= 2, got {self.intake_hi}")
        if self.intake_lo and self.intake_lo >= self.intake_hi:
            raise ValueError(
                f"overload.intake_lo ({self.intake_lo}) must be < "
                f"intake_hi ({self.intake_hi}) — the hysteresis band")
        if not (0.0 < self.retry_fraction <= 1.0):
            raise ValueError(
                f"overload.retry_fraction must be in (0, 1], got "
                f"{self.retry_fraction}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"overload.breaker_threshold must be >= 1, got "
                f"{self.breaker_threshold}")
        if not (0.0 < self.client_queue_frac <= 1.0):
            raise ValueError(
                f"overload.client_queue_frac must be in (0, 1], got "
                f"{self.client_queue_frac}")
        if not (0.0 < self.read_queue_frac <= 1.0):
            raise ValueError(
                f"overload.read_queue_frac must be in (0, 1], got "
                f"{self.read_queue_frac}")


@dataclass
class PlacementConfig:
    """Placement plane: demand counters + shard rebalancer (placement/).

    A mesh "shard" is a contiguous row range of the groups axis
    (``G / groups_shards`` rows each, matching ``parallel/mesh.make_mesh``).
    The placement plane folds per-group demand into EWMA rate counters,
    detects hot/cold shards against ``skew_threshold``, and live-migrates
    group rows between shard ranges through the stop/start epoch protocol
    (placement/migrator.py).  All knobs mirror the demand SPI's rate-limit
    shape (reconfiguration/demand.py ``min_interval_s`` /
    ``min_requests_between``).
    """

    # Master switch: attach demand counters to the manager and (mesh +
    # compact path) fold the per-group demand EWMA on device inside the
    # compaction dispatch.
    enabled: bool = False
    # Per-tick EWMA decay of the per-group demand counter (device fold:
    # demand' = decay * demand + decided_now).  0.9 ~ a
    # ten-tick horizon; closer to 1.0 = smoother, slower to react.
    ewma_decay: float = 0.9
    # Host-fold sampling cadence: fold accumulated intake into the EWMA
    # (and refresh shard loads) every this many ticks.
    sample_every_ticks: int = 8
    # Rebalance trigger: max/min shard-load ratio above which a plan is
    # emitted (loads below ``min_shard_load`` count as idle floor, so an
    # empty shard does not make the ratio infinite).
    skew_threshold: float = 2.0
    # Hysteresis: after a plan executes, shard loads must exceed the
    # threshold by this factor before the NEXT plan (flap damping).
    hysteresis: float = 1.25
    # Rate limits, mirroring demand.py's _rate_limited guards.
    min_interval_ticks: int = 64
    min_moves_between: int = 0  # reserved: min demand delta between plans
    # Per-plan cap on migrations (greedy bin-pack picks the hottest groups
    # first; a huge plan would stall the tick loop on stop/start churn).
    max_moves_per_plan: int = 4
    # Idle floor for the skew ratio denominator (EWMA units).
    min_shard_load: float = 1e-3

    def __post_init__(self) -> None:
        if not (0.0 < self.ewma_decay < 1.0):
            raise ValueError(
                f"placement.ewma_decay must be in (0, 1), got {self.ewma_decay}"
            )
        if self.skew_threshold < 1.0:
            raise ValueError(
                f"placement.skew_threshold must be >= 1, got {self.skew_threshold}"
            )
        if self.hysteresis < 1.0:
            raise ValueError(
                f"placement.hysteresis must be >= 1, got {self.hysteresis}"
            )


@dataclass
class CellsConfig:
    """Serving-cell host plane (cells/): N crash-isolated Mode A manager
    processes per host, each owning ``crc32(name) % n_cells`` of the group
    space with its own tick driver, WAL directory and transport endpoint,
    under a :class:`cells.CellSupervisor`.

    Properties keys: ``cells.n_cells=4``, ``cells.pin_cores=true``, ... —
    see README "Serving cells" for sizing guidance (one cell per physical
    core, minus one for the supervisor/edge).
    """

    # Master switch for server.py --cells bootstrap (the library API takes
    # explicit constructor args and ignores this).
    enabled: bool = False
    # Cells per host.  0 = auto: max(1, os.cpu_count() - 1).
    n_cells: int = 0
    # Per-cell topology (each cell is a full InProcessCluster).
    n_actives: int = 3
    n_reconfigurators: int = 1
    # Pin each cell worker to one core via sched_setaffinity (cell k ->
    # core k % cpu_count).  Ignored on platforms without affinity support.
    pin_cores: bool = True
    # SO_REUSEPORT shared edge port (0 = no edge): every cell binds the same
    # port and forwards mis-routed first requests to the owner cell, so a
    # client with no placement table still reaches any group through one
    # well-known address.
    edge_port: int = 0
    # Supervisor heartbeats (EWMA FailureDetection over the control socket).
    heartbeat_interval_s: float = 0.25
    heartbeat_timeout_s: float = 3.0
    # Crash restart policy: exponential backoff base and per-cell cap.
    restart_backoff_s: float = 0.5
    max_restarts: int = 8
    # Graceful SIGTERM drain budget before the supervisor escalates.
    drain_timeout_s: float = 10.0

    def __post_init__(self) -> None:
        if self.n_cells < 0:
            raise ValueError(f"cells.n_cells must be >= 0, got {self.n_cells}")
        if self.n_actives < 1 or self.n_reconfigurators < 1:
            raise ValueError("cells need >= 1 active and >= 1 reconfigurator")


@dataclass
class FailureDetectionConfig:
    """FailureDetection.java:63-76 analog (host-level, per node pair)."""

    ping_interval_s: float = 0.1  # max 1 ping / 100ms, FailureDetection.java:65-66
    timeout_s: float = 3.0
    coordinator_failover_grace_ticks: int = 2
    # Adaptive timeout (Jacobson/TCP-RTO style): per-node EWMA of ping
    # inter-arrival gaps; effective timeout = max(timeout_s,
    # adaptive_beta * (mean + 4 * meandev)).  Jittery WAN links then get a
    # longer fuse than the static floor, so transient delay spikes don't
    # flap the alive mask and trigger dueling-coordinator churn; quiet
    # links keep the configured floor.
    adaptive: bool = False
    adaptive_beta: float = 1.5
    adaptive_gain: float = 0.125  # EWMA gain for mean and mean deviation


@dataclass
class SSLConfig:
    """Transport security (SSL stack analog,
    nio/SSLDataProcessingWorker.java:59: CLEAR/SERVER_AUTH/MUTUAL_AUTH,
    selected per deployment like ReconfigurableNode.java:298).

    Properties keys: ``ssl.mode=mutual_auth``, ``ssl.certfile=...``,
    ``ssl.keyfile=...``, ``ssl.cafile=...``.
    """

    mode: str = "clear"  # clear | server_auth | mutual_auth
    certfile: str = ""
    keyfile: str = ""
    cafile: str = ""

    def __post_init__(self) -> None:
        if self.mode not in ("clear", "server_auth", "mutual_auth"):
            raise ValueError(f"bad ssl.mode {self.mode!r}")


@dataclass
class NodeConfig:
    """Cluster topology: node id -> (host, port).

    Mirrors the ``active.*`` / ``reconfigurator.*`` lines of
    ``gigapaxos.properties`` so reference fixtures translate directly.
    """

    actives: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    reconfigurators: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    # Explicit replica-slot order for Mode B universes (boot topology +
    # runtime-added nodes in committed order; slots of removed nodes are
    # retained, never recycled).  Empty = sorted actives — correct ONLY for
    # clusters whose node set never changed.  After ANY add/remove, a node
    # restoring without its own WAL must boot with the committed order
    # (properties key ``universe=A0,A1,...``, returned by the add_active
    # response) or its slot indices silently diverge from the incumbents'.
    # Nodes with an intact WAL recover their member list from it.
    universe: List[str] = field(default_factory=list)

    def active_ids(self):
        return sorted(self.actives)

    def universe_order(self):
        return list(self.universe) if self.universe else sorted(self.actives)

    def reconfigurator_ids(self):
        return sorted(self.reconfigurators)


@dataclass
class GigapaxosTpuConfig:
    paxos: PaxosTuning = field(default_factory=PaxosTuning)
    placement: PlacementConfig = field(default_factory=PlacementConfig)
    fd: FailureDetectionConfig = field(default_factory=FailureDetectionConfig)
    ssl: SSLConfig = field(default_factory=SSLConfig)
    cells: CellsConfig = field(default_factory=CellsConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    nodes: NodeConfig = field(default_factory=NodeConfig)
    # WAL directory; None = in-memory only (tests).
    log_dir: str | None = None
    # Periodic stats dumps via logging (0 = off; PaxosManager.java:482-494
    # outstanding-dump analog).  Flat properties key: stats_interval_s=10
    stats_interval_s: float = 0.0
    # Use the C++ journal backend (csrc/journal.cc) for planes opened from
    # a WAL directory.
    native_journal: bool = True


def _parse_scalar(txt: str, ty: type):
    if ty is bool:
        return txt.strip().lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(txt)
    if ty is float:
        return float(txt)
    return txt


def load_properties(path: str) -> GigapaxosTpuConfig:
    """Load a gigapaxos.properties-style file.

    Recognized keys: ``active.<ID>=host:port``, ``reconfigurator.<ID>=host:port``
    and flat tuning keys like ``paxos.window=16`` / ``fd.timeout_s=5``.
    Unknown keys are ignored (the reference likewise ignores params it does
    not know, utils/Config.java:150-170).
    """
    cfg = GigapaxosTpuConfig()
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(("#", "!")):
                continue
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            key, val = key.strip(), val.strip()
            if key == "universe":
                cfg.nodes.universe = [x.strip() for x in val.split(",") if x.strip()]
            elif key.startswith("active."):
                host, port = val.rsplit(":", 1)
                cfg.nodes.actives[key[len("active.") :]] = (host, int(port))
            elif key.startswith("reconfigurator."):
                host, port = val.rsplit(":", 1)
                cfg.nodes.reconfigurators[key[len("reconfigurator.") :]] = (
                    host,
                    int(port),
                )
            elif "." in key:
                section, fname = key.split(".", 1)
                sub = getattr(cfg, section, None)
                if sub is not None and dataclasses.is_dataclass(sub):
                    for f_ in dataclasses.fields(sub):
                        if f_.name == fname:
                            setattr(
                                sub,
                                fname,
                                _parse_scalar(val, type(getattr(sub, fname))),
                            )
            elif hasattr(cfg, key):
                cur = getattr(cfg, key)
                setattr(cfg, key, _parse_scalar(val, type(cur) if cur is not None else str))
    apply_env_overrides(cfg)
    return cfg


def apply_env_overrides(cfg: GigapaxosTpuConfig) -> None:
    """Apply ``GPTPU_<SECTION>_<FIELD>`` environment overrides and re-validate."""
    for sub_name in ("paxos", "placement", "fd", "ssl", "cells", "obs",
                     "overload"):
        sub = getattr(cfg, sub_name)
        for f_ in dataclasses.fields(sub):
            env = os.environ.get(f"GPTPU_{sub_name.upper()}_{f_.name.upper()}")
            if env is not None:
                setattr(sub, f_.name, _parse_scalar(env, type(getattr(sub, f_.name))))
    validate(cfg)


def validate(cfg: GigapaxosTpuConfig) -> None:
    """Re-run dataclass validation (setattr bypasses ``__post_init__``)."""
    for sub_name in ("paxos", "placement", "fd", "ssl", "cells", "obs",
                     "overload"):
        sub = getattr(cfg, sub_name)
        post = getattr(sub, "__post_init__", None)
        if post is not None:
            post()
