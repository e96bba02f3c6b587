"""Scenario definitions: mainnet-shaped traffic mixes, seeded + deterministic.

Mainnet shape (the ratios, not the absolute scale): every active validator
attests exactly once per epoch, so a subscribed-to-everything node sees
roughly `n_validators / 32` single-bit attestations per slot; each of the
up-to-64 committees elects ~16 aggregators, so aggregates arrive at
`committees * 16` per slot; and there is one block per slot. The generator
jitters each count ±10% from the scenario seed so queues see realistic
unevenness while staying bit-reproducible.

`stale_fraction` mixes in attestations stamped with a slot older than the
propagation window — replayed/late gossip whose deadline has already
passed, which MUST be shed `expired` at pop, never verified.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, replace

SLOTS_PER_EPOCH = 32          # mainnet shape
AGGREGATORS_PER_COMMITTEE = 16
MAX_COMMITTEES_PER_SLOT = 64


@dataclass(frozen=True)
class SlotTraffic:
    attestations: int
    aggregates: int
    blocks: int
    stale_attestations: int = 0


@dataclass
class Scenario:
    name: str
    n_validators: int = 16384
    slots: int = 8
    seed: int = 0xC0FFEE
    # open-loop multiplier over the mainnet-shaped per-slot counts
    flood_factor: float = 1.0
    # fraction of attestations stamped past the propagation window
    stale_fraction: float = 0.0
    # fault injections: "device_stall" stalls the device backend over
    # stall_slots; "slow_host" adds per-batch host latency; "storage_crash"
    # tears the durable head write at crash_slot and kills the node, then
    # the runner restarts it from the same datadir (crash_restart scenario);
    # "mesh_stall" stalls ONE chip's shard of the mesh device over
    # stall_slots (the collective blocks — loadgen/meshsim.py)
    faults: tuple = ()
    stall_slots: tuple = (2, 4)      # [start, end) in scenario slots
    crash_slot: int | None = None    # storage_crash: slot whose head write tears
    # mesh serving (loadgen/meshsim.py): mesh=True routes batches through
    # a real PipelinedDispatcher over an N-chip mesh device sim whose chip
    # count resolves against parallel.get_mesh() (mesh_devices overrides —
    # the --mesh-devices sweep's points); mesh_stall_chip names the chip
    # the "mesh_stall" fault wedges (chip 1 by default: the urgent lane is
    # pinned to chip 0 and must keep serving through the stall)
    mesh: bool = False
    mesh_devices: int | None = None
    mesh_stall_chip: int = 1
    # queue bounds for the attestation/aggregate queues (None = processor
    # defaults); flood scenarios shrink them so shedding is observable in
    # a few seconds instead of at mainnet scale
    att_queue_cap: int | None = None
    agg_queue_cap: int | None = None
    seconds_per_slot: float = 1.0    # logical (manual-clock) seconds


def mainnet_mix(n_validators: int, rng: random.Random) -> SlotTraffic:
    atts = max(1, n_validators // SLOTS_PER_EPOCH)
    committees = max(1, min(MAX_COMMITTEES_PER_SLOT, atts // 128))
    aggs = committees * AGGREGATORS_PER_COMMITTEE

    def jitter(n: int) -> int:
        return max(1, int(n * (0.9 + 0.2 * rng.random())))

    return SlotTraffic(jitter(atts), jitter(aggs), 1)


def traffic_schedule(sc: Scenario) -> list[SlotTraffic]:
    """Per-slot traffic for the whole scenario — pure function of the
    scenario (seeded RNG), so a report is reproducible from (name, seed)."""
    rng = random.Random(sc.seed)
    out = []
    for _slot in range(sc.slots):
        base = mainnet_mix(sc.n_validators, rng)
        atts = int(base.attestations * sc.flood_factor)
        stale = int(atts * sc.stale_fraction)
        out.append(
            SlotTraffic(
                attestations=atts - stale,
                aggregates=int(base.aggregates * sc.flood_factor),
                blocks=base.blocks,
                stale_attestations=stale,
            )
        )
    return out


SCENARIOS: dict[str, Scenario] = {
    # ~5 s CPU-only sanity pass: modest traffic, every code path exercised
    # (flood over the shrunk queue caps -> oldest-first sheds; stale mix ->
    # expiry; device stall mid-run -> full breaker cycle)
    "smoke": Scenario(
        name="smoke", n_validators=4096, slots=6, flood_factor=3.0,
        stale_fraction=0.1, faults=("device_stall",), stall_slots=(2, 4),
        att_queue_cap=256, agg_queue_cap=64,
    ),
    # steady mainnet-shaped mix, no faults — the control run
    "steady": Scenario(
        name="steady", n_validators=16384, slots=8,
    ),
    # 4x open-loop flood over deliberately small queues: oldest-first
    # shedding + admission refusals under pressure
    "flood": Scenario(
        name="flood", n_validators=16384, slots=8, flood_factor=4.0,
        stale_fraction=0.05, att_queue_cap=512, agg_queue_cap=128,
    ),
    # device stalls mid-run while the flood continues: the circuit breaker
    # must open, the host path serve, and the breaker close after recovery
    "device_stall": Scenario(
        name="device_stall", n_validators=16384, slots=10, flood_factor=2.0,
        faults=("device_stall",), stall_slots=(3, 6),
        att_queue_cap=1024, agg_queue_cap=256,
    ),
    # slow host verification under flood: queues stay hot, deadlines bite
    "slow_host": Scenario(
        name="slow_host", n_validators=8192, slots=8, flood_factor=2.0,
        faults=("slow_host",), stale_fraction=0.1,
        att_queue_cap=512, agg_queue_cap=128,
    ),
    # one chip of the mesh wedges mid-run while the flood continues: the
    # collective blocks every SHARDED batch, the breaker must open and the
    # host path serve (SLO ratio dips), the urgent lane (pinned to chip 0)
    # keeps serving, and the heal must close the breaker — the multichip
    # analog of device_stall, proving a stalled shard degrades gracefully
    # instead of wedging the pipeline window
    "mesh_stall": Scenario(
        name="mesh_stall", n_validators=16384, slots=10, flood_factor=2.0,
        mesh=True, faults=("mesh_stall",), stall_slots=(3, 6),
        att_queue_cap=1024, agg_queue_cap=256,
    ),
    # crash recovery proof: mainnet-shaped load over a DURABLE store whose
    # head write tears mid-record at crash_slot (the node "dies"); the
    # runner restarts from the same datadir, asserts the recovered head is
    # the last durably persisted one, and finishes the run — conservation
    # extends to published == processed + dropped + expired + lost_to_crash
    "crash_restart": Scenario(
        name="crash_restart", n_validators=4096, slots=8, flood_factor=2.0,
        stale_fraction=0.1, faults=("storage_crash",), crash_slot=4,
        att_queue_cap=256, agg_queue_cap=64,
    ),
}


def smoke_variant(sc: Scenario) -> Scenario:
    """Any scenario shrunk to smoke scale (CPU-only, seconds) without
    changing its SHAPE: same faults, same mix, clamped size. This is what
    `--smoke` combined with an explicit `--scenario` runs."""
    out = replace(
        sc,
        n_validators=min(sc.n_validators, 4096),
        slots=min(sc.slots, 8),
    )
    if out.crash_slot is not None:
        out.crash_slot = max(1, min(out.crash_slot, out.slots - 2))
    s0, s1 = out.stall_slots
    out.stall_slots = (min(s0, max(0, out.slots - 2)), min(s1, out.slots))
    return out


def get_scenario(name: str, **overrides) -> Scenario:
    """A named scenario, optionally with field overrides (CLI flags)."""
    base = SCENARIOS.get(name)
    if base is None:
        have = (
            sorted(SCENARIOS) + sorted(CAPACITY_SCENARIOS)
            + sorted(STATE_ROOT_SCENARIOS) + sorted(MIXED_DUTY_SCENARIOS)
            + sorted(MULTINODE_SCENARIOS) + sorted(_ensure_fleet())
        )
        raise KeyError(
            f"unknown scenario {name!r} (have: {', '.join(have)})"
        )
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(base, **overrides) if overrides else replace(base)


# --------------------------------------------------------------- capacity


@dataclass
class CapacityScenario:
    """The closed-loop capacity-control proof (loadgen/capacity.py): a
    deterministic device-time-ledger sim where batch sizing genuinely
    matters (padded pow2 lane costs + per-batch base overhead, the torchbls
    padding-bucket economics) driven through the REAL BeaconProcessor +
    AdmissionController + CapacityScheduler + SlotAccountant. The driver
    runs the controller leg (NO pre-installed profile, scheduler retuning
    live) against a static-optimal reference (the best fixed-cap plan
    found by sweeping a pow2 ladder with retuning disabled — the plan an
    oracle `autotune calibrate` would have installed) and FAILS unless
    the controller's deadline-credited throughput lands within
    `gate_ratio` of it."""

    name: str
    n_validators: int = 16384
    slots: int = 24
    seed: int = 0xC0FFEE
    #: per-slot demand curve shape: "ramp" sweeps factor_low -> factor_high
    #: -> back (the diurnal arc); "crowd" holds factor_low with a
    #: factor_high burst over crowd_slots
    profile: str = "ramp"
    factor_low: float = 0.25
    factor_high: float = 2.4
    crowd_slots: tuple = (8, 12)     # [start, end) for profile="crowd"
    #: BULK-class work (chain_segment) submitted per slot: what the
    #: admission watermarks shed when the controller tightens them
    bulk_per_slot: int = 24
    bulk_queue_cap: int = 64
    #: device cost model: a batch of n sets pays
    #: base_ms + per_set_ms * pow2ceil(n) logical milliseconds
    base_ms: float = 25.0
    per_set_ms: float = 0.65
    #: logical device seconds available per slot (the ledger)
    seconds_per_slot: int = 1
    #: extra traffic-free slots that drain backlog before the force-drain
    epilogue_slots: int = 4
    #: controller throughput floor vs the static-optimal reference
    gate_ratio: float = 0.9
    att_queue_cap: int | None = None
    agg_queue_cap: int | None = None


CAPACITY_SCENARIOS: dict[str, CapacityScenario] = {
    # demand sweeps a diurnal arc (0.25x -> 3x mainnet shape -> back),
    # overloading the ledger around the peak: the controller must track
    # the moving knee — pow2-aligned caps per demand phase — from a cold
    # start, with no profile installed
    "diurnal_ramp": CapacityScenario(
        name="diurnal_ramp", profile="ramp", factor_high=3.0,
    ),
    # steady 0.8x with a 5x crowd over slots [8,12): overload is real
    # (the ledger cannot serve the burst), so the controller's job is to
    # widen caps for the backlog, tighten watermarks while burn is over
    # 1x, and recover — and still out-serve (or match) every fixed plan
    "flash_crowd": CapacityScenario(
        name="flash_crowd", profile="crowd", slots=20,
        factor_low=0.8, factor_high=5.0, crowd_slots=(8, 12),
    ),
}


def is_capacity(name: str) -> bool:
    return name in CAPACITY_SCENARIOS


def get_capacity_scenario(name: str, **overrides) -> CapacityScenario:
    base = CAPACITY_SCENARIOS.get(name)
    if base is None:
        raise KeyError(f"unknown capacity scenario {name!r}")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(base, **overrides) if overrides else replace(base)


def capacity_smoke_variant(sc: CapacityScenario) -> CapacityScenario:
    """Seconds-sized clamp, same demand SHAPE (profile + factors are the
    scenario; only scale shrinks). Shrinking the validator count scales
    the per-set cost UP by the same ratio so the demand-to-ledger ratio
    — the saturation physics the gate measures — is preserved; without
    that a smoke run would never stress the ledger and every plan would
    tie. The crowd window slides inside the clamped run so the burst is
    never cut."""
    n_small = min(sc.n_validators, 8192)
    out = replace(
        sc,
        n_validators=n_small,
        per_set_ms=sc.per_set_ms * (sc.n_validators / n_small),
        slots=min(sc.slots, 12),
        epilogue_slots=min(sc.epilogue_slots, 3),
    )
    if out.profile == "crowd":
        s0, s1 = out.crowd_slots
        width = max(1, min(s1 - s0, out.slots - 2))
        s0 = min(s0, out.slots - width - 1)
        out = replace(out, crowd_slots=(s0, s0 + width))
    return out


def capacity_slot_factors(sc: CapacityScenario) -> list[float]:
    """The per-slot demand multipliers — a pure function of the scenario
    (no RNG: jitter stays in mainnet_mix's seeded draw)."""
    import math

    if sc.profile == "crowd":
        s0, s1 = sc.crowd_slots
        return [
            sc.factor_high if s0 <= i < s1 else sc.factor_low
            for i in range(sc.slots)
        ]
    span = max(1, sc.slots - 1)
    return [
        sc.factor_low
        + (sc.factor_high - sc.factor_low) * math.sin(math.pi * i / span)
        for i in range(sc.slots)
    ]


# ------------------------------------------------------------- state root


@dataclass
class StateRootScenario:
    """The second workload's soak: seeded mutate-and-reroot churn over a
    validator-scale BeaconState (loadgen/state_root.py). Every slot
    mutates a block's worth of validators/balances and re-roots through
    the ACTIVE hash backend (bn --hash-backend / the scenario override);
    the run is conservation-checked — the balance ledger must sum and the
    final root must equal a cache-free ground-truth rehash — so a soak
    that passes proves the device path bit-exact under churn, not just on
    a fixture."""

    name: str
    n_validators: int = 16384
    slots: int = 8
    seed: int = 0xC0FFEE
    #: validators whose effective balance (and balance) mutate per slot
    churn_validators: int = 8
    #: additional balance-only mutations per slot
    churn_balances: int = 32
    #: override the process hash backend for the run (None = whatever
    #: bn --hash-backend / env resolved)
    hash_backend: str | None = None


STATE_ROOT_SCENARIOS: dict[str, StateRootScenario] = {
    "state_root": StateRootScenario(name="state_root"),
    # mainnet scale: the CowList-backed registry (ssz/cow.py) — fewer
    # slots because each carries the same churn shape but the fixture
    # build and ground-truth rehash dominate the wall clock
    "state_root_1m": StateRootScenario(
        name="state_root_1m", n_validators=1_048_576, slots=4
    ),
}


def is_state_root(name: str) -> bool:
    return name in STATE_ROOT_SCENARIOS


def get_state_root_scenario(name: str, **overrides) -> StateRootScenario:
    base = STATE_ROOT_SCENARIOS.get(name)
    if base is None:
        raise KeyError(f"unknown state-root scenario {name!r}")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(base, **overrides) if overrides else replace(base)


def state_root_smoke_variant(sc: StateRootScenario) -> StateRootScenario:
    """Seconds-sized clamp, same churn shape (the --smoke modifier)."""
    return replace(
        sc,
        n_validators=min(sc.n_validators, 2048),
        slots=min(sc.slots, 4),
    )


# ------------------------------------------------------------- multi-node


@dataclass
class MultiNodeScenario:
    """A scenario over N full BeaconChain+NetworkNode stacks under a
    network fault plan (loadgen/multinode.py + netfaults.py). These run on
    the MINIMAL spec with the fake BLS backend: the subject is the
    network — forks, partitions, sync, slashing — not the device path, so
    every family is CPU-sized (seconds) by construction and `--smoke` is a
    clamp, not a reshape."""

    name: str
    n_nodes: int = 4
    n_validators: int = 64
    slots: int = 12
    seed: int = 0xC0FFEE
    subnets: int = 2
    #: publish per-validator attestations (the weight fork choice needs to
    #: resolve competing forks); off for families that don't fork
    attest: bool = True
    #: attach a SlasherService to every node (equivocation_storm)
    slasher: bool = False
    #: K: slots after the last heal within which all alive nodes must
    #: agree on one head, or the scenario FAILS
    converge_slots: int = 4
    #: fault plan pieces (loadgen/netfaults.py dataclasses)
    partitions: tuple = ()
    links: tuple = ()
    rpc_faults: tuple = ()
    churn: tuple = ()
    equivocations: tuple = ()
    #: sync_catchup: this node starts detached and range-syncs after
    #: `slots`, then `post_slots` more live slots run with it attached
    catchup_node: int | None = None
    post_slots: int = 2
    #: p2p Req/Resp budget for the in-sim nodes (small: injected faults
    #: raise immediately, real requests are localhost)
    rpc_timeout: float = 2.0
    #: validators owned per node (None = even split); must sum to
    #: n_validators — fork_reorg uses an uneven split so the healed fork
    #: race has a decisive majority
    validator_split: tuple | None = None
    #: fail the run unless >=1 produced block ends up orphaned (the
    #: fork_reorg acceptance: a reorg actually happened)
    expect_reorg: bool = False
    #: route gossip verification through the REAL BeaconProcessor +
    #: CapacityScheduler (harness-pumped, multinode._tick): the capacity
    #: controller under a heal-driven reorg storm — e.g.
    #: `partition_heal` with the controller active must still converge
    #: within K of heal with burn recovering
    batch_gossip: bool = False


def _multinode_scenarios() -> dict[str, MultiNodeScenario]:
    from .netfaults import Equivocation, Partition, RpcFault

    return {
        # 3-vs-1 partition mid-run: the minority node forks or stalls,
        # the heal must reconverge every head within K slots through
        # parent lookups + attestation-weighted fork choice
        "partition_heal": MultiNodeScenario(
            name="partition_heal", n_nodes=4, n_validators=64, slots=12,
            partitions=(Partition(start_slot=4, heal_slot=8,
                                  groups=((0, 1, 2), (3,))),),
            converge_slots=4,
        ),
        # 2-vs-2 node split with UNEVEN stake (48 vs 16 validators) held
        # long enough that BOTH sides grow a fork: the heal forces a real
        # reorg — the minority fork's blocks end up orphaned (the run
        # fails unless >=1 block is reorged out) before convergence
        "fork_reorg": MultiNodeScenario(
            name="fork_reorg", n_nodes=4, n_validators=64, slots=16,
            validator_split=(24, 24, 8, 8),
            partitions=(Partition(start_slot=4, heal_slot=10,
                                  groups=((0, 1), (2, 3))),),
            converge_slots=5, expect_reorg=True,
        ),
        # a node started behind range-syncs to head while the first peer
        # it targets stalls silently mid-range: SyncManager must time out,
        # blame, back off, and fail over to an alternate peer
        "sync_catchup": MultiNodeScenario(
            name="sync_catchup", n_nodes=4, n_validators=32, slots=8,
            attest=False, catchup_node=3, post_slots=2,
            rpc_faults=(RpcFault(
                server=0, start_slot=0, end_slot=10**9, mode="silent",
                protocols=(
                    "/eth2/beacon_chain/req/beacon_blocks_by_range/2/"
                    "ssz_snappy",
                ),
            ),),
        ),
        # repeated double-proposals: every honest node must reject the
        # second block, route both signed headers through its slasher,
        # and the assembled ProposerSlashings must reach later blocks
        "equivocation_storm": MultiNodeScenario(
            name="equivocation_storm", n_nodes=4, n_validators=64,
            slots=12, attest=False, slasher=True,
            equivocations=(Equivocation(slot=3), Equivocation(slot=6),
                           Equivocation(slot=9)),
        ),
    }


# ------------------------------------------------------------------ fleet


@dataclass
class FleetScenario:
    """A validator-fleet soak over the multi-node harness (loadgen/
    fleet.py): real VC stacks (slashing-protected stores, duty services,
    hardened BeaconNodeFallback) drive every duty through the nodes'
    rate-limited API surfaces while the fault axes compose. Minimal spec,
    fake BLS, CPU-sized; `--smoke` clamps size, never the fault shape."""

    name: str
    n_nodes: int = 4
    #: thousands of keys at full scale; smoke clamps (FLEET_SMOKE_*)
    n_validators: int = 2048
    #: each node's keys split UNEVENLY (seeded) across this many VCs
    vcs_per_node: int = 4
    slots: int = 16
    seed: int = 0xC0FFEE
    subnets: int = 2
    converge_slots: int = 4
    #: network fault axes (loadgen/netfaults.py dataclasses)
    partitions: tuple = ()
    links: tuple = ()
    churn: tuple = ()
    #: fleet fault axes (loadgen/fleet.py dataclasses)
    node_stalls: tuple = ()
    node_crashes: tuple = ()
    flash_crowds: tuple = ()
    #: token-bucket rate/burst on every node's VC-facing API surface
    #: (logical tokens/second — the HTTP API's --http-rate-limit shape)
    node_rate: float = 4096.0
    node_burst: float = 8192.0
    #: hardened-fallback knobs (validator/beacon_node.py resolution)
    vc_timeout: float = 2.0
    vc_retries: int = 2
    #: sign + aggregate sync-committee duties too
    sync_duties: bool = True
    #: fail unless performed/scheduled reaches this (None = no floor)
    min_performed_ratio: float | None = None
    #: fail unless >=1 incident dumped during the run
    expect_incident: bool = False
    #: route every node's gossip attestation/aggregate/block work through
    #: the REAL BeaconProcessor + CapacityScheduler (harness-pumped at
    #: phase barriers, multinode._tick) instead of inline verification —
    #: the capacity controller under realistic VC duty demand
    batch_gossip: bool = False
    #: fail unless the capacity scheduler actually made batch-formation
    #: decisions on the nodes (the scheduler-active proof)
    expect_scheduler: bool = False
    seconds_per_slot: float = 1.0
    #: -------- the real-socket HTTP leg (loadgen/fleet.py HttpLeg): this
    #: many VCs per node talk to a REAL localhost `api.http_api.serve()`
    #: server through pooled `api.client` connections (0 = leg off)
    http_vcs_per_node: int = 0
    #: duty-shaped GET requests each HTTP VC issues per slot (seeded
    #: deterministic schedule — the scheduled counts join the cluster
    #: rollup; socket outcomes/latencies stay wall-clock observations)
    http_requests_per_slot: int = 1
    #: server hardening knobs (api.http_api.WorkerPoolHTTPServer)
    http_threads: int = 4
    http_request_timeout: float = 1.0
    #: token-bucket rate on the real servers (None = unlimited)
    http_rate_limit: float | None = None
    #: socket-seam attacker schedule (netfaults.HttpFault)
    http_faults: tuple = ()
    #: fail unless the admission gate actually shed (http_api_shed_total
    #: + flight-recorder proof that saturation was reached and survived)
    expect_http_shed: bool = False


FLEET_SMOKE_VALIDATORS = 96
FLEET_SMOKE_SLOTS = 20


def _fleet_scenarios() -> dict[str, FleetScenario]:
    from .fleet import FlashCrowd, NodeCrash, NodeStall
    from .netfaults import HttpFault, Partition

    return {
        # the control run: no faults, the fleet must perform >=99% of its
        # duties (the remainder: genuinely empty aggregation pools)
        "fleet_steady": FleetScenario(
            name="fleet_steady", min_performed_ratio=0.99,
        ),
        # a 3v1 partition while the fleet signs: both sides keep serving
        # their forks (zero slashable signatures!), heads reconverge
        # within K of heal, every missed duty carries a reason
        "fleet_partition": FleetScenario(
            name="fleet_partition",
            partitions=(Partition(start_slot=4, heal_slot=8,
                                  groups=((0, 1, 2), (3,))),),
            converge_slots=4, expect_incident=True,
        ),
        # a torn store write kills node 1 mid-epoch: its VCs time out,
        # demote it, and fail over — the fleet keeps meeting duties
        "fleet_crash": FleetScenario(
            name="fleet_crash",
            node_crashes=(NodeCrash(node=1, slot=5),),
            converge_slots=4, expect_incident=True,
            min_performed_ratio=0.9,
        ),
        # fleet_steady's duty traffic as the capacity controller's demand
        # curve (the ROADMAP fleet item's follow-up): every node's gossip
        # verification work rides the REAL BeaconProcessor + capacity
        # scheduler, and the run fails unless the >=99% performed floor
        # STILL holds with the scheduler forming every batch — plus
        # nonzero scheduler decisions on the nodes (controller provably
        # active, not vacuously bypassed)
        "fleet_capacity": FleetScenario(
            name="fleet_capacity", min_performed_ratio=0.99,
            batch_gossip=True, expect_scheduler=True,
        ),
        # everything at once: 3-way partition x node-0 API stall x flash
        # crowd x one torn-write crash — PLUS the real-socket lane:
        # hundreds of HTTP VCs per node drive duty-shaped reads through
        # REAL localhost servers while an RST window bites the sockets.
        # The duty path must degrade with counted reasons and recover —
        # zero slashable messages, heads converge after heal, burn back
        # under 1x by the end, and the cluster rollup carries the leg's
        # per-route scheduled counts
        "combined_chaos": FleetScenario(
            name="combined_chaos", slots=20,
            partitions=(Partition(start_slot=4, heal_slot=8,
                                  groups=((0, 1), (2,), (3,))),),
            node_stalls=(NodeStall(node=0, start_slot=5, end_slot=7),),
            node_crashes=(NodeCrash(node=1, slot=6),),
            flash_crowds=(FlashCrowd(start_slot=10, end_slot=12),),
            converge_slots=5, expect_incident=True,
            http_vcs_per_node=128, http_requests_per_slot=1,
            http_threads=4, http_request_timeout=1.0,
            http_faults=(
                HttpFault(kind="reset", start_slot=10, end_slot=13,
                          clients=2),
            ),
        ),
        # the socket-seam siege: slow-loris header trickle occupies every
        # worker, a fire-and-forget storm overflows the admission queue,
        # and mid-body stalls eat read deadlines — the gate MUST shed
        # typed 503s (counted, flight-recorded), the health-exempt route
        # MUST keep answering, and the in-process duty path must not
        # notice (the performed floor still holds)
        "http_slowloris": FleetScenario(
            name="http_slowloris", n_nodes=2, n_validators=256,
            vcs_per_node=2, slots=8, converge_slots=4,
            http_vcs_per_node=3, http_requests_per_slot=1,
            http_threads=2, http_request_timeout=0.4,
            http_faults=(
                HttpFault(kind="slow_loris", start_slot=2, end_slot=5,
                          clients=4),
                HttpFault(kind="storm_429", start_slot=2, end_slot=5,
                          clients=40),
                HttpFault(kind="body_stall", start_slot=3, end_slot=5,
                          clients=2),
            ),
            expect_http_shed=True, min_performed_ratio=0.97,
        ),
    }


FLEET_SCENARIOS: dict[str, FleetScenario] = {}


def _ensure_fleet() -> dict[str, FleetScenario]:
    if not FLEET_SCENARIOS:
        FLEET_SCENARIOS.update(_fleet_scenarios())
    return FLEET_SCENARIOS


def is_fleet(name: str) -> bool:
    return name in _ensure_fleet()


def get_fleet_scenario(name: str, **overrides) -> FleetScenario:
    base = _ensure_fleet().get(name)
    if base is None:
        raise KeyError(f"unknown fleet scenario {name!r}")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(base, **overrides) if overrides else replace(base)


def fleet_smoke_variant(sc: FleetScenario) -> FleetScenario:
    """Seconds-sized clamp: fewer keys and VCs, same fault plan (the
    plan IS the scenario's shape — slots are NOT clamped below the last
    fault window)."""
    return replace(
        sc,
        n_validators=min(sc.n_validators, FLEET_SMOKE_VALIDATORS),
        vcs_per_node=min(sc.vcs_per_node, 2),
        slots=min(sc.slots, FLEET_SMOKE_SLOTS),
        http_vcs_per_node=min(sc.http_vcs_per_node, 4),
    )


#: lazily built (netfaults imports the metrics registry; keep module
#: import as light as the CLI parser expects)
MULTINODE_SCENARIOS: dict[str, MultiNodeScenario] = {}


def _ensure_multinode() -> dict[str, MultiNodeScenario]:
    if not MULTINODE_SCENARIOS:
        MULTINODE_SCENARIOS.update(_multinode_scenarios())
    return MULTINODE_SCENARIOS


def is_multinode(name: str) -> bool:
    return name in _ensure_multinode()


def get_multinode_scenario(name: str, **overrides) -> MultiNodeScenario:
    base = _ensure_multinode().get(name)
    if base is None:
        raise KeyError(f"unknown multi-node scenario {name!r}")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(base, **overrides) if overrides else replace(base)


def multinode_smoke_variant(sc: MultiNodeScenario) -> MultiNodeScenario:
    """Multi-node scenarios are CPU-sized by construction; `--smoke` only
    clamps an operator override back into the seconds range without
    changing the fault plan (the plan IS the scenario's shape)."""
    return replace(
        sc,
        n_validators=min(sc.n_validators, 64),
        slots=min(sc.slots, 16),
    )


# -------------------------------------------------------------- mixed duty


@dataclass
class MixedDutyScenario:
    """One device, many tenants (loadgen/mixed_duty.py): BLS attestation
    batches, tree-hash state-root jobs, and epoch-vector work all drive
    ONE per-chip device ledger through the process-wide device-occupancy
    ledger (observability/device_ledger.py). The run is the measurement
    substrate for the ROADMAP's "one device, many tenants" arbiter: it
    fails unless per-chip ledger conservation (busy + idle +
    contention-wait = wall) holds exactly, every workload's SLO block
    lands in the report, and the injected mid-run stall produces at
    least one schema-valid `device_contention` incident naming victim
    and occupant. The deterministic core is bit-identical across reruns
    — this run IS the workloads-isolated baseline the arbiter item's
    acceptance clause compares against."""

    name: str
    n_validators: int = 8192
    slots: int = 12
    seed: int = 0x7E9A27
    #: chip universe of the logical device (the meshsim shape)
    n_chips: int = 4
    #: BLS demand scale over mainnet_mix's seeded draw
    demand_factor: float = 1.0
    #: tree-hash tenant: state-root jobs per slot, leaves per job
    roots_per_slot: int = 6
    root_leaves: int = 4096
    #: epoch tenant: cadence (every k-th slot) and batches per firing
    epoch_every: int = 8
    epoch_batches: int = 2
    #: logical device cost model per tenant: a batch of n units pays
    #: base_ms + per_unit_ms * pow2ceil(n) ms (the padding-bucket
    #: economics shared with the capacity ledger); BLS shards across
    #: every chip, state-root jobs pin one chip round-robin
    bls_base_ms: float = 25.0
    bls_per_set_ms: float = 0.65
    hash_base_ms: float = 8.0
    hash_per_leaf_ms: float = 0.004
    epoch_base_ms: float = 60.0
    epoch_per_val_ms: float = 0.012
    seconds_per_slot: int = 1
    #: traffic-free drain slots before the final force-drain
    epilogue_slots: int = 2
    #: injected mid-run stall: over [start, end) slots BLS batches serve
    #: stall_factor x slower (a wedged collective holding the device),
    #: so the other tenants' admitted work queues behind the occupant —
    #: the contention episode the incident trigger must catch and name
    stall_slots: tuple = (5, 7)
    stall_factor: float = 8.0
    #: accountant device_contention trigger threshold (logical seconds
    #: of cross-tenant contention accrued per slot)
    contention_threshold: float = 0.25


MIXED_DUTY_SCENARIOS: dict[str, MixedDutyScenario] = {
    # steady mainnet-shaped BLS + 6 state-roots/slot + epoch vectors on
    # the epoch boundary, with a mid-run 8x BLS stall: the three tenants
    # genuinely contend for the 4-chip ledger around the stall window
    "mixed_duty": MixedDutyScenario(name="mixed_duty"),
}


def is_mixed_duty(name: str) -> bool:
    return name in MIXED_DUTY_SCENARIOS


def get_mixed_duty_scenario(name: str, **overrides) -> MixedDutyScenario:
    base = MIXED_DUTY_SCENARIOS.get(name)
    if base is None:
        raise KeyError(f"unknown mixed-duty scenario {name!r}")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(base, **overrides) if overrides else replace(base)


def mixed_duty_smoke_variant(sc: MixedDutyScenario) -> MixedDutyScenario:
    """Seconds-sized clamp preserving the contention physics: shrinking
    the validator count scales the BLS per-set cost up by the same ratio
    (the capacity_smoke_variant rule), and the stall window slides inside
    the clamped run so the contention episode is never cut."""
    n_small = min(sc.n_validators, 4096)
    out = replace(
        sc,
        n_validators=n_small,
        bls_per_set_ms=sc.bls_per_set_ms * (sc.n_validators / n_small),
        slots=min(sc.slots, 10),
        epilogue_slots=min(sc.epilogue_slots, 2),
        roots_per_slot=min(sc.roots_per_slot, 4),
    )
    s0, s1 = out.stall_slots
    width = max(1, min(s1 - s0, out.slots - 3))
    s0 = max(1, min(s0, out.slots - width - 1))
    return replace(out, stall_slots=(s0, s0 + width))
