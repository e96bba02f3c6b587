"""Planner: pure, deterministic derivation of serving knobs from a profile
(the port's copy of the JAX package's autotune/planner.py).

Given a DeviceProfile, `plan_from_profile` derives:

  - the batch caps a beacon processor forms batches with,
  - the hybrid router's p99 budget and urgent-set threshold (env vars and
    constructor args stay explicit overrides — see crypto/bls/hybrid.py
    knob precedence),
  - the startup warmup plan: the ordered buckets worth warming before
    traffic arrives (autotune/runtime.start_warmup).

The function is pure (no IO, no clocks, no randomness): the same profile
JSON always yields the identical Plan, which is what makes a persisted
profile equivalent to re-measuring. Derivation rules, in order:

  batch caps   The measured bucket with the best sets/sec marks peak
               throughput; the cap is the SMALLEST bucket achieving >= 90%
               of it (the throughput knee — beyond it, wider batches only
               add latency). A knee sitting at the sweep's LARGEST bucket
               means throughput was still rising when measurement stopped,
               so the cap never drops below the default on that evidence.
               Aggregate cap is half the attestation cap (aggregates carry
               ~2x the pubkey work per set).
  p99 budget   2x the p99 of the smallest measured bucket (the urgent
               path's bucket): the router reroutes small batches to the
               host only when the device is doing twice as badly as it
               did when calibrated. Clamped to [50 ms, 5 s].
  urgent sets  The largest measured bucket size n where n sequential
               host verifies still beat the bucket's device p50 — below
               that, the host path wins on latency. Needs the profile's
               host reference measurement; defaults to 4 without one.
  warmup plan  Measured buckets ordered by achieved sets/sec (descending;
               ties: smaller first, so cheap compiles land early), capped
               at 4 buckets — then the profile's SMALL/urgent buckets
               (warmup_small_buckets, falling back to the smallest
               measured bucket) are appended if the throughput ordering
               dropped them, so bring-up always precompiles the urgent
               fast path's shapes, not just the firehose ones. With no
               measured buckets the node warms the two highest-traffic
               default shapes: the subnet-attestation firehose (1024 x 1,
               the fast compile) then the aggregate bucket (512 x 128).
  pipeline     Dispatch double-buffering depth: the profile's measured
  depth        pipeline_depth, clamped to [1, 16]; default 4 when
               unmeasured.
  msm window   The calibrated varying-base MSM window width (w in
               {2,4,5,6}), passed through verbatim; None when unmeasured
               (consumers fall back to the default).

A profile's mesh topology ("sets8", "sets4-pks2") still shapes the caps
and budgets as in the reference; the port measures on one card
("single"), where it changes nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

from .profile import DeviceProfile

# The JAX package's beacon-processor batch caps and the hybrid router's
# built-in defaults — duplicated here (not imported) so the planner stays
# import-cycle-free.
DEFAULT_MAX_ATTESTATION_BATCH = 1024
DEFAULT_MAX_AGGREGATE_BATCH = 512
DEFAULT_P99_BUDGET_MS = 500.0
DEFAULT_URGENT_MAX_SETS = 4

# (n_sets, n_pks) shapes warmed when no profile exists: gossip subnet
# attestations (single-signer sets, m=1 — compiles fastest, carries the
# most traffic) then coalesced aggregates (committee-wide pubkey sets).
DEFAULT_WARMUP_BUCKETS = (
    (DEFAULT_MAX_ATTESTATION_BATCH, 1),
    (DEFAULT_MAX_AGGREGATE_BATCH, 128),
)

KNEE_FRACTION = 0.9          # "within 10% of peak sets/sec" knee rule
MAX_BATCH_CAP = 4096         # sanity ceiling on derived caps
MIN_BATCH_CAP = 4            # torchbls MIN_SETS floor
P99_BUDGET_FACTOR = 2.0
P99_BUDGET_CLAMP_MS = (50.0, 5000.0)
# collective-aware budget slack: every halving level of a D-chip mesh adds
# one interconnect reduction round to the stage-1 tree-sum and stage-4 pair
# product, so the p99 budget a profile justifies grows by this fraction
# per log2(D) — a routing/stall verdict tuned single-chip must not flag a
# healthy 8-chip batch whose collectives legitimately cost a few ms more
COLLECTIVE_P99_SLACK_PER_HALVING = 0.05
STALL_BUDGET_FACTOR = 4.0    # mirrors the hybrid router's stall default
MAX_WARMUP_BUCKETS = 4
# appended small/urgent warmup shapes may exceed MAX_WARMUP_BUCKETS by
# this many entries (they are the cheap compiles; dropping them is what
# made every cold node pay the host detour on its first urgent verify)
MAX_SMALL_WARMUP_EXTRA = 2
DEFAULT_PIPELINE_DEPTH = 4   # mirrors torchbls pipeline.DEFAULT_DEPTH
PIPELINE_DEPTH_CLAMP = (1, 16)
# tree-hash warmup: leaf-count ladders bring-up warms when the hash
# backend is device-backed. The default is the mainnet-shaped
# validator-registry scale a state root hits first; profile values clamp
# to this range (a typo'd 2**40 bucket must not compile for an hour).
DEFAULT_TREE_HASH_WARMUP = (16384,)
TREE_HASH_BUCKET_CLAMP = (64, 1 << 22)
# bring-up compiles the listed ladders SEQUENTIALLY: cap the count like
# MAX_WARMUP_BUCKETS caps the BLS list — a 60-entry profile must not
# monopolize the device for the whole warm-up window
MAX_TREE_HASH_WARMUP = 4


@dataclass(frozen=True)
class Plan:
    """Deterministic serving knobs derived from one device profile."""

    max_attestation_batch: int = DEFAULT_MAX_ATTESTATION_BATCH
    max_aggregate_batch: int = DEFAULT_MAX_AGGREGATE_BATCH
    p99_budget_ms: float = DEFAULT_P99_BUDGET_MS
    urgent_max_sets: int = DEFAULT_URGENT_MAX_SETS
    warmup_buckets: tuple = DEFAULT_WARMUP_BUCKETS
    pipeline_depth: int = DEFAULT_PIPELINE_DEPTH
    msm_window: int | None = None
    # mesh-aware serving: total chips of the measured topology, the
    # per-chip share of the batch caps (global cap / set-axis size — what
    # a capacity dashboard compares against per-chip roofline), and the
    # collective-aware stall budget the hybrid router feeds the QoS
    # breaker (None = unmeasured topology, consumers keep the 4x-p99
    # default)
    mesh_devices: int = 1
    per_chip_attestation_batch: int = DEFAULT_MAX_ATTESTATION_BATCH
    per_chip_aggregate_batch: int = DEFAULT_MAX_AGGREGATE_BATCH
    stall_budget_ms: float | None = None
    # the second workload's warmup list: leaf-count buckets the
    # tree-hash engine warms at bring-up
    tree_hash_warmup: tuple = DEFAULT_TREE_HASH_WARMUP
    source: str = "defaults"


DEFAULT_PLAN = Plan()


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def parse_mesh_shape(key: str | None) -> dict:
    """A topology string as axis sizes: "sets4-pks2" -> {"sets": 4,
    "pks": 2}; {} for None/"single"/unparseable (one chip). The JAX
    package's parallel.mesh.parse_mesh_shape."""
    import re

    if not key or key == "single":
        return {}
    out = {}
    for part in str(key).split("-"):
        m = re.fullmatch(r"([a-z_]+)(\d+)", part)
        if not m:
            return {}
        out[m.group(1)] = int(m.group(2))
    return out


def plan_from_profile(profile: DeviceProfile) -> Plan:
    """Pure Plan derivation; see the module docstring for the rules."""
    measured = sorted(
        (b for b in profile.buckets.values()
         if b.sets_per_sec is not None and b.samples > 0),
        key=lambda b: (b.n_sets, b.n_pks),
    )
    source = f"profile:{profile.key_string()}"

    # ---- topology: axis sizes of the mesh the profile measured on.
    # set_axis keys the batch-cap rounding (full batches must shard
    # evenly); total chips key the collective-aware budget slack.
    shape = parse_mesh_shape(profile.mesh_shape)
    set_axis = max(1, int(shape.get("sets", 1)))
    mesh_devices = 1
    for v in shape.values():
        mesh_devices *= max(1, int(v))
    collective_rounds = max(0, (mesh_devices - 1).bit_length())
    collective_slack = 1.0 + COLLECTIVE_P99_SLACK_PER_HALVING * collective_rounds

    # ---- batch caps: smallest bucket within KNEE_FRACTION of peak rate.
    # If that knee IS the largest measured bucket, throughput was still
    # rising when the sweep ended — the data shows nothing about wider
    # batches, so only a knee OBSERVED inside the sweep may lower the cap
    # below the default (a profile changes a knob only when measurement
    # supports the change).
    att_cap = DEFAULT_MAX_ATTESTATION_BATCH
    if measured:
        peak = max(b.sets_per_sec for b in measured)
        knee = min(
            (b.n_sets for b in measured
             if b.sets_per_sec >= KNEE_FRACTION * peak),
        )
        if knee == max(b.n_sets for b in measured):
            knee = max(knee, DEFAULT_MAX_ATTESTATION_BATCH)
        att_cap = int(_clamp(knee, MIN_BATCH_CAP, MAX_BATCH_CAP))
    # mesh-shape-keyed caps: a full batch must divide evenly over the set
    # axis (the backend pads the remainder with masked lanes — a cap that is
    # not a mesh multiple wastes the pad lanes on EVERY full batch)
    if att_cap % set_axis:
        att_cap += set_axis - (att_cap % set_axis)
    agg_cap = max(MIN_BATCH_CAP, att_cap // 2)
    if agg_cap % set_axis:
        agg_cap += set_axis - (agg_cap % set_axis)

    # ---- p99 budget from the smallest (urgent) measured bucket, widened
    # by the collective slack on a multi-chip mesh (each halving level of
    # the cross-set reductions adds one interconnect round)
    p99_budget = DEFAULT_P99_BUDGET_MS
    smallest = next((b for b in measured if b.p99_ms is not None), None)
    if smallest is not None:
        p99_budget = _clamp(
            P99_BUDGET_FACTOR * smallest.p99_ms * collective_slack,
            *P99_BUDGET_CLAMP_MS,
        )
    # the stall verdict the hybrid router feeds the QoS breaker: derived
    # here (not in the router) so one planner owns every topology-aware
    # budget; None when nothing was measured — consumers keep the 4x-p99
    # default resolution
    stall_budget = (
        round(STALL_BUDGET_FACTOR * float(p99_budget), 3)
        if smallest is not None else None
    )

    # ---- urgent threshold: host wins while n * host_ms <= device p50
    urgent = DEFAULT_URGENT_MAX_SETS
    host_ms = None
    if profile.host:
        host_ms = profile.host.get("single_set_ms")
    if host_ms:
        candidates = [
            b.n_sets
            for b in measured
            if b.p50_ms is not None and b.n_sets * host_ms <= b.p50_ms
        ]
        urgent = max(candidates) if candidates else 1

    # ---- warmup: best-throughput buckets first; cheap shapes break ties.
    # The profile's small/urgent shapes are then APPENDED if the
    # throughput ordering dropped them — the urgent fast path needs its
    # bucket hot at bring-up even when it never wins a throughput sort.
    if measured:
        ordered = sorted(
            measured,
            key=lambda b: (-b.sets_per_sec, b.n_sets, b.n_pks),
        )
        warmup_list = [
            (b.n_sets, b.n_pks) for b in ordered[:MAX_WARMUP_BUCKETS]
        ]
        small = profile.warmup_small_buckets
        if not small:
            smallest = min(measured, key=lambda b: (b.n_sets, b.n_pks))
            small = ((smallest.n_sets, smallest.n_pks),)
        for shape in small:
            shape = (int(shape[0]), int(shape[1]))
            if shape not in warmup_list:
                warmup_list.append(shape)
            if len(warmup_list) >= MAX_WARMUP_BUCKETS + MAX_SMALL_WARMUP_EXTRA:
                break
        warmup = tuple(warmup_list)
    else:
        warmup = DEFAULT_WARMUP_BUCKETS

    # ---- dispatch pipeline depth + MSM window: measured values pass
    # through (clamped/validated); unmeasured falls back to the defaults
    depth = DEFAULT_PIPELINE_DEPTH
    if profile.pipeline_depth:
        depth = int(_clamp(int(profile.pipeline_depth), *PIPELINE_DEPTH_CLAMP))
    msm_window = (
        int(profile.msm_window) if profile.msm_window is not None else None
    )

    # ---- tree-hash warmup: the profile's measured leaf-count
    # buckets pass through clamped + deduplicated in order; unmeasured
    # falls back to the registry-scale default
    if profile.tree_hash_buckets:
        seen = []
        for n in profile.tree_hash_buckets:
            n = int(_clamp(int(n), *TREE_HASH_BUCKET_CLAMP))
            if n not in seen:
                seen.append(n)
            if len(seen) >= MAX_TREE_HASH_WARMUP:
                break
        tree_hash_warmup = tuple(seen)
    else:
        tree_hash_warmup = DEFAULT_TREE_HASH_WARMUP

    return Plan(
        max_attestation_batch=att_cap,
        max_aggregate_batch=agg_cap,
        p99_budget_ms=round(float(p99_budget), 3),
        urgent_max_sets=int(urgent),
        warmup_buckets=warmup,
        pipeline_depth=depth,
        msm_window=msm_window,
        mesh_devices=mesh_devices,
        per_chip_attestation_batch=max(1, att_cap // set_axis),
        per_chip_aggregate_batch=max(1, agg_cap // set_axis),
        stall_budget_ms=stall_budget,
        tree_hash_warmup=tree_hash_warmup,
        source=source,
    )
