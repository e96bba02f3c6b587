"""Scenario runner: synthetic gossip through the real QoS-protected path.

The port's copy of the JAX package's loadgen/runner.py. Its device lane is
the StallingBackend (fake semantics by design), so it runs no kernel.

One `LoadgenNode` is the serving path of a beacon node with the chain
swapped for counters: an `InProcessGossipRouter` delivers synthetic
attestation/aggregate/block messages (snappy-compressed, deduped by real
message ids) into topic handlers that submit `WorkItem`s to a real
`BeaconProcessor` guarded by a real `AdmissionController` — the exact
submit/coalesce/shed/expire machinery gossip exercises in production. The
verification leg is a `StallingBackend` device behind a `CircuitBreaker`
with an instant host fallback, so device-stall scenarios drive the
closed→open→half_open cycle exactly as the hybrid BLS router would.

Time is a `ManualSlotClock` advanced slot by slot; the breaker reads the
same logical clock. Within a slot the generator is open-loop (everything
publishes whether or not the pipeline keeps up), then the pump drains, so
every count in the report is a pure function of (scenario, seed).

Service-level accounting: each run drives a PRIVATE SlotAccountant
(observability/slo.py — the global one belongs to the node) whose slot
reports close after every drained slot, so the report's `slo` block shows
the per-slot deadline-hit ratio degrading through a device stall and
recovering after. The global flight recorder is reset per run and pointed
at `<datadir>/incidents`: the breaker opening (or a burn-rate/miss-streak
trigger) dumps a real incident snapshot, which the report lists and
`bn debug-bundle --datadir` packages.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
import time

from ..chain.beacon_processor import (
    BeaconProcessor,
    BeaconProcessorConfig,
    WorkItem,
    WorkKind,
)
from ..network import gossip as gs
from ..network import snappy
from ..observability.flight_recorder import RECORDER
from ..observability.slo import SlotAccountant
from ..qos.admission import AdmissionController
from ..qos.breaker import CircuitBreaker
from ..utils.slot_clock import ManualSlotClock
from .faults import DeviceStallError, FaultInjector, SlowHostVerify, StallingBackend
from .scenarios import Scenario, traffic_schedule

# stale gossip is stamped this many slots in the past: past the propagation
# window (32), so its deadline has already expired on arrival
STALE_AGE_SLOTS = 40

_FORK_DIGEST = b"\x00" * 4


class LoadgenNode:
    """Router topics -> QoS-guarded BeaconProcessor -> counting verifiers."""

    def __init__(self, sc: Scenario, clock: ManualSlotClock, store=None,
                 slo_acct: SlotAccountant | None = None):
        self.scenario = sc
        self.clock = clock
        # optional durable store: the block handler persists the head slot
        # through it (a loadgen-scale BeaconChain.persist()), so storage
        # faults injected there crash the node exactly where a real one
        # would crash — inside its durable-write path
        self.store = store
        self.admission = AdmissionController(clock)
        self.processor = BeaconProcessor(
            BeaconProcessorConfig(), admission=self.admission
        )
        # private per-run accountant (export_metrics=False keeps the
        # process-global slo_* gauges owned by the node's accountant);
        # crash_restart passes ONE accountant across both node phases
        self.slo = slo_acct if slo_acct is not None else SlotAccountant(
            export_metrics=False
        )
        self.slo.bind_clock(clock)
        self.processor.slo = self.slo
        if sc.att_queue_cap is not None:
            self.processor.max_lengths[WorkKind.gossip_attestation] = (
                sc.att_queue_cap
            )
        if sc.agg_queue_cap is not None:
            self.processor.max_lengths[WorkKind.gossip_aggregate] = (
                sc.agg_queue_cap
            )
        if sc.mesh:
            # mesh scenario: an N-chip device sim with collective
            # semantics (one stalled chip stalls the whole batch) behind
            # a REAL PipelinedDispatcher — chip count resolves against
            # parallel.get_mesh() unless the sweep pins it. The port has
            # no meshsim.py yet: until it lands, this import raises
            # ImportError and a mesh scenario runs no further
            from ..crypto.torchbls.pipeline import PipelinedDispatcher
            from .meshsim import MeshShardedBackend, resolve_mesh_devices

            self.mesh_devices = resolve_mesh_devices(sc.mesh_devices)
            self.device = MeshShardedBackend(self.mesh_devices)
            self.dispatcher = PipelinedDispatcher(workload="meshsim")
        else:
            self.mesh_devices = None
            self.device = StallingBackend()
            self.dispatcher = None
        # breaker on the scenario's logical clock: one-slot cooldown, so
        # recovery is observable within the run
        self.breaker = CircuitBreaker(
            "loadgen_device", failure_threshold=3,
            reset_timeout=float(sc.seconds_per_slot), time_fn=clock._time,
            workload="meshsim",
        )
        # wall-clock verify observations for mesh runs (device-served
        # batches only): the sweep's sets/s + p50 numbers — kept OUT of
        # the deterministic report core
        self.batch_verify_obs: list = []  # (n_sets, secs)
        self.slow_host = (
            SlowHostVerify() if "slow_host" in sc.faults else None
        )
        self.router = gs.InProcessGossipRouter()
        self.att_topic = gs.attestation_subnet_topic(_FORK_DIGEST, 0)
        self.agg_topic = gs.topic_name(_FORK_DIGEST, "beacon_aggregate_and_proof")
        self.block_topic = gs.topic_name(_FORK_DIGEST, "beacon_block")
        self.router.subscribe("node", self.att_topic, self._on_att)
        self.router.subscribe("node", self.agg_topic, self._on_agg)
        self.router.subscribe("node", self.block_topic, self._on_block)
        self._seq = 0
        self.published = {"attestations": 0, "aggregates": 0, "blocks": 0,
                          "stale_attestations": 0}
        self.verified_sets = 0
        self.batches = {"device": 0, "host": 0, "device_stalls": 0,
                        "circuit_refusals": 0}
        self.block_slot_lag: list[int] = []
        self.shed_callbacks = 0

    # --------------------------------------------------------- payloads

    def _payload(self, slot: int, rng: random.Random) -> bytes:
        """Unique synthetic message: stamped slot + sequence + seeded noise
        (the router dedups by real message id; every payload must differ)."""
        self._seq += 1
        return (
            # signed: stale stamps near genesis go negative (slot - 40)
            int(slot).to_bytes(8, "little", signed=True)
            + self._seq.to_bytes(8, "little")
            + rng.getrandbits(128).to_bytes(16, "little")
        )

    @staticmethod
    def _stamped_slot(msg) -> int:
        return int.from_bytes(
            snappy.decompress(msg.payload)[:8], "little", signed=True
        )

    # --------------------------------------------------------- handlers

    def _on_shed(self, _reason: str) -> None:
        self.shed_callbacks += 1

    def _on_att(self, msg) -> bool:
        slot = self._stamped_slot(msg)
        return self.processor.submit(WorkItem(
            kind=WorkKind.gossip_attestation,
            payload=slot,
            run_batch=self._run_verify_batch,
            deadline_slot=self.admission.attestation_deadline_slot(slot),
            on_shed=self._on_shed,
        ))

    def _on_agg(self, msg) -> bool:
        slot = self._stamped_slot(msg)
        return self.processor.submit(WorkItem(
            kind=WorkKind.gossip_aggregate,
            payload=slot,
            run_batch=self._run_verify_batch,
            deadline_slot=self.admission.attestation_deadline_slot(slot),
            on_shed=self._on_shed,
        ))

    def _on_block(self, msg) -> bool:
        slot = self._stamped_slot(msg)

        def run():
            # blocks verify on the host path unconditionally (the hybrid
            # urgent path); what matters here is WHEN they run. Mesh runs
            # additionally push the proposer check through the REAL
            # dispatcher's urgent BYPASS lane, pinned to chip 0 — the
            # mesh_stall scenario (chip 1 wedged) proves the urgent path
            # keeps serving while every sharded batch stalls
            now = self.clock.now() or 0
            self.block_slot_lag.append(now - slot)
            if self.dispatcher is not None:
                from ..crypto.bls.api import _ReadyHandle

                try:
                    # pre-resolved handle (the bypass lane resolves
                    # in-band; crypto/bls/api owns the handle contract)
                    self.dispatcher.submit(
                        lambda: _ReadyHandle(
                            self.device.verify_signature_sets_urgent(
                                [None], [1]
                            )
                        ),
                        urgent=True,
                    ).result()
                    self.batches["urgent"] = self.batches.get("urgent", 0) + 1
                except Exception:
                    # a stalled chip 0 fails the urgent verify; the block
                    # still imports (host fallback semantics) — count it
                    self.batches["urgent_stalled"] = (
                        self.batches.get("urgent_stalled", 0) + 1
                    )
            if self.store is not None:
                # the durable head record (BeaconChain.persist() at loadgen
                # scale): one CRC-framed fsynced append per imported block —
                # a SimulatedCrash raised here kills the whole node run
                from ..store.kv import Column

                self.store.put(
                    Column.beacon_chain, b"head-slot",
                    int(slot).to_bytes(8, "little", signed=True),
                )

        return self.processor.submit(
            WorkItem(kind=WorkKind.gossip_block, run=run)
        )

    def _run_verify_batch(self, payloads) -> None:
        """Coalesced batch verifier: device behind the breaker, host
        fallback — the hybrid router's routing shape with counters for
        crypto (fake semantics; loadgen measures QoS, not pairings)."""
        n = len(payloads)
        self.verified_sets += n
        t0 = time.perf_counter()
        if self.breaker.allow():
            try:
                if self.dispatcher is not None:
                    # mesh lane: the REAL pipelined dispatcher owns the
                    # submission (FIFO window + torchbls_pipeline_* series);
                    # resolution stays in-band so reports remain
                    # deterministic functions of (scenario, seed)
                    self.dispatcher.submit(
                        lambda: self.device.verify_signature_sets_async(
                            [None] * n, [1] * n
                        )
                    ).result()
                else:
                    self.device.verify_signature_sets([None] * n, [1] * n)
                dt = time.perf_counter() - t0
                self.breaker.record_success()
                self.batches["device"] += 1
                self.batch_verify_obs.append((n, dt))
                self.slo.record_route("device", n)
                self.slo.record_verify_latency(dt)
                RECORDER.note_route("loadgen_device", "device", "ok")
                return None
            except DeviceStallError:
                self.breaker.record_failure()
                self.batches["device_stalls"] += 1
                # the host serves the batch below, but it already blew the
                # device stall budget: these items verified LATE — counted
                # processed for conservation, deadline MISSES for the SLI
                self.slo.record_late(n)
        else:
            self.batches["circuit_refusals"] += 1
        if self.slow_host is not None:
            self.slow_host(n)
        self.batches["host"] += 1
        self.slo.record_route("host", n)
        self.slo.record_verify_latency(time.perf_counter() - t0)
        RECORDER.note_route(
            "loadgen_device", "host",
            "device_stall" if self.device.stalled else "circuit_open",
        )
        return None

    # --------------------------------------------------------- publishing

    def publish_slot(self, slot: int, traffic, rng: random.Random) -> None:
        for _ in range(traffic.attestations):
            self.router.publish(
                "loadgen", self.att_topic, self._payload(slot, rng)
            )
        self.published["attestations"] += traffic.attestations
        stale_slot = slot - STALE_AGE_SLOTS
        for _ in range(traffic.stale_attestations):
            self.router.publish(
                "loadgen", self.att_topic, self._payload(stale_slot, rng)
            )
        self.published["stale_attestations"] += traffic.stale_attestations
        for _ in range(traffic.aggregates):
            self.router.publish(
                "loadgen", self.agg_topic, self._payload(slot, rng)
            )
        self.published["aggregates"] += traffic.aggregates
        for _ in range(traffic.blocks):
            self.router.publish(
                "loadgen", self.block_topic, self._payload(slot, rng)
            )
        self.published["blocks"] += traffic.blocks


def _prepare_recorder(datadir: str | None, clock, slo_acct) -> str:
    """Reset the global flight recorder for a deterministic run and point
    it at this run's incident directory; returns that directory."""
    datadir = datadir or tempfile.mkdtemp(prefix="loadgen-")
    incident_dir = os.path.join(datadir, "incidents")
    RECORDER.reset()
    RECORDER.configure(incident_dir=incident_dir, clock=clock,
                       slo_provider=slo_acct.snapshot)
    return incident_dir


def _slo_block(slo_acct: SlotAccountant, incident_dir: str) -> dict:
    """The report's service-level block: per-slot deadline-hit ratios, the
    rolling windows, and the incidents the run dumped."""
    reports = [r for r in slo_acct.recent if not r.empty]
    hits = sum(r.hits for r in reports)
    misses = sum(r.misses for r in reports)
    total = hits + misses
    return {
        "target": slo_acct.target,
        "deadline_hits": hits,
        "deadline_misses": misses,
        "deadline_hit_ratio": round(hits / total, 4) if total else None,
        "per_slot": [
            {
                "slot": r.slot,
                "deadline_hit_ratio": (
                    None if r.hit_ratio() is None else round(r.hit_ratio(), 4)
                ),
                "hits": r.hits,
                "misses": r.misses,
                "late": r.late,
                "routes": r.routes,
            }
            for r in reports
        ],
        "windows": {
            name: slo_acct.window_summary(name) for name in slo_acct.windows
        },
        "incident_dir": incident_dir,
        "incidents": [
            os.path.basename(p) for p in RECORDER.incidents_written
        ],
        "flight_recorder_events": RECORDER.events_recorded,
    }


def _verify_obs_block(node: LoadgenNode) -> dict:
    """Wall-clock verify observations (EVERY run): sets/s + p50 over the
    device-served batches — what `bn loadtest --bench-matrix` and the
    --mesh-devices sweep snapshot into BENCH_MATRIX rows. Deliberately
    OUTSIDE the deterministic report core — these are measurements, not
    seed functions."""
    obs = node.batch_verify_obs
    total_sets = sum(n for n, _ in obs)
    total_secs = sum(s for _, s in obs)
    lats = sorted(s for _, s in obs)
    p50 = lats[len(lats) // 2] if lats else None
    return {
        "device_batches": len(obs),
        "sets_per_sec": (
            round(total_sets / total_secs, 2) if total_secs > 0 else None
        ),
        "verify_p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
    }


def _mesh_block(node: LoadgenNode) -> dict:
    """Mesh runs additionally report per-chip occupancy + the urgent-lane
    ledger next to the verify observations."""
    block = dict(node.device.occupancy())
    block.update(
        _verify_obs_block(node),
        urgent_served=node.batches.get("urgent", 0),
        urgent_stalled=node.batches.get("urgent_stalled", 0),
    )
    return block


def run_scenario(sc: Scenario, out_path: str | None = None,
                 log_fn=None, datadir: str | None = None) -> dict:
    """Run one scenario to completion; returns (and optionally writes) the
    machine-readable report."""
    if "storage_crash" in sc.faults:
        return run_crash_restart(sc, out_path=out_path, log_fn=log_fn,
                                 datadir=datadir)
    t_wall = time.time()
    clock = ManualSlotClock(0, max(1, int(sc.seconds_per_slot)))
    slo_acct = SlotAccountant(export_metrics=False)
    incident_dir = _prepare_recorder(datadir, clock, slo_acct)
    node = LoadgenNode(sc, clock, slo_acct=slo_acct)
    injector = FaultInjector()
    if "device_stall" in sc.faults:
        start, end = sc.stall_slots
        injector.at(start, node.device.stall)
        injector.at(end, node.device.release)
    if "mesh_stall" in sc.faults:
        start, end = sc.stall_slots
        chip = sc.mesh_stall_chip % max(1, node.mesh_devices or 1)
        injector.at(start, lambda: node.device.stall_chip(chip))
        injector.at(end, lambda: node.device.release_chip(chip))
    schedule = traffic_schedule(sc)
    rng = random.Random(sc.seed ^ 0x10AD6E4)
    for slot, traffic in enumerate(schedule):
        clock.set_slot(slot)
        injector.on_slot(slot)
        node.publish_slot(slot, traffic, rng)
        node.processor.run_until_idle()
        slo_acct.close_slot(slot)
        if log_fn is not None:
            log_fn(f"slot {slot}: published "
                   f"{traffic.attestations + traffic.stale_attestations} att "
                   f"/ {traffic.aggregates} agg / {traffic.blocks} block; "
                   f"breaker={node.breaker.state()}")
    # epilogue slot: release any still-armed faults, drain what remains
    clock.set_slot(sc.slots)
    injector.on_slot(sc.slots + max(0, sc.stall_slots[1] - sc.slots))
    node.device.release()
    node.processor.run_until_idle()
    slo_acct.close_slot(sc.slots)
    proc = node.processor
    report = {
        "scenario": sc.name,
        "seed": sc.seed,
        "slots": sc.slots,
        "n_validators": sc.n_validators,
        "flood_factor": sc.flood_factor,
        "faults": list(sc.faults),
        "published": dict(node.published),
        "processed": {k.name: v for k, v in proc.processed.items() if v},
        "dropped": {k.name: v for k, v in proc.dropped.items() if v},
        "expired": {k.name: v for k, v in proc.expired.items() if v},
        "shed_admission": {
            k.name: v for k, v in proc.shed_admission.items() if v
        },
        "qos_totals": proc.qos_totals(),
        "shed_callbacks": node.shed_callbacks,
        "verified_sets": node.verified_sets,
        "batches": dict(node.batches),
        "breaker_transitions": list(node.breaker.transitions),
        "blocks_processed_in_slot": bool(node.block_slot_lag)
        and max(node.block_slot_lag) == 0,
        "slo": _slo_block(slo_acct, incident_dir),
        "elapsed_secs": round(time.time() - t_wall, 3),
    }
    report["verify_observations"] = _verify_obs_block(node)
    if node.mesh_devices is not None:
        report["mesh"] = _mesh_block(node)
    # the deadline-hit ratio rides next to the loss accounting so one
    # glance answers both "was work conserved" and "was it in time"
    report["deadline_hit_ratio"] = report["slo"]["deadline_hit_ratio"]
    # fully detach the run's wiring: a later incident in this process
    # must not be stamped by the dead manual clock or carry this run's
    # private accountant windows
    RECORDER.configure(incident_dir=None, clock=None, slo_provider=None)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def _merge_counts(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def run_crash_restart(sc: Scenario, out_path: str | None = None,
                      log_fn=None, datadir: str | None = None) -> dict:
    """The crash-recovery proof: mainnet-shaped load over a DURABLE store,
    a torn head write at `crash_slot` that kills the node mid-slot, then a
    restart over the same datadir that must resume from the last durably
    persisted head and finish the run.

    Phase 1 runs on a `FaultyKVStore` (fsync=always) whose fault plan
    tears the crash slot's head record mid-write; the `SimulatedCrash`
    propagates out of the processor pump — everything still queued at that
    instant is `lost_to_crash`, exactly the work a real power loss eats.
    Phase 2 reopens the path with the healthy pure-Python engine: replay
    truncates the torn record (store-level crash recovery), the recovered
    head MUST be crash_slot - 1, and the remaining slots run on a fresh
    node. The report's conservation invariant extends to
    published == processed + dropped + expired + lost_to_crash."""
    from ..store.kv import Column
    from ..store.native_kv import PurePythonKVStore
    from .storefaults import FaultPlan, FaultyKVStore, SimulatedCrash

    t_wall = time.time()
    datadir = datadir or tempfile.mkdtemp(prefix="loadgen-crash-")
    path = os.path.join(datadir, "hot.db")
    crash_slot = sc.crash_slot if sc.crash_slot is not None else sc.slots // 2
    # one head record per slot -> the crash slot's record is write #crash_slot+1;
    # keep 9 bytes (header + 1 payload byte): a torn record the CRC must catch
    store = FaultyKVStore(
        path, plan=FaultPlan(tear_at=crash_slot + 1, tear_keep_bytes=9),
        fsync="always",
    )
    clock = ManualSlotClock(0, max(1, int(sc.seconds_per_slot)))
    # ONE accountant across the crash and the restart: the scenario's
    # service level is what the OPERATOR saw, node identity aside
    slo_acct = SlotAccountant(export_metrics=False)
    incident_dir = _prepare_recorder(datadir, clock, slo_acct)
    node = LoadgenNode(sc, clock, store=store, slo_acct=slo_acct)
    schedule = traffic_schedule(sc)
    rng = random.Random(sc.seed ^ 0x10AD6E4)

    crash_msg = None
    resume_at = sc.slots
    for slot, traffic in enumerate(schedule):
        clock.set_slot(slot)
        node.publish_slot(slot, traffic, rng)
        try:
            node.processor.run_until_idle()
        except SimulatedCrash as e:
            crash_msg = str(e)
            resume_at = slot + 1   # the node is down for the rest of the slot
            RECORDER.record("node_crash", severity="error", slot=slot,
                            fault=str(e))
            if log_fn is not None:
                log_fn(f"slot {slot}: CRASH — {e}")
            break
        slo_acct.close_slot(slot)
        if log_fn is not None:
            log_fn(f"slot {slot}: published "
                   f"{traffic.attestations + traffic.stale_attestations} att "
                   f"/ {traffic.aggregates} agg / {traffic.blocks} block")
    proc1 = node.processor
    # work lost with the process: the unit being executed when the store
    # died (the block — its processed count never ticked) plus everything
    # still queued. Loadgen batches resolve synchronously, so there are no
    # in-flight device handles to account.
    lost_to_crash = 0
    if crash_msg is not None:
        lost_to_crash = 1 + sum(len(q) for q in proc1.queues.values())

    # ---- restart over the SAME datadir with the healthy engine: replay +
    # tail truncation recover the crash-consistent prefix
    store2 = PurePythonKVStore(path, fsync="always")
    raw = store2.get(Column.beacon_chain, b"head-slot")
    recovered_head = (
        int.from_bytes(raw, "little", signed=True) if raw is not None else None
    )
    expected_head = crash_slot - 1 if crash_msg is not None else sc.slots - 1
    node2 = LoadgenNode(sc, clock, store=store2, slo_acct=slo_acct)
    for slot in range(resume_at, sc.slots):
        clock.set_slot(slot)
        node2.publish_slot(slot, schedule[slot], rng)
        node2.processor.run_until_idle()
        slo_acct.close_slot(slot)
        if log_fn is not None:
            log_fn(f"slot {slot}: resumed node published "
                   f"{schedule[slot].attestations} att")
    clock.set_slot(sc.slots)
    node2.processor.run_until_idle()
    slo_acct.close_slot(sc.slots)
    store2.close()
    proc2 = node2.processor

    published = _merge_counts(node.published, node2.published)
    pub_total = sum(published.values())
    processed = _merge_counts(
        {k.name: v for k, v in proc1.processed.items() if v},
        {k.name: v for k, v in proc2.processed.items() if v},
    )
    dropped = _merge_counts(
        {k.name: v for k, v in proc1.dropped.items() if v},
        {k.name: v for k, v in proc2.dropped.items() if v},
    )
    expired = _merge_counts(
        {k.name: v for k, v in proc1.expired.items() if v},
        {k.name: v for k, v in proc2.expired.items() if v},
    )
    conservation = {
        "published": pub_total,
        "processed": sum(processed.values()),
        "dropped": sum(dropped.values()),
        "expired": sum(expired.values()),
        "lost_to_crash": lost_to_crash,
    }
    conservation["ok"] = conservation["published"] == (
        conservation["processed"] + conservation["dropped"]
        + conservation["expired"] + conservation["lost_to_crash"]
    )
    slo_block = _slo_block(slo_acct, incident_dir)
    # the deadline-hit ratio sits INSIDE the conservation block: "was work
    # conserved" and "was it in time" are the two halves of one verdict
    conservation["deadline_hit_ratio"] = slo_block["deadline_hit_ratio"]
    lag = node.block_slot_lag + node2.block_slot_lag
    report = {
        "scenario": sc.name,
        "seed": sc.seed,
        "slots": sc.slots,
        "n_validators": sc.n_validators,
        "flood_factor": sc.flood_factor,
        "faults": list(sc.faults),
        "crash": {
            "slot": crash_slot if crash_msg is not None else None,
            "fault": crash_msg,
            "datadir": datadir,
            "store_writes_at_crash": store.writes,
            "lost_to_crash": lost_to_crash,
            "recovered_head_slot": recovered_head,
            "expected_head_slot": expected_head,
            "resumed_from_persisted_head": recovered_head == expected_head,
            "resumed_at_slot": resume_at,
        },
        "published": published,
        "processed": processed,
        "dropped": dropped,
        "expired": expired,
        "conservation": conservation,
        "qos_totals": {
            "shed": proc1.qos_totals()["shed"] + proc2.qos_totals()["shed"],
            "expired": proc1.qos_totals()["expired"]
            + proc2.qos_totals()["expired"],
        },
        "shed_callbacks": node.shed_callbacks + node2.shed_callbacks,
        "verified_sets": node.verified_sets + node2.verified_sets,
        "batches": _merge_counts(node.batches, node2.batches),
        "breaker_transitions": list(node.breaker.transitions)
        + list(node2.breaker.transitions),
        "blocks_processed_in_slot": bool(lag) and max(lag) == 0,
        "slo": slo_block,
        "deadline_hit_ratio": slo_block["deadline_hit_ratio"],
        "elapsed_secs": round(time.time() - t_wall, 3),
    }
    # fully detach the run's wiring: a later incident in this process
    # must not be stamped by the dead manual clock or carry this run's
    # private accountant windows
    RECORDER.configure(incident_dir=None, clock=None, slo_provider=None)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report
