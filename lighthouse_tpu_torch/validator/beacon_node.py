"""Beacon-node interface for the validator client + multi-node fallback.

Parity surface: the typed client boundary of lighthouse/common/eth2
(BeaconNodeHttpClient, src/lib.rs:156) and the VC's
BeaconNodeFallback health-ranked redundancy
(validator_client/src/beacon_node_fallback.rs). The VC talks to a small
duck-typed interface; `InProcessBeaconNode` implements it directly over a
BeaconChain (the simulator path — testing/simulator analog), and an HTTP
client implementing the same surface slots in for production (api/client).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..state_transition import accessors as acc
from ..state_transition.slot import types_for_slot
from ..types import helpers as h
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

log = get_logger("vc_fallback")

VC_FALLBACK = REGISTRY.counter_vec(
    "vc_fallback_total",
    "validator-client beacon-node fallback calls, by method and outcome "
    "(success / error / timeout / rate_limited / retry / probe_up / "
    "all_failed)",
    ("method", "result"),
)
VC_NODE_HEALTH = REGISTRY.gauge_vec(
    "vc_node_health_score",
    "per-node fallback health score in [0,1] (1 = every recent call "
    "succeeded; failures halve it, timeouts quarter it, successes decay "
    "it back toward 1)",
    ("node",),
)

#: default per-call deadline in seconds (the VC analog of --rpc-timeout)
DEFAULT_CALL_TIMEOUT = 5.0
#: below this score a node is DEMOTED: it ranks behind every healthy
#: node and is only probed back, never retried first
DEMOTION_THRESHOLD = 0.5


def resolve_call_timeout(explicit: float | None = None) -> float:
    """Per-call deadline resolution: explicit arg / --vc-timeout >
    LIGHTHOUSE_TPU_VC_TIMEOUT > 5.0 (the --rpc-timeout pattern). A value
    <= 0 disables the deadline."""
    if explicit is not None:
        return float(explicit)
    env = os.environ.get("LIGHTHOUSE_TPU_VC_TIMEOUT")
    if env:
        try:
            return float(env)
        except ValueError:
            log.warn("bad LIGHTHOUSE_TPU_VC_TIMEOUT ignored", value=env)
    return DEFAULT_CALL_TIMEOUT


@dataclass
class AttesterDuty:
    pubkey: bytes
    validator_index: int
    slot: int
    committee_index: int
    committee_length: int
    committee_position: int
    committees_at_slot: int


@dataclass
class ProposerDuty:
    pubkey: bytes
    validator_index: int
    slot: int


@dataclass
class SyncDuty:
    pubkey: bytes
    validator_index: int
    positions: list   # [(subcommittee_index, index_in_subcommittee)]


class BeaconNodeError(Exception):
    pass


class NodeTimeout(BeaconNodeError):
    """A beacon-node call blew its deadline (the classified-timeout shape:
    socket timeout, injected silent peer, or a slow call measured past the
    per-call budget)."""


class NodeRateLimited(BeaconNodeError):
    """The node's token bucket refused the call (HTTP 429 shape)."""

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


class _NullLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class InProcessBeaconNode:
    """The VC-visible API implemented straight over a BeaconChain.

    Optional wiring makes it a full BN surface for the fleet harness:
    `op_pool` enables `produce_block`, `net` gossips published
    blocks/attestations to peers (what a real BN does after accepting a
    publish), and `lock` serializes chain mutations with the network
    node's handler threads."""

    def __init__(self, chain, op_pool=None, net=None, lock=None):
        self.chain = chain
        self.op_pool = op_pool
        self.net = net
        self.lock = lock if lock is not None else _NullLock()
        self.healthy = True

    # -- node status -----------------------------------------------------

    def is_healthy(self) -> bool:
        return self.healthy

    def genesis_validators_root(self) -> bytes:
        return bytes(self.chain.head_state().genesis_validators_root)

    # -- duties ----------------------------------------------------------

    def attester_duties(self, epoch: int, indices: list[int]) -> list[AttesterDuty]:
        if not self.healthy:
            raise BeaconNodeError("node down")
        chain = self.chain
        state = chain.head_state()
        spec = chain.spec
        # advance a clone when the requested epoch is beyond the head's
        # shuffling horizon (the reference advances the state the same way
        # in its duties endpoint)
        if epoch > acc.get_current_epoch(state, spec) + 1:
            from ..testing.harness import clone_state
            from ..state_transition.slot import process_slots

            state = clone_state(state, spec)
            process_slots(state, spec, h.compute_start_slot_at_epoch(epoch, spec))
        cache = acc.build_committee_cache(state, spec, epoch)
        wanted = set(indices)
        duties = []
        for slot in range(
            h.compute_start_slot_at_epoch(epoch, spec),
            h.compute_start_slot_at_epoch(epoch + 1, spec),
        ):
            for cidx in range(cache.committees_per_slot):
                committee = cache.committee(slot, cidx)
                for pos, vi in enumerate(committee):
                    if vi in wanted:
                        duties.append(
                            AttesterDuty(
                                pubkey=bytes(state.validators[vi].pubkey),
                                validator_index=vi,
                                slot=slot,
                                committee_index=cidx,
                                committee_length=len(committee),
                                committee_position=pos,
                                committees_at_slot=cache.committees_per_slot,
                            )
                        )
        return duties

    def proposer_duties(self, epoch: int) -> list[ProposerDuty]:
        if not self.healthy:
            raise BeaconNodeError("node down")
        chain = self.chain
        spec = chain.spec
        from ..testing.harness import clone_state
        from ..state_transition.slot import process_slots

        state = clone_state(chain.head_state(), spec)
        start = h.compute_start_slot_at_epoch(epoch, spec)
        if state.slot < start:
            process_slots(state, spec, start)
        duties = []
        for slot in range(start, start + spec.preset.SLOTS_PER_EPOCH):
            proposer = acc.get_beacon_proposer_index(state, spec, slot)
            duties.append(
                ProposerDuty(
                    pubkey=bytes(state.validators[proposer].pubkey),
                    validator_index=proposer,
                    slot=slot,
                )
            )
        return duties

    # -- attestation flow ------------------------------------------------

    def attestation_data(self, slot: int, committee_index: int, types=None):
        if not self.healthy:
            raise BeaconNodeError("node down")
        chain = self.chain
        spec = chain.spec
        types = types_for_slot(spec, slot)
        epoch = h.compute_epoch_at_slot(slot, spec)

        # early-attester path: serve the block imported this slot straight
        # from the cache (populated only when it won fork choice) without
        # touching a full state (early_attester_cache.rs)
        early = chain.early_attester_cache.try_attest(slot, chain.head_root)
        if early is not None:
            return types.AttestationData.make(
                slot=slot,
                index=committee_index,
                beacon_block_root=early.beacon_block_root,
                source=types.Checkpoint.make(
                    epoch=early.source_epoch, root=early.source_root
                ),
                target=types.Checkpoint.make(
                    epoch=early.target_epoch, root=early.target_root
                ),
            )

        head_root = chain.head_root
        # attester cache: (epoch, head) -> (source, target_root) without
        # touching the full state (attester_cache.rs)
        cached = chain.attester_cache.get(epoch, head_root)
        if cached is not None:
            source, target_root = cached
        else:
            state = chain.head_state()
            start_slot = h.compute_start_slot_at_epoch(epoch, spec)
            if state.slot <= start_slot:
                target_root = head_root
            else:
                target_root = bytes(
                    state.block_roots[start_slot % spec.preset.SLOTS_PER_HISTORICAL_ROOT]
                )
            source = (
                state.current_justified_checkpoint
                if epoch == acc.get_current_epoch(state, spec)
                else state.previous_justified_checkpoint
            )
            chain.attester_cache.put(epoch, head_root, source, target_root)
        return types.AttestationData.make(
            slot=slot,
            index=committee_index,
            beacon_block_root=head_root,
            source=source,
            target=types.Checkpoint.make(epoch=epoch, root=target_root),
        )

    #: attestation gossip fans out over this many subnet topics when a
    #: `net` is wired (the harness's subnet count; production parity is
    #: spec.attestation_subnet_count)
    subnet_count = 2

    def _att_subnet(self, att) -> int:
        cidx = int(att.data.index)
        cb = getattr(att, "committee_bits", None)
        if cb:
            cidx = next((i for i, b in enumerate(cb) if b), 0)
        return cidx % max(1, self.subnet_count)

    def publish_attestations(self, attestations, types=None) -> int:
        """BN re-verifies, imports and gossips; returns count accepted."""
        if not self.healthy:
            raise BeaconNodeError("node down")
        with self.lock:
            verified = self.chain.verify_unaggregated_attestations(
                attestations
            )
            for att, indices in verified:
                self.chain.apply_attestation_to_fork_choice(att, indices)
                if self.op_pool is not None:
                    self.op_pool.insert_attestation(
                        att, indices,
                        types or types_for_slot(self.chain.spec,
                                                att.data.slot),
                    )
        if self.net is not None:
            for att, _indices in verified:
                self.net.publish_attestation(att, self._att_subnet(att))
        return len(verified)

    def aggregate_attestation(self, slot: int, data_root: bytes):
        """Serve an aggregate from the naive aggregation pool
        (GET /eth/v1/validator/aggregate_attestation)."""
        if not self.healthy:
            raise BeaconNodeError("node down")
        types = types_for_slot(self.chain.spec, slot)
        agg = self.chain.naive_attestation_pool.get_aggregate(slot, data_root, types)
        if agg is None:
            raise BeaconNodeError("no aggregate known")
        return agg

    def publish_aggregates(self, signed_aggregates, types=None) -> int:
        if not self.healthy:
            raise BeaconNodeError("node down")
        with self.lock:
            verified = self.chain.verify_aggregated_attestations(
                signed_aggregates
            )
            for att, indices in verified:
                self.chain.apply_attestation_to_fork_choice(att, indices)
        if self.net is not None:
            # gossip only what verification ACCEPTED (the attestation path
            # above does the same): pushing a refused aggregate to mesh
            # peers earns this node their invalid-message penalties
            accepted = {id(att) for att, _indices in verified}
            for agg in signed_aggregates:
                if id(agg.message.aggregate) in accepted:
                    self.net.publish_aggregate(agg)
        return len(verified)

    # -- sync committee flow ----------------------------------------------

    def sync_duties(self, epoch: int, indices: list[int]) -> list["SyncDuty"]:
        """Current-period sync-committee membership for the given validators
        (POST /eth/v1/validator/duties/sync)."""
        if not self.healthy:
            raise BeaconNodeError("node down")
        duties = []
        state = self.chain.head_state()
        if not hasattr(state, "current_sync_committee"):
            return duties
        for vi in indices:
            positions = self.chain.sync_subcommittee_positions(vi)
            if positions:
                duties.append(
                    SyncDuty(
                        pubkey=bytes(state.validators[vi].pubkey),
                        validator_index=vi,
                        positions=positions,
                    )
                )
        return duties

    def publish_sync_messages(self, msgs) -> int:
        if not self.healthy:
            raise BeaconNodeError("node down")
        with self.lock:
            return self.chain.process_sync_committee_messages(msgs)

    def sync_committee_contribution(self, slot: int, subcommittee_index: int, beacon_block_root: bytes):
        if not self.healthy:
            raise BeaconNodeError("node down")
        types = types_for_slot(self.chain.spec, slot)
        contrib = self.chain.naive_sync_pool.get_contribution(
            slot, beacon_block_root, subcommittee_index, types
        )
        if contrib is None:
            raise BeaconNodeError("no contribution known")
        return contrib

    def publish_contributions(self, signed_contributions) -> int:
        if not self.healthy:
            raise BeaconNodeError("node down")
        n = 0
        for sc in signed_contributions:
            if self.chain.verify_signed_contribution(sc):
                n += 1
        return n

    # -- preparation ------------------------------------------------------

    def prepare_beacon_proposer(self, preparations) -> int:
        """Record fee recipients (POST /eth/v1/validator/prepare_beacon_proposer)."""
        if not self.healthy:
            raise BeaconNodeError("node down")
        for p in preparations:
            self.chain.proposer_preparations[p["validator_index"]] = p["fee_recipient"]
        return len(preparations)

    # -- blocks ----------------------------------------------------------

    def produce_block(self, slot: int, randao_reveal: bytes, types=None,
                      graffiti: bytes | None = None):
        """Unsigned block on the node's head (GET /eth/v3/validator/blocks).
        Requires an `op_pool` to pack operations from."""
        if not self.healthy:
            raise BeaconNodeError("node down")
        with self.lock:
            return self.chain.produce_block(
                slot, randao_reveal, op_pool=self.op_pool, graffiti=graffiti
            )

    def publish_block(self, signed_block, types=None) -> bytes:
        if not self.healthy:
            raise BeaconNodeError("node down")
        with self.lock:
            root = self.chain.verify_block_for_gossip(signed_block)
            out = self.chain.process_block(
                signed_block, block_root=root, proposal_already_verified=True
            )
        if self.net is not None:
            self.net.publish_block(signed_block)
        return out


class _Candidate:
    """Per-node fallback health state. Score lives in [0,1]: successes
    decay it back toward 1, errors halve it, timeouts quarter it; below
    DEMOTION_THRESHOLD the node ranks behind every healthy peer. `label`
    is a STABLE identity for metrics (the HTTP client's URL, a harness
    node's global index) — list position alone would alias every
    fallback instance's first node onto one series."""

    __slots__ = ("node", "index", "label", "score", "last_result",
                 "demotions")

    def __init__(self, node, index: int):
        self.node = node
        self.index = index
        ident = getattr(node, "base_url", None)
        if ident is None:
            ident = getattr(node, "index", None)
        self.label = str(ident if ident is not None else index)
        self.score = 1.0
        self.last_result = "untried"
        self.demotions = 0

    @property
    def demoted(self) -> bool:
        return self.score < DEMOTION_THRESHOLD

    def is_healthy(self) -> bool:
        try:
            return bool(self.node.is_healthy())
        except Exception:  # noqa: BLE001 — an unreachable node is unhealthy
            return False


def classify_failure(exc: Exception) -> str:
    """Map a node-call exception onto a fallback outcome: timeout-shaped
    failures (socket timeout, injected silent peer, NodeTimeout) sink the
    node hard; rate limiting is the node protecting itself and is retried
    without demotion; everything else is an error. Rate limiting is
    recognized by TYPE (NodeRateLimited — the HTTP client raises it for
    status 429) or an explicit phrase, never a bare '429' substring: an
    error mentioning epoch 429 must not exempt a broken node from
    demotion."""
    if isinstance(exc, NodeRateLimited):
        return "rate_limited"
    name = type(exc).__name__.lower()
    text = str(exc).lower()
    if "timeout" in name or "timeout" in text or "timed out" in text:
        return "timeout"
    if "rate limit" in text or "rate-limit" in text or (
        "too many requests" in text
    ):
        return "rate_limited"
    return "error"


class BeaconNodeFallback:
    """Health-ranked multi-node redundancy (beacon_node_fallback.rs), with
    per-call deadlines, failure-driven health scoring and bounded
    retry/backoff.

    Every call is measured against `call_timeout` on the injectable
    `clock` (a call that returns late still sinks its node: the next duty
    prefers a faster peer). Failures demote a node's score — errors halve
    it, timeouts quarter it — and a demoted node ranks behind every
    healthy one; it is probed back via `is_healthy()` every `probe_every`
    calls instead of being retried first forever. One duty gets at most
    `max_retries` extra rounds across the ranked nodes, separated by
    exponential backoff through the injectable `sleep_fn` (tests and the
    fleet harness record delays instead of sleeping). Outcomes land in
    `vc_fallback_total{method,result}`; demotions in the flight recorder;
    deterministic per-instance tallies in `stats`."""

    BACKOFF_BASE = 0.05
    BACKOFF_CAP = 2.0
    #: hard ceiling on how long a server's Retry-After may stretch the
    #: between-round backoff — with deadlines disabled (call_timeout 0)
    #: an unclamped header would be an unbounded server-controlled sleep
    RETRY_AFTER_CAP = 30.0

    def __init__(self, nodes: list, call_timeout: float | None = None,
                 clock=time.monotonic, sleep_fn=time.sleep,
                 max_retries: int = 2, probe_every: int = 8,
                 recorder=None):
        self._candidates = [_Candidate(n, i) for i, n in enumerate(nodes)]
        self.call_timeout = resolve_call_timeout(call_timeout)
        self.clock = clock
        self.sleep_fn = sleep_fn
        self.max_retries = int(max_retries)
        self.probe_every = int(probe_every)
        self.recorder = recorder
        self._calls = 0
        self.last_served: int | None = None
        #: deterministic per-instance tallies (scenario reports)
        self.stats = {
            "calls": 0, "successes": 0, "errors": 0, "timeouts": 0,
            "rate_limited": 0, "retries": 0, "failovers": 0,
            "probes_up": 0, "exhausted": 0,
            "retry_after_honored": 0, "retry_after_skipped": 0,
        }

    @property
    def nodes(self) -> list:
        return [c.node for c in self._candidates]

    def health_scores(self) -> dict[int, float]:
        return {c.index: round(c.score, 4) for c in self._candidates}

    # ---------------------------------------------------------- internals

    def _ranked(self, health: dict[int, bool] | None = None) -> list[_Candidate]:
        """Rank by (healthy, score, index). `health` is probed ONCE per
        duty call and reused across retry rounds — for an HTTP client
        is_healthy() is a real network GET, and re-probing every node
        every round would spend the duty deadline on health checks; the
        failure-driven scores are the intra-call freshness signal."""
        if health is None:
            health = {c.index: c.is_healthy() for c in self._candidates}
        return sorted(
            self._candidates,
            key=lambda c: (not health[c.index], -c.score, c.index),
        )

    def _set_score(self, cand: _Candidate, score: float, reason: str) -> None:
        was_demoted = cand.demoted
        cand.score = min(1.0, max(0.0, score))
        VC_NODE_HEALTH.labels(cand.label).set(cand.score)
        if cand.demoted and not was_demoted:
            cand.demotions += 1
            log.warn("beacon node demoted", node=cand.label,
                     score=f"{cand.score:.3f}", reason=reason)
            if self.recorder is not None:
                self.recorder.record(
                    "vc_node_demoted", severity="warn", node=cand.label,
                    score=round(cand.score, 4), reason=reason,
                )

    def _record_failure(self, cand: _Candidate, method: str, outcome: str,
                        exc: Exception | None = None) -> None:
        VC_FALLBACK.labels(method, outcome).inc()
        self.stats[
            "timeouts" if outcome == "timeout"
            else "rate_limited" if outcome == "rate_limited"
            else "errors"
        ] += 1
        cand.last_result = outcome
        if outcome == "rate_limited":
            return   # the node is healthy, just busy: never demote for 429s
        factor = 0.25 if outcome == "timeout" else 0.5
        self._set_score(cand, cand.score * factor, outcome)

    def _record_success(self, cand: _Candidate, method: str) -> None:
        VC_FALLBACK.labels(method, "success").inc()
        self.stats["successes"] += 1
        cand.last_result = "success"
        self._set_score(cand, 0.5 * cand.score + 0.5, "success")

    def _probe_demoted(self) -> None:
        """Probe every demoted node's health endpoint; a live answer lifts
        it back to the demotion boundary so ranking can try it again."""
        for cand in self._candidates:
            if not cand.demoted:
                continue
            if cand.is_healthy():
                self.stats["probes_up"] += 1
                VC_FALLBACK.labels("probe", "probe_up").inc()
                self._set_score(cand, DEMOTION_THRESHOLD, "probe_up")

    # -------------------------------------------------------------- calls

    def first_success(self, method: str, *args, **kwargs):
        result, _node, _attempts = self.call_detailed(method, *args, **kwargs)
        return result

    def call_detailed(self, method: str, *args, **kwargs):
        """Like first_success but returns (result, serving_node_index,
        attempts) — the fleet harness attributes work to the node that
        actually served it."""
        self._calls += 1
        self.stats["calls"] += 1
        if self.probe_every and self._calls % self.probe_every == 0:
            self._probe_demoted()
        errors: list[tuple[int, str]] = []
        attempts = 0
        t_begin = self.clock()
        retry_floor = 0.0  # max Retry-After seen in the previous round
        health = {c.index: c.is_healthy() for c in self._candidates}
        for round_no in range(self.max_retries + 1):
            if round_no:
                delay = min(self.BACKOFF_CAP,
                            self.BACKOFF_BASE * (2 ** (round_no - 1)))
                if retry_floor > 0.0:
                    # honor Retry-After as the backoff FLOOR — unless
                    # honoring it would sleep past the remaining duty
                    # deadline, in which case the round proceeds on plain
                    # exponential backoff (failing over beats out-sleeping
                    # the slot; the limiting node was already skipped
                    # within the round)
                    remaining = (
                        self.call_timeout - (self.clock() - t_begin)
                        if self.call_timeout > 0 else float("inf")
                    )
                    if retry_floor <= remaining:
                        delay = max(delay, retry_floor)
                        self.stats["retry_after_honored"] += 1
                        VC_FALLBACK.labels(method, "retry_after_honored").inc()
                    else:
                        self.stats["retry_after_skipped"] += 1
                        VC_FALLBACK.labels(method, "retry_after_skipped").inc()
                retry_floor = 0.0
                self.stats["retries"] += 1
                VC_FALLBACK.labels(method, "retry").inc()
                self.sleep_fn(delay)
            for pos, cand in enumerate(self._ranked(health)):
                attempts += 1
                start = self.clock()
                try:
                    result = getattr(cand.node, method)(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 — fail over
                    outcome = classify_failure(e)
                    if outcome == "rate_limited":
                        ra = float(getattr(e, "retry_after", 0.0) or 0.0)
                        retry_floor = max(
                            retry_floor, min(ra, self.RETRY_AFTER_CAP)
                        )
                    self._record_failure(cand, method, outcome, e)
                    errors.append((cand.index,
                                   f"{type(e).__name__}: {e}"))
                    continue
                if (self.call_timeout > 0
                        and self.clock() - start > self.call_timeout):
                    # the answer arrived past the deadline: use it (it is
                    # real), but sink the node so the next duty routes to
                    # a faster peer first
                    self._record_failure(cand, method, "timeout")
                else:
                    self._record_success(cand, method)
                if pos or round_no:
                    self.stats["failovers"] += 1
                self.last_served = cand.index
                return result, cand.index, attempts
        self.stats["exhausted"] += 1
        VC_FALLBACK.labels(method, "all_failed").inc()
        raise BeaconNodeError(
            f"all beacon nodes failed {method} after "
            f"{self.max_retries + 1} rounds: {errors}"
        )
