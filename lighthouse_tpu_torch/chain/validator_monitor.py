"""ValidatorMonitor — per-validator performance tracking.

Parity surface: lighthouse/beacon_node/beacon_chain/src/
validator_monitor.rs (2.1k LoC): registered validators get per-epoch
hit/miss accounting for attestations (source/target/head timeliness and
inclusion delay), block proposals INCLUDING missed proposals, and
sync-committee duty performance; epoch summaries are logged at epoch
boundaries (misses at warning level — the operator alert), exported as
Prometheus metrics, and served over the API
(/lighthouse_tpu/ui/validator-metrics — ui.rs post_validator_monitor_metrics
analog). BeaconChain drives the event methods from its import path and
epoch rollover (beacon_chain.py), so a registered validator is observed
with no further configuration anywhere else.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from ..state_transition import accessors as acc
from ..types.spec import ChainSpec
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

log = get_logger("validator_monitor")

MONITORED_VALIDATORS = REGISTRY.gauge(
    "validator_monitor_validators", "Number of validators being monitored"
)
# hit/miss observations as labeled families (one family per duty, broken
# down by outcome) instead of the previous six ad-hoc singletons — a
# dashboard computes a per-duty hit ratio with one `sum by (result)`
# query, and the SLO epoch window ingests the same verdicts
# (observability/slo.py record_validator_epoch).
MONITOR_BLOCKS = REGISTRY.counter_vec(
    "validator_monitor_blocks_total",
    "Monitored validators' proposal duties, by outcome "
    "(proposed / missed)",
    ("result",),
)
MONITOR_ATTESTATIONS = REGISTRY.counter_vec(
    "validator_monitor_attestations_total",
    "Monitored validators' per-epoch attestation verdicts, by outcome "
    "(timely_target = credit earned / miss = epoch closed with no credit)",
    ("result",),
)
MONITOR_SYNC = REGISTRY.counter_vec(
    "validator_monitor_sync_total",
    "Monitored validators' sync-committee slots, by outcome "
    "(included / missed)",
    ("result",),
)


@dataclass
class EpochSummary:
    attestations: int = 0
    attestation_min_delay: int | None = None
    attestation_source_hits: int = 0
    attestation_target_hits: int = 0
    attestation_head_hits: int = 0
    blocks_proposed: int = 0
    blocks_missed: int = 0
    sync_signatures: int = 0
    sync_misses: int = 0
    slashed: bool = False

    def as_dict(self) -> dict:
        return {
            "attestations": self.attestations,
            "attestation_min_inclusion_delay": self.attestation_min_delay,
            "attestation_source_hits": self.attestation_source_hits,
            "attestation_target_hits": self.attestation_target_hits,
            "attestation_head_hits": self.attestation_head_hits,
            "blocks_proposed": self.blocks_proposed,
            "blocks_missed": self.blocks_missed,
            "sync_signatures": self.sync_signatures,
            "sync_misses": self.sync_misses,
            "slashed": self.slashed,
        }


class ValidatorMonitor:
    def __init__(self, spec: ChainSpec, auto_register: bool = False):
        self.spec = spec
        self.auto_register = auto_register
        self.watched: set[int] = set()
        # (validator_index, epoch) -> EpochSummary
        self.summaries: dict[tuple[int, int], EpochSummary] = defaultdict(EpochSummary)
        # epoch -> [(slot, proposer_index)] expected duties (miss detection)
        self._proposer_duties: dict[int, list[tuple[int, int]]] = {}
        # slots that actually got an imported block, per epoch
        self._proposed_slots: dict[int, set[int]] = defaultdict(set)
        self._finalized_epochs: set[int] = set()

    @property
    def active(self) -> bool:
        return self.auto_register or bool(self.watched)

    def register(self, validator_index: int) -> None:
        self.watched.add(int(validator_index))
        MONITORED_VALIDATORS.set(len(self.watched))

    def _tracked(self, idx: int) -> bool:
        return self.auto_register or idx in self.watched

    # ------------------------------------------------------------- events

    def on_block_imported(self, block, attesting_index_sets) -> None:
        """Called on import with the block and, per included attestation,
        its attesting indices + inclusion info."""
        epoch = block.slot // self.spec.preset.SLOTS_PER_EPOCH
        self._proposed_slots[epoch].add(int(block.slot))
        if self._tracked(block.proposer_index):
            self.summaries[(block.proposer_index, epoch)].blocks_proposed += 1
            MONITOR_BLOCKS.labels("proposed").inc()
            log.info(
                "monitored proposal included",
                validator=int(block.proposer_index),
                slot=int(block.slot),
            )
        for att, indices in attesting_index_sets:
            delay = block.slot - att.data.slot
            att_epoch = att.data.target.epoch
            for vi in indices:
                if not self._tracked(vi):
                    continue
                s = self.summaries[(vi, att_epoch)]
                s.attestations += 1
                if s.attestation_min_delay is None or delay < s.attestation_min_delay:
                    s.attestation_min_delay = delay

    def on_sync_aggregate(self, slot: int, committee_indices, bits) -> None:
        """Per imported block: the sync-committee membership (validator
        indices in committee order; negative = unknown pubkey, skipped)
        and the block's participation bits."""
        epoch = slot // self.spec.preset.SLOTS_PER_EPOCH
        for vi, bit in zip(committee_indices, bits):
            if vi < 0 or not self._tracked(vi):
                continue
            s = self.summaries[(vi, epoch)]
            if bit:
                s.sync_signatures += 1
                MONITOR_SYNC.labels("included").inc()
            else:
                s.sync_misses += 1
                MONITOR_SYNC.labels("missed").inc()

    def on_proposer_duties(self, epoch: int, duties) -> None:
        """Record expected proposers for an epoch: [(slot, validator_idx)]."""
        self._proposer_duties[epoch] = [(int(s), int(v)) for s, v in duties]

    def on_attestation_participation(self, state, epoch: int) -> None:
        """Read participation flags after epoch processing (altair+)."""
        if not hasattr(state, "previous_epoch_participation"):
            return
        for vi, flags in enumerate(state.previous_epoch_participation):
            if not self._tracked(vi):
                continue
            s = self.summaries[(vi, epoch)]
            if acc.has_flag(flags, acc.TIMELY_SOURCE_FLAG_INDEX):
                s.attestation_source_hits += 1
            if acc.has_flag(flags, acc.TIMELY_TARGET_FLAG_INDEX):
                s.attestation_target_hits += 1
            if acc.has_flag(flags, acc.TIMELY_HEAD_FLAG_INDEX):
                s.attestation_head_hits += 1

    def on_slashing(self, validator_index: int, epoch: int) -> None:
        if self._tracked(validator_index):
            self.summaries[(validator_index, epoch)].slashed = True
            log.warn(
                "monitored validator slashed",
                validator=int(validator_index),
                epoch=int(epoch),
            )

    def finalize_epoch(self, epoch: int, state=None) -> None:
        """Close the books for an epoch: read participation flags (state is
        a post-state whose PREVIOUS epoch is `epoch`), detect missed
        proposals against the recorded duties, and emit the operator-facing
        epoch summary — misses at warning level (the missed-block /
        missed-attestation alerting the reference provides)."""
        if epoch < 0 or epoch in self._finalized_epochs:
            return
        self._finalized_epochs.add(epoch)
        if state is not None:
            self.on_attestation_participation(state, epoch)

        proposed = self._proposed_slots.get(epoch, set())
        epoch_hits = 0
        epoch_misses = 0
        for slot, vi in self._proposer_duties.pop(epoch, []):
            if not self._tracked(vi):
                continue
            if slot not in proposed:
                self.summaries[(vi, epoch)].blocks_missed += 1
                MONITOR_BLOCKS.labels("missed").inc()
                epoch_misses += 1
                log.warn(
                    "monitored validator MISSED a block",
                    validator=vi, slot=slot, epoch=epoch,
                )
            else:
                # fulfilled proposal duties are HITS in the SLO epoch
                # window — misses alone would bias the ratio downward
                epoch_hits += 1

        # explicit registrations always get a verdict (including "no data" ->
        # miss); in auto mode, every validator the epoch produced data for
        report_set = set(self.watched) | {
            vi for (vi, e) in self.summaries.keys() if e == epoch
        }
        for vi in sorted(report_set):
            s = self.summaries[(vi, epoch)]
            if s.attestation_target_hits:
                MONITOR_ATTESTATIONS.labels("timely_target").inc(
                    s.attestation_target_hits
                )
                epoch_hits += s.attestation_target_hits
                log.info(
                    "validator epoch summary", validator=vi, epoch=epoch,
                    attestations=s.attestations,
                    min_inclusion_delay=s.attestation_min_delay,
                    target_hits=s.attestation_target_hits,
                    head_hits=s.attestation_head_hits,
                    proposed=s.blocks_proposed,
                    sync_signatures=s.sync_signatures,
                )
            else:
                MONITOR_ATTESTATIONS.labels("miss").inc()
                epoch_misses += 1
                log.warn(
                    "monitored validator MISSED attestation credit",
                    validator=vi, epoch=epoch, attestations=s.attestations,
                )
            # sync-committee verdicts were counted per slot at import time
            # (on_sync_aggregate); fold them into the same epoch feed
            epoch_hits += s.sync_signatures
            epoch_misses += s.sync_misses
        if epoch_hits or epoch_misses:
            # the duty verdicts land in the SLO epoch window next to the
            # pipeline's deadline accounting (observability/slo.py)
            from ..observability import slo as obs_slo

            obs_slo.ACCOUNTANT.record_validator_epoch(epoch_hits, epoch_misses)

    # ------------------------------------------------------------- queries

    def summary(self, validator_index: int, epoch: int) -> EpochSummary:
        return self.summaries[(validator_index, epoch)]

    def epoch_report(self, epoch: int) -> dict[int, EpochSummary]:
        return {vi: s for (vi, e), s in self.summaries.items() if e == epoch}

    def metrics_for(self, indices, epoch: int) -> dict:
        """API payload: {index: summary dict} for the given epoch (the
        /lighthouse_tpu/ui/validator-metrics response body)."""
        out = {}
        for vi in indices:
            s = self.summaries.get((int(vi), epoch))
            out[str(int(vi))] = (s or EpochSummary()).as_dict()
        return out

    def prune(self, before_epoch: int) -> None:
        self.summaries = defaultdict(
            EpochSummary,
            {k: v for k, v in self.summaries.items() if k[1] >= before_epoch},
        )
        for e in [e for e in self._proposed_slots if e < before_epoch]:
            del self._proposed_slots[e]
        for e in [e for e in self._proposer_duties if e < before_epoch]:
            del self._proposer_duties[e]
        self._finalized_epochs = {e for e in self._finalized_epochs if e >= before_epoch}
