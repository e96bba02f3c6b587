"""OperationPool — pending operations + greedy max-cover attestation packing.

Parity surface: lighthouse/beacon_node/operation_pool/src/lib.rs:50
(pools for attestations, slashings, exits, BLS changes, sync contributions),
attestation_storage.rs (attestations stored split by data with compact
participation sets) and max_cover.rs (greedy weighted maximum-coverage
packing of aggregates into the block's MAX_ATTESTATIONS slots).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from ..state_transition import accessors as acc
from ..types import helpers as h
from ..types.spec import ChainSpec


@dataclass
class PooledAttestation:
    data_key: bytes              # hash_tree_root(AttestationData)
    data: object
    aggregation_bits: tuple[bool, ...]
    signature: bytes
    attesting_indices: frozenset[int]
    # electra (EIP-7549): which committees the aggregate covers; None for
    # pre-electra attestations (committee identified by data.index instead)
    committee_bits: tuple[bool, ...] | None = None


def max_cover(items: list[tuple[frozenset, float, object]], limit: int) -> list[object]:
    """Greedy weighted max-cover (max_cover.rs MaximumCover analog):
    items are (element_set, weight_per_element..., payload). Picks up to
    `limit` payloads maximizing newly-covered elements; re-scores each round."""
    chosen = []
    covered: set = set()
    remaining = list(items)
    for _ in range(limit):
        best = None
        best_gain = 0
        for entry in remaining:
            elems, weight, _payload = entry
            gain = sum(weight for e in elems if e not in covered)
            if gain > best_gain:
                best_gain = gain
                best = entry
        if best is None:
            break
        covered |= set(best[0])
        chosen.append(best[2])
        remaining.remove(best)
    return chosen


class OperationPool:
    def __init__(self, spec: ChainSpec):
        self.spec = spec
        # data_key -> list[PooledAttestation] (attestation_storage analog)
        self.attestations: dict[bytes, list[PooledAttestation]] = defaultdict(list)
        self.attestation_data: dict[bytes, object] = {}
        self.proposer_slashings: dict[int, object] = {}
        self.attester_slashings: list[object] = []
        self.voluntary_exits: dict[int, object] = {}
        self.bls_changes: dict[int, object] = {}
        self.sync_contributions: dict[tuple[int, bytes, int], object] = {}

    # ------------------------------------------------------------- inserts

    def insert_attestation(self, att, attesting_indices, types) -> None:
        key = types.AttestationData.hash_tree_root(att.data)
        cb = getattr(att, "committee_bits", None)
        entry = PooledAttestation(
            data_key=key,
            data=att.data,
            aggregation_bits=tuple(att.aggregation_bits),
            signature=bytes(att.signature),
            attesting_indices=frozenset(attesting_indices),
            committee_bits=tuple(cb) if cb is not None else None,
        )
        bucket = self.attestations[key]
        # drop if strictly covered by an existing aggregate
        for existing in bucket:
            if entry.attesting_indices <= existing.attesting_indices:
                return
        bucket[:] = [
            e for e in bucket if not (e.attesting_indices < entry.attesting_indices)
        ]
        bucket.append(entry)
        self.attestation_data[key] = att.data

    def insert_proposer_slashing(self, slashing) -> None:
        self.proposer_slashings[slashing.signed_header_1.message.proposer_index] = slashing

    def insert_attester_slashing(self, slashing) -> None:
        # dedup by content: a retried POST / regossip must not stack copies
        if any(s == slashing for s in self.attester_slashings):
            return
        self.attester_slashings.append(slashing)

    def insert_voluntary_exit(self, signed_exit) -> None:
        self.voluntary_exits[signed_exit.message.validator_index] = signed_exit

    def insert_bls_change(self, signed_change) -> None:
        self.bls_changes[signed_change.message.validator_index] = signed_change

    # ------------------------------------------------------------- packing

    def get_attestations_for_block(self, state, types) -> list:
        """Greedy max-cover packing into MAX_ATTESTATIONS
        (lib.rs:252-343 analog). Weight = effective-balance-weighted new
        coverage of (epoch, validator) pairs not yet on chain (approximated
        by participation flags)."""
        spec = self.spec
        current_epoch = acc.get_current_epoch(state, spec)
        previous_epoch = acc.get_previous_epoch(state, spec)
        items = []
        for key, bucket in self.attestations.items():
            data = self.attestation_data[key]
            if data.target.epoch not in (previous_epoch, current_epoch):
                continue
            if not (
                data.slot + spec.min_attestation_inclusion_delay
                <= state.slot
                <= data.slot + spec.preset.SLOTS_PER_EPOCH
            ):
                continue
            # the source must still match the packing state's justified
            # checkpoint, or process_attestation rejects the block (stale
            # attestations straddling a justification advance)
            justified = (
                state.current_justified_checkpoint
                if data.target.epoch == current_epoch
                else state.previous_justified_checkpoint
            )
            if data.source != justified:
                continue
            participation = (
                state.current_epoch_participation
                if data.target.epoch == current_epoch
                else state.previous_epoch_participation
            )
            for entry in bucket:
                fresh = frozenset(
                    i
                    for i in entry.attesting_indices
                    if not acc.has_flag(participation[i], acc.TIMELY_TARGET_FLAG_INDEX)
                )
                if not fresh:
                    continue
                items.append((fresh, 1.0, entry))
        # the block's fork decides the container shape: electra blocks can
        # only carry electra-shaped (committee_bits) attestations and vice
        # versa — at the fork boundary the mismatched pool tail is dropped,
        # exactly like the reference (and the test harness) does
        electra_block = any(
            f.name == "committee_bits" for f in types.Attestation.fields
        )
        limit = (
            spec.preset.MAX_ATTESTATIONS_ELECTRA
            if electra_block
            else spec.preset.MAX_ATTESTATIONS
        )
        candidates = [
            it
            for it in items
            if (it[2].committee_bits is not None) == electra_block
        ]
        # canonical order before the greedy pass: max_cover breaks ties by
        # list position, and the pool fills in gossip ARRIVAL order — two
        # nodes holding identical contents must pack identical blocks
        # (deterministic multi-node runs depend on it)
        candidates.sort(
            key=lambda it: (
                int(it[2].data.slot),
                sorted(it[0]),
                bytes(it[2].signature),
            )
        )
        chosen = max_cover(candidates, limit)
        out = []
        for entry in chosen:
            kwargs = dict(
                aggregation_bits=list(entry.aggregation_bits),
                data=entry.data,
                signature=entry.signature,
            )
            if electra_block:
                kwargs["committee_bits"] = list(entry.committee_bits)
            out.append(types.Attestation.make(**kwargs))
        return out

    def get_slashings_and_exits(self, state, types):
        spec = self.spec
        epoch = acc.get_current_epoch(state, spec)
        proposer_slashings = [
            s
            for s in self.proposer_slashings.values()
            if h.is_slashable_validator(
                state.validators[s.signed_header_1.message.proposer_index], epoch
            )
        ][: spec.preset.MAX_PROPOSER_SLASHINGS]
        def attester_slashing_includable(s) -> bool:
            # process_attester_slashing requires >=1 still-slashable common
            # index; packing a spent slashing invalidates the whole block
            common = set(s.attestation_1.attesting_indices) & set(
                s.attestation_2.attesting_indices
            )
            return any(
                i < len(state.validators)
                and h.is_slashable_validator(state.validators[i], epoch)
                for i in common
            )

        limit = getattr(
            spec.preset, "MAX_ATTESTER_SLASHINGS_ELECTRA", None
        ) if any(
            f.name == "committee_bits" for f in types.Attestation.fields
        ) else spec.preset.MAX_ATTESTER_SLASHINGS
        if limit is None:
            limit = spec.preset.MAX_ATTESTER_SLASHINGS
        attester_slashings = [
            s for s in self.attester_slashings if attester_slashing_includable(s)
        ][:limit]
        def exit_includable(e) -> bool:
            # mirror process_voluntary_exit's non-signature checks: packing
            # an op the state transition would reject invalidates the block
            vi = int(e.message.validator_index)
            if vi >= len(state.validators):
                return False
            v = state.validators[vi]
            return (
                v.exit_epoch == 2**64 - 1
                and h.is_active_validator(v, epoch)
                and epoch >= e.message.epoch
                and epoch >= v.activation_epoch + spec.shard_committee_period
            )

        exits = [
            e for e in self.voluntary_exits.values() if exit_includable(e)
        ][: spec.preset.MAX_VOLUNTARY_EXITS]
        def change_includable(c) -> bool:
            # mirror process_bls_to_execution_change's non-signature checks
            vi = int(c.message.validator_index)
            if vi >= len(state.validators):
                return False
            wc = bytes(state.validators[vi].withdrawal_credentials)
            return (
                wc[:1] == b"\x00"
                and wc[1:] == h.sha256(bytes(c.message.from_bls_pubkey))[1:]
            )

        changes = [
            c for c in self.bls_changes.values() if change_includable(c)
        ][: spec.preset.MAX_BLS_TO_EXECUTION_CHANGES]
        return proposer_slashings, attester_slashings, exits, changes

    # --------------------------------------------------------- persistence

    OP_POOL_KEY = b"persisted-op-pool"

    def persist(self, store, types) -> None:
        """Serialize the pool into the chain store so a restart does not
        drop pending operations (operation_pool/src/persistence.rs).
        Containers go through SSZ (their classes are built dynamically per
        SpecTypes, so pickling the objects directly would not round-trip)."""
        import pickle

        payload = {
            "attestations": [
                (
                    types.AttestationData.serialize(e.data),
                    list(e.aggregation_bits),
                    e.signature,
                    sorted(e.attesting_indices),
                    list(e.committee_bits) if e.committee_bits is not None else None,
                )
                for bucket in self.attestations.values()
                for e in bucket
            ],
            "proposer_slashings": [
                types.ProposerSlashing.serialize(s)
                for s in self.proposer_slashings.values()
            ],
            "attester_slashings": [
                types.AttesterSlashing.serialize(s) for s in self.attester_slashings
            ],
            "voluntary_exits": [
                types.SignedVoluntaryExit.serialize(e)
                for e in self.voluntary_exits.values()
            ],
            "bls_changes": [
                types.SignedBLSToExecutionChange.serialize(c)
                for c in self.bls_changes.values()
            ]
            if hasattr(types, "SignedBLSToExecutionChange")
            else [],
        }
        store.put_chain_item(self.OP_POOL_KEY, pickle.dumps(payload))

    @classmethod
    def load(cls, store, spec, types) -> "OperationPool":
        """Rebuild a pool persisted by `persist`; empty pool when none."""
        import pickle
        import types as _pytypes

        pool = cls(spec)
        raw = store.get_chain_item(cls.OP_POOL_KEY)
        if raw is None:
            return pool
        payload = pickle.loads(raw)
        for entry in payload["attestations"]:
            # tolerate the pre-committee_bits 4-tuple format (a store
            # persisted by an older build must not abort startup)
            data_ssz, bits, sig, indices = entry[:4]
            cb = entry[4] if len(entry) > 4 else None
            att = _pytypes.SimpleNamespace(
                data=types.AttestationData.deserialize(data_ssz),
                aggregation_bits=bits,
                signature=sig,
            )
            if cb is not None:
                att.committee_bits = cb
            pool.insert_attestation(att, indices, types)
        for s in payload["proposer_slashings"]:
            pool.insert_proposer_slashing(types.ProposerSlashing.deserialize(s))
        for s in payload["attester_slashings"]:
            pool.insert_attester_slashing(types.AttesterSlashing.deserialize(s))
        for e in payload["voluntary_exits"]:
            pool.insert_voluntary_exit(types.SignedVoluntaryExit.deserialize(e))
        if hasattr(types, "SignedBLSToExecutionChange"):
            for c in payload.get("bls_changes", []):
                pool.insert_bls_change(
                    types.SignedBLSToExecutionChange.deserialize(c)
                )
        return pool

    # ------------------------------------------------------------- pruning

    def prune(self, state) -> None:
        """Drop operations no longer includable (persistence.rs prune path)."""
        spec = self.spec
        current_epoch = acc.get_current_epoch(state, spec)
        keep = {}
        for key, bucket in self.attestations.items():
            data = self.attestation_data[key]
            if data.target.epoch + 1 >= current_epoch:
                keep[key] = bucket
        self.attestations = defaultdict(list, keep)
        self.attestation_data = {
            k: v for k, v in self.attestation_data.items() if k in keep
        }
        self.voluntary_exits = {
            i: e
            for i, e in self.voluntary_exits.items()
            if state.validators[i].exit_epoch == 2**64 - 1
        }
        self.proposer_slashings = {
            i: s
            for i, s in self.proposer_slashings.items()
            if not state.validators[i].slashed
        }
        epoch = acc.get_current_epoch(state, self.spec)
        self.attester_slashings = [
            s
            for s in self.attester_slashings
            if any(
                i < len(state.validators)
                and h.is_slashable_validator(state.validators[i], epoch)
                for i in set(s.attestation_1.attesting_indices)
                & set(s.attestation_2.attesting_indices)
            )
        ]
