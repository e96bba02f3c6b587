"""Consensus containers, fork-versioned, built per-preset.

The reference expresses fork variance with `superstruct` macros over six
forks (lighthouse/consensus/types/src/beacon_state.rs:208,
beacon_block.rs, etc.) and container sizes with `EthSpec` const generics.
Here a `SpecTypes` object is built once per (preset, fork) pair: every spec
container as an SSZ descriptor with the right sizes, and the per-fork
field deltas applied in order (altair participation flags, bellatrix
payloads, capella withdrawals, deneb blobs, electra requests).

Values are the cheap generated dataclasses from ssz.core — `state.slot` is a
plain int, `state.validators` a plain list — friendly both to host logic and
to columnar extraction for device kernels. The exception at validator scale:
the big per-validator state fields ride `ssz/cow.py`'s chunked copy-on-write
`CowList` (list-alike; adopted by `clone_state` once a field crosses
`cow_min_len()`, never at genesis/deserialize construction), so clones share
chunk structure and re-roots hash only dirty chunks. Code holding a state
list should index/iterate it, not assume `type(...) is list`.
"""

from __future__ import annotations

from functools import lru_cache

from ..ssz.core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Vector,
    boolean,
    uint8,
    uint64,
    uint256,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
)
from .spec import ForkName, Preset

# type aliases matching spec names
Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
ValidatorIndex = uint64
Gwei = uint64
Root = Bytes32
Hash32 = Bytes32
Version = Bytes4
DomainType = Bytes4
ForkDigest = Bytes4
BLSPubkey = Bytes48
BLSSignature = Bytes96
KZGCommitment = Bytes48
KZGProof = Bytes48
ExecutionAddress = Bytes20
ParticipationFlags = uint8


class SpecTypes:
    """All container descriptors for one (preset, fork)."""

    def __init__(self, preset: Preset, fork: ForkName):
        self.preset = preset
        self.fork = fork
        p = preset

        C = Container

        # ---- primitives shared by all forks
        self.Fork = C("Fork", [
            ("previous_version", Version),
            ("current_version", Version),
            ("epoch", Epoch),
        ])
        self.ForkData = C("ForkData", [
            ("current_version", Version),
            ("genesis_validators_root", Root),
        ])
        self.Checkpoint = C("Checkpoint", [("epoch", Epoch), ("root", Root)])
        self.Validator = C("Validator", [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("effective_balance", Gwei),
            ("slashed", boolean),
            ("activation_eligibility_epoch", Epoch),
            ("activation_epoch", Epoch),
            ("exit_epoch", Epoch),
            ("withdrawable_epoch", Epoch),
        ])
        self.AttestationData = C("AttestationData", [
            ("slot", Slot),
            ("index", CommitteeIndex),
            ("beacon_block_root", Root),
            ("source", self.Checkpoint),
            ("target", self.Checkpoint),
        ])
        self.IndexedAttestation = C("IndexedAttestation", [
            ("attesting_indices", List(ValidatorIndex, p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", self.AttestationData),
            ("signature", BLSSignature),
        ])
        self.PendingAttestation = C("PendingAttestation", [
            ("aggregation_bits", Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", self.AttestationData),
            ("inclusion_delay", Slot),
            ("proposer_index", ValidatorIndex),
        ])
        self.Eth1Data = C("Eth1Data", [
            ("deposit_root", Root),
            ("deposit_count", uint64),
            ("block_hash", Hash32),
        ])
        self.DepositMessage = C("DepositMessage", [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("amount", Gwei),
        ])
        self.DepositData = C("DepositData", [
            ("pubkey", BLSPubkey),
            ("withdrawal_credentials", Bytes32),
            ("amount", Gwei),
            ("signature", BLSSignature),
        ])
        self.BeaconBlockHeader = C("BeaconBlockHeader", [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body_root", Root),
        ])
        self.SignedBeaconBlockHeader = C("SignedBeaconBlockHeader", [
            ("message", self.BeaconBlockHeader),
            ("signature", BLSSignature),
        ])
        self.SigningData = C("SigningData", [
            ("object_root", Root),
            ("domain", Bytes32),
        ])
        self.Attestation = C("Attestation", [
            ("aggregation_bits", Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", self.AttestationData),
            ("signature", BLSSignature),
        ])
        self.AttesterSlashing = C("AttesterSlashing", [
            ("attestation_1", self.IndexedAttestation),
            ("attestation_2", self.IndexedAttestation),
        ])
        self.Deposit = C("Deposit", [
            ("proof", Vector(Bytes32, p.DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
            ("data", self.DepositData),
        ])
        self.ProposerSlashing = C("ProposerSlashing", [
            ("signed_header_1", self.SignedBeaconBlockHeader),
            ("signed_header_2", self.SignedBeaconBlockHeader),
        ])
        self.VoluntaryExit = C("VoluntaryExit", [
            ("epoch", Epoch),
            ("validator_index", ValidatorIndex),
        ])
        self.SignedVoluntaryExit = C("SignedVoluntaryExit", [
            ("message", self.VoluntaryExit),
            ("signature", BLSSignature),
        ])
        self.AggregateAndProof = C("AggregateAndProof", [
            ("aggregator_index", ValidatorIndex),
            ("aggregate", self.Attestation),
            ("selection_proof", BLSSignature),
        ])
        self.SignedAggregateAndProof = C("SignedAggregateAndProof", [
            ("message", self.AggregateAndProof),
            ("signature", BLSSignature),
        ])
        self.HistoricalBatch = C("HistoricalBatch", [
            ("block_roots", Vector(Bytes32, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Bytes32, p.SLOTS_PER_HISTORICAL_ROOT)),
        ])

        # ---- altair
        if fork >= ForkName.altair:
            self.SyncAggregate = C("SyncAggregate", [
                ("sync_committee_bits", Bitvector(p.SYNC_COMMITTEE_SIZE)),
                ("sync_committee_signature", BLSSignature),
            ])
            self.SyncCommittee = C("SyncCommittee", [
                ("pubkeys", Vector(BLSPubkey, p.SYNC_COMMITTEE_SIZE)),
                ("aggregate_pubkey", BLSPubkey),
            ])
            self.SyncCommitteeMessage = C("SyncCommitteeMessage", [
                ("slot", Slot),
                ("beacon_block_root", Root),
                ("validator_index", ValidatorIndex),
                ("signature", BLSSignature),
            ])
            self.SyncCommitteeContribution = C("SyncCommitteeContribution", [
                ("slot", Slot),
                ("beacon_block_root", Root),
                ("subcommittee_index", uint64),
                ("aggregation_bits", Bitvector(p.SYNC_COMMITTEE_SIZE // 4)),
                ("signature", BLSSignature),
            ])
            self.SyncAggregatorSelectionData = C("SyncAggregatorSelectionData", [
                ("slot", Slot),
                ("subcommittee_index", uint64),
            ])
            self.ContributionAndProof = C("ContributionAndProof", [
                ("aggregator_index", ValidatorIndex),
                ("contribution", self.SyncCommitteeContribution),
                ("selection_proof", BLSSignature),
            ])
            self.SignedContributionAndProof = C("SignedContributionAndProof", [
                ("message", self.ContributionAndProof),
                ("signature", BLSSignature),
            ])

        # ---- bellatrix execution payload
        if fork >= ForkName.bellatrix:
            self.Transaction = ByteList(p.MAX_BYTES_PER_TRANSACTION)
            payload_fields = [
                ("parent_hash", Hash32),
                ("fee_recipient", ExecutionAddress),
                ("state_root", Bytes32),
                ("receipts_root", Bytes32),
                ("logs_bloom", ByteVector(p.BYTES_PER_LOGS_BLOOM)),
                ("prev_randao", Bytes32),
                ("block_number", uint64),
                ("gas_limit", uint64),
                ("gas_used", uint64),
                ("timestamp", uint64),
                ("extra_data", ByteList(p.MAX_EXTRA_DATA_BYTES)),
                ("base_fee_per_gas", uint256),
                ("block_hash", Hash32),
                ("transactions", List(self.Transaction, p.MAX_TRANSACTIONS_PER_PAYLOAD)),
            ]
            header_fields = payload_fields[:-1] + [("transactions_root", Root)]
            if fork >= ForkName.capella:
                self.Withdrawal = C("Withdrawal", [
                    ("index", uint64),
                    ("validator_index", ValidatorIndex),
                    ("address", ExecutionAddress),
                    ("amount", Gwei),
                ])
                payload_fields = payload_fields + [
                    ("withdrawals", List(self.Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD))
                ]
                header_fields = header_fields + [("withdrawals_root", Root)]
            if fork >= ForkName.deneb:
                payload_fields = payload_fields + [
                    ("blob_gas_used", uint64),
                    ("excess_blob_gas", uint64),
                ]
                header_fields = header_fields + [
                    ("blob_gas_used", uint64),
                    ("excess_blob_gas", uint64),
                ]
            self.ExecutionPayload = C("ExecutionPayload", payload_fields)
            self.ExecutionPayloadHeader = C("ExecutionPayloadHeader", header_fields)

        # ---- capella
        if fork >= ForkName.capella:
            self.BLSToExecutionChange = C("BLSToExecutionChange", [
                ("validator_index", ValidatorIndex),
                ("from_bls_pubkey", BLSPubkey),
                ("to_execution_address", ExecutionAddress),
            ])
            self.SignedBLSToExecutionChange = C("SignedBLSToExecutionChange", [
                ("message", self.BLSToExecutionChange),
                ("signature", BLSSignature),
            ])
            self.HistoricalSummary = C("HistoricalSummary", [
                ("block_summary_root", Root),
                ("state_summary_root", Root),
            ])

        # ---- deneb blobs
        if fork >= ForkName.deneb:
            self.Blob = ByteVector(32 * p.FIELD_ELEMENTS_PER_BLOB)
            self.BlobIdentifier = C("BlobIdentifier", [
                ("block_root", Root),
                ("index", uint64),
            ])

        # ---- electra (EIP-6110/7002/7251/7549)
        if fork >= ForkName.electra:
            self.PendingDeposit = C("PendingDeposit", [
                ("pubkey", BLSPubkey),
                ("withdrawal_credentials", Bytes32),
                ("amount", Gwei),
                ("signature", BLSSignature),
                ("slot", Slot),
            ])
            self.PendingPartialWithdrawal = C("PendingPartialWithdrawal", [
                ("validator_index", ValidatorIndex),
                ("amount", Gwei),
                ("withdrawable_epoch", Epoch),
            ])
            self.PendingConsolidation = C("PendingConsolidation", [
                ("source_index", ValidatorIndex),
                ("target_index", ValidatorIndex),
            ])
            self.DepositRequest = C("DepositRequest", [
                ("pubkey", BLSPubkey),
                ("withdrawal_credentials", Bytes32),
                ("amount", Gwei),
                ("signature", BLSSignature),
                ("index", uint64),
            ])
            self.WithdrawalRequest = C("WithdrawalRequest", [
                ("source_address", ExecutionAddress),
                ("validator_pubkey", BLSPubkey),
                ("amount", Gwei),
            ])
            self.ConsolidationRequest = C("ConsolidationRequest", [
                ("source_address", ExecutionAddress),
                ("source_pubkey", BLSPubkey),
                ("target_pubkey", BLSPubkey),
            ])
            self.ExecutionRequests = C("ExecutionRequests", [
                ("deposits", List(self.DepositRequest, p.MAX_DEPOSIT_REQUESTS_PER_PAYLOAD)),
                ("withdrawals", List(self.WithdrawalRequest, p.MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD)),
                ("consolidations", List(self.ConsolidationRequest, p.MAX_CONSOLIDATION_REQUESTS_PER_PAYLOAD)),
            ])
            # EIP-7549: attestations span all committees of a slot; the
            # committee index moves out of AttestationData into committee_bits
            max_agg_bits = p.MAX_VALIDATORS_PER_COMMITTEE * p.MAX_COMMITTEES_PER_SLOT
            self.Attestation = C("Attestation", [
                ("aggregation_bits", Bitlist(max_agg_bits)),
                ("data", self.AttestationData),
                ("signature", BLSSignature),
                ("committee_bits", Bitvector(p.MAX_COMMITTEES_PER_SLOT)),
            ])
            self.IndexedAttestation = C("IndexedAttestation", [
                ("attesting_indices", List(ValidatorIndex, max_agg_bits)),
                ("data", self.AttestationData),
                ("signature", BLSSignature),
            ])
            self.AttesterSlashing = C("AttesterSlashing", [
                ("attestation_1", self.IndexedAttestation),
                ("attestation_2", self.IndexedAttestation),
            ])
            self.AggregateAndProof = C("AggregateAndProof", [
                ("aggregator_index", ValidatorIndex),
                ("aggregate", self.Attestation),
                ("selection_proof", BLSSignature),
            ])
            self.SignedAggregateAndProof = C("SignedAggregateAndProof", [
                ("message", self.AggregateAndProof),
                ("signature", BLSSignature),
            ])
            self.SingleAttestation = C("SingleAttestation", [
                ("committee_index", CommitteeIndex),
                ("attester_index", ValidatorIndex),
                ("data", self.AttestationData),
                ("signature", BLSSignature),
            ])

        # ---- block body (per fork)
        if fork >= ForkName.electra:
            max_att_slashings = p.MAX_ATTESTER_SLASHINGS_ELECTRA
            max_atts = p.MAX_ATTESTATIONS_ELECTRA
        else:
            max_att_slashings = p.MAX_ATTESTER_SLASHINGS
            max_atts = p.MAX_ATTESTATIONS
        body_fields = [
            ("randao_reveal", BLSSignature),
            ("eth1_data", self.Eth1Data),
            ("graffiti", Bytes32),
            ("proposer_slashings", List(self.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
            ("attester_slashings", List(self.AttesterSlashing, max_att_slashings)),
            ("attestations", List(self.Attestation, max_atts)),
            ("deposits", List(self.Deposit, p.MAX_DEPOSITS)),
            ("voluntary_exits", List(self.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
        ]
        if fork >= ForkName.altair:
            body_fields.append(("sync_aggregate", self.SyncAggregate))
        if fork >= ForkName.bellatrix:
            body_fields.append(("execution_payload", self.ExecutionPayload))
        if fork >= ForkName.capella:
            body_fields.append(
                ("bls_to_execution_changes",
                 List(self.SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES))
            )
        if fork >= ForkName.deneb:
            body_fields.append(
                ("blob_kzg_commitments",
                 List(KZGCommitment, p.MAX_BLOB_COMMITMENTS_PER_BLOCK))
            )
        if fork >= ForkName.electra:
            body_fields.append(("execution_requests", self.ExecutionRequests))
        self.BeaconBlockBody = C("BeaconBlockBody", body_fields)

        self.BeaconBlock = C("BeaconBlock", [
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", self.BeaconBlockBody),
        ])
        self.SignedBeaconBlock = C("SignedBeaconBlock", [
            ("message", self.BeaconBlock),
            ("signature", BLSSignature),
        ])

        if fork >= ForkName.deneb:
            # proof depth = list data tree + length mix-in + body container
            # (17 on mainnet: 12 + 1 + 4)
            def _log2ceil(n):
                d = 0
                while (1 << d) < n:
                    d += 1
                return d

            proof_depth = (
                _log2ceil(p.MAX_BLOB_COMMITMENTS_PER_BLOCK)
                + 1
                + _log2ceil(len(body_fields))
            )
            self.BlobSidecar = C("BlobSidecar", [
                ("index", uint64),
                ("blob", self.Blob),
                ("kzg_commitment", KZGCommitment),
                ("kzg_proof", KZGProof),
                ("signed_block_header", self.SignedBeaconBlockHeader),
                ("kzg_commitment_inclusion_proof", Vector(Bytes32, proof_depth)),
            ])

        # ---- beacon state (per fork)
        state_fields = [
            ("genesis_time", uint64),
            ("genesis_validators_root", Root),
            ("slot", Slot),
            ("fork", self.Fork),
            ("latest_block_header", self.BeaconBlockHeader),
            ("block_roots", Vector(Bytes32, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", Vector(Bytes32, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("historical_roots", List(Bytes32, p.HISTORICAL_ROOTS_LIMIT)),
            ("eth1_data", self.Eth1Data),
            ("eth1_data_votes",
             List(self.Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH)),
            ("eth1_deposit_index", uint64),
            ("validators", List(self.Validator, p.VALIDATOR_REGISTRY_LIMIT)),
            ("balances", List(Gwei, p.VALIDATOR_REGISTRY_LIMIT)),
            ("randao_mixes", Vector(Bytes32, p.EPOCHS_PER_HISTORICAL_VECTOR)),
            ("slashings", Vector(Gwei, p.EPOCHS_PER_SLASHINGS_VECTOR)),
        ]
        if fork == ForkName.phase0:
            state_fields += [
                ("previous_epoch_attestations",
                 List(self.PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)),
                ("current_epoch_attestations",
                 List(self.PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH)),
            ]
        else:
            state_fields += [
                ("previous_epoch_participation",
                 List(ParticipationFlags, p.VALIDATOR_REGISTRY_LIMIT)),
                ("current_epoch_participation",
                 List(ParticipationFlags, p.VALIDATOR_REGISTRY_LIMIT)),
            ]
        state_fields += [
            ("justification_bits", Bitvector(4)),
            ("previous_justified_checkpoint", self.Checkpoint),
            ("current_justified_checkpoint", self.Checkpoint),
            ("finalized_checkpoint", self.Checkpoint),
        ]
        if fork >= ForkName.altair:
            state_fields += [
                ("inactivity_scores", List(uint64, p.VALIDATOR_REGISTRY_LIMIT)),
                ("current_sync_committee", self.SyncCommittee),
                ("next_sync_committee", self.SyncCommittee),
            ]
        if fork >= ForkName.bellatrix:
            state_fields += [
                ("latest_execution_payload_header", self.ExecutionPayloadHeader),
            ]
        if fork >= ForkName.capella:
            state_fields += [
                ("next_withdrawal_index", uint64),
                ("next_withdrawal_validator_index", ValidatorIndex),
                ("historical_summaries",
                 List(self.HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT)),
            ]
        if fork >= ForkName.electra:
            state_fields += [
                ("deposit_requests_start_index", uint64),
                ("deposit_balance_to_consume", Gwei),
                ("exit_balance_to_consume", Gwei),
                ("earliest_exit_epoch", Epoch),
                ("consolidation_balance_to_consume", Gwei),
                ("earliest_consolidation_epoch", Epoch),
                ("pending_deposits",
                 List(self.PendingDeposit, p.PENDING_DEPOSITS_LIMIT)),
                ("pending_partial_withdrawals",
                 List(self.PendingPartialWithdrawal, p.PENDING_PARTIAL_WITHDRAWALS_LIMIT)),
                ("pending_consolidations",
                 List(self.PendingConsolidation, p.PENDING_CONSOLIDATIONS_LIMIT)),
            ]
        self.BeaconState = C("BeaconState", state_fields)


@lru_cache(maxsize=16)
def spec_types(preset: Preset, fork: ForkName) -> SpecTypes:
    return SpecTypes(preset, fork)
