"""Chain specification: fork schedule, presets, domains.

Runtime equivalent of the reference's two-level configuration (SURVEY.md §5
"Config/flag system"): the compile-time `EthSpec` const-generics trait
(lighthouse/consensus/types/src/eth_spec.rs:53) becomes a runtime
`Preset` (container sizes), and `ChainSpec`
(lighthouse/consensus/types/src/chain_spec.rs) stays the runtime
constants object (fork schedule, domains, time parameters). Python has no
monomorphization to win back; container descriptors are built per-preset
once and cached (types/containers.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum


class ForkName(str, Enum):
    phase0 = "phase0"
    altair = "altair"
    bellatrix = "bellatrix"
    capella = "capella"
    deneb = "deneb"
    electra = "electra"

    @property
    def order(self) -> int:
        return _FORK_ORDER.index(self)

    def __ge__(self, other):
        return self.order >= other.order

    def __gt__(self, other):
        return self.order > other.order

    def __le__(self, other):
        return self.order <= other.order

    def __lt__(self, other):
        return self.order < other.order


_FORK_ORDER = [
    ForkName.phase0,
    ForkName.altair,
    ForkName.bellatrix,
    ForkName.capella,
    ForkName.deneb,
    ForkName.electra,
]

FAR_FUTURE_EPOCH = 2**64 - 1


@dataclass(frozen=True)
class Preset:
    """Container-size constants (the EthSpec analog)."""

    name: str
    # time
    SLOTS_PER_EPOCH: int
    SLOTS_PER_HISTORICAL_ROOT: int
    EPOCHS_PER_ETH1_VOTING_PERIOD: int
    EPOCHS_PER_HISTORICAL_VECTOR: int
    EPOCHS_PER_SLASHINGS_VECTOR: int
    HISTORICAL_ROOTS_LIMIT: int
    VALIDATOR_REGISTRY_LIMIT: int
    # committees
    MAX_COMMITTEES_PER_SLOT: int
    TARGET_COMMITTEE_SIZE: int
    MAX_VALIDATORS_PER_COMMITTEE: int
    SHUFFLE_ROUND_COUNT: int
    # block body limits
    MAX_PROPOSER_SLASHINGS: int
    MAX_ATTESTER_SLASHINGS: int
    MAX_ATTESTATIONS: int
    MAX_DEPOSITS: int
    MAX_VOLUNTARY_EXITS: int
    # altair
    SYNC_COMMITTEE_SIZE: int
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD: int
    MIN_SYNC_COMMITTEE_PARTICIPANTS: int
    # bellatrix
    MAX_BYTES_PER_TRANSACTION: int
    MAX_TRANSACTIONS_PER_PAYLOAD: int
    BYTES_PER_LOGS_BLOOM: int
    MAX_EXTRA_DATA_BYTES: int
    # capella
    MAX_BLS_TO_EXECUTION_CHANGES: int
    MAX_WITHDRAWALS_PER_PAYLOAD: int
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP: int
    # deneb
    MAX_BLOB_COMMITMENTS_PER_BLOCK: int
    FIELD_ELEMENTS_PER_BLOB: int
    # electra
    MAX_ATTESTER_SLASHINGS_ELECTRA: int
    MAX_ATTESTATIONS_ELECTRA: int
    MAX_DEPOSIT_REQUESTS_PER_PAYLOAD: int
    MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD: int
    MAX_CONSOLIDATION_REQUESTS_PER_PAYLOAD: int
    PENDING_DEPOSITS_LIMIT: int
    PENDING_PARTIAL_WITHDRAWALS_LIMIT: int
    PENDING_CONSOLIDATIONS_LIMIT: int
    # misc deposit tree
    DEPOSIT_CONTRACT_TREE_DEPTH: int = 32
    MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP: int = 8
    MAX_PENDING_DEPOSITS_PER_EPOCH: int = 16


MAINNET_PRESET = Preset(
    name="mainnet",
    SLOTS_PER_EPOCH=32,
    SLOTS_PER_HISTORICAL_ROOT=8192,
    EPOCHS_PER_ETH1_VOTING_PERIOD=64,
    EPOCHS_PER_HISTORICAL_VECTOR=65536,
    EPOCHS_PER_SLASHINGS_VECTOR=8192,
    HISTORICAL_ROOTS_LIMIT=16777216,
    VALIDATOR_REGISTRY_LIMIT=2**40,
    MAX_COMMITTEES_PER_SLOT=64,
    TARGET_COMMITTEE_SIZE=128,
    MAX_VALIDATORS_PER_COMMITTEE=2048,
    SHUFFLE_ROUND_COUNT=90,
    MAX_PROPOSER_SLASHINGS=16,
    MAX_ATTESTER_SLASHINGS=2,
    MAX_ATTESTATIONS=128,
    MAX_DEPOSITS=16,
    MAX_VOLUNTARY_EXITS=16,
    SYNC_COMMITTEE_SIZE=512,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=256,
    MIN_SYNC_COMMITTEE_PARTICIPANTS=1,
    MAX_BYTES_PER_TRANSACTION=2**30,
    MAX_TRANSACTIONS_PER_PAYLOAD=2**20,
    BYTES_PER_LOGS_BLOOM=256,
    MAX_EXTRA_DATA_BYTES=32,
    MAX_BLS_TO_EXECUTION_CHANGES=16,
    MAX_WITHDRAWALS_PER_PAYLOAD=16,
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP=16384,
    MAX_BLOB_COMMITMENTS_PER_BLOCK=4096,
    FIELD_ELEMENTS_PER_BLOB=4096,
    MAX_ATTESTER_SLASHINGS_ELECTRA=1,
    MAX_ATTESTATIONS_ELECTRA=8,
    MAX_DEPOSIT_REQUESTS_PER_PAYLOAD=8192,
    MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD=16,
    MAX_CONSOLIDATION_REQUESTS_PER_PAYLOAD=2,
    PENDING_DEPOSITS_LIMIT=2**27,
    PENDING_PARTIAL_WITHDRAWALS_LIMIT=2**27,
    PENDING_CONSOLIDATIONS_LIMIT=2**18,
)

MINIMAL_PRESET = replace(
    MAINNET_PRESET,
    name="minimal",
    SLOTS_PER_EPOCH=8,
    SLOTS_PER_HISTORICAL_ROOT=64,
    EPOCHS_PER_ETH1_VOTING_PERIOD=4,
    EPOCHS_PER_HISTORICAL_VECTOR=64,
    EPOCHS_PER_SLASHINGS_VECTOR=64,
    MAX_COMMITTEES_PER_SLOT=4,
    TARGET_COMMITTEE_SIZE=4,
    SHUFFLE_ROUND_COUNT=10,
    SYNC_COMMITTEE_SIZE=32,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=8,
    MAX_WITHDRAWALS_PER_PAYLOAD=4,
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP=16,
    FIELD_ELEMENTS_PER_BLOB=4096,
    MAX_BLOB_COMMITMENTS_PER_BLOCK=32,
    MAX_DEPOSIT_REQUESTS_PER_PAYLOAD=4,
    MAX_WITHDRAWAL_REQUESTS_PER_PAYLOAD=2,
    PENDING_PARTIAL_WITHDRAWALS_LIMIT=64,
    PENDING_CONSOLIDATIONS_LIMIT=64,
    MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP=2,
)


# electra misc constants
UNSET_DEPOSIT_REQUESTS_START_INDEX = 2**64 - 1
FULL_EXIT_REQUEST_AMOUNT = 0
GENESIS_SLOT = 0
BLS_WITHDRAWAL_PREFIX = b"\x00"
ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"
COMPOUNDING_WITHDRAWAL_PREFIX = b"\x02"
# compressed G2 point at infinity (pending-deposit signature placeholder)
G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95


# domains (spec DomainType values, 4 bytes little-endian of the given ints)
DOMAIN_BEACON_PROPOSER = bytes([0, 0, 0, 0])
DOMAIN_BEACON_ATTESTER = bytes([1, 0, 0, 0])
DOMAIN_RANDAO = bytes([2, 0, 0, 0])
DOMAIN_DEPOSIT = bytes([3, 0, 0, 0])
DOMAIN_VOLUNTARY_EXIT = bytes([4, 0, 0, 0])
DOMAIN_SELECTION_PROOF = bytes([5, 0, 0, 0])
DOMAIN_AGGREGATE_AND_PROOF = bytes([6, 0, 0, 0])
DOMAIN_SYNC_COMMITTEE = bytes([7, 0, 0, 0])
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = bytes([8, 0, 0, 0])
DOMAIN_CONTRIBUTION_AND_PROOF = bytes([9, 0, 0, 0])
DOMAIN_BLS_TO_EXECUTION_CHANGE = bytes([10, 0, 0, 0])


@dataclass
class ChainSpec:
    """Runtime constants: fork schedule + gwei/time/validator parameters."""

    preset: Preset = field(default_factory=lambda: MAINNET_PRESET)
    config_name: str = "mainnet"

    # fork schedule: fork -> (version bytes, activation epoch or None)
    genesis_fork_version: bytes = bytes([0, 0, 0, 0])
    altair_fork_version: bytes = bytes([1, 0, 0, 0])
    altair_fork_epoch: int | None = 74240
    bellatrix_fork_version: bytes = bytes([2, 0, 0, 0])
    bellatrix_fork_epoch: int | None = 144896
    capella_fork_version: bytes = bytes([3, 0, 0, 0])
    capella_fork_epoch: int | None = 194048
    deneb_fork_version: bytes = bytes([4, 0, 0, 0])
    deneb_fork_epoch: int | None = 269568
    electra_fork_version: bytes = bytes([5, 0, 0, 0])
    electra_fork_epoch: int | None = None

    # time
    seconds_per_slot: int = 12
    min_genesis_time: int = 1606824000
    genesis_delay: int = 604800
    min_genesis_active_validator_count: int = 16384
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    min_epochs_to_inactivity_penalty: int = 4

    # gwei
    min_deposit_amount: int = 10**9
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9
    ejection_balance: int = 16 * 10**9
    # electra balances
    min_activation_balance: int = 32 * 10**9
    max_effective_balance_electra: int = 2048 * 10**9

    # rewards & penalties
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1
    # altair
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # bellatrix
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3
    # electra
    min_slashing_penalty_quotient_electra: int = 4096
    whistleblower_reward_quotient_electra: int = 4096

    # validator cycling
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_per_epoch_activation_churn_limit: int = 8
    min_per_epoch_churn_limit_electra: int = 128 * 10**9
    max_per_epoch_activation_exit_churn_limit: int = 256 * 10**9

    # justification
    justification_bits_length: int = 4

    # attestation subnets / p2p
    attestation_subnet_count: int = 64
    subnets_per_node: int = 2
    attestation_propagation_slot_range: int = 32
    maximum_gossip_clock_disparity_ms: int = 500
    target_aggregators_per_committee: int = 16

    # deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes(20)

    # sync committee aggregation
    sync_committee_subnet_count: int = 4
    target_aggregators_per_sync_subcommittee: int = 16

    # deneb
    max_blobs_per_block: int = 6
    max_blobs_per_block_electra: int = 9
    min_epochs_for_blob_sidecars_requests: int = 4096

    # terminal merge params
    terminal_total_difficulty: int = 58750000000000000000000
    terminal_block_hash: bytes = bytes(32)
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH

    # hysteresis
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5

    # proposer boost (fork choice)
    proposer_score_boost: int = 40
    reorg_head_weight_threshold: int = 20
    reorg_parent_weight_threshold: int = 160
    reorg_max_epochs_since_finalization: int = 2

    # -- derived helpers --------------------------------------------------

    def fork_version(self, fork: ForkName) -> bytes:
        return {
            ForkName.phase0: self.genesis_fork_version,
            ForkName.altair: self.altair_fork_version,
            ForkName.bellatrix: self.bellatrix_fork_version,
            ForkName.capella: self.capella_fork_version,
            ForkName.deneb: self.deneb_fork_version,
            ForkName.electra: self.electra_fork_version,
        }[fork]

    def fork_epoch(self, fork: ForkName) -> int | None:
        return {
            ForkName.phase0: 0,
            ForkName.altair: self.altair_fork_epoch,
            ForkName.bellatrix: self.bellatrix_fork_epoch,
            ForkName.capella: self.capella_fork_epoch,
            ForkName.deneb: self.deneb_fork_epoch,
            ForkName.electra: self.electra_fork_epoch,
        }[fork]

    def fork_name_at_epoch(self, epoch: int) -> ForkName:
        current = ForkName.phase0
        for fork in _FORK_ORDER[1:]:
            fe = self.fork_epoch(fork)
            if fe is not None and epoch >= fe:
                current = fork
        return current

    def fork_name_at_slot(self, slot: int) -> ForkName:
        return self.fork_name_at_epoch(slot // self.preset.SLOTS_PER_EPOCH)

    def churn_limit(self, active_validator_count: int) -> int:
        return max(
            self.min_per_epoch_churn_limit,
            active_validator_count // self.churn_limit_quotient,
        )

    def activation_churn_limit(self, active_validator_count: int) -> int:
        return min(
            self.max_per_epoch_activation_churn_limit,
            self.churn_limit(active_validator_count),
        )

    def max_blobs(self, fork: ForkName) -> int:
        return (
            self.max_blobs_per_block_electra
            if fork >= ForkName.electra
            else self.max_blobs_per_block
        )


def mainnet_spec() -> ChainSpec:
    return ChainSpec()


def minimal_spec(**overrides) -> ChainSpec:
    """Minimal preset with all forks at genesis — the test workhorse (the
    analog of the reference harness running MinimalEthSpec with
    spec.fork_epoch overrides)."""
    defaults = dict(
        preset=MINIMAL_PRESET,
        config_name="minimal",
        genesis_fork_version=bytes([0, 0, 0, 1]),
        altair_fork_version=bytes([1, 0, 0, 1]),
        altair_fork_epoch=0,
        bellatrix_fork_version=bytes([2, 0, 0, 1]),
        bellatrix_fork_epoch=0,
        capella_fork_version=bytes([3, 0, 0, 1]),
        capella_fork_epoch=0,
        deneb_fork_version=bytes([4, 0, 0, 1]),
        deneb_fork_epoch=0,
        electra_fork_version=bytes([5, 0, 0, 1]),
        electra_fork_epoch=None,
        min_genesis_active_validator_count=64,
        churn_limit_quotient=32,
        seconds_per_slot=6,
        min_per_epoch_churn_limit_electra=64 * 10**9,
    )
    defaults.update(overrides)
    return ChainSpec(**defaults)
