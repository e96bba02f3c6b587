"""Spec helper functions: domains, signing roots, shuffling, committees.

Parity surface: the free functions in the reference's `types` and
`swap_or_not_shuffle` crates —
compute_domain/compute_signing_root (consensus/types/src/chain_spec.rs,
signing_data usage), compute_shuffled_index
(lighthouse/consensus/swap_or_not_shuffle/src/), committee computation
(consensus/types/src/beacon_state/committee_cache.rs).

The shuffle is implemented both scalar (spec-identical, used for single
lookups) and as a full-permutation pass (shuffle_list, used by the committee
cache — one sha256 round per shuffling round per 256-index block, the same
batching trick the reference uses).
"""

from __future__ import annotations

import hashlib

from .spec import ChainSpec, ForkName, FAR_FUTURE_EPOCH


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def int_to_bytes(n: int, length: int) -> bytes:
    return n.to_bytes(length, "little")


def bytes_to_uint64(data: bytes) -> int:
    return int.from_bytes(data[:8], "little")


# ------------------------------------------------------------ domains


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    from .containers import spec_types
    from .spec import MAINNET_PRESET

    # ForkData is preset-independent; use any cached type set
    t = spec_types(MAINNET_PRESET, ForkName.phase0)
    fd = t.ForkData.make(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root,
    )
    return t.ForkData.hash_tree_root(fd)


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: bytes,
    genesis_validators_root: bytes,
) -> bytes:
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fork_data_root[:28]


def compute_signing_root_from_root(object_root: bytes, domain: bytes) -> bytes:
    from .containers import spec_types
    from .spec import MAINNET_PRESET

    t = spec_types(MAINNET_PRESET, ForkName.phase0)
    sd = t.SigningData.make(object_root=object_root, domain=domain)
    return t.SigningData.hash_tree_root(sd)


def compute_signing_root(ssz_type, obj, domain: bytes) -> bytes:
    from .containers import spec_types
    from .spec import MAINNET_PRESET

    t = spec_types(MAINNET_PRESET, ForkName.phase0)
    sd = t.SigningData.make(object_root=ssz_type.hash_tree_root(obj), domain=domain)
    return t.SigningData.hash_tree_root(sd)


def get_domain(state, spec: ChainSpec, domain_type: bytes, epoch: int | None = None) -> bytes:
    """Spec get_domain against a BeaconState."""
    ep = epoch if epoch is not None else compute_epoch_at_slot(state.slot, spec)
    fork_version = (
        state.fork.previous_version if ep < state.fork.epoch else state.fork.current_version
    )
    return compute_domain(domain_type, fork_version, state.genesis_validators_root)


# ------------------------------------------------------------ time math


def compute_epoch_at_slot(slot: int, spec: ChainSpec) -> int:
    return slot // spec.preset.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(epoch: int, spec: ChainSpec) -> int:
    return epoch * spec.preset.SLOTS_PER_EPOCH


def compute_activation_exit_epoch(epoch: int, spec: ChainSpec) -> int:
    return epoch + 1 + spec.max_seed_lookahead


# ------------------------------------------------------------ validator predicates


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_eligible_for_activation_queue(v, spec: ChainSpec, electra: bool = False) -> bool:
    if electra:
        # EIP-7251: any balance >= MIN_ACTIVATION_BALANCE is queue-eligible
        return (
            v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
            and v.effective_balance >= spec.min_activation_balance
        )
    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == spec.max_effective_balance
    )


# ------------------------------------------------------------ withdrawal credentials


def has_eth1_withdrawal_credential(v) -> bool:
    return bytes(v.withdrawal_credentials)[:1] == b"\x01"


def has_compounding_withdrawal_credential(v) -> bool:
    return bytes(v.withdrawal_credentials)[:1] == b"\x02"


def has_execution_withdrawal_credential(v) -> bool:
    return has_eth1_withdrawal_credential(v) or has_compounding_withdrawal_credential(v)


def get_max_effective_balance(v, spec: ChainSpec) -> int:
    """EIP-7251: compounding validators may hold up to 2048 ETH effective."""
    if has_compounding_withdrawal_credential(v):
        return spec.max_effective_balance_electra
    return spec.min_activation_balance


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and v.activation_epoch <= epoch < v.withdrawable_epoch


def get_active_validator_indices(state, epoch: int) -> list[int]:
    return [i for i, v in enumerate(state.validators) if is_active_validator(v, epoch)]


# ------------------------------------------------------------ randomness


def get_randao_mix(state, spec: ChainSpec, epoch: int) -> bytes:
    return state.randao_mixes[epoch % spec.preset.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(state, spec: ChainSpec, epoch: int, domain_type: bytes) -> bytes:
    mix = get_randao_mix(
        state,
        spec,
        epoch + spec.preset.EPOCHS_PER_HISTORICAL_VECTOR - spec.min_seed_lookahead - 1,
    )
    return sha256(domain_type + int_to_bytes(epoch, 8) + mix)


# ------------------------------------------------------------ shuffling


def compute_shuffled_index(index: int, index_count: int, seed: bytes, rounds: int) -> int:
    """Spec swap-or-not shuffle for a single index."""
    assert index < index_count
    for r in range(rounds):
        pivot = bytes_to_uint64(sha256(seed + bytes([r]))) % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = sha256(seed + bytes([r]) + int_to_bytes(position // 256, 4))
        byte_ = source[(position % 256) // 8]
        bit = (byte_ >> (position % 8)) & 1
        index = flip if bit else index
    return index


def shuffle_list(indices: list[int], seed: bytes, rounds: int) -> list[int]:
    """Whole-permutation swap-or-not (inverse direction, matching the
    reference's shuffle_list which shuffles a full list in O(n) per round).

    Equivalent to mapping compute_shuffled_index over 0..n, i.e.
    out[i] = indices[compute_shuffled_index(i)] — the orientation committee
    computation consumes (verified in tests/test_types.py)."""
    n = len(indices)
    if n == 0:
        return []
    out = list(indices)
    # run rounds in REVERSE so that the net permutation equals the forward
    # per-index shuffle applied to positions
    for r in reversed(range(rounds)):
        pivot = bytes_to_uint64(sha256(seed + bytes([r]))) % n
        # precompute hash blocks lazily per position block
        sources: dict[int, bytes] = {}

        def bit_at(position: int) -> int:
            block = position // 256
            if block not in sources:
                sources[block] = sha256(seed + bytes([r]) + int_to_bytes(block, 4))
            byte_ = sources[block][(position % 256) // 8]
            return (byte_ >> (position % 8)) & 1

        # In both regions the decision bit lives at position max(i, flip)
        # (spec: position = max(index, flip)); in region 1 that is
        # flip = pivot - i, in region 2 it is flip = pivot + n - i.
        mirror = (pivot + 1) // 2
        for i in range(mirror):
            flip = pivot - i
            if bit_at(flip):
                out[i], out[flip] = out[flip], out[i]
        mirror2 = (pivot + n + 1) // 2
        for i in range(pivot + 1, mirror2):
            flip = (pivot + n - i) % n
            if bit_at(pivot + n - i):
                out[i], out[flip] = out[flip], out[i]
    return out


def compute_committee(
    shuffled_indices: list[int], index: int, count: int
) -> list[int]:
    n = len(shuffled_indices)
    start = (n * index) // count
    end = (n * (index + 1)) // count
    return shuffled_indices[start:end]


def compute_proposer_index(
    state, spec: ChainSpec, indices: list[int], seed: bytes, electra: bool = False
) -> int:
    """Spec compute_proposer_index (effective-balance weighted sampling).

    Electra (EIP-7251) widens the acceptance sample from 1 random byte
    against MAX_EFFECTIVE_BALANCE to 2 bytes against
    MAX_EFFECTIVE_BALANCE_ELECTRA, so 2048-ETH validators sample evenly."""
    assert indices
    i = 0
    total = len(indices)
    while True:
        shuffled = compute_shuffled_index(
            i % total, total, seed, spec.preset.SHUFFLE_ROUND_COUNT
        )
        candidate = indices[shuffled]
        eff = state.validators[candidate].effective_balance
        if electra:
            rnd = sha256(seed + int_to_bytes(i // 16, 8))
            off = (i % 16) * 2
            random_value = int.from_bytes(rnd[off : off + 2], "little")
            if eff * 0xFFFF >= spec.max_effective_balance_electra * random_value:
                return candidate
        else:
            random_byte = sha256(seed + int_to_bytes(i // 32, 8))[i % 32]
            if eff * 255 >= spec.max_effective_balance * random_byte:
                return candidate
        i += 1
