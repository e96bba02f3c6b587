"""Beacon-state accessors (spec get_* functions) + committee cache.

Parity: the accessor layer of lighthouse/consensus/state_processing and
the committee cache of consensus/types/src/beacon_state/committee_cache.rs —
one whole-registry shuffle per (state, epoch), reused by every per-slot
committee lookup (the reference builds the same cache per shuffling epoch).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..types import helpers as h
from ..types.spec import (
    ChainSpec,
    ForkName,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_SYNC_COMMITTEE,
)

# participation flag indices (altair)
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
PARTICIPATION_FLAG_WEIGHTS = [14, 26, 14]  # TIMELY_SOURCE/TARGET/HEAD weights
WEIGHT_DENOMINATOR = 64
PROPOSER_WEIGHT = 8
SYNC_REWARD_WEIGHT = 2


def get_current_epoch(state, spec: ChainSpec) -> int:
    return h.compute_epoch_at_slot(state.slot, spec)


def get_previous_epoch(state, spec: ChainSpec) -> int:
    cur = get_current_epoch(state, spec)
    return cur - 1 if cur > 0 else 0


def get_block_root_at_slot(state, spec: ChainSpec, slot: int) -> bytes:
    assert slot < state.slot <= slot + spec.preset.SLOTS_PER_HISTORICAL_ROOT
    return state.block_roots[slot % spec.preset.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(state, spec: ChainSpec, epoch: int) -> bytes:
    return get_block_root_at_slot(state, spec, h.compute_start_slot_at_epoch(epoch, spec))


def get_total_balance(state, spec: ChainSpec, indices) -> int:
    return max(
        spec.effective_balance_increment,
        sum(state.validators[i].effective_balance for i in indices),
    )


def get_total_active_balance(state, spec: ChainSpec) -> int:
    return get_total_balance(
        state, spec, h.get_active_validator_indices(state, get_current_epoch(state, spec))
    )


@dataclass
class CommitteeCache:
    """Committees for one shuffling epoch: the full shuffled registry plus
    slicing metadata. Equivalent role to the reference's CommitteeCache."""

    epoch: int
    shuffled_indices: list[int]
    committees_per_slot: int
    slots_per_epoch: int

    def committee(self, slot: int, index: int) -> list[int]:
        slot_in_epoch = slot % self.slots_per_epoch
        committee_index = slot_in_epoch * self.committees_per_slot + index
        total = self.committees_per_slot * self.slots_per_epoch
        return h.compute_committee(self.shuffled_indices, committee_index, total)

    def committees_at_slot(self, slot: int) -> list[list[int]]:
        return [self.committee(slot, i) for i in range(self.committees_per_slot)]

    @property
    def active_validator_count(self) -> int:
        return len(self.shuffled_indices)


def get_committee_count_per_slot(active_count: int, spec: ChainSpec) -> int:
    p = spec.preset
    return max(
        1,
        min(
            p.MAX_COMMITTEES_PER_SLOT,
            active_count // p.SLOTS_PER_EPOCH // p.TARGET_COMMITTEE_SIZE,
        ),
    )


def build_committee_cache(state, spec: ChainSpec, epoch: int) -> CommitteeCache:
    cur = get_current_epoch(state, spec)
    assert epoch in (cur - 1, cur, cur + 1) or cur == 0, "epoch outside shuffling range"
    indices = h.get_active_validator_indices(state, epoch)
    seed = h.get_seed(state, spec, epoch, DOMAIN_BEACON_ATTESTER)
    shuffled = h.shuffle_list(indices, seed, spec.preset.SHUFFLE_ROUND_COUNT)
    return CommitteeCache(
        epoch=epoch,
        shuffled_indices=shuffled,
        committees_per_slot=get_committee_count_per_slot(len(indices), spec),
        slots_per_epoch=spec.preset.SLOTS_PER_EPOCH,
    )


def get_beacon_committee(state, spec: ChainSpec, slot: int, index: int, cache=None):
    epoch = h.compute_epoch_at_slot(slot, spec)
    if cache is None or cache.epoch != epoch:
        cache = build_committee_cache(state, spec, epoch)
    return cache.committee(slot, index)


def get_beacon_proposer_index(state, spec: ChainSpec, slot: int | None = None) -> int:
    from ..types.spec import ForkName

    slot = state.slot if slot is None else slot
    epoch = h.compute_epoch_at_slot(slot, spec)
    seed = h.sha256(
        h.get_seed(state, spec, epoch, DOMAIN_BEACON_PROPOSER) + h.int_to_bytes(slot, 8)
    )
    indices = h.get_active_validator_indices(state, epoch)
    electra = spec.fork_name_at_slot(slot) >= ForkName.electra
    return h.compute_proposer_index(state, spec, indices, seed, electra=electra)


def get_attesting_indices(state, spec: ChainSpec, data, aggregation_bits, cache=None):
    committee = get_beacon_committee(state, spec, data.slot, data.index, cache)
    if len(aggregation_bits) != len(committee):
        raise ValueError("aggregation bits length != committee size")
    return [i for i, bit in zip(committee, aggregation_bits) if bit]


def get_committee_indices(committee_bits) -> list[int]:
    """EIP-7549: the committee indices flagged in an electra attestation."""
    return [i for i, bit in enumerate(committee_bits) if bit]


def get_attesting_indices_electra(state, spec: ChainSpec, attestation, cache=None):
    """EIP-7549 get_attesting_indices: aggregation bits span the committees
    named by committee_bits, concatenated in index order. Strict: raises
    ValueError on bad committee indices, length mismatches, empty
    committee-bits, or a named committee with no attesters (the spec's
    process_attestation assertions)."""
    data = attestation.data
    if cache is None or cache.epoch != h.compute_epoch_at_slot(data.slot, spec):
        cache = build_committee_cache(state, spec, h.compute_epoch_at_slot(data.slot, spec))
    committee_indices = get_committee_indices(attestation.committee_bits)
    if not committee_indices:
        raise ValueError("no committee bits set")
    out: list[int] = []
    offset = 0
    bits = attestation.aggregation_bits
    for committee_index in committee_indices:
        if committee_index >= cache.committees_per_slot:
            raise ValueError("committee index out of range")
        committee = cache.committee(data.slot, committee_index)
        if offset + len(committee) > len(bits):
            raise ValueError("aggregation bits length != total committee size")
        committee_attesters = [
            vi for i, vi in enumerate(committee) if bits[offset + i]
        ]
        if not committee_attesters:
            raise ValueError("committee with no attesters")
        out.extend(committee_attesters)
        offset += len(committee)
    if len(bits) != offset:
        raise ValueError("aggregation bits length != total committee size")
    return sorted(set(out))


# ------------------------------------------------------------ altair helpers


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def get_unslashed_participating_indices(state, spec: ChainSpec, flag_index: int, epoch: int):
    cur = get_current_epoch(state, spec)
    assert epoch in (cur, get_previous_epoch(state, spec))
    participation = (
        state.current_epoch_participation
        if epoch == cur
        else state.previous_epoch_participation
    )
    active = h.get_active_validator_indices(state, epoch)
    return {
        i
        for i in active
        if has_flag(participation[i], flag_index) and not state.validators[i].slashed
    }


def get_base_reward_per_increment(state, spec: ChainSpec) -> int:
    return (
        spec.effective_balance_increment
        * spec.base_reward_factor
        // _integer_squareroot(get_total_active_balance(state, spec))
    )


def get_base_reward(state, spec: ChainSpec, index: int) -> int:
    increments = state.validators[index].effective_balance // spec.effective_balance_increment
    return increments * get_base_reward_per_increment(state, spec)


def _integer_squareroot(n: int) -> int:
    import math

    return math.isqrt(n)


def get_finality_delay(state, spec: ChainSpec) -> int:
    return get_previous_epoch(state, spec) - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state, spec: ChainSpec) -> bool:
    return get_finality_delay(state, spec) > spec.min_epochs_to_inactivity_penalty


# ------------------------------------------------------------ sync committee


def get_next_sync_committee_indices(state, spec: ChainSpec) -> list[int]:
    from ..types.spec import ForkName

    epoch = get_current_epoch(state, spec) + 1
    electra = spec.fork_name_at_epoch(epoch) >= ForkName.electra
    active = h.get_active_validator_indices(state, epoch)
    count = len(active)
    seed = h.get_seed(state, spec, epoch, DOMAIN_SYNC_COMMITTEE)
    i = 0
    out: list[int] = []
    while len(out) < spec.preset.SYNC_COMMITTEE_SIZE:
        shuffled = h.compute_shuffled_index(i % count, count, seed, spec.preset.SHUFFLE_ROUND_COUNT)
        candidate = active[shuffled]
        eff = state.validators[candidate].effective_balance
        if electra:
            rnd = h.sha256(seed + h.int_to_bytes(i // 16, 8))
            off = (i % 16) * 2
            random_value = int.from_bytes(rnd[off : off + 2], "little")
            if eff * 0xFFFF >= spec.max_effective_balance_electra * random_value:
                out.append(candidate)
        else:
            random_byte = h.sha256(seed + h.int_to_bytes(i // 32, 8))[i % 32]
            if eff * 255 >= spec.max_effective_balance * random_byte:
                out.append(candidate)
        i += 1
    return out
