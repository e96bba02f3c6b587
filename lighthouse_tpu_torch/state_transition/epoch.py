"""process_epoch — spec epoch transition, phase0 and altair+ paths.

Parity surface: lighthouse/consensus/state_processing/src/
per_epoch_processing.rs:33 and the single-pass optimization layout of
per_epoch_processing/single_pass.rs (the altair+ path below walks the
registry a constant number of times and batches per-validator flag reads,
which is also the columnar layout a future device epoch kernel consumes).
"""

from __future__ import annotations

from ..types import helpers as h
from ..types.spec import ChainSpec, ForkName, FAR_FUTURE_EPOCH
from . import accessors as acc
from . import mutators as mut


def process_epoch(state, spec: ChainSpec, types, fork: ForkName) -> None:
    from ..ssz.cow import CowList

    # The scalar spec loops below index per element millions of times at
    # validator scale, and a CowList element read costs ~3x a plain
    # list's — so the epoch runs over flat lists and diff-rebuilds the
    # chunked backing afterwards (CowList.rebuild_from: unchanged chunks
    # stay shared and clean, so post-epoch roots remain incremental over
    # whatever the epoch left untouched).
    cow_fields = {}
    for f in state.__class__.ssz_type.fields:
        v = getattr(state, f.name)
        if isinstance(v, CowList):
            cow_fields[f.name] = v
            setattr(state, f.name, v.to_list())
    try:
        if fork == ForkName.phase0:
            _process_epoch_phase0(state, spec, types)
        else:
            _process_epoch_altair(state, spec, types, fork)
    finally:
        for name, cow in cow_fields.items():
            v = getattr(state, name)
            if isinstance(v, list):
                setattr(state, name, cow.rebuild_from(v))


# ===================================================== altair+ path


def _process_epoch_altair(state, spec, types, fork):
    process_justification_and_finalization(state, spec, types, fork)
    process_inactivity_updates(state, spec)
    process_rewards_and_penalties_altair(state, spec, fork)
    if fork >= ForkName.electra:
        from . import electra as el

        el.process_registry_updates_electra(state, spec)
        el.process_slashings_electra(state, spec)
        process_eth1_data_reset(state, spec)
        el.process_pending_deposits(state, spec, types)
        el.process_pending_consolidations(state, spec)
        el.process_effective_balance_updates_electra(state, spec)
    else:
        process_registry_updates(state, spec)
        process_slashings(state, spec, fork)
        process_eth1_data_reset(state, spec)
        process_effective_balance_updates(state, spec)
    process_slashings_reset(state, spec)
    process_randao_mixes_reset(state, spec)
    if fork >= ForkName.capella:
        process_historical_summaries_update(state, spec, types)
    else:
        process_historical_roots_update(state, spec, types)
    process_participation_flag_updates(state)
    process_sync_committee_updates(state, spec, types)


def _weigh_justification_and_finalization(
    state, spec, types, total_active, previous_target, current_target
):
    previous_epoch = acc.get_previous_epoch(state, spec)
    current_epoch = acc.get_current_epoch(state, spec)
    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[:-1]
    if previous_target * 3 >= total_active * 2:
        state.current_justified_checkpoint = types.Checkpoint.make(
            epoch=previous_epoch, root=acc.get_block_root(state, spec, previous_epoch)
        )
        bits[1] = True
    if current_target * 3 >= total_active * 2:
        state.current_justified_checkpoint = types.Checkpoint.make(
            epoch=current_epoch, root=acc.get_block_root(state, spec, current_epoch)
        )
        bits[0] = True
    state.justification_bits = bits

    # finalization rules
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


def process_justification_and_finalization(state, spec, types, fork):
    if acc.get_current_epoch(state, spec) <= 1:
        return
    if fork == ForkName.phase0:
        prev_att = _matching_target_attestations(state, spec, acc.get_previous_epoch(state, spec))
        cur_att = _matching_target_attestations(state, spec, acc.get_current_epoch(state, spec))
        previous_target = _attesting_balance_phase0(state, spec, prev_att)
        current_target = _attesting_balance_phase0(state, spec, cur_att)
    else:
        previous_target = acc.get_total_balance(
            state,
            spec,
            acc.get_unslashed_participating_indices(
                state, spec, acc.TIMELY_TARGET_FLAG_INDEX, acc.get_previous_epoch(state, spec)
            ),
        )
        current_target = acc.get_total_balance(
            state,
            spec,
            acc.get_unslashed_participating_indices(
                state, spec, acc.TIMELY_TARGET_FLAG_INDEX, acc.get_current_epoch(state, spec)
            ),
        )
    total = acc.get_total_active_balance(state, spec)
    _weigh_justification_and_finalization(state, spec, types, total, previous_target, current_target)


def process_inactivity_updates(state, spec):
    if acc.get_current_epoch(state, spec) == 0:
        return
    participating = acc.get_unslashed_participating_indices(
        state, spec, acc.TIMELY_TARGET_FLAG_INDEX, acc.get_previous_epoch(state, spec)
    )
    leaking = acc.is_in_inactivity_leak(state, spec)
    for i in h.get_active_validator_indices(state, acc.get_previous_epoch(state, spec)):
        if i in participating:
            state.inactivity_scores[i] -= min(1, state.inactivity_scores[i])
        else:
            state.inactivity_scores[i] += spec.inactivity_score_bias
        if not leaking:
            state.inactivity_scores[i] -= min(
                spec.inactivity_score_recovery_rate, state.inactivity_scores[i]
            )


def _eligible_validator_indices(state, spec):
    prev = acc.get_previous_epoch(state, spec)
    active_prev = set(h.get_active_validator_indices(state, prev))
    return [
        i
        for i, v in enumerate(state.validators)
        if i in active_prev or (v.slashed and prev + 1 < v.withdrawable_epoch)
    ]


def get_flag_index_deltas(state, spec, flag_index: int, fork, eligible=None):
    """(rewards, penalties) for one participation flag — the altair pyspec
    shape, exposed so the EF `rewards` runner can compare per-flag deltas
    (lighthouse/testing/ef_tests/src/cases/rewards.rs analog).
    `eligible` lets the epoch transition share ONE registry scan across the
    four delta sets."""
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    if acc.get_current_epoch(state, spec) == 0:
        return rewards, penalties
    prev = acc.get_previous_epoch(state, spec)
    total_active = acc.get_total_active_balance(state, spec)
    base_per_incr = acc.get_base_reward_per_increment(state, spec)
    leaking = acc.is_in_inactivity_leak(state, spec)
    participating = acc.get_unslashed_participating_indices(
        state, spec, flag_index, prev
    )
    flag_balance = acc.get_total_balance(state, spec, participating)
    weight = acc.PARTICIPATION_FLAG_WEIGHTS[flag_index]
    incr = spec.effective_balance_increment
    if eligible is None:
        eligible = _eligible_validator_indices(state, spec)
    for i in eligible:
        eff = state.validators[i].effective_balance
        base_reward = (eff // incr) * base_per_incr
        if i in participating:
            if not leaking:
                reward_numerator = base_reward * weight * (flag_balance // incr)
                rewards[i] = reward_numerator // (
                    (total_active // incr) * acc.WEIGHT_DENOMINATOR
                )
        elif flag_index != acc.TIMELY_HEAD_FLAG_INDEX:
            penalties[i] = base_reward * weight // acc.WEIGHT_DENOMINATOR
    return rewards, penalties


def get_inactivity_penalty_deltas(state, spec, fork, eligible=None):
    """(rewards, penalties) from the inactivity leak (altair pyspec)."""
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    if acc.get_current_epoch(state, spec) == 0:
        return rewards, penalties
    prev = acc.get_previous_epoch(state, spec)
    participating = acc.get_unslashed_participating_indices(
        state, spec, acc.TIMELY_TARGET_FLAG_INDEX, prev
    )
    if fork == ForkName.altair:
        inactivity_quotient = spec.inactivity_penalty_quotient_altair
    else:
        inactivity_quotient = spec.inactivity_penalty_quotient_bellatrix
    if eligible is None:
        eligible = _eligible_validator_indices(state, spec)
    for i in eligible:
        if i not in participating:
            eff = state.validators[i].effective_balance
            penalty_numerator = eff * state.inactivity_scores[i]
            penalties[i] = penalty_numerator // (
                spec.inactivity_score_bias * inactivity_quotient
            )
    return rewards, penalties


def process_rewards_and_penalties_altair(state, spec, fork):
    if acc.get_current_epoch(state, spec) == 0:
        return
    # pyspec application order: each delta set is applied across the whole
    # registry before the next (matters only at the zero-balance clamp)
    eligible = _eligible_validator_indices(state, spec)
    # second accelerated workload (lighthouse_tpu_torch/torchhash): with
    # a device-backed hash backend and a large registry the four delta
    # sets compute as vectors (the epoch_deltas kernel, host-numpy
    # fallback) — bit-exact with the scalar loops, which the "host"
    # backend keeps
    from ..torchhash import epoch_vectors as _ev

    deltas = _ev.altair_deltas(state, spec, fork, eligible)
    if deltas is None:
        deltas = [
            get_flag_index_deltas(state, spec, f, fork, eligible=eligible)
            for f in range(len(acc.PARTICIPATION_FLAG_WEIGHTS))
        ]
        deltas.append(
            get_inactivity_penalty_deltas(state, spec, fork, eligible=eligible)
        )
    for rewards, penalties in deltas:
        for i in range(len(state.validators)):
            mut.increase_balance(state, i, rewards[i])
            mut.decrease_balance(state, i, penalties[i])


def process_registry_updates(state, spec):
    current_epoch = acc.get_current_epoch(state, spec)
    # eligibility + ejections
    for i, v in enumerate(state.validators):
        if h.is_eligible_for_activation_queue(v, spec):
            state.validators[i] = v.copy_with(
                activation_eligibility_epoch=current_epoch + 1
            )
        v = state.validators[i]
        if (
            h.is_active_validator(v, current_epoch)
            and v.effective_balance <= spec.ejection_balance
        ):
            mut.initiate_validator_exit(state, spec, i)

    # activation queue, FIFO by (eligibility epoch, index)
    queue = sorted(
        (
            i
            for i, v in enumerate(state.validators)
            if v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    active_count = len(h.get_active_validator_indices(state, current_epoch))
    limit = spec.activation_churn_limit(active_count)
    for i in queue[:limit]:
        v = state.validators[i]
        state.validators[i] = v.copy_with(
            activation_epoch=h.compute_activation_exit_epoch(current_epoch, spec)
        )


def process_slashings(state, spec, fork):
    epoch = acc.get_current_epoch(state, spec)
    total = acc.get_total_active_balance(state, spec)
    if fork == ForkName.phase0:
        mult = spec.proportional_slashing_multiplier
    elif fork == ForkName.altair:
        mult = spec.proportional_slashing_multiplier_altair
    else:
        mult = spec.proportional_slashing_multiplier_bellatrix
    adjusted = min(sum(state.slashings) * mult, total)
    increment = spec.effective_balance_increment
    for i, v in enumerate(state.validators):
        if (
            v.slashed
            and epoch + spec.preset.EPOCHS_PER_SLASHINGS_VECTOR // 2 == v.withdrawable_epoch
        ):
            penalty_numerator = (v.effective_balance // increment) * adjusted
            penalty = penalty_numerator // total * increment
            mut.decrease_balance(state, i, penalty)


def process_eth1_data_reset(state, spec):
    next_epoch = acc.get_current_epoch(state, spec) + 1
    if next_epoch % spec.preset.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, spec):
    # vectorized hysteresis scan at registry scale (torchhash epoch stage);
    # the copy_with writes below stay scalar either way — only CHANGED
    # validators are rewritten, preserving the memoized-root semantics
    from ..torchhash import epoch_vectors as _ev

    changes = _ev.effective_balance_updates(state, spec)
    if changes is not None:
        for i, new_eff in changes:
            state.validators[i] = state.validators[i].copy_with(
                effective_balance=new_eff
            )
        return
    hysteresis_increment = spec.effective_balance_increment // spec.hysteresis_quotient
    downward = hysteresis_increment * spec.hysteresis_downward_multiplier
    upward = hysteresis_increment * spec.hysteresis_upward_multiplier
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        if (
            balance + downward < v.effective_balance
            or v.effective_balance + upward < balance
        ):
            state.validators[i] = v.copy_with(
                effective_balance=min(
                    balance - balance % spec.effective_balance_increment,
                    spec.max_effective_balance,
                )
            )


def process_slashings_reset(state, spec):
    next_epoch = acc.get_current_epoch(state, spec) + 1
    state.slashings[next_epoch % spec.preset.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(state, spec):
    current = acc.get_current_epoch(state, spec)
    next_epoch = current + 1
    state.randao_mixes[next_epoch % spec.preset.EPOCHS_PER_HISTORICAL_VECTOR] = (
        h.get_randao_mix(state, spec, current)
    )


def process_historical_roots_update(state, spec, types):
    next_epoch = acc.get_current_epoch(state, spec) + 1
    per_batch = spec.preset.SLOTS_PER_HISTORICAL_ROOT // spec.preset.SLOTS_PER_EPOCH
    if next_epoch % per_batch == 0:
        batch = types.HistoricalBatch.make(
            block_roots=list(state.block_roots), state_roots=list(state.state_roots)
        )
        state.historical_roots.append(types.HistoricalBatch.hash_tree_root(batch))


def process_historical_summaries_update(state, spec, types):
    from ..ssz.core import Bytes32, Vector

    next_epoch = acc.get_current_epoch(state, spec) + 1
    per_batch = spec.preset.SLOTS_PER_HISTORICAL_ROOT // spec.preset.SLOTS_PER_EPOCH
    if next_epoch % per_batch == 0:
        vec = Vector(Bytes32, spec.preset.SLOTS_PER_HISTORICAL_ROOT)
        summary = types.HistoricalSummary.make(
            block_summary_root=vec.hash_tree_root(list(state.block_roots)),
            state_summary_root=vec.hash_tree_root(list(state.state_roots)),
        )
        state.historical_summaries.append(summary)


def process_participation_flag_updates(state):
    state.previous_epoch_participation = state.current_epoch_participation
    n = len(state.validators)
    prev = state.previous_epoch_participation
    from ..ssz.cow import CowList

    if isinstance(prev, CowList):
        # a CowList-backed state stays CowList-backed across the epoch
        # boundary; filled() shares one zero chunk across the spine, so
        # the reset is O(#chunks) instead of an O(n) allocation
        state.current_epoch_participation = CowList.filled(
            0, n, prev._chunk_elems, name=prev.name
        )
    else:
        state.current_epoch_participation = [0] * n


def process_sync_committee_updates(state, spec, types):
    next_epoch = acc.get_current_epoch(state, spec) + 1
    if next_epoch % spec.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state, spec, types)


def get_next_sync_committee(state, spec, types):
    from ..crypto import bls
    from ..crypto.bls381 import curve as cv

    indices = acc.get_next_sync_committee_indices(state, spec)
    pubkeys = [state.validators[i].pubkey for i in indices]
    # aggregate pubkey = sum of committee pubkeys
    agg = None
    for pk in pubkeys:
        pt = bls.PublicKey.deserialize(bytes(pk)).point
        agg = cv.g1_add(agg, pt)
    agg_bytes = bls.PublicKey(agg).serialize()
    return types.SyncCommittee.make(pubkeys=list(pubkeys), aggregate_pubkey=agg_bytes)


# ===================================================== phase0 path


def _matching_source_attestations(state, spec, epoch):
    if epoch == acc.get_current_epoch(state, spec):
        return list(state.current_epoch_attestations)
    return list(state.previous_epoch_attestations)


def _matching_target_attestations(state, spec, epoch):
    return [
        a
        for a in _matching_source_attestations(state, spec, epoch)
        if bytes(a.data.target.root) == acc.get_block_root(state, spec, epoch)
    ]


def _matching_head_attestations(state, spec, epoch):
    return [
        a
        for a in _matching_target_attestations(state, spec, epoch)
        if bytes(a.data.beacon_block_root)
        == acc.get_block_root_at_slot(state, spec, a.data.slot)
    ]


def _unslashed_attesting_indices(state, spec, attestations):
    out = set()
    cache = {}
    for a in attestations:
        out |= set(
            acc.get_attesting_indices(
                state, spec, a.data, a.aggregation_bits, cache.get(a.data.target.epoch)
            )
        )
    return {i for i in out if not state.validators[i].slashed}


def _attesting_balance_phase0(state, spec, attestations):
    return acc.get_total_balance(
        state, spec, _unslashed_attesting_indices(state, spec, attestations)
    )


def _process_epoch_phase0(state, spec, types):
    process_justification_and_finalization(state, spec, types, ForkName.phase0)
    _process_rewards_and_penalties_phase0(state, spec, types)
    process_registry_updates(state, spec)
    process_slashings(state, spec, ForkName.phase0)
    process_eth1_data_reset(state, spec)
    process_effective_balance_updates(state, spec)
    process_slashings_reset(state, spec)
    process_randao_mixes_reset(state, spec)
    process_historical_roots_update(state, spec, types)
    # participation record rotation
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


def _process_rewards_and_penalties_phase0(state, spec, types):
    if acc.get_current_epoch(state, spec) == 0:
        return
    rewards, penalties = _attestation_deltas_phase0(state, spec)
    for i in range(len(state.validators)):
        mut.increase_balance(state, i, rewards[i])
        mut.decrease_balance(state, i, penalties[i])


def _attestation_deltas_phase0(state, spec):
    prev_epoch = acc.get_previous_epoch(state, spec)
    total_balance = acc.get_total_active_balance(state, spec)
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n

    eligible = [
        i
        for i, v in enumerate(state.validators)
        if h.is_active_validator(v, prev_epoch)
        or (v.slashed and prev_epoch + 1 < v.withdrawable_epoch)
    ]

    matching_source = _matching_source_attestations(state, spec, prev_epoch)
    matching_target = _matching_target_attestations(state, spec, prev_epoch)
    matching_head = _matching_head_attestations(state, spec, prev_epoch)

    src_idx = _unslashed_attesting_indices(state, spec, matching_source)
    tgt_idx = _unslashed_attesting_indices(state, spec, matching_target)
    head_idx = _unslashed_attesting_indices(state, spec, matching_head)

    increment = spec.effective_balance_increment
    total_incr = total_balance // increment
    leaking = acc.is_in_inactivity_leak(state, spec)

    def base_reward(i):
        eff = state.validators[i].effective_balance
        return eff * spec.base_reward_factor // acc._integer_squareroot(total_balance) // 4

    def proposer_reward(i):
        return base_reward(i) // spec.proposer_reward_quotient

    for attesting, att_set in (
        (src_idx, matching_source),
        (tgt_idx, matching_target),
        (head_idx, matching_head),
    ):
        att_balance = acc.get_total_balance(state, spec, attesting)
        att_incr = att_balance // increment
        for i in eligible:
            if i in attesting:
                if leaking:
                    rewards[i] += base_reward(i)
                else:
                    rewards[i] += base_reward(i) * att_incr // total_incr
            else:
                penalties[i] += base_reward(i)

    # proposer + inclusion delay micro-rewards
    for i in src_idx:
        candidates = [
            a
            for a in matching_source
            if i
            in acc.get_attesting_indices(state, spec, a.data, a.aggregation_bits, None)
        ]
        attestation = min(candidates, key=lambda a: a.inclusion_delay)
        rewards[attestation.proposer_index] += proposer_reward(i)
        max_attester_reward = base_reward(i) - proposer_reward(i)
        rewards[i] += max_attester_reward // attestation.inclusion_delay

    if leaking:
        for i in eligible:
            # spec get_inactivity_penalty_deltas: BASE_REWARDS_PER_EPOCH *
            # base_reward - proposer_reward (the proposer share is not burned)
            penalties[i] += base_reward(i) * 4 - proposer_reward(i)
            if i not in tgt_idx:
                eff = state.validators[i].effective_balance
                penalties[i] += (
                    eff * acc.get_finality_delay(state, spec) // spec.inactivity_penalty_quotient
                )
    return rewards, penalties
