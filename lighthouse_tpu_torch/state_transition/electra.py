"""Electra (EIP-6110/7002/7251/7549) state-transition operations.

Parity surface: the electra arms of
lighthouse/consensus/state_processing/src/per_block_processing.rs
(process_deposit_requests, process_withdrawal_requests,
process_consolidation_requests), per_epoch_processing/single_pass.rs
(pending deposits/consolidations), and
lighthouse/consensus/state_processing/src/upgrade/electra.rs:1.

Balance-denominated churn replaces validator-count churn: exits and
consolidations consume Gwei from per-epoch churn budgets tracked directly on
the state (earliest_exit_epoch/exit_balance_to_consume and the
consolidation twins).
"""

from __future__ import annotations

from ..types import helpers as h
from ..types.spec import (
    ChainSpec,
    FAR_FUTURE_EPOCH,
    FULL_EXIT_REQUEST_AMOUNT,
    GENESIS_SLOT,
    UNSET_DEPOSIT_REQUESTS_START_INDEX,
)
from . import accessors as acc
from . import mutators as mut


# ------------------------------------------------------------ churn helpers


def get_balance_churn_limit(state, spec: ChainSpec) -> int:
    churn = max(
        spec.min_per_epoch_churn_limit_electra,
        acc.get_total_active_balance(state, spec) // spec.churn_limit_quotient,
    )
    return churn - churn % spec.effective_balance_increment


def get_activation_exit_churn_limit(state, spec: ChainSpec) -> int:
    return min(
        spec.max_per_epoch_activation_exit_churn_limit,
        get_balance_churn_limit(state, spec),
    )


def get_consolidation_churn_limit(state, spec: ChainSpec) -> int:
    return get_balance_churn_limit(state, spec) - get_activation_exit_churn_limit(
        state, spec
    )


def compute_exit_epoch_and_update_churn(state, spec: ChainSpec, exit_balance: int) -> int:
    earliest_exit_epoch = max(
        state.earliest_exit_epoch,
        h.compute_activation_exit_epoch(acc.get_current_epoch(state, spec), spec),
    )
    per_epoch_churn = get_activation_exit_churn_limit(state, spec)
    if state.earliest_exit_epoch < earliest_exit_epoch:
        exit_balance_to_consume = per_epoch_churn
    else:
        exit_balance_to_consume = state.exit_balance_to_consume
    if exit_balance > exit_balance_to_consume:
        balance_to_process = exit_balance - exit_balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest_exit_epoch += additional_epochs
        exit_balance_to_consume += additional_epochs * per_epoch_churn
    state.exit_balance_to_consume = exit_balance_to_consume - exit_balance
    state.earliest_exit_epoch = earliest_exit_epoch
    return state.earliest_exit_epoch


def compute_consolidation_epoch_and_update_churn(
    state, spec: ChainSpec, consolidation_balance: int
) -> int:
    earliest = max(
        state.earliest_consolidation_epoch,
        h.compute_activation_exit_epoch(acc.get_current_epoch(state, spec), spec),
    )
    per_epoch_churn = get_consolidation_churn_limit(state, spec)
    if state.earliest_consolidation_epoch < earliest:
        balance_to_consume = per_epoch_churn
    else:
        balance_to_consume = state.consolidation_balance_to_consume
    if consolidation_balance > balance_to_consume:
        balance_to_process = consolidation_balance - balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest += additional_epochs
        balance_to_consume += additional_epochs * per_epoch_churn
    state.consolidation_balance_to_consume = balance_to_consume - consolidation_balance
    state.earliest_consolidation_epoch = earliest
    return state.earliest_consolidation_epoch


def get_pending_balance_to_withdraw(state, validator_index: int) -> int:
    return sum(
        w.amount
        for w in state.pending_partial_withdrawals
        if w.validator_index == validator_index
    )


# ------------------------------------------------------------ validator mutators


def switch_to_compounding_validator(state, spec: ChainSpec, index: int) -> None:
    v = state.validators[index]
    wc = bytes(v.withdrawal_credentials)
    state.validators[index] = v.copy_with(
        withdrawal_credentials=b"\x02" + wc[1:]
    )
    queue_excess_active_balance(state, spec, index)


def queue_excess_active_balance(state, spec: ChainSpec, index: int) -> None:
    from ..types.spec import G2_POINT_AT_INFINITY

    balance = state.balances[index]
    if balance > spec.min_activation_balance:
        excess = balance - spec.min_activation_balance
        state.balances[index] = spec.min_activation_balance
        v = state.validators[index]
        # the excess is queued as an already-validated deposit (GENESIS_SLOT
        # marks bridge-validated entries)
        types = _types_for_state(state, spec)
        state.pending_deposits.append(
            types.PendingDeposit.make(
                pubkey=v.pubkey,
                withdrawal_credentials=v.withdrawal_credentials,
                amount=excess,
                signature=G2_POINT_AT_INFINITY,
                slot=GENESIS_SLOT,
            )
        )


def _types_for_state(state, spec: ChainSpec):
    from ..types.containers import spec_types

    return spec_types(spec.preset, spec.fork_name_at_slot(state.slot))


# ------------------------------------------------------------ execution requests


def process_deposit_request(state, spec: ChainSpec, types, request) -> None:
    """EIP-6110: EL-sourced deposits enter the pending queue directly."""
    if state.deposit_requests_start_index == UNSET_DEPOSIT_REQUESTS_START_INDEX:
        state.deposit_requests_start_index = request.index
    state.pending_deposits.append(
        types.PendingDeposit.make(
            pubkey=request.pubkey,
            withdrawal_credentials=request.withdrawal_credentials,
            amount=request.amount,
            signature=request.signature,
            slot=state.slot,
        )
    )


def process_withdrawal_request(state, spec: ChainSpec, types, request) -> None:
    """EIP-7002: execution-layer-triggered exits and partial withdrawals.
    Invalid requests are dropped, never block-invalidating."""
    amount = request.amount
    is_full_exit = amount == FULL_EXIT_REQUEST_AMOUNT
    if (
        len(state.pending_partial_withdrawals)
        == spec.preset.PENDING_PARTIAL_WITHDRAWALS_LIMIT
        and not is_full_exit
    ):
        return

    index = _pubkey_index(state, bytes(request.validator_pubkey))
    if index is None:
        return
    v = state.validators[index]
    if not h.has_execution_withdrawal_credential(v):
        return
    if bytes(v.withdrawal_credentials)[12:] != bytes(request.source_address):
        return
    epoch = acc.get_current_epoch(state, spec)
    if not h.is_active_validator(v, epoch):
        return
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if epoch < v.activation_epoch + spec.shard_committee_period:
        return

    pending = get_pending_balance_to_withdraw(state, index)
    if is_full_exit:
        if pending == 0:
            mut.initiate_validator_exit(state, spec, index)
        return

    has_sufficient_eff = v.effective_balance >= spec.min_activation_balance
    has_excess = state.balances[index] > spec.min_activation_balance + pending
    if h.has_compounding_withdrawal_credential(v) and has_sufficient_eff and has_excess:
        to_withdraw = min(
            state.balances[index] - spec.min_activation_balance - pending, amount
        )
        exit_queue_epoch = compute_exit_epoch_and_update_churn(state, spec, to_withdraw)
        withdrawable_epoch = exit_queue_epoch + spec.min_validator_withdrawability_delay
        state.pending_partial_withdrawals.append(
            types.PendingPartialWithdrawal.make(
                validator_index=index,
                amount=to_withdraw,
                withdrawable_epoch=withdrawable_epoch,
            )
        )


def _pubkey_index(state, pubkey: bytes):
    """pubkey -> validator index via a per-state lazy map.

    The naive registry scan made every withdrawal/consolidation request and
    pending deposit O(n) — O(n*m) per block at mainnet scale. The map is
    built once per state instance and extended incrementally as the
    registry grows (the validator_pubkey_cache.rs idea applied at the
    state-transition layer; pubkeys are append-only and never change)."""
    cache = getattr(state, "_pubkey_idx", None)
    n = len(state.validators)
    if cache is None:
        cache = [{}, 0]
        object.__setattr__(state, "_pubkey_idx", cache)
    idx_map, built = cache
    if built < n:
        for i in range(built, n):
            idx_map[bytes(state.validators[i].pubkey)] = i
        cache[1] = n
    return idx_map.get(pubkey)


def _is_valid_switch_to_compounding_request(state, spec: ChainSpec, request) -> bool:
    if bytes(request.source_pubkey) != bytes(request.target_pubkey):
        return False
    index = _pubkey_index(state, bytes(request.source_pubkey))
    if index is None:
        return False
    v = state.validators[index]
    if bytes(v.withdrawal_credentials)[12:] != bytes(request.source_address):
        return False
    if not h.has_eth1_withdrawal_credential(v):
        return False
    if not h.is_active_validator(v, acc.get_current_epoch(state, spec)):
        return False
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return False
    return True


def process_consolidation_request(state, spec: ChainSpec, types, request) -> None:
    """EIP-7251: merge a source validator's balance into a compounding
    target, or switch a validator to compounding credentials."""
    if _is_valid_switch_to_compounding_request(state, spec, request):
        index = _pubkey_index(state, bytes(request.source_pubkey))
        switch_to_compounding_validator(state, spec, index)
        return

    if bytes(request.source_pubkey) == bytes(request.target_pubkey):
        return
    if len(state.pending_consolidations) == spec.preset.PENDING_CONSOLIDATIONS_LIMIT:
        return
    if get_consolidation_churn_limit(state, spec) <= spec.min_activation_balance:
        return

    source_index = _pubkey_index(state, bytes(request.source_pubkey))
    target_index = _pubkey_index(state, bytes(request.target_pubkey))
    if source_index is None or target_index is None:
        return
    source = state.validators[source_index]
    target = state.validators[target_index]

    if bytes(source.withdrawal_credentials)[12:] != bytes(request.source_address):
        return
    if not h.has_execution_withdrawal_credential(source):
        return
    if not h.has_compounding_withdrawal_credential(target):
        return
    epoch = acc.get_current_epoch(state, spec)
    if not h.is_active_validator(source, epoch) or not h.is_active_validator(target, epoch):
        return
    if source.exit_epoch != FAR_FUTURE_EPOCH or target.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if get_pending_balance_to_withdraw(state, source_index) > 0:
        return

    exit_epoch = compute_consolidation_epoch_and_update_churn(
        state, spec, source.effective_balance
    )
    state.validators[source_index] = source.copy_with(
        exit_epoch=exit_epoch,
        withdrawable_epoch=exit_epoch + spec.min_validator_withdrawability_delay,
    )
    state.pending_consolidations.append(
        types.PendingConsolidation.make(
            source_index=source_index, target_index=target_index
        )
    )


# ------------------------------------------------------------ epoch processing


def process_pending_deposits(state, spec: ChainSpec, types) -> None:
    """Apply queued deposits up to the activation-exit churn, carrying unused
    budget in deposit_balance_to_consume only when the limit is hit."""
    next_epoch = acc.get_current_epoch(state, spec) + 1
    available = state.deposit_balance_to_consume + get_activation_exit_churn_limit(
        state, spec
    )
    processed_amount = 0
    next_deposit_index = 0
    deposits_to_postpone = []
    is_churn_limit_reached = False
    finalized_slot = h.compute_start_slot_at_epoch(
        state.finalized_checkpoint.epoch, spec
    )

    for deposit in state.pending_deposits:
        # EL deposit requests only apply once the eth1 bridge queue is drained
        if (
            deposit.slot > GENESIS_SLOT
            and state.eth1_deposit_index < state.deposit_requests_start_index
        ):
            break
        if deposit.slot > finalized_slot:
            break
        if next_deposit_index >= spec.preset.MAX_PENDING_DEPOSITS_PER_EPOCH:
            break

        index = _pubkey_index(state, bytes(deposit.pubkey))
        is_exited = False
        is_withdrawn = False
        if index is not None:
            v = state.validators[index]
            is_exited = v.exit_epoch < FAR_FUTURE_EPOCH
            is_withdrawn = v.withdrawable_epoch < next_epoch

        if is_withdrawn:
            # balance can never activate: credit without consuming churn
            _apply_pending_deposit(state, spec, types, deposit)
        elif is_exited:
            deposits_to_postpone.append(deposit)
        else:
            is_churn_limit_reached = processed_amount + deposit.amount > available
            if is_churn_limit_reached:
                break
            processed_amount += deposit.amount
            _apply_pending_deposit(state, spec, types, deposit)
        next_deposit_index += 1

    state.pending_deposits = (
        list(state.pending_deposits[next_deposit_index:]) + deposits_to_postpone
    )
    if is_churn_limit_reached:
        state.deposit_balance_to_consume = available - processed_amount
    else:
        state.deposit_balance_to_consume = 0


def _apply_pending_deposit(state, spec: ChainSpec, types, deposit) -> None:
    from .block import add_validator_to_registry, is_valid_deposit_signature

    index = _pubkey_index(state, bytes(deposit.pubkey))
    if index is None:
        if is_valid_deposit_signature(
            spec,
            types,
            deposit.pubkey,
            deposit.withdrawal_credentials,
            deposit.amount,
            deposit.signature,
        ):
            add_validator_to_registry(
                state,
                spec,
                types,
                deposit.pubkey,
                deposit.withdrawal_credentials,
                deposit.amount,
            )
    else:
        mut.increase_balance(state, index, deposit.amount)


def process_pending_consolidations(state, spec: ChainSpec) -> None:
    next_epoch = acc.get_current_epoch(state, spec) + 1
    done = 0
    for pending in state.pending_consolidations:
        source = state.validators[pending.source_index]
        if source.slashed:
            done += 1
            continue
        if source.withdrawable_epoch > next_epoch:
            break
        amount = min(state.balances[pending.source_index], source.effective_balance)
        mut.decrease_balance(state, pending.source_index, amount)
        mut.increase_balance(state, pending.target_index, amount)
        done += 1
    state.pending_consolidations = list(state.pending_consolidations[done:])


def process_registry_updates_electra(state, spec: ChainSpec) -> None:
    """Electra registry updates: activations are no longer churn-limited
    (the pending-deposit queue already is); eligibility requires
    MIN_ACTIVATION_BALANCE."""
    current_epoch = acc.get_current_epoch(state, spec)
    activation_epoch = h.compute_activation_exit_epoch(current_epoch, spec)
    for i, v in enumerate(state.validators):
        if h.is_eligible_for_activation_queue(v, spec, electra=True):
            state.validators[i] = v.copy_with(
                activation_eligibility_epoch=current_epoch + 1
            )
        elif (
            h.is_active_validator(v, current_epoch)
            and v.effective_balance <= spec.ejection_balance
        ):
            mut.initiate_validator_exit(state, spec, i)
        elif (
            v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
            and v.activation_epoch == FAR_FUTURE_EPOCH
        ):
            state.validators[i] = v.copy_with(activation_epoch=activation_epoch)


def process_slashings_electra(state, spec: ChainSpec) -> None:
    epoch = acc.get_current_epoch(state, spec)
    total = acc.get_total_active_balance(state, spec)
    adjusted = min(
        sum(state.slashings) * spec.proportional_slashing_multiplier_bellatrix, total
    )
    increment = spec.effective_balance_increment
    penalty_per_increment = adjusted // (total // increment)
    for i, v in enumerate(state.validators):
        if (
            v.slashed
            and epoch + spec.preset.EPOCHS_PER_SLASHINGS_VECTOR // 2
            == v.withdrawable_epoch
        ):
            penalty = penalty_per_increment * (v.effective_balance // increment)
            mut.decrease_balance(state, i, penalty)


def process_effective_balance_updates_electra(state, spec: ChainSpec) -> None:
    hysteresis_increment = spec.effective_balance_increment // spec.hysteresis_quotient
    downward = hysteresis_increment * spec.hysteresis_downward_multiplier
    upward = hysteresis_increment * spec.hysteresis_upward_multiplier
    for i, v in enumerate(state.validators):
        balance = state.balances[i]
        max_eff = h.get_max_effective_balance(v, spec)
        if balance + downward < v.effective_balance or v.effective_balance + upward < balance:
            state.validators[i] = v.copy_with(
                effective_balance=min(
                    balance - balance % spec.effective_balance_increment, max_eff
                )
            )
