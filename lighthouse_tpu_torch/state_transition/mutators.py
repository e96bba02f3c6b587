"""Beacon-state mutators (spec mutator functions).

Parity: the mutator half of lighthouse/consensus/state_processing
(initiate_validator_exit, slash_validator, balance updates). States here are
mutable dataclass instances; callers own copying (the replayer and harness
clone via SSZ roundtrip or copy_with)."""

from __future__ import annotations

from ..types import helpers as h
from ..types.spec import ChainSpec, ForkName, FAR_FUTURE_EPOCH
from . import accessors as acc


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)


def initiate_validator_exit(state, spec: ChainSpec, index: int) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if hasattr(state, "earliest_exit_epoch"):
        # electra: balance-denominated churn (EIP-7251)
        from .electra import compute_exit_epoch_and_update_churn

        exit_queue_epoch = compute_exit_epoch_and_update_churn(
            state, spec, v.effective_balance
        )
        state.validators[index] = v.copy_with(
            exit_epoch=exit_queue_epoch,
            withdrawable_epoch=exit_queue_epoch
            + spec.min_validator_withdrawability_delay,
        )
        return
    exit_epochs = [
        w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_queue_epoch = max(
        exit_epochs
        + [h.compute_activation_exit_epoch(acc.get_current_epoch(state, spec), spec)]
    )
    exit_queue_churn = sum(
        1 for w in state.validators if w.exit_epoch == exit_queue_epoch
    )
    active = len(h.get_active_validator_indices(state, acc.get_current_epoch(state, spec)))
    if exit_queue_churn >= spec.churn_limit(active):
        exit_queue_epoch += 1
    state.validators[index] = v.copy_with(
        exit_epoch=exit_queue_epoch,
        withdrawable_epoch=exit_queue_epoch + spec.min_validator_withdrawability_delay,
    )


def slash_validator(
    state, spec: ChainSpec, fork: ForkName, slashed_index: int, whistleblower_index=None
) -> None:
    epoch = acc.get_current_epoch(state, spec)
    initiate_validator_exit(state, spec, slashed_index)
    v = state.validators[slashed_index]
    state.validators[slashed_index] = v.copy_with(
        slashed=True,
        withdrawable_epoch=max(
            v.withdrawable_epoch, epoch + spec.preset.EPOCHS_PER_SLASHINGS_VECTOR
        ),
    )
    v = state.validators[slashed_index]
    state.slashings[epoch % spec.preset.EPOCHS_PER_SLASHINGS_VECTOR] += v.effective_balance

    if fork == ForkName.phase0:
        min_quotient = spec.min_slashing_penalty_quotient
    elif fork == ForkName.altair:
        min_quotient = spec.min_slashing_penalty_quotient_altair
    elif fork >= ForkName.electra:
        min_quotient = spec.min_slashing_penalty_quotient_electra
    else:
        min_quotient = spec.min_slashing_penalty_quotient_bellatrix
    decrease_balance(state, slashed_index, v.effective_balance // min_quotient)

    proposer_index = acc.get_beacon_proposer_index(state, spec)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    if fork >= ForkName.electra:
        whistleblower_reward = (
            v.effective_balance // spec.whistleblower_reward_quotient_electra
        )
    else:
        whistleblower_reward = v.effective_balance // spec.whistleblower_reward_quotient
    if fork == ForkName.phase0:
        proposer_reward = whistleblower_reward // spec.proposer_reward_quotient
    else:
        proposer_reward = (
            whistleblower_reward * acc.PROPOSER_WEIGHT // acc.WEIGHT_DENOMINATOR
        )
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)
