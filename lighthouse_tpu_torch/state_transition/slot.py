"""per_slot_processing, fork upgrades, and the top-level state transition.

Parity surface: lighthouse/consensus/state_processing/src/
per_slot_processing.rs and upgrade/*.rs. `state_transition` is the spec
entry: advance slots (running epoch processing + fork upgrades at
boundaries), then apply the block.
"""

from __future__ import annotations

from ..types import helpers as h
from ..types.spec import ChainSpec, ForkName
from ..types.containers import spec_types
from . import accessors as acc
from .block import BlockProcessingError, SignatureStrategy, per_block_processing
from .epoch import get_next_sync_committee, process_epoch


def types_for_slot(spec: ChainSpec, slot: int):
    return spec_types(spec.preset, spec.fork_name_at_slot(slot))


def process_slot(state, spec: ChainSpec) -> None:
    """Cache state/block roots for the CURRENT slot before advancing."""
    types = types_for_slot(spec, state.slot)
    p = spec.preset
    prev_state_root = types.BeaconState.hash_tree_root(state)
    state.state_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = prev_state_root
    if bytes(state.latest_block_header.state_root) == b"\x00" * 32:
        state.latest_block_header = state.latest_block_header.copy_with(
            state_root=prev_state_root
        )
    block_root = types.BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = block_root


def per_slot_processing(state, spec: ChainSpec) -> None:
    """Advance the state by exactly one slot (epoch processing + upgrade at
    boundaries)."""
    process_slot(state, spec)
    next_slot = state.slot + 1
    if next_slot % spec.preset.SLOTS_PER_EPOCH == 0:
        fork = spec.fork_name_at_slot(state.slot)
        process_epoch(state, spec, spec_types(spec.preset, fork), fork)
    state.slot = next_slot
    # fork upgrade at the first slot of the new fork's activation epoch
    old_fork = spec.fork_name_at_slot(state.slot - 1)
    new_fork = spec.fork_name_at_slot(state.slot)
    if new_fork != old_fork:
        upgrade_state(state, spec, old_fork, new_fork)


def process_slots(state, spec: ChainSpec, target_slot: int) -> None:
    if target_slot < state.slot:
        raise ValueError("cannot rewind state")
    while state.slot < target_slot:
        per_slot_processing(state, spec)


def state_transition(
    state,
    signed_block,
    spec: ChainSpec,
    strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK,
    get_pubkey=None,
    verify_state_root: bool = True,
):
    """Full spec state transition: advance to the block's slot, apply it,
    optionally check the advertised state root."""
    block = signed_block.message
    process_slots(state, spec, block.slot)
    types = types_for_slot(spec, block.slot)
    per_block_processing(
        state, signed_block, spec, types, strategy=strategy, get_pubkey=get_pubkey
    )
    if verify_state_root:
        actual = types.BeaconState.hash_tree_root(state)
        if bytes(block.state_root) != actual:
            raise BlockProcessingError("state root mismatch")
    return state


# ------------------------------------------------------------ upgrades


def upgrade_state(state, spec: ChainSpec, old_fork: ForkName, new_fork: ForkName):
    """In-place container migration at a fork boundary
    (upgrade/altair.rs … upgrade/electra.rs analog)."""
    order = [
        ForkName.phase0,
        ForkName.altair,
        ForkName.bellatrix,
        ForkName.capella,
        ForkName.deneb,
        ForkName.electra,
    ]
    path = order[order.index(old_fork) + 1 : order.index(new_fork) + 1]
    for fork in path:
        _UPGRADES[fork](state, spec)


def _upgrade_to_altair(state, spec):
    types = spec_types(spec.preset, ForkName.altair)
    epoch = acc.get_current_epoch(state, spec)
    new_state = types.BeaconState.make(
        **{
            f.name: getattr(state, f.name)
            for f in types.BeaconState.fields
            if hasattr(state, f.name)
            and f.name
            not in (
                "fork",
                "previous_epoch_participation",
                "current_epoch_participation",
                "inactivity_scores",
                "current_sync_committee",
                "next_sync_committee",
            )
        },
        fork=types.Fork.make(
            previous_version=state.fork.current_version,
            current_version=spec.altair_fork_version,
            epoch=epoch,
        ),
        previous_epoch_participation=[0] * len(state.validators),
        current_epoch_participation=[0] * len(state.validators),
        inactivity_scores=[0] * len(state.validators),
    )
    sync = get_next_sync_committee(new_state, spec, types)
    new_state.current_sync_committee = sync
    new_state.next_sync_committee = get_next_sync_committee(new_state, spec, types)
    _replace_in_place(state, new_state)


def _carry_fields(state, types, fork_version, spec, extra: dict):
    epoch = acc.get_current_epoch(state, spec)
    fields = {}
    for f in types.BeaconState.fields:
        if f.name == "fork":
            fields["fork"] = types.Fork.make(
                previous_version=state.fork.current_version,
                current_version=fork_version,
                epoch=epoch,
            )
        elif f.name in extra:
            fields[f.name] = extra[f.name]
        elif hasattr(state, f.name):
            fields[f.name] = getattr(state, f.name)
        else:
            fields[f.name] = f.type.default()
    return types.BeaconState.make(**fields)


def _upgrade_to_bellatrix(state, spec):
    types = spec_types(spec.preset, ForkName.bellatrix)
    new_state = _carry_fields(state, types, spec.bellatrix_fork_version, spec, {})
    _replace_in_place(state, new_state)


def _upgrade_to_capella(state, spec):
    types = spec_types(spec.preset, ForkName.capella)
    # the payload header gains withdrawals_root (default zero-root container)
    old_header = state.latest_execution_payload_header
    hdr_fields = {
        f.name: getattr(old_header, f.name, f.type.default())
        for f in types.ExecutionPayloadHeader.fields
    }
    new_state = _carry_fields(
        state,
        types,
        spec.capella_fork_version,
        spec,
        {
            "latest_execution_payload_header": types.ExecutionPayloadHeader.make(**hdr_fields),
            "next_withdrawal_index": 0,
            "next_withdrawal_validator_index": 0,
            "historical_summaries": [],
        },
    )
    _replace_in_place(state, new_state)


def _upgrade_to_deneb(state, spec):
    types = spec_types(spec.preset, ForkName.deneb)
    old_header = state.latest_execution_payload_header
    hdr_fields = {
        f.name: getattr(old_header, f.name, f.type.default())
        for f in types.ExecutionPayloadHeader.fields
    }
    new_state = _carry_fields(
        state,
        types,
        spec.deneb_fork_version,
        spec,
        {"latest_execution_payload_header": types.ExecutionPayloadHeader.make(**hdr_fields)},
    )
    _replace_in_place(state, new_state)


def _upgrade_to_electra(state, spec):
    """Real electra upgrade (upgrade/electra.rs analog): balance-churn fields
    seeded from the current registry, pre-activation validators re-queued
    through pending_deposits, compounding early-adopters' excess queued."""
    from ..types.spec import (
        FAR_FUTURE_EPOCH,
        GENESIS_SLOT,
        G2_POINT_AT_INFINITY,
        UNSET_DEPOSIT_REQUESTS_START_INDEX,
    )
    from ..types import helpers as h
    from . import electra as el

    types = spec_types(spec.preset, ForkName.electra)
    current_epoch = acc.get_current_epoch(state, spec)

    # spec: max over exit epochs (default current_epoch), +1 unconditionally
    earliest_exit_epoch = (
        max(
            (v.exit_epoch for v in state.validators if v.exit_epoch != FAR_FUTURE_EPOCH),
            default=current_epoch,
        )
        + 1
    )

    old_header = state.latest_execution_payload_header
    hdr_fields = {
        f.name: getattr(old_header, f.name, f.type.default())
        for f in types.ExecutionPayloadHeader.fields
    }
    new_state = _carry_fields(
        state,
        types,
        spec.electra_fork_version,
        spec,
        {
            "latest_execution_payload_header": types.ExecutionPayloadHeader.make(**hdr_fields),
            "deposit_requests_start_index": UNSET_DEPOSIT_REQUESTS_START_INDEX,
            "deposit_balance_to_consume": 0,
            "exit_balance_to_consume": 0,
            "earliest_exit_epoch": earliest_exit_epoch,
            "consolidation_balance_to_consume": 0,
            "earliest_consolidation_epoch": h.compute_activation_exit_epoch(
                current_epoch, spec
            ),
            "pending_deposits": [],
            "pending_partial_withdrawals": [],
            "pending_consolidations": [],
        },
    )
    new_state.exit_balance_to_consume = el.get_activation_exit_churn_limit(
        new_state, spec
    )
    new_state.consolidation_balance_to_consume = el.get_consolidation_churn_limit(
        new_state, spec
    )

    # re-queue validators that never became eligible through the new
    # pending-deposit churn, FIFO by (eligibility epoch, index)
    pre_activation = sorted(
        (
            i
            for i, v in enumerate(new_state.validators)
            if v.activation_epoch == FAR_FUTURE_EPOCH
        ),
        key=lambda i: (new_state.validators[i].activation_eligibility_epoch, i),
    )
    for index in pre_activation:
        balance = new_state.balances[index]
        new_state.balances[index] = 0
        v = new_state.validators[index]
        new_state.validators[index] = v.copy_with(
            effective_balance=0, activation_eligibility_epoch=FAR_FUTURE_EPOCH
        )
        new_state.pending_deposits.append(
            types.PendingDeposit.make(
                pubkey=v.pubkey,
                withdrawal_credentials=v.withdrawal_credentials,
                amount=balance,
                signature=G2_POINT_AT_INFINITY,
                slot=GENESIS_SLOT,
            )
        )

    # compounding early adopters go through the queue for their excess
    for index, v in enumerate(new_state.validators):
        if h.has_compounding_withdrawal_credential(v):
            el.queue_excess_active_balance(new_state, spec, index)

    _replace_in_place(state, new_state)


_UPGRADES = {
    ForkName.altair: _upgrade_to_altair,
    ForkName.bellatrix: _upgrade_to_bellatrix,
    ForkName.capella: _upgrade_to_capella,
    ForkName.deneb: _upgrade_to_deneb,
    ForkName.electra: _upgrade_to_electra,
}


def _replace_in_place(state, new_state):
    """Swap all fields of `state` for `new_state`'s (the caller's reference
    keeps working across the container-class change)."""
    state.__class__ = new_state.__class__
    state.__dict__.clear()
    state.__dict__.update(new_state.__dict__)
