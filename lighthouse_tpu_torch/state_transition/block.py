"""per_block_processing — spec block state transition.

Parity surface: lighthouse/consensus/state_processing/src/
per_block_processing.rs:100 with BlockSignatureStrategy (:54-63):
  NO_VERIFICATION   — signatures assumed valid (already batch-verified)
  VERIFY_INDIVIDUAL — verify each set as it is built
  VERIFY_RANDAO     — only the randao reveal
  VERIFY_BULK       — accumulate every set and verify ONE batch at the end
                      (BlockSignatureVerifier::verify_entire_block :128-139)
VERIFY_BULK is the default: one block's sets (131 for a full mainnet block)
become a single batch verify on the card under the "torch" BLS backend.

Forks: phase0 pending-attestation path and altair+ participation-flag path,
bellatrix execution payload (consistency checks; EL interaction lives in
chain/execution_layer), capella withdrawals + BLS changes, deneb blob commit
limits and EIP-7044 exit domains (signature_sets.py).
"""

from __future__ import annotations

from enum import Enum

from ..crypto import bls
from ..types import helpers as h
from ..types.spec import ChainSpec, ForkName, FAR_FUTURE_EPOCH
from . import accessors as acc
from . import mutators as mut
from . import signature_sets as sigs


class BlockProcessingError(Exception):
    pass


class SignatureStrategy(Enum):
    NO_VERIFICATION = "no_verification"
    VERIFY_INDIVIDUAL = "verify_individual"
    VERIFY_RANDAO = "verify_randao"
    VERIFY_BULK = "verify_bulk"


class SignatureBatch:
    """Accumulates SignatureSets, then one backend batch verify — the
    ParallelSignatureSets analog (block_signature_verifier.rs:88)."""

    def __init__(self):
        self.sets: list[bls.SignatureSet] = []

    def add(self, s):
        if s is None:
            return
        if isinstance(s, list):
            self.sets.extend(x for x in s if x is not None)
        else:
            self.sets.append(s)

    def verify(self) -> bool:
        if not self.sets:
            return True
        return bls.verify_signature_sets(self.sets)


def _default_pubkey_getter(state):
    cache: dict[int, bls.PublicKey] = {}

    def get_pubkey(index: int) -> bls.PublicKey:
        if index not in cache:
            cache[index] = bls.PublicKey.deserialize(bytes(state.validators[index].pubkey))
        return cache[index]

    return get_pubkey


def per_block_processing(
    state,
    signed_block,
    spec: ChainSpec,
    types,
    strategy: SignatureStrategy = SignatureStrategy.VERIFY_BULK,
    get_pubkey=None,
    verify_block_root: bool = True,
) -> None:
    """Mutates `state` by applying `signed_block`. Raises on invalidity."""
    fork = spec.fork_name_at_slot(signed_block.message.slot)
    get_pubkey = get_pubkey or _default_pubkey_getter(state)
    batch = SignatureBatch()

    def handle(s):
        if strategy == SignatureStrategy.VERIFY_BULK:
            batch.add(s)
        elif strategy == SignatureStrategy.VERIFY_INDIVIDUAL:
            b = SignatureBatch()
            b.add(s)
            if not b.verify():
                raise BlockProcessingError("invalid signature")

    block = signed_block.message

    if strategy in (SignatureStrategy.VERIFY_BULK, SignatureStrategy.VERIFY_INDIVIDUAL):
        handle(sigs.block_proposal_set(state, spec, types, signed_block, get_pubkey))

    process_block_header(state, spec, types, block, verify_block_root=verify_block_root)
    if fork >= ForkName.bellatrix:
        process_withdrawals_and_payload(state, spec, types, block, fork)
    process_randao(state, spec, types, block, strategy, handle, get_pubkey)
    process_eth1_data(state, spec, types, block.body)
    process_operations(state, spec, types, block, fork, handle, get_pubkey)
    if fork >= ForkName.altair:
        process_sync_aggregate(state, spec, types, block, handle, get_pubkey)

    if strategy == SignatureStrategy.VERIFY_BULK:
        if not batch.verify():
            raise BlockProcessingError("bulk signature verification failed")


# ------------------------------------------------------------ header


def process_block_header(state, spec, types, block, verify_block_root=True):
    if block.slot != state.slot:
        raise BlockProcessingError(f"block slot {block.slot} != state slot {state.slot}")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessingError("block not newer than latest header")
    expected_proposer = acc.get_beacon_proposer_index(state, spec)
    if block.proposer_index != expected_proposer:
        raise BlockProcessingError(
            f"wrong proposer {block.proposer_index} != {expected_proposer}"
        )
    if verify_block_root:
        parent_root = types.BeaconBlockHeader.hash_tree_root(state.latest_block_header)
        if bytes(block.parent_root) != parent_root:
            raise BlockProcessingError("parent root mismatch")
    if state.validators[block.proposer_index].slashed:
        raise BlockProcessingError("proposer is slashed")
    state.latest_block_header = types.BeaconBlockHeader.make(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,  # filled at next slot processing
        body_root=types.BeaconBlockBody.hash_tree_root(block.body),
    )


# ------------------------------------------------------------ randao / eth1


def process_randao(state, spec, types, block, strategy, handle, get_pubkey):
    epoch = acc.get_current_epoch(state, spec)
    if strategy != SignatureStrategy.NO_VERIFICATION:
        handle(sigs.randao_set(state, spec, types, block, get_pubkey))
        if strategy == SignatureStrategy.VERIFY_RANDAO:
            b = SignatureBatch()
            b.add(sigs.randao_set(state, spec, types, block, get_pubkey))
            if not b.verify():
                raise BlockProcessingError("invalid randao reveal")
    mix = bytes(
        a ^ b
        for a, b in zip(
            acc.h.get_randao_mix(state, spec, epoch),
            h.sha256(bytes(block.body.randao_reveal)),
        )
    )
    state.randao_mixes[epoch % spec.preset.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def eth1_data_after_vote(state, spec, vote):
    """The eth1_data that process_eth1_data will leave in place after this
    vote is cast — shared by the verifier (below) and the block producer
    (deposit inclusion must be computed against the POST-vote value)."""
    period_slots = spec.preset.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.preset.SLOTS_PER_EPOCH
    count = sum(1 for v in state.eth1_data_votes if v == vote) + 1
    return vote if count * 2 > period_slots else state.eth1_data


def process_eth1_data(state, spec, types, body):
    effective = eth1_data_after_vote(state, spec, body.eth1_data)
    state.eth1_data_votes.append(body.eth1_data)
    state.eth1_data = effective


# ------------------------------------------------------------ operations


def process_operations(state, spec, types, block, fork, handle, get_pubkey):
    body = block.body
    # expected deposit count; electra (EIP-6110) caps the eth1 bridge queue
    # at deposit_requests_start_index
    if fork >= ForkName.electra:
        eth1_deposit_index_limit = min(
            state.eth1_data.deposit_count, state.deposit_requests_start_index
        )
        if state.eth1_deposit_index < eth1_deposit_index_limit:
            expected_deposits = min(
                spec.preset.MAX_DEPOSITS,
                eth1_deposit_index_limit - state.eth1_deposit_index,
            )
        else:
            expected_deposits = 0
    else:
        expected_deposits = min(
            spec.preset.MAX_DEPOSITS,
            state.eth1_data.deposit_count - state.eth1_deposit_index,
        )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessingError(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )

    for ps in body.proposer_slashings:
        process_proposer_slashing(state, spec, types, ps, fork, handle, get_pubkey)
    for asl in body.attester_slashings:
        process_attester_slashing(state, spec, types, asl, fork, handle, get_pubkey)
    cache = {}
    for att in body.attestations:
        process_attestation(state, spec, types, att, fork, handle, get_pubkey, cache)
    for dep in body.deposits:
        process_deposit(state, spec, types, dep, fork)
    for exit_ in body.voluntary_exits:
        process_voluntary_exit(state, spec, types, exit_, handle, get_pubkey)
    if fork >= ForkName.capella:
        for change in body.bls_to_execution_changes:
            process_bls_to_execution_change(state, spec, types, change, handle)
    if fork >= ForkName.deneb:
        if len(body.blob_kzg_commitments) > spec.max_blobs(fork):
            raise BlockProcessingError("too many blob commitments")
    if fork >= ForkName.electra:
        from . import electra as el

        reqs = body.execution_requests
        for dr in reqs.deposits:
            el.process_deposit_request(state, spec, types, dr)
        for wr in reqs.withdrawals:
            el.process_withdrawal_request(state, spec, types, wr)
        for cr in reqs.consolidations:
            el.process_consolidation_request(state, spec, types, cr)


def _is_slashable_attestation_data(d1, d2) -> bool:
    double = d1 != d2 and d1.target.epoch == d2.target.epoch
    surround = d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    return double or surround


def _validate_indexed_attestation(state, spec, types, indexed, handle, get_pubkey):
    idx = list(indexed.attesting_indices)
    if not idx or idx != sorted(set(idx)):
        raise BlockProcessingError("attesting indices not sorted/unique/nonempty")
    if any(i >= len(state.validators) for i in idx):
        raise BlockProcessingError("unknown validator index")
    handle(sigs.indexed_attestation_set(state, spec, types, indexed, get_pubkey))


def process_proposer_slashing(state, spec, types, slashing, fork, handle, get_pubkey):
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessingError("proposer slashing: different slots")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessingError("proposer slashing: different proposers")
    if h1 == h2:
        raise BlockProcessingError("proposer slashing: identical headers")
    if h1.proposer_index >= len(state.validators):
        raise BlockProcessingError("proposer slashing: unknown validator")
    proposer = state.validators[h1.proposer_index]
    if not h.is_slashable_validator(proposer, acc.get_current_epoch(state, spec)):
        raise BlockProcessingError("proposer not slashable")
    for s in sigs.proposer_slashing_sets(state, spec, types, slashing, get_pubkey):
        handle(s)
    mut.slash_validator(state, spec, fork, h1.proposer_index)


def process_attester_slashing(state, spec, types, slashing, fork, handle, get_pubkey):
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    if not _is_slashable_attestation_data(a1.data, a2.data):
        raise BlockProcessingError("attestations not slashable")
    _validate_indexed_attestation(state, spec, types, a1, handle, get_pubkey)
    _validate_indexed_attestation(state, spec, types, a2, handle, get_pubkey)
    slashed_any = False
    common = sorted(set(a1.attesting_indices) & set(a2.attesting_indices))
    epoch = acc.get_current_epoch(state, spec)
    for index in common:
        if h.is_slashable_validator(state.validators[index], epoch):
            mut.slash_validator(state, spec, fork, index)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessingError("attester slashing slashed nobody")


def process_attestation(state, spec, types, att, fork, handle, get_pubkey, cache):
    data = att.data
    p = spec.preset
    current_epoch = acc.get_current_epoch(state, spec)
    previous_epoch = acc.get_previous_epoch(state, spec)
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BlockProcessingError("attestation target epoch out of range")
    if data.target.epoch != h.compute_epoch_at_slot(data.slot, spec):
        raise BlockProcessingError("target epoch != slot epoch")
    if state.slot < data.slot + spec.min_attestation_inclusion_delay:
        raise BlockProcessingError("attestation inclusion window")
    # EIP-7045 (deneb) removed the one-epoch upper inclusion bound; older
    # forks still enforce it (reference drops it for deneb+ likewise).
    if fork < ForkName.deneb and state.slot > data.slot + p.SLOTS_PER_EPOCH:
        raise BlockProcessingError("attestation inclusion window")
    epoch_cache = cache.get(data.target.epoch)
    if epoch_cache is None:
        epoch_cache = acc.build_committee_cache(state, spec, data.target.epoch)
        cache[data.target.epoch] = epoch_cache
    if fork >= ForkName.electra:
        # EIP-7549: committee index lives in committee_bits; aggregation bits
        # span the named committees concatenated in index order
        if data.index != 0:
            raise BlockProcessingError("electra attestation data.index != 0")
        try:
            attesting = acc.get_attesting_indices_electra(
                state, spec, att, epoch_cache
            )
        except ValueError as e:
            raise BlockProcessingError(f"electra attestation: {e}") from e
    else:
        if data.index >= epoch_cache.committees_per_slot:
            raise BlockProcessingError("bad committee index")
        committee = epoch_cache.committee(data.slot, data.index)
        if len(att.aggregation_bits) != len(committee):
            raise BlockProcessingError("aggregation bits != committee size")
        attesting = [i for i, bit in zip(committee, att.aggregation_bits) if bit]

    indexed = types.IndexedAttestation.make(
        attesting_indices=sorted(attesting),
        data=data,
        signature=att.signature,
    )
    _validate_indexed_attestation(state, spec, types, indexed, handle, get_pubkey)

    if fork == ForkName.phase0:
        pending = types.PendingAttestation.make(
            aggregation_bits=att.aggregation_bits,
            data=data,
            inclusion_delay=state.slot - data.slot,
            proposer_index=acc.get_beacon_proposer_index(state, spec),
        )
        # justified checkpoint check
        if data.target.epoch == current_epoch:
            if data.source != state.current_justified_checkpoint:
                raise BlockProcessingError("wrong source checkpoint")
            state.current_epoch_attestations.append(pending)
        else:
            if data.source != state.previous_justified_checkpoint:
                raise BlockProcessingError("wrong source checkpoint")
            state.previous_epoch_attestations.append(pending)
        return

    # altair+: participation flags + proposer reward
    flags = _attestation_participation_flags(state, spec, data, state.slot - data.slot)
    participation = (
        state.current_epoch_participation
        if data.target.epoch == current_epoch
        else state.previous_epoch_participation
    )
    base_per_incr = acc.get_base_reward_per_increment(state, spec)
    proposer_reward_numerator = 0
    for index in attesting:
        for flag_index, weight in enumerate(acc.PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in flags and not acc.has_flag(participation[index], flag_index):
                participation[index] = acc.add_flag(participation[index], flag_index)
                incr = (
                    state.validators[index].effective_balance
                    // spec.effective_balance_increment
                )
                proposer_reward_numerator += incr * base_per_incr * weight
    proposer_reward_denominator = (
        (acc.WEIGHT_DENOMINATOR - acc.PROPOSER_WEIGHT)
        * acc.WEIGHT_DENOMINATOR
        // acc.PROPOSER_WEIGHT
    )
    mut.increase_balance(
        state,
        acc.get_beacon_proposer_index(state, spec),
        proposer_reward_numerator // proposer_reward_denominator,
    )


def _attestation_participation_flags(state, spec, data, inclusion_delay):
    justified = (
        state.current_justified_checkpoint
        if data.target.epoch == acc.get_current_epoch(state, spec)
        else state.previous_justified_checkpoint
    )
    if data.source != justified:
        raise BlockProcessingError("wrong source checkpoint")
    is_matching_source = True
    is_matching_target = bytes(data.target.root) == acc.get_block_root(
        state, spec, data.target.epoch
    )
    is_matching_head = is_matching_target and bytes(
        data.beacon_block_root
    ) == acc.get_block_root_at_slot(state, spec, data.slot)
    flags = []
    import math

    if is_matching_source and inclusion_delay <= math.isqrt(spec.preset.SLOTS_PER_EPOCH):
        flags.append(acc.TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target:
        flags.append(acc.TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == spec.min_attestation_inclusion_delay:
        flags.append(acc.TIMELY_HEAD_FLAG_INDEX)
    return flags


# ------------------------------------------------------------ deposits


def is_valid_merkle_branch(leaf, branch, depth, index, root) -> bool:
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = h.sha256(bytes(branch[i]) + value)
        else:
            value = h.sha256(value + bytes(branch[i]))
    return value == bytes(root)


def process_deposit(state, spec, types, deposit, fork):
    if not is_valid_merkle_branch(
        types.DepositData.hash_tree_root(deposit.data),
        deposit.proof,
        spec.preset.DEPOSIT_CONTRACT_TREE_DEPTH + 1,
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise BlockProcessingError("invalid deposit proof")
    state.eth1_deposit_index += 1
    apply_deposit(state, spec, types, deposit.data, fork)


def is_valid_deposit_signature(spec, types, pubkey, withdrawal_credentials, amount, signature) -> bool:
    """Proof-of-possession check; invalid deposits are skipped, not
    block-invalidating (spec behavior)."""
    data = types.DepositData.make(
        pubkey=pubkey,
        withdrawal_credentials=withdrawal_credentials,
        amount=amount,
        signature=signature,
    )
    try:
        s = sigs.deposit_set(spec, types, data)
    except Exception:
        return False
    b = SignatureBatch()
    b.add(s)
    return b.verify()


def add_validator_to_registry(state, spec, types, pubkey, withdrawal_credentials, amount) -> None:
    electra = hasattr(state, "pending_deposits")
    if electra:
        v_probe = types.Validator.make(
            pubkey=pubkey,
            withdrawal_credentials=withdrawal_credentials,
            effective_balance=0,
            slashed=False,
            activation_eligibility_epoch=FAR_FUTURE_EPOCH,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
        max_eff = h.get_max_effective_balance(v_probe, spec)
    else:
        max_eff = spec.max_effective_balance
    v = types.Validator.make(
        pubkey=pubkey,
        withdrawal_credentials=withdrawal_credentials,
        effective_balance=min(
            amount - amount % spec.effective_balance_increment, max_eff
        ),
        slashed=False,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )
    state.validators.append(v)
    state.balances.append(amount)
    if hasattr(state, "previous_epoch_participation"):
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)


def apply_deposit(state, spec, types, data, fork):
    pubkeys = [bytes(v.pubkey) for v in state.validators]
    pk = bytes(data.pubkey)

    if fork >= ForkName.electra:
        # EIP-6110: deposits flow through the pending queue; new validators
        # are registered with zero balance, the amount follows via
        # process_pending_deposits' churn
        if pk not in pubkeys:
            if not is_valid_deposit_signature(
                spec, types, data.pubkey, data.withdrawal_credentials,
                data.amount, data.signature,
            ):
                return
            add_validator_to_registry(
                state, spec, types, data.pubkey, data.withdrawal_credentials, 0
            )
        from ..types.spec import GENESIS_SLOT

        state.pending_deposits.append(
            types.PendingDeposit.make(
                pubkey=data.pubkey,
                withdrawal_credentials=data.withdrawal_credentials,
                amount=data.amount,
                signature=data.signature,
                slot=GENESIS_SLOT,
            )
        )
        return

    if pk not in pubkeys:
        if not is_valid_deposit_signature(
            spec, types, data.pubkey, data.withdrawal_credentials,
            data.amount, data.signature,
        ):
            return
        add_validator_to_registry(
            state, spec, types, data.pubkey, data.withdrawal_credentials, data.amount
        )
    else:
        index = pubkeys.index(pk)
        mut.increase_balance(state, index, data.amount)


# ------------------------------------------------------------ exits / bls changes


def process_voluntary_exit(state, spec, types, signed_exit, handle, get_pubkey):
    exit_ = signed_exit.message
    if exit_.validator_index >= len(state.validators):
        raise BlockProcessingError("exit: unknown validator")
    v = state.validators[exit_.validator_index]
    epoch = acc.get_current_epoch(state, spec)
    if not h.is_active_validator(v, epoch):
        raise BlockProcessingError("exiting validator not active")
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessingError("validator already exiting")
    if epoch < exit_.epoch:
        raise BlockProcessingError("exit epoch in future")
    if epoch < v.activation_epoch + spec.shard_committee_period:
        raise BlockProcessingError("validator too young to exit")
    if hasattr(state, "pending_partial_withdrawals"):
        # electra: only exit a validator with no pending partial withdrawals
        from .electra import get_pending_balance_to_withdraw

        if get_pending_balance_to_withdraw(state, exit_.validator_index) != 0:
            raise BlockProcessingError("exit with pending partial withdrawals")
    handle(sigs.voluntary_exit_set(state, spec, types, signed_exit, get_pubkey))
    mut.initiate_validator_exit(state, spec, exit_.validator_index)


def process_bls_to_execution_change(state, spec, types, signed_change, handle):
    change = signed_change.message
    if change.validator_index >= len(state.validators):
        raise BlockProcessingError("unknown validator")
    v = state.validators[change.validator_index]
    wc = bytes(v.withdrawal_credentials)
    if wc[:1] != b"\x00":
        raise BlockProcessingError("not BLS withdrawal credentials")
    if wc[1:] != h.sha256(bytes(change.from_bls_pubkey))[1:]:
        raise BlockProcessingError("withdrawal credentials mismatch")
    handle(sigs.bls_to_execution_change_set(state, spec, types, signed_change))
    state.validators[change.validator_index] = v.copy_with(
        withdrawal_credentials=b"\x01" + b"\x00" * 11 + bytes(change.to_execution_address)
    )


# ------------------------------------------------------------ sync aggregate


def process_sync_aggregate(state, spec, types, block, handle, get_pubkey):
    agg = block.body.sync_aggregate
    bits = agg.sync_committee_bits
    sig = bls.Signature.deserialize(bytes(agg.sync_committee_signature))
    if not any(bits):
        if not sig.is_infinity():
            raise BlockProcessingError("empty sync aggregate with non-infinity signature")
    else:
        s = sigs.sync_aggregate_set(state, spec, types, agg, block.slot, get_pubkey)
        handle(s)

    # rewards
    total_active_increments = (
        acc.get_total_active_balance(state, spec) // spec.effective_balance_increment
    )
    base_per_incr = acc.get_base_reward_per_increment(state, spec)
    total_base_rewards = base_per_incr * total_active_increments
    max_participant_rewards = (
        total_base_rewards
        * acc.SYNC_REWARD_WEIGHT
        // acc.WEIGHT_DENOMINATOR
        // spec.preset.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // spec.preset.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward
        * acc.PROPOSER_WEIGHT
        // (acc.WEIGHT_DENOMINATOR - acc.PROPOSER_WEIGHT)
    )
    proposer_index = acc.get_beacon_proposer_index(state, spec)

    pubkey_to_index = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    for pk, bit in zip(state.current_sync_committee.pubkeys, bits):
        index = pubkey_to_index[bytes(pk)]
        if bit:
            mut.increase_balance(state, index, participant_reward)
            mut.increase_balance(state, proposer_index, proposer_reward)
        else:
            mut.decrease_balance(state, index, participant_reward)


# ------------------------------------------------------------ payload / withdrawals


def compute_timestamp_at_slot(state, spec, slot) -> int:
    return state.genesis_time + slot * spec.seconds_per_slot


def get_expected_withdrawals(state, spec, types):
    """Capella withdrawal sweep; electra prepends the pending-partial queue
    (EIP-7002) and uses compounding-aware balance ceilings (EIP-7251).

    Returns (withdrawals, processed_partial_withdrawals_count)."""
    epoch = acc.get_current_epoch(state, spec)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    withdrawals = []
    processed_partials = 0
    electra = hasattr(state, "pending_partial_withdrawals")

    if electra:
        for w in state.pending_partial_withdrawals:
            if (
                w.withdrawable_epoch > epoch
                or len(withdrawals)
                == spec.preset.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP
            ):
                break
            v = state.validators[w.validator_index]
            has_sufficient = v.effective_balance >= spec.min_activation_balance
            has_excess = state.balances[w.validator_index] > spec.min_activation_balance
            if v.exit_epoch == FAR_FUTURE_EPOCH and has_sufficient and has_excess:
                withdrawable = min(
                    state.balances[w.validator_index] - spec.min_activation_balance,
                    w.amount,
                )
                withdrawals.append(
                    types.Withdrawal.make(
                        index=withdrawal_index,
                        validator_index=w.validator_index,
                        address=bytes(v.withdrawal_credentials)[12:],
                        amount=withdrawable,
                    )
                )
                withdrawal_index += 1
            processed_partials += 1

    n = len(state.validators)
    bound = min(n, spec.preset.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
    for _ in range(bound):
        v = state.validators[validator_index]
        wc = bytes(v.withdrawal_credentials)
        if electra:
            partially_withdrawn = sum(
                w.amount for w in withdrawals if w.validator_index == validator_index
            )
            balance = state.balances[validator_index] - partially_withdrawn
            has_cred = h.has_execution_withdrawal_credential(v)
            max_eff = h.get_max_effective_balance(v, spec)
        else:
            balance = state.balances[validator_index]
            has_cred = wc[:1] == b"\x01"
            max_eff = spec.max_effective_balance
        fully = has_cred and v.withdrawable_epoch <= epoch and balance > 0
        partially = (
            has_cred and v.effective_balance == max_eff and balance > max_eff
        )
        if fully:
            withdrawals.append(
                types.Withdrawal.make(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=wc[12:],
                    amount=balance,
                )
            )
            withdrawal_index += 1
        elif partially:
            withdrawals.append(
                types.Withdrawal.make(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=wc[12:],
                    amount=balance - max_eff,
                )
            )
            withdrawal_index += 1
        if len(withdrawals) == spec.preset.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        validator_index = (validator_index + 1) % n
    return withdrawals, processed_partials


def is_execution_enabled(state, types, body) -> bool:
    return (
        is_merge_transition_complete(state, types)
        or body.execution_payload != types.ExecutionPayload.default()
    )


def process_withdrawals_and_payload(state, spec, types, block, fork):
    payload = block.body.execution_payload
    if not is_execution_enabled(state, types, block.body):
        return
    if fork >= ForkName.capella:
        expected, processed_partials = get_expected_withdrawals(state, spec, types)
        if list(payload.withdrawals) != expected:
            raise BlockProcessingError("unexpected withdrawals")
        for w in expected:
            mut.decrease_balance(state, w.validator_index, w.amount)
        if fork >= ForkName.electra:
            state.pending_partial_withdrawals = list(
                state.pending_partial_withdrawals[processed_partials:]
            )
        if expected:
            state.next_withdrawal_index = expected[-1].index + 1
        if len(expected) == spec.preset.MAX_WITHDRAWALS_PER_PAYLOAD:
            state.next_withdrawal_validator_index = (
                expected[-1].validator_index + 1
            ) % len(state.validators)
        else:
            state.next_withdrawal_validator_index = (
                state.next_withdrawal_validator_index
                + spec.preset.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
            ) % len(state.validators)

    process_execution_payload(state, spec, types, block, fork)


def is_merge_transition_complete(state, types) -> bool:
    return state.latest_execution_payload_header != types.ExecutionPayloadHeader.default()


def process_execution_payload(state, spec, types, block, fork):
    """Consensus-side payload checks; execution validity (newPayload) is the
    chain layer's job via the EL client (SURVEY §3.2 process boundary)."""
    payload = block.body.execution_payload
    if is_merge_transition_complete(state, types):
        if bytes(payload.parent_hash) != bytes(
            state.latest_execution_payload_header.block_hash
        ):
            raise BlockProcessingError("payload parent hash mismatch")
    if bytes(payload.prev_randao) != acc.h.get_randao_mix(
        state, spec, acc.get_current_epoch(state, spec)
    ):
        raise BlockProcessingError("payload prev_randao mismatch")
    if payload.timestamp != compute_timestamp_at_slot(state, spec, state.slot):
        raise BlockProcessingError("payload timestamp mismatch")

    header_kwargs = dict(
        parent_hash=payload.parent_hash,
        fee_recipient=payload.fee_recipient,
        state_root=payload.state_root,
        receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom,
        prev_randao=payload.prev_randao,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=_transactions_root(types, payload),
    )
    if fork >= ForkName.capella:
        from ..ssz.core import List as SSZList

        header_kwargs["withdrawals_root"] = SSZList(
            types.Withdrawal, spec.preset.MAX_WITHDRAWALS_PER_PAYLOAD
        ).hash_tree_root(payload.withdrawals)
    if fork >= ForkName.deneb:
        header_kwargs["blob_gas_used"] = payload.blob_gas_used
        header_kwargs["excess_blob_gas"] = payload.excess_blob_gas
    state.latest_execution_payload_header = types.ExecutionPayloadHeader.make(**header_kwargs)


def _transactions_root(types, payload):
    from ..ssz.core import List as SSZList

    ptype = None
    for f in types.ExecutionPayload.fields:
        if f.name == "transactions":
            ptype = f.type
    return ptype.hash_tree_root(payload.transactions)
