"""SignatureSet constructors: every signed consensus object -> backend-
agnostic SignatureSet.

Parity surface: lighthouse/consensus/state_processing/src/
per_block_processing/signature_sets.rs:56-610 (18 kinds). Each constructor
resolves pubkeys through a caller-provided `get_pubkey(validator_index) ->
PublicKey` (the ValidatorPubkeyCache seam that feeds the batched verify)
and computes the 32-byte signing root host-side.
"""

from __future__ import annotations

from ..crypto import bls
from ..types import helpers as h
from ..types.spec import (
    ChainSpec,
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_BLS_TO_EXECUTION_CHANGE,
    DOMAIN_CONTRIBUTION_AND_PROOF,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
)
from . import accessors as acc


class SignatureSetError(Exception):
    pass


def _sig(signature_bytes: bytes) -> bls.Signature:
    try:
        return bls.Signature.deserialize(bytes(signature_bytes))
    except Exception as e:
        raise SignatureSetError(f"undecodable signature: {e}") from e


def block_proposal_set(state, spec: ChainSpec, types, signed_block, get_pubkey, block_root=None):
    """Proposer signature over the block root."""
    block = signed_block.message
    domain = h.get_domain(
        state, spec, DOMAIN_BEACON_PROPOSER, h.compute_epoch_at_slot(block.slot, spec)
    )
    if block_root is None:
        block_root = types.BeaconBlock.hash_tree_root(block)
    message = h.compute_signing_root_from_root(block_root, domain)
    pk = get_pubkey(block.proposer_index)
    return bls.SignatureSet(_sig(signed_block.signature), (pk,), message)


def historical_block_proposal_set(
    spec: ChainSpec, types, signed_block, genesis_validators_root: bytes, get_pubkey
):
    """Proposer signature set for a block BELOW the current anchor — no
    historical state needed: the domain is derived from the fork schedule +
    genesis_validators_root alone, and the pubkey from the (append-only)
    registry. This is what backfill batch verification runs on
    (lighthouse/beacon_node/beacon_chain/src/historical_blocks.rs:189)."""
    block = signed_block.message
    epoch = h.compute_epoch_at_slot(block.slot, spec)
    fork_version = spec.fork_version(spec.fork_name_at_epoch(epoch))
    domain = h.compute_domain(
        DOMAIN_BEACON_PROPOSER, fork_version, genesis_validators_root
    )
    block_root = types.BeaconBlock.hash_tree_root(block)
    message = h.compute_signing_root_from_root(block_root, domain)
    pk = get_pubkey(block.proposer_index)
    return bls.SignatureSet(_sig(signed_block.signature), (pk,), message)


def block_header_set(state, spec: ChainSpec, types, signed_header, get_pubkey):
    hdr = signed_header.message
    domain = h.get_domain(
        state, spec, DOMAIN_BEACON_PROPOSER, h.compute_epoch_at_slot(hdr.slot, spec)
    )
    root = types.BeaconBlockHeader.hash_tree_root(hdr)
    message = h.compute_signing_root_from_root(root, domain)
    pk = get_pubkey(hdr.proposer_index)
    return bls.SignatureSet(_sig(signed_header.signature), (pk,), message)


def randao_set(state, spec: ChainSpec, types, block, get_pubkey):
    from ..ssz.core import uint64

    epoch = h.compute_epoch_at_slot(block.slot, spec)
    domain = h.get_domain(state, spec, DOMAIN_RANDAO, epoch)
    message = h.compute_signing_root(uint64, epoch, domain)
    pk = get_pubkey(block.proposer_index)
    return bls.SignatureSet(_sig(block.body.randao_reveal), (pk,), message)


def indexed_attestation_set(state, spec: ChainSpec, types, indexed_att, get_pubkey):
    data = indexed_att.data
    domain = h.get_domain(state, spec, DOMAIN_BEACON_ATTESTER, data.target.epoch)
    message = h.compute_signing_root(types.AttestationData, data, domain)
    pks = [get_pubkey(i) for i in indexed_att.attesting_indices]
    if not pks:
        raise SignatureSetError("empty attesting indices")
    return bls.SignatureSet(_sig(indexed_att.signature), pks, message)


def proposer_slashing_sets(state, spec: ChainSpec, types, slashing, get_pubkey):
    return [
        block_header_set(state, spec, types, slashing.signed_header_1, get_pubkey),
        block_header_set(state, spec, types, slashing.signed_header_2, get_pubkey),
    ]


def attester_slashing_sets(state, spec: ChainSpec, types, slashing, get_pubkey):
    return [
        indexed_attestation_set(state, spec, types, slashing.attestation_1, get_pubkey),
        indexed_attestation_set(state, spec, types, slashing.attestation_2, get_pubkey),
    ]


def voluntary_exit_set(state, spec: ChainSpec, types, signed_exit, get_pubkey):
    exit_ = signed_exit.message
    # Deneb+: exits are signed with the capella fork domain regardless of
    # the current fork (EIP-7044 semantics at the capella version pin).
    from ..types.spec import ForkName

    if spec.fork_name_at_slot(state.slot) >= ForkName.deneb:
        version = spec.capella_fork_version
        domain = h.compute_domain(
            DOMAIN_VOLUNTARY_EXIT, version, state.genesis_validators_root
        )
    else:
        domain = h.get_domain(state, spec, DOMAIN_VOLUNTARY_EXIT, exit_.epoch)
    message = h.compute_signing_root(types.VoluntaryExit, exit_, domain)
    pk = get_pubkey(exit_.validator_index)
    return bls.SignatureSet(_sig(signed_exit.signature), (pk,), message)


def deposit_set(spec: ChainSpec, types, deposit_data):
    """Deposit signatures use compute_domain with the GENESIS fork version
    and empty genesis_validators_root, and the pubkey from the deposit
    itself (proof of possession; validator may not exist yet)."""
    domain = h.compute_domain(DOMAIN_DEPOSIT, spec.genesis_fork_version, b"\x00" * 32)
    msg = types.DepositMessage.make(
        pubkey=deposit_data.pubkey,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        amount=deposit_data.amount,
    )
    message = h.compute_signing_root(types.DepositMessage, msg, domain)
    pk = bls.PublicKey.deserialize(bytes(deposit_data.pubkey))
    return bls.SignatureSet(_sig(deposit_data.signature), (pk,), message)


def sync_aggregate_set(state, spec: ChainSpec, types, sync_aggregate, block_slot, get_pubkey):
    """Sync committee signature over the previous slot's block root."""
    prev_slot = max(block_slot, 1) - 1
    epoch = h.compute_epoch_at_slot(prev_slot, spec)
    domain = h.get_domain(state, spec, DOMAIN_SYNC_COMMITTEE, epoch)
    root = acc.get_block_root_at_slot(state, spec, prev_slot)
    message = h.compute_signing_root_from_root(root, domain)
    committee_pubkeys = state.current_sync_committee.pubkeys
    pks = [
        get_pubkey_by_bytes(get_pubkey, bytes(pk))
        for pk, bit in zip(committee_pubkeys, sync_aggregate.sync_committee_bits)
        if bit
    ]
    sig = _sig(sync_aggregate.sync_committee_signature)
    if not pks:
        # empty aggregate must carry the infinity signature; callers check
        # via eth_fast_aggregate_verify semantics
        return None
    return bls.SignatureSet(sig, pks, message)


def bls_to_execution_change_set(state, spec: ChainSpec, types, signed_change):
    """Signed with the GENESIS fork version (spendable forever)."""
    change = signed_change.message
    domain = h.compute_domain(
        DOMAIN_BLS_TO_EXECUTION_CHANGE,
        spec.genesis_fork_version,
        state.genesis_validators_root,
    )
    message = h.compute_signing_root(types.BLSToExecutionChange, change, domain)
    pk = bls.PublicKey.deserialize(bytes(change.from_bls_pubkey))
    return bls.SignatureSet(_sig(signed_change.signature), (pk,), message)


def selection_proof_set(state, spec: ChainSpec, types, slot, aggregator_index, selection_proof, get_pubkey):
    from ..ssz.core import uint64

    domain = h.get_domain(
        state, spec, DOMAIN_SELECTION_PROOF, h.compute_epoch_at_slot(slot, spec)
    )
    message = h.compute_signing_root(uint64, slot, domain)
    pk = get_pubkey(aggregator_index)
    return bls.SignatureSet(_sig(selection_proof), (pk,), message)


def aggregate_and_proof_set(state, spec: ChainSpec, types, signed_agg, get_pubkey):
    msg = signed_agg.message
    domain = h.get_domain(
        state,
        spec,
        DOMAIN_AGGREGATE_AND_PROOF,
        h.compute_epoch_at_slot(msg.aggregate.data.slot, spec),
    )
    message = h.compute_signing_root(types.AggregateAndProof, msg, domain)
    pk = get_pubkey(msg.aggregator_index)
    return bls.SignatureSet(_sig(signed_agg.signature), (pk,), message)


def sync_committee_message_set(state, spec: ChainSpec, msg, get_pubkey):
    domain = h.get_domain(
        state, spec, DOMAIN_SYNC_COMMITTEE, h.compute_epoch_at_slot(msg.slot, spec)
    )
    message = h.compute_signing_root_from_root(bytes(msg.beacon_block_root), domain)
    pk = get_pubkey(msg.validator_index)
    return bls.SignatureSet(_sig(msg.signature), (pk,), message)


def contribution_and_proof_set(state, spec: ChainSpec, types, signed, get_pubkey):
    msg = signed.message
    domain = h.get_domain(
        state,
        spec,
        DOMAIN_CONTRIBUTION_AND_PROOF,
        h.compute_epoch_at_slot(msg.contribution.slot, spec),
    )
    message = h.compute_signing_root(types.ContributionAndProof, msg, domain)
    pk = get_pubkey(msg.aggregator_index)
    return bls.SignatureSet(_sig(signed.signature), (pk,), message)


def sync_selection_proof_set(state, spec: ChainSpec, types, slot, subcommittee_index, aggregator_index, proof, get_pubkey):
    domain = h.get_domain(
        state,
        spec,
        DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        h.compute_epoch_at_slot(slot, spec),
    )
    data = types.SyncAggregatorSelectionData.make(
        slot=slot, subcommittee_index=subcommittee_index
    )
    message = h.compute_signing_root(types.SyncAggregatorSelectionData, data, domain)
    pk = get_pubkey(aggregator_index)
    return bls.SignatureSet(_sig(proof), (pk,), message)


def get_pubkey_by_bytes(get_pubkey, pk_bytes: bytes):
    """Resolve a pubkey by compressed bytes through the cache when the
    caller's get_pubkey supports it, else decompress."""
    resolver = getattr(get_pubkey, "by_bytes", None)
    if resolver is not None:
        return resolver(pk_bytes)
    return bls.PublicKey.deserialize(pk_bytes)
