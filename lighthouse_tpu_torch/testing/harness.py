"""StateHarness — deterministic block production over the state transition.

The core of the reference's BeaconChainHarness
(lighthouse/beacon_node/beacon_chain/src/test_utils.rs:610): interop
keypairs, logical time, extend-chain with full attestation participation.
This harness drives the pure state transition; chain/test_utils wraps it
with a full BeaconChain (store + fork choice) later.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..crypto import bls
from ..types import helpers as h
from ..types.spec import (
    ChainSpec,
    ForkName,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
)
from ..types.containers import spec_types
from ..state_transition import accessors as acc
from ..state_transition.block import SignatureStrategy
from ..state_transition.genesis import interop_genesis_state
from ..state_transition.slot import process_slots, state_transition, types_for_slot


# Re-export: clone_state is production consensus code and lives with the
# type layer; the harness keeps the historical import path for tests.
from ..types.state_util import clone_state  # noqa: F401


def _sign(sk, root: bytes) -> "bls.Signature":
    """Sign, but under the fake backend return a cheap deterministic dummy —
    the fake backend never checks signatures, and skipping the g2_mul makes
    the plumbing test lanes ~20x faster (the reference gets the same effect
    from fake_crypto's no-op sign)."""
    if bls.get_backend().name == "fake":
        return _DummySig()
    return bls.sign(sk, root)


class _DummySig:
    """Stand-in signature under the fake backend: a fixed VALID G2 point
    (the generator) so signature-set constructors can still decode it."""

    _cached = None

    def __init__(self):
        if _DummySig._cached is None:
            from ..crypto.bls381 import curve as _cv, serde as _serde

            _DummySig._cached = _serde.g2_compress(_cv.G2_GEN)
        self.point = None

    def serialize(self) -> bytes:
        return _DummySig._cached

    def is_infinity(self) -> bool:
        return False


@dataclass
class StateHarness:
    spec: ChainSpec
    keypairs: list
    state: object = None
    genesis_time: int = 1_600_000_000

    def __post_init__(self):
        if self.state is None:
            self.state = interop_genesis_state(self.keypairs, self.genesis_time, self.spec)

    @classmethod
    def new(cls, spec: ChainSpec, validator_count: int):
        return cls(spec=spec, keypairs=bls.interop_keypairs(validator_count))

    # -- signing helpers --------------------------------------------------

    def sk(self, validator_index: int) -> bls.SecretKey:
        return self.keypairs[validator_index].sk

    def sign_block(self, block, types):
        # Domain from the SPEC's fork schedule at the block's epoch, not
        # from self.state: the pre-block state still carries the old fork
        # at an upgrade boundary, and the verifier's advanced state would
        # use the new one (a real-crypto-only mismatch the fake lane never
        # sees).
        epoch = h.compute_epoch_at_slot(block.slot, self.spec)
        version = self.spec.fork_version(self.spec.fork_name_at_epoch(epoch))
        domain = h.compute_domain(
            DOMAIN_BEACON_PROPOSER, version,
            bytes(self.state.genesis_validators_root),
        )
        root = h.compute_signing_root(types.BeaconBlock, block, domain)
        sig = _sign(self.sk(block.proposer_index), root)
        return types.SignedBeaconBlock.make(message=block, signature=sig.serialize())

    def randao_reveal(self, state, proposer_index: int, epoch: int) -> bytes:
        from ..ssz.core import uint64

        domain = h.get_domain(state, self.spec, DOMAIN_RANDAO, epoch)
        root = h.compute_signing_root(uint64, epoch, domain)
        return _sign(self.sk(proposer_index), root).serialize()

def _build_attestations(self, state, slot, head_root):
    spec = self.spec
    types = types_for_slot(spec, slot)
    epoch = h.compute_epoch_at_slot(slot, spec)
    cache = acc.build_committee_cache(state, spec, epoch)
    start_slot = h.compute_start_slot_at_epoch(epoch, spec)
    if slot == start_slot:
        target_root = head_root
    else:
        target_root = state.block_roots[start_slot % spec.preset.SLOTS_PER_HISTORICAL_ROOT]
    source = (
        state.current_justified_checkpoint
        if epoch == acc.get_current_epoch(state, spec)
        else state.previous_justified_checkpoint
    )
    domain = h.get_domain(state, spec, DOMAIN_BEACON_ATTESTER, epoch)
    atts = []
    from ..crypto.bls381 import curve as cv

    electra = spec.fork_name_at_slot(slot) >= ForkName.electra
    for index in range(cache.committees_per_slot):
        committee = cache.committee(slot, index)
        data = types.AttestationData.make(
            slot=slot,
            index=0 if electra else index,
            beacon_block_root=head_root,
            source=source,
            target=types.Checkpoint.make(epoch=epoch, root=target_root),
        )
        root = h.compute_signing_root(types.AttestationData, data, domain)
        if bls.get_backend().name == "fake":
            sig_bytes = _sign(self.sk(committee[0]), root).serialize()
        else:
            agg_point = None
            for vi in committee:
                s = bls.sign(self.sk(vi), root)
                agg_point = cv.g2_add(agg_point, s.point)
            sig_bytes = bls.Signature(agg_point).serialize()
        if electra:
            # EIP-7549: one attestation per committee, committee_bits set
            committee_bits = [False] * spec.preset.MAX_COMMITTEES_PER_SLOT
            committee_bits[index] = True
            atts.append(
                types.Attestation.make(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=sig_bytes,
                    committee_bits=committee_bits,
                )
            )
        else:
            atts.append(
                types.Attestation.make(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=sig_bytes,
                )
            )
    return atts


def _sync_aggregate(self, state, block_slot: int):
    """Fully-participating sync aggregate signing the parent block root."""
    spec = self.spec
    types = types_for_slot(spec, block_slot)
    prev_slot = max(block_slot, 1) - 1
    epoch = h.compute_epoch_at_slot(prev_slot, spec)
    domain = h.get_domain(state, spec, DOMAIN_SYNC_COMMITTEE, epoch)
    root = acc.get_block_root_at_slot(state, spec, prev_slot)
    signing_root = h.compute_signing_root_from_root(root, domain)
    sk_by_pk = {kp.pk.serialize(): kp.sk for kp in self.keypairs}
    from ..crypto.bls381 import curve as cv

    fake = bls.get_backend().name == "fake"
    agg_point = None
    bits = []
    any_signer = None
    for pk in state.current_sync_committee.pubkeys:
        sk = sk_by_pk.get(bytes(pk))
        if sk is None:
            bits.append(False)
            continue
        bits.append(True)
        any_signer = sk
        if not fake:
            s = bls.sign(sk, signing_root)
            agg_point = cv.g2_add(agg_point, s.point)
    if fake and any_signer is not None:
        sig_bytes = _sign(any_signer, signing_root).serialize()
    elif agg_point is not None:
        sig_bytes = bls.Signature(agg_point).serialize()
    else:
        sig_bytes = bls.INFINITY_SIGNATURE_BYTES
    return types.SyncAggregate.make(
        sync_committee_bits=bits,
        sync_committee_signature=sig_bytes,
    )


def _produce_block(self, slot: int, attestations=(), full_sync: bool = True):
    """Produce a signed block for `slot` on top of the current state."""
    spec = self.spec
    types = types_for_slot(spec, slot)
    fork = spec.fork_name_at_slot(slot)
    state = clone_state(self.state, spec)
    process_slots(state, spec, slot)

    proposer = acc.get_beacon_proposer_index(state, spec)
    epoch = h.compute_epoch_at_slot(slot, spec)
    # process_slots filled latest_block_header.state_root at the parent slot
    parent_root = types.BeaconBlockHeader.hash_tree_root(state.latest_block_header)

    # drop attestations whose container shape doesn't match the block's fork
    # (at the electra boundary, pre-fork attestations can't be included —
    # EIP-7549 changed the Attestation container)
    electra_block = fork >= ForkName.electra
    attestations = [
        a for a in attestations if hasattr(a, "committee_bits") == electra_block
    ]
    body_kwargs = dict(
        randao_reveal=self.randao_reveal(state, proposer, epoch),
        eth1_data=state.eth1_data,
        graffiti=b"\x00" * 32,
        proposer_slashings=[],
        attester_slashings=[],
        attestations=list(attestations),
        deposits=[],
        voluntary_exits=[],
    )
    if fork >= ForkName.altair:
        if full_sync:
            body_kwargs["sync_aggregate"] = _sync_aggregate(self, state, slot)
        else:
            body_kwargs["sync_aggregate"] = types.SyncAggregate.make(
                sync_committee_bits=[False] * spec.preset.SYNC_COMMITTEE_SIZE,
                sync_committee_signature=bls.INFINITY_SIGNATURE_BYTES,
            )
    if fork >= ForkName.bellatrix:
        body_kwargs["execution_payload"] = types.ExecutionPayload.default()
    if fork >= ForkName.capella:
        body_kwargs["bls_to_execution_changes"] = []
    if fork >= ForkName.deneb:
        body_kwargs["blob_kzg_commitments"] = []
    if fork >= ForkName.electra:
        body_kwargs["execution_requests"] = types.ExecutionRequests.default()

    block = types.BeaconBlock.make(
        slot=slot,
        proposer_index=proposer,
        parent_root=parent_root,
        state_root=b"\x00" * 32,
        body=types.BeaconBlockBody.make(**body_kwargs),
    )
    # compute state root by applying the unsigned block without checks
    trial = types.SignedBeaconBlock.make(message=block, signature=b"\x00" * 96)
    post = clone_state(self.state, spec)
    state_transition(
        post,
        trial,
        spec,
        strategy=SignatureStrategy.NO_VERIFICATION,
        verify_state_root=False,
    )
    block = block.copy_with(state_root=types.BeaconState.hash_tree_root(post))
    return self.sign_block(block, types), post


def _apply_block(self, signed_block, strategy=SignatureStrategy.VERIFY_BULK):
    state_transition(self.state, signed_block, self.spec, strategy=strategy)
    return signed_block


def _extend_chain(self, num_blocks: int, attest: bool = True):
    """Produce+apply `num_blocks` blocks with full attestation participation
    (attestations from slot s included in the block at s+1)."""
    spec = self.spec
    blocks = []
    pending_atts = []
    for _ in range(num_blocks):
        slot = self.state.slot + 1
        signed, post = _produce_block(self, slot, attestations=pending_atts)
        _apply_block(self, signed)
        blocks.append(signed)
        if attest:
            types = types_for_slot(spec, slot)
            head_root = types.BeaconBlock.hash_tree_root(signed.message)
            att_state = clone_state(self.state, spec)
            pending_atts = _build_attestations(self, att_state, slot, head_root)
        else:
            pending_atts = []
    return blocks


StateHarness.build_attestations = _build_attestations
StateHarness.sync_aggregate = _sync_aggregate
StateHarness.produce_block = _produce_block
StateHarness.apply_block = _apply_block
StateHarness.extend_chain = _extend_chain
