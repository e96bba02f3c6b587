"""Light-client server: bootstrap/update production + verification.

Parity surface: lighthouse/beacon_node/beacon_chain/src/
light_client_server_cache.rs and the LightClient* containers of
consensus/types — LightClientBootstrap (header + current sync committee +
branch), LightClientUpdate (attested/finalized headers, next sync committee
branch, finality branch, sync aggregate), FinalityUpdate/OptimisticUpdate,
served over the /eth/v1/beacon/light_client endpoints.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ssz.proof import container_field_proof, verify_branch
from ..state_transition.slot import types_for_slot
from ..types.spec import ChainSpec


@dataclass
class LightClientBootstrap:
    header: object                      # BeaconBlockHeader
    current_sync_committee: object
    current_sync_committee_branch: list


@dataclass
class LightClientUpdate:
    attested_header: object
    next_sync_committee: object
    next_sync_committee_branch: list
    finalized_header: object | None
    finality_branch: list
    sync_aggregate: object
    signature_slot: int


@dataclass
class LightClientFinalityUpdate:
    attested_header: object
    finalized_header: object
    finality_branch: list
    sync_aggregate: object
    signature_slot: int


@dataclass
class LightClientOptimisticUpdate:
    attested_header: object
    sync_aggregate: object
    signature_slot: int


class LightClientServerCache:
    def __init__(self, spec: ChainSpec):
        self.spec = spec
        self.latest_finality_update: LightClientFinalityUpdate | None = None
        self.latest_optimistic_update: LightClientOptimisticUpdate | None = None
        self.bootstraps: dict[bytes, LightClientBootstrap] = {}
        self.best_updates: dict[int, LightClientUpdate] = {}   # sync period -> update

    # ------------------------------------------------------------- produce

    def produce_bootstrap(self, state, block_header) -> LightClientBootstrap:
        types = types_for_slot(self.spec, state.slot)
        _leaf, branch, _pos, _depth = container_field_proof(
            types.BeaconState, state, ["current_sync_committee"]
        )
        return LightClientBootstrap(
            header=block_header,
            current_sync_committee=state.current_sync_committee,
            current_sync_committee_branch=branch,
        )

    def produce_update(self, attested_state, attested_header, finalized_header, sync_aggregate, signature_slot):
        types = types_for_slot(self.spec, attested_state.slot)
        _l, next_branch, _p, _d = container_field_proof(
            types.BeaconState, attested_state, ["next_sync_committee"]
        )
        _l2, fin_branch, _p2, _d2 = container_field_proof(
            types.BeaconState, attested_state, ["finalized_checkpoint", "root"]
        )
        period = (
            attested_state.slot
            // self.spec.preset.SLOTS_PER_EPOCH
            // self.spec.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )
        update = LightClientUpdate(
            attested_header=attested_header,
            next_sync_committee=attested_state.next_sync_committee,
            next_sync_committee_branch=next_branch,
            finalized_header=finalized_header,
            finality_branch=fin_branch,
            sync_aggregate=sync_aggregate,
            signature_slot=signature_slot,
        )
        prior = self.best_updates.get(period)
        if prior is None or _participants(update) > _participants(prior):
            self.best_updates[period] = update
        return update

    def on_finality(self, attested_state, attested_header, finalized_header, sync_aggregate, signature_slot):
        types = types_for_slot(self.spec, attested_state.slot)
        _l, fin_branch, _p, _d = container_field_proof(
            types.BeaconState, attested_state, ["finalized_checkpoint", "root"]
        )
        self.latest_finality_update = LightClientFinalityUpdate(
            attested_header=attested_header,
            finalized_header=finalized_header,
            finality_branch=fin_branch,
            sync_aggregate=sync_aggregate,
            signature_slot=signature_slot,
        )

    def on_head(self, attested_header, sync_aggregate, signature_slot):
        self.latest_optimistic_update = LightClientOptimisticUpdate(
            attested_header=attested_header,
            sync_aggregate=sync_aggregate,
            signature_slot=signature_slot,
        )


def _participants(update: LightClientUpdate) -> int:
    return sum(1 for b in update.sync_aggregate.sync_committee_bits if b)


# ------------------------------------------------------------- verification


def verify_bootstrap(spec: ChainSpec, bootstrap: LightClientBootstrap, types) -> bool:
    """Check the sync-committee branch against the header's state root."""
    leaf = types.SyncCommittee.hash_tree_root(bootstrap.current_sync_committee)
    # position of current_sync_committee among state fields
    idx = next(
        i for i, f in enumerate(types.BeaconState.fields)
        if f.name == "current_sync_committee"
    )
    return verify_branch(
        leaf,
        bootstrap.current_sync_committee_branch,
        idx,
        bytes(bootstrap.header.state_root),
    )


def verify_finality_branch(spec: ChainSpec, update, types, finalized_block_root: bytes) -> bool:
    """The finality branch proves state.finalized_checkpoint.root against
    the attested header's state root. Leaf position: root is field 1 of the
    Checkpoint (depth 1) under finalized_checkpoint's state field index."""
    state_idx = next(
        i for i, f in enumerate(types.BeaconState.fields)
        if f.name == "finalized_checkpoint"
    )
    pos = 1 + (state_idx << 1)
    return verify_branch(
        finalized_block_root,
        update.finality_branch,
        pos,
        bytes(update.attested_header.state_root),
    )
