"""Genesis state construction (interop + from-deposits).

Parity surface: lighthouse/beacon_node/genesis/ plus the interop
genesis the testing harness uses (deterministic keypairs, pre-activated
validators — common/eth2_interop_keypairs + BeaconChainHarness defaults).
"""

from __future__ import annotations

from ..crypto import bls
from ..types import helpers as h
from ..types.spec import ChainSpec, ForkName, FAR_FUTURE_EPOCH
from ..types.containers import spec_types
from . import accessors as acc
from .epoch import get_next_sync_committee
from .slot import upgrade_state


def bls_withdrawal_credentials(pubkey_bytes: bytes) -> bytes:
    return b"\x00" + h.sha256(pubkey_bytes)[1:]


# The interop genesis state is a pure function of (spec, keypairs,
# genesis_time, eth1 hash) and hashing the validator registry is expensive —
# memoize and hand out deep copies (tests build the same 64-validator
# minimal-preset genesis dozens of times).
_genesis_cache: dict = {}


def interop_genesis_state(
    keypairs: list[bls.Keypair],
    genesis_time: int,
    spec: ChainSpec,
    eth1_block_hash: bytes = b"\x42" * 32,
):
    from ..types.state_util import clone_state

    key = (repr(spec), len(keypairs), genesis_time, eth1_block_hash)
    hit = _genesis_cache.get(key)
    if hit is not None and hit[1] == [kp.pk.serialize() for kp in keypairs]:
        return clone_state(hit[0], spec)
    state = _interop_genesis_state(keypairs, genesis_time, spec, eth1_block_hash)
    _genesis_cache[key] = (
        clone_state(state, spec),
        [kp.pk.serialize() for kp in keypairs],
    )
    return state


def _interop_genesis_state(
    keypairs: list[bls.Keypair],
    genesis_time: int,
    spec: ChainSpec,
    eth1_block_hash: bytes = b"\x42" * 32,
):
    """Deterministic pre-activated genesis state at the spec's genesis fork."""
    fork = spec.fork_name_at_epoch(0)
    types = spec_types(spec.preset, ForkName.phase0)

    state = types.BeaconState.default()
    state.genesis_time = genesis_time
    state.fork = types.Fork.make(
        previous_version=spec.genesis_fork_version,
        current_version=spec.genesis_fork_version,
        epoch=0,
    )
    state.eth1_data = types.Eth1Data.make(
        deposit_root=b"\x00" * 32,
        deposit_count=len(keypairs),
        block_hash=eth1_block_hash,
    )
    state.eth1_deposit_index = len(keypairs)
    # The genesis header commits to the GENESIS FORK's empty body (a chain
    # starting at deneb has a deneb body_root here, exactly like the spec's
    # initialize_beacon_state_from_eth1 instantiated at that fork) — this
    # keeps hash(genesis block) == hash(header), which backfill relies on.
    genesis_types = spec_types(spec.preset, fork)
    body = genesis_types.BeaconBlockBody.default()
    state.latest_block_header = types.BeaconBlockHeader.make(
        slot=0,
        proposer_index=0,
        parent_root=b"\x00" * 32,
        state_root=b"\x00" * 32,
        body_root=genesis_types.BeaconBlockBody.hash_tree_root(body),
    )
    state.randao_mixes = [eth1_block_hash] * spec.preset.EPOCHS_PER_HISTORICAL_VECTOR

    for kp in keypairs:
        pk_bytes = kp.pk.serialize()
        state.validators.append(
            types.Validator.make(
                pubkey=pk_bytes,
                withdrawal_credentials=bls_withdrawal_credentials(pk_bytes),
                effective_balance=spec.max_effective_balance,
                slashed=False,
                activation_eligibility_epoch=0,
                activation_epoch=0,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH,
            )
        )
        state.balances.append(spec.max_effective_balance)

    state.genesis_validators_root = _validators_root(state, types, spec)

    if fork != ForkName.phase0:
        upgrade_state(state, spec, ForkName.phase0, fork)
        # genesis fork versions: previous == current at genesis
        ftypes = spec_types(spec.preset, fork)
        state.fork = ftypes.Fork.make(
            previous_version=spec.fork_version(fork),
            current_version=spec.fork_version(fork),
            epoch=0,
        )
    return state


def _validators_root(state, types, spec: ChainSpec) -> bytes:
    from ..ssz.core import List as SSZList

    reg = SSZList(types.Validator, spec.preset.VALIDATOR_REGISTRY_LIMIT)
    return reg.hash_tree_root(state.validators)


# ------------------------------------------------- genesis from deposits


def initialize_beacon_state_from_eth1(
    spec: ChainSpec,
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits,
):
    """The spec's initialize_beacon_state_from_eth1: build a candidate
    genesis state by processing real deposit-contract deposits (the
    production genesis path the interop shortcut skips —
    lighthouse/beacon_node/genesis/src/lib.rs). `deposits` are
    types.Deposit values with proofs against the progressively-growing
    deposit tree (eth1.DepositTree.proof provides them)."""
    from .block import apply_deposit
    from ..chain.eth1 import DepositTree

    fork = spec.fork_name_at_epoch(0)
    types = spec_types(spec.preset, ForkName.phase0)
    state = types.BeaconState.default()
    state.genesis_time = eth1_timestamp + spec.genesis_delay
    state.fork = types.Fork.make(
        previous_version=spec.genesis_fork_version,
        current_version=spec.genesis_fork_version,
        epoch=0,
    )
    state.eth1_data = types.Eth1Data.make(
        deposit_root=b"\x00" * 32,
        deposit_count=len(deposits),
        block_hash=eth1_block_hash,
    )
    genesis_types = spec_types(spec.preset, fork)
    body = genesis_types.BeaconBlockBody.default()
    state.latest_block_header = types.BeaconBlockHeader.make(
        slot=0, proposer_index=0, parent_root=b"\x00" * 32,
        state_root=b"\x00" * 32,
        body_root=genesis_types.BeaconBlockBody.hash_tree_root(body),
    )
    state.randao_mixes = [eth1_block_hash] * spec.preset.EPOCHS_PER_HISTORICAL_VECTOR

    # process deposits against the incrementally-updated deposit root
    tree = DepositTree()
    for dep in deposits:
        tree.push(types.DepositData.hash_tree_root(dep.data))
    for i, dep in enumerate(deposits):
        state.eth1_data = state.eth1_data.copy_with(
            deposit_root=tree.root(count=i + 1)
        )
        # apply_deposit checks the signature for new keys and tops up
        # existing ones (the genesis path skips per-deposit merkle proofs:
        # each proof is against its own prefix tree, which the incremental
        # eth1_data.deposit_root above already pins)
        apply_deposit(state, spec, types, dep.data, ForkName.phase0)
        state.eth1_deposit_index = i + 1
    state.eth1_data = state.eth1_data.copy_with(deposit_root=tree.root())

    # activate validators with full effective balance
    for i, v in enumerate(state.validators):
        eff = min(
            state.balances[i] - state.balances[i] % spec.effective_balance_increment,
            spec.max_effective_balance,
        )
        upd = {"effective_balance": eff}
        if eff == spec.max_effective_balance:
            upd["activation_eligibility_epoch"] = 0
            upd["activation_epoch"] = 0
        state.validators[i] = v.copy_with(**upd)

    state.genesis_validators_root = _validators_root(state, types, spec)
    if fork != ForkName.phase0:
        upgrade_state(state, spec, ForkName.phase0, fork)
        ftypes = spec_types(spec.preset, fork)
        state.fork = ftypes.Fork.make(
            previous_version=spec.fork_version(fork),
            current_version=spec.fork_version(fork),
            epoch=0,
        )
    return state


def is_valid_genesis_state(state, spec: ChainSpec) -> bool:
    """The spec's genesis trigger (eth1_genesis_service.rs polls this)."""
    if state.genesis_time < spec.min_genesis_time:
        return False
    active = len(h.get_active_validator_indices(state, 0))
    return active >= spec.min_genesis_active_validator_count


class Eth1GenesisService:
    """Poll an eth1 cache until enough deposits trigger genesis
    (lighthouse/beacon_node/genesis/src/eth1_genesis_service.rs:1).
    Feed it the Eth1Service's cache; `try_genesis` returns the genesis
    state once the trigger conditions hold, else None."""

    def __init__(self, eth1_cache, spec: ChainSpec):
        self.cache = eth1_cache
        self.spec = spec
        self.attempts = 0

    def try_genesis(self):
        self.attempts += 1
        spec = self.spec
        types = spec_types(spec.preset, ForkName.phase0)
        for block in self.cache.blocks:
            if block.deposit_count < spec.min_genesis_active_validator_count:
                continue
            deposits = [
                types.Deposit.make(
                    proof=self.cache.tree.proof(i, count=block.deposit_count),
                    data=self.cache.deposits[i],
                )
                for i in range(block.deposit_count)
            ]
            state = initialize_beacon_state_from_eth1(
                spec, block.hash, block.timestamp, deposits
            )
            if is_valid_genesis_state(state, spec):
                return state
        return None
