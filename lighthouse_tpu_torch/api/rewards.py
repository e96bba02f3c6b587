"""Beacon-API reward computations.

Parity surface:
  - lighthouse/beacon_node/http_api/src/standard_block_rewards.rs +
    beacon_chain/src/beacon_block_reward.rs (GET beacon/rewards/blocks)
  - beacon_chain/src/attestation_rewards.rs (POST beacon/rewards/attestations)
  - http_api/src/sync_committee_rewards.rs (POST beacon/rewards/sync_committee)

Block rewards are measured, not re-derived: each operation class is applied
to a clone of the pre-state and the proposer-balance delta read off — by
construction this agrees with the state transition for every fork.
"""

from __future__ import annotations

from ..state_transition import accessors as acc
from ..state_transition import epoch as ep
from ..state_transition.block import (
    _default_pubkey_getter,
    process_attestation,
    process_attester_slashing,
    process_proposer_slashing,
    process_sync_aggregate,
)
from ..state_transition.slot import process_slots, types_for_slot
from ..types.spec import ForkName
from ..types.state_util import clone_state


def _noop_handle(_s):
    return None


def compute_block_rewards(chain, block_root: bytes) -> dict:
    """StandardBlockReward for an imported block (all amounts in gwei)."""
    spec = chain.spec
    slot = chain.block_slots.get(block_root)
    if slot is None:
        raise KeyError("block not found")
    types = types_for_slot(spec, slot)
    signed = chain.store.get_block(block_root, types)
    if signed is None:
        raise KeyError("block not found")
    block = signed.message
    proposer = int(block.proposer_index)
    fork = spec.fork_name_at_slot(slot)

    state = chain._state_for_block(bytes(block.parent_root), slot)
    state = clone_state(state, spec)
    if state.slot < slot:
        process_slots(state, spec, slot)

    def bal() -> int:
        return int(state.balances[proposer])

    get_pubkey = _default_pubkey_getter(state)
    rewards = {}
    before = bal()
    for ps in block.body.proposer_slashings:
        process_proposer_slashing(
            state, spec, types, ps, fork, _noop_handle, get_pubkey
        )
    rewards["proposer_slashings"] = bal() - before

    before = bal()
    for asl in block.body.attester_slashings:
        process_attester_slashing(
            state, spec, types, asl, fork, _noop_handle, get_pubkey
        )
    rewards["attester_slashings"] = bal() - before

    before = bal()
    att_cache: dict = {}
    for att in block.body.attestations:
        process_attestation(
            state, spec, types, att, fork, _noop_handle, get_pubkey, att_cache
        )
    rewards["attestations"] = bal() - before

    rewards["sync_aggregate"] = 0
    if fork >= ForkName.altair:
        before = bal()
        process_sync_aggregate(state, spec, types, block, _noop_handle, get_pubkey)
        rewards["sync_aggregate"] = bal() - before

    total = (
        rewards["attestations"]
        + rewards["sync_aggregate"]
        + rewards["proposer_slashings"]
        + rewards["attester_slashings"]
    )
    return {
        "proposer_index": proposer,
        "total": total,
        "attestations": rewards["attestations"],
        "sync_aggregate": rewards["sync_aggregate"],
        "proposer_slashings": rewards["proposer_slashings"],
        "attester_slashings": rewards["attester_slashings"],
    }


def _canonical_state_at_slot(chain, slot: int):
    """Post-state of the canonical block at/below `slot`, advanced to
    `slot` — walks the head lineage so the answer is exact even when the
    head has moved far past it."""
    spec = chain.spec
    root = chain.head_root
    while chain.block_slots.get(root, 0) > slot:
        blk = chain.store.get_block(
            root, types_for_slot(spec, chain.block_slots[root])
        )
        if blk is None:
            raise KeyError(f"canonical chain walk broke at {root.hex()[:8]}")
        root = bytes(blk.message.parent_root)
    state_root = chain.state_root_by_block.get(root)
    if state_root is None or state_root not in chain.state_cache:
        raise KeyError(f"state at slot {slot} unavailable")
    state = clone_state(chain.state_cache[state_root], spec)
    if state.slot < slot:
        process_slots(state, spec, slot)
    return state


def compute_attestation_rewards(chain, epoch: int, validators: list | None) -> dict:
    """StandardAttestationRewards for `epoch` (altair+ accounting).

    Judged on the state at the END slot of epoch+1 (late attestations for
    `epoch` can land through all of epoch+1 — attestation_rewards.rs:44
    uses the same slot) — resolved from the canonical lineage, not the
    head, so the answer stays pinned to `epoch` as the chain advances."""
    spec = chain.spec
    sp_epoch = spec.preset.SLOTS_PER_EPOCH
    judge_slot = (epoch + 2) * sp_epoch - 1
    head = chain.head_state()
    if int(head.slot) < judge_slot:
        raise KeyError(f"epoch {epoch} not yet judgeable")
    state = _canonical_state_at_slot(chain, judge_slot)
    fork = spec.fork_name_at_slot(state.slot)
    if fork < ForkName.altair:
        raise ValueError("attestation rewards endpoint serves altair+ epochs")

    n = len(state.validators)
    per_flag = []
    for flag_index in range(len(acc.PARTICIPATION_FLAG_WEIGHTS)):
        per_flag.append(ep.get_flag_index_deltas(state, spec, flag_index, fork))
    inact_rw, inact_pen = ep.get_inactivity_penalty_deltas(state, spec, fork)

    # ideal rewards per effective-balance tier present in the registry
    base_per_incr = acc.get_base_reward_per_increment(state, spec)
    total_active = acc.get_total_active_balance(state, spec)
    incr = spec.effective_balance_increment
    leaking = acc.is_in_inactivity_leak(state, spec)
    prev = acc.get_previous_epoch(state, spec)
    flag_balances = [
        acc.get_total_balance(
            state, spec,
            acc.get_unslashed_participating_indices(state, spec, i, prev),
        )
        for i in range(len(acc.PARTICIPATION_FLAG_WEIGHTS))
    ]
    ideal = []
    for eff in sorted({int(v.effective_balance) for v in state.validators}):
        base_reward = (eff // incr) * base_per_incr
        row = {"effective_balance": eff, "head": 0, "target": 0, "source": 0,
               "inactivity": 0}
        for flag_index, name in ((0, "source"), (1, "target"), (2, "head")):
            if leaking:
                continue
            weight = acc.PARTICIPATION_FLAG_WEIGHTS[flag_index]
            num = base_reward * weight * (flag_balances[flag_index] // incr)
            row[name] = num // ((total_active // incr) * acc.WEIGHT_DENOMINATOR)
        ideal.append(row)

    wanted = None
    if validators:
        wanted = set()
        for v in validators:
            if isinstance(v, str) and v.startswith("0x"):
                pkb = bytes.fromhex(v[2:])
                for i, val in enumerate(state.validators):
                    if bytes(val.pubkey) == pkb:
                        wanted.add(i)
                        break
            else:
                wanted.add(int(v))
    eligible = set(ep._eligible_validator_indices(state, spec))
    total = []
    for i in range(n):
        if i not in eligible:
            continue
        if wanted is not None and i not in wanted:
            continue
        (src_r, src_p), (tgt_r, tgt_p), (head_r, _head_p) = (
            per_flag[0], per_flag[1], per_flag[2],
        )
        total.append(
            {
                "validator_index": i,
                "head": head_r[i],
                "target": tgt_r[i] - tgt_p[i],
                "source": src_r[i] - src_p[i],
                "inactivity": inact_rw[i] - inact_pen[i],
            }
        )
    return {"ideal_rewards": ideal, "total_rewards": total}


def compute_sync_committee_rewards(chain, block_root: bytes,
                                   validators: list | None) -> list[dict]:
    """Per-participant sync-committee rewards for one block
    (sync_committee_rewards.rs)."""
    spec = chain.spec
    slot = chain.block_slots.get(block_root)
    if slot is None:
        raise KeyError("block not found")
    types = types_for_slot(spec, slot)
    signed = chain.store.get_block(block_root, types)
    if signed is None:
        raise KeyError("block not found")
    fork = spec.fork_name_at_slot(slot)
    if fork < ForkName.altair:
        raise ValueError("no sync committee before altair")

    state = chain._state_for_block(bytes(signed.message.parent_root), slot)
    state = clone_state(state, spec)
    if state.slot < slot:
        process_slots(state, spec, slot)

    # participant reward exactly as process_sync_aggregate computes it
    total_active = acc.get_total_active_balance(state, spec)
    incr = spec.effective_balance_increment
    base_per_incr = acc.get_base_reward_per_increment(state, spec)
    total_base_rewards = base_per_incr * (total_active // incr)
    max_participant_rewards = (
        total_base_rewards
        * acc.SYNC_REWARD_WEIGHT
        // acc.WEIGHT_DENOMINATOR
        // spec.preset.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // spec.preset.SYNC_COMMITTEE_SIZE

    index_by_pk = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    committee = [
        index_by_pk.get(bytes(pk)) for pk in state.current_sync_committee.pubkeys
    ]
    bits = list(signed.message.body.sync_aggregate.sync_committee_bits)
    wanted = {int(v) for v in validators} if validators else None
    out = []
    for pos, vidx in enumerate(committee):
        if vidx is None:
            continue
        if wanted is not None and vidx not in wanted:
            continue
        out.append(
            {
                "validator_index": vidx,
                "reward": participant_reward if bits[pos] else -participant_reward,
            }
        )
    return out
