"""The port's operation pool and execution modules (chain/op_pool.py,
execution/block_hash.py, chain/execution_layer.py) on the CPU against the
JAX package's.

- the op pool on the same minimal-spec state, built field by field on both
  sides: max_cover on tests/test_op_pool.py's cases and on seeded random
  covers; inserts, the supersede of a covered aggregate, packing
  (get_attestations_for_block) and get_slashings_and_exits over includable
  and spent slashings, exits and BLS changes, and prune: the same
  SSZ bytes; persist writes the same bytes on both sides, and the port
  restores the JAX package's persisted pool to the same contents;
- keccak256, rlp_encode, ordered_trie_root and compute_block_hash on
  tests/test_execution.py's inputs and seeded ones: byte-equal;
- ExecutionLayer over MockExecutionLayer: payload production, import with
  and without the local block-hash check, a forced INVALID and an unknown
  parent: the same JSON and the same statuses.

Tolerance: exact. No JAX compile.
"""

import importlib
import random
import types as pytypes

import pytest

PACKAGES = ("lighthouse_tpu", "lighthouse_tpu_torch")
MODULES = {"op": "chain.op_pool", "el": "chain.execution_layer", "bh": "execution.block_hash",
           "api": "execution.engine_api", "acc": "state_transition.accessors",
           "c": "types.containers", "spec": "types.spec", "hc": "store.hot_cold",
           "h": "types.helpers"}
FAR = 2**64 - 1


def mods(package: str):
    m = pytypes.SimpleNamespace(
        **{k: importlib.import_module(f"{package}.{v}") for k, v in MODULES.items()})
    m.chain_spec = m.spec.minimal_spec()
    m.types = m.c.spec_types(m.spec.MINIMAL_PRESET, m.spec.ForkName.deneb)
    return m


def on_both(step):
    """step(m) on the JAX package, then on the port; the results must be equal."""
    want, got = (step(mods(p)) for p in PACKAGES)
    assert got == want
    return got


# ---------------------------------------------------------------- op pool


def test_max_cover_matches_jax():
    rng = random.Random(0x0BB1)
    cases = [([(frozenset({1, 2, 3}), 1.0, "a"), (frozenset({3, 4}), 1.0, "b"),
               (frozenset({4, 5, 6, 7}), 1.0, "c")], 3),
             ([(frozenset({i}), 1.0, i) for i in range(10)], 4)]
    for k in range(6):
        items = [(frozenset(rng.sample(range(64), rng.randrange(1, 12))),
                  rng.choice((1.0, 2.0, 0.5)), f"{k}:{i}") for i in range(40)]
        cases.append((items, rng.choice((1, 8, 128))))
    got = on_both(lambda m: [m.op.max_cover(items, limit) for items, limit in cases])
    assert got[0] == ["c", "a"] and len(got[1]) == 4


def att(m, bits, slot=9, index=0, target_epoch=1, source_root=b"\x02" * 32):
    t = m.types
    data = t.AttestationData.make(
        slot=slot, index=index, beacon_block_root=b"\x01" * 32,
        source=t.Checkpoint.make(epoch=0, root=source_root),
        target=t.Checkpoint.make(epoch=target_epoch, root=b"\x03" * 32))
    return t.Attestation.make(aggregation_bits=bits, data=data,
                              signature=bytes([slot % 251]) * 96)


def pool_state(m, n=12):
    """A deneb state on the minimal spec at an epoch past the exits' shard
    committee period: validators active from epoch 0, 2 and 9 slashed, 10
    not yet active, 0 and 1 with 0x00 credentials (0 matching its BLS
    change's key), 3 with target participation."""
    spec, t = m.chain_spec, m.types
    st = t.BeaconState.default()
    epoch = spec.shard_committee_period + 1
    st.slot = epoch * spec.preset.SLOTS_PER_EPOCH + 2
    vals = []
    for i in range(n):
        creds = b"\x00" + m.h.sha256(bytes([i]) * 48)[1:] if i < 2 else b"\x01" + b"\x00" * 31
        vals.append(t.Validator.make(
            pubkey=bytes([i]) * 48, withdrawal_credentials=creds,
            effective_balance=32 * 10**9, slashed=i in (2, 9),
            activation_eligibility_epoch=0, activation_epoch=epoch + 4 if i == 10 else 0,
            exit_epoch=FAR, withdrawable_epoch=FAR))
    st.validators = vals
    st.balances = [32 * 10**9] * n
    st.current_epoch_participation = [0] * n
    st.previous_epoch_participation = [0] * n
    st.previous_epoch_participation[3] = m.acc.add_flag(0, m.acc.TIMELY_TARGET_FLAG_INDEX)
    st.current_justified_checkpoint = t.Checkpoint.make(epoch=0, root=b"\x02" * 32)
    st.previous_justified_checkpoint = t.Checkpoint.make(epoch=0, root=b"\x02" * 32)
    return st


def header(m, proposer, body=b"\x01"):
    t = m.types
    return t.SignedBeaconBlockHeader.make(
        message=t.BeaconBlockHeader.make(slot=1, proposer_index=proposer,
                                         parent_root=b"\x00" * 32, state_root=b"\x00" * 32,
                                         body_root=body * 32),
        signature=b"\x05" * 96)


def indexed(m, indices, root=b"\x03"):
    t = m.types
    data = t.AttestationData.make(
        slot=1, index=0, beacon_block_root=root * 32,
        source=t.Checkpoint.make(epoch=0, root=b"\x00" * 32),
        target=t.Checkpoint.make(epoch=0, root=root * 32))
    return t.IndexedAttestation.make(attesting_indices=indices, data=data,
                                     signature=b"\x06" * 96)


def fill_pool(m, pool):
    """The same operations on either side's pool, in the same order."""
    t = m.types
    epoch_slot = pool_state(m).slot
    cur = epoch_slot // m.chain_spec.preset.SLOTS_PER_EPOCH
    pool.insert_attestation(att(m, [True, False, False, False], slot=epoch_slot - 1,
                                target_epoch=cur), [10], t)
    pool.insert_attestation(att(m, [True, True, True, False], slot=epoch_slot - 1,
                                target_epoch=cur), [10, 11, 4], t)
    pool.insert_attestation(att(m, [True, False, False, False], slot=epoch_slot - 1,
                                target_epoch=cur), [10], t)          # covered: a no-op
    pool.insert_attestation(att(m, [True, True, False, False], index=1, slot=epoch_slot - 2,
                                target_epoch=cur), [2, 3], t)
    pool.insert_attestation(att(m, [False, False, True, True], index=2, slot=epoch_slot - 2,
                                target_epoch=cur), [5, 6], t)
    pool.insert_attestation(att(m, [True, True, True, True], index=3, slot=epoch_slot - 3,
                                target_epoch=cur, source_root=b"\x07" * 32), [7, 8, 0, 1], t)
    pool.insert_attestation(att(m, [True, False, False, False], slot=1, target_epoch=0),
                            [1], t)                                  # stale: pruned
    for proposer in (1, 2, 3):                                       # 2 is slashed
        pool.insert_proposer_slashing(t.ProposerSlashing.make(
            signed_header_1=header(m, proposer), signed_header_2=header(m, proposer, b"\x02")))
    for a, b in (([3, 4, 5], [4, 5, 6]), ([2, 9], [2, 9]), ([7], [8])):
        s = t.AttesterSlashing.make(attestation_1=indexed(m, a), attestation_2=indexed(m, b,
                                                                                       b"\x04"))
        pool.insert_attester_slashing(s)
        pool.insert_attester_slashing(s)                             # deduped by content
    for vi, ep in ((6, 0), (10, 0), (11, 10**6)):
        pool.insert_voluntary_exit(t.SignedVoluntaryExit.make(
            message=t.VoluntaryExit.make(epoch=ep, validator_index=vi), signature=b"\x0a" * 96))
    for vi, key in ((0, bytes([0]) * 48), (1, b"\xee" * 48), (5, bytes([5]) * 48),
                    (50, b"\x00" * 48)):
        pool.insert_bls_change(t.SignedBLSToExecutionChange.make(
            message=t.BLSToExecutionChange.make(validator_index=vi, from_bls_pubkey=key,
                                                to_execution_address=b"\x0c" * 20),
            signature=b"\x0d" * 96))


def pool_view(m, pool):
    """Everything a pool holds, as bytes."""
    t = m.types
    return (sorted((k, [(list(e.aggregation_bits), e.signature, sorted(e.attesting_indices))
                        for e in bucket]) for k, bucket in pool.attestations.items()),
            sorted(t.ProposerSlashing.serialize(s) for s in pool.proposer_slashings.values()),
            [t.AttesterSlashing.serialize(s) for s in pool.attester_slashings],
            sorted(t.SignedVoluntaryExit.serialize(e) for e in pool.voluntary_exits.values()),
            sorted(t.SignedBLSToExecutionChange.serialize(c) for c in pool.bls_changes.values()))


def test_packing_slashings_exits_and_prune_match_jax():
    def step(m):
        t = m.types
        pool = m.op.OperationPool(m.chain_spec)
        fill_pool(m, pool)
        st = pool_state(m)
        held = pool_view(m, pool)
        packed = [t.Attestation.serialize(a) for a in pool.get_attestations_for_block(st, t)]
        ps, asl, exits, changes = pool.get_slashings_and_exits(st, t)
        ops = ([t.ProposerSlashing.serialize(s) for s in ps],
               [t.AttesterSlashing.serialize(s) for s in asl],
               [t.SignedVoluntaryExit.serialize(e) for e in exits],
               [t.SignedBLSToExecutionChange.serialize(c) for c in changes])
        pool.prune(st)
        return held, packed, ops, pool_view(m, pool)

    held, packed, (ps, asl, exits, changes), pruned = on_both(step)
    assert len(packed) == 3 and (len(ps), len(asl), len(exits), len(changes)) == (2, 1, 1, 1)
    assert len(pruned[0]) == len(held[0]) - 1


def test_persist_and_restore_match_jax():
    """Both packages persist the same bytes; the port restores the JAX
    package's persisted pool to the same contents."""
    persisted, views = [], []
    for package in PACKAGES:
        m = mods(package)
        pool = m.op.OperationPool(m.chain_spec)
        fill_pool(m, pool)
        store = m.hc.HotColdDB(m.chain_spec)
        pool.persist(store, m.types)
        persisted.append(store.get_chain_item(m.op.OperationPool.OP_POOL_KEY))
        views.append(pool_view(m, pool))
    assert persisted[1] == persisted[0] and views[1] == views[0]
    m = mods("lighthouse_tpu_torch")
    store = m.hc.HotColdDB(m.chain_spec)
    store.put_chain_item(m.op.OperationPool.OP_POOL_KEY, persisted[0])
    restored = m.op.OperationPool.load(store, m.chain_spec, m.types)
    assert pool_view(m, restored) == views[0]
    empty = m.op.OperationPool.load(m.hc.HotColdDB(m.chain_spec), m.chain_spec, m.types)
    assert not empty.attestations and not empty.voluntary_exits


# -------------------------------------------------------------- execution


def test_keccak_rlp_and_trie_roots_match_jax():
    rng = random.Random(0xEC)
    blobs = [b"", b"abc", b"\x00", b"\x7f", b"\x80", b"dog"] + [b"a" * n for n in (
        55, 56, 134, 135, 136, 137, 271, 272, 1000)]
    blobs += [rng.randbytes(rng.randrange(0, 600)) for _ in range(20)]
    items = [b"", b"\x00", b"\x7f", b"\x80", b"dog", [b"cat", b"dog"], [], 0, 15, 1024,
             b"Lorem ipsum dolor sit amet, consectetur adipisicing elit", [[], [[]], [[], [[]]]],
             [b"x" * 60, [b"y" * 3, 2**64 - 1]]]
    tries = [[], [b"\x01" * 40], [b"\x11" * 40, b"\x22" * 40], [b"\x22" * 40, b"\x11" * 40]]
    tries += [[rng.randbytes(rng.randrange(1, 90)) for _ in range(k)] for k in (3, 17, 130)]

    def step(m):
        return ([m.bh.keccak256(b) for b in blobs], [m.bh.rlp_encode(x) for x in items],
                [m.bh.ordered_trie_root(v) for v in tries], m.bh.EMPTY_TRIE_ROOT)

    keccaks, _rlp, roots, empty = on_both(step)
    assert keccaks[0].hex().startswith("c5d2460186f7") and roots[0] == empty


def payload(m, **over):
    t = m.types
    fields = dict(
        parent_hash=b"\x01" * 32, fee_recipient=b"\x02" * 20, state_root=b"\x03" * 32,
        receipts_root=b"\x04" * 32, logs_bloom=b"\x00" * 256, prev_randao=b"\x05" * 32,
        block_number=7, gas_limit=30_000_000, gas_used=21_000, timestamp=12_345,
        extra_data=b"geth", base_fee_per_gas=7, block_hash=b"\x00" * 32,
        transactions=[b"\xf8\x6b" + b"\x01" * 40],
        withdrawals=[t.Withdrawal.make(index=0, validator_index=3, address=b"\x09" * 20,
                                       amount=10)],
        blob_gas_used=0, excess_blob_gas=0)
    fields.update(over)
    return t.ExecutionPayload.make(**fields)


def test_block_hash_matches_jax():
    def step(m):
        out = []
        for over in ({}, {"gas_used": 22_000}, {"transactions": []}, {"withdrawals": []},
                     {"extra_data": b"", "base_fee_per_gas": 2**200},
                     {"transactions": [bytes([i]) * (i + 1) for i in range(20)]}):
            p = payload(m, **over)
            for root in (b"\x0b" * 32, None):
                h = m.bh.compute_block_hash(p, root)
                good = p.copy_with(block_hash=h)
                out.append((h, m.bh.verify_payload_block_hash(good, root),
                            m.bh.verify_payload_block_hash(good, b"\x0c" * 32)))
        return out

    got = on_both(step)
    assert got[0][1] is True and got[0][2] is False


def test_execution_layer_over_mock_el_matches_jax():
    def step(m):
        t = m.types
        mock = m.api.MockExecutionLayer()
        el = m.el.ExecutionLayer(mock, m.chain_spec, default_fee_recipient=b"\x0f" * 20)
        genesis = b"\x00" * 32
        w = [t.Withdrawal.make(index=1, validator_index=2, address=b"\x03" * 20, amount=4)]
        p1, bundle = el.produce_payload(t, genesis, genesis, genesis, timestamp=12,
                                        prev_randao=b"\x05" * 32, withdrawals=w,
                                        parent_beacon_block_root=b"\x06" * 32)
        j1 = m.el.payload_to_json(p1)
        back = t.ExecutionPayload.serialize(m.el.payload_from_json(t, j1))
        statuses = [el.notify_new_payload(p1, b"\x06" * 32, kzg_commitments=[b"\x07" * 48])]
        orphan = p1.copy_with(parent_hash=b"\x99" * 32, block_hash=b"\x98" * 32)
        statuses.append(el.notify_new_payload(orphan))
        mock.invalid_hashes.add(bytes(p1.block_hash))
        statuses.append(el.notify_new_payload(p1))
        checked = m.el.ExecutionLayer(m.api.MockExecutionLayer(), m.chain_spec,
                                      verify_block_hashes=True)
        good = payload(m)
        good = good.copy_with(block_hash=m.bh.compute_block_hash(good, b"\x0b" * 32))
        statuses += [checked.notify_new_payload(good, b"\x0b" * 32),
                     checked.notify_new_payload(good.copy_with(gas_used=1), b"\x0b" * 32)]
        fcu = el.notify_forkchoice_updated(bytes(p1.block_hash), genesis, genesis)
        return (j1, back, bundle, statuses, fcu, el.new_payloads, el.forkchoice_updates,
                el.payloads_built, checked.new_payloads)

    j1, _back, _bundle, statuses, *_ = on_both(step)
    assert statuses[0] == "VALID" and statuses[2] == "INVALID" and statuses[-1] == "INVALID"
    assert j1["withdrawals"] and j1["timestamp"] == "0xc"


@pytest.mark.parametrize("n", [0, 1, 31])
def test_add_flag_and_participation_helpers_agree(n):
    """The packing's weights read participation flags: the accessors the
    pool calls give the same flags on both sides."""
    got = on_both(lambda m: [m.acc.add_flag(n, f) for f in range(3)]
                  + [m.acc.has_flag(m.acc.add_flag(n, f), f) for f in range(3)])
    assert all(got[3:])
