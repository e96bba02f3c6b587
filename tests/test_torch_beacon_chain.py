"""The port's BeaconChain (chain/beacon_chain.py with its caches, pubkey
cache, naive aggregation, validator monitor, DA checker and the hot/cold
store) on the CPU against the JAX package's.

- tests/test_beacon_chain.py's sequence, run in step on both chains over
  the same 64 interop validators on "fake" BLS (the reference's harness
  and the port's, its keys carried across): imports, a duplicate, a future
  block and a bad signature, a chain segment, the attestation gossip batch
  with its dedup, the fork revert, the state-advance timer, persist and
  resume: the same head roots, state roots, BlockError messages and
  verdicts, and every store column equal after persist;
- tests/test_data_availability.py's deneb import that gossip blob sidecars
  gate (N_FE = 8 field elements a blob, its insecure dev setup; KZG on the
  host lanes under "fake"): the same sidecars, head, held block and
  rejections;
- the slice on "torch" on the CPU (TorchBackend(device="cpu"), the plain
  kernel lanes, the "device" hash backend on the engine's plain versions)
  against the reference on "python", with real signatures: a chain
  started from a checkpoint backfills a segment of blocks in one batch,
  with the same verdict, head and stored blocks.

Tolerance: exact everywhere (roots, bytes, messages, verdicts). No JAX
compile: the reference runs "fake" or "python" BLS and its host hash lane.
"""

import dataclasses
import importlib

import pytest

from lighthouse_tpu.chain import beacon_chain as _jbc  # noqa: F401
from lighthouse_tpu.chain import data_availability as _jda  # noqa: F401
from lighthouse_tpu.crypto import bls as jbls

VALIDATORS = 64
N_FE = 8                      # field elements per blob (the reference's dev setup)
TORCH_VALIDATORS = 16

MODULES = {"bc": "chain.beacon_chain", "da": "chain.data_availability", "bls": "crypto.bls",
           "kzg": "crypto.kzg", "serde": "crypto.bls381.serde", "hm": "testing.harness",
           "slot": "state_transition.slot", "acc": "state_transition.accessors",
           "h": "types.helpers", "spec": "types.spec", "kv": "store.kv"}


class Side:
    """One package's chain and harness, and the modules a step needs."""

    def __init__(self, package: str):
        for name, mod in MODULES.items():
            setattr(self, name, importlib.import_module(f"{package}.{mod}"))
        self.harness = self.chain = None

    @property
    def spec_(self):
        return self.harness.spec

    def clone(self, state):
        return self.hm.clone_state(state, self.spec_)

    def types(self, slot):
        return self.slot.types_for_slot(self.spec_, slot)


# the port loads when this file's first test runs, not at collection
carry = router = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global carry, router
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.testing import carry
    from lighthouse_tpu_torch.torchhash import router

    prev_hash, prev = router._state["backend"], bls.api._active_backend
    router.set_hash_backend("host")
    jprev = jbls.get_backend().name
    yield
    router.set_hash_backend(prev_hash)
    bls.api._active_backend = prev
    jbls.set_backend(jprev)


def new_sides(n, preset_overrides=None, kzg=False, backend="fake"):
    """The reference's and the port's harness and chain at genesis over the
    same n interop keys, on `backend` BLS."""
    out = []
    jkeys = jbls.interop_keypairs(n)
    for kp in jkeys:                        # interned, as a node's registry is
        kp.pk.serialize()
    for package in ("lighthouse_tpu", "lighthouse_tpu_torch"):
        s = Side(package)
        s.bls.set_backend(backend)
        preset = s.spec.MINIMAL_PRESET
        if preset_overrides:
            preset = dataclasses.replace(preset, **preset_overrides)
        spec = s.spec.minimal_spec(preset=preset)
        keys = jkeys if package == "lighthouse_tpu" else carry.carry_keypairs(jkeys)
        s.harness = s.hm.StateHarness(spec=spec, keypairs=keys)
        s.setup = s.kzg.TrustedSetup.insecure_dev_setup(N_FE) if kzg else None
        s.chain = s.bc.BeaconChain(spec, s.clone(s.harness.state), kzg_setup=s.setup)
        out.append(s)
    return out


@pytest.fixture(scope="module")
def sides():
    return new_sides(VALIDATORS)


def both(sides, step):
    """step(side) on the reference, then on the port."""
    return [step(s) for s in sides]


def same(sides, step):
    """step(side) on both sides; the two results must be equal."""
    want, got = both(sides, step)
    assert got == want
    return got


def outcome(fn):
    """fn()'s value, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the verdict is the result
        return (type(e).__name__, str(e))


def produce(s, attestations=()):
    slot = s.harness.state.slot + 1
    signed, _post = s.harness.produce_block(slot, attestations=list(attestations),
                                            full_sync=False)
    return slot, signed


def produce_and_import(s, n, gossip=True):
    roots = []
    for _ in range(n):
        slot, signed = produce(s)
        s.harness.apply_block(signed)
        s.chain.slot_clock.set_slot(slot)
        s.chain.per_slot_task()
        if gossip:
            root = s.chain.verify_block_for_gossip(signed)
            s.chain.process_block(signed, block_root=root, proposal_already_verified=True)
        else:
            root = s.chain.process_block(signed)
        roots.append(root)
    return roots


def head_view(s):
    st = s.chain.head_state()
    return (s.chain.head_root, int(st.slot),
            s.types(st.slot).BeaconState.hash_tree_root(st), s.chain.fork_choice.get_head())


def test_import_blocks_and_head_match_jax(sides):
    roots = same(sides, lambda s: produce_and_import(s, 3))
    assert same(sides, head_view)[0] == roots[-1]


def test_duplicate_block_rejected_as_jax(sides):
    def step(s):
        slot, signed = produce(s)
        s.harness.apply_block(signed)
        s.chain.slot_clock.set_slot(slot)
        s.chain.per_slot_task()
        root = s.chain.verify_block_for_gossip(signed)
        s.chain.process_block(signed, block_root=root, proposal_already_verified=True)
        return root, outcome(lambda: s.chain.verify_block_for_gossip(signed))

    _root, verdict = same(sides, step)
    assert verdict == ("BlockError", "block already known")
    same(sides, head_view)


def test_future_block_rejected_as_jax(sides):
    def step(s):
        slot, signed = produce(s)
        early = outcome(lambda: s.chain.verify_block_for_gossip(signed))   # the clock not moved
        s.harness.apply_block(signed)
        s.chain.slot_clock.set_slot(slot)
        s.chain.per_slot_task()
        return early, s.chain.process_block(signed)

    early, _root = same(sides, step)
    assert early[0] == "BlockError" and early[1].startswith("future block")


def test_bad_signature_rejected_as_jax(sides):
    def step(s):
        slot, signed = produce(s)
        bad = signed.copy_with(signature=b"\xbb" + bytes(signed.signature)[1:])
        s.chain.slot_clock.set_slot(slot)
        s.chain.per_slot_task()
        verdict = outcome(lambda: s.chain.verify_block_for_gossip(bad))
        s.harness.apply_block(signed)
        return verdict, s.chain.process_block(signed)

    verdict, _root = same(sides, step)
    assert verdict[0] == "BlockError"
    same(sides, head_view)


def test_chain_segment_matches_jax(sides):
    def step(s):
        blocks = []
        for _ in range(4):
            _slot, signed = produce(s)
            s.harness.apply_block(signed)
            blocks.append(signed)
        s.chain.slot_clock.set_slot(s.harness.state.slot)
        s.chain.per_slot_task()
        return s.chain.process_chain_segment(blocks)

    roots = same(sides, step)
    assert len(roots) == 4 and same(sides, head_view)[0] == roots[-1]


def singles_for(s, slot, head_root):
    """One single-bit attestation per member of the slot's committees, each
    signed by its member (the reference test's singles)."""
    types = s.types(slot)
    atts = s.harness.build_attestations(s.clone(s.harness.state), slot, head_root)
    st = s.clone(s.harness.state)
    epoch = s.acc.get_current_epoch(st, s.spec_)
    cache = s.acc.build_committee_cache(st, s.spec_, epoch)
    domain = s.h.get_domain(st, s.spec_, s.spec.DOMAIN_BEACON_ATTESTER, epoch)
    out = []
    for index in range(cache.committees_per_slot):
        committee = cache.committee(slot, index)
        data = atts[index].data
        root = s.h.compute_signing_root(types.AttestationData, data, domain)
        for pos, vi in enumerate(committee):
            sig = s.bls.sign(s.harness.sk(vi), root)
            out.append(types.Attestation.make(
                aggregation_bits=[i == pos for i in range(len(committee))], data=data,
                signature=sig.serialize()))
    return out


def test_attestation_gossip_batch_matches_jax(sides):
    def step(s):
        slot, signed = produce(s)
        s.harness.apply_block(signed)
        s.chain.slot_clock.set_slot(slot)
        s.chain.per_slot_task()
        root = s.chain.process_block(signed)
        types = s.types(slot)
        singles = singles_for(s, slot, root)
        verified = s.chain.verify_unaggregated_attestations(singles)
        for att, indices in verified:
            s.chain.apply_attestation_to_fork_choice(att, indices)
        again = s.chain.verify_unaggregated_attestations(singles)
        pool = s.chain.naive_attestation_pool
        datas = {types.AttestationData.hash_tree_root(a.data) for a in singles}
        aggregates = [types.Attestation.serialize(pool.get_aggregate(slot, d, types))
                      for d in sorted(datas)]
        return (len(singles), [(types.Attestation.hash_tree_root(a), list(i)) for a, i in verified],
                again, sorted(s.chain.observed_attesters), aggregates)

    n, verified, again, observed, aggregates = same(sides, step)
    assert n == len(verified) == len(observed) > 0 and again == [] and aggregates


def test_fork_revert_matches_jax(sides):
    def step(s):
        produce_and_import(s, 2)
        head_before = s.chain.head_root
        head_slot = s.chain.head_state().slot
        new_head = s.chain.revert_to_fork_boundary(head_before)
        reverted = (new_head, head_before in s.chain.block_slots,
                    s.chain.store.block_exists(head_before), int(s.chain.head_state().slot))
        # the chain goes on from its reverted head: its own produce_block
        slot = s.chain.head_state().slot + 2
        s.chain.slot_clock.set_slot(slot)
        s.chain.per_slot_task()
        st = s.clone(s.chain.head_state())
        s.slot.process_slots(st, s.spec_, slot)
        proposer = s.acc.get_beacon_proposer_index(st, s.spec_)
        reveal = s.harness.randao_reveal(st, proposer, slot // s.spec_.preset.SLOTS_PER_EPOCH)
        block = s.chain.produce_block(slot, reveal)
        root = s.chain.process_block(s.harness.sign_block(block, s.types(slot)))
        return head_before, head_slot, reverted, root, s.chain.head_root

    head_before, head_slot, (new_head, kept, stored, slot), root, head = same(sides, step)
    assert new_head != head_before and not kept and not stored and slot == head_slot - 1
    assert head == root
    # the harness got ahead of the reverted chain: both rejoin at the chain's head
    for s in sides:
        s.harness.state = s.clone(s.chain.head_state())


def test_state_advance_timer_matches_jax(sides):
    def step(s):
        head = s.chain.head_root
        first, second = s.chain.advance_head_state(), s.chain.advance_head_state()
        adv = s.chain._advanced[head]
        got = s.chain._state_for_block(head, int(adv.slot))
        return (first, second, int(adv.slot), s.chain.current_slot,
                s.types(adv.slot).BeaconState.hash_tree_root(got))

    first, second, adv_slot, current, _root = same(sides, step)
    assert first is True and second is False and adv_slot == current + 1


def test_persist_and_resume_match_jax(sides):
    def columns(s):
        return {c.value: sorted(s.chain.store.hot.iter_column(c)) for c in s.kv.Column}

    def step(s):
        produce_and_import(s, 1)
        s.chain.persist()
        resumed = s.bc.BeaconChain.resume(s.spec_, s.chain.store)
        restarted = s.bc.BeaconChain.from_store(s.spec_, s.chain.store)
        return (columns(s), s.chain.head_root, resumed.head_root, restarted.head_root,
                sorted(resumed.block_slots.items()), len(resumed.pubkey_cache))

    cols, head, resumed, restarted, slots, n = same(sides, step)
    assert head == resumed == restarted and n == VALIDATORS and cols["bch"]


# ------------------------------------------------------- data availability


@pytest.fixture(scope="module")
def da_sides():
    return new_sides(VALIDATORS, {"FIELD_ELEMENTS_PER_BLOB": N_FE}, kzg=True)


def blob_block(s, n_blobs):
    """The reference test's _blob_block: a block of n_blobs commitments
    produced by the chain, signed by the harness, and its sidecars."""
    spec = s.spec_
    slot = s.harness.state.slot + 1
    types = s.types(slot)
    blobs = [b"".join((j + i + 1).to_bytes(32, "big") for j in range(N_FE))
             for i in range(n_blobs)]
    commitments = [s.serde.g1_compress(s.kzg.blob_to_kzg_commitment(b, s.setup)) for b in blobs]
    proofs = [s.serde.g1_compress(s.kzg.compute_blob_kzg_proof(b, c, s.setup))
              for b, c in zip(blobs, commitments)]
    state = s.clone(s.harness.state)
    s.slot.process_slots(state, spec, slot)
    proposer = s.acc.get_beacon_proposer_index(state, spec)
    reveal = s.harness.randao_reveal(state, proposer, slot // spec.preset.SLOTS_PER_EPOCH)
    s.chain.slot_clock.set_slot(slot)
    s.chain.per_slot_task()
    block = s.chain.produce_block(slot, reveal, blobs_bundle=(blobs, commitments, proofs))
    signed = s.harness.sign_block(block, types)
    return signed, s.da.build_sidecars(types, spec, signed, blobs, proofs)


def test_gossip_blobs_gate_the_deneb_import_as_jax(da_sides):
    def step(s):
        signed, sidecars = blob_block(s, 2)
        types = s.types(signed.message.slot)
        root = types.BeaconBlock.hash_tree_root(signed.message)
        serial = [types.BlobSidecar.serialize(sc) for sc in sidecars]
        inclusion = [s.da.verify_commitment_inclusion(types, s.spec_, sc) for sc in sidecars]
        gossip = [s.chain.process_gossip_blob(sc) for sc in sidecars]
        got = s.chain.process_block(signed)
        stored = [types.BlobSidecar.serialize(sc) for sc in s.chain.get_blobs(root)]
        s.harness.apply_block(signed)

        # the next block is held until its blob joins; its sidecar rejected
        # when tampered with, then accepted, then ignored as seen
        signed2, (sc,) = blob_block(s, 1)
        root2 = types.BeaconBlock.hash_tree_root(signed2.message)
        try:
            s.chain.process_block(signed2)
            held = None
        except s.da.AvailabilityPendingError as e:
            held = (e.block_root, list(e.missing))
        mismatched = outcome(lambda: s.chain.process_block(
            signed2, blobs=[sc.copy_with(kzg_commitment=b"\x02" * 48)]))
        bad_hdr = sc.signed_block_header.copy_with(signature=b"\x11" * 96)
        rejected = [outcome(lambda bad=bad: s.da.verify_blob_sidecar_for_gossip(s.chain, bad))
                    for bad in (sc.copy_with(kzg_proof=bytes(sc.kzg_commitment)),
                                sc.copy_with(index=100),
                                sc.copy_with(signed_block_header=bad_hdr))]
        join = s.chain.process_gossip_blob(sc)
        dedup = outcome(lambda: s.da.verify_blob_sidecar_for_gossip(s.chain, sc))
        s.harness.apply_block(signed2)
        return (root, serial, inclusion, gossip, got, stored, root2, held, mismatched, rejected,
                join, dedup, s.chain.head_root)

    (root, serial, inclusion, gossip, got, stored, root2, held, mismatched, rejected, join,
     dedup, head) = same(da_sides, step)
    assert all(inclusion) and gossip == [None, None] and got == root and stored == serial
    assert held == (root2, [0]) and join == root2 and head == root2
    assert mismatched[0] == "BlockError" and "match" in mismatched[1]
    assert [r[0] for r in rejected] == ["BlobError"] * 3 and "KZG" in rejected[0][1]
    assert dedup[0] == "BlobIgnoreError"


# ------------------------------------------------------------ on "torch"


def test_backfill_segment_on_torch_cpu_matches_jax_python(monkeypatch):
    """Three blocks with real signatures (the reference's harness on
    "python"); both chains start from a checkpoint at the third and
    backfill the first two in one signature batch: the port on
    TorchBackend(device="cpu"), the reference on "python"."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend
    from lighthouse_tpu_torch.torchhash import engine

    jside, pside = new_sides(TORCH_VALIDATORS, backend="python")
    jh = jside.harness
    blocks = []
    for _ in range(3):
        _slot, signed = produce(jside)
        jh.apply_block(signed)
        blocks.append(signed)
    jtypes, ptypes = jside.types(3), pside.types(3)
    pblocks = [carry.carry_signed_block(b, jtypes, ptypes) for b in blocks]
    pstate = carry.carry_state(jh.state, jtypes, ptypes)

    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)                      # the suite's other workers share the cores
    monkeypatch.setattr(api, "_BACKENDS", dict(api._BACKENDS))
    api.register_backend("torch-cpu", TorchBackend(device="cpu"))
    pside.bls.set_backend("torch-cpu")
    engine.set_device("cpu")
    router.set_hash_backend("device")
    verifies = []
    backend = api.get_backend()
    monkeypatch.setattr(backend, "verify_signature_sets", lambda sets, rands, _f=(
        backend.verify_signature_sets): verifies.append(len(sets)) or _f(sets, rands))
    try:
        out = []
        for s, bs, state in ((jside, blocks, jh.state), (pside, pblocks, pstate)):
            chain = s.bc.BeaconChain.from_checkpoint(s.spec_, s.clone(state), bs[-1])
            accepted = chain.import_historical_blocks(bs[:-1])
            tampered = bs[0].copy_with(signature=bs[1].signature)
            out.append((accepted, chain.head_root, chain.oldest_block_slot,
                        [s.types(b.message.slot).SignedBeaconBlock.serialize(chain.store.get_block(
                            s.types(b.message.slot).BeaconBlock.hash_tree_root(b.message),
                            s.types(b.message.slot))) for b in bs],
                        outcome(lambda c=chain, t=tampered: c.import_historical_blocks([t]))))
    finally:
        router.set_hash_backend("host")
        torch.set_num_threads(threads)
    assert out[1] == out[0]
    assert out[0][0] == 2 and out[0][2] == 1
    assert out[0][4] == ("BlockError", "backfill chain discontinuity")
    assert verifies == [2]                        # one batch on the torch lanes
