"""The port's block processing (state_transition/{block, electra, slot,
signature_sets, genesis, block_replayer}.py, testing/harness.py) on the CPU
against the JAX package's.

- the port's StateHarness.extend_chain over four epochs of the minimal
  preset, deneb from genesis and electra from epoch 2, gives the
  reference's state root at every slot (each block's state_root), and the
  same final state; BlockReplayer.apply_blocks replays the chain to it;
- electra's epoch processing and its balance-denominated exit churn on
  the chain's electra state equal the reference's;
- a block with real signatures (testing/block_fixtures.py: each aggregate
  signed by its members' summed secret keys) imports under the port's
  "torch" backend on the CPU, its plain lanes, and the same block with the
  attestation's signature replaced by another valid one is rejected;
- the summed-key signature of a committee equals the reference harness's
  member-by-member aggregate, byte for byte.

Both sides run their "fake" BLS backend on the chain (the harness then signs
with a fixed valid point) and the "host" hash backend. Tolerance: exact
(state roots and SSZ bytes). Keys cross as secret-key ints and affine points
(testing/carry.py), so only the reference generates them.
"""

import pytest

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.state_transition import epoch as jep
from lighthouse_tpu.state_transition import mutators as jmut
from lighthouse_tpu.testing import harness as jharness
from lighthouse_tpu.testing.ef_runner import spec_at_fork as j_spec_at_fork
from lighthouse_tpu.types.containers import spec_types as j_spec_types
from lighthouse_tpu.types.spec import ForkName as JForkName

N = 16
EPOCHS = 4
ELECTRA_EPOCH = 2

# the port loads when this file's first test runs, not at collection
bls = block = carry = cf = ep = harness = mut = replayer = slot = spec_at_fork = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global bls, block, carry, cf, ep, harness, mut, replayer, slot, spec_at_fork
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_transition import block, slot
    from lighthouse_tpu_torch.state_transition import block_replayer as replayer
    from lighthouse_tpu_torch.state_transition import epoch as ep
    from lighthouse_tpu_torch.state_transition import mutators as mut
    from lighthouse_tpu_torch.testing import carry, harness
    from lighthouse_tpu_torch.testing import compare_fields as cf
    from lighthouse_tpu_torch.testing.ef_runner import spec_at_fork
    from lighthouse_tpu_torch.torchhash import router

    prev_hash, prev = router._state["backend"], bls.api._active_backend
    router.set_hash_backend("host")
    jprev = jbls.get_backend().name
    yield
    router.set_hash_backend(prev_hash)
    bls.api._active_backend = prev
    jbls.set_backend(jprev)


@pytest.fixture(scope="module")
def chains():
    """The two harnesses after EPOCHS epochs of blocks, and their blocks."""
    jbls.set_backend("fake")
    bls.set_backend("fake")
    overrides = {"electra_fork_epoch": ELECTRA_EPOCH}
    jspec = j_spec_at_fork("minimal", "deneb", overrides)
    spec = spec_at_fork("minimal", "deneb", overrides)
    jkeys = jbls.interop_keypairs(N)
    jh = jharness.StateHarness(spec=jspec, keypairs=jkeys)
    ph = harness.StateHarness(spec=spec, keypairs=carry.carry_keypairs(jkeys))
    slots = EPOCHS * spec.preset.SLOTS_PER_EPOCH
    jblocks = jh.extend_chain(slots)
    pblocks = ph.extend_chain(slots)
    return jspec, spec, jh, ph, jblocks, pblocks


def test_extend_chain_matches_jax_slot_by_slot(chains):
    jspec, spec, jh, ph, jblocks, pblocks = chains
    assert [b.message.slot for b in pblocks] == list(range(1, len(pblocks) + 1))
    for jb, pb in zip(jblocks, pblocks):
        assert bytes(pb.message.state_root) == bytes(jb.message.state_root), pb.message.slot
        jt = j_spec_types(jspec.preset, jspec.fork_name_at_slot(jb.message.slot))
        pt = slot.types_for_slot(spec, pb.message.slot)
        assert pt.SignedBeaconBlock.serialize(pb) == jt.SignedBeaconBlock.serialize(jb)
    assert spec.fork_name_at_slot(ph.state.slot).name == "electra"
    # the electra blocks carry committee_bits, the deneb ones do not
    assert hasattr(pblocks[-1].message.body.attestations[0], "committee_bits")
    assert not hasattr(pblocks[1].message.body.attestations[0], "committee_bits")
    jt = j_spec_types(jspec.preset, JForkName.electra)
    types = slot.types_for_slot(spec, ph.state.slot)
    want = carry.carry_state(jh.state, jt, types)
    cf.assert_equal(ph.state, want, "the port's and the reference's states")
    assert types.BeaconState.hash_tree_root(ph.state) == jt.BeaconState.hash_tree_root(jh.state)

    # the replayer from genesis, state roots checked at every block
    from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state

    genesis = interop_genesis_state(ph.keypairs, ph.genesis_time, spec)
    out = replayer.BlockReplayer(spec=spec, state=genesis, verify_state_roots=True).apply_blocks(
        pblocks)
    assert types.BeaconState.hash_tree_root(out) == types.BeaconState.hash_tree_root(ph.state)


def test_electra_epoch_and_exit_churn_match_jax(chains):
    jspec, spec, jh, ph, _jb, _pb = chains
    jt = j_spec_types(jspec.preset, JForkName.electra)
    types = slot.types_for_slot(spec, ph.state.slot)
    jstate = jt.BeaconState.deserialize(jt.BeaconState.serialize(jh.state))
    state = carry.carry_state(jh.state, jt, types)
    # exits first: electra's churn is denominated in Gwei (EIP-7251)
    for i in (3, 5, 7):
        jmut.initiate_validator_exit(jstate, jspec, i)
        mut.initiate_validator_exit(state, spec, i)
    assert state.earliest_exit_epoch == jstate.earliest_exit_epoch
    assert state.exit_balance_to_consume == jstate.exit_balance_to_consume
    assert [v.exit_epoch for v in state.validators] == [v.exit_epoch for v in jstate.validators]
    # then the epoch transition at the last slot of the state's epoch
    end = (jstate.slot // jspec.preset.SLOTS_PER_EPOCH + 1) * jspec.preset.SLOTS_PER_EPOCH - 1
    jstate.slot = state.slot = end
    jep.process_epoch(jstate, jspec, jt, JForkName.electra)
    ep.process_epoch(state, spec, types, spec.fork_name_at_slot(state.slot))
    assert list(state.balances) == list(jstate.balances)
    assert types.BeaconState.hash_tree_root(state) == jt.BeaconState.hash_tree_root(jstate)


@pytest.fixture(scope="module")
def signed_block():
    """A minimal-preset deneb block with real signatures at slot 8 over 16
    interop validators: the attestation of slot 7 (2 keys), the sync
    aggregate (32), the RANDAO reveal and the proposer signature: 4 sets,
    bucket (4, 32), each verify ~15 s on the CPU's plain lanes."""
    from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state
    from lighthouse_tpu_torch.testing import block_fixtures as bf

    spec = spec_at_fork("minimal", "deneb")
    keys = carry.carry_keypairs(jbls.interop_keypairs(N))
    pre = interop_genesis_state(keys, 1_600_000_000, spec)
    slot.process_slots(pre, spec, spec.preset.SLOTS_PER_EPOCH - 1)
    signed, _seconds = bf.build_block(spec, keys, pre, workers=4, last_slots=1)
    types = slot.types_for_slot(spec, signed.message.slot)
    # the tampered copy: the attestation signed over the sync aggregate's message
    att = signed.message.body.attestations[0]
    body = signed.message.body.copy_with(attestations=[att.copy_with(
        signature=signed.message.body.sync_aggregate.sync_committee_signature)])
    return spec, types, pre, signed, signed.copy_with(message=signed.message.copy_with(body=body))


def test_block_with_real_signatures_on_torch_cpu(signed_block):
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend
    from lighthouse_tpu_torch.types.state_util import clone_state

    spec, types, pre, signed, swapped = signed_block
    assert len(signed.message.body.attestations) == 1
    api.register_backend("torch-cpu", TorchBackend(device="cpu"))
    bls.set_backend("torch-cpu")
    post = slot.state_transition(clone_state(pre, spec), signed, spec,
                                 strategy=block.SignatureStrategy.VERIFY_BULK)
    assert types.BeaconState.hash_tree_root(post) == bytes(signed.message.state_root)
    with pytest.raises(block.BlockProcessingError, match="bulk signature"):
        slot.state_transition(clone_state(pre, spec), swapped, spec,
                              strategy=block.SignatureStrategy.VERIFY_BULK)
    # without verification the valid block gives the same post-state
    bls.set_backend("fake")
    quiet = slot.state_transition(clone_state(pre, spec), signed, spec,
                                  strategy=block.SignatureStrategy.NO_VERIFICATION)
    assert types.BeaconState.hash_tree_root(quiet) == types.BeaconState.hash_tree_root(post)


def test_summed_key_signature_equals_member_aggregate(signed_block):
    """block_fixtures' (sum sk_i) * H(m) against the reference harness's
    attestation, signed member by member on its "python" backend."""
    from lighthouse_tpu.state_transition.slot import process_slots as j_process_slots
    from lighthouse_tpu_torch.testing import block_fixtures as bf

    jbls.set_backend("python")
    jspec = j_spec_at_fork("minimal", "deneb")
    jh = jharness.StateHarness(spec=jspec, keypairs=jbls.interop_keypairs(N))
    j_process_slots(jh.state, jspec, 3)
    att = jh.build_attestations(jh.state, 2, b"\x11" * 32)[0]
    members = _committee(jh, jspec, 2)
    jt = j_spec_types(jspec.preset, JForkName.deneb)
    from lighthouse_tpu.types import helpers as jh_
    from lighthouse_tpu.types.spec import DOMAIN_BEACON_ATTESTER

    domain = jh_.get_domain(jh.state, jspec, DOMAIN_BEACON_ATTESTER, 0)
    root = jh_.compute_signing_root(jt.AttestationData, att.data, domain)
    summed = sum(jh.keypairs[i].sk.scalar for i in members) % bls.api.R
    assert bf.sign_root(summed, root) == bytes(att.signature)
    assert len(members) >= 2


def _committee(jh, jspec, slot_):
    from lighthouse_tpu.state_transition import accessors as jacc

    return jacc.build_committee_cache(jh.state, jspec, 0).committee(slot_, 0)


def test_import_runs_on_the_card_by_default_and_never_falls_back(signed_block, monkeypatch):
    """With no backend named the import takes "torch", which needs the card
    (without one it raises); a verify that fails raises through
    state_transition, and nothing verifies on the host instead."""
    import torch

    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.types.state_util import clone_state

    spec, _types, pre, signed, _tampered = signed_block
    host_calls = []
    monkeypatch.setattr(api.PythonBackend, "verify_signature_sets",
                        lambda self, sets, rands: host_calls.append(len(sets)) or True)

    class Broken(api.FakeBackend):
        def verify_signature_sets(self, sets, rands):
            raise RuntimeError("launch failed")

    api.register_backend("broken", Broken())
    bls.set_backend("broken")
    with pytest.raises(RuntimeError, match="launch failed"):
        slot.state_transition(clone_state(pre, spec), signed, spec)
    if not torch.cuda.is_available():
        monkeypatch.delenv("LIGHTHOUSE_TPU_BLS_BACKEND", raising=False)
        monkeypatch.delitem(api._BACKENDS, "torch", raising=False)
        monkeypatch.setattr(api, "_active_backend", None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            slot.state_transition(clone_state(pre, spec), signed, spec)
    assert host_calls == []
