"""The port's epoch vectors (torchhash/epoch_vectors.py, the epoch_deltas
kernel's plain version) and process_epoch on the CPU against the JAX
package.

- altair_deltas, steady and in an inactivity leak, against the port's and
  the reference's pure-Python loops, and the kernel's inputs and outputs
  against the reference's device program, _device_epoch_kernel, called
  under jax.enable_x64(True) (the reference's own device leg imports
  jax.experimental.enable_x64, which this JAX lacks, so its tests reach
  only its numpy lane);
- a state whose eff * score lies in [2^63, 2^64): admitted by the
  overflow pre-check, so the plain lane's int64 must give uint64's result;
- the pre-check's refusal, the shared breaker, and a device failure that
  lets the numpy lane serve, counted;
- process_epoch on a state carried across as SSZ bytes against the
  reference's: balances, effective balances and the state root;
- effective_balance_updates against the reference's.

Tolerance: exact equality (Gwei as ints). The JAX side compiles the epoch
program once, at the 512-validator bucket.
"""

import copy
import random

import numpy as np
import pytest

from lighthouse_tpu.jaxhash import epoch_vectors as jev
from lighthouse_tpu.jaxhash import router as jrouter
from lighthouse_tpu.state_transition import epoch as jep
from lighthouse_tpu.state_transition.slot import types_for_slot as j_types_for_slot
from lighthouse_tpu.types.spec import FAR_FUTURE_EPOCH, ForkName, minimal_spec

N = 300

# the port loads when this file's first test runs, not at collection
K = engine = ev = ep = router = slot = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global K, engine, ev, ep, router, slot
    import torch
    from lighthouse_tpu_torch.state_transition import epoch as ep
    from lighthouse_tpu_torch.state_transition import slot
    from lighthouse_tpu_torch.torchhash import engine, router
    from lighthouse_tpu_torch.torchhash import epoch_vectors as ev
    from lighthouse_tpu_torch.torchhash import kernels as K

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _vectors_on(monkeypatch):
    """The port on its "device" default with the engine on the plain
    versions and the vector lane on from one validator; the reference on
    its host default."""
    for var in ("LIGHTHOUSE_TPU_HASH_BACKEND", "LIGHTHOUSE_TPU_HASH_MIN_LEAVES",
                "LIGHTHOUSE_TPU_COW_MIN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_VEC_MIN", "1")
    router.set_hash_backend(None)
    jrouter.set_hash_backend(None)
    engine.set_device("cpu")
    yield
    engine.set_device(None)
    router.set_hash_backend(None)
    jrouter.set_hash_backend(None)


def reference_state(seed, leak=False, scores=(0, 50)):
    """The reference's seeded epoch state (tests/test_jaxhash.py's
    _epoch_state): slashed, exited, inactive and zero-balance validators."""
    spec = minimal_spec()
    types = j_types_for_slot(spec, 0)
    rng = random.Random(seed)
    vals = []
    for i in range(N):
        slashed = rng.random() < 0.05
        exited = rng.random() < 0.05
        vals.append(types.Validator.make(
            pubkey=i.to_bytes(48, "big"),
            withdrawal_credentials=i.to_bytes(32, "big"),
            effective_balance=rng.choice([0, 16, 31, 32, 32]) * 10**9,
            slashed=slashed,
            activation_eligibility_epoch=0,
            activation_epoch=0 if rng.random() < 0.95 else FAR_FUTURE_EPOCH,
            exit_epoch=2 if exited else FAR_FUTURE_EPOCH,
            withdrawable_epoch=6 if slashed else FAR_FUTURE_EPOCH,
        ))
    state = types.BeaconState.default()
    state.validators = vals
    state.balances = [rng.randrange(0, 40 * 10**9) for _ in range(N)]
    state.previous_epoch_participation = [rng.randrange(0, 8) for _ in range(N)]
    state.current_epoch_participation = [rng.randrange(0, 8) for _ in range(N)]
    state.inactivity_scores = [rng.randrange(*scores) for _ in range(N)]
    state.slot = (20 if leak else 3) * spec.preset.SLOTS_PER_EPOCH - 1
    return spec, types, state


def carried(jtypes, jstate):
    """(spec, types, state) of the port: the reference's state as SSZ bytes."""
    from lighthouse_tpu_torch.types.spec import minimal_spec as port_spec

    spec = port_spec()
    types = slot.types_for_slot(spec, jstate.slot)
    return spec, types, types.BeaconState.deserialize(jtypes.BeaconState.serialize(jstate))


def python_deltas(epoch_mod, spec, state, fork):
    eligible = epoch_mod._eligible_validator_indices(state, spec)
    want = [epoch_mod.get_flag_index_deltas(state, spec, f, fork, eligible=eligible)
            for f in range(3)]
    want.append(epoch_mod.get_inactivity_penalty_deltas(state, spec, fork, eligible=eligible))
    return eligible, want


class Recorder:
    """Wraps kernels.epoch_deltas and keeps its last arguments and outputs."""

    def __init__(self, monkeypatch):
        self.calls = []
        wrapped = K.epoch_deltas

        def record(*args):
            out = wrapped(*args)
            self.calls.append((args, out))
            return out

        monkeypatch.setattr(K, "epoch_deltas", record)


def reference_kernel(args):
    """_device_epoch_kernel on the same inputs, padded to its bucket, under
    jax.enable_x64(True); returns uint64 arrays trimmed to n."""
    import jax

    eff, part, eligible, target, scores, base_per_incr, incr, flag_incrs, total_incr, denom, \
        leaking = args
    n = eff.shape[0]
    nb = 1 << max(0, (n - 1).bit_length())

    def pad(t, dtype):
        a = t.numpy().view(dtype)
        out = np.zeros(a.shape[:-1] + (nb,), dtype)
        out[..., :n] = a
        return out

    with jax.enable_x64(True):
        rew, pen, inact = jev._device_epoch_kernel(nb)(
            pad(eff, np.uint64), pad(part, np.bool_), pad(eligible, np.bool_),
            pad(target, np.bool_), pad(scores, np.uint64), np.uint64(base_per_incr),
            np.uint64(incr), np.asarray(flag_incrs, np.uint64), np.uint64(total_incr),
            np.uint64(denom), np.bool_(leaking))
        return np.asarray(rew)[:, :n], np.asarray(pen)[:, :n], np.asarray(inact)[:n]


def as_u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("leak", [False, True], ids=["steady", "leak"])
def test_altair_deltas_match_loops_and_reference_kernel(monkeypatch, leak):
    jspec, jtypes, jstate = reference_state(seed=42, leak=leak)
    spec, types, state = carried(jtypes, jstate)
    fork = ForkName.deneb
    _jel, jwant = python_deltas(jep, jspec, jstate, fork)
    eligible, want = python_deltas(ep, spec, state, fork)
    assert want == jwant
    rec = Recorder(monkeypatch)
    before = ev.epoch_totals().get("ok", 0)
    got = ev.altair_deltas(state, spec, fork, eligible)
    assert ev.epoch_totals().get("ok", 0) == before + 1        # the kernel's lane served
    assert got is not None
    for f in range(4):
        assert got[f][0] == want[f][0] and got[f][1] == want[f][1], f
    (args, (rew, pen, inact)), = rec.calls
    assert bool(args[-1]) == leak
    jrew, jpen, jinact = reference_kernel(args)
    assert np.array_equal(as_u64(rew), jrew) and np.array_equal(as_u64(pen), jpen)
    assert np.array_equal(as_u64(inact), jinact)


def test_near_2_64_numerators(monkeypatch):
    """eff * score in [2^63, 2^64) for the 32 ETH validators: the pre-check
    admits the state, and the plain lane gives uint64's quotients."""
    jspec, jtypes, jstate = reference_state(seed=5, scores=(400_000_000, 500_000_000))
    spec, types, state = carried(jtypes, jstate)
    products = [v.effective_balance * s for v, s in zip(state.validators, state.inactivity_scores)]
    assert max(products) < 2**64 and sum(p >= 2**63 for p in products) > N // 4
    fork = ForkName.deneb
    eligible, want = python_deltas(ep, spec, state, fork)
    assert want == python_deltas(jep, jspec, jstate, fork)[1]
    rec = Recorder(monkeypatch)
    got = ev.altair_deltas(state, spec, fork, eligible)
    assert got is not None and len(rec.calls) == 1
    for f in range(4):
        assert got[f][0] == want[f][0] and got[f][1] == want[f][1], f
    assert max(want[3][1]) > 0
    args, (rew, pen, inact) = rec.calls[0]
    jrew, jpen, jinact = reference_kernel(args)
    assert np.array_equal(as_u64(inact), jinact)
    assert np.array_equal(as_u64(rew), jrew) and np.array_equal(as_u64(pen), jpen)


def test_overflow_pre_check_refuses():
    jspec, jtypes, jstate = reference_state(seed=9)
    spec, _types, state = carried(jtypes, jstate)
    state.inactivity_scores[3] = 2**62
    eligible = ep._eligible_validator_indices(state, spec)
    assert ev.altair_deltas(state, spec, ForkName.deneb, eligible) is None


def test_shared_breaker_and_device_failure(monkeypatch):
    """Hybrid with the tree-hash breaker open refuses the vector lane. A
    device leg that raises is counted as an error: under "device" the
    error reaches the caller, under "hybrid" the numpy lane serves."""
    from lighthouse_tpu_torch.qos.breaker import CircuitBreaker

    jspec, jtypes, jstate = reference_state(seed=13)
    spec, _types, state = carried(jtypes, jstate)
    eligible, want = python_deltas(ep, spec, state, ForkName.deneb)
    monkeypatch.setattr(router.ROUTER, "_breaker", CircuitBreaker("tree_hash_device_test"))
    router.set_hash_backend("hybrid")
    for _ in range(3):
        router.ROUTER.record_device(False)
    assert ev.altair_deltas(state, spec, ForkName.deneb, eligible) is None
    router.set_hash_backend("device")
    engine.set_device("meta")                # a device with no kernel: the leg raises
    before = ev.epoch_totals().get("error", 0)
    with pytest.raises(Exception):
        ev.altair_deltas(state, spec, ForkName.deneb, eligible)
    assert ev.epoch_totals()["error"] == before + 1
    monkeypatch.setattr(router.ROUTER, "_breaker", CircuitBreaker("tree_hash_device_test2"))
    router.set_hash_backend("hybrid")        # closed breaker: the leg runs, fails,
    got = ev.altair_deltas(state, spec, ForkName.deneb, eligible)  # numpy serves
    assert ev.epoch_totals()["error"] == before + 2
    assert [got[f][0] for f in range(4)] == [w[0] for w in want]
    assert [got[f][1] for f in range(4)] == [w[1] for w in want]


@pytest.mark.parametrize("leak", [False, True], ids=["steady", "leak"])
def test_process_epoch_matches_reference(leak):
    jspec, jtypes, jstate = reference_state(seed=11, leak=leak)
    spec, types, state = carried(jtypes, jstate)
    fork = spec.fork_name_at_slot(state.slot)
    jep.process_epoch(jstate, jspec, jtypes, jspec.fork_name_at_slot(jstate.slot))
    before = ev.epoch_totals().get("ok", 0)
    ep.process_epoch(state, spec, types, fork)
    assert ev.epoch_totals().get("ok", 0) == before + 1
    assert list(state.balances) == list(jstate.balances)
    assert ([v.effective_balance for v in state.validators]
            == [v.effective_balance for v in jstate.validators])
    assert types.BeaconState.hash_tree_root(state) == jtypes.BeaconState.hash_tree_root(jstate)


def test_effective_balance_updates_match_reference():
    jspec, jtypes, jstate = reference_state(seed=17)
    spec, _types, state = carried(jtypes, jstate)
    got = ev.effective_balance_updates(state, spec)
    jrouter.set_hash_backend("device")       # the reference's numpy lane, no JAX
    want = jev.effective_balance_updates(jstate, jspec)
    assert got == want and len(got) > N // 4
    # the pure-Python loop writes the same effective balances
    want_eff = [v.effective_balance for v in state.validators]
    for i, e in got:
        want_eff[i] = e
    host = copy.deepcopy(state)
    router.set_hash_backend("host")
    ep.process_effective_balance_updates(host, spec)
    assert [v.effective_balance for v in host.validators] == want_eff
