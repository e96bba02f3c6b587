"""The port's tree-hash router and SSZ state roots (torchhash/router.py,
ssz/, types/) on the CPU, with the engine pinned to the plain versions
(engine.set_device("cpu")).

- the router's reasons, threshold and breaker, as tests/test_jaxhash.py
  holds the reference's, and the port's "device" default;
- merkleize routed through the device lane against the reference's;
- the 300-validator synthetic state's root, through the device lane and
  the host lane, plain lists and CowLists (LIGHTHOUSE_TPU_COW_MIN=64),
  against the reference's root of the same state, built by the
  reference's fixture and carried across as SSZ bytes;
- three slots of churn (clone_state, validator and balance writes, a
  re-root each slot) against the reference's roots of the same writes and
  the port's uncached_state_root.

Tolerance: exact equality (roots as bytes). No JAX: the reference hashes
on its host lane.
"""

import random

import numpy as np
import pytest

from lighthouse_tpu.jaxhash import router as jrouter
from lighthouse_tpu.ssz import core as jcore
from lighthouse_tpu.ssz import tree_cache as jtc
from lighthouse_tpu.testing import state_fixtures as jfx
from lighthouse_tpu.types import state_util as jsu

# the port loads when this file's first test runs, not at collection
engine = router = core = fx = su = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global engine, router, core, fx, su
    import torch
    from lighthouse_tpu_torch.ssz import core
    from lighthouse_tpu_torch.testing import state_fixtures as fx
    from lighthouse_tpu_torch.torchhash import engine, router
    from lighthouse_tpu_torch.types import state_util as su

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cpu_engine(monkeypatch):
    """Every test starts on the port's default backend with the env seams
    clear and the engine on the plain versions; the reference stays on
    its host default."""
    for var in ("LIGHTHOUSE_TPU_HASH_BACKEND", "LIGHTHOUSE_TPU_HASH_MIN_LEAVES",
                "LIGHTHOUSE_TPU_EPOCH_VEC_MIN", "LIGHTHOUSE_TPU_COW_MIN",
                "LIGHTHOUSE_TPU_FIXTURE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    router.set_hash_backend(None)
    jrouter.set_hash_backend(None)
    engine.set_device("cpu")
    yield
    engine.set_device(None)
    router.set_hash_backend(None)


def rand_leaves(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)


# ----------------------------------------------------------------- router


def test_router_reasons_and_threshold():
    r = router.TreeHashRouter(min_leaves=64)
    leaves = rand_leaves(16)
    router.set_hash_backend("host")
    assert r.maybe_build_levels(leaves, 12) is None          # host backend
    router.set_hash_backend("hybrid")
    assert r.maybe_build_levels(leaves, 12) is None          # below threshold
    big = rand_leaves(100, seed=3)
    routed = r.maybe_build_levels(big, 12)
    assert routed is not None
    assert routed[1] == jtc._build(big, 12)[1]
    totals = router.route_totals()
    assert totals.get("host/backend_host") and totals.get("host/small") and totals.get("device/ok")


def test_router_breaker_and_device_error(monkeypatch):
    router.set_hash_backend("hybrid")
    r = router.TreeHashRouter(min_leaves=4)
    calls = {"n": 0}

    def boom(leaves, depth, root_only=False):
        calls["n"] += 1
        raise RuntimeError("device wedged")

    monkeypatch.setattr(engine, "device_build_levels", boom)
    before = router.route_totals().get("host/device_error", 0)
    leaves = rand_leaves(64, seed=4)
    for _ in range(3):                       # three failures open the circuit
        assert r.maybe_build_levels(leaves, 12) is None
    assert calls["n"] == 3
    assert r.maybe_build_levels(leaves, 12) is None          # open: O(1) refusal
    assert calls["n"] == 3
    router.set_hash_backend("device")        # "device" skips the refusal and
    with pytest.raises(RuntimeError, match="device wedged"):  # raises: no host
        r.maybe_build_levels(leaves, 12)     # ladder hides the card
    assert calls["n"] == 4
    assert router.route_totals()["host/device_error"] == before + 3
    assert r._breaker._failures == 4          # the raised failure is recorded


def test_backend_default_env_and_validation(monkeypatch):
    """The port's default is "device" (the reference's is "host"); the
    env variable and set_hash_backend override it; unknown names raise."""
    assert router.hash_backend() == "device"
    assert jrouter.hash_backend() == "host"
    monkeypatch.setenv("LIGHTHOUSE_TPU_HASH_BACKEND", "host")
    assert router.hash_backend() == "host"
    router.set_hash_backend("hybrid")
    assert router.hash_backend() == "hybrid"
    with pytest.raises(ValueError):
        router.set_hash_backend("gpu")
    monkeypatch.setenv("LIGHTHOUSE_TPU_HASH_MIN_LEAVES", "300")
    assert router.TreeHashRouter().min_leaves == 300
    monkeypatch.delenv("LIGHTHOUSE_TPU_HASH_MIN_LEAVES")
    assert router.TreeHashRouter().min_leaves == router.DEFAULT_MIN_LEAVES == 1024


def test_device_lane_never_runs_on_the_cpu_by_itself():
    """Without a pinned device the engine takes the card; without one it
    raises. Under the default "device" backend the error reaches the
    caller; only "hybrid" lets the router's host ladder serve, counted
    device_error."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine runs there")
    engine.set_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.device()
    r = router.TreeHashRouter(min_leaves=4)
    leaves = rand_leaves(64, 9)
    before = router.route_totals().get("host/device_error", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.maybe_build_levels(leaves, 12)
    assert router.route_totals().get("host/device_error", 0) == before
    router.set_hash_backend("hybrid")
    assert r.maybe_build_levels(leaves, 12) is None
    assert router.route_totals()["host/device_error"] == before + 1


def test_start_warmup_runs_the_ladder():
    t = router.start_warmup(buckets=(100,))
    t.join(timeout=60)
    assert not t.is_alive()
    assert engine.warm_tree_bucket(100) >= 0.0


# ------------------------------------------------------------ ssz routing


def test_merkleize_routes_device(monkeypatch):
    rng = np.random.default_rng(5)
    chunks = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(300)]
    want = jcore.merkleize(chunks, 1024)      # the reference's host ladder
    monkeypatch.setattr(router.ROUTER, "min_leaves", 64)
    before = router.route_totals().get("device/ok", 0)
    assert core.merkleize(chunks, 1024) == want
    assert router.route_totals().get("device/ok", 0) == before + 1


def carried(jtypes, jstate, types):
    """The reference's state as SSZ bytes, into the port's types."""
    return types.BeaconState.deserialize(jtypes.BeaconState.serialize(jstate))


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("cow", [False, True], ids=["lists", "cowlists"])
def test_state_root_matches_reference(monkeypatch, backend, cow):
    if cow:
        monkeypatch.setenv("LIGHTHOUSE_TPU_COW_MIN", "64")
    _jspec, jtypes, jstate = jfx.build_synthetic_state(300, participation_seed=1)
    want = jtypes.BeaconState.hash_tree_root(jstate)
    _spec, types, state = fx.build_synthetic_state(300, participation_seed=1)
    assert isinstance(state.validators, list) != cow
    monkeypatch.setattr(router.ROUTER, "min_leaves", 64)
    router.set_hash_backend(backend)
    before = router.route_totals().get("device/ok", 0)
    assert types.BeaconState.hash_tree_root(state) == want
    assert types.BeaconState.hash_tree_root(carried(jtypes, jstate, types)) == want
    assert fx.uncached_state_root(types, state) == want
    served = router.route_totals().get("device/ok", 0) - before
    assert (served > 0) == (backend == "device")


def test_three_slots_of_churn_match_reference(monkeypatch):
    """The state_root scenario's churn shape, three slots: each slot's root
    equals the reference's after the same writes, the roots differ, and
    the last equals a cache-free rehash."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_COW_MIN", "64")
    monkeypatch.setattr(router.ROUTER, "min_leaves", 64)
    spec, types, state = fx.build_synthetic_state(300, participation_seed=2)
    jspec, jtypes, jstate = jfx.build_synthetic_state(300, participation_seed=2)
    roots = [types.BeaconState.hash_tree_root(state)]
    assert roots[0] == jtypes.BeaconState.hash_tree_root(jstate)
    rng = random.Random(0xC0FFEE)
    for slot in range(1, 4):
        state, jstate = su.clone_state(state, spec), jsu.clone_state(jstate, jspec)
        state.slot = jstate.slot = slot
        for k in range(8 + 32):
            i = rng.randrange(300)
            new_bal = max(0, state.balances[i] + rng.randrange(-(10**9), 10**9))
            state.balances[i] = jstate.balances[i] = new_bal
            if k < 8:
                eff = (new_bal // 10**9) * 10**9
                state.validators[i] = state.validators[i].copy_with(effective_balance=eff)
                jstate.validators[i] = jstate.validators[i].copy_with(effective_balance=eff)
        roots.append(types.BeaconState.hash_tree_root(state))
        assert roots[-1] == jtypes.BeaconState.hash_tree_root(jstate), slot
    assert len(set(roots)) == len(roots)
    assert fx.uncached_state_root(types, state) == roots[-1]
    assert router.route_totals().get("device/ok", 0) > 0
