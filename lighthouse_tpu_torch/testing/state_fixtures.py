"""Synthetic validator-scale BeaconStates for benches and loadgen.

The port's copy of lighthouse_tpu/testing/state_fixtures.py: one builder
shared by chip_smoke.py's state_root and epoch paths and the port's tree
hash tests, so the state-root workload every harness measures is the
SAME shape as the reference's:
an n-validator deneb state on the minimal spec (pubkeys are opaque bytes
for hashing purposes — no key derivation), optionally with seeded
participation/inactivity so the epoch-transition vectors have real work.

Two scale features ride here:

  - The big per-validator fields come back as `ssz/cow.py` CowLists when
    the registry is at least cow_min_len() (override with `cow=`), built
    chunk-wise — the 1M-validator fixture never materializes a second
    flat copy of anything.
  - Fixtures persist to disk keyed by (validator_count, seed, fork): an
    npz holding the seeded arrays AND the per-validator memoized roots,
    so repeat 1M builds skip the ~1M-element RNG replay and — the real
    cost — the from-scratch per-validator hashing of the first root.
    Default dir is `<repo>/.fixture_cache` (gitignored);
    LIGHTHOUSE_TPU_FIXTURE_CACHE overrides it (a path) or disables
    caching entirely (0/off). Auto-caching starts at CACHE_MIN_N
    validators; pass `cache=True/False` to force either way.
"""

from __future__ import annotations

import os

import numpy as np

#: below this, building from scratch is faster than touching disk
CACHE_MIN_N = 65536

_DISABLED = ("0", "off", "false", "no", "disabled")


def fixture_cache_dir() -> str | None:
    """Cache directory, or None when caching is disabled by env."""
    raw = os.environ.get("LIGHTHOUSE_TPU_FIXTURE_CACHE", "").strip()
    if raw.lower() in _DISABLED and raw:
        return None
    if raw:
        return raw
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(pkg_root, ".fixture_cache")


def _cache_path(n: int, seed: int | None, fork: str) -> str | None:
    d = fixture_cache_dir()
    if d is None:
        return None
    seed_label = "none" if seed is None else str(seed)
    return os.path.join(d, f"state_n{n}_s{seed_label}_{fork}.npz")


def _seeded_arrays(n: int, seed: int):
    """Deterministic per-seed field arrays, vectorized (the per-element
    random.Random loop was most of a 1M fixture build)."""
    rng = np.random.default_rng(seed)
    prev_part = rng.integers(0, 8, n, dtype=np.uint8)
    cur_part = rng.integers(0, 8, n, dtype=np.uint8)
    inact = rng.integers(0, 8, n, dtype=np.uint64)
    balances = (
        32 * 10**9 + rng.integers(-(10**9), 10**9, n, dtype=np.int64)
    ).astype(np.uint64)
    return prev_part, cur_part, inact, balances


def build_synthetic_state(n: int, *, participation_seed: int | None = None,
                          slot: int | None = None, cow: bool | None = None,
                          cache: bool | None = None):
    """(spec, types, state) with n validators. With `participation_seed`
    the participation flags / inactivity scores / balances are seeded
    non-trivial (the epoch-transition workload); `slot` defaults to 0
    (pass an epoch-boundary-minus-one slot to bench process_epoch).
    `cow`/`cache` override the CowList-backing and disk-cache defaults
    (see module docstring)."""
    from ..ssz.cow import CowList, cow_chunk_elems, cow_min_len
    from ..state_transition.slot import types_for_slot
    from ..types.spec import FAR_FUTURE_EPOCH, minimal_spec

    spec = minimal_spec()
    types = types_for_slot(spec, 0)
    fork = types.fork.value
    use_cow = cow if cow is not None else (
        cow_min_len() > 0 and n >= cow_min_len()
    )
    use_cache = cache if cache is not None else n >= CACHE_MIN_N
    path = _cache_path(n, participation_seed, fork) if use_cache else None

    cached = None
    if path is not None and os.path.exists(path):
        try:
            with np.load(path) as f:
                cached = {k: f[k] for k in f.files}
            if cached.get("validator_roots") is not None and len(
                cached["validator_roots"]
            ) != n:
                cached = None
        except Exception:
            cached = None  # unreadable cache rebuilds from scratch

    validators = [
        types.Validator.make(
            pubkey=i.to_bytes(48, "big"),
            withdrawal_credentials=i.to_bytes(32, "big"),
            effective_balance=32 * 10**9,
            slashed=False,
            activation_eligibility_epoch=0,
            activation_epoch=0,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        )
        for i in range(n)
    ]
    if cached is not None:
        # pre-seed the memoized roots: the first state root skips the
        # from-scratch per-validator hashing (the dominant cold cost)
        roots = cached["validator_roots"]
        for i, v in enumerate(validators):
            object.__setattr__(v, "_htr", roots[i].tobytes())

    if participation_seed is not None:
        if cached is not None:
            prev_part = cached["prev_part"]
            cur_part = cached["cur_part"]
            inact = cached["inact"]
            balances = cached["balances"]
        else:
            prev_part, cur_part, inact, balances = _seeded_arrays(
                n, participation_seed
            )
        prev_list = prev_part.tolist()
        cur_list = cur_part.tolist()
        inact_list = inact.tolist()
        bal_list = balances.tolist()
    else:
        prev_list = [0] * n
        cur_list = [0] * n
        inact_list = [0] * n
        bal_list = [32 * 10**9] * n

    state = types.BeaconState.default()
    if use_cow:
        bs = types.BeaconState
        ft = {f.name: f.type for f in bs.fields}
        state.validators = CowList.from_list(
            validators, cow_chunk_elems(ft["validators"]), name="validators"
        )
        state.balances = CowList.from_list(
            bal_list, cow_chunk_elems(ft["balances"]), name="balances"
        )
        state.previous_epoch_participation = CowList.from_list(
            prev_list, cow_chunk_elems(ft["previous_epoch_participation"]),
            name="previous_epoch_participation",
        )
        state.current_epoch_participation = CowList.from_list(
            cur_list, cow_chunk_elems(ft["current_epoch_participation"]),
            name="current_epoch_participation",
        )
        state.inactivity_scores = CowList.from_list(
            inact_list, cow_chunk_elems(ft["inactivity_scores"]),
            name="inactivity_scores",
        )
    else:
        state.validators = validators
        state.balances = bal_list
        state.previous_epoch_participation = prev_list
        state.current_epoch_participation = cur_list
        state.inactivity_scores = inact_list

    if path is not None and cached is None:
        _save_fixture(path, types, validators, participation_seed, n)
    if slot is not None:
        state.slot = slot
    return spec, types, state


def _save_fixture(path: str, types, validators, seed: int | None,
                  n: int) -> None:
    """Write the npz: seeded arrays + per-validator roots. Computing the
    roots here is the same work the first state root would do — paid once
    per (n, seed, fork) instead of per process."""
    try:
        roots = np.empty((n, 32), np.uint8)
        vt = None
        for f in types.BeaconState.fields:
            if f.name == "validators":
                vt = f.type.element
        for i, v in enumerate(validators):
            roots[i] = np.frombuffer(vt.hash_tree_root(v), np.uint8)
        arrays = {"validator_roots": roots}
        if seed is not None:
            prev_part, cur_part, inact, balances = _seeded_arrays(n, seed)
            arrays.update(prev_part=prev_part, cur_part=cur_part,
                          inact=inact, balances=balances)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except Exception:
        # a failed cache write must never fail a fixture build
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except Exception:
            pass


def uncached_state_root(types, state) -> bytes:
    """Ground-truth root: a from-scratch rehash of a deep copy with every
    cache defeated — memoized container roots stripped, a FRESH list tree
    cache, CowList fields flattened to plain lists (their per-instance
    hash state must not serve), and the host hash backend — so a
    cached/device root can be proven against it."""
    import copy

    from ..torchhash import router as _router
    from ..ssz import tree_cache as _tc
    from ..ssz.cow import CowList

    st = copy.deepcopy(state)
    for f in st.__class__.ssz_type.fields:
        v = getattr(st, f.name)
        if isinstance(v, CowList):
            setattr(st, f.name, v.to_list())
    for v in st.validators:
        if hasattr(v, "_htr"):
            object.__delattr__(v, "_htr")
    prev_cache = _tc.GLOBAL_LIST_CACHE
    prev_backend = _router._state["backend"]
    _tc.GLOBAL_LIST_CACHE = _tc.ListTreeCache()
    try:
        _router.set_hash_backend("host")
        return types.BeaconState.hash_tree_root(st)
    finally:
        _router._state["backend"] = prev_backend
        _tc.GLOBAL_LIST_CACHE = prev_cache
