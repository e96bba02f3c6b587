"""The state_root loadtest scenario: mutate-and-reroot churn at scale.

`bn loadtest --scenario state_root [--smoke] [--hash-backend device]`
drives the tree-hash stack the way a serving node does: a validator-scale
BeaconState, a block's worth of seeded validator/balance mutations per
slot, a re-root through the selected hash backend (the loadtest
`--hash-backend` flag, else whatever LIGHTHOUSE_TPU_HASH_BACKEND / the
host default resolves) — so soak runs exercise the second device workload
beside the BLS scenarios.

The report is conservation-checked, both halves:
  - the balance LEDGER must sum: every gwei the churn moved is accounted,
    and sum(state.balances) at the end equals the ledger's expectation;
  - the final root must equal a cache-free ground-truth rehash
    (memoized roots stripped, fresh tree cache, host backend) — a device
    or cache divergence under churn fails the run, not just a fixture.
Exit is nonzero on any violated invariant (the driver enforces it).
"""

from __future__ import annotations

import json
import random
import statistics
import time

from .scenarios import StateRootScenario


def run_state_root_scenario(sc: StateRootScenario, out_path: str | None = None,
                            log_fn=None) -> dict:
    """Run the churn loop; returns (and optionally writes) the report."""
    from ..torchhash import hash_backend, router, set_hash_backend
    from ..testing.harness import clone_state
    from ..testing.state_fixtures import (
        build_synthetic_state,
        uncached_state_root,
    )

    t_wall = time.time()
    prev_backend = router._state["backend"]
    if sc.hash_backend is not None:
        set_hash_backend(sc.hash_backend)
    route_before = _route_totals()
    cow_before = _cow_snapshot()
    try:
        spec, types, state = build_synthetic_state(
            sc.n_validators, participation_seed=sc.seed & 0xFFFF
        )
        rng = random.Random(sc.seed)
        expected_total = sum(state.balances)

        t0 = time.time()
        root = types.BeaconState.hash_tree_root(state)
        cold_secs = time.time() - t0

        roots = [root]
        reroot_secs = []
        mutations = {"validators": 0, "balances": 0}
        moved_gwei = 0
        for slot in range(1, sc.slots + 1):
            state = clone_state(state, spec)
            state.slot = slot
            for _ in range(sc.churn_validators):
                i = rng.randrange(sc.n_validators)
                delta = rng.randrange(-(10**9), 10**9)
                new_bal = max(0, state.balances[i] + delta)
                moved_gwei += new_bal - state.balances[i]
                state.balances[i] = new_bal
                state.validators[i] = state.validators[i].copy_with(
                    effective_balance=(new_bal // 10**9) * 10**9
                )
                mutations["validators"] += 1
            for _ in range(sc.churn_balances):
                i = rng.randrange(sc.n_validators)
                delta = rng.randrange(-(10**8), 10**8)
                new_bal = max(0, state.balances[i] + delta)
                moved_gwei += new_bal - state.balances[i]
                state.balances[i] = new_bal
                mutations["balances"] += 1
            t0 = time.time()
            new_root = types.BeaconState.hash_tree_root(state)
            reroot_secs.append(time.time() - t0)
            # churn always moves at least the participation of one leaf:
            # an unchanged root means a cache served stale data
            if new_root == roots[-1]:
                roots.append(new_root)
                break
            roots.append(new_root)
            if log_fn is not None:
                log_fn(
                    f"slot {slot}: rerooted {sc.n_validators} validators in "
                    f"{reroot_secs[-1] * 1e3:.1f}ms backend={hash_backend()}"
                )

        truth = uncached_state_root(types, state)
        balance_total = sum(state.balances)
        p50 = statistics.median(reroot_secs) if reroot_secs else None
        conservation = {
            "expected_balance_total": expected_total + moved_gwei,
            "balance_total": balance_total,
            "balances_ok": balance_total == expected_total + moved_gwei,
            "roots_distinct": len(set(roots)) == len(roots),
            "root_matches_uncached": truth == roots[-1],
        }
        conservation["ok"] = (
            conservation["balances_ok"]
            and conservation["roots_distinct"]
            and conservation["root_matches_uncached"]
        )
        report = {
            "scenario": sc.name,
            "seed": sc.seed,
            "slots": sc.slots,
            "n_validators": sc.n_validators,
            "hash_backend": hash_backend(),
            "published": {
                "mutations": mutations["validators"] + mutations["balances"]
            },
            "mutations": mutations,
            "roots": len(roots),
            "cold_ms": round(cold_secs * 1e3, 3),
            "reroot_p50_ms": round(p50 * 1e3, 3) if p50 else None,
            "roots_per_sec": round(1.0 / p50, 2) if p50 else None,
            "conservation": conservation,
            # route delta over the run: which path actually served (the
            # tree_hash_route_total families, scoped to this scenario)
            "tree_hash_routes": _route_delta(route_before),
            # CoW accounting over the run: chunks copied/re-hashed and
            # how the roots were served (tree_cache_root_total outcomes),
            # plus the final state's per-field chunk sharing
            "cow": _cow_delta(cow_before, state),
            "elapsed_secs": round(time.time() - t_wall, 3),
            # what --bench-matrix style writers read (driver summary)
            "verify_observations": {
                "sets_per_sec": None,
                "verify_p50_ms": round(p50 * 1e3, 3) if p50 else None,
            },
        }
    finally:
        router._state["backend"] = prev_backend
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def _route_totals() -> dict:
    """Current tree_hash_route_total{path,reason} values."""
    from ..torchhash.router import route_totals

    return route_totals()


def _route_delta(before: dict) -> dict:
    after = _route_totals()
    return {
        k: v - before.get(k, 0)
        for k, v in after.items()
        if v - before.get(k, 0)
    }


def _cow_snapshot() -> dict:
    from ..ssz.cow import cow_totals
    from ..ssz.tree_cache import root_outcome_totals

    snap = cow_totals()
    snap["root_outcomes"] = root_outcome_totals()
    return snap


def _cow_delta(before: dict, state) -> dict:
    from ..ssz.cow import CowList

    after = _cow_snapshot()
    out = {}
    for family in ("chunk_copies", "chunk_rehash", "root_outcomes"):
        prev = before.get(family, {})
        out[family] = {
            k: v - prev.get(k, 0)
            for k, v in after.get(family, {}).items()
            if v - prev.get(k, 0)
        }
    out["shared_chunks"] = {
        f.name: getattr(state, f.name).shared_chunk_stats()
        for f in state.__class__.ssz_type.fields
        if isinstance(getattr(state, f.name), CowList)
    }
    return out
