"""Vectorized epoch processing: balance/reward/penalty vectors as arrays.

The port of lighthouse_tpu/jaxhash/epoch_vectors.py. The altair+ epoch
transition's per-validator loops (flag deltas, inactivity penalties,
effective-balance hysteresis, state_transition/epoch.py) are data-parallel:
every validator's delta is a pure function of its own row plus a handful
of epoch scalars. The host lane expresses them once over numpy uint64
(`flag_deltas_vec` and friends, as in the reference); the device lane is
the epoch_deltas kernel (csrc/epoch.cu, the reference's
_device_epoch_kernel), and both are pinned bit-exact against the
pure-Python spec path and the reference's device program in
tests/test_torch_epoch.py.

Overflow honesty: all spec math is floor division over uint64. The worst
realistic numerators (base_reward * weight * flag_increments ~ 2^62 at
2M-validator scale; eff * inactivity_score) fit, and `altair_deltas`
CHECKS the actual bounds with Python bigints before vectorizing — a state
that would wrap falls back to the pure-Python path instead of silently
wrapping.

Routing: `altair_deltas` / `effective_balance_updates` return None unless
the hash backend is device-backed (router.hash_backend() in device/hybrid,
the port's default "device") AND the registry is at least
`min_validators` — the callers in state_transition/epoch.py then run the
unchanged pure-Python loops. The device leg shares the tree-hash router's
breaker, and a device failure is counted in
`torchhash_epoch_device_total{outcome="error"}`: under backend "hybrid" the
host-numpy lane then serves, under "device" the error reaches the caller
(the reference's numpy lane serves under both).
"""

from __future__ import annotations

import os

import numpy as np

from ..state_transition import accessors as acc
from ..types.spec import ForkName
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

DEFAULT_MIN_VALIDATORS = 1024

_log = get_logger("torchhash.epoch")
_DEVICE_TOTAL = REGISTRY.counter_vec(
    "torchhash_epoch_device_total",
    "device epoch-delta attempts by outcome (ok = the epoch_deltas kernel "
    "served, error = it raised and the host-numpy lane served)",
    ("outcome",),
)


def epoch_totals() -> dict:
    """{outcome: count} snapshot of torchhash_epoch_device_total."""
    return {key[0]: child.value for key, child in _DEVICE_TOTAL.children()}


def min_validators() -> int:
    raw = os.environ.get("LIGHTHOUSE_TPU_EPOCH_VEC_MIN", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return DEFAULT_MIN_VALIDATORS


def _enabled(n: int) -> bool:
    """Route the epoch vectors? Shares the tree-hash router's breaker:
    in hybrid mode a wedged device refuses O(1) here too (the router.py
    contract) instead of paying a failed device attempt per epoch forever;
    backend "device" keeps attempting, like the hash route. A half-open
    allow claims the probe — _device_altair_deltas reports the outcome."""
    from .router import ROUTER, hash_backend

    backend = hash_backend()
    if backend not in ("device", "hybrid") or n < min_validators():
        return False
    if backend == "hybrid" and not ROUTER.allow_device():
        return False
    return True


# ------------------------------------------------- shared vector formulation


def flag_deltas_vec(xp, eff, participating, eligible, base_per_incr, incr,
                    weight, flag_incr, total_incr, leaking, is_head):
    """(rewards, penalties) uint64 vectors for ONE participation flag —
    the vector form of epoch.get_flag_index_deltas' per-validator body.
    Scalars are Python ints (they promote to the array dtype in both
    namespaces); masks are bool arrays."""
    base = (eff // incr) * base_per_incr
    zero = xp.zeros_like(eff)
    if leaking:
        rewards = zero
    else:
        rewards = xp.where(
            participating & eligible,
            base * weight * flag_incr // (total_incr * acc.WEIGHT_DENOMINATOR),
            zero,
        )
    if is_head:
        penalties = zero
    else:
        penalties = xp.where(
            eligible & ~participating, base * weight // acc.WEIGHT_DENOMINATOR,
            zero,
        )
    return rewards, penalties


def inactivity_deltas_vec(xp, eff, scores, participating_target, eligible,
                          denom):
    """Inactivity-leak penalty vector (epoch.get_inactivity_penalty_deltas;
    rewards are identically zero there)."""
    return xp.where(
        eligible & ~participating_target, eff * scores // denom,
        xp.zeros_like(eff),
    )


def effective_balance_vec(xp, balances, eff, incr, downward, upward, max_eff):
    """(changed mask, new effective balance) for the hysteresis update
    (epoch.process_effective_balance_updates, pre-electra rule)."""
    changed = (balances + downward < eff) | (eff + upward < balances)
    new = xp.minimum(balances - balances % incr, xp.full_like(balances, max_eff))
    return changed, new


# --------------------------------------------------------- state -> arrays


def _seq_array(seq, dtype, n: int) -> np.ndarray:
    """Marshal a state field to an array: chunk-wise for CowList-backed
    fields (no per-element Python iteration at the top), fromiter for
    plain lists."""
    to_numpy = getattr(seq, "to_numpy", None)
    if to_numpy is not None:
        return to_numpy(dtype)
    return np.fromiter(seq, dtype, n)


def _registry_arrays(state):
    vals = state.validators
    n = len(vals)
    eff = np.fromiter((v.effective_balance for v in vals), np.uint64, n)
    slashed = np.fromiter((bool(v.slashed) for v in vals), bool, n)
    activation = np.fromiter((v.activation_epoch for v in vals), np.uint64, n)
    exit_ep = np.fromiter((v.exit_epoch for v in vals), np.uint64, n)
    return eff, slashed, activation, exit_ep


def _active_mask(activation, exit_ep, epoch: int):
    e = np.uint64(epoch)
    return (activation <= e) & (e < exit_ep)


# ----------------------------------------------------------- public entries


def altair_deltas(state, spec, fork, eligible):
    """The four (rewards, penalties) delta sets of
    process_rewards_and_penalties_altair as plain int lists, computed
    vectorized — or None when the hash backend keeps the pure-Python
    path (host backend, small registry, or a value range that would
    overflow uint64). Bit-exact with the scalar loops by construction."""
    n = len(state.validators)
    if not _enabled(n) or acc.get_current_epoch(state, spec) == 0:
        return None
    prev = acc.get_previous_epoch(state, spec)
    cur = acc.get_current_epoch(state, spec)
    eff, slashed, activation, exit_ep = _registry_arrays(state)
    part_prev = _seq_array(state.previous_epoch_participation, np.uint8, n)
    scores = _seq_array(state.inactivity_scores, np.uint64, n)
    active_cur = _active_mask(activation, exit_ep, cur)
    active_prev = _active_mask(activation, exit_ep, prev)
    eligible_mask = np.zeros(n, bool)
    eligible_mask[list(eligible)] = True

    incr = spec.effective_balance_increment
    total_active = max(incr, int(eff[active_cur].sum()))
    base_per_incr = (
        incr * spec.base_reward_factor // acc._integer_squareroot(total_active)
    )
    leaking = acc.is_in_inactivity_leak(state, spec)
    part_masks = [
        active_prev & ~slashed & ((part_prev >> f) & 1).astype(bool)
        for f in range(len(acc.PARTICIPATION_FLAG_WEIGHTS))
    ]
    flag_balances = [max(incr, int(eff[m].sum())) for m in part_masks]
    if fork == ForkName.altair:
        quotient = spec.inactivity_penalty_quotient_altair
    else:
        quotient = spec.inactivity_penalty_quotient_bellatrix
    denom = spec.inactivity_score_bias * quotient

    # overflow honesty: check the ACTUAL bounds with bigints; a state that
    # would wrap uint64 keeps the pure-Python bigint path
    max_base = (int(eff.max(initial=0)) // incr) * base_per_incr
    max_weight = max(acc.PARTICIPATION_FLAG_WEIGHTS)
    max_flag_incr = max(fb // incr for fb in flag_balances)
    if (
        max_base * max_weight * max(1, max_flag_incr) >= 2**64
        or int(eff.max(initial=0)) * int(scores.max(initial=0)) >= 2**64
        or denom >= 2**64
    ):
        return None

    total_incr = total_active // incr
    flag_incrs = [fb // incr for fb in flag_balances]
    target_part = part_masks[acc.TIMELY_TARGET_FLAG_INDEX]

    out = _device_altair_deltas(
        n, eff, part_masks, eligible_mask, target_part, scores,
        base_per_incr, incr, flag_incrs, total_incr, denom, leaking,
    )
    if out is None:
        # host-numpy lane: the same shared formulation, no device
        rew3, pen3 = [], []
        for f, weight in enumerate(acc.PARTICIPATION_FLAG_WEIGHTS):
            r, p = flag_deltas_vec(
                np, eff, part_masks[f], eligible_mask, base_per_incr, incr,
                weight, flag_incrs[f], total_incr, leaking,
                f == acc.TIMELY_HEAD_FLAG_INDEX,
            )
            rew3.append(r)
            pen3.append(p)
        inact = inactivity_deltas_vec(
            np, eff, scores, target_part, eligible_mask, denom
        )
    else:
        rew3, pen3, inact = out
    deltas = [
        (rew3[f].tolist(), pen3[f].tolist())
        for f in range(len(acc.PARTICIPATION_FLAG_WEIGHTS))
    ]
    deltas.append(([0] * n, inact.tolist()))
    return deltas


def kernel_inputs(dev, eff, part_masks, eligible_mask, target_part, scores):
    """The epoch_deltas kernel's tensors on `dev` from the host marshal's
    arrays: eff and scores as int64 holding their uint64 values, the
    masks as bool."""
    import torch

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(dev)

    return (put(eff, np.int64), put(np.stack(part_masks), np.bool_),
            put(eligible_mask, np.bool_), put(target_part, np.bool_),
            put(scores, np.int64))


def _device_altair_deltas(n, eff, part_masks, eligible_mask, target_part,
                          scores, base_per_incr, incr, flag_incrs,
                          total_incr, denom, leaking):
    """Device leg: the epoch_deltas kernel on the engine's device. Returns
    the (rewards(3), penalties(3), inactivity) uint64 arrays. A device
    failure is counted and recorded, then raised under backend "device"
    and answered None under "hybrid" (the caller's host-numpy lane
    serves). Only a
    DEVICE-served computation observes torchhash_device_seconds. The
    epoch workload has no dispatcher: it books its device time in the
    device ledger directly, as the `epoch` tenant."""
    import time

    from ..observability.device_ledger import LEDGER
    from ..ssz.core import next_pow2
    from . import engine, kernels

    t0 = time.perf_counter()
    interval = LEDGER.open("epoch", lane="batch", bucket=next_pow2(n))
    try:
        interval.start()
        rew, pen, inact = kernels.epoch_deltas(
            *kernel_inputs(engine.device(), eff, part_masks, eligible_mask,
                           target_part, scores),
            base_per_incr, incr, flag_incrs, total_incr, denom, leaking,
        )
        rew, pen, inact = (t.cpu().numpy().view(np.uint64) for t in (rew, pen, inact))
        engine._DEVICE_SECONDS.labels("epoch_deltas").observe(
            time.perf_counter() - t0
        )
        interval.close("ok")
        _DEVICE_TOTAL.labels("ok").inc()
        _router_record(True)
        return list(rew), list(pen), inact
    except Exception as e:
        interval.close("error")
        _DEVICE_TOTAL.labels("error").inc()
        _router_record(False)
        from .router import hash_backend

        if hash_backend() != "hybrid":
            raise
        _log.warn("device epoch deltas failed; host vector lane serves",
                  error=f"{type(e).__name__}: {e}")
        return None


def _router_record(ok: bool) -> None:
    """Report a device epoch attempt to the shared breaker — never raises
    (the delta math must not die on a diagnostics path)."""
    try:
        from .router import ROUTER

        ROUTER.record_device(ok)
    except Exception:
        pass


def effective_balance_updates(state, spec):
    """[(index, new_effective_balance)] for validators the hysteresis
    rule changes (epoch.process_effective_balance_updates, pre-electra) —
    or None when the pure-Python loop should run. The caller applies the
    copy_with writes so the memoized-root invalidation semantics are
    identical to the scalar path."""
    n = len(state.validators)
    if not _enabled(n):
        return None
    eff = np.fromiter(
        (v.effective_balance for v in state.validators), np.uint64, n
    )
    balances = _seq_array(state.balances, np.uint64, n)
    hysteresis_incr = spec.effective_balance_increment // spec.hysteresis_quotient
    downward = hysteresis_incr * spec.hysteresis_downward_multiplier
    upward = hysteresis_incr * spec.hysteresis_upward_multiplier
    changed, new = effective_balance_vec(
        np, balances, eff, spec.effective_balance_increment, downward,
        upward, spec.max_effective_balance,
    )
    return [(int(i), int(new[i])) for i in np.flatnonzero(changed)]
