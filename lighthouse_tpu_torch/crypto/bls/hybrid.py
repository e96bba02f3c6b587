"""Hybrid host/device BLS verification policy — the urgent-path escape
hatch (the port's copy of the JAX package's crypto/bls/hybrid.py).

The chain sometimes needs a SINGLE urgent verification (a gossip block's
proposer signature, a lone attestation on a quiet subnet) with low p99,
while the device pipeline is built for big batches and can be cold (the
first verify of a process builds or loads the kernel library and warms a
bucket) or absent (no CUDA card). Lighthouse's analog is the per-set CPU
fallback after a failed blst batch (lighthouse/beacon_node/beacon_chain/
src/attestation_verification/batch.rs:116-120); here the escape hatch
also covers a cold or absent card, so a node without one still serves
verification.

Routing policy (each decision counted in Prometheus metrics):
  - device state "down"/"probing"  -> host, always. The device probe runs
    in a daemon thread (torch.cuda.is_available(), the port's
    TorchBackend on "cuda", one load of the BLS kernel library — on a
    cold build/ directory that is the nvcc build) with a bounded startup
    wait, and keeps retrying, so a card that becomes usable later
    upgrades the process to the device path without a restart.
  - small batch + cold bucket      -> host now, warm the device bucket in
    the background with the same sets (the next verify at this shape rides
    the warmed device path).
  - large batch                    -> device (batches are throughput work,
    not urgent; they pay the first-use cost once).
  - small batch + device p99 over budget (rolling window) -> host.
  - device dispatch raises         -> host answers; repeated failures mark
    the device down until the next probe succeeds.
  - circuit breaker OPEN           -> host, O(1) refusal. The breaker
    (qos/breaker.py) trips after consecutive failures — raised dispatches
    OR verifies slower than the stall budget (4x the p99 budget) — so a
    stalled-but-not-dead device degrades to the host path within one
    budget window instead of per-call timeouts. Recovery is probe-driven:
    after the cooldown one half-open probe rides the device and its
    outcome closes or re-opens the circuit. State is exported as
    `bls_device_circuit_state` (0=closed, 1=open, 2=half_open).

The host lane is the port's "python" backend. Neither importing this
module nor constructing the router initializes CUDA: the probe does, on
its own thread, at the first routed call.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Sequence

from ...observability import flight_recorder as _fr
from ...observability import slo as _slo
from ...observability import trace as _obs_trace
from ...utils.logging import get_logger
from ...utils.metrics import REGISTRY

# one labeled family instead of a name-mangled counter per reason: a scrape
# can sum over paths or break a path down by reason without regexes. Each
# verification is counted ONCE, by the path that finally served it — a
# device dispatch that fails and reroutes shows as {path="host",
# reason="device_error"}, never as two decisions
_ROUTE_DECISIONS = REGISTRY.counter_vec(
    "bls_hybrid_route_total",
    "verifications by the path that served them and the routing reason",
    ("path", "reason"),
)
_REASONS = {
    reason: _ROUTE_DECISIONS.labels("host", reason)
    for reason in (
        "device_down", "device_probing", "device_cold", "latency_budget",
        "device_error", "circuit_open",
    )
}
_DEVICE_ROUTED = _ROUTE_DECISIONS.labels("device", "ok")


def _note_route(path: str, reason: str, n_sets: int = 1) -> None:
    """One served verification: the route family child, the SLO
    accountant's per-slot route share, and a flight-recorder event when
    the path FLIPS (device->host or back) — route flips are exactly the
    transitions an incident dump should show next to breaker events."""
    (_DEVICE_ROUTED if path == "device" else _REASONS[reason]).inc()
    _slo.ACCOUNTANT.record_route(path, n_sets)
    _fr.RECORDER.note_route("bls_device", path, reason)


_DEVICE_LATENCY = REGISTRY.histogram(
    "bls_hybrid_device_verify_seconds", "device multi-set verify wall time"
)
# QoS circuit breaker state (qos/breaker.py): 0=closed,
# 1=open, 2=half_open. Module-level so every HybridBackend instance (tests
# construct several) reports through the same series; the live node has one.
_CIRCUIT_STATE = REGISTRY.gauge(
    "bls_device_circuit_state",
    "device-path circuit breaker state (0=closed, 1=open, 2=half_open); "
    "DEPRECATED alias of circuit_state{workload=\"bls\"}",
)


def _resolve_knob(ctor_val, env_name: str, profile_val, default: float):
    """One routing knob with explicit precedence:

        explicit constructor arg > env var > profile-derived > default

    (the autotune contract, docs/PERF_NOTES.md "Autotune": a persisted
    device profile supplies learned values, but an operator's env var or
    an explicit argument always wins). Returns (value, source) where
    source names the layer that decided, for the one-time startup log."""
    if ctor_val is not None:
        return float(ctor_val), "constructor"
    raw = os.environ.get(env_name)
    if raw is not None:
        try:
            return float(raw), "env"
        except ValueError:
            # malformed env falls through to the NEXT layer (profile, then
            # default). Pre-autotune code fell straight to the default —
            # same outcome when no profile is installed; with one, the
            # learned value wins and the startup log shows source=profile.
            pass
    if profile_val is not None:
        return float(profile_val), "profile"
    return float(default), "default"


def _dummy_sets(n_sets: int, n_pks: int):
    """Shape-exact placeholder sets (generator points, distinct messages)
    for warming a padding bucket: a device verify over them executes
    the full four-stage pipeline — the result is False, the warm-up is
    real."""
    from ..bls381 import curve as cv
    from .keys import PublicKey
    from .signature import Signature
    from .signature_set import SignatureSet

    pk = PublicKey(cv.G1_GEN)
    sig = Signature(cv.G2_GEN)
    return [
        SignatureSet(sig, [pk] * max(1, n_pks), i.to_bytes(4, "little") * 8)
        for i in range(max(1, n_sets))
    ]


def _autotune_plan():
    """The installed autotune plan, or None — never raises (the hybrid
    backend must construct even if the autotune subsystem is broken)."""
    try:
        from ...autotune import runtime

        return runtime.active_plan()
    except Exception:
        return None


class HybridBackend:
    """Registered as "hybrid" in the backend registry (api.set_backend)."""

    name = "hybrid"

    def __init__(
        self,
        *,
        urgent_max_sets: int | None = None,
        p99_budget_ms: float | None = None,
        probe_startup_wait_secs: float | None = None,
        probe_retry_secs: float | None = None,
        breaker_reset_secs: float | None = None,
        stall_budget_ms: float | None = None,
    ):
        self._log = get_logger("bls.hybrid")
        self._lock = threading.Lock()
        # the raw constructor args, kept so a plan installed at RUNTIME
        # (a profile installed mid-run) can re-run the exact
        # resolution — constructor/env layers keep winning, only the
        # profile/default layers move (_apply_plan)
        self._ctor_knobs = {
            "urgent_max_sets": urgent_max_sets,
            "p99_budget_ms": p99_budget_ms,
            "stall_budget_ms": stall_budget_ms,
        }
        self._probe_startup_wait, _ = _resolve_knob(
            probe_startup_wait_secs, "LIGHTHOUSE_TPU_DEVICE_PROBE_WAIT_SECS",
            None, 20.0,
        )
        self._probe_retry, _ = _resolve_knob(
            probe_retry_secs, "LIGHTHOUSE_TPU_DEVICE_PROBE_RETRY_SECS",
            None, 600.0,
        )
        breaker_reset, _ = _resolve_knob(
            breaker_reset_secs, "LIGHTHOUSE_TPU_BREAKER_RESET_SECS",
            None, 10.0,
        )
        from ...qos.breaker import CircuitBreaker

        self._breaker = CircuitBreaker(
            "bls_device", failure_threshold=3,
            reset_timeout=breaker_reset, state_gauge=_CIRCUIT_STATE,
            workload="bls",
        )
        self._apply_plan(_autotune_plan())
        try:
            from ...autotune import runtime as _at_runtime

            # live retune: installing/clearing a profile mid-run re-derives
            # the p99 budget and urgent threshold immediately
            _at_runtime.add_plan_listener(self._apply_plan)
        except Exception:
            pass  # a broken autotune subsystem must not block construction
        self._state = "probing"            # probing | up | down
        self._device = None                # TorchBackend once probed up
        self._device_failures = 0
        self._warm_buckets: set = set()
        self._warming: set = set()
        self._lats: deque = deque(maxlen=128)
        self._probe_started = threading.Event()
        self._probe_done = threading.Event()

    def _apply_plan(self, plan) -> None:
        """(Re-)resolve every plan-derived routing knob against `plan`
        (None = no profile installed). Runs at construction AND from the
        autotune plan listener on runtime installs/clears; the knob
        precedence contract is untouched — only the profile/default
        layers ever produce a new value here."""
        urgent, urgent_src = _resolve_knob(
            self._ctor_knobs["urgent_max_sets"],
            "LIGHTHOUSE_TPU_URGENT_MAX_SETS",
            plan.urgent_max_sets if plan else None, 4,
        )
        p99, p99_src = _resolve_knob(
            self._ctor_knobs["p99_budget_ms"],
            "LIGHTHOUSE_TPU_DEVICE_P99_BUDGET_MS",
            plan.p99_budget_ms if plan else None, 500.0,
        )
        # a verify slower than this is a STALL (breaker failure signal):
        # well past anything the p99 budget router would tolerate, so legit
        # heavy batches never trip it, a wedged device does. The planner's
        # Plan.stall_budget_ms (None without measurements) sits between
        # env/ctor and the 4x-p99 default.
        stall, _ = _resolve_knob(
            self._ctor_knobs["stall_budget_ms"],
            "LIGHTHOUSE_TPU_DEVICE_STALL_BUDGET_MS",
            getattr(plan, "stall_budget_ms", None) if plan else None,
            p99 * 4.0,
        )
        with self._lock:
            changed = (
                getattr(self, "urgent_max_sets", None) != int(urgent)
                or getattr(self, "p99_budget_ms", None) != p99
                or getattr(self, "_stall_budget_secs", None) != stall / 1e3
            )
            self.urgent_max_sets = int(urgent)
            self.p99_budget_ms = p99
            self._stall_budget_secs = stall / 1e3
            self.knob_sources = {
                "urgent_max_sets": urgent_src, "p99_budget_ms": p99_src,
            }
        if changed:
            # change-only: a control loop may re-install a plan every few
            # slots, and a no-op resolve must not turn the log into a
            # metronome
            self._log.info(
                "routing knobs resolved",
                urgent_max_sets=self.urgent_max_sets,
                urgent_max_sets_source=urgent_src,
                p99_budget_ms=self.p99_budget_ms,
                p99_budget_ms_source=p99_src,
                plan_source=plan.source if plan else "none",
            )

    # ------------------------------------------------------------- probing

    def _ensure_probe(self):
        if self._probe_started.is_set():
            return
        with self._lock:
            if self._probe_started.is_set():
                return
            self._probe_started.set()
            t = threading.Thread(target=self._probe_loop, daemon=True,
                                 name="bls-hybrid-device-probe")
            t.start()

    def _probe_loop(self):
        while True:
            try:
                import torch

                if not torch.cuda.is_available():
                    raise RuntimeError("no CUDA device")
                from ..torchbls import kernels
                from ..torchbls.backend import TorchBackend

                device = self._device or TorchBackend(device="cuda")
                kernels.library()   # one load; the nvcc build on a cold build/
                with self._lock:
                    self._device = device
                    self._state = "up"
                    self._device_failures = 0
                self._log.info("device backend up",
                               device=torch.cuda.get_device_name(0))
                self._probe_done.set()
                return
            except Exception as e:
                with self._lock:
                    self._state = "down"
                self._log.warn(
                    "device backend unavailable; serving from host",
                    error=f"{type(e).__name__}: {e}",
                    retry_secs=self._probe_retry,
                )
                self._probe_done.set()
            time.sleep(self._probe_retry)

    def _device_state(self) -> str:
        self._ensure_probe()
        # bounded startup grace: give the probe a chance to finish so the
        # very first verifies ride the device, but never block on it
        if self._state == "probing":
            self._probe_done.wait(self._probe_startup_wait)
        with self._lock:
            return self._state

    # ------------------------------------------------------------- routing

    def _lane(self, n_sets: int) -> str:
        return "urgent" if n_sets <= self.urgent_max_sets else "batch"

    def _bucket(self, sets) -> tuple:
        """LANE-AWARE warm/cold key: (lane, padding bucket). On one card
        both lanes run the same kernels at the same bucket, but the lane
        stays part of the key as in the reference: warmth is vouched for
        per lane, the way the serving path submits."""
        from ..torchbls.backend import padding_bucket

        lane = self._lane(len(sets))
        return lane, padding_bucket(
            len(sets), max(len(s.signing_keys) for s in sets)
        )

    def _p99_ms(self) -> float | None:
        with self._lock:
            if len(self._lats) < 8:
                return None
            xs = sorted(self._lats)
        return xs[min(len(xs) - 1, int(len(xs) * 0.99))] * 1e3

    def _route(self, sets) -> tuple[str, str]:
        state = self._device_state()
        if state != "up":
            return "host", f"device_{state}"
        small = len(sets) <= self.urgent_max_sets
        bucket = self._bucket(sets)
        with self._lock:
            cold = bucket not in self._warm_buckets
        if cold and small:
            self._spawn_warm(bucket, sets)
            return "host", "device_cold"
        if not cold and small:
            p99 = self._p99_ms()
            if p99 is not None and p99 > self.p99_budget_ms:
                return "host", "latency_budget"
        # breaker consulted LAST, exactly when the device path is otherwise
        # chosen: open = O(1) refusal; allow() in half-open admits exactly
        # one probe verify whose recorded outcome (via _record_device_ok /
        # _record_device_error) closes or re-opens the circuit. Consulting
        # it earlier could claim the probe slot for a verify that then
        # routes to the host and never reports back.
        if not self._breaker.allow():
            return "host", "circuit_open"
        return "device", ""

    def _spawn_warm(self, bucket, sets):
        with self._lock:
            if bucket in self._warming or bucket in self._warm_buckets:
                return
            self._warming.add(bucket)
        snapshot = list(sets)

        def warm():
            try:
                t0 = time.time()
                # warm through the SAME lane the serving path will pick
                # (_device_submitters): a small batch routes urgent
                submit, _ = self._device_submitters(snapshot)
                submit(snapshot, [1] * len(snapshot))
                with self._lock:
                    self._warm_buckets.add(bucket)
                self._log.info(
                    "device bucket warmed", bucket=str(bucket),
                    secs=round(time.time() - t0, 1),
                )
            except Exception as e:
                self._log.warn(
                    "device bucket warm failed", bucket=str(bucket),
                    error=f"{type(e).__name__}: {e}",
                )
            finally:
                with self._lock:
                    self._warming.discard(bucket)

        threading.Thread(target=warm, daemon=True,
                         name=f"bls-hybrid-warm-{bucket}").start()

    def warm_bucket(self, n_sets: int, n_pks: int) -> bool:
        """Full-pipeline warm-up of one padding bucket through the device,
        marking it warm for ROUTING too — the autotune startup warmup
        calls this (autotune/runtime.start_warmup) so the first real batch
        at a planned shape skips both the first-use cost and the host
        detour (this router keeps urgent sets on the host until a bucket
        has completed one device verify, _warm_buckets). Returns False
        (never raises) when the device is down/probing or the verify fails
        — warmup degrades, the process keeps serving."""
        if self._device_state() != "up":
            return False
        from ..torchbls.backend import padding_bucket

        # bucket resolved BEFORE materializing the dummy sets, and claimed
        # in _warming so a concurrent _spawn_warm / warm_bucket at the
        # same shape never runs a second warm of it. The key is the SAME
        # lane-aware one _bucket computes for a real batch of this size.
        lane = self._lane(max(1, n_sets))
        bucket = (lane, padding_bucket(max(1, n_sets), max(1, n_pks)))
        with self._lock:
            if bucket in self._warm_buckets:
                return True
            if bucket in self._warming:
                return False  # another warm of this shape is in flight
            self._warming.add(bucket)
        try:
            sets = _dummy_sets(n_sets, n_pks)
            t0 = time.time()
            # dummy sets verify False; the warm-up is the point. NOT
            # recorded via _record_device_ok: the first-use wall time must
            # not enter the p99 window the budget router reads. Warm
            # through the SAME lane the serving path will pick
            submit, _ = self._device_submitters(sets)
            submit(sets, [1] * len(sets))
            with self._lock:
                self._warm_buckets.add(bucket)
            self._log.info("bucket warmed (startup plan)", bucket=str(bucket),
                           secs=round(time.time() - t0, 1))
            return True
        except Exception as e:
            self._log.warn("bucket warmup failed", bucket=str(bucket),
                           error=f"{type(e).__name__}: {e}")
            return False
        finally:
            with self._lock:
                self._warming.discard(bucket)

    def _host(self):
        from . import api

        return api._BACKENDS["python"]

    def _record_device_ok(self, bucket, dt, n_sets: int = 1):
        _DEVICE_LATENCY.observe(dt)
        with self._lock:
            self._lats.append(dt)
            self._warm_buckets.add(bucket)
            self._device_failures = 0
        # a verify that completed but blew the stall budget is a breaker
        # failure: the device answered, too late to be useful
        if dt > self._stall_budget_secs:
            self._log.warn("device verify stalled past budget",
                           secs=round(dt, 2),
                           budget_secs=self._stall_budget_secs)
            self._breaker.record_failure()
            # SLO: the sets verified, but past their usefulness budget —
            # processed for conservation, deadline MISSES for the SLI.
            # Kind rides the current trace (set by the caller of a sync
            # verify) so a late BLOCK batch is excluded; async batch
            # resolves carry no trace here and those are exactly the
            # coalesced attestation/aggregate (TIMELY) dispatches.
            tr = _obs_trace.current_trace()
            _slo.ACCOUNTANT.record_late(n_sets,
                                        kind=tr.kind if tr else None)
        else:
            self._breaker.record_success()

    def _record_device_error(self, e):
        self._log.warn("device verify failed; host served",
                       error=f"{type(e).__name__}: {e}")
        self._breaker.record_failure()
        with self._lock:
            self._device_failures += 1
            if self._device_failures >= 3:
                self._state = "down"
                self._probe_done.clear()
                self._probe_started.clear()  # re-arm the probe loop

    # ------------------------------------------------------------- surface

    def _device_submitters(self, sets):
        """(sync_fn, async_fn) for a device-routed batch: urgent-sized
        batches take the torch dispatcher's BYPASS lane (no waiting
        behind the coalesced firehose window) when the device backend
        exposes one; stub backends fall back to the plain submission
        path."""
        dev = self._device
        if len(sets) <= self.urgent_max_sets:
            sync = getattr(dev, "verify_signature_sets_urgent", None)
            asyn = getattr(dev, "verify_signature_sets_urgent_async", None)
            return (
                sync or dev.verify_signature_sets,
                asyn or getattr(dev, "verify_signature_sets_async", None),
            )
        return (
            dev.verify_signature_sets,
            getattr(dev, "verify_signature_sets_async", None),
        )

    def verify_signature_sets(self, sets, rands) -> bool:
        path, reason = self._route(sets)
        if path == "host":
            _note_route("host", reason, len(sets))
            return self._host().verify_signature_sets(sets, rands)
        bucket = self._bucket(sets)
        submit, _ = self._device_submitters(sets)
        try:
            t0 = time.time()
            ok = submit(sets, rands)
            self._record_device_ok(bucket, time.time() - t0, len(sets))
            _note_route("device", "ok", len(sets))
            return ok
        except Exception as e:
            self._record_device_error(e)
            _note_route("host", "device_error", len(sets))
            return self._host().verify_signature_sets(sets, rands)

    def verify_signature_sets_async(self, sets, rands):
        from . import api

        path, reason = self._route(sets)
        if path == "host":
            _note_route("host", reason, len(sets))
            return api._ReadyHandle(
                self._host().verify_signature_sets(sets, rands)
            )
        bucket = self._bucket(sets)
        outer = self

        class _Handle:
            __slots__ = ("_inner", "_t0")

            def __init__(self, inner, t0):
                self._inner = inner
                self._t0 = t0

            def result(self) -> bool:
                try:
                    r = self._inner.result()
                    outer._record_device_ok(
                        bucket, time.time() - self._t0, len(sets)
                    )
                    _note_route("device", "ok", len(sets))
                    return r
                except Exception as e:
                    outer._record_device_error(e)
                    _note_route("host", "device_error", len(sets))
                    return outer._host().verify_signature_sets(sets, rands)

        sync_submit, async_submit = self._device_submitters(sets)
        try:
            t0 = time.time()
            if async_submit is None:
                # device backend without async submission (test stubs):
                # serve synchronously through the same accounting
                r = sync_submit(sets, rands)
                self._record_device_ok(bucket, time.time() - t0, len(sets))
                _note_route("device", "ok", len(sets))
                return api._ReadyHandle(r)
            return _Handle(async_submit(sets, rands), t0)
        except Exception as e:
            self._record_device_error(e)
            _note_route("host", "device_error", len(sets))
            return api._ReadyHandle(self._host().verify_signature_sets(sets, rands))

    def __getattr__(self, name):
        # accelerated primitives (device MSM / pairing product for KZG)
        # exist as attributes ONLY while the device is up — consumers probe
        # with getattr(..., None) and fall back to their host paths
        # (crypto/kzg.py), so a lost card degrades instead of crashing
        if name in ("g1_msm", "g1_msm_fixed", "pairing_product_is_one"):
            if self._device_state() == "up" and self._device is not None:
                return getattr(self._device, name)
        raise AttributeError(name)

    def verify_single(self, pk, message: bytes, sig) -> bool:
        if sig.is_infinity():
            return False
        from .signature_set import SignatureSet

        return self.verify_signature_sets([SignatureSet(sig, (pk,), message)], [1])

    def aggregate_verify(self, pks, messages, sig) -> bool:
        state = self._device_state()
        if state != "up":
            reason = f"device_{state}"
        elif not self._breaker.allow():
            reason = "circuit_open"
        else:
            try:
                t0 = time.time()
                ok = self._device.aggregate_verify(pks, messages, sig)
                # same stall-budget rule as _record_device_ok: a verify
                # that completes too late to be useful is a breaker
                # failure, or mixed single+batch traffic on a stalled
                # device would never accumulate 3 consecutive failures
                if time.time() - t0 > self._stall_budget_secs:
                    self._breaker.record_failure()
                else:
                    self._breaker.record_success()
                _note_route("device", "ok")
                return ok
            except Exception as e:
                self._record_device_error(e)
                reason = "device_error"
        _note_route("host", reason)
        return self._host().aggregate_verify(pks, messages, sig)
