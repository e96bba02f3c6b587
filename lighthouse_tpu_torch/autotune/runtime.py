"""Process-global autotune state: the installed profile/plan + warmup (the
port's copy of the JAX package's autotune/runtime.py).

`install_profile` makes a profile (and its derived Plan) the process-wide
source of serving knobs; `active_plan` is what the consumers — the hybrid
router's budgets and the torch dispatcher's depth — consult. With nothing
installed they fall back to their hard-coded defaults.

`autoload` restores a persisted profile for the current card. Device
identity reads torch.cuda, so detection runs in a daemon thread with a
bounded wait, and a process whose card cannot be reached serves on
defaults.

`start_warmup` is the consumer of the plan's warmup buckets: a daemon
thread that warms each planned (n_sets, n_pks) shape — through the hybrid
router's `warm_bucket` on "hybrid", through the torch backend's
`warm_stages` on "torch" — so the first real batches skip the kernel
library's load and the first-use cost at that shape.
"""

from __future__ import annotations

import os
import threading
import weakref

from ..utils.logging import get_logger
from .planner import DEFAULT_WARMUP_BUCKETS, Plan, plan_from_profile
from .profile import BACKEND_REVISION, DeviceProfile

_lock = threading.Lock()
_state: dict = {"profile": None, "plan": None}
# plan-change listeners (weak refs — consumers are long-lived singletons
# in a running process, but tests construct many HybridBackends and a dead
# listener must not pin one). Called OUTSIDE _lock with the new Plan (or
# None on clear) so a listener may read active_plan()/take its own locks.
_listeners: list = []


def add_plan_listener(fn) -> None:
    """Register `fn(plan_or_none)` to run whenever a profile is installed
    or cleared at runtime — the mechanism consumers (the hybrid router's
    budgets, the torch dispatcher's depth) use to re-resolve
    profile-derived knobs WITHOUT a restart. Bound methods are held via
    WeakMethod: a garbage-collected owner silently unsubscribes."""
    try:
        ref = weakref.WeakMethod(fn)
    except TypeError:
        ref = weakref.ref(fn)
    with _lock:
        _listeners.append(ref)


def _notify_listeners(plan) -> None:
    with _lock:
        refs = list(_listeners)
    for ref in refs:
        fn = ref()
        if fn is None:
            with _lock:
                try:
                    _listeners.remove(ref)
                except ValueError:
                    pass
            continue
        try:
            fn(plan)
        except Exception as e:  # a listener must never break install
            get_logger("autotune").warn(
                "plan listener failed", error=f"{type(e).__name__}: {e}"
            )


def _record_refusal(reason: str, profile: DeviceProfile, path, **fields):
    """Profile refusals are bring-up facts an incident dump should carry
    (an operator wondering why the process serves on defaults reads the
    flight recorder, not the startup scroll)."""
    try:
        from ..observability.flight_recorder import RECORDER

        RECORDER.record(
            "autotune_profile_refused", severity="warn", reason=reason,
            path=str(path or ""), **fields,
        )
    except Exception:
        pass  # diagnostics must never break install


def install_profile(profile: DeviceProfile, path: str | None = None,
                    allow_stale: bool = False,
                    live_mesh_shape: str | None = None) -> Plan | None:
    """Make `profile` the process-wide knob source; returns its Plan.

    A STALE profile — measured under a different BACKEND_REVISION (an
    older build of the port, or the JAX package) — is refused (returns
    None, the
    consumers keep their current knobs): budgets and caps derived from a
    dead kernel structure misroute the live one. The same contract covers
    TOPOLOGY: when the caller knows the live mesh shape (`live_mesh_shape`
    — autoload passes the detected key's, "single" on one card),
    a profile calibrated on a different topology is refused too — its
    padding buckets, per-chip caps and collective budgets describe a mesh
    this process is not serving on. `allow_stale=True` is the explicit
    operator override (LIGHTHOUSE_TPU_AUTOTUNE_PROFILE names a file on
    purpose) for BOTH refusals; the rejection is still logged loudly and
    lands in the flight recorder either way."""
    if profile.is_stale():
        log = get_logger("autotune")
        if not allow_stale:
            log.warn(
                "STALE autotune profile refused (backend revision "
                "mismatch); calibrate on this build",
                profile_revision=str(profile.key.get("backend_revision")),
                current_revision=BACKEND_REVISION,
                path=path or "",
            )
            _record_refusal(
                "stale_revision", profile, path,
                profile_revision=str(profile.key.get("backend_revision")),
                current_revision=BACKEND_REVISION,
            )
            return None
        log.warn(
            "installing STALE autotune profile (operator override); its "
            "numbers were measured on a different kernel structure",
            profile_revision=str(profile.key.get("backend_revision")),
            current_revision=BACKEND_REVISION,
        )
    if profile.mesh_mismatch(live_mesh_shape):
        log = get_logger("autotune")
        if not allow_stale:
            log.warn(
                "autotune profile refused (mesh topology mismatch); "
                "calibrate on this topology",
                profile_mesh=str(profile.mesh_shape),
                live_mesh=str(live_mesh_shape),
                path=path or "",
            )
            _record_refusal(
                "mesh_mismatch", profile, path,
                profile_mesh=str(profile.mesh_shape),
                live_mesh=str(live_mesh_shape),
            )
            return None
        log.warn(
            "installing MESH-MISMATCHED autotune profile (operator "
            "override); its buckets/budgets were measured on a different "
            "topology",
            profile_mesh=str(profile.mesh_shape),
            live_mesh=str(live_mesh_shape),
        )
    plan = plan_from_profile(profile)
    measured_backend = profile.key.get("bls_backend")
    if measured_backend not in (None, "torch"):
        # e.g. a CPU profile pinned via LIGHTHOUSE_TPU_AUTOTUNE_PROFILE:
        # install it (the operator asked), but say loudly that its numbers
        # were not measured on the device path the process will serve with
        get_logger("autotune").warn(
            "installed profile was measured on a non-device backend; its "
            "derived knobs may not fit the torch serving path",
            measured_backend=measured_backend,
        )
    with _lock:
        _state["profile"] = profile
        _state["plan"] = plan
    get_logger("autotune").info(
        "autotune profile installed",
        source=plan.source,
        path=path or "",
        max_attestation_batch=plan.max_attestation_batch,
        max_aggregate_batch=plan.max_aggregate_batch,
        p99_budget_ms=plan.p99_budget_ms,
        urgent_max_sets=plan.urgent_max_sets,
        pipeline_depth=plan.pipeline_depth,
        msm_window=plan.msm_window,
        warmup_buckets=str(list(plan.warmup_buckets)),
    )
    _notify_listeners(plan)
    return plan


def install_runtime_plan(plan: Plan) -> Plan:
    """Make a RUNTIME-derived plan (a control loop's retune) the
    process-wide knob source and notify the plan listeners — the same
    actuation path a profile install uses, so the hybrid router and the
    torch dispatcher pick the change up live with their env/constructor
    precedence layers untouched. The installed PROFILE is untouched: a
    later real `install_profile` replaces this plan wholesale. The plan's
    `source` should name the producer so consumers and logs can tell a
    control-loop retune from a calibration."""
    with _lock:
        _state["plan"] = plan
    _notify_listeners(plan)
    return plan


def active_plan() -> Plan | None:
    with _lock:
        return _state["plan"]


def active_profile() -> DeviceProfile | None:
    with _lock:
        return _state["profile"]


def clear() -> None:
    """Uninstall (tests): consumers return to the hard-coded defaults."""
    with _lock:
        _state["profile"] = None
        _state["plan"] = None
    _notify_listeners(None)


# ---------------------------------------------------------------- autoload


def detect_device_key(wait_secs: float = 5.0) -> dict | None:
    """Resolve the current device key in a daemon thread bounded by
    `wait_secs` (the first CUDA call of a process can take seconds).
    Returns None on timeout or any detection failure."""
    from . import profile as prof

    result: list = []
    done = threading.Event()

    def detect():
        try:
            result.append(prof.current_device_key())
        except Exception as e:  # no device / import failure
            result.append(e)
        done.set()

    threading.Thread(target=detect, daemon=True,
                     name="autotune-device-detect").start()
    if not done.wait(wait_secs):
        return None
    if not result or isinstance(result[0], Exception):
        return None
    return result[0]


def autoload(wait_secs: float | None = None,
             path: str | None = None) -> Plan | None:
    """Load + install a persisted profile for the current device, if any.

    Resolution order: LIGHTHOUSE_TPU_AUTOTUNE=0 disables everything; an
    explicit `path` (or LIGHTHOUSE_TPU_AUTOTUNE_PROFILE) is loaded without
    device detection; otherwise the device key is resolved in a daemon
    thread bounded by `wait_secs` (LIGHTHOUSE_TPU_AUTOTUNE_WAIT_SECS,
    default 5 s) and the canonical per-device file is tried. Returns the
    installed Plan, or None (no profile / disabled / detection timeout) —
    never raises, never blocks unboundedly."""
    log = get_logger("autotune")
    if os.environ.get("LIGHTHOUSE_TPU_AUTOTUNE", "1") in ("0", "off", "no"):
        return None
    from . import profile as prof

    if wait_secs is None:
        try:
            wait_secs = float(
                os.environ.get("LIGHTHOUSE_TPU_AUTOTUNE_WAIT_SECS", 5.0)
            )
        except ValueError:
            wait_secs = 5.0

    path = path or os.environ.get("LIGHTHOUSE_TPU_AUTOTUNE_PROFILE")
    if path:
        try:
            loaded = prof.load(path)
            # an explicitly named profile is an operator override: a
            # stale revision or mesh mismatch installs WITH a loud
            # warning instead of being refused (the canonical-path
            # branch below stays strict — its filename embeds the
            # revision AND the topology). The mismatch warning still
            # needs the LIVE topology: detect it with the same bounded
            # wait (detection failure -> None -> unknowable, no check —
            # the override installs either way, so this never blocks a
            # start beyond wait_secs).
            live = None
            if loaded.mesh_shape is not None:
                key = detect_device_key(wait_secs)
                live = key.get("mesh_shape") if key else None
            return install_profile(loaded, path=path, allow_stale=True,
                                   live_mesh_shape=live)
        except Exception as e:
            log.warn("autotune profile load failed; serving on defaults",
                     path=path, error=f"{type(e).__name__}: {e}")
            return None

    key = detect_device_key(wait_secs)
    if key is None:
        log.warn("autotune device detection failed or timed out; serving "
                 "on defaults", wait_secs=wait_secs)
        return None
    candidate = prof.default_path(key)
    if not os.path.isfile(candidate):
        log.info("no autotune profile for this device; serving on defaults",
                 expected_path=candidate)
        return None
    try:
        # belt and braces: the canonical filename embeds the topology, but
        # the key INSIDE the file is what install checks against the
        # detected live mesh (a renamed/copied file must still be refused)
        return install_profile(prof.load(candidate), path=candidate,
                               live_mesh_shape=key.get("mesh_shape"))
    except Exception as e:
        log.warn("autotune profile load failed; serving on defaults",
                 path=candidate, error=f"{type(e).__name__}: {e}")
        return None


# ----------------------------------------------------------------- warmup


def warmup_buckets() -> tuple:
    """The active plan's warmup buckets, or the default pair."""
    plan = active_plan()
    return plan.warmup_buckets if plan is not None else DEFAULT_WARMUP_BUCKETS


def start_warmup(buckets=None, warm_fn=None,
                 supervisor=None) -> threading.Thread:
    """Warm the warmup buckets in a background daemon thread.

    Called from node bring-up (cli.cmd_bn) when a device-backed BLS
    backend is selected. On the hybrid backend the buckets warm through
    `HybridBackend.warm_bucket` — a full-pipeline dummy verify that also
    marks the bucket warm for ROUTING (its own probe bounds the device
    wait); on the plain torch backend they warm through the torch
    backend's `warm_stages` (which builds or loads the kernel library and
    runs one dummy verify at the bucket on the card — safe to block HERE,
    it is a daemon thread). `warm_fn(n_sets, n_pks)` replaces both (tests).
    Times land in the profiler either way. With a `supervisor`
    (utils/supervisor.py) a failed attempt is retried with backoff; without
    one any failure degrades to first-use cost on the first dispatch,
    never to a crashed process."""
    log = get_logger("autotune")
    plan_buckets = tuple(buckets) if buckets is not None else warmup_buckets()

    def attempt():
        # raises on failure — the CALLER owns the retry policy (see below)
        if warm_fn is not None:
            fn = warm_fn
        else:
            from ..crypto.bls import api as bls_api

            backend = bls_api.get_backend()
            if hasattr(backend, "warm_bucket"):
                fn = backend.warm_bucket
            else:
                from ..crypto.torchbls.backend import warm_stages as fn
        import time as _time

        for n_sets, n_pks in plan_buckets:
            t0 = _time.time()
            ok = fn(n_sets, n_pks)
            if ok is False:  # warm_bucket: device down/failed (None =
                log.warn(    # warm_stages, which raises on failure)
                    "warmup bucket skipped (device unavailable or "
                    "warm failed)", n_sets=n_sets, n_pks=n_pks,
                )
            else:
                log.info("warmup bucket done", n_sets=n_sets,
                         n_pks=n_pks, secs=round(_time.time() - t0, 1))

    if supervisor is not None:
        # node bring-up path: a warmup crash retries with backoff instead
        # of degrading straight to first-use cost (utils/supervisor.py)
        return supervisor.spawn(attempt, "autotune_warmup")

    def run():
        try:
            attempt()
        except Exception as e:
            log.warn("startup warmup abandoned (first dispatches will "
                     "pay the first-use cost)",
                     error=f"{type(e).__name__}: {e}")

    t = threading.Thread(target=run, daemon=True, name="autotune-warmup")
    t.start()
    return t
