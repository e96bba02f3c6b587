"""Hybrid tree-hash routing: hashlib below the threshold, device above.

The port of lighthouse_tpu/jaxhash/router.py, with the reference's routing,
threshold, breaker and counters; its device is the card (engine.py). Every
large merkleization (ssz/core.merkleize, ssz/tree_cache._build) asks the
router first; the decision is counted ONCE in
`tree_hash_route_total{path,reason}` by the path that finally served it —
the exact contract of `bls_hybrid_route_total`, so one dashboard reads
both workloads the same way.

Routing policy:
  - backend "host"                    -> host, always (reason backend_host):
    how a caller asks for hashlib. The port's default is "device", where
    the reference's is "host": the port's entry points run on the card
    unless the caller asks for the CPU (as its BLS default is "torch").
  - below `min_leaves`                -> host (reason small): the hashlib
    SHA-NI ladder beats any device round trip on small trees
  - breaker OPEN (backend "hybrid")   -> host, O(1) refusal (reason
    circuit_open). The breaker trips on consecutive device failures;
    recovery is half-open probe-driven (qos/breaker.py),
    state exported as `tree_hash_circuit_state`. Backend "device" skips
    the open-circuit refusal (an operator pinning the device path wants
    every attempt) but still records outcomes.
  - device dispatch raises, "hybrid"  -> host answers (reason
    device_error), failure recorded.
  - device dispatch raises, "device"  -> the failure is recorded and the
    error reaches the caller: no host ladder hides the card. (The
    reference's host ladder answers under both backends; here only the
    operator's explicit "hybrid" buys that fallback.)
  - otherwise                         -> device (reason ok).
"""

from __future__ import annotations

import os
import threading

from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

HASH_BACKENDS = ("host", "device", "hybrid")
DEFAULT_MIN_LEAVES = 1024

_ROUTE = REGISTRY.counter_vec(
    "tree_hash_route_total",
    "large-tree merkleizations by the path that served them and the "
    "routing reason (the tree-hash analog of bls_hybrid_route_total)",
    ("path", "reason"),
)
_CIRCUIT_STATE = REGISTRY.gauge(
    "tree_hash_circuit_state",
    "tree-hash device-path circuit breaker state (0=closed, 1=open, "
    "2=half_open); DEPRECATED alias of circuit_state{workload=\"tree_hash\"}",
)

_state = {"backend": None}


def hash_backend() -> str:
    """The active hash backend: explicit set_hash_backend >
    LIGHTHOUSE_TPU_HASH_BACKEND > "device"."""
    if _state["backend"] is not None:
        return _state["backend"]
    env = os.environ.get("LIGHTHOUSE_TPU_HASH_BACKEND", "").strip().lower()
    return env if env in HASH_BACKENDS else "device"


def set_hash_backend(name: str | None) -> None:
    """Pin the hash backend for this process (None reverts to env/default
    resolution)."""
    if name is not None and name not in HASH_BACKENDS:
        raise ValueError(
            f"unknown hash backend {name!r} (have: {', '.join(HASH_BACKENDS)})"
        )
    _state["backend"] = name


class TreeHashRouter:
    """One process-wide instance (ROUTER below) owns the breaker and the
    threshold; tests construct private ones."""

    def __init__(self, min_leaves: int | None = None):
        if min_leaves is None:
            raw = os.environ.get("LIGHTHOUSE_TPU_HASH_MIN_LEAVES", "").strip()
            try:
                min_leaves = int(raw) if raw else DEFAULT_MIN_LEAVES
            except ValueError:
                min_leaves = DEFAULT_MIN_LEAVES
        self.min_leaves = max(2, int(min_leaves))
        self._log = get_logger("torchhash.router")
        from ..qos.breaker import CircuitBreaker

        self._breaker = CircuitBreaker(
            "tree_hash_device", failure_threshold=3,
            state_gauge=_CIRCUIT_STATE, workload="tree_hash",
        )

    # ------------------------------------------------------------- routing

    def allow_device(self) -> bool:
        """Breaker admission for OTHER device consumers sharing this
        device (the epoch-vector stage): open = refuse O(1); a half-open
        True claims the probe slot, so the caller MUST report the attempt
        via record_device."""
        return self._breaker.allow()

    def record_device(self, ok: bool) -> None:
        (self._breaker.record_success if ok
         else self._breaker.record_failure)()

    def _route(self, n_leaves: int) -> tuple[str, str]:
        backend = hash_backend()
        if backend == "host":
            return "host", "backend_host"
        if n_leaves < self.min_leaves:
            return "host", "small"
        if backend == "hybrid" and not self._breaker.allow():
            return "host", "circuit_open"
        return "device", "ok"

    def maybe_build_levels(self, leaves, depth: int, n_leaves: int | None = None,
                           root_only: bool = False, min_level: int = 0):
        """(levels, root) exactly as ssz/tree_cache._build would return,
        via the device — or None when the host path should serve (the
        caller runs its unchanged hashlib ladder). A device failure falls
        to the host only under backend "hybrid"; under "device" it is
        recorded and raised. `leaves`
        may be a zero-arg callable producing the (n, 32) uint8 array (with
        `n_leaves` given), so a host-routed call never pays the marshal;
        `root_only` skips the per-level device->host transfers (levels
        comes back None); `min_level` lets a caller that retains only the
        upper levels (the CoW spine) skip the device->host transfers of
        everything below it — those entries come back None."""
        n = int(n_leaves if n_leaves is not None else leaves.shape[0])
        path, reason = self._route(n)
        if path == "host":
            _ROUTE.labels("host", reason).inc()
            return None
        if callable(leaves):
            leaves = leaves()
        from . import engine

        try:
            # min_level only when asked: the 2-kwarg call shape is the
            # stable seam tests/monkeypatched engines rely on
            kw = {"min_level": min_level} if min_level else {}
            result = engine.device_build_levels(leaves, depth,
                                                root_only=root_only, **kw)
        except Exception as e:
            self._breaker.record_failure()
            if hash_backend() != "hybrid":
                raise
            self._log.warn(
                "device tree hash failed; host ladder serves",
                n_leaves=n, error=f"{type(e).__name__}: {e}",
            )
            _ROUTE.labels("host", "device_error").inc()
            return None
        self._breaker.record_success()
        _ROUTE.labels("device", "ok").inc()
        return result

    def prefer_full_build(self, n_leaves: int, n_dirty_leaves: int) -> bool:
        """The CoW incremental-vs-rebuild decision: per-chunk host rehash
        wins while the dirty fraction is small; past it a full ladder is
        cheaper — and when the full ladder would be served by the DEVICE
        the crossover drops (the rebuild amortizes over the mesh while
        the dirty-path rehash is always host-serial)."""
        path, _ = self._route(n_leaves)
        if path == "device":
            return n_dirty_leaves * 4 >= n_leaves
        return n_dirty_leaves > max(64, n_leaves // 8)

    def maybe_tree_root(self, leaves, depth: int, n_leaves: int | None = None):
        """Root-only entry for ssz/core.merkleize: bytes, or None for the
        host ladder. Only the top device level transfers to host."""
        routed = self.maybe_build_levels(leaves, depth, n_leaves=n_leaves,
                                         root_only=True)
        return None if routed is None else routed[1]


ROUTER = TreeHashRouter()


def route_totals() -> dict:
    """{"path/reason": count} snapshot of tree_hash_route_total (the
    reference's loadgen scenario and chip_smoke.py's state_root path read
    its per-run delta)."""
    return {
        "/".join(str(v) for v in key): child.value
        for key, child in _ROUTE.children()
    }


# ------------------------------------------------------------------ warmup


def start_warmup(buckets=None) -> threading.Thread:
    """Run the ladder once at each bucket in a daemon thread, so the first
    real state root skips the kernels' build. Without `buckets` it warms
    the installed autotune plan's `tree_hash_warmup` (the calibrated
    `tree_hash_buckets`), else the validator-registry scale the state root
    hits first. Any failure degrades to a cold first root, never a crashed
    caller."""
    log = get_logger("torchhash.warmup")
    if buckets is None:
        plan = None
        try:
            from ..autotune import runtime

            plan = runtime.active_plan()
        except Exception:
            pass
        buckets = tuple(getattr(plan, "tree_hash_warmup", ()) or ()) or (16384,)

    def run():
        from . import engine

        for n_leaves in buckets:
            try:
                secs = engine.warm_tree_bucket(int(n_leaves))
                log.info("tree-hash bucket warmed", n_leaves=int(n_leaves),
                         secs=round(secs, 1))
            except Exception as e:
                log.warn("tree-hash bucket warm failed",
                         n_leaves=int(n_leaves),
                         error=f"{type(e).__name__}: {e}")

    t = threading.Thread(target=run, daemon=True, name="torchhash-warmup")
    t.start()
    return t
