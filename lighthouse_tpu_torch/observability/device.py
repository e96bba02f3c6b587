"""Per-stage device-time attribution for the torch verify pipeline (the
port's copy of the JAX package's observability/device.py).

The dispatch path runs four stages (prepare, hash-to-G2, pairs, pairing —
`crypto/torchbls/backend.py`) without waiting: the host enqueues all four
and waits once, on the verdict. That is the right shape for throughput,
but it makes the card a single opaque span, and nothing says WHICH stage
holds it.

This module is the one owner of per-stage device timing:

  - `run_stage(attr, stage, fn, *args)` wraps every stage dispatch. In
    the default (attribution OFF) mode it only opens an NVTX range
    `torchbls:<stage>` around a dispatch on the card — nanoseconds when no
    profiler is attached, and the stage shows up named in a profiler's
    timeline when one is. Dispatch stays asynchronous.
  - With attribution ON (the calibrator, `profile_stages`, env
    `LIGHTHOUSE_TPU_DEVICE_ATTRIBUTION=1`), each stage dispatch on the card
    is bracketed by two CUDA events on the current stream, and the host
    waits on the end event, which SERIALIZES the pipeline — attribution is
    a diagnostic mode, not a serving mode. The events' elapsed time lands
    in `torchbls_stage_device_seconds{stage,n_sets,n_pks}`; the FIRST timed
    dispatch of a (stage, bucket) in a process is classified as the stage's
    first use (the kernel library's load and the first launch at that
    shape) and lands in `torchbls_stage_compile_seconds{stage,n_sets,n_pks}`
    instead (the first-dispatch convention of the autotune profiler). Each
    dispatch also adds a `device:<stage>` sub-span with host perf_counter
    bounds to the current pipeline Trace, so the Chrome/Perfetto export
    renders host lanes AND a device lane per stage in one timeline
    (observability/trace.py routes `device:*` spans onto their own tracks).
  - When program analytics are also enabled (observability/perf.py), the
    first attributed dispatch per (stage, bucket) counts the stage's work
    into the `torchbls_program_*` gauges and the autotune profile.

On CPU tensors (the plain versions) there is no NVTX range and no event:
the lane is host perf_counter. The tensor's device picks the lane, as
crypto/torchbls/kernels.py's wrappers pick theirs. Nothing here imports
torch or touches CUDA at import.
"""

from __future__ import annotations

import os
import threading
from time import perf_counter

from ..utils.metrics import REGISTRY
from . import perf as _perf

#: the verify's stage order (crypto/torchbls/backend.py TorchBackend.run)
STAGES = ("prepare", "h2c", "pairs", "pairing")

#: Trace span-name prefix that routes a span onto a device lane in the
#: Chrome trace-event export (observability/trace.py)
DEVICE_SPAN_PREFIX = "device:"

#: NVTX range prefix of a stage dispatch on the card
NVTX_PREFIX = "torchbls:"

# stage times span tens of microseconds (a small bucket on the card) to
# minutes (a first use that builds the kernel library)
_STAGE_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0, 300.0,
)

STAGE_DEVICE_SECONDS = REGISTRY.histogram_vec(
    "torchbls_stage_device_seconds",
    "attributed per-stage device time (CUDA events around the stage's "
    "launches; host time on CPU tensors), by stage and padding bucket; "
    "steady-state dispatches only — the first per (stage, bucket) lands in "
    "torchbls_stage_compile_seconds",
    ("stage", "n_sets", "n_pks"),
    buckets=_STAGE_BUCKETS,
)
STAGE_COMPILE_SECONDS = REGISTRY.gauge_vec(
    "torchbls_stage_compile_seconds",
    "first attributed dispatch per (stage, padding bucket): the kernel "
    "library's load (or build) and the first launch at that shape "
    "(autotune first-dispatch convention)",
    ("stage", "n_sets", "n_pks"),
)

_lock = threading.Lock()
_seen: set = set()          # (stage, bucket) pairs that dispatched timed once
_enabled_override: bool | None = None


def set_enabled(on: bool | None) -> None:
    """Force attribution on/off for this process (None = back to env)."""
    global _enabled_override
    _enabled_override = None if on is None else bool(on)


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    env = os.environ.get("LIGHTHOUSE_TPU_DEVICE_ATTRIBUTION", "").lower()
    return env in ("1", "on", "yes", "true")


class attributed:
    """`with device.attributed():` — attribution on for a scope (the
    calibrator, profile_stages, tests); restores the previous override on
    exit."""

    def __enter__(self):
        global _enabled_override
        self._prev = _enabled_override
        _enabled_override = True
        return self

    def __exit__(self, *exc):
        global _enabled_override
        _enabled_override = self._prev
        return False


class DispatchAttribution:
    """Per-dispatch carrier: the padding bucket plus the pipeline Trace
    (if any) that device sub-spans should land in."""

    __slots__ = ("bucket", "trace")

    def __init__(self, bucket: tuple, trace=None):
        self.bucket = (int(bucket[0]), int(bucket[1]))
        self.trace = trace


def begin(bucket: tuple, trace=None) -> DispatchAttribution | None:
    """Attribution handle for one dispatch, or None when disabled (the
    hot-path default: stages stay asynchronous, only NVTX ranges)."""
    if not enabled():
        return None
    if trace is None:
        from . import trace as _trace

        trace = _trace.current_trace()
    return DispatchAttribution(bucket, trace)


def _cuda_tensor(args):
    """The first CUDA tensor among the (nested) arguments, or None: a stage
    on CPU tensors runs its plain versions."""
    for a in args:
        if isinstance(a, (tuple, list)):
            t = _cuda_tensor(a)
            if t is not None:
                return t
        elif getattr(getattr(a, "device", None), "type", None) == "cuda":
            return a
    return None


def run_stage(attr: DispatchAttribution | None, stage: str, fn, *args):
    """Dispatch one stage (in an NVTX range on the card); with an
    attribution handle, also time it and record it."""
    on_card = _cuda_tensor(args) is not None
    if attr is None:
        if not on_card:
            return fn(*args)
        import torch

        with torch.cuda.nvtx.range(NVTX_PREFIX + stage):
            return fn(*args)
    t0 = perf_counter()
    if on_card:
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.nvtx.range(NVTX_PREFIX + stage):
            start.record()
            out = fn(*args)
            end.record()
        end.synchronize()
        t1 = perf_counter()
        secs = start.elapsed_time(end) / 1e3
    else:
        out = fn(*args)
        t1 = perf_counter()
        secs = t1 - t0
    _record(attr, stage, t0, t1, secs)
    if _perf.analytics_enabled():
        _perf.maybe_capture_program(stage, fn, args, attr.bucket, out)
    return out


def _record(attr: DispatchAttribution, stage: str, t0: float, t1: float,
            secs: float) -> None:
    key = (stage, attr.bucket)
    with _lock:
        first = key not in _seen
        _seen.add(key)
    n, m = attr.bucket
    if first:
        # first use (the library's load, the first launch at this shape) —
        # keep it out of the steady-state distribution
        STAGE_COMPILE_SECONDS.labels(stage, n, m).set(secs)
    else:
        STAGE_DEVICE_SECONDS.labels(stage, n, m).observe(secs)
    if attr.trace is not None:
        attr.trace.add_span(
            f"{DEVICE_SPAN_PREFIX}{stage}", t0, t1,
            phase="compile" if first else "execute", bucket=f"{n}x{m}",
        )


def reset_seen() -> None:
    """Forget compile/execute classification state (tests)."""
    with _lock:
        _seen.clear()


# --------------------------------------------------------------- snapshots


def snapshot_stages(device_kind: str | None = None) -> dict:
    """Per-bucket, per-stage timing summary from the attributed series,
    with roofline numbers where program analytics exist for the bucket.

    Shape: {"<n>x<m>": {stage: {count, mean_ms, total_s, compile_s?,
    roofline?}}}."""
    out: dict = {}
    for (stage, n, m), child in STAGE_DEVICE_SECONDS.children():
        if child.n == 0:
            continue
        mean_s = child.total / child.n
        entry = {
            "count": child.n,
            "mean_ms": round(mean_s * 1e3, 3),
            "total_s": round(child.total, 4),
        }
        stats = _perf.program_stats(stage, (int(n), int(m)))
        if stats is not None:
            rl = _perf.roofline(stats, mean_s, device_kind)
            if rl is not None:
                entry["roofline"] = rl
        out.setdefault(f"{n}x{m}", {})[stage] = entry
    for (stage, n, m), child in STAGE_COMPILE_SECONDS.children():
        if child.value:
            out.setdefault(f"{n}x{m}", {}).setdefault(stage, {})[
                "compile_s"
            ] = round(child.value, 6)
    return out


# ------------------------------------------------- standalone stage profiler


def profile_stages(
    n_sets: int, n_pks: int, reps: int = 3, seed: int = 7,
    analytics: bool = True, device=None,
) -> dict:
    """Time the four stages of crypto/torchbls/backend.py standalone at one
    padding bucket: a first rep (the first use, unless the process already
    dispatched the bucket), then `reps` timed dispatches each, chaining
    real intermediates (prepare's and h2c's outputs feed pairs, pairs feeds
    pairing). Every observation also lands in the torchbls_stage_* families
    and (with analytics) the torchbls_program_* gauges and the autotune
    profile.

    Inputs are random 16-bit interchange limbs with the top limb zero
    (field elements below p, not curve points: the stages' work does not
    depend on it), random 64-bit coefficients and full masks, from a numpy
    `seed`. Runs on the card unless `device` names another (torchcfg);
    initializes CUDA there."""
    import numpy as np
    import torch

    from ..crypto.torchbls import backend as be
    from ..crypto.torchbls import limbs as lb
    from ..utils import torchcfg

    dev = torchcfg.resolve_device(device)
    n, m = be.padding_bucket(n_sets, n_pks)
    rng = np.random.default_rng(seed)

    def rl(shape):
        # random < 2^16 per limb, top limb zero: a valid field element
        a = rng.integers(0, 1 << 16, size=shape + (lb.NL,), dtype=np.int64)
        a[..., -1] = 0
        return torch.from_numpy(a).to(dev)

    prepare_in = (
        rl((n, m)), rl((n, m)), torch.ones((n, m), dtype=torch.int64, device=dev),
        rl((n, 2)), rl((n, 2)),
        torch.from_numpy(rng.integers(0, 2, size=(n, be.Z_BITS), dtype=np.int64)).to(dev),
        torch.ones((n,), dtype=torch.int64, device=dev),
    )
    us = rl((n, 2, 2))

    prev_analytics = _perf.set_analytics(analytics)
    try:
        with attributed():
            for _ in range(reps + 1):   # +1: the first rep may be the first use
                attr = begin((n, m))
                z_pk, sig_acc, _bad = run_stage(attr, "prepare", be.stage_prepare, *prepare_in)
                h_jac = run_stage(attr, "h2c", be.stage_h2c, us)
                pairs = run_stage(attr, "pairs", be.stage_pairs, z_pk, h_jac, sig_acc,
                                  prepare_in[-1])
                run_stage(attr, "pairing", be.stage_pairing, *pairs)
    finally:
        _perf.set_analytics(prev_analytics)

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    snap = snapshot_stages(device_kind=kind)
    return {
        "bucket": [n, m],
        "device_kind": kind,
        "reps": reps,
        "stages": snap.get(f"{n}x{m}", {}),
        "programs": _perf.program_snapshot().get(f"{n}x{m}", {}),
    }
