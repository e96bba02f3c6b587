"""Program analytics and roofline attribution of the verify's stages (the
port's copy of the first half of the JAX package's observability/perf.py;
its bench-trend half comes with the port's benchmark).

Two jobs, no torch at import time:

1. **Program analytics** — at a stage's warm-up (`warm_stages`) or its
   first attributed dispatch per bucket, capture the work the stage does at
   its inputs: where the reference reads a compiled XLA program's
   `cost_analysis()` and `memory_analysis()`, the port counts the stage's
   own work (crypto/torchbls/costs.py `stage_stats`): its 32-bit integer
   instructions (`int_ops`: 600 IMADs per Fq product, 41,548 per
   binary-GCD inversion), the bytes it must move (`bytes_accessed`: 48 B
   per Fq element, a bit per flag) and its tensors' footprint
   (`argument_bytes`, `output_bytes`). Each capture lands as labeled
   `torchbls_program_*` gauges, in the autotune profiler's per-bucket
   recorders (so the persisted device profile carries the program's work
   next to the measured timings — autotune/profile.py `programs`), and in
   the in-memory snapshot. Stats carry `int_ops` where the reference's
   carry `flops`: the verify does integer work only.

2. **Roofline** — `roofline(stats, secs, device_kind)` turns a stage's
   instructions and bytes plus a measured stage time into achieved rates
   against the card's peaks (`PEAK_ESTIMATES`, overridable via
   LIGHTHOUSE_TPU_PEAK_INT_OPS / LIGHTHOUSE_TPU_PEAK_HBM_GBPS), and the
   stage's share of its bound: the least time the card could take for the
   same work over the time it took. A share above 1 means a miscount.
"""

from __future__ import annotations

import os
import threading

from ..utils.metrics import REGISTRY

# ------------------------------------------------------------------ metrics

PROGRAM_INT_OPS = REGISTRY.gauge_vec(
    "torchbls_program_int_ops",
    "32-bit integer instructions the stage's work needs at its inputs "
    "(600 per Fq product, 41,548 per binary-GCD inversion), by stage and "
    "padding bucket",
    ("stage", "n_sets", "n_pks"),
)
PROGRAM_BYTES_ACCESSED = REGISTRY.gauge_vec(
    "torchbls_program_bytes_accessed",
    "bytes the stage must move at its inputs (48 per Fq element, a bit per "
    "flag; arguments read once, outputs written once), by stage and padding "
    "bucket",
    ("stage", "n_sets", "n_pks"),
)
PROGRAM_BYTES = REGISTRY.gauge_vec(
    "torchbls_program_bytes",
    "bytes the stage's argument and output tensors hold in the port's "
    "layout, by stage, padding bucket and region (argument/output)",
    ("stage", "n_sets", "n_pks", "region"),
)

_lock = threading.Lock()
_programs: dict = {}       # (stage, (n, m)) -> stats dict
_analytics_override: bool | None = None

#: peak (32-bit integer instructions/s, HBM bytes/s) per device kind
#: PREFIX; the longest matching prefix wins. One H100 SXM, the card
#: `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` names
#: "NVIDIA H100 80GB HBM3, 700.00 W": 64 integer instructions per clock per
#: SM x 132 SMs x 1.98 GHz = 16.7 T/s, and 3.35 TB/s (crypto/torchbls/
#: costs.py; the bounds of chip_smoke.py use the same row). Below the power
#: limit the card clocks lower, so the peaks are estimates.
PEAK_ESTIMATES = {
    "NVIDIA H100 80GB HBM3": (64 * 132 * 1.98e9, 3.35e12),
}


def set_analytics(on: bool | None) -> bool | None:
    """Force program-analytics capture on/off; returns the previous
    override so scoped callers can restore it."""
    global _analytics_override
    prev = _analytics_override
    _analytics_override = None if on is None else bool(on)
    return prev


def analytics_enabled() -> bool:
    if _analytics_override is not None:
        return _analytics_override
    env = os.environ.get("LIGHTHOUSE_TPU_PROGRAM_ANALYTICS", "").lower()
    return env in ("1", "on", "yes", "true")


def maybe_capture_program(stage: str, fn, args, bucket: tuple, out=None):
    """capture_program once per (stage, bucket); later calls are free."""
    key = (stage, (int(bucket[0]), int(bucket[1])))
    with _lock:
        if key in _programs:
            return _programs[key]
    return capture_program(stage, fn, args, bucket, out)


def capture_program(stage: str, fn, args, bucket: tuple, out=None) -> dict | None:
    """Count one stage's work at concrete arguments and record it. `out`
    is the stage's output on them; without it `fn(*args)` runs once more to
    give it. Best-effort: any failure returns None and records nothing (a
    diagnostics call must not cost the verify path)."""
    try:
        from ..crypto.torchbls import costs

        if out is None:
            out = fn(*args)
        stats = costs.stage_stats(stage, args, out)
    except Exception:
        return None
    record_program(stage, bucket, stats)
    return stats


def record_program(stage: str, bucket: tuple, stats: dict) -> None:
    """Publish one program's stats: gauges, snapshot, autotune recorder."""
    n, m = int(bucket[0]), int(bucket[1])
    PROGRAM_INT_OPS.labels(stage, n, m).set(stats.get("int_ops", 0.0))
    PROGRAM_BYTES_ACCESSED.labels(stage, n, m).set(stats.get("bytes_accessed", 0.0))
    for region in ("argument", "output"):
        v = stats.get(f"{region}_bytes")
        if v is not None:
            PROGRAM_BYTES.labels(stage, n, m, region).set(v)
    with _lock:
        _programs[(stage, (n, m))] = dict(stats)
    try:
        from ..autotune import profiler

        profiler.observe_program(n, m, stage, stats)
    except Exception:
        pass  # diagnostics must never raise into the dispatch path


def program_stats(stage: str, bucket: tuple) -> dict | None:
    with _lock:
        st = _programs.get((stage, (int(bucket[0]), int(bucket[1]))))
    return dict(st) if st else None


def program_snapshot() -> dict:
    """{"<n>x<m>": {stage: stats}} for everything captured so far."""
    with _lock:
        items = list(_programs.items())
    out: dict = {}
    for (stage, (n, m)), stats in items:
        out.setdefault(f"{n}x{m}", {})[stage] = dict(stats)
    return out


def reset_programs() -> None:
    """Drop captured program stats (tests)."""
    with _lock:
        _programs.clear()


# ----------------------------------------------------------------- roofline


def peak_for(device_kind: str | None) -> tuple | None:
    """(peak integer instructions/s, peak HBM bytes/s) ESTIMATE for a
    device kind. Env overrides (LIGHTHOUSE_TPU_PEAK_INT_OPS tera
    instructions/s, LIGHTHOUSE_TPU_PEAK_HBM_GBPS gigabytes/s) beat the
    table: both set, for any kind or none; one set, in place of that peak of
    the kind's row."""
    env_i = os.environ.get("LIGHTHOUSE_TPU_PEAK_INT_OPS")
    env_b = os.environ.get("LIGHTHOUSE_TPU_PEAK_HBM_GBPS")
    if env_i and env_b:
        return float(env_i) * 1e12, float(env_b) * 1e9
    if not device_kind:
        return None
    best = None
    for prefix, peaks in PEAK_ESTIMATES.items():
        if device_kind.lower().startswith(prefix.lower()):
            if best is None or len(prefix) > best[0]:
                best = (len(prefix), peaks)
    if best is None:
        return None
    pi, pb = best[1]
    if env_i:
        pi = float(env_i) * 1e12
    if env_b:
        pb = float(env_b) * 1e9
    return pi, pb


def roofline(stats: dict, secs: float, device_kind: str | None) -> dict | None:
    """Achieved against peak throughput for one stage execution.

    `stats` is a capture_program dict; `secs` a measured time of one
    execution of that stage. Returns achieved instructions/s and bytes/s,
    and where a peak exists their utilization, the wall the stage is closer
    to ("compute" or "memory"), the stage's bound (the larger of its
    instructions over the integer peak and its bytes over HBM's) and
    `bound_share`, the bound over the measured time."""
    if not secs or secs <= 0:
        return None
    ops = float(stats.get("int_ops") or 0.0)
    byts = float(stats.get("bytes_accessed") or 0.0)
    out = {
        "seconds": round(secs, 6),
        "achieved_gops_per_sec": round(ops / secs / 1e9, 3),
        "achieved_gbytes_per_sec": round(byts / secs / 1e9, 3),
        "peak_note": "peaks are ESTIMATES (PEAK_ESTIMATES / env overrides)",
    }
    peaks = peak_for(device_kind)
    if peaks is not None:
        pi, pb = peaks
        iu = ops / secs / pi if pi else 0.0
        bu = byts / secs / pb if pb else 0.0
        out.update(
            int_ops_utilization=round(iu, 6),
            hbm_utilization=round(bu, 6),
            bound="memory" if bu > iu else "compute",
            bound_ms=max(ops / pi if pi else 0.0, byts / pb if pb else 0.0) * 1e3,
            bound_share=max(iu, bu),
            device_kind=device_kind,
        )
    return out
