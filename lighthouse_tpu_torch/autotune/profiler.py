"""Per-bucket timing recorder for the torch BLS dispatch (the port's copy
of the JAX package's autotune/profiler.py).

The torch backend calls `observe_dispatch` when a verify resolves and
`observe_compile` when `warm_stages` warms a bucket (crypto/torchbls/
backend.py). Each observation lands twice:

  - in the process metrics registry (utils/metrics.py), as LABELED
    per-bucket Prometheus series — `autotune_dispatch_seconds{n_sets=,
    n_pks=}` histograms plus `autotune_sets_per_sec{...}` /
    `autotune_compile_seconds{...}` gauges;
  - in an in-memory per-bucket recorder, from which `build_profile`
    snapshots a DeviceProfile.

First-dispatch classification: the first dispatch a process sees at a
bucket is ALWAYS folded into the bucket's compile cost rather than the
steady-state latency distribution — even after `warm_stages` recorded an
explicit warm-up. On the card the first dispatch of a process pays the
kernel library's load (and, in a fresh checkout, its nvcc build) and the
caching allocator's first allocations at that shape. compile_secs keeps
the max of the explicit warm and the first dispatch, so that cost never
inflates the p50/p99 series the planner derives budgets from.

Everything is best-effort and lock-guarded; an observation can never raise
into the dispatch path.
"""

from __future__ import annotations

import threading
from collections import deque

from ..utils.metrics import REGISTRY

# dispatch latency spans sub-ms cache hits to multi-minute cold compiles
DISPATCH_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0,
)
_MAX_SAMPLES = 512  # rolling latency window per bucket

_DISPATCHES_TOTAL = REGISTRY.counter(
    "autotune_dispatches_total",
    "multi-set verify dispatches observed by the autotune profiler",
)
_BUCKET_LABELS = ("n_sets", "n_pks")
_DISPATCH_SECONDS = REGISTRY.histogram_vec(
    "autotune_dispatch_seconds",
    "device dispatch wall time, by padding bucket",
    _BUCKET_LABELS,
    buckets=DISPATCH_BUCKETS,
)
_SETS_PER_SEC = REGISTRY.gauge_vec(
    "autotune_sets_per_sec",
    "achieved signature sets/sec, by padding bucket",
    _BUCKET_LABELS,
)
_COMPILE_SECONDS = REGISTRY.gauge_vec(
    "autotune_compile_seconds",
    "compile/first-dispatch wall time, by padding bucket",
    _BUCKET_LABELS,
)


class _BucketRecorder:
    __slots__ = (
        "n_sets", "n_pks", "compile_secs", "lats", "total_sets",
        "total_secs", "hist", "rate_gauge", "compile_gauge", "seen_first",
        "programs",
    )

    def __init__(self, n_sets: int, n_pks: int):
        self.n_sets = n_sets
        self.n_pks = n_pks
        self.compile_secs: float | None = None
        self.lats: deque = deque(maxlen=_MAX_SAMPLES)
        self.total_sets = 0
        self.total_secs = 0.0
        self.seen_first = False
        # stage -> program analytics
        self.programs: dict = {}
        self.hist = _DISPATCH_SECONDS.labels(n_sets, n_pks)
        self.rate_gauge = _SETS_PER_SEC.labels(n_sets, n_pks)
        self.compile_gauge = _COMPILE_SECONDS.labels(n_sets, n_pks)

    def stats(self):
        # may run WITHOUT the module lock (snapshot_buckets is signal-
        # handler-safe): a concurrent append can interrupt deque iteration
        for _ in range(3):
            try:
                xs = sorted(self.lats)
                break
            except RuntimeError:
                continue
        else:
            return None
        if not xs:
            return None
        n = len(xs)
        return {
            "p50_ms": xs[n // 2] * 1e3,
            "p99_ms": xs[min(n - 1, int(n * 0.99))] * 1e3,
            "sets_per_sec": (
                self.total_sets / self.total_secs if self.total_secs > 0 else None
            ),
            "samples": n,
        }


_lock = threading.Lock()
_buckets: dict = {}  # (n_sets, n_pks) -> _BucketRecorder


def _recorder(n_sets: int, n_pks: int) -> _BucketRecorder:
    key = (int(n_sets), int(n_pks))
    rec = _buckets.get(key)
    if rec is None:
        rec = _buckets.setdefault(key, _BucketRecorder(*key))
    return rec


def observe_dispatch(n_sets: int, n_pks: int, secs: float, real_sets: int) -> None:
    """One resolved multi-set dispatch at padding bucket (n_sets, n_pks):
    `secs` of wall time verified `real_sets` real (unpadded) sets."""
    try:
        with _lock:
            rec = _recorder(n_sets, n_pks)
            first = not rec.seen_first
            rec.seen_first = True
            if first:
                # this dispatch paid the bucket's first-use cost — keep
                # the larger of it and any explicit warm record
                rec.compile_secs = (
                    float(secs) if rec.compile_secs is None
                    else max(rec.compile_secs, float(secs))
                )
            else:
                rec.lats.append(float(secs))
                rec.total_sets += int(real_sets)
                rec.total_secs += float(secs)
        _DISPATCHES_TOTAL.inc()
        rec.hist.observe(float(secs))
        if first:
            rec.compile_gauge.set(rec.compile_secs)
        if rec.total_secs > 0:
            rec.rate_gauge.set(rec.total_sets / rec.total_secs)
    except Exception:
        pass  # never raise into the verify path


def observe_compile(n_sets: int, n_pks: int, secs: float) -> None:
    """An explicit warm-up (warm_stages) of bucket (n_sets, n_pks).
    Deliberately does NOT mark the bucket seen: the first real dispatch
    must not enter the latency window (module docstring)."""
    try:
        with _lock:
            rec = _recorder(n_sets, n_pks)
            rec.compile_secs = (
                float(secs) if rec.compile_secs is None
                else max(rec.compile_secs, float(secs))
            )
        rec.compile_gauge.set(rec.compile_secs)
    except Exception:
        pass


def observe_program(n_sets: int, n_pks: int, stage: str, stats: dict) -> None:
    """Program analytics for one stage at one bucket (flops / bytes
    accessed), so the persisted profile carries the program shape next to
    the measured timings."""
    try:
        with _lock:
            _recorder(n_sets, n_pks).programs[str(stage)] = dict(stats)
    except Exception:
        pass  # never raise into the capture path


def snapshot_buckets() -> dict:
    """(n_sets, n_pks) -> BucketProfile for every bucket observed so far.

    LOCK-FREE by design: a signal handler may call it between bytecodes
    of a thread inside observe_dispatch's critical section, where
    blocking on _lock would deadlock. dict/deque reads are GIL-atomic;
    per-recorder numbers are best-effort."""
    from .profile import BucketProfile

    out = {}
    recs = list(_buckets.values())
    for rec in recs:
        st = rec.stats()
        bp = BucketProfile(
            n_sets=rec.n_sets,
            n_pks=rec.n_pks,
            compile_secs=rec.compile_secs,
            programs=dict(rec.programs) or None,
        )
        if st is not None:
            bp.samples = st["samples"]
            bp.p50_ms = round(st["p50_ms"], 3)
            bp.p99_ms = round(st["p99_ms"], 3)
            if st["sets_per_sec"] is not None:
                bp.sets_per_sec = round(st["sets_per_sec"], 3)
        out[(rec.n_sets, rec.n_pks)] = bp
    return out


def build_profile(key: dict, source: str, host: dict | None = None):
    """DeviceProfile from everything observed in this process."""
    from .profile import DeviceProfile

    return DeviceProfile(
        key=dict(key), buckets=snapshot_buckets(), host=host, source=source
    )


def reset() -> None:
    """Drop in-memory recorders (tests). Registry metrics persist — the
    registry dedupes by name, so recorders re-attach to the same series."""
    with _lock:
        _buckets.clear()
