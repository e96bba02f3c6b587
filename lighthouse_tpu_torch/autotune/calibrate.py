"""Offline calibration sweep: measure the padding buckets, write a profile
(the port's copy of the JAX package's autotune/calibrate.py).

Entry points: `python -m lighthouse_tpu_torch autotune calibrate` (cli.py)
and `python -m lighthouse_tpu_torch.autotune.calibrate`, both thin wrappers
over `run_from_args`.

Two modes:

  - device calibration (default): the "torch" backend verifies fixture
    workloads at a sweep of padding buckets on the card; its built-in
    profiler hooks record the first use (first dispatch per bucket) and
    steady-state latency. Before the timed sweep one attributed verify per
    workload records the per-stage split and each stage's work into the
    profile (observability/device.py, perf.py); after it, the varying-base
    MSM at every window width and the tree-hash ladder. Run this once per
    card; the profile lands at its canonical per-device path
    (profile.default_path, under build/autotune) where
    `runtime.autoload` finds it. The kernels build at first use into
    build/, as on any other path.
  - `--smoke`: a CPU dry-run of the whole measure -> profile -> plan
    pipeline using the committed tiny fixtures (bench_fixtures_smoke.npz)
    and the pure-python BLS backend, which never touches CUDA. Smoke output
    goes to a gitignored path: a CPU dry-run must never clobber the
    card's profile.

Fixture workloads (utils/fixtures.py over the npz files of
scripts/gen_bench_fixtures.py): a single set, attestation batches at
power-of-two slices, and the sync-committee aggregate (the wide-pubkey
bucket). Every measurement is also a correctness check — a calibration
verify returning False, MSM widths that disagree, or a ladder root other
than hashlib's aborts that sweep.

`last_run` holds what the last `run_from_args` measured beyond the profile
(the MSM sweep's sum and times, the ladder's roots), for a caller that
checks them.
"""

from __future__ import annotations

import json
import os
import random
import time

from ..utils.logging import get_logger


class CalibrationError(RuntimeError):
    pass


def _log(msg, **kw):
    get_logger("autotune.calibrate").info(msg, **kw)


#: the last run_from_args' sweep results beyond the profile
last_run: dict = {}


# ----------------------------------------------------------------- fixtures


def load_fixture_groups(path: str, include_kzg: bool = False) -> dict:
    """SignatureSet groups from a bench fixtures npz (attestation sets,
    the sync aggregate; optionally the KZG fixture). Host-only int
    conversion, no device work."""
    from ..utils import fixtures

    out = fixtures.load_groups(path)
    if include_kzg:
        out["kzg"] = fixtures.load_kzg(path)
    return out


def bucket_of(sets) -> tuple:
    """The (n_sets, n_pks) padding bucket the torch backend dispatches this
    workload at (crypto/torchbls/backend.py padding_bucket, the dispatch
    path's own rounding rule; one card, so no mesh padding)."""
    from ..crypto.torchbls.backend import padding_bucket

    return padding_bucket(len(sets), max(len(s.signing_keys) for s in sets))


def _rands(rng, n):
    return [1] + [rng.getrandbits(64) | 1 for _ in range(n - 1)]


def sweep_workloads(groups: dict, smoke: bool) -> list:
    """Ordered (label, sets) workloads; deduped by padding bucket so each
    bucket is measured once per sweep."""
    att = groups["att"]
    slices = [1, len(att)] if smoke else [1, 4, 16, 64, len(att)]
    out, seen = [], set()
    for k in slices:
        k = max(1, min(k, len(att)))
        sets = att[:k]
        b = bucket_of(sets)
        if b not in seen:
            seen.add(b)
            out.append((f"att[{k}]", sets))
    b = bucket_of(groups["sync"])
    if b not in seen:
        out.append(("sync_aggregate", groups["sync"]))
    return out


# --------------------------------------------------------------- measuring


def measure_backend(backend, workloads, reps: int, rng=None) -> None:
    """Time `reps + 1` verifies per workload into the profiler (the first
    pays the bucket's first use and is classified as such). The torch
    backend self-records through its resolved handles
    (autotune_self_recording); anything else is timed here."""
    from . import profiler

    rng = rng or random.Random(0xA07)
    self_recording = getattr(backend, "autotune_self_recording", False)
    for label, sets in workloads:
        bucket = bucket_of(sets)
        rands = _rands(rng, len(sets))
        for rep in range(reps + 1):
            t0 = time.perf_counter()
            ok = backend.verify_signature_sets(sets, rands)
            dt = time.perf_counter() - t0
            if not ok:
                raise CalibrationError(
                    f"calibration workload {label} failed to verify "
                    f"(bucket {bucket}, rep {rep})"
                )
            if not self_recording:
                profiler.observe_dispatch(*bucket, dt, len(sets))
            _log("measured", workload=label, bucket=str(bucket), rep=rep,
                 secs=round(dt, 3))


def _attribution_pass(backend, workloads) -> None:
    """One attributed verify per workload BEFORE the timing sweep: records
    the per-stage first-use/execute split and each stage's work into the
    profile (observability/device.py, perf.py) without polluting the
    persisted p50/p99 — attribution serializes the stages, so it must never
    be live while measure_backend times dispatches. Running first is
    deliberate: the serialized dispatch is each bucket's FIRST, so the
    profiler folds it into compile_secs (already a first-dispatch number),
    and the sweep's own reps then measure the asynchronous path exactly as
    serving does."""
    from ..observability import device as _obs_device
    from ..observability import perf as _obs_perf

    prev = _obs_perf.set_analytics(True)
    try:
        with _obs_device.attributed():
            for label, sets in workloads:
                if not backend.verify_signature_sets(sets, [1] * len(sets)):
                    raise CalibrationError(
                        f"attribution pass workload {label} failed to verify"
                    )
    finally:
        _obs_perf.set_analytics(prev)
    _log("per-stage attribution + program analytics captured")


#: measured buckets at or under this many (padded) sets are "small":
#: they are the urgent fast path's shapes and land in the profile's
#: warmup_small_buckets so bring-up warms them even when the
#: throughput-ordered warmup list is full of wide buckets
SMALL_WARMUP_MAX_SETS = 8

#: varying-base MSM workload size for the window sweep
MSM_SWEEP_POINTS = 32


def msm_window_sweep(backend, points, reps: int, rng=None) -> dict:
    """Time `backend.g1_msm` at every ALLOWED_WINDOWS width (plus the bit
    form w=0) and return {"window": winner, "secs_by_window": {...},
    "sum": the MSM's result}.

    Each width is forced via the LIGHTHOUSE_TPU_MSM_WINDOW env override
    (the layer above the plan — exactly what a sweep should use); its first
    call is untimed, then `reps` are timed. Every width must give the same
    sum. The winner is the width with the best median time and is what
    `run_from_args` persists as DeviceProfile.msm_window. On the card the
    kernel recodes its digits into GLV bit windows whatever the width, so
    the widths differ mostly in the host's digit packing."""
    from ..crypto.torchbls.msm import ALLOWED_WINDOWS

    rng = rng or random.Random(0xA08)
    pts = list(points)[:MSM_SWEEP_POINTS]
    scalars = [rng.getrandbits(255) for _ in pts]
    prev_env = os.environ.get("LIGHTHOUSE_TPU_MSM_WINDOW")
    secs_by_window: dict = {}
    sums: dict = {}
    try:
        for w in (0,) + tuple(ALLOWED_WINDOWS):
            os.environ["LIGHTHOUSE_TPU_MSM_WINDOW"] = str(w)
            sums[w] = backend.g1_msm(pts, scalars)     # first call (uncounted)
            samples = []
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                if backend.g1_msm(pts, scalars) is None:
                    raise CalibrationError(
                        f"MSM sweep at window {w} returned identity for a "
                        "non-trivial workload"
                    )
                samples.append(time.perf_counter() - t0)
            samples.sort()
            secs_by_window[w] = samples[len(samples) // 2]
            _log("msm window measured", window=w,
                 median_secs=round(secs_by_window[w], 4))
    finally:
        if prev_env is None:
            os.environ.pop("LIGHTHOUSE_TPU_MSM_WINDOW", None)
        else:
            os.environ["LIGHTHOUSE_TPU_MSM_WINDOW"] = prev_env
    if len({repr(s) for s in sums.values()}) != 1:
        raise CalibrationError(f"MSM widths disagree: {sums}")
    winner = min(secs_by_window, key=secs_by_window.get)
    # the winner persists EVEN when it is the bit form (w=0): "windowed
    # lost the sweep on this device" is a measured verdict the default
    # must not override (None stays reserved for "unmeasured")
    return {"window": winner, "secs_by_window": secs_by_window, "sum": sums[0]}


def tree_hash_sweep(buckets, reps: int) -> tuple:
    """Measure the torchhash ladder at each leaf-count bucket:
    `warm_tree_bucket` pays (and times) the first use, then `reps` roots
    of zero leaves, each equal to hashlib's (ssz.core.ZERO_HASHES). Returns
    the measured bucket tuple — what run_from_args persists as
    DeviceProfile.tree_hash_buckets, the ladders bring-up warms on this
    device."""
    import numpy as np

    from ..ssz.core import ZERO_HASHES
    from ..torchhash import engine

    out = []
    roots = last_run.setdefault("tree_hash_roots", {})
    for n in buckets:
        n = int(n)
        first_secs = engine.warm_tree_bucket(n)
        leaves = np.zeros((n, 32), np.uint8)
        depth = engine.hash_bucket(n).bit_length() - 1
        samples = []
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            _levels, root = engine.device_build_levels(leaves, depth, root_only=True)
            samples.append(time.perf_counter() - t0)
            if root != ZERO_HASHES[depth]:
                raise CalibrationError(f"tree-hash ladder at {n} leaves: root {root.hex()} "
                                       f"is not hashlib's {ZERO_HASHES[depth].hex()}")
        samples.sort()
        roots[n] = root.hex()
        _log("tree-hash bucket measured", n_leaves=n,
             first_secs=round(first_secs, 2),
             median_secs=round(samples[len(samples) // 2], 4))
        out.append(n)
    return tuple(out)


def measure_host_reference(sets, reps: int) -> dict:
    """Host (pure python) single-set verify time — the planner's reference
    for the urgent-set threshold."""
    from ..crypto.bls import api as bls_api

    host = bls_api._BACKENDS["python"]
    one = sets[:1]
    samples = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        if not host.verify_signature_sets(one, [1]):
            raise CalibrationError("host reference verify failed")
        samples.append(time.perf_counter() - t0)
    return {"single_set_ms": round(sum(samples) / len(samples) * 1e3, 3)}


def _host_key(backend_name: str) -> dict:
    """The key of a profile measured on the host: no CUDA call."""
    import torch

    from . import profile

    return {
        "platform": "cpu", "device_kind": "cpu", "num_devices": 1,
        "torch_version": torch.__version__,
        "backend_revision": profile.BACKEND_REVISION,
        "bls_backend": backend_name, "mesh_shape": "single",
    }


# --------------------------------------------------------------------- run


def add_calibrate_args(p) -> None:
    """The flags of `autotune calibrate` and of this module's cli_main."""
    p.add_argument("--smoke", action="store_true",
                   help="CPU dry-run: tiny fixtures, pure-python backend, "
                        "gitignored output (never the card's profile)")
    p.add_argument("--fixtures", default=None,
                   help="bench fixtures npz (default: bench_fixtures.npz, "
                        "or the smoke variant with --smoke)")
    p.add_argument("--backend", default=None, choices=["torch", "python"],
                   help="measured backend (default: torch; --smoke: python)")
    p.add_argument("--reps", type=int, default=None,
                   help="timed reps per bucket after the first-use rep "
                        "(default: 6; --smoke: 2)")
    p.add_argument("--out", default=None,
                   help="profile output path (default: the canonical "
                        "per-device path under build/autotune; --smoke: "
                        "./autotune_profile_smoke.json)")
    p.add_argument("--no-msm-sweep", action="store_true",
                   help="skip the varying-base MSM window-width sweep "
                        "(w in {2,4,5,6} vs the bit form; torch backend "
                        "only — the winner persists as the profile's "
                        "msm_window)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="record this measured dispatch pipeline depth in "
                        "the profile (default: leave unmeasured)")
    p.add_argument("--tree-hash-buckets", default=None,
                   help="comma list of torchhash ladder leaf counts to "
                        "measure + persist as the profile's "
                        "tree_hash_buckets (default 16384 — the registry "
                        "scale; torch backend only)")
    p.add_argument("--no-tree-hash-sweep", action="store_true",
                   help="skip the tree-hash ladder sweep (profile keeps "
                        "tree_hash_buckets unmeasured; bring-up warms the "
                        "default registry-scale ladder)")


def run_from_args(args) -> tuple:
    """Execute a calibration described by an argparse namespace with the
    `add_calibrate_args` attributes. Returns (DeviceProfile, path)."""
    from . import planner, profile, profiler

    smoke = bool(getattr(args, "smoke", False))
    backend_name = args.backend or ("python" if smoke else "torch")
    reps = args.reps if args.reps is not None else (2 if smoke else 6)
    on_card = backend_name == "torch"

    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    fixtures = args.fixtures or os.path.join(
        repo_root,
        "bench_fixtures_smoke.npz" if smoke else "bench_fixtures.npz",
    )

    msm_sweep = on_card and not getattr(args, "no_msm_sweep", False)
    _log("calibration starting", smoke=smoke, backend=backend_name,
         fixtures=fixtures, reps=reps, msm_sweep=msm_sweep)
    last_run.clear()
    groups = load_fixture_groups(fixtures, include_kzg=msm_sweep)

    from ..crypto.bls import api as bls_api

    backend = bls_api.set_backend(backend_name)
    workloads = sweep_workloads(groups, smoke)
    if on_card:
        _attribution_pass(backend, workloads)
    t0 = time.time()
    measure_backend(backend, workloads, reps)
    host = measure_host_reference(groups["att"], 1 if smoke else 3)

    msm_window = None
    msm_secs = None
    if msm_sweep:
        try:
            sweep = msm_window_sweep(
                backend, groups["kzg"]["g1_lagrange"], reps
            )
            msm_window, msm_secs = sweep["window"], sweep["secs_by_window"]
            last_run["msm_sweep"] = sweep
            _log("msm window sweep complete", winner=msm_window)
        except CalibrationError:
            raise
        except Exception as e:  # the verify sweep already succeeded — a
            # broken MSM path degrades to an unmeasured window, it must
            # not discard the whole calibration
            _log("msm window sweep failed; profile keeps msm_window "
                 "unmeasured", error=f"{type(e).__name__}: {e}")

    tree_hash_buckets = None
    if on_card and not getattr(args, "no_tree_hash_sweep", False):
        raw = getattr(args, "tree_hash_buckets", None) or "16384"
        try:
            tree_hash_buckets = tree_hash_sweep(
                [int(x) for x in str(raw).split(",") if x.strip()],
                1 if smoke else reps,
            )
            _log("tree-hash sweep complete",
                 buckets=str(list(tree_hash_buckets)))
        except Exception as e:  # second-workload sweep must not discard
            # the BLS calibration — degrade to unmeasured
            _log("tree-hash sweep failed; profile keeps tree_hash_buckets "
                 "unmeasured", error=f"{type(e).__name__}: {e}")

    key = (profile.current_device_key(bls_backend=backend_name) if on_card
           else _host_key(backend_name))

    prof = profiler.build_profile(
        key, source="calibrate-smoke" if smoke else "calibrate", host=host
    )
    if not prof.buckets:
        raise CalibrationError("sweep recorded no buckets")
    # the tuning fields: the calibrated MSM window, the operator-supplied
    # measured pipeline depth, and the small/urgent buckets the warmup
    # plan must never drop (the urgent fast path's shapes)
    prof.msm_window = msm_window
    depth_arg = getattr(args, "pipeline_depth", None)
    if depth_arg is not None:
        prof.pipeline_depth = max(1, int(depth_arg))
    small = tuple(
        b for b in sorted(prof.buckets)
        if b[0] <= SMALL_WARMUP_MAX_SETS
    )
    prof.warmup_small_buckets = small or None
    # the measured tree-hash ladder buckets (None when the sweep was
    # skipped/failed or the measured backend is not the card's)
    prof.tree_hash_buckets = tree_hash_buckets

    out = args.out or (
        os.path.join(repo_root, "autotune_profile_smoke.json")
        if smoke
        else profile.default_path(key)
    )
    path = profile.save(prof, out)
    plan = planner.plan_from_profile(prof)
    _log("calibration complete", secs=round(time.time() - t0, 1),
         buckets=len(prof.buckets), path=path,
         msm_secs_by_window=str(msm_secs) if msm_secs else "")
    _log("derived plan", max_attestation_batch=plan.max_attestation_batch,
         max_aggregate_batch=plan.max_aggregate_batch,
         p99_budget_ms=plan.p99_budget_ms,
         urgent_max_sets=plan.urgent_max_sets,
         pipeline_depth=plan.pipeline_depth,
         msm_window=plan.msm_window,
         warmup_buckets=str(list(plan.warmup_buckets)))
    return prof, path


def cli_main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="autotune_calibrate",
        description="measure the BLS verification padding buckets on this "
                    "card and write an autotune profile",
    )
    add_calibrate_args(p)
    args = p.parse_args(argv)
    _prof, path = run_from_args(args)
    from ..utils.metrics import REGISTRY

    series = sum(
        1 for line in REGISTRY.expose_text().splitlines()
        if line.startswith("autotune_")
    )
    print(json.dumps({"profile": path, "autotune_metric_series": series}))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli_main())
