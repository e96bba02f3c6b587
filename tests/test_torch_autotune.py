"""The port's autotune layer (lighthouse_tpu_torch/autotune/) held against
the JAX package's: the same profile JSON loads in both and plans the same
knobs; the port refuses a profile of another backend revision (the JAX
package's among them); an installed plan retunes a live hybrid router and a
live dispatcher; the startup warm-up walks the plan's buckets. No JAX program
is compiled; nothing touches a device.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from lighthouse_tpu.autotune import planner as ref_planner
from lighthouse_tpu.autotune import profile as ref_profile
from lighthouse_tpu.autotune import runtime as ref_runtime
from lighthouse_tpu.crypto.jaxbls import pipeline as ref_pipeline
from lighthouse_tpu_torch.autotune import planner, profile, runtime
from lighthouse_tpu_torch.crypto.torchbls import pipeline

KNOB_ENV = ("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "LIGHTHOUSE_TPU_URGENT_MAX_SETS",
            "LIGHTHOUSE_TPU_DEVICE_P99_BUDGET_MS", "LIGHTHOUSE_TPU_DEVICE_STALL_BUDGET_MS")


def _profile_json(revision: str, mesh: str = "single", host: bool = True,
                  depth: int | None = 6) -> dict:
    buckets = [
        {"n_sets": 4, "n_pks": 1, "samples": 16, "compile_secs": 31.0,
         "p50_ms": 6.1, "p99_ms": 7.3, "sets_per_sec": 640.0},
        {"n_sets": 64, "n_pks": 128, "samples": 16, "compile_secs": 0.9,
         "p50_ms": 14.2, "p99_ms": 19.0, "sets_per_sec": 4500.0},
        {"n_sets": 128, "n_pks": 128, "samples": 8, "compile_secs": None,
         "p50_ms": 27.0, "p99_ms": 30.0, "sets_per_sec": 4740.0},
        {"n_sets": 512, "n_pks": 1, "samples": 0, "compile_secs": 2.0,
         "p50_ms": None, "p99_ms": None, "sets_per_sec": None},
    ]
    return {
        "schema_version": 1,
        "key": {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                "num_devices": 1, "torch_version": "2.11.0+cu128",
                "backend_revision": revision, "bls_backend": "torch",
                "mesh_shape": mesh},
        "source": "calibrate", "created_unix": 1.0,
        "host": {"single_set_ms": 0.2} if host else None,
        "msm_window": 4, "pipeline_depth": depth,
        "warmup_small_buckets": [[4, 1], [8, 1]],
        "tree_hash_buckets": [1 << 20, 16384, 1 << 30],
        "buckets": buckets,
    }


def _knobs(plan) -> dict:
    d = dataclasses.asdict(plan)
    d.pop("source")
    return d


@pytest.mark.parametrize("mesh, host, depth", [
    ("single", True, 6), ("single", False, None), ("sets4-pks2", True, 40),
])
def test_same_profile_plans_equal_knobs(mesh, host, depth):
    doc = json.loads(json.dumps(_profile_json(profile.BACKEND_REVISION, mesh, host, depth)))
    port_plan = planner.plan_from_profile(profile.DeviceProfile.from_json(doc))
    ref_plan = ref_planner.plan_from_profile(ref_profile.DeviceProfile.from_json(doc))
    assert _knobs(port_plan) == _knobs(ref_plan)
    assert port_plan.source.startswith("profile:gpu_NVIDIA-H100-80GB-HBM3_x1_torch")
    assert port_plan.pipeline_depth == (min(depth, 16) if depth else planner.DEFAULT_PIPELINE_DEPTH)
    assert profile.DeviceProfile.from_json(doc).to_json() == doc


def test_defaults_equal_the_reference():
    assert _knobs(planner.DEFAULT_PLAN) == _knobs(ref_planner.DEFAULT_PLAN)
    assert planner.DEFAULT_WARMUP_BUCKETS == ref_planner.DEFAULT_WARMUP_BUCKETS
    assert planner.DEFAULT_PIPELINE_DEPTH == pipeline.DEFAULT_DEPTH


def test_install_refuses_a_stale_revision(monkeypatch, tmp_path):
    """A profile of the JAX package (revision r9) or of another port build
    is refused, with a flight-recorder event; an operator's explicit path
    installs it anyway; the port's own revision installs and round-trips
    through save/autoload."""
    from lighthouse_tpu_torch.observability.flight_recorder import RECORDER

    for var in KNOB_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LIGHTHOUSE_TPU_AUTOTUNE_DIR", str(tmp_path))
    runtime.clear()
    RECORDER.reset()
    try:
        for stale in (ref_profile.BACKEND_REVISION, "t0"):
            prof = profile.DeviceProfile.from_json(_profile_json(stale))
            assert prof.is_stale()
            assert runtime.install_profile(prof) is None
            assert runtime.active_plan() is None
        refused = [e for e in RECORDER.events() if e["kind"] == "autotune_profile_refused"]
        assert [e["reason"] for e in refused] == ["stale_revision"] * 2
        forced = runtime.install_profile(prof, allow_stale=True)
        assert forced is not None and runtime.active_plan() == forced
        runtime.clear()
        fresh = profile.DeviceProfile.from_json(_profile_json(profile.BACKEND_REVISION))
        path = profile.save(fresh)
        assert path.startswith(str(tmp_path)) and "torch2.11.0" in path
        plan = runtime.autoload(path=path)
        assert plan == planner.plan_from_profile(fresh)
        assert runtime.active_profile().key_string() == fresh.key_string()
    finally:
        runtime.clear()
        RECORDER.reset()


def test_installed_plan_retunes_live_router_and_dispatcher(monkeypatch):
    """Installing a plan retunes a live hybrid router's urgent_max_sets and
    p99 budget and a live backend dispatcher's depth (resolve_depth's
    "profile" layer, as the reference's under the same plan); clearing it
    restores the defaults."""
    from lighthouse_tpu_torch.crypto.bls.hybrid import HybridBackend
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend

    for var in KNOB_ENV:
        monkeypatch.delenv(var, raising=False)
    runtime.clear()
    ref_runtime.clear()
    try:
        router = HybridBackend(probe_startup_wait_secs=0.1, probe_retry_secs=3600.0)
        backend = TorchBackend(device="cpu")
        assert (router.urgent_max_sets, router.p99_budget_ms) == (4, 500.0)
        assert (backend.dispatcher.depth, backend.dispatcher.depth_source) == (4, "default")
        doc = _profile_json(profile.BACKEND_REVISION, depth=7)
        plan = runtime.install_profile(profile.DeviceProfile.from_json(doc))
        assert plan.urgent_max_sets != 4 and plan.p99_budget_ms != 500.0
        assert (router.urgent_max_sets, router.p99_budget_ms) == (
            plan.urgent_max_sets, plan.p99_budget_ms)
        assert router.knob_sources == {"urgent_max_sets": "profile", "p99_budget_ms": "profile"}
        assert router._stall_budget_secs == pytest.approx(plan.stall_budget_ms / 1e3)
        assert (backend.dispatcher.depth, backend.dispatcher.depth_source) == (7, "profile")
        assert pipeline.resolve_depth() == (7, "profile")
        ref_doc = dict(doc, key=dict(doc["key"], backend_revision=ref_profile.BACKEND_REVISION))
        ref_runtime.install_profile(ref_profile.DeviceProfile.from_json(ref_doc))
        assert pipeline.resolve_depth() == ref_pipeline.resolve_depth()
        monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "3")
        assert pipeline.resolve_depth() == ref_pipeline.resolve_depth() == (3, "env")
        monkeypatch.delenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH")
        runtime.clear()
        assert (router.urgent_max_sets, router.p99_budget_ms) == (4, 500.0)
        assert (backend.dispatcher.depth, backend.dispatcher.depth_source) == (4, "default")
    finally:
        runtime.clear()
        ref_runtime.clear()


def test_start_warmup_walks_the_plan_buckets(monkeypatch):
    for var in KNOB_ENV:
        monkeypatch.delenv(var, raising=False)
    runtime.clear()
    try:
        assert runtime.warmup_buckets() == planner.DEFAULT_WARMUP_BUCKETS
        plan = runtime.install_profile(
            profile.DeviceProfile.from_json(_profile_json(profile.BACKEND_REVISION)))
        seen = []
        runtime.start_warmup(warm_fn=lambda n, m: seen.append((n, m))).join(10)
        assert seen == list(plan.warmup_buckets)
        assert (4, 1) in seen and (8, 1) in seen       # the small buckets ride along
    finally:
        runtime.clear()


def test_start_warmup_through_the_hybrid_router():
    """On "hybrid" the warm-up goes through HybridBackend.warm_bucket: each
    bucket runs one dummy verify on the device (a stub here) and is marked
    warm for routing, in its lane."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.hybrid import HybridBackend

    class Device:
        calls = []

        def verify_signature_sets(self, sets, rands):
            self.calls.append((len(sets), len(sets[0].signing_keys)))
            return False                              # dummy sets never verify

    router = HybridBackend(probe_startup_wait_secs=0.1, probe_retry_secs=3600.0)
    router._probe_started.set()
    router._probe_done.set()
    router._state, router._device = "up", Device()
    prev = api._active_backend
    api.register_backend("hybrid-warm-test", router)
    try:
        api.set_backend("hybrid-warm-test")
        runtime.start_warmup(buckets=[(1, 1), (64, 128)]).join(30)
        assert Device.calls == [(1, 1), (64, 128)]
        assert router._warm_buckets == {("urgent", (4, 1)), ("batch", (64, 128))}
        assert router.warm_bucket(1, 1) is True and len(Device.calls) == 2
    finally:
        api._active_backend = prev
        api._BACKENDS.pop("hybrid-warm-test", None)


def test_warm_stages_runs_one_dummy_verify_and_records_it():
    """On the "torch" backend the warm-up's warm_stages runs one dummy
    verify at the bucket (a spy here, on a CPU backend) and records the
    bucket's first-use time in the profiler."""
    from lighthouse_tpu_torch.autotune import profiler
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.torchbls import backend as be

    spy = be.TorchBackend(device="cpu")
    seen = []
    spy.verify_signature_sets = lambda sets, rands: seen.append(
        (len(sets), {len(s.signing_keys) for s in sets}, len(rands))) or False
    prev = api._BACKENDS.get("torch")
    api.register_backend("torch", spy)
    profiler.reset()
    try:
        be.warm_stages(3, 2)
        assert seen == [(3, {2}, 3)]
        assert profiler.snapshot_buckets()[(4, 2)].compile_secs >= 0.0
    finally:
        profiler.reset()
        if prev is None:
            api._BACKENDS.pop("torch", None)
        else:
            api.register_backend("torch", prev)


def test_current_device_key_reads_torch():
    key = profile.current_device_key()
    assert key["torch_version"] == torch.__version__
    assert (key["backend_revision"], key["bls_backend"], key["mesh_shape"]) == (
        profile.BACKEND_REVISION, "torch", "single")
    if not torch.cuda.is_available():
        assert (key["platform"], key["num_devices"]) == ("none", 0)
        assert not torch.cuda.is_initialized()
    assert "jax_version" not in key
