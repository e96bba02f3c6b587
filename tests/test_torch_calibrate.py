"""The port's autotune calibrator and CLI (lighthouse_tpu_torch/autotune/
calibrate.py, cli.py) held against the JAX package's: the smoke
calibration on the small fixtures gives the same buckets, samples, source,
small warm-up buckets and host block, and both profiles install; the
workload sweep, the MSM window sweep and the tree-hash sweep give what the
reference's give; the plan's msm_window and tree_hash_warmup layers resolve
as the reference's do; `autotune show` prints the same plan. No JAX stage
is compiled (the reference's tree-hash sweep compiles one 64-leaf ladder)
and nothing touches CUDA: the smoke runs the "python" backend on both
sides, as the reference's own smoke test does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import runpy
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lighthouse_tpu.autotune import calibrate as ref_cal
from lighthouse_tpu.autotune import profile as ref_profile
from lighthouse_tpu.autotune import profiler as ref_profiler
from lighthouse_tpu.autotune import runtime as ref_runtime
from lighthouse_tpu_torch import cli
from lighthouse_tpu_torch.autotune import calibrate, profile, profiler, runtime
from lighthouse_tpu_torch.crypto.torchbls import msm
from lighthouse_tpu_torch.torchhash import engine, router

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "bench_fixtures_smoke.npz")
FULL = os.path.join(REPO, "bench_fixtures.npz")
MSM_ENV = ("LIGHTHOUSE_TPU_MSM_WINDOW", "LIGHTHOUSE_TPU_MSM_WINDOWED")


@pytest.fixture
def single_mesh(monkeypatch):
    """The reference's buckets on one device (the tests' 8 virtual CPU
    devices would make it pad every bucket to its sets mesh)."""
    from lighthouse_tpu.parallel import mesh

    monkeypatch.setenv("LIGHTHOUSE_TPU_MESH", "0")
    mesh.reset_mesh_cache()
    yield
    monkeypatch.undo()
    mesh.reset_mesh_cache()


@pytest.fixture
def clean_runtime():
    runtime.clear()
    ref_runtime.clear()
    yield
    runtime.clear()
    ref_runtime.clear()


def _smoke(cli_main, reset, out):
    reset()
    assert cli_main(["--smoke", "--out", str(out)]) == 0
    return out


def test_smoke_calibration_matches_the_reference(tmp_path, capsys, single_mesh, clean_runtime):
    port = profile.load(str(_smoke(calibrate.cli_main, profiler.reset, tmp_path / "port.json")))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["profile"] == str(tmp_path / "port.json")
    assert summary["autotune_metric_series"] > 0
    assert not torch.cuda.is_initialized()
    ref = ref_profile.load(str(_smoke(ref_cal.cli_main, ref_profiler.reset, tmp_path / "ref.json")))

    assert sorted(port.buckets) == sorted(ref.buckets) == [(4, 4), (4, 8)]
    assert ({b: p.samples for b, p in port.buckets.items()}
            == {b: p.samples for b, p in ref.buckets.items()} == {(4, 4): 2, (4, 8): 2})
    assert port.source == ref.source == "calibrate-smoke"
    assert port.warmup_small_buckets == ref.warmup_small_buckets == ((4, 4), (4, 8))
    assert set(port.host) == set(ref.host) == {"single_set_ms"} and port.host["single_set_ms"] > 0
    assert port.msm_window is ref.msm_window is None
    assert port.tree_hash_buckets is ref.tree_hash_buckets is None
    assert port.key["platform"] == "cpu" and port.key["bls_backend"] == "python"
    assert port.key["backend_revision"] == profile.BACKEND_REVISION
    assert runtime.install_profile(port) is not None
    assert ref_runtime.install_profile(ref) is not None
    assert runtime.active_plan().warmup_buckets


def test_fixture_groups_and_sweep_workloads_match_the_reference(single_mesh):
    port, ref = calibrate.load_fixture_groups(SMOKE), ref_cal.load_fixture_groups(SMOKE)
    for name in ("att", "sync"):
        assert [(s.signature.point, [k.point for k in s.signing_keys], s.message)
                for s in port[name]] == [
                    (s.signature.point, [k.point for k in s.signing_keys], s.message)
                    for s in ref[name]]
    assert port["meta"] == ref["meta"]

    def labelled(work, bucket_of):
        return [(label, len(sets), bucket_of(sets)) for label, sets in work]

    for smoke in (True, False):
        assert (labelled(calibrate.sweep_workloads(port, smoke), calibrate.bucket_of)
                == labelled(ref_cal.sweep_workloads(ref, smoke), ref_cal.bucket_of))
    # bench_fixtures.npz by its sets' widths: decoding its 66,048 keys
    # takes seconds per package, and the sweep reads only the counts
    z = np.load(FULL)
    meta = json.loads(bytes(z["meta"]))
    shaped = {"att": [SimpleNamespace(signing_keys=[None] * z["att_keys"].shape[1])
                      for _ in range(meta["n_att"])],
              "sync": [SimpleNamespace(signing_keys=[None] * z["sync_keys"].shape[0])]}
    for smoke in (True, False):
        got = labelled(calibrate.sweep_workloads(shaped, smoke), calibrate.bucket_of)
        assert got == labelled(ref_cal.sweep_workloads(shaped, smoke), ref_cal.bucket_of)
    assert [b for _l, _n, b in got] == [(4, 128), (16, 128), (64, 128), (512, 128), (4, 512)]


class _StubMSM:
    """g1_msm whose time depends on the env's window: 5 fastest."""

    def __init__(self):
        self.widths = []

    def g1_msm(self, points, scalars):
        import time

        w = int(os.environ["LIGHTHOUSE_TPU_MSM_WINDOW"])
        self.widths.append(w)
        time.sleep(0.0005 if w == 5 else 0.003)
        return (len(points), sum(scalars) % 97)


def test_msm_window_sweep_matches_the_reference(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_MSM_WINDOW", "6")
    pts = list(range(40))
    port_stub, ref_stub = _StubMSM(), _StubMSM()
    got = calibrate.msm_window_sweep(port_stub, pts, reps=2)
    want = ref_cal.msm_window_sweep(ref_stub, pts, reps=2)
    assert got["window"] == want["window"] == 5
    assert sorted(got["secs_by_window"]) == sorted(want["secs_by_window"]) == [0, 2, 4, 5, 6]
    assert port_stub.widths == ref_stub.widths
    assert got["sum"] == (calibrate.MSM_SWEEP_POINTS, got["sum"][1])
    assert os.environ["LIGHTHOUSE_TPU_MSM_WINDOW"] == "6"


def test_msm_window_sweep_refuses_widths_that_disagree(monkeypatch):
    monkeypatch.delenv("LIGHTHOUSE_TPU_MSM_WINDOW", raising=False)

    class Wrong(_StubMSM):
        def g1_msm(self, points, scalars):
            return (int(os.environ["LIGHTHOUSE_TPU_MSM_WINDOW"]), 1)

    with pytest.raises(calibrate.CalibrationError, match="disagree"):
        calibrate.msm_window_sweep(Wrong(), list(range(4)), reps=1)
    assert "LIGHTHOUSE_TPU_MSM_WINDOW" not in os.environ


def test_tree_hash_sweep_matches_the_reference():
    engine.set_device("cpu")
    try:
        assert calibrate.tree_hash_sweep([64], reps=1) == ref_cal.tree_hash_sweep([64], reps=1) == (64,)
    finally:
        engine.set_device(None)
    from lighthouse_tpu_torch.ssz.core import ZERO_HASHES

    assert calibrate.last_run["tree_hash_roots"][64] == ZERO_HASHES[6].hex()


def _profile_doc(revision, msm_window=None, tree_hash=None):
    return {
        "schema_version": 1,
        "key": {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "num_devices": 1,
                "torch_version": "2.11.0+cu128", "backend_revision": revision,
                "bls_backend": "torch", "mesh_shape": "single"},
        "source": "calibrate", "created_unix": 1.0, "host": {"single_set_ms": 580.0},
        "msm_window": msm_window, "pipeline_depth": 6,
        "warmup_small_buckets": [[4, 128]],
        "tree_hash_buckets": tree_hash,
        "buckets": [
            {"n_sets": 4, "n_pks": 128, "samples": 7, "compile_secs": 2.0,
             "p50_ms": 7.0, "p99_ms": 9.0, "sets_per_sec": 570.0},
            {"n_sets": 64, "n_pks": 128, "samples": 7, "compile_secs": 0.5,
             "p50_ms": 14.0, "p99_ms": 19.0, "sets_per_sec": 4500.0},
        ],
    }


def _install_both(**kw):
    port = profile.DeviceProfile.from_json(_profile_doc(profile.BACKEND_REVISION, **kw))
    ref = ref_profile.DeviceProfile.from_json(_profile_doc(ref_profile.BACKEND_REVISION, **kw))
    assert runtime.install_profile(port) is not None
    assert ref_runtime.install_profile(ref) is not None


@pytest.mark.parametrize("plan_window, env, want", [
    (0, {}, 0),                                          # the bit form, measured: honoured
    (5, {}, 5),
    (5, {"LIGHTHOUSE_TPU_MSM_WINDOW": "2"}, 2),          # the env beats the plan
    (5, {"LIGHTHOUSE_TPU_MSM_WINDOW": "3"}, 5),          # malformed: falls to the plan
    (5, {"LIGHTHOUSE_TPU_MSM_WINDOWED": "0"}, 0),        # legacy switch
    (0, {"LIGHTHOUSE_TPU_MSM_WINDOWED": "1"}, 4),
])
def test_msm_window_plan_layer_matches_the_reference(monkeypatch, clean_runtime, plan_window, env, want):
    from lighthouse_tpu.crypto.jaxbls import msm as ref_msm

    for k in MSM_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _install_both(msm_window=plan_window)
    assert msm.msm_window() == ref_msm.msm_window() == want
    runtime.clear()
    ref_runtime.clear()
    if not env:   # without a plan: the default (the reference's is the platform's)
        assert msm.msm_window() == msm.DEFAULT_WINDOW


def test_tree_hash_warmup_reads_the_plan(monkeypatch, clean_runtime):
    warmed = []
    monkeypatch.setattr(engine, "warm_tree_bucket", lambda n: warmed.append(n) or 0.0)
    router.start_warmup().join(10)
    assert warmed == [16384]                # no plan: the registry scale
    warmed.clear()
    _install_both(tree_hash=[1 << 17, 64, 1 << 17])
    assert runtime.active_plan().tree_hash_warmup == (1 << 17, 64)
    router.start_warmup().join(10)
    assert warmed == [1 << 17, 64]
    warmed.clear()
    router.start_warmup((128,)).join(10)    # explicit buckets beat the plan
    assert warmed == [128]


def test_autotune_show_prints_the_reference_plan(tmp_path, capsys, monkeypatch):
    from lighthouse_tpu.cli import main as ref_main

    path = str(tmp_path / "p.json")
    with open(path, "w") as f:
        json.dump(_profile_doc(profile.BACKEND_REVISION, msm_window=0, tree_hash=[16384]), f)
    assert cli.main(["autotune", "show", "--profile", path]) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_main(["autotune", "show", "--profile", path]) == 0
    ref = json.loads(capsys.readouterr().out)
    port_plan, ref_plan = dict(port["plan"]), dict(ref["plan"])
    assert port_plan.pop("source").startswith("profile:gpu_NVIDIA-H100-80GB-HBM3")
    ref_plan.pop("source")
    assert port_plan == ref_plan
    assert port["profile"] == ref["profile"]
    assert port_plan["msm_window"] == 0 and port_plan["tree_hash_warmup"] == [16384]
    # the package's __main__ is the same CLI
    monkeypatch.setattr(sys, "argv", ["lighthouse_tpu_torch", "autotune", "show", "--profile", path])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("lighthouse_tpu_torch", run_name="__main__")
    assert done.value.code == 0
    assert json.loads(capsys.readouterr().out)["plan"] == port["plan"]
    assert cli.main(["autotune", "show", "--profile", str(tmp_path / "none.json")]) == 1


def test_measure_backend_records_a_self_recording_backend_once(monkeypatch):
    """The torch backend records each resolved verify itself
    (autotune_self_recording), so measure_backend adds nothing: the
    profile's samples per bucket are the reps, not twice them."""
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend

    assert TorchBackend.autotune_self_recording is True
    profiler.reset()
    sets = [SimpleNamespace(signing_keys=[None] * 3)] * 5

    class SelfRecording:
        autotune_self_recording = True

        def verify_signature_sets(self, sets, rands):
            profiler.observe_dispatch(8, 4, 0.001, len(sets))
            return True

    calibrate.measure_backend(SelfRecording(), [("att[5]", sets)], reps=3)
    calibrate.measure_backend(SimpleNamespace(verify_signature_sets=lambda s, r: True),
                              [("att[2]", sets[:2])], reps=3)
    buckets = profiler.snapshot_buckets()
    assert buckets[(8, 4)].samples == 3 and buckets[(4, 4)].samples == 3
    profiler.reset()
