"""The port's per-stage attribution and program analytics
(lighthouse_tpu_torch/observability/device.py, perf.py) held against the
JAX package's: run_stage gives the same spans, phases, first-use/execute
split and snapshot shape on the reference test's stub sequence; the
backend's four stages and its warm-up dispatch through it; a captured
stage carries the work crypto/torchbls/costs.py counts; the peak overrides
keep the reference's precedence. Host only (the stages are stubbed or run
their plain versions at (4, 2)); the attribution's `cuda` tests (CUDA
events, NVTX ranges) are in tests/test_torch_kernels.py, which imports no
JAX and runs on the card.
"""

from __future__ import annotations

import pytest
import torch

from lighthouse_tpu.observability import device as ref_dev
from lighthouse_tpu.observability import perf as ref_perf
from lighthouse_tpu.observability.trace import Trace as RefTrace
from lighthouse_tpu_torch.autotune import profiler
from lighthouse_tpu_torch.crypto.torchbls import backend as be
from lighthouse_tpu_torch.crypto.torchbls import costs
from lighthouse_tpu_torch.crypto.torchbls import limbs as lb
from lighthouse_tpu_torch.observability import device as obsdev
from lighthouse_tpu_torch.observability import perf
from lighthouse_tpu_torch.observability.trace import Trace

PEAK_ENV = ("LIGHTHOUSE_TPU_PEAK_INT_OPS", "LIGHTHOUSE_TPU_PEAK_FLOPS", "LIGHTHOUSE_TPU_PEAK_HBM_GBPS")


def _stub_sequence(dev, trace_cls, bucket):
    """tests/test_observability.py's sequence: two prepares, a pairing,
    then a dispatch with attribution off."""
    dev.reset_seen()
    tr = trace_cls("gossip_attestation", 4)
    with dev.attributed():
        attr = dev.begin(bucket, trace=tr)
        assert attr is not None
        assert dev.run_stage(attr, "prepare", lambda a, b: a + b, 1, 2) == 3
        assert dev.run_stage(attr, "prepare", lambda a, b: a + b, 3, 4) == 7
        dev.run_stage(attr, "pairing", lambda: None)
    assert dev.begin(bucket) is None
    assert dev.run_stage(None, "prepare", lambda: 5) == 5
    n, m = bucket
    snap = dev.snapshot_stages()[f"{n}x{m}"]
    return {
        "spans": [s[0] for s in tr.spans],
        "phases": [s[3]["phase"] for s in tr.spans],
        "buckets": [s[3]["bucket"] for s in tr.spans],
        "compile_prepare": dev.STAGE_COMPILE_SECONDS.labels("prepare", n, m).value > 0,
        "execute_prepare": dev.STAGE_DEVICE_SECONDS.labels("prepare", n, m).n,
        "execute_pairing": dev.STAGE_DEVICE_SECONDS.labels("pairing", n, m).n,
        "snapshot": {stage: sorted(e) for stage, e in snap.items()},
        "prepare_count": snap["prepare"]["count"],
    }


def test_run_stage_matches_the_reference_on_its_stub_sequence():
    bucket = (16, 4)   # distinctive: no other test dispatches at it
    got = _stub_sequence(obsdev, Trace, bucket)
    want = _stub_sequence(ref_dev, RefTrace, bucket)
    assert got == want
    assert got["spans"] == ["device:prepare", "device:prepare", "device:pairing"]
    assert got["phases"] == ["compile", "execute", "compile"]
    assert got["snapshot"] == {"pairing": ["compile_s"],
                               "prepare": ["compile_s", "count", "mean_ms", "total_s"]}
    assert obsdev.STAGES == ref_dev.STAGES and obsdev.DEVICE_SPAN_PREFIX == ref_dev.DEVICE_SPAN_PREFIX


def _stub_stages(monkeypatch, calls):
    """The backend's four stages as stubs with the real stages' shapes."""
    def prepare(pk_x, pk_y, pk_mask, sig_x, sig_y, z_bits, set_mask):
        calls.append("prepare")
        n = pk_x.shape[0]
        z = torch.zeros((n, lb.NL), dtype=torch.int64)
        s = torch.zeros((2, lb.NL), dtype=torch.int64)
        return (z, z, z), (s, s, s), torch.tensor(False)

    def h2c(us):
        calls.append("h2c")
        q = torch.zeros((us.shape[0], 2, lb.NL), dtype=torch.int64)
        return q, q, q

    def pairs(z_pk, h_jac, sig_acc, set_mask):
        calls.append("pairs")
        n = set_mask.shape[0] + 1
        p, q = torch.zeros((n, lb.NL), dtype=torch.int64), torch.zeros((n, 2, lb.NL), dtype=torch.int64)
        return p, p, q, q, torch.ones((n,), dtype=torch.bool)

    def pairing(px, py, qxx, qyy, mask):
        calls.append("pairing")
        return torch.tensor(True)

    for name, fn in (("stage_prepare", prepare), ("stage_h2c", h2c), ("stage_pairs", pairs),
                     ("stage_pairing", pairing)):
        monkeypatch.setattr(be, name, fn)


def _inputs(n, m):
    z = torch.zeros
    prepare_in = (z((n, m, lb.NL), dtype=torch.int64), z((n, m, lb.NL), dtype=torch.int64),
                  torch.ones((n, m), dtype=torch.int64), z((n, 2, lb.NL), dtype=torch.int64),
                  z((n, 2, lb.NL), dtype=torch.int64), torch.ones((n, be.Z_BITS), dtype=torch.int64),
                  torch.ones((n,), dtype=torch.int64))
    return prepare_in, z((n, 2, 2, lb.NL), dtype=torch.int64)


def test_backend_run_dispatches_each_stage_through_run_stage(monkeypatch):
    """TorchBackend.run: with attribution on, a device:<stage> span per
    stage in order on the current trace, the first use at the bucket in the
    compile family; off, no span and nothing recorded."""
    from lighthouse_tpu_torch.observability import trace as obstrace

    calls = []
    _stub_stages(monkeypatch, calls)
    obsdev.reset_seen()
    prepare_in, us = _inputs(8, 2)
    tr = Trace("gossip_attestation", 8)
    obstrace.set_current_trace(tr)
    try:
        ok, bad = be.TorchBackend.run(prepare_in, us)
        assert tr.spans == [] and bool(ok) and not bool(bad)
        with obsdev.attributed():
            for _ in range(2):
                be.TorchBackend.run(prepare_in, us)
    finally:
        obstrace.set_current_trace(None)
    assert calls == ["prepare", "h2c", "pairs", "pairing"] * 3
    assert [s[0] for s in tr.spans] == [f"device:{s}" for s in obsdev.STAGES] * 2
    assert [s[3]["phase"] for s in tr.spans] == ["compile"] * 4 + ["execute"] * 4
    assert {s[3]["bucket"] for s in tr.spans} == {"8x2"}
    snap = obsdev.snapshot_stages()["8x2"]
    assert all(snap[s]["count"] == 1 and "compile_s" in snap[s] for s in obsdev.STAGES)


def test_attributed_dispatch_captures_each_stage_once(monkeypatch):
    """With analytics on, the first attributed dispatch per (stage, bucket)
    counts the stage's work into the snapshot and the autotune profiler."""
    calls = []
    _stub_stages(monkeypatch, calls)
    perf.reset_programs()
    profiler.reset()
    prepare_in, us = _inputs(4, 8)
    prev = perf.set_analytics(True)
    try:
        with obsdev.attributed():
            be.TorchBackend.run(prepare_in, us)
            be.TorchBackend.run(prepare_in, us)
    finally:
        perf.set_analytics(prev)
    assert len(calls) == 8                     # the capture reuses the outputs
    progs = perf.program_snapshot()["4x8"]
    assert sorted(progs) == sorted(obsdev.STAGES)
    want = costs.fq_products_h2c(4) * costs.IMAD_PER_FQ_MUL
    assert progs["h2c"]["int_ops"] == want
    assert progs["pairs"]["int_ops"] == (costs.fq_products_pairs(4) * costs.IMAD_PER_FQ_MUL
                                         + 9 * costs.int_ops_inverse())
    assert progs["pairing"]["fq_products"] == (costs.fq_products_miller(torch.ones(5))
                                               + costs.fq_products_easy_part()
                                               + costs.fq_products_hard_part())
    assert profiler.snapshot_buckets()[(4, 8)].programs["h2c"]["int_ops"] == want
    assert perf.PROGRAM_INT_OPS.labels("h2c", 4, 8).value == want
    profiler.reset()
    perf.reset_programs()


def test_warm_stages_captures_prepare_and_h2c(monkeypatch):
    """warm_stages with analytics on counts the prepare and h2c programs
    at its bucket (the reference's warm_stages captures the same two)."""
    from lighthouse_tpu_torch.crypto.bls import api

    calls = []
    _stub_stages(monkeypatch, calls)
    cpu = be.TorchBackend(device="cpu")
    monkeypatch.setitem(api._BACKENDS, "torch", cpu)
    monkeypatch.setattr(cpu, "verify_signature_sets", lambda sets, rands: False)
    perf.reset_programs()
    prev = perf.set_analytics(True)
    try:
        be.warm_stages(3, 2)
    finally:
        perf.set_analytics(prev)
    assert sorted(perf.program_snapshot()["4x2"]) == ["h2c", "prepare"]
    assert calls == ["prepare", "h2c"]
    perf.reset_programs()
    profiler.reset()


def test_capture_program_counts_prepare_at_4x2():
    """capture_program on CPU tensors of the real stage_prepare at (4, 2):
    the counters' instructions and bytes, the tensors' footprint."""
    prepare_in, _us = _inputs(4, 2)
    prepare_in = prepare_in[:5] + (prepare_in[5] * torch.tensor([1, 0] * 32),) + prepare_in[6:]
    perf.reset_programs()
    stats = perf.capture_program("prepare", be.stage_prepare, prepare_in, (4, 2))
    products = costs.fq_products_prepare(prepare_in[2], prepare_in[5], prepare_in[6])
    assert stats["fq_products"] == products
    assert stats["int_ops"] == products * costs.IMAD_PER_FQ_MUL
    out_bytes = 3 * 4 * 48 + 3 * 2 * 48 + 1              # z_pk, sig_acc, the flag
    in_bytes = 2 * 4 * 2 * 48 + 1 + 2 * 4 * 2 * 48 + 32 + 1   # pubkeys, mask, sigs, bits, mask
    assert stats["bytes_accessed"] == in_bytes + out_bytes
    assert stats["argument_bytes"] == sum(t.numel() * 8 for t in prepare_in)
    assert perf.program_stats("prepare", (4, 2)) == stats
    assert perf.maybe_capture_program("prepare", None, prepare_in, (4, 2)) == stats
    assert perf.capture_program("nothing", lambda: 0, (), (4, 2)) is None
    perf.reset_programs()


def test_roofline_share_of_the_bound():
    stats = {"int_ops": 16.7e9, "bytes_accessed": 3.35e6}    # 1 ms of ops, 1 us of bytes
    rl = perf.roofline(stats, 0.004, "NVIDIA H100 80GB HBM3")
    assert rl["bound"] == "compute"
    assert rl["bound_ms"] == pytest.approx(1.0, rel=0.01)
    assert rl["bound_share"] == pytest.approx(0.25, rel=0.01)
    assert rl["int_ops_utilization"] == pytest.approx(0.25, rel=0.01)
    assert perf.roofline(stats, 0.0, None) is None
    assert "bound_share" not in perf.roofline(stats, 1.0, "cpu")


@pytest.mark.parametrize("env", [
    {}, {"ops": "100"}, {"hbm": "2000"}, {"ops": "100", "hbm": "2000"},
])
def test_peak_overrides_keep_the_reference_precedence(monkeypatch, env):
    """Both overrides beat the table for any kind; one replaces its peak
    in a known kind's row and gives nothing for an unknown kind; none gives
    the table. The same on the reference with its own names and rows."""
    for k in PEAK_ENV:
        monkeypatch.delenv(k, raising=False)
    if "ops" in env:
        monkeypatch.setenv("LIGHTHOUSE_TPU_PEAK_INT_OPS", env["ops"])
        monkeypatch.setenv("LIGHTHOUSE_TPU_PEAK_FLOPS", env["ops"])
    if "hbm" in env:
        monkeypatch.setenv("LIGHTHOUSE_TPU_PEAK_HBM_GBPS", env["hbm"])

    def shape(peak_for, known, table):
        got_known, got_other = peak_for(known), peak_for("unknown card")
        want = (float(env["ops"]) * 1e12 if "ops" in env else table[0],
                float(env["hbm"]) * 1e9 if "hbm" in env else table[1])
        return got_known == want, got_other is None, peak_for(None) is None

    kind = "NVIDIA H100 80GB HBM3"
    got = shape(perf.peak_for, kind, perf.PEAK_ESTIMATES[kind])
    assert got == shape(ref_perf.peak_for, "TPU v5e", ref_perf.PEAK_ESTIMATES["TPU v5e"])
    assert got == ((True, False, False) if len(env) == 2 else (True, True, True))
    assert perf.PEAK_ESTIMATES[kind] == (costs.INT32_PER_S, costs.HBM_BYTES_PER_S)


def test_profile_stages_chains_the_stages(monkeypatch):
    """profile_stages on stubs: reps + 1 dispatches of each stage in order,
    each fed the previous stages' outputs, and its summary's shape."""
    calls = []
    _stub_stages(monkeypatch, calls)
    obsdev.reset_seen()
    perf.reset_programs()
    out = obsdev.profile_stages(5, 3, reps=2, device="cpu", analytics=True)
    assert calls == ["prepare", "h2c", "pairs", "pairing"] * 3
    assert out["bucket"] == [8, 4] and out["reps"] == 2 and out["device_kind"] == "cpu"
    assert sorted(out["stages"]) == sorted(obsdev.STAGES)
    assert all(out["stages"][s]["count"] == 2 for s in obsdev.STAGES)
    assert sorted(out["programs"]) == sorted(obsdev.STAGES)
    perf.reset_programs()
    profiler.reset()
