"""Device ms of the three MSM kernels (csrc/msm.cu) at the KZG path's full
width, to compare checkouts in one call on the card.

The inputs are chip_smoke.py's: msm_precompute on the 4096 points of
bench_fixtures.npz's setup, msm_fixed on their 65536 comb lanes with blob
0's scalars, msm_varying on the batch verify's C' (18 points in a bucket
of 32 at w = 4, captured from one verify_blob_kzg_proof_batch). Each
kernel's output is held equal (torch.equal) to its plain version once,
then ROUNDS rounds give each kernel function's device ms from
torch.profiler (the mean of REPS calls) and the wrapper's CUDA-event ms.
Run from a checkout's root on a machine with a CUDA card (copy this file
into another checkout's lighthouse_tpu_torch/testing/ to time that one):

    python3 -m lighthouse_tpu_torch.testing.msm_timing

Prints one JSON line per round and a last line with the medians.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROUNDS = 3
REPS = 3
FUNCTIONS = {
    "msm_precompute": ("msm_precompute_kernel",),
    "msm_fixed": ("msm_hist_kernel", "msm_scatter_kernel", "msm_level_kernel", "msm_join_kernel"),
    "msm_varying": ("msm_recode_kernel", "msm_level_kernel", "msm_join_kernel"),
}


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("msm_timing: no CUDA device", file=sys.stderr)
        return 2
    from ..crypto import bls, kzg
    from ..crypto.torchbls import kernels as K
    from ..crypto.torchbls import msm
    from ..crypto.torchbls.backend import pack_ints_vec
    from ..utils import fixtures

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    K.library()
    build_s = time.perf_counter() - t0
    kz = fixtures.load_kzg(str(ROOT / "bench_fixtures.npz"))
    setup = kzg.TrustedSetup(kz["g1_lagrange"], kz["g2_monomial"],
                             kzg._fr_roots_of_unity(len(kz["g1_lagrange"])))
    blobs, cbs, pbs = kz["blobs"], kz["commitments"], kz["proofs"]
    backend = bls.set_backend("torch")
    captured = []
    real_g1_msm = backend.g1_msm

    def spy(points, scalars):
        captured.append((list(points), list(scalars)))
        return real_g1_msm(points, scalars)

    backend.g1_msm = spy
    try:
        if kzg.verify_blob_kzg_proof_batch(blobs, cbs, pbs, setup) is not True:
            raise SystemExit("the KZG batch verify failed")
    finally:
        del backend.g1_msm
    g1 = setup.g1_lagrange
    pre = tuple(torch.as_tensor(a, device=dev) for a in (
        pack_ints_vec([p[0] for p in g1]).astype(np.int64),
        pack_ints_vec([p[1] for p in g1]).astype(np.int64), np.zeros(len(g1), bool)))
    comb = msm.FixedBaseMSM(g1, dev)
    args = {"msm_precompute": pre,
            "msm_fixed": (*comb._tables, comb.bits_tensor(kzg.blob_to_polynomial(blobs[0], setup))),
            "msm_varying": backend.msm_inputs(*captured[0], 4) + (4,)}
    for name, a in args.items():
        kernel, plain = K.KERNELS[name][0](*a), K.KERNELS[name][1](*a)
        if not all(torch.equal(k, p) for k, p in zip(kernel, plain)):
            raise SystemExit(f"{name} differs from its plain version")

    rounds = []
    for rnd in range(ROUNDS):
        row = {}
        for name, a in args.items():
            wrapper = K.KERNELS[name][0]
            wrapper(*a)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                wrapper(*a)
            end.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    wrapper(*a)
                torch.cuda.synchronize()
            split = {}
            for ev in prof.key_averages():
                key = ev.key.split("(")[0].split("<")[0].removeprefix("void ")
                if key in FUNCTIONS[name]:
                    split[key] = (getattr(ev, "device_time_total", None)
                                  or getattr(ev, "cuda_time_total", 0)) / 1e3 / REPS
            row[name] = {"event_ms": start.elapsed_time(end) / REPS,
                         "device_ms": sum(split.values()), "split": split}
        rounds.append(row)
        print(json.dumps({"phase": "msm_timing", "round": rnd, **row}), flush=True)
    print(json.dumps({
        "phase": "msm_timing_summary", "cwd": os.getcwd(), "build_s": build_s,
        "library": str(K.library().path), "rounds": ROUNDS,
        **{f"{name}_device_ms_median": statistics.median(r[name]["device_ms"] for r in rounds)
           for name in args},
        **{f"{name}_join_ms_median": statistics.median(r[name]["split"]["msm_join_kernel"]
                                                       for r in rounds)
           for name in ("msm_fixed", "msm_varying")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
