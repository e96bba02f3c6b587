"""Where a pipelined submission's host time goes on the card.

Drives the pipelined path of chip_smoke.py (8 asynchronous submissions of
the 64 x 128 gossip batch at the dispatcher's depth, the 5th tampered)
through the port's public API and splits every submission's host time:
the marshal (TorchBackend.marshal), of it the host-to-card copies
(TorchBackend._tensor), the four stages' launches (the backend's stage
functions), and the rest (the dispatcher's window: resolving the oldest
batch in flight). CUDA events around each copy and each stage give their
device ms. With --kzg-first, the KZG commitments and proofs of the
fixture's 6 blobs run first (comb tables, and pinned host blocks of the
comb bits left in PyTorch's host allocator), as chip_smoke.py's KZG phase
leaves them. Run from a checkout's root on a machine with a CUDA card:

    python3 -m lighthouse_tpu_torch.testing.submission_timing [--kzg-first]

Prints one JSON line per round (ROUNDS of them) and a last line with the
medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SUBMISSIONS = 8
ROUNDS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixtures", default=str(ROOT / "bench_fixtures.npz"))
    ap.add_argument("--kzg-first", action="store_true")
    args = ap.parse_args(argv)

    import random

    import torch

    if not torch.cuda.is_available():
        print("submission_timing: no CUDA device", file=sys.stderr)
        return 2
    from ..crypto import bls
    from ..crypto.torchbls import backend as be
    from ..crypto.torchbls import kernels as K
    from ..utils import fixtures

    t0 = time.perf_counter()
    K.library()
    build_s = time.perf_counter() - t0
    att = fixtures.load_groups(args.fixtures, n_att=64)["att"]

    def rands(n: int) -> list[int]:          # chip_smoke.py's coefficients
        r = random.Random(int.from_bytes(b"chipsmok", "little"))
        return [1] + [r.getrandbits(64) | 1 for _ in range(n - 1)]

    s0 = att[0]
    tampered = [bls.SignatureSet(s0.signature, s0.signing_keys,
                                 bytes([s0.message[0] ^ 1]) + s0.message[1:])] + att[1:]
    bls.set_backend("torch")
    kzg_s = None
    if args.kzg_first:
        from ..crypto import kzg

        t0 = time.perf_counter()
        kz = fixtures.load_kzg(args.fixtures)
        setup = kzg.TrustedSetup(kz["g1_lagrange"], kz["g2_monomial"],
                                 kzg._fr_roots_of_unity(len(kz["g1_lagrange"])))
        for b, cb in zip(kz["blobs"], kz["commitments"]):
            kzg.blob_to_kzg_commitment(b, setup)
            kzg.compute_blob_kzg_proof(b, cb, setup)
        torch.cuda.synchronize()
        kzg_s = time.perf_counter() - t0
    if bls.verify_signature_sets(att, rands) is not True:     # warm: the pubkey grid
        raise SystemExit("the gossip batch did not verify")

    # the instrumented parts: host seconds and event pairs per submission
    rec: dict = {}

    def timed(kind, fn):
        def wrapper(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = fn(*a, **kw)
            end.record()
            rec.setdefault(kind, []).append((time.perf_counter() - t, start, end))
            return out
        return wrapper

    real = {"marshal": be.TorchBackend.marshal, "_tensor": be.TorchBackend._tensor}
    real_stages = {name: getattr(be, name)
                   for name in ("stage_prepare", "stage_h2c", "stage_pairs", "stage_pairing")}
    be.TorchBackend.marshal = timed("marshal", real["marshal"])
    be.TorchBackend._tensor = timed("copy", real["_tensor"])
    for name, fn in real_stages.items():
        setattr(be, name, timed(name, fn))
    batches = [tampered if i == 4 else att for i in range(SUBMISSIONS)]
    expected = [i != 4 for i in range(SUBMISSIONS)]
    rounds = []
    try:
        for rnd in range(ROUNDS):
            torch.cuda.synchronize()
            subs = []
            t_wall = time.perf_counter()
            tickets = []
            for batch in batches:
                rec.clear()
                t = time.perf_counter()
                tickets.append(bls.verify_signature_sets_async(batch, rands))
                subs.append((time.perf_counter() - t, dict(rec)))
            verdicts = [tk.result() for tk in tickets]
            wall = time.perf_counter() - t_wall
            torch.cuda.synchronize()
            if verdicts != expected:
                raise SystemExit(f"verdicts {verdicts}, want {expected}")
            rows = []
            for total, parts in subs:
                host = {k: sum(h for h, _s, _e in v) for k, v in parts.items()}
                dev = {k: sum(s.elapsed_time(e) for _h, s, e in v) for k, v in parts.items()}
                launches = sum(host.get(n, 0.0) for n in real_stages)
                rows.append({
                    "submit_s": total, "marshal_s": host.get("marshal", 0.0),
                    "copies_s": host.get("copy", 0.0), "copies": len(parts.get("copy", [])),
                    "launches_s": launches,
                    "window_s": total - host.get("marshal", 0.0) - launches,
                    "stage_host_s": {n: host.get(n, 0.0) for n in real_stages},
                    "copy_device_ms": dev.get("copy", 0.0),
                    "stage_device_ms": {n: dev.get(n, 0.0) for n in real_stages}})
            rounds.append({"round": rnd, "wall_s": wall, "submissions": rows})
            print(json.dumps({"phase": "submission_timing", **rounds[-1]}), flush=True)
    finally:
        be.TorchBackend.marshal, be.TorchBackend._tensor = real["marshal"], real["_tensor"]
        for name, fn in real_stages.items():
            setattr(be, name, fn)

    def med(key):
        return statistics.median(s[key] for rd in rounds for s in rd["submissions"])

    print(json.dumps({
        "phase": "submission_timing_summary", "cwd": os.getcwd(), "kzg_first": args.kzg_first,
        "kzg_first_s": kzg_s, "build_s": build_s, "rounds": ROUNDS,
        "library": str(K.library().path),
        "wall_s_median": statistics.median(rd["wall_s"] for rd in rounds),
        **{f"{k}_median": med(k) for k in ("submit_s", "marshal_s", "copies_s", "launches_s",
                                           "window_s", "copy_device_ms")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
