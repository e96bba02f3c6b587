"""Pipeline stage-timing snapshot + startup trace probe.

`snapshot()` backs the `/lighthouse_tpu/pipeline` ops endpoint: aggregate
per-stage timings (from the tracer's histogram family), live scheduler
state (from any registered BeaconProcessor), and summaries of the most
recent completed traces. Everything is read-only over data the hot path
already maintains — a snapshot never touches a lock the dispatch path
holds.

`run_probe()` pushes a small synthetic batch through a real
BeaconProcessor so a freshly started (or quiet) node still produces spans
for every pipeline stage — the `bn --trace-out` bring-up path uses it, and
the e2e scrape test rides the same code.

The port's copy of the JAX package's observability/pipeline.py. Its
snapshot has no `perf_trend` key: the bench-trend half of perf.py reads
the JAX package's benchmark records and is not ported, which is what the
reference's snapshot gives when no BENCH artifacts ship.
"""

from __future__ import annotations

import weakref

from .trace import PIPELINE_STAGES, STAGE_SECONDS, TRACER

_processors: list = []  # weakrefs to registered BeaconProcessors


def register_processor(proc) -> None:
    """Expose a BeaconProcessor's live queue state to snapshots. Weakly
    referenced: a stopped/collected processor drops out on its own."""
    _processors.append(weakref.ref(proc))


def _live_processors():
    out = []
    stale = []
    for ref in _processors:
        p = ref()
        if p is None:
            stale.append(ref)
        else:
            out.append(p)
    for ref in stale:
        _processors.remove(ref)
    return out


def _stage_stats() -> dict:
    """Per-(stage, kind) timing summary from the histogram family."""
    out: dict = {}
    for key, child in STAGE_SECONDS.children():
        stage, kind = key
        if child.n == 0:
            continue
        out.setdefault(stage, {})[kind] = {
            "count": child.n,
            "total_seconds": round(child.total, 6),
            "mean_seconds": round(child.total / child.n, 6),
        }
    return out


def snapshot() -> dict:
    stats = _stage_stats()
    procs = []
    for p in _live_processors():
        procs.append(p.stats())
    recent = []
    for tr in TRACER.snapshot_ring()[-32:]:
        recent.append(
            {
                "kind": tr.kind,
                "items": tr.n_items,
                "duration_seconds": round(tr.duration(), 6),
                "spans": [
                    {"stage": name, "seconds": round(t1 - t0, 6)}
                    for name, t0, t1, _ in tr.spans
                ],
                **({"meta": {k: str(v) for k, v in tr.meta.items()}}
                   if tr.meta else {}),
            }
        )
    return {
        "stages": [s for s in PIPELINE_STAGES if s in stats],
        "stage_timings": stats,
        "processors": procs,
        "traces_completed": TRACER.completed,
        "recent_traces": recent,
    }


def run_probe(n_items: int = 8) -> int:
    """Drive a synthetic attestation-shaped batch through a REAL
    BeaconProcessor end to end (enqueue -> coalesce -> marshal -> async
    verify handle -> device wait -> continuation) using the active BLS
    backend. Returns the number of work units executed.

    The sets are generator-point placeholders (verify False on real
    backends, True on fake) — the result is discarded; the trace is the
    point. Kept tiny so even the pure-Python backend finishes in ~a second.
    """
    from ..chain.beacon_processor import (
        BeaconProcessor,
        BeaconProcessorConfig,
        WorkItem,
        WorkKind,
    )
    from ..crypto import bls
    from ..crypto.bls381 import curve as cv
    from .slo import SlotAccountant

    pk = bls.PublicKey(cv.G1_GEN)
    sig = bls.Signature(cv.G2_GEN)

    def run_batch(payloads):
        sets = [
            bls.SignatureSet(sig, [pk], i.to_bytes(4, "little") * 8)
            for i in range(len(payloads))
        ]
        handle = bls.verify_signature_sets_async(sets)
        return handle, lambda ok: None

    proc = BeaconProcessor(
        BeaconProcessorConfig(max_attestation_batch=max(2, n_items))
    )
    # synthetic probe work must not pollute the node's production SLI (a
    # cold first dispatch reading as 8 deadline misses could trip the
    # burn-rate incident on a healthy node): throwaway accountant
    proc.slo = SlotAccountant(export_metrics=False)
    for i in range(n_items):
        proc.submit(
            WorkItem(
                kind=WorkKind.gossip_attestation, payload=i,
                run_batch=run_batch,
            )
        )
    return proc.run_until_idle()
