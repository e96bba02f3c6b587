"""Observability of the port: span tracing, the flight recorder, the SLO
accountant, the device ledger, per-stage device attribution, program
analytics, the pipeline snapshot and cross-node propagation (copies of the JAX package's modules of the same names).

  - `trace`: a lightweight span tracer. A Trace carries one work unit
    through the pipeline; completed traces land in a bounded ring and
    feed per-stage Prometheus histograms, and the ring exports as Chrome
    trace-event (Perfetto) JSON.
  - `flight_recorder`: the always-on black box — a bounded ring of
    structured events (breaker transitions, route flips, deadline misses,
    WARN+ log records) with incident triggers that dump diagnosis
    snapshots and render as instant markers in the Perfetto export.
  - `slo`: the slot-level service-level accountant — one SlotReport per
    slot boundary, rolling 5-slot and 32-slot windows with burn rate, the
    `slo_*` families and the health degraded signal.
  - `device_ledger`: who holds the card and who waits — per-tenant busy
    time of the `bls`, `tree_hash` and `epoch` workloads, admit waits,
    cross-tenant contention, and exact per-chip conservation.
  - `device`: per-stage device time of the verify — NVTX ranges around
    every stage dispatch on the card, and with attribution on, CUDA events
    into `torchbls_stage_{device,compile}_seconds` and `device:<stage>`
    trace spans; `profile_stages` times the four stages at one bucket.
  - `perf`: program analytics (each stage's integer instructions and bytes
    at its inputs, `torchbls_program_*`) and the roofline against the
    card's peaks.
  - `pipeline`: the stage-timing snapshot (per-stage timings, every
    registered BeaconProcessor's live state, recent traces) and
    `run_probe`, which pushes a small batch through a real BeaconProcessor
    to the active BLS backend.
  - `propagation`: cross-node causality — the wire trace context every
    gossip publish and Req/Resp request carries, per-node propagation SLIs
    (`net_propagation_seconds{topic}`, time-to-head) and the
    propagation-stall incident trigger.

Always-on by design: recording a trace is appending a few floats to a
deque. Nothing here initializes a device.
"""

from .trace import (  # noqa: F401
    PIPELINE_STAGES,
    TRACER,
    Trace,
    Tracer,
    chrome_trace_events,
    current_trace,
    set_current_trace,
)
from .pipeline import register_processor, snapshot  # noqa: F401
from . import device, device_ledger, flight_recorder, perf, slo  # noqa: F401  (registers their families + the log sink)
from . import propagation  # noqa: F401  (registers the net_* families)
from .device_ledger import LEDGER  # noqa: F401
from .flight_recorder import RECORDER  # noqa: F401
from .slo import ACCOUNTANT  # noqa: F401
