"""Span tracer for the verification dataflow (the port's copy of the JAX
package's observability/trace.py).

Model: a `Trace` is one work unit's journey through the pipeline — a
coalesced gossip batch, a single work item, a device dispatch. Stages are
recorded as closed spans (name, t0, t1, args); producers may add
sub-spans and annotations (the torch backend annotates the padding bucket
and the real set count of the batch it marshals).

Every finished span feeds the `pipeline_stage_seconds{stage,kind}`
histogram family; the finished trace lands in a bounded ring, which
`chrome_trace_events` renders in the trace-event JSON schema that
Perfetto and chrome://tracing load directly — one "thread" row per
pipeline lane, complete ("ph": "X") events with microsecond timestamps.
Spans named `device:<stage>` are routed onto dedicated, named device
lanes; sampled queue depths export as counter events ("ph": "C"); the
flight recorder's events render as instant markers and the device
ledger's per-workload occupancy as lanes of their own.

Cost model: one Trace alloc + a span tuple append per stage per BATCH,
and one histogram observe per span. Timestamps are time.perf_counter()
(monotonic); the export rebases them so t=0 is the oldest event.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
from collections import deque
from time import perf_counter

from ..utils.metrics import REGISTRY

#: canonical stage order of the verification dataflow; the acceptance
#: surface for exports (docs/OBSERVABILITY.md "Trace stages")
PIPELINE_STAGES = ("enqueue", "coalesce", "marshal", "device", "continuation")

# spans range from sub-ms queue pops to multi-minute cold compiles
_STAGE_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0, 300.0,
)

STAGE_SECONDS = REGISTRY.histogram_vec(
    "pipeline_stage_seconds",
    "verification dataflow stage wall time, by stage and work kind",
    ("stage", "kind"),
    buckets=_STAGE_BUCKETS,
)

TRACES_TOTAL = REGISTRY.counter_vec(
    "pipeline_traces_total",
    "completed pipeline traces, by work kind",
    ("kind",),
)


#: process-wide monotonic trace ids — the correlation key the flight
#: recorder stamps on events recorded while a trace is current, so an
#: incident dump's event list joins against its recent-trace list
_next_trace_id = itertools.count(1)


def next_trace_id() -> int:
    """Allocate one id from the process-wide trace-id sequence (publish
    contexts built outside any Trace still need a unique causal key)."""
    return next(_next_trace_id)


class Trace:
    """One work unit's spans. Append-only; finished via Tracer.finish."""

    __slots__ = ("kind", "n_items", "t0", "spans", "meta", "trace_id", "ctx")

    def __init__(self, kind: str, n_items: int = 1):
        self.kind = kind
        self.n_items = n_items
        self.t0 = perf_counter()
        self.trace_id = next(_next_trace_id)
        self.spans: list = []        # (name, t0, t1, args|None)
        self.meta: dict = {}
        # wire-propagated origin context (observability/propagation.py):
        # set on the producer side at publish and ADOPTED on every
        # consumer, so a block's publish span and its remote
        # validate/import spans share one causal id — the merged Perfetto
        # export links them with flow events keyed on it
        self.ctx = None

    def add_span(self, name: str, t0: float, t1: float, **args) -> None:
        self.spans.append((name, t0, t1, args or None))

    def adopt(self, ctx) -> None:
        """Adopt a WireTraceContext into this trace (cross-node causal
        join): the context becomes the trace's flow key and its origin
        fields land in the exported span args."""
        self.ctx = ctx
        self.meta.update(
            causal=ctx.causal_id(), origin=ctx.origin,
            origin_slot=ctx.slot, origin_seq=ctx.seq,
        )

    def annotate(self, **kv) -> None:
        """Attach key/values to the whole trace (bucket, bytes, ...)."""
        self.meta.update(kv)

    def duration(self) -> float:
        if not self.spans:
            return 0.0
        return max(t1 for _, _, t1, _ in self.spans) - min(
            t0 for _, t0, _, _ in self.spans
        )


# wire-context thread-local (set by the transport's CREQ serve path):
# traces begun on a thread with a bound wire context auto-adopt it, so a
# served request's spans join the caller's causal chain without plumbing
# a context argument through every handler signature
_wire_tls = threading.local()


def set_current_wire_ctx(ctx) -> None:
    """Bind the wire context of the request being served to this thread
    (transport `Connection._serve`); `Tracer.begin` adopts it."""
    _wire_tls.ctx = ctx


def current_wire_ctx():
    return getattr(_wire_tls, "ctx", None)


class Tracer:
    """Bounded ring of completed traces + per-stage histogram feed."""

    def __init__(self, ring_size: int = 256, counter_ring_size: int = 2048):
        self.ring: deque = deque(maxlen=ring_size)
        # sampled counter values (t, name, {series: value}) — queue depths
        # today; exported as "ph": "C" rows next to the spans
        self.counter_ring: deque = deque(maxlen=counter_ring_size)
        self._lock = threading.Lock()
        self.completed = 0
        self.out_path: str | None = None  # where a caller writes the export
        # optional () -> [(t_mono, name, args)] provider of instant-event
        # markers for the export; the flight recorder wires itself onto
        # the global TRACER at import (test-local Tracer instances export
        # only their own spans)
        self.instants_source = None
        # optional () -> [(track, name, t0, t1, args)] provider of the
        # device ledger's merged per-workload occupancy timeline; the
        # ledger wires itself onto the global TRACER at import, the same
        # contract as instants_source
        self.device_timeline_source = None

    def begin(self, kind: str, n_items: int = 1) -> Trace:
        tr = Trace(kind, n_items)
        ctx = current_wire_ctx()
        if ctx is not None:
            tr.adopt(ctx)
        return tr

    def finish(self, trace: Trace | None) -> None:
        if trace is None:
            return
        for name, t0, t1, _args in trace.spans:
            STAGE_SECONDS.labels(name, trace.kind).observe(t1 - t0)
        TRACES_TOTAL.labels(trace.kind).inc()
        with self._lock:
            self.ring.append(trace)
            self.completed += 1

    def sample_counters(self, name: str, values: dict) -> None:
        """Record one sample of a counter track (e.g. per-WorkKind queue
        depth at batch-formation time); bounded, lock-guarded, cheap."""
        with self._lock:
            self.counter_ring.append((perf_counter(), name, dict(values)))

    def snapshot_ring(self) -> list[Trace]:
        with self._lock:
            return list(self.ring)

    def snapshot_counters(self) -> list[tuple]:
        with self._lock:
            return list(self.counter_ring)

    def reset(self) -> None:
        with self._lock:
            self.ring.clear()
            self.counter_ring.clear()
            self.completed = 0

    # ------------------------------------------------------------- export

    def write_chrome_trace(self, path: str) -> int:
        """Write the ring as Chrome trace-event JSON; returns event count.
        With an instants_source wired (the flight recorder on the global
        TRACER), its events render as instant markers on a dedicated lane
        of the same timeline."""
        events = chrome_trace_events(
            self.snapshot_ring(), counters=self.snapshot_counters(),
            instants=self.instants_source() if self.instants_source else None,
            device_timeline=self.device_timeline_source()
            if self.device_timeline_source else None,
        )
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "lighthouse-tpu pipeline tracer"},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


#: spans named `device:<stage>` render on dedicated lanes starting here
#: (host pipeline lanes recycle tid 0..HOST_LANES-1)
DEVICE_LANE_BASE = 1000

#: host pipeline lane count; tids recycle mod this. ONE owner — both the
#: span export and the flow-link synthesis derive a trace's lane from it,
#: and a divergence would detach every flow arrow from its slice
HOST_LANES = 32


def _host_tid(trace_index: int) -> int:
    return trace_index % HOST_LANES

#: flight-recorder instant events render on this dedicated lane
INSTANT_LANE = 900

#: trace kinds that ANCHOR a cross-node flow (the producer end of the
#: arrow): gossip publishes and HTTP client requests; everything else
#: carrying a wire context is a consumer (`http_serve`, imports, ...)
_FLOW_ANCHOR_KINDS = ("gossip_publish", "http_client")

#: the device ledger's per-workload occupancy/waiting tracks render on
#: dedicated lanes starting here (one tid per track, deterministically
#: ordered by track name)
DEVICE_LEDGER_LANE_BASE = 2000


def _device_timeline_events(timeline, pid: int, base: float) -> list[dict]:
    """Render the device ledger's merged timeline — (track, name, t0, t1,
    args) spans from DeviceLedger.perfetto_device_timeline() — as "X"
    rows on per-track lanes plus thread_name metadata. Tracks are
    assigned tids in sorted order so the export is deterministic: each
    workload's occupancy track (`ledger:<workload>`) sits beside its
    waiting-marker track (`ledger:<workload>:wait`)."""
    tracks = sorted({t for t, _, _, _, _ in timeline})
    tids = {t: DEVICE_LEDGER_LANE_BASE + i for i, t in enumerate(tracks)}
    events: list[dict] = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tids[t],
            "args": {"name": f"ledger:{t}"},
        }
        for t in tracks
    ]
    for track, name, t0, t1, args in timeline:
        ev = {
            "name": name,
            "cat": "device_ledger",
            "ph": "X",
            "ts": (t0 - base) * 1e6,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": pid,
            "tid": tids[track],
        }
        if args:
            ev["args"] = {k: str(v) for k, v in args.items()}
        events.append(ev)
    return events


def chrome_trace_events(
    traces: list[Trace], counters: list[tuple] | None = None,
    instants: list[tuple] | None = None, pid: int | None = None,
    base: float | None = None, device_timeline: list[tuple] | None = None,
) -> list[dict]:
    """Trace-event ("X" complete events, µs) rows for a list of traces.

    Each trace gets its own tid so overlapping pipeline lanes (up to
    max_inflight device batches) render as parallel rows; tids recycle
    mod 32 to keep the track count readable. Spans whose name starts
    with `device:` (per-stage device attribution sub-spans) are routed
    to one dedicated lane per stage (tid >= DEVICE_LANE_BASE) with a
    thread_name metadata row, so host pipeline and device stages show as
    distinct lanes of ONE timeline. `counters` — (t, name, {series:
    value}) samples from Tracer.sample_counters — export as "ph": "C"
    counter rows. `instants` — (t, name, args) markers from the flight
    recorder (breaker transitions, incidents, deadline misses) — export as
    "ph": "i" instant events on the dedicated INSTANT_LANE, so the black
    box's view lines up against the pipeline spans. `device_timeline` —
    (track, name, t0, t1, args) spans from the device ledger — render as
    per-workload occupancy/waiting lanes (tid >= DEVICE_LEDGER_LANE_BASE,
    deterministic track order). Timestamps are rebased
    so the oldest event is t=0 (`base` overrides the rebase origin so the
    cluster merge can put N tracers on one shared axis; `pid` overrides
    the process id so each node renders as its own process group).

    Cross-node flow events are NOT emitted here — they need the whole
    cluster's traces at once (one distinct s/f pair per consumer, or the
    trace-event flow model chains sibling importers into false causality);
    `merge_chrome_traces` synthesizes them."""
    counters = counters or []
    instants = instants or []
    device_timeline = device_timeline or []
    if not traces and not counters and not instants and not device_timeline:
        return []
    span_starts = [
        t0
        for tr in traces
        for _, t0, _, _ in tr.spans or [("", tr.t0, tr.t0, None)]
    ]
    if base is None:
        base = min(
            span_starts
            + [t for t, _, _ in counters]
            + [t for t, _, _ in instants]
            + [t0 for _, _, t0, _, _ in device_timeline]
        )
    if pid is None:
        pid = os.getpid()
    events = []
    device_lanes: dict = {}  # span name -> dedicated tid
    for i, tr in enumerate(traces):
        host_tid = _host_tid(i)
        for name, t0, t1, args in tr.spans:
            if name.startswith("device:"):
                tid = device_lanes.get(name)
                if tid is None:
                    tid = DEVICE_LANE_BASE + len(device_lanes)
                    device_lanes[name] = tid
            else:
                tid = host_tid
            ev = {
                "name": name,
                "cat": tr.kind,
                "ph": "X",
                "ts": (t0 - base) * 1e6,
                "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": pid,
                "tid": tid,
            }
            merged = dict(tr.meta)
            if args:
                merged.update(args)
            if merged:
                ev["args"] = {k: str(v) for k, v in merged.items()}
            events.append(ev)
    for name, tid in device_lanes.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
    for t, name, values in counters:
        events.append(
            {
                "name": name,
                "ph": "C",
                "ts": (t - base) * 1e6,
                "pid": pid,
                "tid": 0,
                "args": {k: float(v) for k, v in values.items()},
            }
        )
    if instants:
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": INSTANT_LANE,
                "args": {"name": "flight_recorder"},
            }
        )
        for t, name, args in instants:
            ev = {
                "name": name,
                "ph": "i",
                "s": "p",          # process-scope marker: full-height line
                "ts": (t - base) * 1e6,
                "pid": pid,
                "tid": INSTANT_LANE,
            }
            if args:
                ev["args"] = {k: str(v) for k, v in args.items()}
            events.append(ev)
    if device_timeline:
        events.extend(_device_timeline_events(device_timeline, pid, base))
    return events


def _flow_links(snaps, base: float) -> list[dict]:
    """Cross-node flow pairs for the cluster merge: ONE distinct (s, f)
    id per (publish, consumer trace). The trace-event flow model treats
    same-id events as a single sequential chain, so a fan-out publish with
    three importers keyed on one id would render import1 -> import2 —
    false causality between siblings; per-consumer ids give the documented
    publish -> each-import arrows. Consumers whose context has no publish
    anchor in the merged set (e.g. an rpc_serve adopting a non-publish
    caller context) emit nothing."""
    from .propagation import flow_id

    # pass 1: producer anchors — fid -> (pid, tid, mid-span time). Gossip
    # publishes and HTTP client requests both originate causal chains;
    # a gossip publish wins when both carry the same context (the HTTP
    # call is then itself a consumer of the publish's chain).
    anchors: dict = {}
    for i, (_name, traces, _c) in enumerate(snaps):
        for j, tr in enumerate(traces):
            if (tr.kind in _FLOW_ANCHOR_KINDS and tr.ctx is not None
                    and tr.spans):
                fid = flow_id(tr.ctx)
                if tr.kind != "gossip_publish" and fid in anchors:
                    continue
                first = tr.spans[0]
                anchors[fid] = (
                    i + 1, _host_tid(j), (first[1] + first[2]) / 2.0
                )
    # pass 2: one unique flow per consumer trace with a matching anchor
    events: list[dict] = []
    for i, (_name, traces, _c) in enumerate(snaps):
        pid = i + 1
        for j, tr in enumerate(traces):
            if (tr.ctx is None or tr.kind in _FLOW_ANCHOR_KINDS
                    or not tr.spans):
                continue
            fid = flow_id(tr.ctx)
            anchor = anchors.get(fid)
            if anchor is None:
                continue
            # digest-derived per-consumer id (NOT an arithmetic pack of
            # pid/index — wrapped indices or >31 pids would collide and
            # re-chain sibling flows)
            uid = int.from_bytes(
                hashlib.sha256(f"{fid}:{pid}:{j}".encode()).digest()[:6],
                "big",
            )
            apid, atid, ats = anchor
            events.append({
                "name": "propagation", "cat": "net", "ph": "s", "id": uid,
                "ts": (ats - base) * 1e6, "pid": apid, "tid": atid,
            })
            first = tr.spans[0]
            events.append({
                "name": "propagation", "cat": "net", "ph": "f", "bp": "e",
                "id": uid, "ts": (first[1] - base) * 1e6,
                "pid": pid, "tid": _host_tid(j),
            })
    return events


def merge_chrome_traces(named_tracers, path: str, instants=None,
                        device_timeline="auto") -> int:
    """Merge N nodes' tracers into ONE Chrome-trace file: each node is a
    distinct process group (pid = position + 1, named via process_name
    metadata), every timestamp rebased against one shared origin, and
    cross-node flow events link each publish span to the remote import
    spans that adopted its wire context. `named_tracers` is an iterable of
    (name, Tracer); `instants` — (t_mono, name, args) markers (the flight
    recorder's `perfetto_instants()`, which is process-global and so
    cluster-wide in an in-process harness) render as a dedicated
    `flight_recorder` process group (pid 0). The device ledger's merged
    per-workload timeline (process-global, like the recorder) renders as
    its own `device_ledger` process group after the node groups —
    `device_timeline="auto"` pulls it from the global TRACER's wired
    source, an explicit list overrides, None suppresses. Returns the
    event count written."""
    snaps = [
        (name, tr.snapshot_ring(), tr.snapshot_counters())
        for name, tr in named_tracers
    ]
    instants = list(instants) if instants else []
    if device_timeline == "auto":
        src = TRACER.device_timeline_source
        device_timeline = src() if src else []
    device_timeline = list(device_timeline) if device_timeline else []
    starts = [
        t0
        for _, traces, counters in snaps
        for tr in traces
        for _, t0, _, _ in tr.spans or [("", tr.t0, tr.t0, None)]
    ] + [t for _, _, counters in snaps for t, _, _ in counters] + [
        t for t, _, _ in instants
    ] + [t0 for _, _, t0, _, _ in device_timeline]
    base = min(starts) if starts else 0.0
    events: list[dict] = []
    if instants:
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": 0,
                "tid": 0,
                "args": {"name": "flight_recorder"},
            }
        )
        events.extend(
            chrome_trace_events([], instants=instants, pid=0, base=base)
        )
    for i, (name, traces, counters) in enumerate(snaps):
        pid = i + 1
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": name},
            }
        )
        events.extend(
            chrome_trace_events(traces, counters=counters, pid=pid,
                                base=base)
        )
    if device_timeline:
        dl_pid = len(snaps) + 1
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": dl_pid,
                "tid": 0,
                "args": {"name": "device_ledger"},
            }
        )
        events.extend(
            _device_timeline_events(device_timeline, dl_pid, base)
        )
    events.extend(_flow_links(snaps, base))
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "lighthouse-tpu cluster trace merge"},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


TRACER = Tracer()

# ------------------------------------------------------- context propagation

_tls = threading.local()


def set_current_trace(trace: Trace | None) -> None:
    """Bind the in-progress trace to this thread so layers below the
    caller (the torch backend's marshal) can annotate it without plumbing
    a trace argument through every call signature."""
    _tls.trace = trace


def current_trace() -> Trace | None:
    return getattr(_tls, "trace", None)
