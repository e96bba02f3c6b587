"""Pipelined dispatch for the torch BLS backend: a depth window, FIFO tickets
and an urgent bypass lane (the port's copy of the JAX package's
crypto/jaxbls/pipeline.py).

- **Depth window.** Up to `depth` batches ride the device queue while the
  host marshals the next one. A batch-lane submission that finds the window
  full first resolves the oldest batch in flight: the backpressure that
  keeps the host's marshal of batch k+1 overlapped with the device's work
  on batch k. Depth resolves explicit argument > LIGHTHOUSE_TPU_PIPELINE_DEPTH
  > the autotune plan's `pipeline_depth` > 4, clamped to (1, 16); a plan
  installed later retunes a live dispatcher through `set_depth`.
- **FIFO resolution.** Batch-lane tickets resolve in submission order,
  whichever ticket's `result()` is called first.
- **Urgent lane.** Urgent submissions (single-set verifies) neither wait for
  a slot nor take one.
- **Errors stay on their ticket.** A handle's exception is stored once and
  re-raised to every `result()` caller of that ticket; it never fails a
  later ticket or a submitter that resolved it to make room.
- **Tenants.** A dispatcher named with a `workload` registers it with the
  device ledger (observability/device_ledger.py); each submission opens an
  interval there with its lane and bucket, marked busy when its dispatch
  begins and closed with its outcome when it resolves.

Metric families `torchbls_pipeline_{depth,inflight,submitted_total,
resolved_total,admit_wait_seconds}` (the reference's `jaxbls_pipeline_*`);
the submitted and resolved counts per lane are also plain attributes.

Host-only: nothing here touches a device, so the dispatcher is tested with
stub handles.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from time import perf_counter

from ...observability.device_ledger import LEDGER
from ...utils.metrics import REGISTRY

_DEPTH_GAUGE = REGISTRY.gauge_vec(
    "torchbls_pipeline_depth",
    "configured double-buffering depth of the torchbls dispatch window, by "
    "the layer that decided it (explicit/env/profile/default)",
    ("source",),
)
_INFLIGHT = REGISTRY.gauge_vec(
    "torchbls_pipeline_inflight",
    "device batches currently in flight through the dispatcher, by lane",
    ("lane",),
)
_SUBMITTED = REGISTRY.counter_vec(
    "torchbls_pipeline_submitted_total",
    "batches submitted through the pipelined dispatcher, by lane",
    ("lane",),
)
_RESOLVED = REGISTRY.counter_vec(
    "torchbls_pipeline_resolved_total",
    "batches resolved by the pipelined dispatcher, by lane and outcome",
    ("lane", "outcome"),
)
_ADMIT_WAIT = REGISTRY.histogram_vec(
    "torchbls_pipeline_admit_wait_seconds",
    "time a submission waited for a window slot (resolving the oldest "
    "in-flight batch) before dispatching, by lane — the urgent lane "
    "never waits",
    ("lane",),
    buckets=(0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)

DEFAULT_DEPTH = 4
DEPTH_CLAMP = (1, 16)


def _clamp_depth(d: int) -> int:
    lo, hi = DEPTH_CLAMP
    return max(lo, min(hi, int(d)))


def _plan():
    """The installed autotune plan, or None — never raises and never
    initializes a device."""
    try:
        from ...autotune import runtime

        return runtime.active_plan()
    except Exception:
        return None


def resolve_depth(explicit=None) -> tuple:
    """(depth, source): explicit argument ("explicit") >
    LIGHTHOUSE_TPU_PIPELINE_DEPTH ("env") > the autotune plan's
    pipeline_depth ("profile") > DEFAULT_DEPTH ("default"), clamped to
    DEPTH_CLAMP at every layer. A malformed variable falls through to the
    next layer."""
    if explicit is not None:
        return _clamp_depth(explicit), "explicit"
    raw = os.environ.get("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "").strip()
    if raw:
        try:
            return _clamp_depth(int(raw)), "env"
        except ValueError:
            pass
    plan = _plan()
    depth = getattr(plan, "pipeline_depth", None) if plan is not None else None
    if depth:
        return _clamp_depth(depth), "profile"
    return DEFAULT_DEPTH, "default"


class PipelineTicket:
    """One submitted batch; `result()` returns its handle's result() value.

    For the batch lane, resolving ticket k first resolves every earlier
    unresolved batch-lane ticket in submission order. Urgent tickets
    resolve on their own."""

    __slots__ = ("_dispatcher", "lane", "handle", "done", "value", "error", "claimed", "_ev",
                 "interval")

    def __init__(self, dispatcher, lane, handle, interval=None):
        self._dispatcher = dispatcher
        self.lane = lane
        self.handle = handle
        self.interval = interval       # device-ledger interval, or None
        self.done = False
        self.value = None
        self.error = None
        self.claimed = False           # a thread owns this ticket's finish
        self._ev = threading.Event()   # set when done (cross-thread waits)

    def result(self):
        return self._dispatcher.resolve(self)


class PipelinedDispatcher:
    """Depth-bounded in-flight window over asynchronous device handles.

    `submit(dispatch)` admits a batch into the window, then runs
    `dispatch()`, a thunk that enqueues the device work and returns a
    handle with `.result()`; the caller has already done the host marshal.
    Urgent submissions skip both the wait and the window. A dispatcher
    with a `workload` books its submissions in the device ledger under
    that tenant; an anonymous one (ad-hoc tests) stays off the books."""

    def __init__(self, depth=None, workload=None):
        self.depth, self.depth_source = resolve_depth(depth)
        self.workload = None if workload is None else str(workload)
        if self.workload is not None:
            LEDGER.register(self.workload, self)
        # state lock (window bookkeeping) and a lock that serialises FIFO
        # drains
        self._lock = threading.Lock()
        self._resolve_lock = threading.Lock()
        self._window: deque = deque()      # batch-lane tickets, FIFO
        # admission slots claimed by submitters still inside dispatch():
        # len(window) + reserved <= depth always holds, so concurrent
        # submitters cannot overfill the window between the check and the
        # append
        self._reserved = 0
        self._slot_free = threading.Condition(self._lock)
        self._urgent_inflight = 0
        self.submitted = {"batch": 0, "urgent": 0}
        self.resolved = {"batch": 0, "urgent": 0}
        _DEPTH_GAUGE.labels(self.depth_source).set(self.depth)

    def set_depth(self, depth: int, source: str) -> None:
        """Live depth retune (an autotune plan installed mid-run)."""
        self.depth = _clamp_depth(depth)
        self.depth_source = source
        _DEPTH_GAUGE.labels(source).set(self.depth)

    # -- submission ------------------------------------------------------

    def submit(self, dispatch, urgent=False, bucket=None) -> PipelineTicket:
        """Admit and dispatch one batch; `bucket` (optional) annotates its
        device-ledger interval with the padding bucket."""
        lane = "urgent" if urgent else "batch"
        interval = None
        if self.workload is not None:
            interval = LEDGER.open(self.workload, lane=lane, bucket=bucket)
        t0 = perf_counter()
        if not urgent:
            while True:
                with self._lock:
                    if len(self._window) + self._reserved < self.depth:
                        self._reserved += 1
                        break
                    oldest = self._window[0] if self._window else None
                if oldest is not None:
                    try:
                        self.resolve(oldest)   # blocking wait: backpressure
                    except Exception:
                        # the failure belongs to the oldest batch and stays
                        # on its ticket; it must not fail this submission
                        pass
                else:
                    # every slot is held by a submitter still in dispatch()
                    with self._slot_free:
                        self._slot_free.wait(timeout=0.05)
        _ADMIT_WAIT.labels(lane).observe(perf_counter() - t0)
        if interval is not None:
            interval.start()           # admit wait over: device dispatch
        try:
            handle = dispatch()
        except BaseException:
            if interval is not None:
                interval.close("error")
            if not urgent:
                with self._slot_free:
                    self._reserved -= 1
                    self._slot_free.notify_all()
            raise
        ticket = PipelineTicket(self, lane, handle, interval)
        with self._lock:
            if urgent:
                self._urgent_inflight += 1
                _INFLIGHT.labels("urgent").set(self._urgent_inflight)
            else:
                self._reserved -= 1
                self._window.append(ticket)
                _INFLIGHT.labels("batch").set(len(self._window))
            self.submitted[lane] += 1
        _SUBMITTED.labels(lane).inc()
        return ticket

    # -- resolution ------------------------------------------------------

    def resolve(self, ticket: PipelineTicket):
        """Resolve `ticket` (on the batch lane, every earlier batch-lane
        ticket first). Returns the stored value or re-raises the stored
        error; idempotent."""
        if ticket.done:
            return self._outcome(ticket)
        if ticket.lane == "urgent":
            with self._lock:
                already_claimed, ticket.claimed = ticket.claimed, True
            if already_claimed:
                ticket._ev.wait()      # another thread owns the finish
                return self._outcome(ticket)
            self._finish(ticket)
            with self._lock:
                self._urgent_inflight = max(0, self._urgent_inflight - 1)
                _INFLIGHT.labels("urgent").set(self._urgent_inflight)
            return self._outcome(ticket)
        with self._resolve_lock:
            while not ticket.done:
                with self._slot_free:
                    head = self._window.popleft() if self._window else None
                    _INFLIGHT.labels("batch").set(len(self._window))
                    if head is not None:
                        self._slot_free.notify_all()
                if head is None:
                    # the ticket left the window on another thread's drain
                    if not ticket.done:  # pragma: no cover - defensive
                        self._finish(ticket)
                    break
                self._finish(head)
        return self._outcome(ticket)

    def drain(self) -> int:
        """Resolve every in-flight batch-lane ticket. Errors stay on their
        tickets; the drain completes."""
        n = 0
        while True:
            with self._lock:
                ticket = self._window[0] if self._window else None
            if ticket is None:
                return n
            try:
                self.resolve(ticket)
            except Exception:
                pass
            n += 1

    def inflight(self) -> int:
        with self._lock:
            return len(self._window) + self._urgent_inflight

    def _finish(self, ticket: PipelineTicket) -> None:
        if ticket.done:
            return
        try:
            ticket.value = ticket.handle.result()
            outcome = "ok"
        except Exception as e:
            ticket.error = e
            outcome = "error"
        ticket.done = True
        # a resolved ticket must not keep device buffers alive
        ticket.handle = None
        if ticket.interval is not None:
            ticket.interval.close(outcome)
            ticket.interval = None
        with self._lock:
            self.resolved[ticket.lane] += 1
        ticket._ev.set()
        _RESOLVED.labels(ticket.lane, outcome).inc()

    @staticmethod
    def _outcome(ticket: PipelineTicket):
        if ticket.error is not None:
            raise ticket.error
        return ticket.value
