"""Pipelined dispatch for the torch BLS backend: a depth window, FIFO tickets
and an urgent bypass lane (the port's copy of the JAX package's
crypto/jaxbls/pipeline.py).

- **Depth window.** Up to `depth` batches ride the device queue while the
  host marshals the next one. A batch-lane submission that finds the window
  full first resolves the oldest batch in flight: the backpressure that
  keeps the host's marshal of batch k+1 overlapped with the device's work
  on batch k. Depth resolves explicit argument > LIGHTHOUSE_TPU_PIPELINE_DEPTH
  > 4, clamped to (1, 16).
- **FIFO resolution.** Batch-lane tickets resolve in submission order,
  whichever ticket's `result()` is called first.
- **Urgent lane.** Urgent submissions (single-set verifies) neither wait for
  a slot nor take one.
- **Errors stay on their ticket.** A handle's exception is stored once and
  re-raised to every `result()` caller of that ticket; it never fails a
  later ticket or a submitter that resolved it to make room.

Host-only: nothing here touches a device, so the dispatcher is tested with
stub handles. Submitted and resolved counts per lane are plain attributes.
"""

from __future__ import annotations

import os
import threading
from collections import deque

DEFAULT_DEPTH = 4
DEPTH_CLAMP = (1, 16)


def _clamp_depth(d: int) -> int:
    lo, hi = DEPTH_CLAMP
    return max(lo, min(hi, int(d)))


def resolve_depth(explicit=None) -> tuple:
    """(depth, source): explicit argument ("explicit") >
    LIGHTHOUSE_TPU_PIPELINE_DEPTH ("env") > DEFAULT_DEPTH ("default"),
    clamped to DEPTH_CLAMP at every layer. A malformed variable falls
    through to the default. The reference's "profile" layer (the autotune
    plan's pipeline_depth, between env and default) is left out until the
    port has the autotune plan."""
    if explicit is not None:
        return _clamp_depth(explicit), "explicit"
    raw = os.environ.get("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "").strip()
    if raw:
        try:
            return _clamp_depth(int(raw)), "env"
        except ValueError:
            pass
    return DEFAULT_DEPTH, "default"


class PipelineTicket:
    """One submitted batch; `result()` returns its handle's result() value.

    For the batch lane, resolving ticket k first resolves every earlier
    unresolved batch-lane ticket in submission order. Urgent tickets
    resolve on their own."""

    __slots__ = ("_dispatcher", "lane", "handle", "done", "value", "error", "claimed", "_ev")

    def __init__(self, dispatcher, lane, handle):
        self._dispatcher = dispatcher
        self.lane = lane
        self.handle = handle
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
    Urgent submissions skip both the wait and the window."""

    def __init__(self, depth=None):
        self.depth = resolve_depth(depth)[0]
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

    # -- submission ------------------------------------------------------

    def submit(self, dispatch, urgent=False) -> PipelineTicket:
        """Admit and dispatch one batch."""
        lane = "urgent" if urgent else "batch"
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
        try:
            handle = dispatch()
        except BaseException:
            if not urgent:
                with self._slot_free:
                    self._reserved -= 1
                    self._slot_free.notify_all()
            raise
        ticket = PipelineTicket(self, lane, handle)
        with self._lock:
            if urgent:
                self._urgent_inflight += 1
            else:
                self._reserved -= 1
                self._window.append(ticket)
            self.submitted[lane] += 1
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
            return self._outcome(ticket)
        with self._resolve_lock:
            while not ticket.done:
                with self._slot_free:
                    head = self._window.popleft() if self._window else None
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
        except Exception as e:
            ticket.error = e
        ticket.done = True
        # a resolved ticket must not keep device buffers alive
        ticket.handle = None
        with self._lock:
            self.resolved[ticket.lane] += 1
        ticket._ev.set()

    @staticmethod
    def _outcome(ticket: PipelineTicket):
        if ticket.error is not None:
            raise ticket.error
        return ticket.value
