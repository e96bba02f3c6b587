"""Circuit breaker: closed / open / half-open with probe-driven recovery.

Formalizes what `HybridBackend` previously did ad hoc (count three device
errors, mark the device down, re-arm a probe thread): a breaker trips OPEN
after `failure_threshold` consecutive failures — where a failure is either
a raised dispatch or a verify slower than the caller's budget window — and
every request while open is refused in O(1), no per-call timeout spent.
After `reset_timeout` seconds the next `allow()` transitions to HALF_OPEN
and admits exactly one probe request; its recorded outcome either closes
the circuit or re-opens it for another cooldown.

The state is exported through a caller-supplied gauge (the hybrid router
wires `bls_device_circuit_state`: 0=closed, 1=open, 2=half_open) and every
transition lands in `qos_circuit_transitions_total{breaker,to}`, so the
closed→open→half_open→closed cycle is scrape-observable. Every transition
is also handed to the flight recorder (observability/flight_recorder.py)
AFTER the breaker lock is released — a transition to OPEN is an incident
trigger that may write a dump, and that IO must never block concurrent
`allow()` callers. The time source is injectable for deterministic tests.

The port's copy of lighthouse_tpu/qos/breaker.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

STATE_VALUES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

TRANSITIONS = REGISTRY.counter_vec(
    "qos_circuit_transitions_total",
    "circuit breaker state transitions, by breaker name and target state",
    ("breaker", "to"),
)

# the unified per-tenant state family: the plain per-breaker gauges
# (bls_device_circuit_state, tree_hash_circuit_state) predate the device
# ledger's workload naming and stay exported as DEPRECATED aliases so
# existing dashboards keep working; new consumers read this one
CIRCUIT_STATE = REGISTRY.gauge_vec(
    "circuit_state",
    "circuit state per tenant workload (0=closed, 1=open, 2=half_open); "
    "supersedes the per-breaker *_circuit_state gauges, which remain as "
    "deprecated aliases",
    ("workload",),
)


class CircuitBreaker:
    def __init__(self, name: str, *, failure_threshold: int = 3,
                 reset_timeout: float = 10.0, time_fn=time.monotonic,
                 state_gauge=None, workload=None):
        self.name = name
        # tenant identity in the unified circuit_state{workload} family;
        # breakers constructed without one only export their legacy gauge
        self.workload = None if workload is None else str(workload)
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._time = time_fn
        self._gauge = state_gauge
        self._log = get_logger(f"qos.breaker.{name}")
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        # inspection/test surface; bounded — a breaker flapping for the
        # life of a degraded node must not grow memory (the durable count
        # lives in qos_circuit_transitions_total)
        self.transitions: deque = deque([CLOSED], maxlen=64)
        # transitions awaiting flight-recorder notification (lock released);
        # _notify_lock serializes delivery so racing flushers cannot
        # reorder transitions (stale breaker_states would pin health at 206)
        self._pending_notify: list = []
        self._notify_lock = threading.Lock()
        if self._gauge is not None:
            self._gauge.set(STATE_VALUES[CLOSED])
        if self.workload is not None:
            CIRCUIT_STATE.labels(self.workload).set(STATE_VALUES[CLOSED])

    # ------------------------------------------------------------ internals

    def _transition_locked(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        self.transitions.append(to)
        TRANSITIONS.labels(self.name, to).inc()
        if self._gauge is not None:
            self._gauge.set(STATE_VALUES[to])
        if self.workload is not None:
            CIRCUIT_STATE.labels(self.workload).set(STATE_VALUES[to])
        self._log.info("circuit transition", to=to,
                       failures=self._failures)
        # flight-recorder notification is DEFERRED: a transition to OPEN
        # triggers an incident dump, and that must run after the caller
        # releases self._lock (see module docstring)
        self._pending_notify.append((to, self._failures))

    def _flush_notify(self) -> None:
        """Hand collected transitions to the flight recorder; call with
        self._lock RELEASED. Items are popped under self._lock (two racing
        flushers must not IndexError on the shared list) and delivered
        under _notify_lock (oldest-first, never reordered). Lock order is
        strictly _notify_lock -> _lock; no path holds _lock while taking
        _notify_lock. The unguarded empty check keeps the common case —
        allow()/record_success() with nothing pending — from ever waiting
        behind a flusher that is busy writing an incident dump (a missed
        item here is delivered by the flusher that queued it)."""
        if not self._pending_notify:
            return
        with self._notify_lock:
            while True:
                with self._lock:
                    if not self._pending_notify:
                        return
                    to, failures = self._pending_notify.pop(0)
                try:
                    from ..observability.flight_recorder import RECORDER

                    RECORDER.note_breaker(self.name, to, failures=failures)
                except Exception:  # the black box must never break the breaker
                    pass

    # ------------------------------------------------------------- surface

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request use the protected path right now? In OPEN past the
        cooldown this transitions to HALF_OPEN and admits exactly one probe
        (further allow() calls refuse until the probe's outcome lands)."""
        try:
            with self._lock:
                if self._state == CLOSED:
                    return True
                if self._state == OPEN:
                    if self._time() - self._opened_at < self.reset_timeout:
                        return False
                    self._transition_locked(HALF_OPEN)
                    self._probe_inflight = True
                    return True
                # HALF_OPEN: one probe at a time
                if self._probe_inflight:
                    return False
                self._probe_inflight = True
                return True
        finally:
            self._flush_notify()

    def record_success(self) -> None:
        try:
            with self._lock:
                if self._state == OPEN:
                    # a straggler dispatched BEFORE the trip completed while
                    # open: it is not evidence of recovery (the pipelined
                    # flap: stall -> 3 failures -> open -> pre-trip handle
                    # lands fine -> circuit must stay open until the cooldown
                    # + half-open probe, or the refusal guarantee never holds)
                    return
                self._failures = 0
                self._probe_inflight = False
                if self._state != CLOSED:
                    self._transition_locked(CLOSED)
        finally:
            self._flush_notify()

    def record_failure(self) -> None:
        try:
            with self._lock:
                self._probe_inflight = False
                if self._state == HALF_OPEN:
                    # failed probe: straight back to open, fresh cooldown
                    self._opened_at = self._time()
                    self._transition_locked(OPEN)
                    return
                self._failures += 1
                if self._state == CLOSED and self._failures >= self.failure_threshold:
                    self._opened_at = self._time()
                    self._transition_locked(OPEN)
        finally:
            self._flush_notify()
