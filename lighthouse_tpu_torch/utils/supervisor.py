"""Supervisor — restart crashed background services with capped backoff.

The node runs a handful of long-lived background threads (gossip
heartbeat, remote monitoring, autotune warmup) whose death must not go
unnoticed: a silently dead heartbeat strands the mesh, a dead monitoring
loop blinds the operator. `TaskExecutor` (utils/task_executor.py) covers
the CRITICAL services — a dead slot timer shuts the node down — but these
auxiliary loops should be *restarted*, not escalate to process death.

`Supervisor.spawn(fn, service)` runs `fn` in one thread with a retry
loop: an exception is logged, counted in `service_restarts_total{service}`
and the function restarted after an exponential backoff with jitter
(base * 2^attempt, capped, +-jitter so a fleet of restarts does not
thundering-herd a shared dependency). After `max_restarts` consecutive
crashes the service is abandoned with a structured error — a hot-crash
loop must not spin the CPU forever. A clean return ends supervision
(one-shot services like warmup are supervised the same way).

Everything is injectable (sleep via the stop event, rng for jitter) so
tests run in milliseconds and deterministically.
"""

from __future__ import annotations

import random
import threading
import time

from .logging import get_logger
from .metrics import REGISTRY

SERVICE_RESTARTS = REGISTRY.counter_vec(
    "service_restarts_total",
    "supervised background services restarted after a crash, by service",
    ("service",),
)


class Supervisor:
    def __init__(
        self,
        name: str = "supervisor",
        max_restarts: int = 5,
        backoff_base: float = 0.5,
        backoff_cap: float = 30.0,
        jitter_frac: float = 0.25,
        rng: random.Random | None = None,
        clock=None,
    ):
        self.name = name
        self.max_restarts = max_restarts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.jitter_frac = jitter_frac
        self.stop_event = threading.Event()
        self.restarts: dict[str, int] = {}
        self.abandoned: list[str] = []
        self._rng = rng or random.Random()
        self._clock = clock or time.monotonic
        self._log = get_logger(name)
        self._threads: dict[str, threading.Thread] = {}

    def backoff(self, attempt: int) -> float:
        """Delay before restart #attempt (0-based): exponential, capped,
        jittered by +-jitter_frac."""
        base = min(self.backoff_cap, self.backoff_base * (2.0 ** attempt))
        return base * (1.0 + self.jitter_frac * (2.0 * self._rng.random() - 1.0))

    def spawn(self, fn, service: str, *args, **kwargs) -> threading.Thread:
        """Run fn(*args, **kwargs) under supervision in a daemon thread.
        The returned thread lives across restarts (it IS the retry loop)
        and ends on clean return, abandonment, or stop()."""

        def supervise():
            attempt = 0
            while not self.stop_event.is_set():
                started = self._clock()
                try:
                    fn(*args, **kwargs)
                    return  # clean exit ends supervision
                except Exception as e:  # noqa: BLE001 — supervision boundary
                    # the budget is for CONSECUTIVE crashes (a hot-crash
                    # loop), not lifetime ones: a service that ran healthy
                    # past the backoff cap before dying starts fresh —
                    # otherwise one transient crash a day abandons a
                    # long-lived loop after a week
                    if self._clock() - started > self.backoff_cap:
                        attempt = 0
                    if attempt >= self.max_restarts:
                        self.abandoned.append(service)
                        self._log.error(
                            "service abandoned after repeated crashes",
                            service=service, restarts=attempt,
                            error=f"{type(e).__name__}: {e}",
                        )
                        return
                    delay = self.backoff(attempt)
                    attempt += 1
                    self.restarts[service] = attempt
                    SERVICE_RESTARTS.labels(service).inc()
                    try:
                        # black-box record: a restarted background service
                        # is exactly the kind of event an incident dump
                        # should show next to breaker/SLO transitions
                        from ..observability.flight_recorder import RECORDER

                        RECORDER.note_supervisor_restart(
                            service, attempt, f"{type(e).__name__}: {e}"
                        )
                    except Exception:
                        pass
                    self._log.warn(
                        "service crashed; restarting",
                        service=service, attempt=attempt,
                        delay_secs=round(delay, 3),
                        error=f"{type(e).__name__}: {e}",
                    )
                    # interruptible backoff: stop() must not wait it out
                    if self.stop_event.wait(delay):
                        return

        t = threading.Thread(
            target=supervise, name=f"{self.name}/{service}", daemon=True
        )
        t.start()
        self._threads[service] = t
        return t

    def alive(self) -> dict[str, bool]:
        return {name: t.is_alive() for name, t in self._threads.items()}

    def stop(self, timeout: float = 2.0) -> None:
        """End supervision: no further restarts; running backoffs abort.
        Service loops watching their own stop events should have them set
        BEFORE calling this (the supervisor does not own service state)."""
        self.stop_event.set()
        for t in self._threads.values():
            t.join(timeout=timeout)
