"""Fault injection: device stall, slow host verify, scheduled triggers.

`StallingBackend` stands in for the device leg of the hybrid router: it
verifies instantly (fake-crypto semantics — loadgen measures the QoS
machinery, not pairings) until `stall()` is called, after which every
verify blocks for a bounded `wait_secs` and then raises `DeviceStallError`
— the shape of a wedged device (a hung card) as seen by a caller with a
timeout. Async handles block in `result()` the same way, so the processor's
in-flight resolution path is exercised too. `release()` restores instant
service.

`FaultInjector` is the slot-driven trigger board: the runner registers
actions at scenario slots and calls `on_slot` as the manual clock advances,
keeping every fault deterministic.
"""

from __future__ import annotations

import threading
import time


class DeviceStallError(RuntimeError):
    """A stalled device verify gave up after its bounded wait."""


class StallingBackend:
    """Scriptable device stand-in: instant verifies, stallable on demand."""

    name = "loadgen_stall"

    def __init__(self, verdict: bool = True, wait_secs: float = 0.02):
        self.verdict = verdict
        self.wait_secs = wait_secs
        self.calls = 0
        self.stall_hits = 0
        self._released = threading.Event()
        self._released.set()
        self._lock = threading.Lock()

    @property
    def stalled(self) -> bool:
        return not self._released.is_set()

    def stall(self) -> None:
        self._released.clear()

    def release(self) -> None:
        self._released.set()

    def _serve(self) -> bool:
        with self._lock:
            self.calls += 1
        if not self._released.wait(self.wait_secs):
            with self._lock:
                self.stall_hits += 1
            raise DeviceStallError(
                f"device stalled past {self.wait_secs}s wait"
            )
        return self.verdict

    def verify_signature_sets(self, sets, rands) -> bool:
        return self._serve()

    def verify_signature_sets_async(self, sets, rands):
        outer = self

        class _Handle:
            def result(self) -> bool:
                return outer._serve()

        return _Handle()


class SlowHostVerify:
    """Host-path fault: a fixed per-batch delay (GIL-released sleep), the
    shape of a host CPU saturated by competing verification work."""

    def __init__(self, delay_secs: float = 0.005):
        self.delay_secs = delay_secs
        self.calls = 0

    def __call__(self, n_sets: int) -> bool:
        self.calls += 1
        time.sleep(self.delay_secs)
        return True


class FaultInjector:
    """Deterministic slot-triggered actions. Register with `at(slot, fn)`;
    the runner calls `on_slot(slot)` once per simulated slot and every
    not-yet-fired action scheduled at or before it runs, in slot order."""

    def __init__(self):
        # per-entry fired flag (NOT index-keyed: registering a new action
        # after some have fired must not remap what already ran)
        self._actions: list[list] = []   # [slot, fn, fired]

    def at(self, slot: int, fn) -> "FaultInjector":
        self._actions.append([int(slot), fn, False])
        self._actions.sort(key=lambda x: x[0])
        return self

    def on_slot(self, slot: int) -> int:
        fired = 0
        for entry in self._actions:
            at_slot, fn, done = entry
            if done or at_slot > slot:
                continue
            entry[2] = True
            fn()
            fired += 1
        return fired
