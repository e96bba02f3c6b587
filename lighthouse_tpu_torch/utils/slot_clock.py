"""Slot clocks: wall-clock and manual (logical time for tests).

Parity surface: lighthouse/common/slot_clock/src/lib.rs:17 (SlotClock
trait; SystemTimeSlotClock + ManualSlotClock — manual time is what keeps the
reference's whole test suite deterministic, SURVEY.md §4)."""

from __future__ import annotations

import time


class SlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> int | None:
        """Current slot, or None before genesis."""
        t = self._time()
        if t < self.genesis_time:
            return None
        return int(t - self.genesis_time) // self.seconds_per_slot

    def _time(self) -> float:
        raise NotImplementedError

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        return (self._time() - self.genesis_time) % self.seconds_per_slot

    def duration_to_next_slot(self) -> float:
        now = self._time()
        if now < self.genesis_time:
            return self.genesis_time - now
        return self.seconds_per_slot - ((now - self.genesis_time) % self.seconds_per_slot)


class SystemTimeSlotClock(SlotClock):
    def _time(self) -> float:
        return time.time()


class ManualSlotClock(SlotClock):
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        super().__init__(genesis_time, seconds_per_slot)
        self._now = float(genesis_time)

    def _time(self) -> float:
        return self._now

    def set_slot(self, slot: int) -> None:
        self._now = self.genesis_time + slot * self.seconds_per_slot

    def advance_slot(self) -> None:
        cur = self.now()
        self.set_slot((cur if cur is not None else -1) + 1)

    def set_time(self, t: float) -> None:
        self._now = t
