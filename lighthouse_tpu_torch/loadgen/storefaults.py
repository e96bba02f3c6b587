"""Storage fault injection: torn writes, CRC corruption, ENOSPC, crashes.

`FaultyKVStore` is the pure-Python KV engine (`store/native_kv.py`
PurePythonKVStore — same CRC-framed on-disk format as the native C++
store) with a scriptable `FaultPlan` spliced into its record-write path.
It implements the full `KeyValueStore` interface, so it drops in anywhere
a real store does: under a `HotColdDB` in tests, or as the datadir store
of a loadgen node (the `crash_restart` scenario).

Faults are keyed on the store's 1-based record-write counter, so a
scenario can say "the 5th durable write tears after 11 bytes" and get the
same crash point on every run:

  - torn write  — only the first `tear_keep_bytes` bytes of the framed
    record reach the file (byte granularity, header included), then the
    process "dies" (`SimulatedCrash`). This is the power-loss-mid-write
    shape the CRC framing exists to survive.
  - crc flip    — the record lands whole but its CRC is wrong (bit rot /
    controller corruption); replay must stop at it.
  - enospc      — the write raises ENOSPC, the disk-full shape.
  - crash point — the process dies cleanly BEFORE the record lands.
  - slow io     — every record write sleeps (saturated disk shape).

After a `SimulatedCrash` the store is dead: further mutations raise
`StoreCrashed` (reads keep working so a test can inspect the corpse). A
"restart" is simply reopening the path with a fresh store — replay + tail
truncation then recover the crash-consistent prefix, which is exactly the
claim the fault matrix tests verify.

Module helpers (`flip_bit`, `last_record_span`) mutate/inspect log files
directly for tests that corrupt a CLOSED database (`bn doctor` coverage,
the cross-engine torn-tail parity matrix).
"""

from __future__ import annotations

import errno
import os
import struct
import time
import zlib
from dataclasses import dataclass

from ..store.native_kv import LogWalk, PurePythonKVStore


class SimulatedCrash(RuntimeError):
    """The injected crash point fired: the process 'died' mid-IO."""


class StoreCrashed(RuntimeError):
    """Mutation attempted on a store that already hit its crash point."""


@dataclass
class FaultPlan:
    """When and how the store misbehaves. Write indices are 1-based counts
    of record writes (do_atomically/put/delete each write one record;
    compaction writes one per live key)."""

    tear_at: int | None = None       # torn write, then SimulatedCrash
    tear_keep_bytes: int = 0         # framed-record bytes that land
    crash_at: int | None = None      # clean crash BEFORE the record lands
    flip_crc_at: int | None = None   # record lands with a corrupted CRC
    enospc_at: int | None = None     # write raises ENOSPC from here on
    slow_secs: float = 0.0           # per-record-write sleep


class FaultyKVStore(PurePythonKVStore):
    """PurePythonKVStore with a fault plan in the record-write path."""

    def __init__(self, path, plan: FaultPlan | None = None,
                 fsync: str | None = "always"):
        self.plan = plan or FaultPlan()
        self.writes = 0
        self.crashed = False
        super().__init__(path, fsync=fsync)

    def do_atomically(self, ops) -> None:
        if self.crashed:
            raise StoreCrashed("store hit its crash point; reopen the path")
        super().do_atomically(ops)

    def compact(self) -> None:
        if self.crashed:
            raise StoreCrashed("store hit its crash point; reopen the path")
        super().compact()

    def _write_record(self, fh, payload: bytes) -> None:
        self.writes += 1
        p = self.plan
        if p.slow_secs:
            time.sleep(p.slow_secs)
        if p.crash_at is not None and self.writes >= p.crash_at:
            self.crashed = True
            raise SimulatedCrash(
                f"crash point at write {self.writes}: record never written"
            )
        if p.enospc_at is not None and self.writes >= p.enospc_at:
            raise OSError(errno.ENOSPC, "injected: no space left on device")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        if p.flip_crc_at is not None and self.writes == p.flip_crc_at:
            crc ^= 1
        record = struct.pack("<II", crc, len(payload)) + payload
        if p.tear_at is not None and self.writes >= p.tear_at:
            keep = max(0, min(int(p.tear_keep_bytes), len(record)))
            fh.write(record[:keep])
            fh.flush()
            try:
                os.fsync(fh.fileno())  # the torn bytes DID reach the platter
            except OSError:
                pass
            self.crashed = True
            raise SimulatedCrash(
                f"torn write at write {self.writes}: "
                f"{keep}/{len(record)} bytes landed"
            )
        fh.write(record)
        fh.flush()


# ------------------------------------------------------- file-level helpers


def flip_bit(path, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit of an existing log file (closed-database corruption)."""
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)
        if not b:
            raise ValueError(f"offset {byte_offset} past EOF")
        f.seek(byte_offset)
        f.write(bytes([b[0] ^ (1 << bit)]))


def last_record_span(path) -> tuple[int, int]:
    """(start, end) byte offsets of the FINAL valid record in a log — the
    torn-write parity matrix truncates at every offset inside this span.
    Raises ValueError on an empty or fully-corrupt log."""
    start = end = None
    with open(path, "rb") as f:
        for start, end, _payload in LogWalk(f):
            pass
    if start is None:
        raise ValueError(f"{path}: no valid records")
    return start, end
