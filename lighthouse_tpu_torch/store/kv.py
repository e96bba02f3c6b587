"""Key-value store abstraction + in-memory backend.

Parity surface: the KeyValueStore/ItemStore traits of
lighthouse/beacon_node/store/src/lib.rs, with column-prefixed keys and
batched atomic writes, and the MemoryStore test backend
(store/src/memory_store.rs). The production C++ log-structured backend
lives in store/native (ctypes binding, see store/native_kv.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum
from typing import Iterator


class Column(str, Enum):
    """DB columns (store/src/lib.rs DBColumn analog)."""

    block = "blk"
    state = "ste"
    state_summary = "ssm"
    blob = "blo"
    da_spill = "das"          # DA-checker overflow entries (pending joins)
    beacon_chain = "bch"      # chain-level singletons (head, fork choice…)
    op_pool = "opo"
    eth1 = "et1"
    pubkey_cache = "pkc"
    freezer_block_roots = "fbr"
    freezer_state_roots = "fsr"
    freezer_chunks = "fck"
    metadata = "met"


@dataclass
class KeyValueOp:
    """One op in an atomic batch."""

    kind: str          # "put" | "delete"
    column: Column
    key: bytes
    value: bytes | None = None

    @classmethod
    def put(cls, column: Column, key: bytes, value: bytes):
        return cls("put", column, key, value)

    @classmethod
    def delete(cls, column: Column, key: bytes):
        return cls("delete", column, key)


class KeyValueStore:
    """Interface; implementations must be thread-safe."""

    def get(self, column: Column, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, column: Column, key: bytes, value: bytes) -> None:
        self.do_atomically([KeyValueOp.put(column, key, value)])

    def delete(self, column: Column, key: bytes) -> None:
        self.do_atomically([KeyValueOp.delete(column, key)])

    def exists(self, column: Column, key: bytes) -> bool:
        return self.get(column, key) is not None

    def do_atomically(self, ops: list[KeyValueOp]) -> None:
        raise NotImplementedError

    def iter_column(self, column: Column) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def compact(self) -> None:
        pass

    def flush(self) -> None:
        """Push buffered writes to durable storage (fsync where the engine
        has a log to sync; no-op for memory backends)."""

    def close(self) -> None:
        pass


class MemoryStore(KeyValueStore):
    """Dict-backed store for tests (memory_store.rs analog)."""

    def __init__(self):
        self._data: dict[tuple[str, bytes], bytes] = {}
        self._lock = threading.Lock()

    def get(self, column: Column, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get((column.value, key))

    def do_atomically(self, ops: list[KeyValueOp]) -> None:
        with self._lock:
            for op in ops:
                if op.kind == "put":
                    self._data[(op.column.value, op.key)] = op.value
                else:
                    self._data.pop((op.column.value, op.key), None)

    def iter_column(self, column: Column):
        with self._lock:
            items = [
                (k[1], v) for k, v in self._data.items() if k[0] == column.value
            ]
        return iter(sorted(items))
