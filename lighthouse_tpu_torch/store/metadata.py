"""Store metadata: schema versions, split point, anchor info, migrations.

Parity surface: lighthouse/beacon_node/store/src/metadata.rs (schema
version + repeat-byte metadata keys + AnchorInfo/BlobInfo records) and the
schema-migration driver in lighthouse/beacon_node/beacon_chain/src/
schema_change.rs, rebuilt for the ctypes/C++ log-structured KV.

Every metadata record serializes to fixed-width little-endian bytes and
lives in the `metadata` column under a 32-byte repeat-byte key, matching
the reference's `Hash256::repeat_byte(n)` constants so a DB inspector can
recognise them.

Migrations are applied one version step at a time; each step's writes plus
the bumped schema-version record go through the KV store in ONE atomic
batch — a crash mid-migration leaves the DB wholly at version N or wholly
at N+1, never in between (tested by tests/test_store_metadata.py with an
injected-fault store).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .kv import Column, KeyValueOp, KeyValueStore

CURRENT_SCHEMA_VERSION = 2

# Repeat-byte metadata keys (metadata.rs:12-18).
SCHEMA_VERSION_KEY = bytes([0]) * 32
CONFIG_KEY = bytes([1]) * 32
SPLIT_KEY = bytes([2]) * 32
PRUNING_CHECKPOINT_KEY = bytes([3]) * 32
COMPACTION_TIMESTAMP_KEY = bytes([4]) * 32
ANCHOR_INFO_KEY = bytes([5]) * 32
BLOB_INFO_KEY = bytes([6]) * 32

# Sentinel: node is not retaining historic states (metadata.rs:21).
STATE_UPPER_LIMIT_NO_RETAIN = (1 << 64) - 1


def _u64(x: int) -> bytes:
    return int(x).to_bytes(8, "little")


def _read_u64(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 8], "little")


@dataclass
class Split:
    """Hot/cold split point (hot_cold_store.rs `Split`)."""

    slot: int = 0
    state_root: bytes = b"\x00" * 32

    def to_bytes(self) -> bytes:
        return _u64(self.slot) + self.state_root

    @classmethod
    def from_bytes(cls, b: bytes) -> "Split":
        return cls(_read_u64(b, 0), b[8:40])


@dataclass
class AnchorInfo:
    """Weak-subjectivity anchor bookkeeping (metadata.rs:88-110).

    anchor_slot: slot of the checkpoint state we started from.
    oldest_block_slot: backfill progress — blocks >= this slot are stored.
    oldest_block_parent: root the next backfilled block must match.
    state_upper_limit: historic states >= this slot are stored.
    state_lower_limit: historic states <= this slot are stored.
    """

    anchor_slot: int
    oldest_block_slot: int
    oldest_block_parent: bytes
    state_upper_limit: int
    state_lower_limit: int

    def block_backfill_complete(self, target_slot: int) -> bool:
        return self.oldest_block_slot <= target_slot

    def all_states_reconstructed(self) -> bool:
        return self.state_lower_limit + 1 >= self.state_upper_limit

    def to_bytes(self) -> bytes:
        return (
            _u64(self.anchor_slot)
            + _u64(self.oldest_block_slot)
            + self.oldest_block_parent
            + _u64(self.state_upper_limit)
            + _u64(self.state_lower_limit)
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "AnchorInfo":
        return cls(
            anchor_slot=_read_u64(b, 0),
            oldest_block_slot=_read_u64(b, 8),
            oldest_block_parent=b[16:48],
            state_upper_limit=_read_u64(b, 48),
            state_lower_limit=_read_u64(b, 56),
        )


@dataclass
class BlobInfo:
    """Blob-sidecar retention bookkeeping (metadata.rs BlobInfo)."""

    oldest_blob_slot: int = 0
    blobs_db: bool = True

    def to_bytes(self) -> bytes:
        return _u64(self.oldest_blob_slot) + bytes([1 if self.blobs_db else 0])

    @classmethod
    def from_bytes(cls, b: bytes) -> "BlobInfo":
        return cls(_read_u64(b, 0), b[8] == 1)


@dataclass
class PruningCheckpoint:
    epoch: int = 0
    root: bytes = b"\x00" * 32

    def to_bytes(self) -> bytes:
        return _u64(self.epoch) + self.root

    @classmethod
    def from_bytes(cls, b: bytes) -> "PruningCheckpoint":
        return cls(_read_u64(b, 0), b[8:40])


# --------------------------------------------------------------- accessors


def get_schema_version(hot: KeyValueStore) -> int | None:
    raw = hot.get(Column.metadata, SCHEMA_VERSION_KEY)
    return _read_u64(raw, 0) if raw is not None else None


def schema_version_op(version: int) -> KeyValueOp:
    return KeyValueOp.put(Column.metadata, SCHEMA_VERSION_KEY, _u64(version))


def put_schema_version(hot: KeyValueStore, version: int) -> None:
    hot.do_atomically([schema_version_op(version)])


def get_split(hot: KeyValueStore) -> Split | None:
    raw = hot.get(Column.metadata, SPLIT_KEY)
    return Split.from_bytes(raw) if raw is not None else None


def put_split(hot: KeyValueStore, split: Split) -> None:
    hot.put(Column.metadata, SPLIT_KEY, split.to_bytes())


def get_anchor_info(hot: KeyValueStore) -> AnchorInfo | None:
    raw = hot.get(Column.metadata, ANCHOR_INFO_KEY)
    return AnchorInfo.from_bytes(raw) if raw is not None else None


def put_anchor_info(hot: KeyValueStore, info: AnchorInfo | None) -> None:
    if info is None:
        hot.delete(Column.metadata, ANCHOR_INFO_KEY)
    else:
        hot.put(Column.metadata, ANCHOR_INFO_KEY, info.to_bytes())


def get_blob_info(hot: KeyValueStore) -> BlobInfo | None:
    raw = hot.get(Column.metadata, BLOB_INFO_KEY)
    return BlobInfo.from_bytes(raw) if raw is not None else None


def put_blob_info(hot: KeyValueStore, info: BlobInfo) -> None:
    hot.put(Column.metadata, BLOB_INFO_KEY, info.to_bytes())


def get_pruning_checkpoint(hot: KeyValueStore) -> PruningCheckpoint | None:
    raw = hot.get(Column.metadata, PRUNING_CHECKPOINT_KEY)
    return PruningCheckpoint.from_bytes(raw) if raw is not None else None


def put_pruning_checkpoint(hot: KeyValueStore, cp: PruningCheckpoint) -> None:
    hot.put(Column.metadata, PRUNING_CHECKPOINT_KEY, cp.to_bytes())


# --------------------------------------------------------------- migrations
#
# Each entry migrates FROM its key version TO key+1. The migration function
# returns a list of KeyValueOps for the hot store; the driver appends the
# schema-version bump and commits everything in one atomic batch (the
# upgrade path of schema_change.rs, without the multi-batch windows the
# reference tolerates because LevelDB recovers half-applied batches).

MigrationFn = Callable[[KeyValueStore], list[KeyValueOp]]
MIGRATIONS: dict[int, MigrationFn] = {}


def migration(from_version: int):
    def deco(fn: MigrationFn) -> MigrationFn:
        MIGRATIONS[from_version] = fn
        return fn

    return deco


@migration(1)
def _v1_to_v2(hot: KeyValueStore) -> list[KeyValueOp]:
    """v1 -> v2: introduce explicit metadata records.

    v1 stores (rounds 1-3) kept the split slot only in process memory and
    had no anchor/blob info. v2 materialises a Split record (slot 0 if the
    freezer is untouched — reopening an old DB re-runs finalization
    migration harmlessly) and a default BlobInfo.
    """
    ops: list[KeyValueOp] = []
    if hot.get(Column.metadata, SPLIT_KEY) is None:
        ops.append(KeyValueOp.put(Column.metadata, SPLIT_KEY, Split().to_bytes()))
    if hot.get(Column.metadata, BLOB_INFO_KEY) is None:
        ops.append(
            KeyValueOp.put(Column.metadata, BLOB_INFO_KEY, BlobInfo().to_bytes())
        )
    return ops


class MigrationError(Exception):
    pass


def _store_is_empty(hot: KeyValueStore) -> bool:
    """True if the store holds no data in any column — distinguishes a
    fresh DB (stamp current, no migration) from a legacy pre-versioning DB
    (must walk the migration chain from v1)."""
    for col in Column:
        for _ in hot.iter_column(col):
            return False
    return True


def migrate_schema(
    hot: KeyValueStore, to_version: int = CURRENT_SCHEMA_VERSION
) -> list[int]:
    """Walk the DB from its current version to `to_version` one step at a
    time. Returns the list of versions applied (empty if already current).

    Fresh DBs (no version record) are stamped directly at `to_version` —
    there is nothing to migrate. Downgrades are refused (database_manager
    refuses them too unless a specific reverse migration exists; we define
    none)."""
    current = get_schema_version(hot)
    if current is None:
        if _store_is_empty(hot):
            # fresh DB: nothing to migrate, stamp current
            put_schema_version(hot, to_version)
            return []
        # legacy DB predating the version record (rounds 1-3): treat as v1
        current = 1
        put_schema_version(hot, current)
    if current == to_version:
        return []
    if current > to_version:
        raise MigrationError(
            f"schema downgrade {current} -> {to_version} is not supported"
        )
    applied = []
    while current < to_version:
        fn = MIGRATIONS.get(current)
        if fn is None:
            raise MigrationError(f"no migration from schema version {current}")
        ops = fn(hot)
        ops.append(schema_version_op(current + 1))
        hot.do_atomically(ops)  # crash before here leaves version = current
        current += 1
        applied.append(current)
    return applied
