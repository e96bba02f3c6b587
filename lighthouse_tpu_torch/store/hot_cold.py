"""HotColdDB — split hot/freezer storage for blocks, states and blobs.

Parity surface: lighthouse/beacon_node/store/src/hot_cold_store.rs:50 —
hot DB holds recent blocks + per-slot state summaries with full states at
epoch boundaries; the freezer holds finalized block/state roots as chunked
vectors plus periodic full "restore point" states; blobs live in their own
column. `migrate_to_freezer` moves finalized data across the split like the
background migrator (store/src/hot_cold_store.rs migration +
beacon_chain/src/migrate.rs). Schema versioning + metadata records live in
store/metadata.py (store/src/metadata.rs analog); historic-state
reconstruction (store/src/reconstruct.rs) replays blocks from restore
points via the BlockReplayer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from ..types.spec import ChainSpec
from ..types.containers import spec_types
from . import metadata as md
from .kv import Column, KeyValueOp, KeyValueStore, MemoryStore

CHUNK_SIZE = 128  # roots per freezer chunk (chunked_vector.rs analog)


class MissingBlockError(Exception):
    """The freezer references a block the block column no longer stores."""


class ReconstructionMismatchError(Exception):
    """A reconstructed state's root disagrees with the freezer's record."""


@dataclass
class StoreConfig:
    slots_per_restore_point: int = 2048
    compact_on_migration: bool = True


class HotColdDB:
    def __init__(
        self,
        spec: ChainSpec,
        hot: KeyValueStore | None = None,
        cold: KeyValueStore | None = None,
        blobs: KeyValueStore | None = None,
        config: StoreConfig | None = None,
    ):
        self.spec = spec
        # `is not None`, NOT truthiness: stores define __len__, so a FRESH
        # (empty) NativeKVStore is falsy and `hot or MemoryStore()` would
        # silently swap the durable store for an in-memory one on first
        # boot — every "persisted" write would vanish on restart.
        self.hot = hot if hot is not None else MemoryStore()
        self.cold = cold if cold is not None else MemoryStore()
        self.blobs_db = blobs if blobs is not None else self.hot
        self.config = config or StoreConfig()
        # schema migration on open (fresh DBs are stamped current)
        self.schema_migrations_applied = md.migrate_schema(self.hot)
        split = md.get_split(self.hot)
        # boundary: slots < split are in the freezer (persisted across opens)
        self.split_slot = split.slot if split is not None else 0

    # ----------------------------------------------------------- lifecycle

    def flush(self) -> None:
        """Durability barrier across all underlying stores (persist points
        and graceful shutdown call this after their last write)."""
        self.hot.flush()
        self.cold.flush()
        if self.blobs_db is not self.hot:
            self.blobs_db.flush()

    def close(self) -> None:
        self.flush()
        self.hot.close()
        self.cold.close()
        if self.blobs_db is not self.hot:
            self.blobs_db.close()

    # ----------------------------------------------------------- metadata

    def get_anchor_info(self) -> md.AnchorInfo | None:
        return md.get_anchor_info(self.hot)

    def put_anchor_info(self, info: md.AnchorInfo | None) -> None:
        md.put_anchor_info(self.hot, info)

    def get_blob_info(self) -> md.BlobInfo | None:
        return md.get_blob_info(self.hot)

    def put_blob_info(self, info: md.BlobInfo) -> None:
        md.put_blob_info(self.hot, info)

    def schema_version(self) -> int | None:
        return md.get_schema_version(self.hot)

    # ------------------------------------------------------------- blocks

    def put_block(self, block_root: bytes, signed_block, types) -> None:
        self.hot.put(Column.block, block_root, types.SignedBeaconBlock.serialize(signed_block))

    def get_block(self, block_root: bytes, types):
        data = self.hot.get(Column.block, block_root)
        if data is None:
            return None
        return types.SignedBeaconBlock.deserialize(data)

    def block_exists(self, block_root: bytes) -> bool:
        return self.hot.exists(Column.block, block_root)

    def delete_block(self, block_root: bytes) -> None:
        self.hot.delete(Column.block, block_root)

    # ------------------------------------------------------------- states

    def put_state(self, state_root: bytes, state, types) -> None:
        self.hot.put(Column.state, state_root, types.BeaconState.serialize(state))
        self.hot.put(
            Column.state_summary,
            state_root,
            int(state.slot).to_bytes(8, "little"),
        )

    def get_state(self, state_root: bytes, types):
        data = self.hot.get(Column.state, state_root)
        if data is None:
            return None
        return types.BeaconState.deserialize(data)

    def state_exists(self, state_root: bytes) -> bool:
        return self.hot.exists(Column.state, state_root)

    # ------------------------------------------------------------- blobs

    def put_blobs(self, block_root: bytes, blobs_bytes: bytes) -> None:
        self.blobs_db.put(Column.blob, block_root, blobs_bytes)

    def get_blobs(self, block_root: bytes) -> bytes | None:
        return self.blobs_db.get(Column.blob, block_root)

    # ------------------------------------------------------------- chain data

    def put_chain_item(self, key: bytes, value: bytes) -> None:
        self.hot.put(Column.beacon_chain, key, value)

    def get_chain_item(self, key: bytes) -> bytes | None:
        return self.hot.get(Column.beacon_chain, key)

    # ------------------------------------------------------------- freezer

    @staticmethod
    def _chunk_key(kind_index: int) -> bytes:
        return kind_index.to_bytes(8, "little")

    def _append_root(self, column: Column, slot: int, root: bytes) -> None:
        chunk_idx = slot // CHUNK_SIZE
        key = self._chunk_key(chunk_idx)
        chunk = bytearray(self.cold.get(column, key) or b"")
        offset = (slot % CHUNK_SIZE) * 32
        if len(chunk) < offset + 32:
            chunk.extend(b"\x00" * (offset + 32 - len(chunk)))
        chunk[offset : offset + 32] = root
        self.cold.put(column, key, bytes(chunk))

    def _get_root(self, column: Column, slot: int) -> bytes | None:
        chunk = self.cold.get(column, self._chunk_key(slot // CHUNK_SIZE))
        return self._chunk_root(chunk, slot)

    def freezer_block_root_at_slot(self, slot: int) -> bytes | None:
        return self._get_root(Column.freezer_block_roots, slot)

    def freezer_state_root_at_slot(self, slot: int) -> bytes | None:
        return self._get_root(Column.freezer_state_roots, slot)

    def migrate_to_freezer(self, finalized_slot: int, chain_iter, types) -> None:
        """Move blocks/states below `finalized_slot` into the freezer.

        chain_iter: iterable of (slot, block_root, state_root) ascending for
        the finalized chain segment being migrated."""
        for slot, block_root, state_root in chain_iter:
            if slot >= finalized_slot:
                continue
            self._append_root(Column.freezer_block_roots, slot, block_root)
            self._append_root(Column.freezer_state_roots, slot, state_root)
            # restore points keep the full state
            if slot % self.config.slots_per_restore_point == 0:
                data = self.hot.get(Column.state, state_root)
                if data is not None:
                    self.cold.put(Column.freezer_chunks, state_root, data)
            # drop hot state (blocks stay hot for by-root queries until pruned)
            self.hot.do_atomically(
                [
                    KeyValueOp.delete(Column.state, state_root),
                    KeyValueOp.delete(Column.state_summary, state_root),
                ]
            )
        self.split_slot = max(self.split_slot, finalized_slot)
        md.put_split(self.hot, md.Split(slot=self.split_slot))
        if self.config.compact_on_migration:
            self.hot.compact()

    def get_restore_point_state(self, state_root: bytes, types):
        data = self.cold.get(Column.freezer_chunks, state_root)
        if data is None:
            return None
        return types.BeaconState.deserialize(data)

    # ---------------------------------------------------------- iterators

    def _chunk_root(self, chunk: bytes | None, slot: int) -> bytes | None:
        if chunk is None:
            return None
        off = (slot % CHUNK_SIZE) * 32
        if len(chunk) < off + 32:
            return None
        root = chunk[off : off + 32]
        return root if root != b"\x00" * 32 else None

    def forwards_block_roots_iterator(
        self, start_slot: int, end_slot: int
    ) -> Iterator[tuple[int, bytes]]:
        """(slot, block_root) ascending over [start_slot, end_slot] from the
        freezer chunks (store/src/forwards_iter.rs analog). Skip slots carry
        the previous root forward, matching chunked-vector semantics. Each
        128-slot chunk is fetched from the cold store once."""
        last = None
        chunk, chunk_idx = None, None
        for slot in range(start_slot, end_slot + 1):
            idx = slot // CHUNK_SIZE
            if idx != chunk_idx:
                chunk = self.cold.get(Column.freezer_block_roots, self._chunk_key(idx))
                chunk_idx = idx
            root = self._chunk_root(chunk, slot)
            if root is None:
                root = last
            if root is not None:
                yield slot, root
            last = root

    def reverse_block_roots_iterator(
        self, start_slot: int, end_slot: int = 0
    ) -> Iterator[tuple[int, bytes]]:
        """(slot, block_root) descending from start_slot down to end_slot,
        one cold-store fetch per 128-slot chunk.

        Slots whose chunk entry is empty (skip slots at the start of a
        chunk before any block landed) are omitted."""
        chunk, chunk_idx = None, None
        for slot in range(start_slot, end_slot - 1, -1):
            idx = slot // CHUNK_SIZE
            if idx != chunk_idx:
                chunk = self.cold.get(Column.freezer_block_roots, self._chunk_key(idx))
                chunk_idx = idx
            root = self._chunk_root(chunk, slot)
            if root is not None:
                yield slot, root

    # ----------------------------------------- historic state reconstruction

    def _restore_point_slot_at_or_below(self, slot: int) -> int | None:
        """Largest restore-point slot <= slot with a stored full state."""
        sprp = self.config.slots_per_restore_point
        rp = (slot // sprp) * sprp
        while rp >= 0:
            root = self.freezer_state_root_at_slot(rp)
            if root is not None and self.cold.exists(Column.freezer_chunks, root):
                return rp
            rp -= sprp
        return None

    def load_cold_state_by_slot(self, slot: int):
        """Rebuild the finalized state at `slot`: nearest restore point at or
        below, then replay the intervening blocks (reconstruct.rs's per-state
        path). Returns None if no restore point covers the slot."""
        from ..state_transition.block_replayer import BlockReplayer
        from ..state_transition.slot import types_for_slot

        rp_slot = self._restore_point_slot_at_or_below(slot)
        if rp_slot is None:
            return None
        rp_root = self.freezer_state_root_at_slot(rp_slot)
        base = self.get_restore_point_state(rp_root, types_for_slot(self.spec, rp_slot))
        if base is None:
            return None
        if rp_slot == slot:
            return base
        blocks = self._replay_blocks(rp_slot, slot)
        replayer = BlockReplayer(spec=self.spec, state=base)
        return replayer.apply_blocks(blocks, target_slot=slot)

    def _replay_blocks(self, after_slot: int, to_slot: int) -> list:
        """Blocks with after_slot < block.slot <= to_slot from the hot block
        column, resolved through the freezer root chunks. A root the freezer
        references but the block column lacks is an integrity error — a
        silently skipped block would reconstruct a WRONG state."""
        from ..state_transition.slot import types_for_slot

        blocks = []
        prev_root = None
        for s, root in self.forwards_block_roots_iterator(after_slot + 1, to_slot):
            if root == prev_root:
                continue  # skip slot: same root repeated
            prev_root = root
            blk = self.get_block(root, types_for_slot(self.spec, s))
            if blk is None:
                raise MissingBlockError(
                    f"freezer references block {root.hex()} at slot {s} "
                    "but the block column does not have it"
                )
            if int(blk.message.slot) > after_slot:
                blocks.append(blk)
        return blocks

    def reconstruct_historic_states(self, batch_slots: int = 1024) -> bool:
        """Fill in pruned historic states after checkpoint sync + backfill
        (store/src/reconstruct.rs): starting from the state at
        anchor.state_lower_limit, replay forward writing a full restore-point
        state at every slots_per_restore_point boundary, advancing
        state_lower_limit as we go (resumable: progress is persisted after
        every batch). Returns True when reconstruction is complete.

        Requires block backfill to be complete (oldest_block_slot == 0)."""
        from ..state_transition.block_replayer import BlockReplayer
        from ..state_transition.slot import types_for_slot

        anchor = self.get_anchor_info()
        if anchor is None:
            return True  # history already complete
        if anchor.state_upper_limit == md.STATE_UPPER_LIMIT_NO_RETAIN:
            # node configured not to retain historic states: nothing to do
            # (the reference's reconstruction likewise refuses to run)
            return True
        if anchor.oldest_block_slot != 0:
            raise ValueError(
                f"historic blocks missing: backfill at slot {anchor.oldest_block_slot}"
            )
        sprp = self.config.slots_per_restore_point
        lower = anchor.state_lower_limit
        upper = anchor.state_upper_limit
        state = self.load_cold_state_by_slot(lower)
        if state is None:
            raise ValueError(f"no cold state at lower limit {lower}")

        while lower < upper:
            target = min(lower + batch_slots, upper, ((lower // sprp) + 1) * sprp)
            blocks = self._replay_blocks(lower, target)
            replayer = BlockReplayer(spec=self.spec, state=state)
            state = replayer.apply_blocks(blocks, target_slot=target)
            lower = target
            if lower % sprp == 0 and lower < upper:
                types = types_for_slot(self.spec, lower)
                root_now = types.BeaconState.hash_tree_root(state)
                sroot = self.freezer_state_root_at_slot(lower)
                if sroot is None:
                    sroot = root_now
                    self._append_root(Column.freezer_state_roots, lower, sroot)
                elif sroot != root_now:
                    # persisting a mismatched state would poison every
                    # future load built from this restore point
                    raise ReconstructionMismatchError(
                        f"reconstructed state at slot {lower} has root "
                        f"{root_now.hex()} but the freezer records {sroot.hex()}"
                    )
                self.cold.put(
                    Column.freezer_chunks, sroot, types.BeaconState.serialize(state)
                )
            anchor.state_lower_limit = lower
            self.put_anchor_info(anchor)
        # complete: drop the anchor (all states reconstructable)
        self.put_anchor_info(None)
        return True
