"""Blob sidecar verification + data-availability checking (deneb+).

Parity surface:
  - gossip blob-sidecar verification — index bounds, slot/finalization
    windows, parent checks, header proposer signature, KZG commitment
    inclusion proof, KZG blob proof, (block_root, index) dedup
    (lighthouse/beacon_node/beacon_chain/src/blob_verification.rs).
  - availability checking — joining blocks and their blob sidecars before
    import, holding whichever side arrives first; import is gated on all
    commitments having a verified matching sidecar
    (lighthouse/beacon_node/beacon_chain/src/data_availability_checker.rs:40).
    The pending store is a bounded in-memory LRU that SPILLS evicted
    entries to the store's da_spill column and transparently faults them back
    on access (overflow_lru_cache.rs OverflowLRUCache semantics): under
    blob spam the in-memory footprint stays capped while no verified
    component is lost.

KZG proofs of all sidecars of a block verify as ONE batch through the shared
pairing kernel (crypto/kzg.verify_blob_kzg_proof_batch — the same device
path as BLS, the north-star workload sharing noted in SURVEY.md §2.4).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from ..crypto import kzg as ckzg
from ..ssz.proof import branch_for, build_tree, verify_branch
from ..types.containers import KZGCommitment
from ..types import helpers as h

class BlobError(Exception):
    """Blob sidecar rejected (blob_verification.rs GossipBlobError analog)."""


class BlobIgnoreError(Exception):
    """Blob sidecar gossip IGNORE: do not propagate, do not penalize the
    sender (blob_verification.rs maps these to GossipBlobError variants
    handled as ignore, not reject).

    `retriable=True` means verification could not run YET (parent/state
    unavailable, future slot): a retransmission should be re-validated once
    the dependency arrives. `retriable=False` is terminal (duplicate,
    pre-finalization): the dedup cache must keep suppressing replays or a
    peer could farm free validation work by replaying old sidecars.
    `missing_parent` is set when the blocking dependency is specifically an
    unimported parent block — the condition a local reprocess queue can key
    a retry on. `retry_at_slot` is set when the dependency is TIME (a
    future-slot sidecar): terminal for gossip dedup, but the owner should
    queue it locally and re-validate once that slot starts."""

    def __init__(self, msg: str, retriable: bool = True,
                 missing_parent: bytes | None = None,
                 retry_at_slot: int | None = None):
        super().__init__(msg)
        self.retriable = retriable
        self.missing_parent = missing_parent
        self.retry_at_slot = retry_at_slot


class AvailabilityPendingError(Exception):
    """Block cannot import yet: blobs missing (held in the DA checker)."""

    def __init__(self, block_root: bytes, missing: list[int]):
        super().__init__(f"awaiting blobs {missing} for {block_root.hex()[:8]}")
        self.block_root = block_root
        self.missing = missing


# --------------------------------------------------- inclusion proofs


def _commitments_field_index(types) -> int:
    for i, f in enumerate(types.BeaconBlockBody.fields):
        if f.name == "blob_kzg_commitments":
            return i
    raise ValueError("body has no blob_kzg_commitments")


def _list_depth(limit: int) -> int:
    d = 0
    while (1 << d) < limit:
        d += 1
    return d


def commitment_inclusion_proof(types, spec, body, index: int) -> list[bytes]:
    """Branch proving body.blob_kzg_commitments[index] under the body root
    (bottom-up: list data tree, length mix-in, body container levels)."""
    commitments = list(body.blob_kzg_commitments)
    limit = spec.preset.MAX_BLOB_COMMITMENTS_PER_BLOCK
    roots = [KZGCommitment.hash_tree_root(c) for c in commitments]
    layers = build_tree(roots, limit)
    branch = branch_for(layers, index)
    branch.append(len(commitments).to_bytes(32, "little"))  # mix-in sibling

    chunks = [
        f.type.hash_tree_root(getattr(body, f.name)) for f in types.BeaconBlockBody.fields
    ]
    body_layers = build_tree(chunks, len(types.BeaconBlockBody.fields))
    branch += branch_for(body_layers, _commitments_field_index(types))
    return branch


def verify_commitment_inclusion(types, spec, sidecar) -> bool:
    """Verify sidecar.kzg_commitment_inclusion_proof against the header's
    body_root (blob_verification.rs verify_kzg_commitment_inclusion_proof)."""
    leaf = KZGCommitment.hash_tree_root(sidecar.kzg_commitment)
    list_depth = _list_depth(spec.preset.MAX_BLOB_COMMITMENTS_PER_BLOCK)
    # position bits bottom-up: leaf index | data-root-left (0) | field index
    pos = int(sidecar.index) | (_commitments_field_index(types) << (list_depth + 1))
    body_root = bytes(sidecar.signed_block_header.message.body_root)
    branch = [bytes(b) for b in sidecar.kzg_commitment_inclusion_proof]
    if len(branch) != list_depth + 1 + _list_depth(len(types.BeaconBlockBody.fields)):
        return False
    return verify_branch(leaf, branch, pos, body_root)


def build_sidecars(types, spec, signed_block, blobs, proofs):
    """Sidecars for a produced block: inclusion proofs over its own body
    (the production mirror of verification; beacon_chain.rs blob sidecar
    construction on publish)."""
    block = signed_block.message
    header = types.BeaconBlockHeader.make(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=block.state_root,
        body_root=types.BeaconBlockBody.hash_tree_root(block.body),
    )
    signed_header = types.SignedBeaconBlockHeader.make(
        message=header, signature=signed_block.signature
    )
    out = []
    for i, (blob, proof) in enumerate(zip(blobs, proofs)):
        out.append(
            types.BlobSidecar.make(
                index=i,
                blob=blob,
                kzg_commitment=block.body.blob_kzg_commitments[i],
                kzg_proof=proof,
                signed_block_header=signed_header,
                kzg_commitment_inclusion_proof=commitment_inclusion_proof(
                    types, spec, block.body, i
                ),
            )
        )
    return out


# --------------------------------------------------- availability checker


@dataclass
class _PendingComponents:
    block: object | None = None          # SignedBeaconBlock
    types: object | None = None
    blobs: dict = field(default_factory=dict)   # index -> sidecar (verified)


class DataAvailabilityChecker:
    """Joins blocks and blob sidecars before import.

    Bounded in-memory LRU; with a backing store, LRU evictions spill the
    serialized pending components to the da_spill column and accesses fault
    them back in (overflow_lru_cache.rs)."""

    def __init__(
        self,
        spec,
        setup: "ckzg.TrustedSetup | None" = None,
        capacity: int = 64,
        store=None,
    ):
        self.spec = spec
        self.setup = setup
        self._pending: OrderedDict[bytes, _PendingComponents] = OrderedDict()
        self.capacity = capacity
        self.store = store  # HotColdDB or None
        self.spilled = 0     # metric: total entries written to disk
        # root -> slot of the spilled entry (slot drives finalization pruning)
        self._on_disk: dict[bytes, int] = {}
        if store is not None:
            self._recover_spilled()

    def _recover_spilled(self) -> None:
        """Rebuild the disk index after a restart — otherwise spilled
        entries would be orphaned forever (unbounded disk growth under
        blob spam across restarts)."""
        from ..store.kv import Column

        for key, raw in self.store.blobs_db.iter_column(Column.da_spill):
            self._on_disk[key] = self._entry_slot_from_bytes(raw)

    @staticmethod
    def _entry_slot_from_bytes(raw: bytes) -> int:
        """Slot of a serialized entry without full deserialization: the
        block slot if present, else the first sidecar's header slot."""
        if raw[0] == 1:
            return int.from_bytes(raw[1:9], "little")
        # no block: u16 count then first sidecar slot
        return int.from_bytes(raw[3:11], "little")

    @staticmethod
    def _entry_slot(e: _PendingComponents) -> int:
        if e.block is not None:
            return int(e.block.message.slot)
        first = next(iter(e.blobs.values()))
        return int(first.signed_block_header.message.slot)

    def prune_finalized(self, finalized_slot: int) -> int:
        """Drop spilled entries at or below the finalized slot (the
        reference prunes its overflow cache at finalization —
        overflow_lru_cache.rs). Returns the number deleted."""
        if self.store is None:
            return 0
        from ..store.kv import Column

        victims = [r for r, s in self._on_disk.items() if s <= finalized_slot]
        for root in victims:
            self.store.blobs_db.delete(Column.da_spill, root)
            del self._on_disk[root]
        # in-memory entries too: a finalized-slot pending join can never
        # complete into a viable block
        mem_victims = [
            r for r, e in self._pending.items()
            if (e.block is not None or e.blobs)
            and self._entry_slot(e) <= finalized_slot
        ]
        for root in mem_victims:
            self._pending.pop(root, None)
        return len(victims) + len(mem_victims)

    # ------------------------------------------------------- spill plumbing

    def _serialize_entry(self, e: _PendingComponents) -> bytes | None:
        """has_block u8 | [slot u64 | len u32 | block] | n u16 |
        (slot u64 | len u32 | sidecar)* — slots resolve SSZ types back."""
        from ..state_transition.slot import types_for_slot

        out = bytearray()
        if e.block is not None:
            raw = e.types.SignedBeaconBlock.serialize(e.block)
            out += b"\x01" + int(e.block.message.slot).to_bytes(8, "little")
            out += len(raw).to_bytes(4, "little") + raw
        else:
            out += b"\x00"
        out += len(e.blobs).to_bytes(2, "little")
        for idx in sorted(e.blobs):
            sc = e.blobs[idx]
            slot = int(sc.signed_block_header.message.slot)
            types = types_for_slot(self.spec, slot)
            raw = types.BlobSidecar.serialize(sc)
            out += slot.to_bytes(8, "little")
            out += len(raw).to_bytes(4, "little") + raw
        return bytes(out)

    def _deserialize_entry(self, raw: bytes) -> _PendingComponents:
        from ..state_transition.slot import types_for_slot

        e = _PendingComponents()
        off = 1
        if raw[0] == 1:
            slot = int.from_bytes(raw[off : off + 8], "little")
            off += 8
            n = int.from_bytes(raw[off : off + 4], "little")
            off += 4
            e.types = types_for_slot(self.spec, slot)
            e.block = e.types.SignedBeaconBlock.deserialize(raw[off : off + n])
            off += n
        count = int.from_bytes(raw[off : off + 2], "little")
        off += 2
        for _ in range(count):
            slot = int.from_bytes(raw[off : off + 8], "little")
            off += 8
            n = int.from_bytes(raw[off : off + 4], "little")
            off += 4
            types = types_for_slot(self.spec, slot)
            sc = types.BlobSidecar.deserialize(raw[off : off + n])
            off += n
            e.blobs[int(sc.index)] = sc
        return e

    def _evict_one(self) -> None:
        root, e = self._pending.popitem(last=False)
        if self.store is None:
            return  # memory-only mode: oldest entry is dropped
        if e.block is None and not e.blobs:
            return  # nothing worth preserving
        from ..store.kv import Column

        raw = self._serialize_entry(e)
        self.store.blobs_db.put(Column.da_spill, root, raw)
        self._on_disk[root] = self._entry_slot(e)
        self.spilled += 1

    def _fault_in(self, block_root: bytes) -> _PendingComponents | None:
        """Load a spilled entry back into memory (removing the disk copy)."""
        if self.store is None or block_root not in self._on_disk:
            return None
        from ..store.kv import Column

        raw = self.store.blobs_db.get(Column.da_spill, block_root)
        if raw is None:
            self._on_disk.pop(block_root, None)
            return None
        self.store.blobs_db.delete(Column.da_spill, block_root)
        self._on_disk.pop(block_root, None)
        e = self._deserialize_entry(raw)
        self._pending[block_root] = e
        while len(self._pending) > self.capacity:
            self._evict_one()
        return e

    def _entry(self, block_root: bytes) -> _PendingComponents:
        e = self._pending.get(block_root)
        if e is None:
            e = self._fault_in(block_root)
        if e is None:
            e = _PendingComponents()
            self._pending[block_root] = e
            while len(self._pending) > self.capacity:
                self._evict_one()
        else:
            self._pending.move_to_end(block_root)
        return e

    def _lookup(self, block_root: bytes) -> _PendingComponents | None:
        """Read-only view: spilled entries are deserialized WITHOUT moving
        them back into memory (faulting in would evict + re-write another
        entry — needless disk churn for a pure query)."""
        e = self._pending.get(block_root)
        if e is not None or self.store is None or block_root not in self._on_disk:
            return e
        from ..store.kv import Column

        raw = self.store.blobs_db.get(Column.da_spill, block_root)
        if raw is None:
            self._on_disk.pop(block_root, None)
            return None
        return self._deserialize_entry(raw)

    # ------------------------------------------------------------ interface

    def put_block(self, block_root: bytes, signed_block, types):
        """Register a block awaiting blobs. Returns (block, sidecars) if now
        fully available, else None."""
        e = self._entry(block_root)
        e.block, e.types = signed_block, types
        return self._check(block_root)

    def put_blob(self, block_root: bytes, sidecar):
        """Register a gossip-verified sidecar. Returns (block, sidecars) if
        its block is now fully available, else None."""
        e = self._entry(block_root)
        e.blobs[int(sidecar.index)] = sidecar
        return self._check(block_root)

    def missing_indices(self, block_root: bytes) -> list[int]:
        e = self._lookup(block_root)
        if e is None or e.block is None:
            return []
        n = len(e.block.message.body.blob_kzg_commitments)
        return [i for i in range(n) if i not in e.blobs]

    def pending_count(self) -> int:
        """Entries tracked in memory + spilled to disk (observability)."""
        return len(self._pending) + len(self._on_disk)

    def _check(self, block_root: bytes):
        e = self._pending.get(block_root)
        if e is None or e.block is None:
            return None
        commitments = list(e.block.message.body.blob_kzg_commitments)
        sidecars = []
        for i, c in enumerate(commitments):
            sc = e.blobs.get(i)
            if sc is None or bytes(sc.kzg_commitment) != bytes(c):
                return None
            sidecars.append(sc)
        self._pending.pop(block_root)
        return e.block, sidecars

    def verify_kzg_proofs(self, sidecars) -> bool:
        """One batched pairing check for all sidecars (kzg batch verify)."""
        if not sidecars:
            return True
        if self.setup is None:
            raise BlobError("no KZG trusted setup loaded")
        return ckzg.verify_blob_kzg_proof_batch(
            [bytes(sc.blob) for sc in sidecars],
            [bytes(sc.kzg_commitment) for sc in sidecars],
            [bytes(sc.kzg_proof) for sc in sidecars],
            self.setup,
        )


# --------------------------------------------------- gossip verification


def verify_blob_sidecar_for_gossip(chain, sidecar, verify_kzg: bool = True) -> bytes:
    """Full gossip checks for one sidecar; returns the block root.

    Mirrors blob_verification.rs GossipVerifiedBlob::new order: index bound,
    slot window, (root, index) dedup, parent known + slot ordering, not
    pre-finalization, inclusion proof, proposer signature (batched through
    the BLS backend), KZG proof."""
    from ..state_transition import signature_sets as sigs
    from ..state_transition.block import SignatureBatch
    from ..state_transition.slot import types_for_slot

    spec = chain.spec
    header = sidecar.signed_block_header.message
    slot = header.slot
    fork = spec.fork_name_at_slot(slot)
    types = types_for_slot(spec, slot)
    block_root = types.BeaconBlockHeader.hash_tree_root(header)

    if int(sidecar.index) >= spec.max_blobs(fork):
        raise BlobError(f"blob index {sidecar.index} out of range")
    if slot > chain.current_slot:
        # terminal for gossip dedup (same-instant mesh duplicates must not
        # burn retry budget) — the owner queues it locally for the slot
        # start via retry_at_slot (ReprocessQueue early-block semantics)
        raise BlobIgnoreError("future slot", retriable=False, retry_at_slot=int(slot))
    key = (block_root, int(sidecar.index))
    if key in chain.observed_blob_sidecars:
        raise BlobIgnoreError("sidecar already seen", retriable=False)
    fin_epoch = chain.fork_choice.store.finalized_checkpoint[0]
    if slot <= h.compute_start_slot_at_epoch(fin_epoch, spec):
        raise BlobIgnoreError("sidecar older than finalization", retriable=False)
    parent_root = bytes(header.parent_root)
    if not chain.store.block_exists(parent_root):
        raise BlobIgnoreError("parent unknown", missing_parent=parent_root)
    parent_slot = chain.block_slots.get(parent_root)
    if parent_slot is not None and parent_slot >= slot:
        raise BlobError("not later than parent")

    if not verify_commitment_inclusion(types, spec, sidecar):
        raise BlobError("bad commitment inclusion proof")

    # proposer signature over the header (same domain as block proposals).
    # State unavailability means verification CANNOT RUN — that must surface
    # as ignore, not accept (the sig/KZG checks below never happened).
    from .beacon_chain import BlockError

    try:
        state = chain._state_for_block(parent_root, slot)
    except BlockError as e:
        raise BlobIgnoreError(f"state unavailable: {e}") from e
    if int(header.proposer_index) >= len(state.validators):
        raise BlobError("proposer index out of range")
    batch = SignatureBatch()
    try:
        batch.add(
            sigs.block_header_set(
                state, spec, types, sidecar.signed_block_header,
                chain.pubkey_cache.pubkey_getter(),
            )
        )
    except sigs.SignatureSetError as e:
        raise BlobError(f"undecodable header signature: {e}") from e
    if not batch.verify():
        raise BlobError("invalid header proposer signature")

    if verify_kzg:
        if not chain.data_availability.verify_kzg_proofs([sidecar]):
            raise BlobError("KZG proof invalid")

    chain.observed_blob_sidecars.add(key)
    return block_root
