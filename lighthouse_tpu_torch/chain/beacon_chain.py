"""BeaconChain — chain orchestration: verification pipelines, import, head.

Parity surface (trimmed to the load-bearing paths of
lighthouse/beacon_node/beacon_chain/src/):
  - gossip block verification (block_verification.rs GossipVerifiedBlock
    :639 -> SignatureVerifiedBlock :648): slot/parent/dedup checks, cheap
    proposer-signature check, then full batch verification on import
  - process_block / import_block (beacon_chain.rs:3035,:3362): state
    transition with VERIFY_BULK (one device batch per block), store writes,
    fork-choice on_block, head recompute (canonical_head.rs:473)
  - attestation verification, single and batched
    (attestation_verification.rs + batch.rs): committee resolution via the
    shuffling cache, observed-dedup, batched BLS verify, fork-choice votes
  - caches: ValidatorPubkeyCache (device feed), ShufflingCache,
    BeaconProposerCache, observed_* gossip dedup sets
  - chain-segment processing with ONE signature batch for the whole
    segment (block_verification.rs:568 signature_verify_chain_segment)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import bls
from ..fork_choice.fork_choice import ForkChoice
from ..state_transition import accessors as acc
from ..state_transition import signature_sets as sigs
from ..state_transition.block import (
    BlockProcessingError,
    SignatureBatch,
    SignatureStrategy,
    per_block_processing,
)
from ..state_transition.slot import process_slots, types_for_slot
from ..store.hot_cold import HotColdDB
from ..types.state_util import clone_state
from ..types import helpers as h
from ..types.spec import ChainSpec, DOMAIN_BEACON_ATTESTER
from ..utils.slot_clock import SlotClock
from .pubkey_cache import ValidatorPubkeyCache

# Validator-monitor attribution failures survived in place (the block is
# already imported; monitoring must never fail it): previously bare
# `except Exception: continue` — now each skipped attestation is a
# counted, logged event (the node_gossip_errors_total treatment).
from ..utils.metrics import REGISTRY as _REGISTRY

_MONITOR_ERRORS = _REGISTRY.counter_vec(
    "beacon_chain_monitor_errors_total",
    "validator-monitor block-import attribution failures survived "
    "(the attestation is skipped, the import stands), by stage",
    ("stage",),
)


class BlockError(Exception):
    """Block rejected (block_verification.rs BlockError analog)."""


class AttestationError(Exception):
    """Attestation rejected (attestation_verification.rs Error analog)."""


@dataclass
class ChainConfig:
    reorg_threshold_percent: int = 20
    import_max_skip_slots: int | None = None
    # background-migrator cadence: advance the hot/cold split once
    # finalization has moved this many epochs past it (migrate.rs /
    # --epochs-per-migration); 0 disables live migration
    epochs_per_migration: int = 1
    # slasher retention horizon in epochs (--slasher-history-length)
    slasher_history_epochs: int = 4096


class ShufflingCache:
    """(epoch, decision_root) -> CommitteeCache (shuffling_cache.rs)."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._map: dict[tuple[int, bytes], object] = {}

    def get_or_build(self, state, spec, epoch: int, decision_root: bytes):
        key = (epoch, decision_root)
        got = self._map.get(key)
        if got is None:
            got = acc.build_committee_cache(state, spec, epoch)
            if len(self._map) >= self.capacity:
                self._map.pop(next(iter(self._map)))
            self._map[key] = got
        return got


class BeaconChain:
    def __init__(
        self,
        spec: ChainSpec,
        genesis_state,
        store: HotColdDB | None = None,
        slot_clock: SlotClock | None = None,
        config: ChainConfig | None = None,
        kzg_setup=None,
        anchor_block=None,
        execution_layer=None,
    ):
        """genesis_state doubles as the ANCHOR state: pass a finalized
        checkpoint state (+ its anchor_block) to start from a weak-
        subjectivity checkpoint instead of genesis
        (client/src/builder.rs:366-528 weak_subjectivity_state analog)."""
        from ..utils.slot_clock import ManualSlotClock

        self.spec = spec
        self.config = config or ChainConfig()
        self.store = store or HotColdDB(spec)
        self.slot_clock = slot_clock or ManualSlotClock(
            genesis_state.genesis_time, spec.seconds_per_slot
        )
        self.genesis_validators_root = bytes(genesis_state.genesis_validators_root)

        types = types_for_slot(spec, genesis_state.slot)
        state_root = types.BeaconState.hash_tree_root(genesis_state)
        if anchor_block is not None:
            # checkpoint start: the supplied block must commit to the state
            if bytes(anchor_block.message.state_root) != state_root:
                raise BlockError("anchor block/state mismatch")
            self.genesis_block_root = types.BeaconBlock.hash_tree_root(
                anchor_block.message
            )
            self.store.put_block(self.genesis_block_root, anchor_block, types)
        else:
            # The anchor block root must match what descendants reference:
            # hash of the state's latest_block_header with its state_root
            # filled (the header's body_root may predate fork upgrades, so
            # we must not rebuild the body ourselves).
            header = genesis_state.latest_block_header
            if bytes(header.state_root) == b"\x00" * 32:
                header = header.copy_with(state_root=state_root)
            self.genesis_block_root = types.BeaconBlockHeader.hash_tree_root(header)
            genesis_block = types.BeaconBlock.make(
                slot=genesis_state.slot,
                proposer_index=header.proposer_index,
                parent_root=header.parent_root,
                state_root=header.state_root,
                body=types.BeaconBlockBody.default(),
            )
            signed_genesis = types.SignedBeaconBlock.make(
                message=genesis_block, signature=b"\x00" * 96
            )
            self.store.put_block(self.genesis_block_root, signed_genesis, types)
        self.anchor_slot = int(genesis_state.slot)
        self.oldest_block_slot = self.anchor_slot  # backfill progress marker
        self._oldest_block_root = self.genesis_block_root
        self.store.put_state(state_root, genesis_state, types)

        self.fork_choice = ForkChoice(
            spec, self.genesis_block_root, genesis_state.slot, genesis_state
        )
        # head states kept in memory: bounded LRU with build promises
        from .caches import (
            AttesterCache,
            BlockTimesCache,
            EarlyAttesterCache,
            ObservedSlashable,
            StateLRU,
        )

        self.state_cache = StateLRU(capacity=32)
        self._advanced: dict = {}   # state-advance timer output (head -> next-slot state)
        self.state_cache[state_root] = genesis_state
        self.block_times = BlockTimesCache()
        self.attester_cache = AttesterCache()
        self.early_attester_cache = EarlyAttesterCache()
        self.observed_slashable = ObservedSlashable()
        self.slasher = None           # optional slasher feed (set by the node)
        self.block_slots: dict[bytes, int] = {self.genesis_block_root: genesis_state.slot}
        self.state_root_by_block: dict[bytes, bytes] = {
            self.genesis_block_root: state_root
        }
        self.head_root = self.genesis_block_root

        self.pubkey_cache = ValidatorPubkeyCache(self.store)
        self.pubkey_cache.import_new_pubkeys(genesis_state)
        self.shuffling_cache = ShufflingCache()
        self.proposer_cache: dict[tuple[int, bytes], list[int]] = {}

        from .validator_monitor import ValidatorMonitor

        # per-validator performance tracking (validator_monitor.rs): driven
        # from the import path + epoch rollover below; inert until a
        # validator is registered (CLI --monitor-validators / API)
        self.monitor = ValidatorMonitor(spec)
        self._monitor_epoch: int | None = None
        self._monitor_sync_indices: tuple[int, list[int]] | None = None

        # observed-* gossip dedup (observed_attesters.rs etc.)
        self.observed_block_producers: set[tuple[int, int]] = set()
        self.observed_attesters: set[tuple[int, int]] = set()          # (epoch, validator)
        self.observed_aggregators: set[tuple[int, int]] = set()
        self.observed_blocks: set[bytes] = set()
        self.observed_blob_sidecars: set[tuple[bytes, int]] = set()    # (root, index)

        from .data_availability import DataAvailabilityChecker
        from .naive_aggregation import NaiveAttestationPool, NaiveSyncContributionPool

        self.data_availability = DataAvailabilityChecker(
            spec, kzg_setup, store=self.store
        )
        self.naive_attestation_pool = NaiveAttestationPool(spec)
        self.naive_sync_pool = NaiveSyncContributionPool(spec)
        # validator_index -> fee recipient, fed by prepare_beacon_proposer
        self.proposer_preparations: dict[int, bytes] = {}
        # eth1 deposit/block cache feeding production (eth1_chain.rs); set
        # by the node when an eth1 endpoint is configured
        self.eth1_cache = None

        # ---- execution layer circuit (execution_payload.rs analog)
        self.execution_layer = execution_layer
        # block root -> execution block hash of its chain (inherited through
        # pre-merge/empty payloads) — feeds forkchoiceUpdated + getPayload
        genesis_payload_hash = b"\x00" * 32
        hdr = getattr(genesis_state, "latest_execution_payload_header", None)
        if hdr is not None:
            genesis_payload_hash = bytes(hdr.block_hash)
        self.payload_hash_by_block: dict[bytes, bytes] = {
            self.genesis_block_root: genesis_payload_hash
        }
        self._el_last_head_sent: bytes | None = None
        # blobs bundles from locally-built payloads, keyed by their
        # commitment list: served back when the signed block is published
        self._produced_bundles: dict[tuple, tuple] = {}

    # ------------------------------------------------- checkpoint / resume

    @classmethod
    def from_checkpoint(cls, spec, anchor_state, anchor_block, **kw):
        """Start from a trusted finalized state/block pair (checkpoint sync;
        required-by-default startup mode in the reference since v4.6.0)."""
        return cls(spec, anchor_state, anchor_block=anchor_block, **kw)

    def import_historical_blocks(self, blocks) -> int:
        """Backfill: import a contiguous ascending run of blocks ENDING at
        the current oldest block's parent, with hash-linkage checks and ONE
        batched proposer-signature verification for the whole run
        (historical_blocks.rs:189 ParallelSignatureSets analog — a flagship
        device batch workload). Returns blocks accepted."""
        if not blocks:
            return 0
        spec = self.spec
        oldest = self.store.get_block(
            self._oldest_block_root, types_for_slot(spec, self.oldest_block_slot)
        )
        expected_root = bytes(oldest.message.parent_root)
        get_pubkey = self.pubkey_cache.pubkey_getter()
        batch = SignatureBatch()
        roots = []
        for sb in reversed(blocks):          # newest -> oldest linkage walk
            types = types_for_slot(spec, sb.message.slot)
            root = types.BeaconBlock.hash_tree_root(sb.message)
            if root != expected_root:
                raise BlockError("backfill chain discontinuity")
            roots.append((root, sb, types))
            expected_root = bytes(sb.message.parent_root)
            if sb.message.slot > 0:
                batch.add(
                    sigs.historical_block_proposal_set(
                        spec, types, sb, self.genesis_validators_root, get_pubkey
                    )
                )
        if not batch.verify():
            raise BlockError("backfill signature batch invalid")
        for root, sb, types in roots:
            self.store.put_block(root, sb, types)
            self.block_slots[root] = int(sb.message.slot)
        # roots[-1] is blocks[0] (the oldest) — the linkage walk went newest
        # to oldest, so its root is already computed
        self.oldest_block_slot = int(blocks[0].message.slot)
        self._oldest_block_root = roots[-1][0]
        return len(blocks)

    PERSIST_HEAD_KEY = b"persisted-head"

    def persist(self) -> None:
        """Persist the minimal resume set: head root + anchor info + op-pool-
        independent indices. States/blocks are already durably in the store;
        resume() rebuilds fork choice by replaying stored blocks from the
        finalized anchor (builder.rs resume path)."""
        import pickle

        fin_epoch, fin_root = self.fork_choice.store.finalized_checkpoint
        payload = {
            "head_root": self.head_root,
            "finalized_root": fin_root,
            "finalized_epoch": fin_epoch,
            "anchor_root": self.genesis_block_root,
            "oldest_block_slot": self.oldest_block_slot,
            "oldest_block_root": self._oldest_block_root,
            "block_slots": self.block_slots,
            "state_root_by_block": self.state_root_by_block,
        }
        self.store.put_chain_item(self.PERSIST_HEAD_KEY, pickle.dumps(payload))
        # durability barrier: a persist that only reached the page cache is
        # not a persist (store flush applies the engine's fsync policy)
        self.store.flush()

    @classmethod
    def resume(cls, spec, store, **kw):
        """Rebuild a chain from a persisted store: load the finalized anchor
        state, replay stored descendant blocks into fork choice, restore the
        head (beacon_chain/src/builder.rs resume analog)."""
        import pickle

        raw = store.get_chain_item(cls.PERSIST_HEAD_KEY)
        if raw is None:
            raise BlockError("no persisted chain in store")
        try:
            meta = pickle.loads(raw)
        except Exception as e:  # noqa: BLE001 — torn/corrupt persist record
            raise BlockError(f"persisted chain record unreadable: {e}") from e
        # anchor: highest stored block at/below finalization whose state we
        # still have — walk back from head via parents
        block_slots = meta["block_slots"]
        state_by_block = meta["state_root_by_block"]

        # find the finalized anchor block+state
        fin_root = meta["finalized_root"]
        if fin_root == b"\x00" * 32 or fin_root not in block_slots:
            fin_root = meta["anchor_root"]
        fin_slot = block_slots.get(fin_root)
        fin_state_root = state_by_block.get(fin_root)
        if fin_slot is None or fin_state_root is None:
            raise BlockError("persisted anchor unknown to the chain indices")
        types = types_for_slot(spec, fin_slot)
        anchor_block = store.get_block(fin_root, types)
        anchor_state = store.get_state(fin_state_root, types)
        if anchor_state is None or anchor_block is None:
            raise BlockError("persisted anchor incomplete")

        chain = cls(spec, anchor_state, store=store, anchor_block=anchor_block, **kw)
        chain.oldest_block_slot = meta["oldest_block_slot"]
        chain._oldest_block_root = meta["oldest_block_root"]
        chain.block_slots.update(block_slots)

        # replay the post-anchor chain into fork choice (ascending slots)
        replay = [
            (slot, root)
            for root, slot in block_slots.items()
            if slot > fin_slot and root in state_by_block
        ]
        for slot, root in sorted(replay):
            t = types_for_slot(spec, slot)
            sb = store.get_block(root, t)
            st = store.get_state(state_by_block[root], t)
            if sb is None or st is None:
                continue
            chain.slot_clock.set_slot(max(chain.current_slot, slot))
            chain.fork_choice.on_tick(chain.current_slot)
            chain.fork_choice.on_block(sb, root, st)
            chain.state_cache[state_by_block[root]] = st
            chain.state_root_by_block[root] = state_by_block[root]
            chain.pubkey_cache.import_new_pubkeys(st)
        chain._persisted_head = meta["head_root"]
        chain.recompute_head()
        return chain

    @classmethod
    def from_store(cls, spec, store, **kw):
        """Restart path over an existing datadir: `resume()` with corrupt-
        head recovery made explicit. A persisted head whose block or state
        the store no longer has (crash between fork-choice update and state
        write) is simply absent from the replay, so fork choice lands on
        the best surviving block — the fork_revert.rs outcome without a
        separate revert pass. Raises BlockError when the persist record
        itself is missing/unreadable or the finalized anchor is gone; the
        caller (cli.cmd_bn) then falls back to its configured start anchor."""
        from ..utils.logging import get_logger

        log = get_logger("chain")
        chain = cls.resume(spec, store, **kw)
        persisted = getattr(chain, "_persisted_head", None)
        if persisted is not None and chain.head_root != persisted:
            log.warn(
                "persisted head unavailable after crash; recovered to the "
                "best surviving block",
                persisted=persisted.hex()[:8],
                recovered=chain.head_root.hex()[:8],
            )
        else:
            log.info(
                "chain resumed from persisted head",
                head=chain.head_root.hex()[:8],
                slot=chain.block_slots.get(chain.head_root),
            )
        return chain

    def revert_to_fork_boundary(self, bad_root: bytes):
        """Corrupt-head recovery (fork_revert.rs): rebuild fork choice from
        the finalized anchor, replaying every stored block EXCEPT the bad
        block and its descendants. Returns the new head root."""
        fin_epoch, fin_root = self.fork_choice.store.finalized_checkpoint
        if fin_root == b"\x00" * 32 or fin_root not in self.block_slots:
            fin_root = self.genesis_block_root
        fin_slot = self.block_slots[fin_root]
        types = types_for_slot(self.spec, fin_slot)
        fin_state_root = self.state_root_by_block.get(fin_root)
        fin_state = (
            self.state_cache.get(fin_state_root)
            or self.store.get_state(fin_state_root, types)
            if fin_state_root
            else None
        )
        if fin_state is None:
            raise BlockError("finalized state unavailable for fork revert")
        if fin_state_root:
            self.state_cache[fin_state_root] = fin_state

        self.fork_choice = ForkChoice(self.spec, fin_root, fin_slot, fin_state)
        # replay stored descendants, skipping the bad branch
        banned = {bad_root}
        replay = sorted(
            (slot, root)
            for root, slot in self.block_slots.items()
            if slot > fin_slot
        )
        for slot, root in replay:
            t = types_for_slot(self.spec, slot)
            sb = self.store.get_block(root, t)
            if sb is None:
                continue
            if bytes(sb.message.parent_root) in banned or root in banned:
                banned.add(root)
                continue
            sroot = self.state_root_by_block.get(root)
            st = self.state_cache.get(sroot) if sroot else None
            if st is None and sroot:
                st = self.store.get_state(sroot, t)
            if st is None:
                banned.add(root)        # no state -> can't vouch for branch
                continue
            self.fork_choice.on_tick(max(self.current_slot, slot))
            self.fork_choice.on_block(sb, root, st)
        for root in banned:
            self.block_slots.pop(root, None)
            self.state_root_by_block.pop(root, None)
            self.store.delete_block(root)
        self.fork_choice.on_tick(self.current_slot)
        return self.recompute_head()

    # ---------------------------------------------------------------- time

    @property
    def current_slot(self) -> int:
        s = self.slot_clock.now()
        return s if s is not None else 0

    def per_slot_task(self) -> None:
        self.fork_choice.on_tick(self.current_slot)
        self.naive_attestation_pool.prune(self.current_slot)
        self.naive_sync_pool.prune(self.current_slot)
        if self.monitor.active:
            self._monitor_epoch_rollover()
        fin_epoch = self.fork_choice.store.finalized_checkpoint[0]
        self.observed_slashable.prune(fin_epoch, self.spec.preset.SLOTS_PER_EPOCH)
        if self.monitor.active and fin_epoch > 0:
            self.monitor.prune(fin_epoch)
        if (
            self.slasher is not None
            and hasattr(self.slasher, "prune")
            and fin_epoch > getattr(self, "_slasher_pruned_at", 0)
        ):
            self._slasher_pruned_at = fin_epoch
            self.slasher.prune(
                fin_epoch,
                self.spec.preset.SLOTS_PER_EPOCH,
                history_epochs=self.config.slasher_history_epochs,
            )
        # pending DA joins at/below finalization can never import
        self.data_availability.prune_finalized(
            fin_epoch * self.spec.preset.SLOTS_PER_EPOCH
        )
        self._maybe_migrate_finalized(fin_epoch)

    def _maybe_migrate_finalized(self, fin_epoch: int) -> None:
        """Background-migrator analog (beacon_chain/src/migrate.rs): once
        finalization has advanced `epochs_per_migration` past the store's
        hot/cold split, walk the newly finalized canonical segment (by
        parent links from the finalized block) and move it across the
        split — states drop from the hot DB, roots land in the freezer's
        chunked vectors, restore points keep full copies."""
        if self.store is None or self.config.epochs_per_migration <= 0:
            return
        spe = self.spec.preset.SLOTS_PER_EPOCH
        fin_slot = fin_epoch * spe
        split = self.store.split_slot
        if fin_slot - split < self.config.epochs_per_migration * spe:
            return
        from ..state_transition.slot import types_for_slot

        fin_root = self.fork_choice.store.finalized_checkpoint[1]
        # the split advances only to the finalized BLOCK's slot (not the
        # epoch boundary): the finalized block's own state must stay hot
        # (fork revert loads exactly it), and with a skipped boundary slot
        # that block sits below the boundary — advancing the split past an
        # unmigrated block would strand it outside every future walk and
        # punch a hole in the freezer's chunked root vectors
        fin_block_slot = self.block_slots.get(fin_root)
        if fin_block_slot is None or fin_block_slot <= split:
            return
        seg: list[tuple[int, bytes, bytes]] = []
        root = fin_root
        while root is not None:
            slot = self.block_slots.get(root)
            if slot is None or slot < split:
                break
            blk = self.store.get_block(root, types_for_slot(self.spec, slot))
            if blk is None:
                break
            if slot < fin_block_slot:
                seg.append((int(slot), root, bytes(blk.message.state_root)))
            if slot == 0:
                break
            root = bytes(blk.message.parent_root)
        if not seg:
            # empty segment still advances the split so the check above
            # does not re-walk every slot
            self.store.migrate_to_freezer(
                fin_block_slot, [], types_for_slot(self.spec, 0)
            )
            return
        seg.reverse()
        self.store.migrate_to_freezer(
            fin_block_slot, seg, types_for_slot(self.spec, seg[0][0])
        )

    # ---------------------------------------------------------------- head

    def advance_head_state(self) -> bool:
        """state_advance_timer.rs analog: during the slot TAIL, pre-compute
        the head state advanced to the next slot so block production and
        first-thing-next-slot attestation serving skip the epoch-transition
        latency. The advanced state is cached under a synthetic key that
        _state_for_block consults first."""
        next_slot = self.current_slot + 1
        head = self.head_root
        cached = self._advanced.get(head)
        if cached is not None and cached.slot >= next_slot:
            return False
        state = clone_state(self.head_state(), self.spec)
        if state.slot >= next_slot:
            return False
        process_slots(state, self.spec, next_slot)
        self._advanced = {head: state}      # only ever one entry (the head)
        return True

    def head_state(self):
        sroot = self.state_root_by_block[self.head_root]
        st = self.state_cache.get(sroot)
        if st is None:
            # evicted from the LRU (deep reorg/revert): reload from store
            types = types_for_slot(self.spec, self.block_slots[self.head_root])
            st = self.store.get_state(sroot, types)
            if st is None:
                raise BlockError("head state unavailable")
            self.state_cache[sroot] = st
        return st

    def head_block(self):
        types = types_for_slot(self.spec, self.block_slots[self.head_root])
        return self.store.get_block(self.head_root, types)

    def recompute_head(self) -> bytes:
        self.fork_choice.on_tick(self.current_slot)
        head = self.fork_choice.get_head()
        self.head_root = head
        self._notify_el_of_head(head)
        return head

    def verify_slashing_for_pool(self, slashing, kind: str) -> None:
        """Validate an externally-submitted slashing BEFORE it can reach the
        op pool: run the real state-transition processing (slashability
        checks + signature sets) against a clone of the head state. A
        garbage or spent slashing packed into a produced block would make
        the node's own blocks invalid (observed_operations.rs + the gossip
        verification the HTTP publish path must mirror). Raises
        BlockProcessingError/AttestationError on anything unincludable."""
        from ..state_transition import block as blk

        spec = self.spec
        state = clone_state(self.head_state(), spec)
        types = types_for_slot(spec, state.slot)
        fork = spec.fork_name_at_slot(state.slot)
        get_pubkey = self.pubkey_cache.pubkey_getter()
        batch = SignatureBatch()
        if kind == "attester":
            blk.process_attester_slashing(
                state, spec, types, slashing, fork, batch.add, get_pubkey
            )
        elif kind == "proposer":
            blk.process_proposer_slashing(
                state, spec, types, slashing, fork, batch.add, get_pubkey
            )
        else:
            raise ValueError(kind)
        if not batch.verify():
            raise BlockProcessingError("slashing signature invalid")

    def process_invalid_execution_payload(self, block_root: bytes) -> bytes:
        """An EL verdict (late newPayload / fcU error) invalidated an
        already-imported optimistic block: poison it and its descendants in
        fork choice and move the head off the invalid subtree
        (proto_array execution-status invalidation)."""
        self.fork_choice.proto.on_invalid_execution_payload(block_root)
        return self.recompute_head()

    def _notify_el_of_head(self, head: bytes) -> None:
        """Send engine_forkchoiceUpdated on head change (canonical_head.rs
        update_execution_engine_forkchoice analog). Skipped pre-merge (no
        execution chain to steer) and deduplicated per head root. An
        INVALID verdict on an optimistically-imported head poisons its
        subtree and moves the head off it."""
        if self.execution_layer is None or head == self._el_last_head_sent:
            return
        head_hash = self.payload_hash_by_block.get(head, b"\x00" * 32)
        if head_hash == b"\x00" * 32:
            return
        jc_root = self.fork_choice.store.justified_checkpoint[1]
        fc_root = self.fork_choice.store.finalized_checkpoint[1]
        safe_hash = self.payload_hash_by_block.get(jc_root, b"\x00" * 32)
        fin_hash = self.payload_hash_by_block.get(fc_root, b"\x00" * 32)
        try:
            res = self.execution_layer.notify_forkchoice_updated(
                head_hash, safe_hash, fin_hash
            )
        except Exception:
            # engine flakiness must not break head updates (retried on the
            # next head recompute); the health machine tracks failures
            return
        self._el_last_head_sent = head
        status = (res or {}).get("payloadStatus", {}).get("status")
        from ..execution.engine_api import PayloadStatus

        if status == PayloadStatus.invalid.value:
            # invalidation moves the head off this subtree; the recursive
            # recompute_head -> _notify_el_of_head chain terminates because
            # every step invalidates at least one block
            self.process_invalid_execution_payload(head)

    # ------------------------------------------------------------ gossip block

    def verify_block_for_gossip(self, signed_block, block_root=None):
        """Cheap structural + proposer-signature verification
        (GossipVerifiedBlock::new analog)."""
        spec = self.spec
        block = signed_block.message
        types = types_for_slot(spec, block.slot)
        if block_root is None:
            block_root = types.BeaconBlock.hash_tree_root(block)

        if block.slot > self.current_slot:
            raise BlockError(f"future block: {block.slot} > {self.current_slot}")
        if block_root in self.observed_blocks or self.store.block_exists(block_root):
            raise BlockError("block already known")
        parent_root = bytes(block.parent_root)
        if not self.store.block_exists(parent_root):
            raise BlockError("parent unknown")
        fin_epoch = self.fork_choice.store.finalized_checkpoint[0]
        fin_slot = h.compute_start_slot_at_epoch(fin_epoch, spec)
        if block.slot <= fin_slot:
            raise BlockError("block older than finalization")
        # proposer signature over a cheaply-advanced parent state — MUST
        # come before any equivocation bookkeeping, or unverifiable spam
        # could poison the observed caches against the honest proposer
        state = self._state_for_block(parent_root, block.slot)
        batch = SignatureBatch()
        try:
            batch.add(
                sigs.block_proposal_set(
                    state, spec, types, signed_block,
                    self.pubkey_cache.pubkey_getter(), block_root=block_root,
                )
            )
        except sigs.SignatureSetError as e:
            raise BlockError(f"undecodable signature: {e}") from e
        if not batch.verify():
            raise BlockError("invalid proposer signature")

        key = (block.slot, block.proposer_index)
        prior = self.observed_slashable.peek_proposal(
            int(block.proposer_index), int(block.slot), block_root
        )
        if prior is not None or key in self.observed_block_producers:
            # a VERIFIED conflicting proposal: feed the slasher both signed
            # headers (the prior one reconstructed from the store) and reject
            self._report_proposer_equivocation(signed_block, block_root, prior, types)
            raise BlockError("proposer equivocation for slot")

        self.observed_slashable.record_proposal(
            int(block.proposer_index), int(block.slot), block_root
        )
        self.observed_block_producers.add(key)
        self.observed_blocks.add(block_root)
        self.block_times.observed(block_root)
        if self.slasher is not None:
            self.slasher.accept_proposal(
                self._proposal_record(signed_block, block_root, types)
            )
        return block_root

    def _proposal_record(self, signed_block, block_root: bytes, types):
        from ..slasher.slasher import ProposalRecord

        block = signed_block.message
        hdr = types.BeaconBlockHeader.make(
            slot=block.slot,
            proposer_index=block.proposer_index,
            parent_root=block.parent_root,
            state_root=block.state_root,
            body_root=types.BeaconBlockBody.hash_tree_root(block.body),
        )
        return ProposalRecord(
            proposer_index=int(block.proposer_index),
            slot=int(block.slot),
            block_root=block_root,
            signed_header=types.SignedBeaconBlockHeader.make(
                message=hdr, signature=signed_block.signature
            ),
        )

    def _report_proposer_equivocation(self, signed_block, block_root, prior_root, types):
        if self.slasher is None:
            return
        self.slasher.accept_proposal(
            self._proposal_record(signed_block, block_root, types)
        )
        if prior_root is not None:
            prior_block = self.store.get_block(prior_root, types)
            if prior_block is not None:
                self.slasher.accept_proposal(
                    self._proposal_record(prior_block, prior_root, types)
                )

    def _state_for_block(self, parent_root: bytes, slot: int):
        """Parent post-state advanced to `slot` (cheap_state_advance).

        Consults the state-advance timer's pre-computed next-slot state
        first — the common case (a block building on the head at the next
        slot) then skips the advance entirely."""
        adv = self._advanced.get(parent_root)
        if adv is not None and adv.slot == slot:
            return clone_state(adv, self.spec)
        state_root = self.state_root_by_block.get(parent_root)
        if state_root is None or state_root not in self.state_cache:
            raise BlockError("parent state unavailable")
        state = clone_state(self.state_cache[state_root], self.spec)
        if state.slot < slot:
            process_slots(state, self.spec, slot)
        return state

    # ------------------------------------------------------------ import

    def process_block(
        self,
        signed_block,
        block_root=None,
        proposal_already_verified: bool = False,
        blobs=None,
        blobs_verified: bool = False,
    ) -> bytes:
        """Full verification + import (process_block/import_block analog).

        Deneb+ blocks carrying commitments are gated on data availability:
        sidecars either arrive via `blobs` (RPC/publish paths) or must have
        been collected by the DA checker from gossip; otherwise the block is
        held and AvailabilityPendingError raised
        (data_availability_checker.rs:40)."""
        from .data_availability import AvailabilityPendingError
        from ..types.spec import ForkName

        spec = self.spec
        block = signed_block.message
        types = types_for_slot(spec, block.slot)
        if block_root is None:
            block_root = types.BeaconBlock.hash_tree_root(block)
        parent_root = bytes(block.parent_root)
        if not self.store.block_exists(parent_root):
            raise BlockError("parent unknown")

        fork = spec.fork_name_at_slot(block.slot)
        commitments = (
            list(block.body.blob_kzg_commitments) if fork >= ForkName.deneb else []
        )
        sidecars = []
        if commitments:
            if blobs is not None:
                sidecars = list(blobs)
                if len(sidecars) != len(commitments) or any(
                    bytes(sc.kzg_commitment) != bytes(c)
                    for sc, c in zip(sidecars, commitments)
                ):
                    raise BlockError("sidecars do not match block commitments")
            else:
                got = self.data_availability.put_block(block_root, signed_block, types)
                if got is None:
                    raise AvailabilityPendingError(
                        block_root, self.data_availability.missing_indices(block_root)
                    )
                _, sidecars = got
                blobs_verified = True  # gossip-verified on arrival
            if not blobs_verified and not self.data_availability.verify_kzg_proofs(
                sidecars
            ):
                raise BlockError("blob KZG batch invalid")

        state = self._state_for_block(parent_root, block.slot)
        get_pubkey = self.pubkey_cache.pubkey_getter()

        batch = SignatureBatch()
        if not proposal_already_verified:
            batch.add(
                sigs.block_proposal_set(
                    state, spec, types, signed_block, get_pubkey, block_root=block_root
                )
            )

        # run per-block processing, accumulating the remaining signature sets
        # into the same batch, then verify EVERYTHING in one device call
        def handle(s):
            batch.add(s)

        from ..state_transition import block as blk

        try:
            blk.process_block_header(state, spec, types, block)
            fork = spec.fork_name_at_slot(block.slot)
            from ..types.spec import ForkName

            if fork >= ForkName.bellatrix:
                blk.process_withdrawals_and_payload(state, spec, types, block, fork)
            blk.process_randao(
                state, spec, types, block, SignatureStrategy.VERIFY_BULK, handle, get_pubkey
            )
            blk.process_eth1_data(state, spec, types, block.body)
            blk.process_operations(state, spec, types, block, fork, handle, get_pubkey)
            if fork >= ForkName.altair:
                blk.process_sync_aggregate(state, spec, types, block, handle, get_pubkey)
        except sigs.SignatureSetError as e:
            raise BlockError(f"undecodable signature: {e}") from e
        except BlockProcessingError as e:
            raise BlockError(str(e)) from e

        if not batch.verify():
            raise BlockError("block signature batch invalid")

        state_root = types.BeaconState.hash_tree_root(state)
        if bytes(block.state_root) != state_root:
            raise BlockError("state root mismatch")

        # Execution validity: hand the payload to the EL BEFORE import
        # (execution_payload.rs:113 notify_new_payload). INVALID rejects the
        # block and poisons its would-be subtree; SYNCING/ACCEPTED imports
        # optimistically (fork choice keeps the node optimistic until a
        # later fcU/newPayload confirms).
        el_status = None
        payload_hash = self.payload_hash_by_block.get(parent_root, b"\x00" * 32)
        if fork >= ForkName.bellatrix and hasattr(block.body, "execution_payload"):
            payload = block.body.execution_payload
            if bytes(payload.block_hash) != b"\x00" * 32:
                payload_hash = bytes(payload.block_hash)
                if self.execution_layer is not None:
                    from ..execution.engine_api import PayloadStatus

                    try:
                        el_status = self.execution_layer.notify_new_payload(
                            payload,
                            parent_beacon_block_root=parent_root,
                            kzg_commitments=getattr(
                                block.body, "blob_kzg_commitments", ()
                            ),
                        )
                    except Exception:
                        # engine unreachable: import optimistically, exactly
                        # like a SYNCING verdict (engines.rs offline state)
                        el_status = PayloadStatus.syncing.value
                    if el_status == PayloadStatus.invalid.value:
                        raise BlockError("execution payload invalid")

        # import: store + caches + fork choice
        self.store.put_block(block_root, signed_block, types)
        if sidecars:
            import struct

            parts = [types.BlobSidecar.serialize(sc) for sc in sidecars]
            self.store.put_blobs(
                block_root,
                struct.pack("<I", len(parts))
                + b"".join(struct.pack("<I", len(p)) + p for p in parts),
            )
        self.store.put_state(state_root, state, types)
        self.state_cache[state_root] = state
        self.block_slots[block_root] = block.slot
        self.state_root_by_block[block_root] = state_root
        self.pubkey_cache.import_new_pubkeys(state)

        self.payload_hash_by_block[block_root] = payload_hash

        # Timely = arrived within the attestation deadline (1/3 slot) of its
        # OWN slot — not merely "imported during its slot". A block landing
        # after attesters voted for its parent must count as late, or the
        # proposer re-org (get_proposer_head) can never fire for the
        # canonical late-block case. Manual clocks sit at the slot start, so
        # logical-time tests keep their on-time semantics.
        timely = (
            self.current_slot == block.slot
            and self.slot_clock.seconds_into_slot() < self.spec.seconds_per_slot / 3
        )
        self.fork_choice.on_tick(self.current_slot)
        self.fork_choice.on_block(signed_block, block_root, state, is_timely=timely)
        if el_status is not None:
            from ..execution.engine_api import PayloadStatus

            if el_status == PayloadStatus.valid.value:
                # VALID verdict also confirms all optimistic ancestors
                self.fork_choice.proto.on_valid_execution_payload(block_root)
        self.block_times.imported(block_root)
        prev_head = self.head_root
        self.recompute_head()
        # Early-attester data: serve attestations for the block imported this
        # slot — but only when fork choice actually selected it as head
        # (beacon_chain.rs only caches on `new_head_root == block_root`); a
        # losing fork block must not hijack attestation data.
        if self.head_root == block_root:
            from .caches import AttesterData

            epoch = h.compute_epoch_at_slot(block.slot, spec)
            self.early_attester_cache.add(
                int(block.slot),
                AttesterData(
                    beacon_block_root=block_root,
                    parent_root=parent_root,
                    source_epoch=int(state.current_justified_checkpoint.epoch),
                    source_root=bytes(state.current_justified_checkpoint.root),
                    target_epoch=epoch,
                    target_root=self._target_root_for(state, epoch, block_root),
                ),
            )
        from ..utils.metrics import BLOCK_OBSERVED_TO_HEAD, BLOCK_OBSERVED_TO_IMPORT

        d = self.block_times.import_delay(block_root)
        if d is not None:
            BLOCK_OBSERVED_TO_IMPORT.observe(d)
        if self.head_root != prev_head:
            self.block_times.became_head(self.head_root)
            d = self.block_times.head_delay(self.head_root)
            if d is not None:
                BLOCK_OBSERVED_TO_HEAD.observe(d)
        if self.monitor.active:
            self._monitor_block_import(block, state, fork)
        return block_root

    # ------------------------------------------------- validator monitor

    def _monitor_block_import(self, block, post_state, fork) -> None:
        """Feed the ValidatorMonitor from an imported block: proposal,
        per-attestation attesting indices (recomputed from the post state —
        only runs when validators are registered), sync-committee
        participation, and slashings (validator_monitor.rs
        register_attestation_in_block and friends)."""
        from ..types.spec import ForkName
        from ..utils.logging import get_logger

        mlog = get_logger("validator_monitor")
        spec = self.spec
        att_sets = []
        for att in block.body.attestations:
            epoch = int(att.data.target.epoch)
            try:
                # reuse the chain-wide shuffling cache, keyed exactly like
                # the gossip attestation path (_committee_for)
                cc = self.shuffling_cache.get_or_build(
                    post_state, spec, epoch, bytes(att.data.target.root)
                )
            except Exception as e:  # noqa: BLE001 — monitoring must never
                _MONITOR_ERRORS.labels("shuffling").inc()  # fail an import
                mlog.warn("monitor shuffling lookup failed; attestation "
                          "skipped", slot=int(att.data.slot), epoch=epoch,
                          error=f"{type(e).__name__}: {e}")
                continue
            try:
                if fork >= ForkName.electra:
                    indices = acc.get_attesting_indices_electra(
                        post_state, spec, att, cc
                    )
                else:
                    committee = cc.committee(att.data.slot, att.data.index)
                    indices = [
                        i for i, bit in zip(committee, att.aggregation_bits) if bit
                    ]
            except Exception as e:  # noqa: BLE001
                _MONITOR_ERRORS.labels("attesting_indices").inc()
                mlog.warn("monitor attesting-index recovery failed; "
                          "attestation skipped", slot=int(att.data.slot),
                          index=int(att.data.index),
                          error=f"{type(e).__name__}: {e}")
                continue
            att_sets.append((att, indices))
        self.monitor.on_block_imported(block, att_sets)

        if fork >= ForkName.altair and hasattr(block.body, "sync_aggregate"):
            self.monitor.on_sync_aggregate(
                int(block.slot),
                self._sync_committee_member_indices(post_state),
                list(block.body.sync_aggregate.sync_committee_bits),
            )

        epoch = int(block.slot) // spec.preset.SLOTS_PER_EPOCH
        for sl in block.body.proposer_slashings:
            self.monitor.on_slashing(
                int(sl.signed_header_1.message.proposer_index), epoch
            )
        for sl in block.body.attester_slashings:
            a = set(sl.attestation_1.attesting_indices)
            for vi in sorted(a & set(sl.attestation_2.attesting_indices)):
                self.monitor.on_slashing(int(vi), epoch)

    def _sync_committee_member_indices(self, state) -> list[int]:
        """Validator indices of the CURRENT sync committee, cached per sync
        period (pubkey -> index via the pubkey cache)."""
        spec = self.spec
        epoch = int(state.slot) // spec.preset.SLOTS_PER_EPOCH
        period = epoch // spec.preset.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        if self._monitor_sync_indices and self._monitor_sync_indices[0] == period:
            return self._monitor_sync_indices[1]
        indices = []
        for pk in state.current_sync_committee.pubkeys:
            got = self.pubkey_cache.get_index(bytes(pk))
            indices.append(-1 if got is None else got)
        self._monitor_sync_indices = (period, indices)
        return indices

    def _monitor_epoch_rollover(self) -> None:
        """On entering a new epoch E: record E's expected proposers (for
        missed-block detection) and close epoch E-2's books. Closing lags
        ONE FULL EPOCH (like validator_monitor.rs): attestations from the
        tail of E-1 are includable throughout E, so E-1's participation
        flags are only complete once E ends — a state in epoch E-1 (whose
        previous_epoch_participation is E-2, now final) is what we read."""
        spe = self.spec.preset.SLOTS_PER_EPOCH
        cur_epoch = self.current_slot // spe
        if cur_epoch == self._monitor_epoch:
            return
        prev_epoch_seen = self._monitor_epoch
        self._monitor_epoch = cur_epoch
        try:
            head = self.head_state()
            start = cur_epoch * spe
            st = head
            if st.slot < start:
                st = clone_state(head, self.spec)
                process_slots(st, self.spec, start)
            duties = [
                (slot, acc.get_beacon_proposer_index(st, self.spec, slot))
                for slot in range(start, start + spe)
            ]
            self.monitor.on_proposer_duties(cur_epoch, duties)

            if cur_epoch >= 2:
                # close every epoch whose books became final since the last
                # tick (the clock may jump several epochs after a stall);
                # only the newest target can read real participation flags —
                # a state inside epoch E-1 has previous participation == E-2
                # bounded backfill: none on the first tick (a checkpoint
                # start at epoch 300k must not reconcile 300k empty epochs)
                # and at most 32 epochs after a stall
                if prev_epoch_seen is None:
                    oldest = cur_epoch - 2
                else:
                    oldest = max(prev_epoch_seen - 1, cur_epoch - 2 - 32, 0)
                for tgt in range(oldest, cur_epoch - 2):
                    self.monitor.finalize_epoch(tgt, None)
                prev_start = (cur_epoch - 1) * spe
                st_close = head
                if st_close.slot < prev_start:
                    st_close = clone_state(head, self.spec)
                    process_slots(st_close, self.spec, prev_start)
                in_prev_epoch = prev_start <= st_close.slot < start
                self.monitor.finalize_epoch(
                    cur_epoch - 2, st_close if in_prev_epoch else None
                )
        except Exception as e:
            from ..utils.logging import get_logger

            get_logger("validator_monitor").warn(
                "epoch rollover bookkeeping failed", error=str(e)
            )

    def process_gossip_blob(self, sidecar):
        """Gossip blob-sidecar entry: verify, feed the DA checker, and import
        the joined block if it just became available. Returns the imported
        block root or None (network_beacon_processor process_gossip_blob
        analog)."""
        from .data_availability import verify_blob_sidecar_for_gossip

        block_root = verify_blob_sidecar_for_gossip(self, sidecar)
        got = self.data_availability.put_blob(block_root, sidecar)
        if got is not None:
            block, sidecars = got
            return self.process_block(block, blobs=sidecars, blobs_verified=True)
        return None

    def get_blobs(self, block_root: bytes):
        """Stored sidecars for an imported block (by-root RPC / API serve)."""
        raw = self.store.get_blobs(block_root)
        if raw is None:
            return []
        import struct

        slot = self.block_slots.get(block_root)
        types = types_for_slot(self.spec, slot if slot is not None else 0)
        n = struct.unpack_from("<I", raw, 0)[0]
        off = 4
        out = []
        for _ in range(n):
            ln = struct.unpack_from("<I", raw, off)[0]
            off += 4
            out.append(types.BlobSidecar.deserialize(raw[off : off + ln]))
            off += ln
        return out

    def process_chain_segment(self, blocks, blobs_by_root=None) -> list[bytes]:
        """Import a batch of contiguous blocks with ONE signature batch for
        the whole segment (signature_verify_chain_segment analog).

        blobs_by_root: {block_root: [sidecar]} fetched over RPC alongside
        the range (block_sidecar_coupling) — verified as a KZG batch inside
        process_block."""
        if not blocks:
            return []
        spec = self.spec
        get_pubkey = self.pubkey_cache.pubkey_getter()
        # 1. one pass building proposal sets against cheaply-advanced states
        batch = SignatureBatch()
        state = self._state_for_block(bytes(blocks[0].message.parent_root), blocks[0].message.slot)
        trial = clone_state(state, spec)
        for sb in blocks:
            types = types_for_slot(spec, sb.message.slot)
            if trial.slot < sb.message.slot:
                process_slots(trial, spec, sb.message.slot)
            batch.add(sigs.block_proposal_set(trial, spec, types, sb, get_pubkey))
            batch.add(sigs.randao_set(trial, spec, types, sb.message, get_pubkey))
        if not batch.verify():
            raise BlockError("chain segment signature batch invalid")
        # 2. sequential import without re-verifying proposal signatures
        roots = []
        for sb in blocks:
            blobs = None
            if blobs_by_root is not None:
                types = types_for_slot(spec, sb.message.slot)
                root = types.BeaconBlock.hash_tree_root(sb.message)
                blobs = blobs_by_root.get(root)
            roots.append(
                self.process_block(
                    sb, proposal_already_verified=True, blobs=blobs
                )
            )
        return roots

    def _target_root_for(self, state, epoch: int, head_root: bytes) -> bytes:
        start = h.compute_start_slot_at_epoch(epoch, self.spec)
        if state.slot <= start:
            return head_root
        return bytes(
            state.block_roots[start % self.spec.preset.SLOTS_PER_HISTORICAL_ROOT]
        )

    # ------------------------------------------------------------ attestations

    @staticmethod
    def _attestation_committee_index(att) -> int:
        """The committee an attestation covers. Electra (EIP-7549) moved
        the index out of AttestationData (data.index MUST be 0) into the
        committee_bits field; gossip attestations/aggregates set exactly
        one bit."""
        cb = getattr(att, "committee_bits", None)
        if cb is None:
            return int(att.data.index)
        set_bits = [i for i, b in enumerate(cb) if b]
        if len(set_bits) != 1:
            raise AttestationError("expected exactly one committee bit")
        if int(att.data.index) != 0:
            raise AttestationError("electra attestation data.index must be 0")
        return set_bits[0]

    def _committee_for(self, data, committee_index: int | None = None):
        spec = self.spec
        epoch = data.target.epoch
        cache = self.shuffling_cache.get_or_build(
            self._attestation_state(data), spec, epoch, bytes(data.target.root)
        )
        idx = int(data.index) if committee_index is None else committee_index
        if idx >= cache.committees_per_slot:
            raise AttestationError("bad committee index")
        return cache.committee(data.slot, idx)

    def _attestation_state(self, data):
        """A state usable to compute the committee for `data`."""
        target_root = bytes(data.target.root)
        state_root = self.state_root_by_block.get(target_root)
        if state_root and state_root in self.state_cache:
            return self.state_cache[state_root]
        return self.head_state()

    def prepare_unaggregated_attestations(self, attestations) -> list:
        """Host-side phase of batch gossip verification: committee lookup,
        dedup, signature-set construction. Returns [(att, attesting, set)]
        ready for one device submission."""
        spec = self.spec
        get_pubkey = self.pubkey_cache.pubkey_getter()
        prepared = []
        # batch-LOCAL dedup: observed_attesters is only updated at
        # completion, so without this a validator equivocating twice within
        # one coalescing window would get both attestations verified and
        # forwarded (the sequential path dropped the second)
        seen_in_batch: set = set()
        for att in attestations:
            data = att.data
            epoch = data.target.epoch
            if data.target.epoch not in (
                h.compute_epoch_at_slot(data.slot, spec),
            ):
                continue
            try:
                committee = self._committee_for(
                    data, self._attestation_committee_index(att)
                )
            except AttestationError:
                continue
            if len(att.aggregation_bits) != len(committee):
                continue
            attesting = [i for i, b in zip(committee, att.aggregation_bits) if b]
            if len(attesting) != 1:
                continue  # unaggregated = exactly one bit
            if (epoch, attesting[0]) in self.observed_attesters:
                continue
            if (epoch, attesting[0]) in seen_in_batch:
                continue
            seen_in_batch.add((epoch, attesting[0]))
            state = self._attestation_state(data)
            types = types_for_slot(spec, data.slot)
            indexed = types.IndexedAttestation.make(
                attesting_indices=attesting, data=data, signature=att.signature
            )
            try:
                s = sigs.indexed_attestation_set(state, spec, types, indexed, get_pubkey)
            except sigs.SignatureSetError:
                continue
            prepared.append((att, attesting, s))
        return prepared

    def complete_attestation_batch(self, prepared, ok: bool) -> list:
        """Device-result phase: on batch failure fall back to per-set
        verification (attestation_verification/batch.rs:213-221), record
        observed attesters, return verified (att, attesting_indices)."""
        results = []
        for att, attesting, s in prepared:
            valid = ok or bls.verify_signature_sets([s])
            if valid:
                self.observed_attesters.add((att.data.target.epoch, attesting[0]))
                types = types_for_slot(self.spec, att.data.slot)
                self.naive_attestation_pool.insert(att, types)
                if self.slasher is not None:
                    from ..slasher.slasher import AttestationRecord

                    indexed = types.IndexedAttestation.make(
                        attesting_indices=attesting, data=att.data,
                        signature=att.signature,
                    )
                    self.slasher.accept_attestation(
                        AttestationRecord(
                            validator_index=attesting[0],
                            source=int(att.data.source.epoch),
                            target=int(att.data.target.epoch),
                            data_root=types.AttestationData.hash_tree_root(att.data),
                            indexed=indexed,
                        )
                    )
                results.append((att, attesting))
        return results

    def verify_unaggregated_attestations(self, attestations) -> list:
        """Batch gossip verification (batch_verify_unaggregated_attestations,
        attestation_verification/batch.rs:140): prepare + ONE device batch +
        complete. The split phases let the beacon processor overlap host
        marshalling with in-flight device batches
        (submit_attestation_batch)."""
        prepared = self.prepare_unaggregated_attestations(attestations)
        if not prepared:
            return []
        ok = bls.verify_signature_sets([s for _, _, s in prepared])
        return self.complete_attestation_batch(prepared, ok)

    def submit_attestation_batch(self, attestations, on_done=None,
                                 on_prepared=None):
        """Pipelined form: prepare on host, submit async to the device, and
        return (handle, continuation). The continuation — run when the
        processor resolves the handle — completes verification and applies
        fork-choice votes. Returns None if nothing verifiable.

        on_prepared([att, ...]) fires after the host phase with the
        attestations that made it into the device batch — callers tracking
        per-message outcomes (the gossip deferred-validation path) learn
        which inputs were dropped at prepare (duplicates/unverifiable)."""
        prepared = self.prepare_unaggregated_attestations(attestations)
        if on_prepared is not None:
            on_prepared([att for att, _indices, _s in prepared])
        if not prepared:
            if on_done is not None:
                on_done([])
            return None
        handle = bls.verify_signature_sets_async([s for _, _, s in prepared])

        def continuation(ok: bool):
            results = self.complete_attestation_batch(prepared, ok)
            for att, indices in results:
                self.apply_attestation_to_fork_choice(att, indices)
            if on_done is not None:
                on_done(results)
            return results

        return handle, continuation

    def verify_aggregated_attestations(self, signed_aggregates) -> list:
        """Batch gossip verification of SignedAggregateAndProof messages:
        3 signature sets each (selection proof, aggregator signature,
        indexed attestation) verified in ONE batch
        (attestation_verification/batch.rs:31-135)."""
        spec = self.spec
        get_pubkey = self.pubkey_cache.pubkey_getter()
        prepared = []
        sets = []
        for signed in signed_aggregates:
            msg = signed.message
            att = msg.aggregate
            data = att.data
            epoch = data.target.epoch
            key = (epoch, msg.aggregator_index)
            if key in self.observed_aggregators:
                continue
            try:
                committee = self._committee_for(
                    data, self._attestation_committee_index(att)
                )
            except AttestationError:
                continue
            if len(att.aggregation_bits) != len(committee):
                continue
            attesting = [i for i, b in zip(committee, att.aggregation_bits) if b]
            if not attesting:
                continue
            state = self._attestation_state(data)
            types = types_for_slot(spec, data.slot)
            indexed = types.IndexedAttestation.make(
                attesting_indices=sorted(attesting), data=data, signature=att.signature
            )
            try:
                trio = [
                    sigs.selection_proof_set(
                        state, spec, types, data.slot, msg.aggregator_index,
                        msg.selection_proof, get_pubkey,
                    ),
                    sigs.aggregate_and_proof_set(state, spec, types, signed, get_pubkey),
                    sigs.indexed_attestation_set(state, spec, types, indexed, get_pubkey),
                ]
            except sigs.SignatureSetError:
                continue
            prepared.append((signed, attesting, trio))
            sets.extend(trio)
        if not sets:
            return []
        ok = bls.verify_signature_sets(sets)
        results = []
        for signed, attesting, trio in prepared:
            valid = ok or bls.verify_signature_sets(trio)
            if valid:
                self.observed_aggregators.add(
                    (signed.message.aggregate.data.target.epoch, signed.message.aggregator_index)
                )
                results.append((signed.message.aggregate, attesting))
        return results

    def verify_sync_committee_message(self, msg) -> bool:
        """Gossip verification of a single SyncCommitteeMessage
        (sync_committee_verification.rs)."""
        spec = self.spec
        state = self.head_state()
        if not hasattr(state, "current_sync_committee"):
            raise AttestationError("pre-altair state")
        pk_bytes = bytes(state.validators[msg.validator_index].pubkey)
        committee_pks = {bytes(pk) for pk in state.current_sync_committee.pubkeys}
        if pk_bytes not in committee_pks:
            raise AttestationError("not in sync committee")
        get_pubkey = self.pubkey_cache.pubkey_getter()
        s = sigs.sync_committee_message_set(state, spec, msg, get_pubkey)
        return bls.verify_signature_sets([s])

    def verify_signed_contribution(self, signed) -> bool:
        """Gossip verification of a SignedContributionAndProof: selection
        proof + aggregator signature + aggregate sync signature, one batch
        (sync_committee_verification.rs contribution path)."""
        spec = self.spec
        state = self.head_state()
        msg = signed.message
        contrib = msg.contribution
        get_pubkey = self.pubkey_cache.pubkey_getter()
        types = types_for_slot(spec, contrib.slot)
        sub_size = spec.preset.SYNC_COMMITTEE_SIZE // spec.sync_committee_subnet_count
        # participant pubkeys for the contribution signature
        start = int(contrib.subcommittee_index) * sub_size
        pks = [
            bytes(state.current_sync_committee.pubkeys[start + i])
            for i, b in enumerate(contrib.aggregation_bits)
            if b
        ]
        if not pks:
            return False
        try:
            trio = [
                sigs.sync_selection_proof_set(
                    state, spec, types, contrib.slot, contrib.subcommittee_index,
                    msg.aggregator_index, msg.selection_proof, get_pubkey,
                ),
                sigs.contribution_and_proof_set(state, spec, types, signed, get_pubkey),
            ]
            # aggregate sync signature over the block root
            from ..types.spec import DOMAIN_SYNC_COMMITTEE

            epoch = h.compute_epoch_at_slot(contrib.slot, spec)
            domain = h.get_domain(state, spec, DOMAIN_SYNC_COMMITTEE, epoch)
            root = h.compute_signing_root_from_root(
                bytes(contrib.beacon_block_root), domain
            )
            by_bytes = sigs.get_pubkey_by_bytes
            trio.append(
                bls.SignatureSet(
                    bls.Signature.deserialize(bytes(contrib.signature)),
                    [by_bytes(get_pubkey, pk) for pk in pks],
                    root,
                )
            )
        except sigs.SignatureSetError:
            return False
        return bls.verify_signature_sets(trio)

    def sync_subcommittee_positions(self, validator_index: int) -> list[tuple[int, int]]:
        """(subcommittee_index, index_in_subcommittee) pairs for a validator
        in the CURRENT sync committee (duplicates possible by spec)."""
        state = self.head_state()
        spec = self.spec
        pk = bytes(state.validators[validator_index].pubkey)
        sub_size = spec.preset.SYNC_COMMITTEE_SIZE // spec.sync_committee_subnet_count
        out = []
        for i, cpk in enumerate(state.current_sync_committee.pubkeys):
            if bytes(cpk) == pk:
                out.append((i // sub_size, i % sub_size))
        return out

    def process_sync_committee_messages(self, msgs) -> int:
        """Verify a batch of sync-committee messages in ONE device batch and
        feed the naive contribution pool. Returns messages accepted."""
        spec = self.spec
        state = self.head_state()
        get_pubkey = self.pubkey_cache.pubkey_getter()
        prepared = []
        for msg in msgs:
            try:
                positions = self.sync_subcommittee_positions(int(msg.validator_index))
            except (IndexError, AttributeError):
                continue
            if not positions:
                continue
            try:
                s = sigs.sync_committee_message_set(state, spec, msg, get_pubkey)
            except sigs.SignatureSetError:
                continue
            prepared.append((msg, positions, s))
        if not prepared:
            return 0
        ok = bls.verify_signature_sets([s for _, _, s in prepared])
        accepted = 0
        for msg, positions, s in prepared:
            if ok or bls.verify_signature_sets([s]):
                for sub_idx, pos in positions:
                    self.naive_sync_pool.insert(
                        int(msg.slot), bytes(msg.beacon_block_root), sub_idx, pos,
                        bytes(msg.signature),
                    )
                accepted += 1
        return accepted

    # ------------------------------------------------------------ production

    def produce_block(
        self,
        slot: int,
        randao_reveal: bytes,
        op_pool=None,
        graffiti: bytes | None = None,
        blobs_bundle=None,
    ):
        """Produce an unsigned block on the head state
        (produce_block_on_state, beacon_chain.rs:4720 analog).

        blobs_bundle: optional (blobs, commitments, proofs) from the EL's
        getPayload (deneb+); commitments go into the body, and the caller
        builds sidecars from the signed block via
        data_availability.build_sidecars."""
        from ..state_transition.block import SignatureStrategy
        from ..types.spec import ForkName

        if graffiti is None:
            # node default (--graffiti / graffiti_calculator.rs role);
            # callers (API) still override per request
            graffiti = getattr(self, "graffiti", b"\x00" * 32)
        spec = self.spec
        types = types_for_slot(spec, slot)
        fork = spec.fork_name_at_slot(slot)
        # proposer re-org: build on the head's PARENT when the head is a
        # weak late block that fork choice deems safe to orphan
        # (get_proposer_head, fork_choice.rs:516)
        parent_root = self.fork_choice.get_proposer_head(self.head_root, slot)
        state = self._state_for_block(parent_root, slot)
        proposer = acc.get_beacon_proposer_index(state, spec)

        attestations = []
        if op_pool is not None:
            attestations = op_pool.get_attestations_for_block(state, types)

        # eth1 voting + deposit inclusion (eth1_chain.rs): the vote may flip
        # state.eth1_data inside process_eth1_data, and deposits are checked
        # against the POST-vote data — compute the effective value the same
        # way the verifier will.
        eth1_data = state.eth1_data
        deposits = []
        if self.eth1_cache is not None:
            from ..state_transition.block import eth1_data_after_vote

            eth1_data = self.eth1_cache.eth1_vote(state, spec, types)
            deposits = self.eth1_cache.deposits_for_block_inclusion(
                state, spec, types,
                eth1_data=eth1_data_after_vote(state, spec, eth1_data),
                fork=fork,
            )

        body_kwargs = dict(
            randao_reveal=randao_reveal,
            eth1_data=eth1_data,
            graffiti=graffiti,
            proposer_slashings=[],
            attester_slashings=[],
            attestations=attestations,
            deposits=deposits,
            voluntary_exits=[],
        )
        if op_pool is not None:
            ps, asl, exits, changes = op_pool.get_slashings_and_exits(state, types)
            body_kwargs.update(
                proposer_slashings=ps, attester_slashings=asl, voluntary_exits=exits
            )
            if fork >= ForkName.capella:
                body_kwargs["bls_to_execution_changes"] = changes
        if fork >= ForkName.altair:
            # pack the sync aggregate built from last slot's subnet
            # contributions signing our parent
            agg = self.naive_sync_pool.get_sync_aggregate(
                max(slot, 1) - 1, parent_root, types
            )
            body_kwargs["sync_aggregate"] = agg or types.SyncAggregate.make(
                sync_committee_bits=[False] * spec.preset.SYNC_COMMITTEE_SIZE,
                sync_committee_signature=bls.INFINITY_SIGNATURE_BYTES,
            )
        if fork >= ForkName.bellatrix:
            payload = types.ExecutionPayload.default()
            if self.execution_layer is not None:
                payload, el_bundle = self._request_el_payload(
                    state, spec, types, fork, proposer, parent_root
                )
                if el_bundle is not None and blobs_bundle is None:
                    blobs_bundle = el_bundle
            body_kwargs["execution_payload"] = payload
        if fork >= ForkName.capella and "bls_to_execution_changes" not in body_kwargs:
            body_kwargs["bls_to_execution_changes"] = []
        if fork >= ForkName.deneb:
            body_kwargs["blob_kzg_commitments"] = (
                list(blobs_bundle[1]) if blobs_bundle is not None else []
            )
            if blobs_bundle is not None:
                # stash so publish can rebuild sidecars after signing;
                # slot-stamped so unpublished bundles (VC refusal, failover
                # to another BN) don't leak for the process lifetime
                self._produced_bundles[
                    tuple(bytes(c) for c in blobs_bundle[1])
                ] = (int(slot), blobs_bundle)
                horizon = int(slot) - 2 * spec.preset.SLOTS_PER_EPOCH
                for k in [
                    k for k, (s, _) in self._produced_bundles.items() if s < horizon
                ]:
                    del self._produced_bundles[k]

        block = types.BeaconBlock.make(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=types.BeaconBlockBody.make(**body_kwargs),
        )
        trial = types.SignedBeaconBlock.make(message=block, signature=b"\x00" * 96)
        post = self._state_for_block(parent_root, slot)
        per_block_processing(
            post, trial, spec, types,
            strategy=SignatureStrategy.NO_VERIFICATION, verify_block_root=True,
        )
        return block.copy_with(state_root=types.BeaconState.hash_tree_root(post))

    def _request_el_payload(self, state, spec, types, fork, proposer: int,
                            parent_root: bytes | None = None):
        """fcU-with-attributes + getPayload against the EL for a block being
        produced on `state` (already advanced to the proposal slot)
        (execution_layer/src/lib.rs get_payload flow). Returns
        (ExecutionPayload, blobs_bundle | None)."""
        from ..state_transition.block import (
            compute_timestamp_at_slot,
            get_expected_withdrawals,
        )
        from ..types.spec import ForkName

        if parent_root is None:
            parent_root = self.head_root
        head_hash = self.payload_hash_by_block.get(parent_root, b"\x00" * 32)
        jc_root = self.fork_choice.store.justified_checkpoint[1]
        fc_root = self.fork_choice.store.finalized_checkpoint[1]
        withdrawals = None
        if fork >= ForkName.capella:
            withdrawals, _ = get_expected_withdrawals(state, spec, types)
        payload, bundle = self.execution_layer.produce_payload(
            types,
            head_payload_hash=head_hash,
            safe_hash=self.payload_hash_by_block.get(jc_root, b"\x00" * 32),
            finalized_hash=self.payload_hash_by_block.get(fc_root, b"\x00" * 32),
            timestamp=compute_timestamp_at_slot(state, spec, state.slot),
            prev_randao=acc.h.get_randao_mix(
                state, spec, acc.get_current_epoch(state, spec)
            ),
            fee_recipient=self.proposer_preparations.get(proposer),
            withdrawals=withdrawals,
            parent_beacon_block_root=parent_root if fork >= ForkName.deneb else None,
        )
        return payload, bundle

    def sidecars_for_produced_block(self, signed_block):
        """Build blob sidecars for a locally-produced block that was just
        signed, from the blobs bundle the EL returned at production time
        (publish_blocks.rs builds sidecars from cached payload contents).
        Returns [] when the block carries no commitments or no bundle is
        stashed (e.g. produced without an EL)."""
        from .data_availability import build_sidecars

        body = signed_block.message.body
        commitments = tuple(
            bytes(c) for c in getattr(body, "blob_kzg_commitments", ())
        )
        if not commitments:
            return []
        # NON-destructive lookup: a failed import must be retryable with
        # the same bundle (slot-horizon pruning in produce_block bounds the
        # stash instead)
        entry = self._produced_bundles.get(commitments)
        if entry is None:
            return []
        _, (blobs, _, proofs) = entry
        types = types_for_slot(self.spec, signed_block.message.slot)
        return build_sidecars(types, self.spec, signed_block, blobs, proofs)

    def apply_attestation_to_fork_choice(self, att, attesting_indices):
        self.fork_choice.on_attestation(
            att.data.slot,
            attesting_indices,
            bytes(att.data.beacon_block_root),
            att.data.target.epoch,
        )
