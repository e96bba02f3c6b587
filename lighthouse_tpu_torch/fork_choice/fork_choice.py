"""ForkChoice — spec wrapper over the proto-array.

Parity surface: lighthouse/consensus/fork_choice/src/fork_choice.rs
(on_block :642, on_attestation :1037, get_head :468, queued attestations
:234) plus the BeaconForkChoiceStore checkpoint tracking
(beacon_node/beacon_chain/src/beacon_fork_choice_store.rs:423).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..types import helpers as h
from ..types.spec import ChainSpec
from ..state_transition import accessors as acc
from .proto_array import ExecutionStatus, ProtoArrayForkChoice


class ForkChoiceError(Exception):
    pass


@dataclass
class QueuedAttestation:
    slot: int
    attesting_indices: tuple[int, ...]
    block_root: bytes
    target_epoch: int


@dataclass
class ForkChoiceStore:
    """Checkpoint state the fork choice needs between calls."""

    current_slot: int
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    unrealized_justified_checkpoint: tuple[int, bytes]
    unrealized_finalized_checkpoint: tuple[int, bytes]
    justified_balances: list[int] = field(default_factory=list)


class ForkChoice:
    def __init__(self, spec: ChainSpec, anchor_root: bytes, anchor_slot: int, anchor_state):
        # Spec get_forkchoice_store: the anchor IS both the justified and
        # finalized checkpoint at startup (required for checkpoint sync,
        # where the state's own checkpoints reference pre-anchor blocks the
        # proto array will never contain).
        epoch = h.compute_epoch_at_slot(anchor_slot, spec)
        jc = (epoch, anchor_root)
        fc = (epoch, anchor_root)
        self.spec = spec
        self.proto = ProtoArrayForkChoice(
            anchor_root, anchor_slot, jc, fc,
            slots_per_epoch=spec.preset.SLOTS_PER_EPOCH,
        )
        self.store = ForkChoiceStore(
            current_slot=anchor_slot,
            justified_checkpoint=jc,
            finalized_checkpoint=fc,
            unrealized_justified_checkpoint=jc,
            unrealized_finalized_checkpoint=fc,
            justified_balances=[
                v.effective_balance
                for v in anchor_state.validators
                if h.is_active_validator(v, epoch)
            ],
        )
        self._queued: list[QueuedAttestation] = []
        self._balances_by_root: dict[bytes, list[int]] = {
            anchor_root: list(self.store.justified_balances)
        }

    # ---------------------------------------------------------------- ticks

    def on_tick(self, slot: int):
        prev = self.store.current_slot
        self.store.current_slot = max(prev, slot)
        if slot > prev:
            # new slot: clear proposer boost
            self.proto.set_proposer_boost(b"\x00" * 32)
        if slot % self.spec.preset.SLOTS_PER_EPOCH == 0:
            # pull up unrealized checkpoints at epoch boundary
            if self.store.unrealized_justified_checkpoint[0] > self.store.justified_checkpoint[0]:
                self._update_justified(self.store.unrealized_justified_checkpoint)
            if self.store.unrealized_finalized_checkpoint[0] > self.store.finalized_checkpoint[0]:
                self.store.finalized_checkpoint = self.store.unrealized_finalized_checkpoint
        self._process_queued()

    # ---------------------------------------------------------------- blocks

    def on_block(self, signed_block, block_root: bytes, state, is_timely: bool = False):
        """Register an imported block. `state` is the post-state."""
        spec = self.spec
        block = signed_block.message
        if block.slot > self.store.current_slot:
            raise ForkChoiceError("block from the future")
        jc = (
            state.current_justified_checkpoint.epoch,
            bytes(state.current_justified_checkpoint.root),
        )
        fc = (
            state.finalized_checkpoint.epoch,
            bytes(state.finalized_checkpoint.root),
        )
        # unrealized justification: what justification WOULD be after epoch
        # processing of this state (approximation: pending target weights).
        ujc, ufc = self._compute_unrealized(state, jc, fc)

        if ujc[0] > self.store.unrealized_justified_checkpoint[0]:
            self.store.unrealized_justified_checkpoint = ujc
        if ufc[0] > self.store.unrealized_finalized_checkpoint[0]:
            self.store.unrealized_finalized_checkpoint = ufc

        # realized checkpoint updates
        if jc[0] > self.store.justified_checkpoint[0]:
            self._update_justified(jc, state)
        if fc[0] > self.store.finalized_checkpoint[0]:
            self.store.finalized_checkpoint = fc

        epoch = h.compute_epoch_at_slot(block.slot, spec)
        self._balances_by_root[block_root] = [
            v.effective_balance
            for v in state.validators
            if h.is_active_validator(v, max(epoch, jc[0]))
        ]

        exec_hash = None
        exec_status = ExecutionStatus.irrelevant
        body = block.body
        if hasattr(body, "execution_payload"):
            ph = bytes(body.execution_payload.block_hash)
            if ph != b"\x00" * 32:
                exec_hash = ph
                exec_status = ExecutionStatus.optimistic

        self.proto.on_block(
            slot=block.slot,
            root=block_root,
            parent_root=bytes(block.parent_root),
            justified_checkpoint=jc,
            finalized_checkpoint=fc,
            unrealized_justified_checkpoint=ujc,
            unrealized_finalized_checkpoint=ufc,
            execution_block_hash=exec_hash,
            execution_status=exec_status,
            timely=bool(is_timely and block.slot == self.store.current_slot),
        )
        if is_timely and block.slot == self.store.current_slot:
            self.proto.set_proposer_boost(block_root)

    def _compute_unrealized(self, state, jc, fc):
        """Unrealized justification from current participation (altair+)."""
        spec = self.spec
        try:
            cur_epoch = acc.get_current_epoch(state, spec)
            if cur_epoch <= 1 or not hasattr(state, "current_epoch_participation"):
                return jc, fc
            total = acc.get_total_active_balance(state, spec)
            cur_target = acc.get_total_balance(
                state,
                spec,
                acc.get_unslashed_participating_indices(
                    state, spec, acc.TIMELY_TARGET_FLAG_INDEX, cur_epoch
                ),
            )
            prev_target = acc.get_total_balance(
                state,
                spec,
                acc.get_unslashed_participating_indices(
                    state, spec, acc.TIMELY_TARGET_FLAG_INDEX, acc.get_previous_epoch(state, spec)
                ),
            )
            ujc = jc
            ufc = fc
            if prev_target * 3 >= total * 2:
                prev_epoch = acc.get_previous_epoch(state, spec)
                root = acc.get_block_root(state, spec, prev_epoch)
                if (prev_epoch, root) != jc and prev_epoch > jc[0]:
                    ujc = (prev_epoch, root)
            if cur_target * 3 >= total * 2:
                root = acc.get_block_root(state, spec, cur_epoch)
                ujc = (cur_epoch, root)
            return ujc, ufc
        except Exception:
            return jc, fc

    def _update_justified(self, jc, state=None):
        self.store.justified_checkpoint = jc
        self.proto.justified_checkpoint = jc
        if state is not None:
            epoch = jc[0]
            self.store.justified_balances = [
                v.effective_balance
                for v in state.validators
                if h.is_active_validator(v, epoch)
            ]
        elif jc[1] in self._balances_by_root:
            self.store.justified_balances = list(self._balances_by_root[jc[1]])

    # ------------------------------------------------------------ attestations

    def on_attestation(self, slot, attesting_indices, block_root: bytes, target_epoch: int):
        """Apply (or queue) LMD votes from a verified attestation."""
        if slot >= self.store.current_slot:
            self._queued.append(
                QueuedAttestation(slot, tuple(attesting_indices), block_root, target_epoch)
            )
            return
        for vi in attesting_indices:
            self.proto.process_attestation(vi, block_root, target_epoch)

    def _process_queued(self):
        ready = [q for q in self._queued if q.slot < self.store.current_slot]
        self._queued = [q for q in self._queued if q.slot >= self.store.current_slot]
        for q in ready:
            for vi in q.attesting_indices:
                self.proto.process_attestation(vi, q.block_root, q.target_epoch)

    # ---------------------------------------------------------------- head

    def get_head(self) -> bytes:
        jc = self.store.justified_checkpoint
        if jc[1] not in self.proto.index_by_root:
            raise ForkChoiceError("justified root unknown to proto array")
        total = sum(self.store.justified_balances)
        boost = (
            total
            // self.spec.preset.SLOTS_PER_EPOCH
            * self.spec.proposer_score_boost
            // 100
        )
        return self.proto.find_head(
            jc[1],
            new_balances=self.store.justified_balances,
            proposer_boost_amount=boost,
            current_epoch=self.store.current_slot // self.spec.preset.SLOTS_PER_EPOCH,
        )

    def get_proposer_head(self, head_root: bytes, proposal_slot: int) -> bytes:
        """Root the proposer should build on: the canonical head, or its
        PARENT when the head is a weak, late block that is safe to re-org
        out (fork_choice.rs:516 get_proposer_head + the re-org thresholds
        of proto_array_fork_choice.rs:192-357). Every guard must pass or
        the answer is the head:

          - single-slot re-org (head is exactly one slot behind) and the
            head itself did not skip a slot (proposer-shuffling stability)
          - the head block arrived LATE (not timely)
          - finalization is recent (no deep re-orgs during non-finality)
          - FFG-competitive: head and parent carry the same justification
          - the head subtree is weak (< reorg_head_weight_threshold % of a
            per-slot committee's weight) and the parent strong
            (>= reorg_parent_weight_threshold %)
        """
        spec = self.spec
        proto = self.proto
        i = proto.index_by_root.get(head_root)
        if i is None:
            return head_root
        node = proto.nodes[i]
        if node.parent is None:
            return head_root
        parent = proto.nodes[node.parent]
        if node.slot + 1 != proposal_slot or parent.slot + 1 != node.slot:
            return head_root
        if node.timely:
            return head_root
        cur_epoch = self.store.current_slot // spec.preset.SLOTS_PER_EPOCH
        if (
            cur_epoch - self.store.finalized_checkpoint[0]
            > spec.reorg_max_epochs_since_finalization
        ):
            return head_root
        if node.justified_checkpoint != parent.justified_checkpoint:
            return head_root
        total = sum(self.store.justified_balances)
        committee_weight = total // spec.preset.SLOTS_PER_EPOCH
        head_weight = proto.subtree_weight(head_root)
        parent_weight = proto.subtree_weight(parent.root)
        if head_weight * 100 >= committee_weight * spec.reorg_head_weight_threshold:
            return head_root
        if parent_weight * 100 < committee_weight * spec.reorg_parent_weight_threshold:
            return head_root
        return parent.root

    def prune(self):
        froot = self.store.finalized_checkpoint[1]
        if froot in self.proto.index_by_root:
            self.proto.prune(froot)
