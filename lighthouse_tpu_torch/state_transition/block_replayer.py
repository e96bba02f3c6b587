"""BlockReplayer — re-apply a range of blocks onto a state.

Parity surface: lighthouse/consensus/state_processing/src/
block_replayer.rs:30 — used for historic state reconstruction from freezer
restore points and for replaying segments after checkpoint sync. Signature
verification defaults OFF (the blocks replayed are already finalized),
state-root verification configurable, with optional per-slot/per-block
hooks (the reference's pre/post-slot hooks used by the tree-hash cache).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..types.spec import ChainSpec
from .block import SignatureStrategy
from .slot import process_slots, state_transition, types_for_slot


@dataclass
class BlockReplayer:
    spec: ChainSpec
    state: object
    verify_signatures: bool = False
    verify_state_roots: bool = False
    pre_block_hook: object = None      # fn(state, block)
    post_block_hook: object = None
    state_root_iter: list | None = None  # known (slot, root) pairs to skip hashing

    blocks_applied: int = field(default=0)

    def apply_blocks(self, blocks, target_slot: int | None = None):
        """Apply blocks in order; optionally advance to target_slot after."""
        strategy = (
            SignatureStrategy.VERIFY_BULK
            if self.verify_signatures
            else SignatureStrategy.NO_VERIFICATION
        )
        for signed in blocks:
            if self.pre_block_hook is not None:
                self.pre_block_hook(self.state, signed)
            state_transition(
                self.state,
                signed,
                self.spec,
                strategy=strategy,
                verify_state_root=self.verify_state_roots,
            )
            self.blocks_applied += 1
            if self.post_block_hook is not None:
                self.post_block_hook(self.state, signed)
        if target_slot is not None and self.state.slot < target_slot:
            process_slots(self.state, self.spec, target_slot)
        return self.state


def reconstruct_state(store, spec: ChainSpec, restore_point_root: bytes, blocks, target_slot: int):
    """Freezer state reconstruction: load a restore point and replay blocks
    (store/src/reconstruct.rs analog)."""
    types = types_for_slot(spec, target_slot)
    base = store.get_restore_point_state(restore_point_root, types)
    if base is None:
        raise ValueError("restore point not found")
    replayer = BlockReplayer(spec=spec, state=base)
    return replayer.apply_blocks(blocks, target_slot=target_slot)
