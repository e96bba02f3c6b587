"""Proto-array fork choice: LMD-GHOST over flat arrays.

Parity surface: lighthouse/consensus/proto_array/src/
proto_array_fork_choice.rs (process_attestation :432, process_block :448,
find_head :463, proposer boost :192-357) and proto_array.rs.

Array-native design: nodes live in parallel numpy arrays (parent index,
weight, best child/descendant), and the two linear passes of find_head —
score changes applied leaf-to-root, then best-descendant propagation —
are plain vectorized/sequential array walks. This is the same flat-array
insight the reference uses (no pointer graph), which also keeps the door
open to device offload of the weight pass for very large trees.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

NONE = -1


class ExecutionStatus(Enum):
    irrelevant = "irrelevant"   # pre-merge
    optimistic = "optimistic"   # payload not yet verified by EL
    valid = "valid"
    invalid = "invalid"


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int | None
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    unrealized_justified_checkpoint: tuple[int, bytes] | None = None
    unrealized_finalized_checkpoint: tuple[int, bytes] | None = None
    execution_block_hash: bytes | None = None
    execution_status: ExecutionStatus = ExecutionStatus.irrelevant
    # arrived within the attestation deadline of its own slot — late blocks
    # are re-org candidates (proto_array_fork_choice.rs:192-357)
    timely: bool = True


@dataclass
class VoteTracker:
    current_root: bytes = b"\x00" * 32
    next_root: bytes = b"\x00" * 32
    next_epoch: int = 0


class ProtoArrayForkChoice:
    def __init__(
        self,
        finalized_root: bytes,
        finalized_slot: int,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        slots_per_epoch: int = 32,
    ):
        self.slots_per_epoch = slots_per_epoch
        self.nodes: list[ProtoNode] = []
        self.index_by_root: dict[bytes, int] = {}
        self.votes: list[VoteTracker] = []
        self.balances: list[int] = []
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.proposer_boost_root: bytes = b"\x00" * 32
        # arrays (resized on insert)
        self._weights = np.zeros(0, dtype=np.int64)
        self._best_child = np.full(0, NONE, dtype=np.int64)
        self._best_descendant = np.full(0, NONE, dtype=np.int64)
        self.on_block(
            slot=finalized_slot,
            root=finalized_root,
            parent_root=None,
            justified_checkpoint=justified_checkpoint,
            finalized_checkpoint=finalized_checkpoint,
        )

    # ---------------------------------------------------------------- blocks

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        justified_checkpoint: tuple[int, bytes],
        finalized_checkpoint: tuple[int, bytes],
        unrealized_justified_checkpoint=None,
        unrealized_finalized_checkpoint=None,
        execution_block_hash: bytes | None = None,
        execution_status: ExecutionStatus = ExecutionStatus.irrelevant,
        timely: bool = True,
    ) -> None:
        if root in self.index_by_root:
            return
        parent = self.index_by_root.get(parent_root) if parent_root else None
        idx = len(self.nodes)
        self.nodes.append(
            ProtoNode(
                slot=slot,
                root=root,
                parent=parent,
                justified_checkpoint=justified_checkpoint,
                finalized_checkpoint=finalized_checkpoint,
                unrealized_justified_checkpoint=unrealized_justified_checkpoint,
                unrealized_finalized_checkpoint=unrealized_finalized_checkpoint,
                execution_block_hash=execution_block_hash,
                execution_status=execution_status,
                timely=timely,
            )
        )
        self.index_by_root[root] = idx
        self._weights = np.append(self._weights, 0)
        self._best_child = np.append(self._best_child, NONE)
        self._best_descendant = np.append(self._best_descendant, NONE)

    # ---------------------------------------------------------------- votes

    def process_attestation(self, validator_index: int, block_root: bytes, target_epoch: int):
        while validator_index >= len(self.votes):
            self.votes.append(VoteTracker())
        vote = self.votes[validator_index]
        if target_epoch > vote.next_epoch or vote == VoteTracker():
            vote.next_root = block_root
            vote.next_epoch = target_epoch

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        a = self.index_by_root.get(ancestor_root)
        d = self.index_by_root.get(descendant_root)
        if a is None or d is None:
            return False
        a_slot = self.nodes[a].slot
        while d is not None and self.nodes[d].slot > a_slot:
            d = self.nodes[d].parent
        return d == a

    def ancestor_at_slot(self, root: bytes, slot: int) -> bytes | None:
        i = self.index_by_root.get(root)
        while i is not None and self.nodes[i].slot > slot:
            i = self.nodes[i].parent
        return self.nodes[i].root if i is not None else None

    # ---------------------------------------------------------------- head

    def set_proposer_boost(self, root: bytes) -> None:
        """Set the boost target for the current slot's timely block (cleared
        by passing the zero root)."""
        self.proposer_boost_root = root

    def _score_changes(self, new_balances: list[int], proposer_boost_amount: int):
        """Per-node weight deltas from vote movements + balance changes +
        proposer boost, like compute_deltas (proto_array_fork_choice.rs)."""
        deltas = np.zeros(len(self.nodes), dtype=np.int64)
        for i, vote in enumerate(self.votes):
            old_bal = self.balances[i] if i < len(self.balances) else 0
            new_bal = new_balances[i] if i < len(new_balances) else 0
            cur = self.index_by_root.get(vote.current_root)
            nxt = self.index_by_root.get(vote.next_root)
            if cur is not None:
                deltas[cur] -= old_bal
            if nxt is not None:
                deltas[nxt] += new_bal
                vote.current_root = vote.next_root
            elif vote.next_root == b"\x00" * 32:
                vote.current_root = vote.next_root
        # proposer boost: un-apply the previous boost, apply the current one
        if self._last_boost_root != b"\x00" * 32:
            old = self.index_by_root.get(self._last_boost_root)
            if old is not None:
                deltas[old] -= self._last_boost_amount
        if self.proposer_boost_root != b"\x00" * 32:
            new = self.index_by_root.get(self.proposer_boost_root)
            if new is not None:
                deltas[new] += proposer_boost_amount
        self._last_boost_root = self.proposer_boost_root
        self._last_boost_amount = proposer_boost_amount
        self.balances = list(new_balances)
        return deltas

    _last_boost_amount = 0
    _last_boost_root = b"\x00" * 32

    def _node_viable(self, idx: int, current_epoch: int | None = None) -> bool:
        """Spec filter_block_tree viability: the node's VOTING SOURCE (its
        unrealized justification for blocks from prior epochs, realized for
        current-epoch blocks) must match the store's justified epoch, with
        the 2-epoch lag tolerance; finalization must be consistent."""
        n = self.nodes[idx]
        if n.execution_status == ExecutionStatus.invalid:
            return False
        if current_epoch is None:
            current_epoch = self._current_epoch_hint
        block_epoch = n.slot // self.slots_per_epoch
        if block_epoch < current_epoch and n.unrealized_justified_checkpoint is not None:
            voting_source = n.unrealized_justified_checkpoint
        else:
            voting_source = n.justified_checkpoint
        ok_j = (
            self.justified_checkpoint[0] == 0
            or voting_source[0] == self.justified_checkpoint[0]
            or voting_source[0] + 2 >= current_epoch
        )
        fc = n.unrealized_finalized_checkpoint or n.finalized_checkpoint
        ok_f = self.finalized_checkpoint[0] == 0 or fc[0] >= self.finalized_checkpoint[0]
        return ok_j and ok_f

    _current_epoch_hint = 0

    def _viable_for_head(self, idx: int) -> bool:
        bd = self._best_descendant[idx]
        target = bd if bd != NONE else idx
        return self._node_viable(int(target))

    def find_head(
        self,
        justified_root: bytes,
        new_balances: list[int] | None = None,
        proposer_boost_amount: int = 0,
        current_epoch: int | None = None,
    ) -> bytes:
        if current_epoch is not None:
            self._current_epoch_hint = current_epoch
        if new_balances is None:
            new_balances = self.balances
        deltas = self._score_changes(new_balances, proposer_boost_amount)

        n = len(self.nodes)
        best_child = np.full(n, NONE, dtype=np.int64)
        best_descendant = np.full(n, NONE, dtype=np.int64)

        # per-node vote weights, then subtree totals in one leaf->root pass
        # (children always have higher indices than parents)
        self._weights = self._weights + deltas
        subtree = self._weights.copy()
        for i in range(n - 1, 0, -1):
            p = self.nodes[i].parent
            if p is not None:
                subtree[p] += subtree[i]

        # best child/descendant: single leaf->root pass
        for i in range(n - 1, 0, -1):
            p = self.nodes[i].parent
            if p is None:
                continue
            if not self._node_viable_with(best_descendant, i):
                continue
            bc = best_child[p]
            if bc == NONE:
                best_child[p] = i
            else:
                wi, wb = subtree[i], subtree[int(bc)]
                if (wi, self.nodes[i].root) > (wb, self.nodes[int(bc)].root):
                    best_child[p] = i
            bd_i = best_descendant[i] if best_descendant[i] != NONE else i
            if best_child[p] == i:
                best_descendant[p] = bd_i

        self._best_child = best_child
        self._best_descendant = best_descendant
        self._last_subtree = subtree          # for re-org weight queries

        j = self.index_by_root[justified_root]
        bd = best_descendant[j]
        head = int(bd) if bd != NONE else j
        return self.nodes[head].root

    def subtree_weight(self, root: bytes) -> int:
        """Subtree vote weight from the most recent find_head pass."""
        sub = getattr(self, "_last_subtree", None)
        i = self.index_by_root.get(root)
        if sub is None or i is None or i >= len(sub):
            return 0
        return int(sub[i])

    def _node_viable_with(self, best_descendant, idx: int) -> bool:
        bd = best_descendant[idx]
        target = int(bd) if bd != NONE else idx
        return self._node_viable(target)

    # -------------------------------------------------- execution status

    def on_valid_execution_payload(self, block_root: bytes):
        """Mark a block and all ancestors valid."""
        i = self.index_by_root.get(block_root)
        while i is not None:
            node = self.nodes[i]
            if node.execution_status == ExecutionStatus.optimistic:
                node.execution_status = ExecutionStatus.valid
            i = node.parent

    def on_invalid_execution_payload(self, block_root: bytes):
        """Mark a block and all descendants invalid."""
        bad = self.index_by_root.get(block_root)
        if bad is None:
            return
        self.nodes[bad].execution_status = ExecutionStatus.invalid
        for i in range(bad + 1, len(self.nodes)):
            p = self.nodes[i].parent
            if p is not None and self.nodes[p].execution_status == ExecutionStatus.invalid:
                self.nodes[i].execution_status = ExecutionStatus.invalid

    # -------------------------------------------------- pruning

    def prune(self, finalized_root: bytes) -> None:
        """Drop everything not descending from the new finalized root."""
        f = self.index_by_root.get(finalized_root)
        if f is None or f == 0:
            return
        keep = set()
        for i in range(len(self.nodes)):
            j = i
            while j is not None and j != f:
                j = self.nodes[j].parent
            if j == f:
                keep.add(i)
        remap: dict[int, int] = {}
        new_nodes = []
        for i in sorted(keep):
            remap[i] = len(new_nodes)
            new_nodes.append(self.nodes[i])
        for node in new_nodes:
            node.parent = remap.get(node.parent) if node.parent in remap else None
        self.nodes = new_nodes
        self.index_by_root = {n.root: i for i, n in enumerate(new_nodes)}
        old_weights = self._weights
        self._weights = np.array(
            [old_weights[i] for i in sorted(keep)], dtype=np.int64
        ) if len(keep) else np.zeros(0, np.int64)
        self._best_child = np.full(len(new_nodes), NONE, dtype=np.int64)
        self._best_descendant = np.full(len(new_nodes), NONE, dtype=np.int64)
