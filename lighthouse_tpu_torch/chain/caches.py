"""Beacon-chain auxiliary caches (the §2.2 set the reference treats as
first-class components).

- ObservedSlashable — per-(proposer, slot) and per-(attester, target) record
  of WHAT was signed, so a second, different message is recognized as an
  equivocation and turned into slasher feed + gossip evidence
  (lighthouse/beacon_node/beacon_chain/src/observed_slashable.rs,
  observed_operations.rs). The plain observed_* dedup sets only answer
  "seen before?" — this answers "seen a CONFLICTING one?".
- BlockTimesCache — gossip-arrival/import/head timestamps per root, the
  observability + re-org-decision feed (block_times_cache.rs).
- EarlyAttesterCache — serve attestation data for the block imported this
  slot, populated only when fork choice selected it as head
  (early_attester_cache.rs).
- AttesterCache — the minimal (justified, target) data needed to serve
  attestation_data without holding a full state (attester_cache.rs).
- StateLRU — bounded promise-style state cache with insertion-order
  eviction (store/state_cache.rs analog for the in-chain map).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field


class ObservedSlashable:
    """Record signed roots; return the CONFLICTING prior root on equivocation."""

    def __init__(self, capacity: int = 8192):
        self._proposals: OrderedDict[tuple[int, int], bytes] = OrderedDict()
        self._attestations: OrderedDict[tuple[int, int], bytes] = OrderedDict()
        self.capacity = capacity

    def _put(self, store: OrderedDict, key, root: bytes):
        store[key] = root
        while len(store) > self.capacity:
            store.popitem(last=False)

    def peek_proposal(self, proposer: int, slot: int, block_root: bytes) -> bytes | None:
        """Prior DIFFERENT root for (proposer, slot), WITHOUT recording —
        equivocation must only be judged against VERIFIED proposals, and a
        proposal must only be recorded after its signature checks out
        (otherwise garbage-signed spam poisons the cache and gets the
        honest block rejected)."""
        prev = self._proposals.get((proposer, slot))
        return prev if prev is not None and prev != block_root else None

    def record_proposal(self, proposer: int, slot: int, block_root: bytes) -> None:
        key = (proposer, slot)
        if key not in self._proposals:
            self._put(self._proposals, key, block_root)

    def observe_proposal(self, proposer: int, slot: int, block_root: bytes) -> bytes | None:
        """peek + record in one step (callers that verify first)."""
        prior = self.peek_proposal(proposer, slot, block_root)
        if prior is None:
            self.record_proposal(proposer, slot, block_root)
        return prior

    def observe_attestation(self, validator: int, target_epoch: int, data_root: bytes) -> bytes | None:
        key = (validator, target_epoch)
        prev = self._attestations.get(key)
        if prev is None:
            self._put(self._attestations, key, data_root)
            return None
        return prev if prev != data_root else None

    def prune(self, finalized_epoch: int, slots_per_epoch: int) -> None:
        cut = finalized_epoch * slots_per_epoch
        for k in [k for k in self._proposals if k[1] < cut]:
            del self._proposals[k]
        for k in [k for k in self._attestations if k[1] < finalized_epoch]:
            del self._attestations[k]


@dataclass
class BlockTimes:
    seen_at: float | None = None          # gossip arrival
    imported_at: float | None = None
    became_head_at: float | None = None


class BlockTimesCache:
    """Arrival/import/head latency per block root (block_times_cache.rs)."""

    def __init__(self, capacity: int = 128, now_fn=time.monotonic):
        self._map: OrderedDict[bytes, BlockTimes] = OrderedDict()
        self.capacity = capacity
        self._now = now_fn

    def _entry(self, root: bytes) -> BlockTimes:
        e = self._map.get(root)
        if e is None:
            e = BlockTimes()
            self._map[root] = e
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)
        return e

    def observed(self, root: bytes) -> None:
        e = self._entry(root)
        if e.seen_at is None:
            e.seen_at = self._now()

    def imported(self, root: bytes) -> None:
        self._entry(root).imported_at = self._now()

    def became_head(self, root: bytes) -> None:
        self._entry(root).became_head_at = self._now()

    def import_delay(self, root: bytes) -> float | None:
        e = self._map.get(root)
        if e is None or e.seen_at is None or e.imported_at is None:
            return None
        return e.imported_at - e.seen_at

    def head_delay(self, root: bytes) -> float | None:
        e = self._map.get(root)
        if e is None or e.seen_at is None or e.became_head_at is None:
            return None
        return e.became_head_at - e.seen_at


@dataclass
class AttesterData:
    """Everything needed to serve attestation_data for one (slot, index)."""

    beacon_block_root: bytes
    parent_root: bytes
    source_epoch: int
    source_root: bytes
    target_epoch: int
    target_root: bytes


class EarlyAttesterCache:
    """Serve attestations for the block imported THIS slot
    (early_attester_cache.rs). Populated only when fork choice selected the
    imported block as head (beacon_chain.rs `new_head_root == block_root`),
    and served only while that block is still the head — an imported fork
    block that LOST fork choice must not hijack attestation data."""

    def __init__(self):
        self._item: tuple[int, AttesterData] | None = None   # (slot, data)

    def add(self, slot: int, data: AttesterData) -> None:
        self._item = (slot, data)

    def try_attest(self, slot: int, head_root: bytes) -> AttesterData | None:
        if self._item is None or self._item[0] != slot:
            return None
        data = self._item[1]
        if data.beacon_block_root == head_root:
            return data
        return None


class AttesterCache:
    """(epoch, decision_root) -> (source checkpoint, target root) — attest
    without holding the full state (attester_cache.rs)."""

    def __init__(self, capacity: int = 16):
        self._map: OrderedDict[tuple[int, bytes], tuple] = OrderedDict()
        self.capacity = capacity

    def put(self, epoch: int, decision_root: bytes, source, target_root: bytes) -> None:
        self._map[(epoch, decision_root)] = (source, target_root)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def get(self, epoch: int, decision_root: bytes):
        return self._map.get((epoch, decision_root))


class StateLRU:
    """Bounded state map with LRU eviction + per-root build promises so
    concurrent requests for the same state compute it once
    (shuffling_cache.rs promise idiom applied to states)."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._map: OrderedDict[bytes, object] = OrderedDict()
        self._building: dict[bytes, threading.Event] = {}
        self._lock = threading.Lock()

    def __contains__(self, root: bytes) -> bool:
        with self._lock:
            return root in self._map

    def get(self, root: bytes):
        with self._lock:
            st = self._map.get(root)
            if st is not None:
                self._map.move_to_end(root)
            return st

    def __getitem__(self, root: bytes):
        st = self.get(root)
        if st is None:
            raise KeyError(root.hex()[:16])
        return st

    def __setitem__(self, root: bytes, state) -> None:
        with self._lock:
            self._map[root] = state
            self._map.move_to_end(root)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def get_or_build(self, root: bytes, build):
        """Return the cached state or build it ONCE across threads."""
        while True:
            with self._lock:
                st = self._map.get(root)
                if st is not None:
                    self._map.move_to_end(root)
                    return st
                ev = self._building.get(root)
                if ev is None:
                    ev = threading.Event()
                    self._building[root] = ev
                    break
            ev.wait()
        try:
            st = build()
            self[root] = st
            return st
        finally:
            with self._lock:
                ev2 = self._building.pop(root, None)
            if ev2 is not None:
                ev2.set()

    def values(self):
        with self._lock:
            return list(self._map.values())

    def items(self):
        with self._lock:
            return list(self._map.items())

    def __len__(self):
        with self._lock:
            return len(self._map)
