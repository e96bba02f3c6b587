"""Incremental merkleization cache for large SSZ lists.

The reference's answer to state-root cost is structural: milhouse
persistent trees + cached_tree_hash recompute only the dirty paths
(lighthouse/consensus/cached_tree_hash/src/lib.rs:1,
 consensus/types/src/beacon_state.rs:34). This is the same idea expressed
over plain Python lists: a small ring of recently-merkleized (leaves,
levels) snapshots per list type; a new root request diffs its leaf array
against the closest snapshot (vectorized numpy compare) and re-hashes only
the changed root-paths — one block touches a handful of validators, so a
16k-validator re-root collapses from ~16k hashes to ~14 per changed leaf.

Leaves are (n, 32) uint8 arrays. The tree is virtual-depth: levels beyond
the real node count use ZERO_HASHES, so list limits in the 2**40 range
cost nothing.

Two consumers share the level machinery here:

  - `ListTreeCache` (this file) — plain Python lists, dirty set found by
    the O(n) snapshot diff.
  - `ssz/cow.py` — CowList-backed state fields, where the dirty set is
    RECORDED at write time and the per-level helpers run over the chunk
    SPINE. Spine nodes sit `base` levels above the leaf plane, so every
    helper takes a `base` zero-hash offset: padding at spine level d is
    the root of an all-zero subtree of height base+d, i.e.
    ZERO_HASHES[base + d]. base=0 keeps the historical behavior exactly.

Both paths count into `tree_cache_root_total{outcome}` (hit = snapshot
replay, update = dirty-path rehash, build = full ladder) and report
retained bytes in `tree_cache_snapshot_bytes{kind}`."""

from __future__ import annotations

import hashlib
from collections import deque

import numpy as np

from ..utils.metrics import REGISTRY
from .core import ZERO_HASHES

_sha = hashlib.sha256

_RING = 4

ROOT_TOTAL = REGISTRY.counter_vec(
    "tree_cache_root_total",
    "large-list tree-root requests by how they were served: hit = an "
    "unchanged snapshot/CoW root replayed, update = only the dirty "
    "root-paths re-hashed, build = full ladder (host or device)",
    ("outcome",),
)
SNAPSHOT_BYTES = REGISTRY.gauge_vec(
    "tree_cache_snapshot_bytes",
    "bytes retained by tree-hash caches: kind=ring is the snapshot ring "
    "(full leaves + levels per snapshot), kind=cow is the CowList hash "
    "state (chunk roots + spine only — no leaf plane)",
    ("kind",),
)


class _Snapshot:
    __slots__ = ("leaves", "levels", "root")

    def __init__(self, leaves, levels, root):
        self.leaves = leaves      # (n, 32) uint8
        self.levels = levels      # [level d] = (n_d, 32) uint8, d=1..depth
        self.root = root

    def nbytes(self) -> int:
        return self.leaves.nbytes + sum(
            l.nbytes for l in self.levels if l is not None
        )


def _hash_level_full(arr: np.ndarray, d: int, base: int = 0) -> np.ndarray:
    """All parent nodes of level-d array `arr` ((n,32) -> (ceil(n/2),32))."""
    n = arr.shape[0]
    odd = n & 1
    out = np.empty(((n + 1) // 2, 32), np.uint8)
    flat = arr.tobytes()
    zpad = ZERO_HASHES[base + d]
    for i in range(n // 2):
        out[i] = np.frombuffer(_sha(flat[64 * i : 64 * i + 64]).digest(), np.uint8)
    if odd:
        out[-1] = np.frombuffer(
            _sha(flat[-32:] + zpad).digest(), np.uint8
        )
    return out


def _build(leaves: np.ndarray, depth: int, min_level: int = 0):
    """Full ladder build. Levels below `min_level` come back as None (the
    CoW path only retains the spine — levels >= its chunk height — so the
    host ladder should not allocate what the caller immediately drops,
    and the device engine can skip their device->host transfers)."""
    if leaves.shape[0]:
        # full rebuilds of large lists are the device tree-hash engine's
        # workload (bn --hash-backend); the router returns levels in THIS
        # function's exact format (or None: the ladder below serves), so
        # the snapshot diff machinery works identically over device-built
        # levels — the dirty-path _update stays host (a handful of
        # hashes; a device round trip per touched node would lose)
        from ..torchhash.router import ROUTER

        routed = ROUTER.maybe_build_levels(leaves, depth, min_level=min_level)
        if routed is not None:
            return routed
    levels = []
    cur = leaves
    for d in range(depth):
        if cur.shape[0] == 0:
            cur = np.empty((0, 32), np.uint8)
        else:
            cur = _hash_level_full(cur, d)
        levels.append(cur if d >= min_level else None)
    if leaves.shape[0] == 0:
        root = ZERO_HASHES[depth]
    else:
        if depth:
            top = levels[-1] if levels[-1] is not None else cur
            root = top[0].tobytes()
        else:
            root = leaves[0].tobytes()
    return levels, root


def update_levels(prev_levels, leaves: np.ndarray, changed, depth: int,
                  base: int = 0):
    """Recompute only the paths through `changed` leaf indices, reusing
    `prev_levels` via copy-on-write of the touched rows; returns
    (levels, root). `base` offsets the zero-hash padding: pass the chunk
    height when `leaves` are CoW chunk roots rather than true leaves."""
    levels = []
    cur = leaves
    changed = np.asarray(changed, dtype=np.int64)
    idxs = np.unique(changed // 2)
    for d in range(depth):
        prev = prev_levels[d]
        n = cur.shape[0]
        n_parents = (n + 1) // 2
        if prev is None or prev.shape[0] != n_parents:
            # length changed (or level not retained): full rebuild from here
            rest_levels, root = _build_from(cur, d, depth, base=base)
            levels.extend(rest_levels)
            return levels, root
        lvl = prev.copy()
        zpad = ZERO_HASHES[base + d]
        for i in idxs:
            lo = 2 * i
            left = cur[lo].tobytes()
            right = cur[lo + 1].tobytes() if lo + 1 < n else zpad
            lvl[i] = np.frombuffer(_sha(left + right).digest(), np.uint8)
        levels.append(lvl)
        cur = lvl
        idxs = np.unique(idxs // 2)
    root = levels[-1][0].tobytes() if depth else leaves[0].tobytes()
    return levels, root


def _update(snap: _Snapshot, leaves: np.ndarray, changed: np.ndarray, depth: int):
    """Recompute only the paths through `changed` leaf indices. Reuses the
    snapshot's level arrays via copy-on-write of the touched rows."""
    return update_levels(snap.levels, leaves, changed, depth)


def _build_from(cur: np.ndarray, start_d: int, depth: int, base: int = 0):
    levels = []
    for d in range(start_d, depth):
        cur = (
            _hash_level_full(cur, d, base=base)
            if cur.shape[0]
            else np.empty((0, 32), np.uint8)
        )
        levels.append(cur)
    root = (
        levels[-1][0].tobytes()
        if levels and levels[-1].shape[0]
        else ZERO_HASHES[base + depth]
    )
    return levels, root


class ListTreeCache:
    """Per-list-type ring of snapshots; `root()` is the only entry."""

    def __init__(self):
        self._rings: dict[object, deque] = {}

    def _retained_bytes(self) -> int:
        return sum(
            snap.nbytes() for ring in self._rings.values() for snap in ring
        )

    def root(self, key, leaves: np.ndarray, depth: int) -> bytes:
        """Merkle root (pre mix-in-length) of `leaves` padded to 2**depth."""
        if leaves.shape[0] == 0:
            return ZERO_HASHES[depth]
        ring = self._rings.setdefault(key, deque(maxlen=_RING))
        best = None
        best_changed = None
        for snap in ring:
            if snap.leaves.shape != leaves.shape:
                continue
            diff = np.any(snap.leaves != leaves, axis=1)
            changed = np.flatnonzero(diff)
            if changed.size == 0:
                ring.remove(snap)
                ring.append(snap)      # keep hot
                ROOT_TOTAL.labels("hit").inc()
                return snap.root
            if best is None or changed.size < best_changed.size:
                best, best_changed = snap, changed
        if best is not None and best_changed.size <= max(64, leaves.shape[0] // 8):
            levels, root = _update(best, leaves, best_changed, depth)
            ROOT_TOTAL.labels("update").inc()
        else:
            levels, root = _build(leaves, depth)
            ROOT_TOTAL.labels("build").inc()
        ring.append(_Snapshot(leaves.copy(), levels, root))
        if self is GLOBAL_LIST_CACHE:
            SNAPSHOT_BYTES.labels("ring").set(self._retained_bytes())
        return root


GLOBAL_LIST_CACHE = ListTreeCache()


def root_outcome_totals() -> dict:
    """{"hit": n, "update": n, "build": n} snapshot of
    tree_cache_root_total — loadgen reports and the CoW tests read the
    per-run delta."""
    return {key[0]: child.value for key, child in ROOT_TOTAL.children()}
