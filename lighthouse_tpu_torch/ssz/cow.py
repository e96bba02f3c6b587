"""Chunked copy-on-write vectors for the big per-validator state fields.

The reference holds `BeaconState` in milhouse persistent tree-backed
lists (consensus/types/src/beacon_state.rs:34) so that clones share
structure and rehashing touches only dirty subtrees. `CowList` is that
shape over plain Python values:

  - The spine is a list of fixed-size CHUNKS (plain Python lists).
    `clone()` copies the SPINE only (one pointer per chunk) and shares
    every chunk by reference — O(#chunks), not O(n) elements, and memory
    across K fork-choice heads is O(diffs).
  - An element write copies only the touched chunk (once per instance —
    the per-instance `_owned` set remembers which chunks are private)
    and records the chunk index in the per-instance `_dirty` set.
  - The dirty set IS the tree-hash diff. `cow_list_root` re-hashes each
    dirty chunk's subtree host-side (chunk height k = log2(leaves/chunk)
    hashes per chunk) and hands the dirty chunk indices straight to
    `tree_cache.update_levels` over the chunk-root SPINE with a base-k
    zero-hash offset — no O(n) leaf marshal, no O(n) snapshot diff, and
    the retained hash state is chunk roots + spine (~1 MB at 1M
    validators) instead of the ring's full leaf plane (>= 32 MB).

Chunk sizing: CHUNK_LEAVES = 64 leaves per chunk — 64 validators, 256
uint64s, or 2048 participation bytes. Small enough that one touched
validator re-hashes 63 spare leaves (~63 sha256, microseconds), large
enough that the 1M-validator spine is 16384 pointers (a clone is ~100 us
and the spine tree adds only +14 levels above the chunk roots).

Correctness basis: a binary merkle tree over 2**depth leaves factors
exactly at any power-of-two chunk width — per-chunk subtrees of height k
(zero-leaf padding of the partial last chunk is identical to merkleize's
zero-chunk padding) under a spine whose zero padding at level d is
ZERO_HASHES[k + d]. Parity vs `uncached_state_root` ground truth is
pinned in tests/test_cow.py."""

from __future__ import annotations

import os
import weakref

import numpy as np

from ..utils.metrics import REGISTRY
from .core import ZERO_HASHES, Uint, _TREE_CACHE_MIN, boolean, next_pow2
from .tree_cache import (
    ROOT_TOTAL,
    SNAPSHOT_BYTES,
    _hash_level_full,
    update_levels,
)

# ------------------------------------------------------------------ metrics
# state_cow_* series are labeled families (scripts/lint_metrics.py
# enforces it): per-field breakdown is the whole point — "which state
# field is churning chunks" is the question a regression needs answered.

_CHUNK_COPIES = REGISTRY.counter_vec(
    "state_cow_chunk_copies_total",
    "chunks privatized by copy-on-write element writes, by state field "
    "(one count per chunk actually copied, not per element write)",
    ("field",),
)
_CHUNK_REHASH = REGISTRY.counter_vec(
    "state_cow_chunk_rehash_total",
    "dirty chunk subtrees re-hashed by the incremental CoW root path, by "
    "state field — the O(changed-chunks) assertion counter",
    ("field",),
)
_SHARED_CHUNKS = REGISTRY.gauge_vec(
    "state_cow_shared_chunks",
    "chunks of the most recently cloned/hashed CowList still shared with "
    "other instances (not privatized by this one), by state field",
    ("field",),
)
_OWNED_CHUNKS = REGISTRY.gauge_vec(
    "state_cow_owned_chunks",
    "chunks privatized (exclusively owned) by the most recently "
    "cloned/hashed CowList instance, by state field",
    ("field",),
)

#: 32-byte leaves per chunk; must be a power of two (the merkle tree only
#: factors into whole subtrees at pow2 boundaries)
CHUNK_LEAVES = 64

_COW_MIN_DEFAULT = 4096


def cow_min_len() -> int:
    """Plain lists at least this long are adopted into CowLists by
    clone_state; <= 0 disables adoption (LIGHTHOUSE_TPU_COW_MIN)."""
    raw = os.environ.get("LIGHTHOUSE_TPU_COW_MIN", "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass  # malformed env falls through to the default
    return _COW_MIN_DEFAULT


def _basic_info(element):
    """(elements_per_leaf, byte_size) for elements core._pack_basic packs
    into shared leaves; None for elements hashed one leaf per element."""
    if isinstance(element, Uint) and element.byte_len in (1, 2, 4, 8):
        return 32 // element.byte_len, element.byte_len
    if element is boolean:
        return 32, 1
    return None


def cow_chunk_elems(list_type) -> int | None:
    """Elements per chunk for a List type eligible for CowList backing,
    or None. Eligible: small basic elements (packed leaves) and Container
    elements (memoized one-leaf roots). Big uints (uint128/256) pack two
    or one per leaf through a different path and stay plain."""
    binfo = _basic_info(list_type.element)
    if binfo is not None:
        return CHUNK_LEAVES * binfo[0]
    from .core import Container

    if isinstance(list_type.element, Container):
        return CHUNK_LEAVES
    return None


class _CowTree:
    """One immutable hash state, shared by reference across clones: the
    chunk-root plane + the spine levels above it. No leaf plane — that is
    the memory win over the snapshot ring."""

    __slots__ = ("chunk_roots", "spine_levels", "root", "n_elems", "depth",
                 "k", "__weakref__")

    def __init__(self, chunk_roots, spine_levels, root, n_elems, depth, k):
        self.chunk_roots = chunk_roots    # (n_chunks, 32) uint8
        self.spine_levels = spine_levels  # [(ceil(n_chunks/2^i), 32)] i=1..
        self.root = root                  # bytes (pre mix-in-length)
        self.n_elems = n_elems
        self.depth = depth
        self.k = k
        _track_tree_bytes(self)

    def nbytes(self) -> int:
        return self.chunk_roots.nbytes + sum(
            l.nbytes for l in self.spine_levels if l is not None
        )


_tree_bytes = {"total": 0}


def _untrack_tree_bytes(nb: int) -> None:
    _tree_bytes["total"] -= nb
    SNAPSHOT_BYTES.labels("cow").set(_tree_bytes["total"])


def _track_tree_bytes(tree: _CowTree) -> None:
    nb = tree.nbytes()
    _tree_bytes["total"] += nb
    SNAPSHOT_BYTES.labels("cow").set(_tree_bytes["total"])
    weakref.finalize(tree, _untrack_tree_bytes, nb)


class CowList:
    """A list-alike over shared fixed-size chunks. Semantics match a
    plain Python list for the operations the state transition uses
    (len/index/assign/iterate/append/extend/==); structure-changing ops
    (insert/delete) fall back to a full re-chunk — correct, O(n), and
    absent from the hot paths.

    The write protocol is the contract everything else rides on: an
    element write privatizes the touched chunk (unless this instance
    already owns it) and records its index in `_dirty` — the set of
    chunks changed since `_tree` (the shared hash state) was computed."""

    __slots__ = ("_chunks", "_len", "_chunk_elems", "_owned", "_dirty",
                 "_tree", "name", "__weakref__")

    def __init__(self, iterable=(), chunk_elems: int = 256,
                 name: str = "anon"):
        if chunk_elems < 1:
            raise ValueError("chunk_elems must be positive")
        self._chunk_elems = int(chunk_elems)
        self._chunks: list[list] = []
        self._len = 0
        self._owned: set[int] = set()
        self._dirty: set[int] = set()
        self._tree: _CowTree | None = None
        self.name = name
        if iterable:
            self._init_chunks(list(iterable))

    def _init_chunks(self, items: list) -> None:
        ce = self._chunk_elems
        self._chunks = [items[i : i + ce] for i in range(0, len(items), ce)]
        self._len = len(items)
        # freshly sliced chunks are private by construction
        self._owned = set(range(len(self._chunks)))
        self._dirty = set(range(len(self._chunks)))
        self._tree = None

    # ------------------------------------------------------------ builders

    @classmethod
    def from_list(cls, items: list, chunk_elems: int, name: str = "anon"):
        return cls(items, chunk_elems=chunk_elems, name=name)

    @classmethod
    def filled(cls, value, n: int, chunk_elems: int, name: str = "anon"):
        """n copies of an immutable `value`, sharing ONE aliased full
        chunk across the whole spine — O(#chunks) to build. Aliased
        chunks are never owned, so the first write to any of them copies
        first (the CoW protocol protects aliases exactly like clones)."""
        self = cls(chunk_elems=chunk_elems, name=name)
        ce = self._chunk_elems
        full, tail = divmod(n, ce)
        if full:
            shared = [value] * ce
            self._chunks = [shared] * full
        if tail:
            self._chunks.append([value] * tail)
            self._owned.add(len(self._chunks) - 1)
        self._len = n
        self._dirty = set(range(len(self._chunks)))
        return self

    # ------------------------------------------------------------- sequence

    def __len__(self) -> int:
        return self._len

    def _locate(self, i: int) -> tuple[int, int]:
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError("CowList index out of range")
        return divmod(i, self._chunk_elems)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._len))]
        c, off = self._locate(i)
        return self._chunks[c][off]

    def __setitem__(self, i, value) -> None:
        if isinstance(i, slice):
            idxs = range(*i.indices(self._len))
            values = list(value)
            if len(idxs) != len(values):
                raise ValueError("CowList slice assignment must preserve length")
            for j, v in zip(idxs, values):
                self[j] = v
            return
        c, off = self._locate(i)
        if c not in self._owned:
            self._chunks[c] = list(self._chunks[c])
            self._owned.add(c)
            _CHUNK_COPIES.labels(self.name).inc()
        self._chunks[c][off] = value
        self._dirty.add(c)

    def __iter__(self):
        for chunk in self._chunks:
            yield from chunk

    def __eq__(self, other):
        if other is self:
            return True
        if not isinstance(other, (list, tuple, CowList)):
            return NotImplemented
        if len(other) != self._len:
            return False
        return all(a == b for a, b in zip(self, other))

    __hash__ = None

    def __repr__(self) -> str:
        return (
            f"CowList(name={self.name!r}, len={self._len}, "
            f"chunks={len(self._chunks)}, owned={len(self._owned)}, "
            f"dirty={len(self._dirty)})"
        )

    def append(self, value) -> None:
        ce = self._chunk_elems
        if self._len % ce == 0:
            self._chunks.append([value])
            c = len(self._chunks) - 1
            self._owned.add(c)
        else:
            c = len(self._chunks) - 1
            if c not in self._owned:
                self._chunks[c] = list(self._chunks[c])
                self._owned.add(c)
                _CHUNK_COPIES.labels(self.name).inc()
            self._chunks[c].append(value)
        self._dirty.add(c)
        self._len += 1

    def extend(self, iterable) -> None:
        for v in iterable:
            self.append(v)

    def _rechunk(self, items: list) -> None:
        """Structure-changing fallback (insert/delete): full re-chunk.
        O(n), correct, and not on any hot path."""
        self._init_chunks(items)

    def insert(self, i: int, value) -> None:
        items = self.to_list()
        items.insert(i, value)
        self._rechunk(items)

    def pop(self, i: int = -1):
        items = self.to_list()
        v = items.pop(i)
        self._rechunk(items)
        return v

    def __delitem__(self, i) -> None:
        items = self.to_list()
        del items[i]
        self._rechunk(items)

    def to_list(self) -> list:
        out = []
        for chunk in self._chunks:
            out.extend(chunk)
        return out

    def to_numpy(self, dtype) -> np.ndarray:
        """Chunk-wise conversion (the epoch-vector marshal path): one
        asarray per chunk, no per-element Python iteration at the top."""
        out = np.empty(self._len, dtype=dtype)
        lo = 0
        for chunk in self._chunks:
            out[lo : lo + len(chunk)] = np.asarray(chunk, dtype=dtype)
            lo += len(chunk)
        return out

    # ----------------------------------------------------------------- cow

    def clone(self) -> "CowList":
        """O(#chunks) structural-sharing clone: fresh spine, shared
        chunks, shared hash state. Both sides lose chunk ownership (every
        chunk is now shared), so the next write on either copies first."""
        new = CowList.__new__(CowList)
        new._chunks = list(self._chunks)
        new._len = self._len
        new._chunk_elems = self._chunk_elems
        new._owned = set()
        new._dirty = set(self._dirty)
        new._tree = self._tree
        new.name = self.name
        self._owned.clear()
        self._refresh_share_gauges()
        return new

    def rebuild_from(self, items: list) -> "CowList":
        """A new CowList over `items` sharing every UNCHANGED chunk with
        this instance (chunk-wise list compares — CPython's identity
        fast path makes unchanged object spans pointer-speed) and
        carrying this instance's hash state with only the changed chunks
        added to the dirty set. The epoch transition flattens to plain
        lists, runs its scalar spec loops at full speed, and restores
        the chunked backing through here — so a post-epoch root is still
        incremental over whatever the epoch left untouched."""
        ce = self._chunk_elems
        new = CowList.__new__(CowList)
        new._chunk_elems = ce
        new._len = len(items)
        new.name = self.name
        if len(items) != self._len:
            new._chunks = [items[i : i + ce]
                           for i in range(0, len(items), ce)]
            new._owned = set(range(len(new._chunks)))
            new._dirty = set(range(len(new._chunks)))
            new._tree = None
            return new
        chunks: list[list] = []
        owned: set[int] = set()
        dirty = set(self._dirty)
        for c, old in enumerate(self._chunks):
            lo = c * ce
            piece = items[lo : lo + len(old)]
            if piece == old:
                chunks.append(old)
            else:
                chunks.append(piece)
                owned.add(c)
                dirty.add(c)
        new._chunks = chunks
        new._owned = owned
        new._dirty = dirty
        new._tree = self._tree
        return new

    def shared_chunk_stats(self) -> dict:
        """{"chunks", "owned", "shared"} for this instance — the
        fork-fanout O(diffs) assertion reads these."""
        n_chunks = len(self._chunks)
        owned = len(self._owned)
        return {"chunks": n_chunks, "owned": owned,
                "shared": n_chunks - owned}

    def _refresh_share_gauges(self) -> None:
        s = self.shared_chunk_stats()
        _SHARED_CHUNKS.labels(self.name).set(s["shared"])
        _OWNED_CHUNKS.labels(self.name).set(s["owned"])


def maybe_adopt(list_type, value, name: str):
    """CowList-ify a plain list when the field is eligible and big enough
    (clone_state's adoption point); anything else passes through."""
    if isinstance(value, CowList):
        return value
    threshold = cow_min_len()
    if threshold <= 0 or not isinstance(value, list) or len(value) < threshold:
        return value
    ce = cow_chunk_elems(list_type)
    if ce is None:
        return value
    return CowList.from_list(value, ce, name=name)


# ------------------------------------------------------------------ hashing


def _chunk_leaf_block(cow: CowList, c: int, element, binfo,
                      lpc: int) -> np.ndarray:
    """(lpc, 32) uint8 zero-padded leaf block of chunk `c` — identical
    bytes to the corresponding slice of core's flat leaf marshal."""
    chunk = cow._chunks[c]
    buf = np.zeros(lpc * 32, np.uint8)
    if binfo is not None:
        _, size = binfo
        data = np.asarray(chunk, dtype=f"<u{size}").view(np.uint8)
        buf[: data.shape[0]] = data
    else:
        blob = b"".join(element.hash_tree_root(v) for v in chunk)
        buf[: len(blob)] = np.frombuffer(blob, np.uint8)
    return buf.reshape(lpc, 32)


def _chunk_subtree_root(cow: CowList, c: int, element, binfo, lpc: int,
                        k: int) -> np.ndarray:
    """(32,) root of chunk c's height-k subtree (lpc - 1 host hashes)."""
    cur = _chunk_leaf_block(cow, c, element, binfo, lpc)
    for d in range(k):
        cur = _hash_level_full(cur, d)
    return cur[0]


def _marshal_leaves(cow: CowList, element, binfo, n_leaves: int) -> np.ndarray:
    """Flat (n_leaves, 32) leaf plane for a full build."""
    if binfo is not None:
        _, size = binfo
        flat = cow.to_numpy(f"<u{size}").view(np.uint8)
        buf = np.zeros(n_leaves * 32, np.uint8)
        buf[: flat.shape[0]] = flat
        return buf.reshape(n_leaves, 32)
    blob = b"".join(element.hash_tree_root(v) for v in cow)
    buf = np.zeros(n_leaves * 32, np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, np.uint8)
    return buf.reshape(n_leaves, 32)


def _host_ladder(leaves: np.ndarray, depth: int, min_level: int):
    """tree_cache._build's hashlib ladder without the router hop (the
    caller already asked the router once)."""
    levels = []
    cur = leaves
    for d in range(depth):
        cur = (
            _hash_level_full(cur, d)
            if cur.shape[0]
            else np.empty((0, 32), np.uint8)
        )
        levels.append(cur if d >= min_level else None)
    root = cur[0].tobytes() if depth else leaves[0].tobytes()
    return levels, root


def cow_list_root(list_type, cow: CowList):
    """Merkle root (pre mix-in-length) of a CowList-backed List value, or
    None when the generic core path should serve (ineligible element,
    misaligned chunking, or a tree too small to bother).

    Outcomes (tree_cache_root_total):
      hit    — hash state valid, no dirty chunks: cached root.
      update — re-hash each dirty chunk's subtree, then the spine paths
               through the dirty chunk indices (base-k zero hashes).
      build  — no/invalid hash state (first root, or length changed) or
               dirty fraction past the router's rebuild crossover: flat
               marshal + full ladder, device-routed with min_level=k-1 so
               only the chunk-root plane and spine transfer back.
    """
    element = list_type.element
    if isinstance(element, (Uint,)) and element.byte_len > 8:
        return None  # packed two-or-one per leaf by core, not one leaf each
    binfo = _basic_info(element)
    n = len(cow)
    if n == 0:
        return None
    if binfo is not None:
        epl, size = binfo
        limit_chunks = (list_type.limit * size + 31) // 32
        n_leaves = -(-n // epl)
        if cow._chunk_elems % epl:
            return None
    else:
        epl = 1
        limit_chunks = list_type.limit
        n_leaves = n
    if n_leaves < _TREE_CACHE_MIN:
        return None
    lpc = cow._chunk_elems // epl
    if lpc < 2 or lpc & (lpc - 1):
        return None  # chunk width must be a pow2 number of leaves
    k = lpc.bit_length() - 1
    depth = next_pow2(limit_chunks).bit_length() - 1
    if depth < k:
        return None

    tree = cow._tree
    valid = (
        tree is not None
        and tree.n_elems == n
        and tree.depth == depth
        and tree.k == k
    )
    if valid and not cow._dirty:
        ROOT_TOTAL.labels("hit").inc()
        return tree.root

    from ..torchhash.router import ROUTER

    spine_depth = depth - k
    if valid and not ROUTER.prefer_full_build(n_leaves, len(cow._dirty) * lpc):
        dirty = np.array(sorted(cow._dirty), dtype=np.int64)
        chunk_roots = tree.chunk_roots.copy()
        for c in dirty:
            chunk_roots[c] = _chunk_subtree_root(cow, int(c), element,
                                                 binfo, lpc, k)
        _CHUNK_REHASH.labels(cow.name).inc(int(dirty.size))
        spine_levels, root = update_levels(
            tree.spine_levels, chunk_roots, dirty, spine_depth, base=k
        )
        ROOT_TOTAL.labels("update").inc()
    else:
        marshalled = {}

        def leaves_cb():
            if "leaves" not in marshalled:
                marshalled["leaves"] = _marshal_leaves(cow, element, binfo,
                                                       n_leaves)
            return marshalled["leaves"]

        routed = ROUTER.maybe_build_levels(
            leaves_cb, depth, n_leaves=n_leaves, min_level=k - 1
        )
        if routed is not None:
            levels, root = routed
        else:
            levels, root = _host_ladder(leaves_cb(), depth, k - 1)
        chunk_roots = levels[k - 1]
        spine_levels = levels[k:]
        ROOT_TOTAL.labels("build").inc()

    cow._tree = _CowTree(chunk_roots, spine_levels, root, n, depth, k)
    cow._dirty = set()
    cow._refresh_share_gauges()
    return root


def cow_totals() -> dict:
    """Per-field snapshot of the CoW counters — loadgen reports and the
    O(changed-chunks) test assertions read the per-run delta."""
    return {
        "chunk_copies": {k[0]: c.value for k, c in _CHUNK_COPIES.children()},
        "chunk_rehash": {k[0]: c.value for k, c in _CHUNK_REHASH.children()},
    }
