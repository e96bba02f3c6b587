"""The device tree-hash engine: the merkle ladder of csrc/sha256.cu.

The port of lighthouse_tpu/jaxhash/engine.py for one H100. The leaf count
rounds up to a power-of-two bucket (`hash_bucket`, at least MIN_LEAVES,
padded with zero chunks), the whole ladder runs on the card
(kernels.sha256_ladder: one launch per level, every level in one buffer
allocated by the wrapper) and each dispatch rides a PipelinedDispatcher
(crypto/torchbls/pipeline.py), so concurrent tree hashes queue behind the
card as BLS batches do.

What the reference has and this engine does not: the mesh over the leaf
axis (`_mesh_for`, LIGHTHOUSE_TPU_HASH_MESH_MIN and the host tail above the
mesh's stop width) has no counterpart on one card, and neither has buffer
donation. The ladder's compile cache has none either: nvcc builds the
kernel once for every width.

The engine's device is the CUDA card (utils/torchcfg.resolve_device), so
without one it raises and the router's host ladder serves; `set_device`
pins another device, "cpu" running the kernels' plain versions (the tests).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from ..ssz.core import ZERO_HASHES, next_pow2
from ..ssz.sha256_batch import pad_blocks
from ..utils import torchcfg
from ..utils.metrics import REGISTRY
from . import kernels

_DEVICE_SECONDS = REGISTRY.histogram_vec(
    "torchhash_device_seconds",
    "wall time of one device hash dispatch (marshal through the host "
    "copy of its result), by op (tree_levels = the merkle ladder, "
    "epoch_deltas = the epoch vectors); the first dispatch of a process "
    "includes the kernels' build",
    ("op",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)
_MARSHALLED = REGISTRY.counter_vec(
    "torchhash_marshalled_bytes_total",
    "bytes packed for device upload by the tree-hash engine, by array "
    "family",
    ("array",),
)

#: smallest leaf bucket: below the router threshold the host serves
#: anyway, this only bounds the smallest ladder
MIN_LEAVES = 64

_state = {"device": None}
_dispatcher = None


def set_device(device) -> None:
    """Pin the device of the engine and of the epoch vectors ("cpu" runs
    the plain versions); None reverts to the CUDA card."""
    _state["device"] = device


def device() -> torch.device:
    """The device the engine runs on: the pinned one, else the card (raises
    without one: no silent CPU run)."""
    return torchcfg.resolve_device(_state["device"])


def _get_dispatcher():
    """The engine's PipelinedDispatcher, the device ledger's `tree_hash`
    tenant (lazy: it resolves its depth at construction)."""
    global _dispatcher
    if _dispatcher is None:
        from ..crypto.torchbls.pipeline import PipelinedDispatcher

        _dispatcher = PipelinedDispatcher(workload="tree_hash")
    return _dispatcher


def hash_bucket(n_leaves: int) -> int:
    """The leaf bucket: the next power of two (the ladder halves), at
    least MIN_LEAVES."""
    return max(MIN_LEAVES, next_pow2(max(1, n_leaves)))


def words_from_leaves(leaves: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 -> (n, 8) int32 holding the big-endian uint32 words
    (sha256_batch.words_from_bytes' words, swapped by numpy's byte-order
    view)."""
    be = np.ascontiguousarray(leaves, np.uint8).view(">u4").reshape(-1, 8)
    return be.astype(np.uint32).view(np.int32)


def leaves_from_words(words: np.ndarray) -> np.ndarray:
    """(n, 8) int32 words -> (n, 32) uint8, big-endian."""
    return words.view(np.uint32).astype(">u4").view(np.uint8).reshape(-1, 32)


class _LevelsHandle:
    """In-flight ladder dispatch; resolves to host word arrays. With
    `last_only` just the top level transfers (the root-only path must not
    copy levels it discards); `first` skips the transfers below that level
    index (None placeholders keep positions). The top level always
    transfers. The transferred levels go in one copy."""

    __slots__ = ("_levels", "_last_only", "_first")

    def __init__(self, levels, last_only=False, first=0):
        self._levels = levels
        self._last_only = last_only
        self._first = first

    def result(self):
        levels = self._levels
        last = len(levels) - 1
        first = last if self._last_only else min(self._first, last)
        host = torch.cat(levels[first:]).cpu().numpy()
        out, row = [], 0
        for i, lvl in enumerate(levels):
            if i < first:
                out.append(None)
                continue
            out.append(host[row:row + lvl.shape[0]])
            row += lvl.shape[0]
        self._levels = None
        return out[-1:] if self._last_only else out


def device_build_levels(leaves: np.ndarray, depth: int,
                        root_only: bool = False, min_level: int = 0):
    """(levels, root) for `leaves` ((n, 32) uint8, n >= 1) padded to
    2**depth, bit-identical to ssz/tree_cache._build: level d is the
    (ceil(n/2^(d+1)), 32) parent array, the list is `depth` long (virtual
    zero-hash levels included), the root is the top node. With
    `root_only=True` levels is None and only the top level transfers to
    the host. With `min_level` the levels below that index skip the
    transfer and come back as None.

    The card computes the padded power-of-two ladder (zero-chunk padding
    IS the SSZ zero-hash folding, so trimmed prefixes match the host
    builder exactly); the virtual depth above the bucket finishes on the
    host. Raises on device failure: the router owns the fallback."""
    n_real = int(leaves.shape[0])
    nb = hash_bucket(n_real)
    real_depth = nb.bit_length() - 1
    if depth < real_depth:
        raise ValueError(
            f"virtual depth {depth} below padded bucket depth {real_depth}"
        )
    t0 = time.perf_counter()
    dev = device()
    words = np.zeros((nb, 8), np.int32)
    words[:n_real] = words_from_leaves(leaves)
    _MARSHALLED.labels("leaves").inc(words.nbytes)
    placed = torch.from_numpy(words).to(dev)

    dev_levels = _get_dispatcher().submit(
        lambda: _LevelsHandle(kernels.sha256_ladder(placed), last_only=root_only,
                              first=min_level)
    ).result()

    if root_only:
        node = leaves_from_words(dev_levels[0])[0].tobytes()
        for d in range(real_depth, depth):
            node = hashlib.sha256(node + ZERO_HASHES[d]).digest()
        _DEVICE_SECONDS.labels("tree_levels").observe(time.perf_counter() - t0)
        return None, node

    levels = []
    cur_w = n_real
    for lvl_words in dev_levels:  # widths nb/2 ... 1
        cur_w = (cur_w + 1) // 2
        levels.append(None if lvl_words is None
                      else leaves_from_words(lvl_words)[:cur_w].copy())
    # the virtual zero-hash depth (1-element levels, like _build)
    node = levels[-1][0].tobytes()
    for d in range(real_depth, depth):
        node = hashlib.sha256(node + ZERO_HASHES[d]).digest()
        levels.append(np.frombuffer(node, np.uint8).reshape(1, 32).copy())
    _DEVICE_SECONDS.labels("tree_levels").observe(time.perf_counter() - t0)
    root = levels[-1][0].tobytes() if depth else leaves[0].tobytes()
    return levels, root


def warm_tree_bucket(n_leaves: int) -> float:
    """Run the ladder once for one leaf-count bucket (zero leaves through
    the full dispatch path; the first call of a process builds the
    kernels); returns the wall seconds."""
    t0 = time.time()
    nb = hash_bucket(max(1, n_leaves))
    leaves = np.zeros((min(n_leaves, nb), 32), np.uint8)
    device_build_levels(leaves, nb.bit_length() - 1, root_only=True)
    return time.time() - t0


# ---------------------------------------------------- device sha256 (tests)


def sha256_msgs_device(msgs: np.ndarray) -> np.ndarray:
    """SHA-256 of n equal-length messages ((n, L) uint8 -> (n, 32) uint8)
    on the engine's device (kernels.sha256_msgs), padded on the host as
    sha256_batch.sha256_msgs pads. Not a serving path: the hashlib-parity
    lane of the tests and chip_smoke.py."""
    out = kernels.sha256_msgs(torch.from_numpy(msg_words(msgs)).to(device()))
    return leaves_from_words(out.cpu().numpy())


def msg_words(msgs: np.ndarray) -> np.ndarray:
    """(n, L) uint8 messages -> (n, 16 * blocks) int32 words of the padded
    messages, the interchange of kernels.sha256_msgs."""
    n, length = msgs.shape
    suffix = np.frombuffer(pad_blocks(length), np.uint8)
    padded = np.concatenate(
        [msgs, np.broadcast_to(suffix, (n, suffix.shape[0]))], axis=1
    )
    return words_from_leaves(padded).reshape(n, -1)
