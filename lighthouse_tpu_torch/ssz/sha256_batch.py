"""Vectorized batched SHA-256 for merkleization: the host lane and the
shared word arithmetic (the port's copy of lighthouse_tpu/ssz/sha256_batch.py).

Tree hashing dominates state-root computation (upstream Lighthouse leans
on SHA-NI assembly and lighthouse/consensus/cached_tree_hash for it). The
data-parallel form hashes every sibling pair of a tree level at once.

`compress` is the straight-line compression over an abstract array
namespace `xp` with native uint32 lanes (unsigned wraparound is SHA-256's
mod-2^32 word arithmetic), and the constants are plain-int tuples. The
host lane here runs it on numpy. The port's device lanes are
torchhash/csrc/sha256.cu, whose `__constant__` tables are generated from
these tuples, and their plain versions in torchhash/kernels.py, which hold
the words in int64 masked to 32 bits (CPU torch has no uint32 add or >>).

On the host CPU this does not beat hashlib's SHA-NI assembly (~0.5 us per
64-byte hash), so merkleize() keeps the hashlib ladder below the tree-hash
router's size threshold. Correctness against hashlib, multi-block messages
and the 64-byte padding edge included, is pinned in
tests/test_torch_sha256.py.
"""

from __future__ import annotations

import numpy as np

#: SHA-256 round constants / initial state, as plain ints: the single
#: source of the numpy lane's arrays and of the CUDA kernels' constant
#: tables (torchhash/kernels.py).
SHA256_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

SHA256_H0 = (
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
)

#: Padding block words for a 64-byte message (one merkle pair): 0x80 bit,
#: zeros, 512-bit length — every tree level appends exactly this block.
PAIR_PAD_WORDS = (0x80000000,) + (0,) * 14 + (512,)

_K32 = np.array(SHA256_K, dtype=np.uint32)
_H032 = np.array(SHA256_H0, dtype=np.uint32)
_PAIR_PAD32 = np.array(PAIR_PAD_WORDS, dtype=np.uint32)


def _rotr(x, n):
    return (x >> n) | (x << (32 - n))


def schedule_word(w_m16, w_m15, w_m7, w_m2):
    """One message-schedule word: W[t] from W[t-16], W[t-15], W[t-7],
    W[t-2]. The numpy lane drives it with a Python loop (straight-line);
    csrc/sha256.cu restates it in registers."""
    s0 = _rotr(w_m15, 7) ^ _rotr(w_m15, 18) ^ (w_m15 >> 3)
    s1 = _rotr(w_m2, 17) ^ _rotr(w_m2, 19) ^ (w_m2 >> 10)
    return w_m16 + s0 + w_m7 + s1


def round_step(v, kt, wt):
    """One compression round over the 8-tuple of working variables —
    shared by both lane drivers like schedule_word."""
    a, b, c, d, e, f, g, h = v
    S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = (e & f) ^ (~e & g)
    t1 = h + S1 + ch + kt + wt
    S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    return (t1 + S0 + maj, a, b, c, d + t1, e, f, g)


def compress(state, w16, k, xp):
    """One SHA-256 compression over a batch of lanes (the straight-line
    driver over schedule_word/round_step).

    state: (8, ...) uint32, w16: (16, ...) uint32 message words, k: the
    (64,) uint32 round-constant array OF THE SAME NAMESPACE. `xp` is an
    array namespace with native uint32 lanes (numpy here): uint32
    wraparound IS the mod-2^32 word arithmetic."""
    w = [w16[t] for t in range(16)]
    for t in range(16, 64):
        w.append(schedule_word(w[t - 16], w[t - 15], w[t - 7], w[t - 2]))
    v = tuple(state[i] for i in range(8))
    for t in range(64):
        v = round_step(v, k[t], w[t])
    return xp.stack(v) + state


# ------------------------------------------------------ bytes <-> word lanes


def words_from_bytes(data: np.ndarray) -> np.ndarray:
    """(n, 4*w) uint8 big-endian bytes -> (n, w) uint32 words."""
    n = data.shape[0]
    b = data.reshape(n, -1, 4).astype(np.uint32)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def bytes_from_words(words: np.ndarray) -> np.ndarray:
    """(n, w) uint32 words -> (n, 4*w) uint8 big-endian bytes."""
    n, w = words.shape
    out = np.empty((n, 4 * w), dtype=np.uint8)
    for j in range(4):
        out[:, j::4] = (words >> np.uint32(24 - 8 * j)).astype(np.uint8)
    return out


def pad_blocks(length: int) -> bytes:
    """SHA-256 padding suffix for an `length`-byte message: 0x80, zeros to
    56 mod 64, 64-bit bit length. A message whose length is 0 mod 64 (the
    merkle-pair 64-byte edge included) gains a WHOLE extra block."""
    pad_zeros = (55 - length) % 64
    return b"\x80" + b"\x00" * pad_zeros + (8 * length).to_bytes(8, "big")


def sha256_msgs(msgs: np.ndarray) -> np.ndarray:
    """sha256 of n equal-length messages, vectorized on the host lane.

    msgs: (n, L) uint8. Returns (n, 32) uint8. Handles any L (multi-block
    messages included) — the general entry the hashlib-parity test matrix
    drives; `sha256_pairs` is the L=64 merkle fast path."""
    n, length = msgs.shape
    suffix = np.frombuffer(pad_blocks(length), np.uint8)
    padded = np.concatenate(
        [msgs, np.broadcast_to(suffix, (n, suffix.shape[0]))], axis=1
    )
    words = words_from_bytes(padded)                    # (n, 16*blocks)
    state = np.broadcast_to(_H032[:, None], (8, n)).copy()
    for blk in range(words.shape[1] // 16):
        w16 = words[:, 16 * blk : 16 * blk + 16].T.copy()   # (16, n)
        state = compress(state, w16, _K32, np)
    return bytes_from_words(state.T)


def sha256_pairs(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """sha256(left[i] || right[i]) for all i.

    left/right: (n, 32) uint8 arrays. Returns (n, 32) uint8."""
    n = left.shape[0]
    w16 = np.concatenate(
        [words_from_bytes(left), words_from_bytes(right)], axis=1
    ).T.copy()                                          # (16, n)
    state = np.broadcast_to(_H032[:, None], (8, n)).copy()
    state = compress(state, w16, _K32, np)
    pad = np.broadcast_to(_PAIR_PAD32[:, None], (16, n))
    state = compress(state, pad, _K32, np)
    return bytes_from_words(state.T)


def hash_level(layer: list[bytes], pad: bytes) -> list[bytes]:
    """Hash one merkle level (list of 32-byte chunks, odd tail padded)."""
    odd = len(layer) & 1
    if odd:
        layer = layer + [pad]
    arr = np.frombuffer(b"".join(layer), dtype=np.uint8).reshape(-1, 32)
    out = sha256_pairs(arr[0::2], arr[1::2])
    return [out[i].tobytes() for i in range(out.shape[0])]


# below this many pairs the numpy batch constant factor loses to hashlib
BATCH_THRESHOLD = 64
