"""Execution block-hash verification: keccak256(rlp(header)).

The consensus client cross-checks that a payload's `block_hash` really is
the hash of the execution block it claims to be — the one place
execution-style hashing (keccak + RLP + MPT roots) appears in the client
(lighthouse/beacon_node/execution_layer/src/block_hash.rs, keccak via
ethereum_hashing, triehash for the transactions/withdrawals roots).

Everything here is pure Python: keccak-f[1600] (tiny and cold — one hash
per imported block), canonical RLP, and the ordered Merkle-Patricia trie
root used for the transactionsRoot/withdrawalsRoot header fields."""

from __future__ import annotations

# ------------------------------------------------------------- keccak256

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_MASK = (1 << 64) - 1


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(a: list[list[int]]) -> None:
    for rnd in range(24):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for keccak-256
    a = [[0] * 5 for _ in range(5)]
    # pad10*1 with 0x01 domain (original keccak, as Ethereum uses). When
    # exactly ONE pad byte fits, the 0x01 and final 0x80 bits share it
    # (0x81) — appending both would emit a spurious extra block.
    rem = len(data) % rate
    if rem == rate - 1:
        padded = data + b"\x81"
    else:
        padded = data + b"\x01" + b"\x00" * (rate - rem - 2) + b"\x80"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            a[i % 5][i // 5] ^= lane
        _keccak_f(a)
    out = b""
    for i in range(4):  # 32 bytes = 4 lanes
        out += a[i % 5][i // 5].to_bytes(8, "little")
    return out


# ------------------------------------------------------------------ RLP


def rlp_encode(item) -> bytes:
    """Canonical RLP: bytes or (possibly nested) lists of bytes."""
    if isinstance(item, int):
        item = _int_bytes(item)
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _len_prefix(len(b), 0x80) + b
    payload = b"".join(rlp_encode(x) for x in item)
    return _len_prefix(len(payload), 0xC0) + payload


def _int_bytes(n: int) -> bytes:
    """RLP integer: big-endian, no leading zeros, empty for 0."""
    if n == 0:
        return b""
    return n.to_bytes((n.bit_length() + 7) // 8, "big")


def _len_prefix(n: int, base: int) -> bytes:
    if n < 56:
        return bytes([base + n])
    nb = _int_bytes(n)
    return bytes([base + 55 + len(nb)]) + nb


# ------------------------------------------------ ordered-list trie root

EMPTY_TRIE_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)


def _nibbles(key: bytes) -> list[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return out


def _hex_prefix(nibbles: list[int], leaf: bool) -> bytes:
    flag = 2 if leaf else 0
    if len(nibbles) % 2:
        data = [flag + 1] + nibbles
    else:
        data = [flag, 0] + nibbles
    out = bytearray()
    for i in range(0, len(data), 2):
        out.append((data[i] << 4) | data[i + 1])
    return bytes(out)


def _node_ref(encoded: bytes):
    return encoded if len(encoded) < 32 else keccak256(encoded)


def _trie_build(items: list[tuple[list[int], bytes]]):
    """RLP structure of the subtrie over (nibble-path, value) pairs."""
    if not items:
        return b""
    if len(items) == 1:
        path, value = items[0]
        return rlp_encode([_hex_prefix(path, leaf=True), value])
    # common prefix extension
    prefix = []
    while True:
        if any(not it[0][len(prefix):] for it in items):
            break
        nxt = items[0][0][len(prefix)] if items[0][0][len(prefix):] else None
        if nxt is None or any(
            it[0][len(prefix)] != nxt for it in items
        ):
            break
        prefix.append(nxt)
    if prefix:
        sub = _trie_build([(it[0][len(prefix):], it[1]) for it in items])
        return rlp_encode([_hex_prefix(prefix, leaf=False), _node_ref(sub)])
    # branch node
    children: list = [b""] * 17
    by_nibble: dict[int, list] = {}
    for path, value in items:
        if not path:
            children[16] = value
        else:
            by_nibble.setdefault(path[0], []).append((path[1:], value))
    for nib, subitems in by_nibble.items():
        sub = _trie_build(subitems)
        children[nib] = _node_ref(sub)
    return rlp_encode(children)


def ordered_trie_root(values: list[bytes]) -> bytes:
    """Root of the MPT keyed by rlp(index) — the transactionsRoot /
    withdrawalsRoot construction (triehash::ordered_trie_root)."""
    if not values:
        return EMPTY_TRIE_ROOT
    items = [(_nibbles(rlp_encode(i)), v) for i, v in enumerate(values)]
    encoded = _trie_build(items)
    return keccak256(encoded)


# ------------------------------------------------------- block hash check

EMPTY_OMMERS_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)


def _withdrawal_rlp(w) -> bytes:
    return rlp_encode([
        int(w.index), int(w.validator_index), bytes(w.address), int(w.amount)
    ])


def compute_block_hash(payload, parent_beacon_block_root: bytes | None = None) -> bytes:
    """keccak256(rlp(execution header)) reconstructed from an
    ExecutionPayload (block_hash.rs calculate_execution_block_hash)."""
    txs_root = ordered_trie_root([bytes(t) for t in payload.transactions])
    fields: list = [
        bytes(payload.parent_hash),
        EMPTY_OMMERS_HASH,
        bytes(payload.fee_recipient),
        bytes(payload.state_root),
        txs_root,
        bytes(payload.receipts_root),
        bytes(payload.logs_bloom),
        0,                                   # difficulty (post-merge: 0)
        int(payload.block_number),
        int(payload.gas_limit),
        int(payload.gas_used),
        int(payload.timestamp),
        bytes(payload.extra_data),
        bytes(payload.prev_randao),          # mixHash
        b"\x00" * 8,                         # nonce
        int(payload.base_fee_per_gas),
    ]
    if hasattr(payload, "withdrawals"):
        fields.append(
            ordered_trie_root([_withdrawal_rlp(w) for w in payload.withdrawals])
        )
    if hasattr(payload, "blob_gas_used"):
        fields.append(int(payload.blob_gas_used))
        fields.append(int(payload.excess_blob_gas))
        if parent_beacon_block_root is not None:
            fields.append(bytes(parent_beacon_block_root))
    return keccak256(rlp_encode(fields))


def verify_payload_block_hash(payload, parent_beacon_block_root: bytes | None = None) -> bool:
    return compute_block_hash(payload, parent_beacon_block_root) == bytes(
        payload.block_hash
    )
