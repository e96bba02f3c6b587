"""SSZ (SimpleSerialize) — serialization + merkleization.

Covers the surface the reference consumes from the external `ethereum_ssz` /
`tree_hash` / `ssz_types` crates (SURVEY.md §2, L2): basic uints, booleans,
Bitvector/Bitlist, Vector/List, ByteVector/ByteList, containers, unions;
serialize/deserialize with offset encoding; hash_tree_root with zero-hash
padding, length mix-in and selector mix-in.

Types are *descriptor objects* (not subclass-per-instance like pyssz):
`List(uint64, 32)` builds a reusable descriptor; values are plain Python
ints/bools/bytes/lists and `Container` dataclass instances. That keeps
values cheap (no wrapper per element) — important because the state
transition manipulates million-element validator registries.

Merkleization is host-side hashlib SHA-256 (C speed) behind `Hasher`, an
explicit seam so subtree hashing can later be dispatched to a batched device
kernel for big states (SURVEY.md §2.4 ethereum_hashing row).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

# lists with at least this many 32-byte leaves go through the incremental
# tree cache (ssz/tree_cache.py); below it plain merkleize wins
_TREE_CACHE_MIN = 256

BYTES_PER_CHUNK = 32
OFFSET_BYTES = 4

_ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# zero_hashes[i] = root of an all-zero tree of depth i
_MAX_DEPTH = 64
ZERO_HASHES = [_ZERO_CHUNK]
for _ in range(_MAX_DEPTH):
    ZERO_HASHES.append(hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest())


def hash_pair(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    p = 1
    while p < n:
        p *= 2
    return p


def merkleize(chunks: Sequence[bytes], limit: int | None = None) -> bytes:
    """Merkleize 32-byte chunks, zero-padded to next_pow2(limit or count).

    Large chunk sets ask the tree-hash router first
    (LIGHTHOUSE_TPU_HASH_BACKEND): above its size threshold the device
    engine serves the root (bit-exact, lighthouse_tpu_torch/torchhash);
    the "host" backend and everything below the threshold keep this
    hashlib ladder."""
    count = len(chunks)
    if limit is not None and count > limit:
        raise ValueError(f"chunk count {count} exceeds limit {limit}")
    width = next_pow2(limit if limit is not None else count)
    depth = width.bit_length() - 1
    if count == 0:
        return ZERO_HASHES[depth]
    if count >= _TREE_CACHE_MIN:
        from ..torchhash.router import ROUTER

        root = ROUTER.maybe_tree_root(
            lambda: np.frombuffer(b"".join(chunks), np.uint8).reshape(-1, 32),
            depth, n_leaves=count,
        )
        if root is not None:
            return root
    layer = list(chunks)
    for d in range(depth):
        nxt = []
        odd = len(layer) & 1
        for i in range(0, len(layer) - odd, 2):
            nxt.append(hash_pair(layer[i], layer[i + 1]))
        if odd:
            nxt.append(hash_pair(layer[-1], ZERO_HASHES[d]))
        layer = nxt
    return layer[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_pair(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_pair(root, selector.to_bytes(32, "little"))


def pack_bytes(data: bytes) -> list[bytes]:
    """Pad bytes to a whole number of 32-byte chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [data[i : i + BYTES_PER_CHUNK] for i in range(0, len(data), BYTES_PER_CHUNK)]


# --------------------------------------------------------------------------
# type descriptors


class SSZType:
    """Base descriptor. Subclasses define is_fixed_size/fixed_size,
    serialize/deserialize, hash_tree_root, default."""

    def is_fixed_size(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


class Uint(SSZType):
    def __init__(self, byte_len: int):
        assert byte_len in (1, 2, 4, 8, 16, 32)
        self.byte_len = byte_len

    def __repr__(self):
        return f"uint{self.byte_len * 8}"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return self.byte_len

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.byte_len, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.byte_len:
            raise ValueError(f"uint{self.byte_len*8}: wrong length {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return self.serialize(value).ljust(32, b"\x00")

    def default(self):
        return 0


class Boolean(SSZType):
    def __repr__(self):
        return "boolean"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return 1

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("invalid boolean encoding")

    def hash_tree_root(self, value) -> bytes:
        return self.serialize(value).ljust(32, b"\x00")

    def default(self):
        return False


uint8 = Uint(1)
uint16 = Uint(2)
uint32 = Uint(4)
uint64 = Uint(8)
uint128 = Uint(16)
uint256 = Uint(32)
boolean = Boolean()
byte = uint8


class ByteVector(SSZType):
    """Fixed-length opaque bytes (Vector[byte, N] with bytes values)."""

    def __init__(self, length: int):
        self.length = length

    def __repr__(self):
        return f"ByteVector[{self.length}]"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return self.length

    def serialize(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)} bytes")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(data)} bytes")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)), (self.length + 31) // 32)

    def default(self):
        return b"\x00" * self.length


class ByteList(SSZType):
    """Variable-length opaque bytes (List[byte, N] with bytes values)."""

    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"ByteList[{self.limit}]"

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError("ByteList over limit")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = bytes(value)
        root = merkleize(pack_bytes(value), (self.limit + 31) // 32)
        return mix_in_length(root, len(value))

    def default(self):
        return b""


class Bitvector(SSZType):
    def __init__(self, length: int):
        assert length > 0
        self.length = length

    def __repr__(self):
        return f"Bitvector[{self.length}]"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return (self.length + 7) // 8

    def serialize(self, value) -> bytes:
        bits = list(value)
        if len(bits) != self.length:
            raise ValueError("Bitvector wrong length")
        out = bytearray((self.length + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size():
            raise ValueError("Bitvector wrong byte length")
        # excess bits must be zero
        if self.length % 8:
            if data[-1] >> (self.length % 8):
                raise ValueError("Bitvector has set padding bits")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(self.length)]

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)), (self.length + 255) // 256)

    def default(self):
        return [False] * self.length


class Bitlist(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"Bitlist[{self.limit}]"

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        bits = list(value)
        if len(bits) > self.limit:
            raise ValueError("Bitlist over limit")
        out = bytearray(len(bits) // 8 + 1)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        out[len(bits) // 8] |= 1 << (len(bits) % 8)  # delimiter
        return bytes(out)

    def deserialize(self, data: bytes):
        if not data:
            raise ValueError("empty Bitlist encoding")
        last = data[-1]
        if last == 0:
            raise ValueError("Bitlist missing delimiter")
        total_bits = (len(data) - 1) * 8 + (last.bit_length() - 1)
        if total_bits > self.limit:
            raise ValueError("Bitlist over limit")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(total_bits)]

    def hash_tree_root(self, value) -> bytes:
        bits = list(value)
        out = bytearray((len(bits) + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        root = merkleize(pack_bytes(bytes(out)), (self.limit + 255) // 256)
        return mix_in_length(root, len(bits))

    def default(self):
        return []


class Vector(SSZType):
    def __init__(self, element: SSZType, length: int):
        assert length > 0
        self.element = element
        self.length = length

    def __repr__(self):
        return f"Vector[{self.element!r}, {self.length}]"

    def is_fixed_size(self):
        return self.element.is_fixed_size()

    def fixed_size(self):
        return self.element.fixed_size() * self.length

    def serialize(self, value) -> bytes:
        items = list(value)
        if len(items) != self.length:
            raise ValueError(f"Vector wrong length {len(items)} != {self.length}")
        return _serialize_sequence(self.element, items)

    def deserialize(self, data: bytes):
        return _deserialize_sequence(self.element, data, expected_len=self.length)

    def hash_tree_root(self, value) -> bytes:
        items = list(value)
        if isinstance(self.element, Uint) or self.element is boolean:
            data = b"".join(self.element.serialize(v) for v in items)
            return merkleize(
                pack_bytes(data), (self.length * self.element.fixed_size() + 31) // 32
            )
        roots = [self.element.hash_tree_root(v) for v in items]
        return merkleize(roots, self.length)

    def default(self):
        return [self.element.default() for _ in range(self.length)]


class List(SSZType):
    def __init__(self, element: SSZType, limit: int):
        self.element = element
        self.limit = limit

    def __repr__(self):
        return f"List[{self.element!r}, {self.limit}]"

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        items = list(value)
        if len(items) > self.limit:
            raise ValueError("List over limit")
        return _serialize_sequence(self.element, items)

    def deserialize(self, data: bytes):
        items = _deserialize_sequence(self.element, data, expected_len=None)
        if len(items) > self.limit:
            raise ValueError("List over limit")
        return items

    def hash_tree_root(self, value) -> bytes:
        # CowList-backed values (the big state fields) carry their own
        # dirty-chunk set — the recorded diff IS the tree-hash diff, so
        # the CoW path skips both the O(n) leaf marshal and the O(n)
        # snapshot diff. It declines (None) for ineligible shapes and the
        # generic path below serves unchanged.
        from .cow import CowList, cow_list_root

        if isinstance(value, CowList):
            root = cow_list_root(self, value)
            if root is not None:
                return mix_in_length(root, len(value))
        items = list(value)
        if isinstance(self.element, Uint) or self.element is boolean:
            data = self._pack_basic(items)
            limit_chunks = (self.limit * self.element.fixed_size() + 31) // 32
            chunks = pack_bytes(data)
            if len(chunks) >= _TREE_CACHE_MIN:
                root = self._cached_root(
                    np.frombuffer(b"".join(chunks), np.uint8).reshape(-1, 32),
                    limit_chunks,
                )
            else:
                root = merkleize(chunks, limit_chunks)
        else:
            roots = [self.element.hash_tree_root(v) for v in items]
            if len(roots) >= _TREE_CACHE_MIN:
                root = self._cached_root(
                    np.frombuffer(b"".join(roots), np.uint8).reshape(-1, 32),
                    self.limit,
                )
            else:
                root = merkleize(roots, self.limit)
        return mix_in_length(root, len(items))

    def _pack_basic(self, items) -> bytes:
        """Serialize a basic-type list; numpy fast path for the big uint
        lists (balances, participation, inactivity scores) whose per-item
        int.to_bytes loop dominated packing at validator scale."""
        size = self.element.fixed_size()
        if isinstance(self.element, Uint) and size in (1, 2, 4, 8) and len(items) >= 64:
            return np.asarray(items, dtype=f"<u{size}").tobytes()
        return b"".join(self.element.serialize(v) for v in items)

    def _cached_root(self, leaves, limit: int) -> bytes:
        from .tree_cache import GLOBAL_LIST_CACHE

        depth = (next_pow2(limit)).bit_length() - 1
        return GLOBAL_LIST_CACHE.root(self, leaves, depth)

    def default(self):
        return []


def _serialize_sequence(element: SSZType, items: list) -> bytes:
    if element.is_fixed_size():
        return b"".join(element.serialize(v) for v in items)
    parts = [element.serialize(v) for v in items]
    fixed = len(parts) * OFFSET_BYTES
    out = bytearray()
    offset = fixed
    for p in parts:
        out += offset.to_bytes(OFFSET_BYTES, "little")
        offset += len(p)
    for p in parts:
        out += p
    return bytes(out)


def _deserialize_sequence(element: SSZType, data: bytes, expected_len):
    if element.is_fixed_size():
        size = element.fixed_size()
        if len(data) % size:
            raise ValueError("sequence length not a multiple of element size")
        n = len(data) // size
        if expected_len is not None and n != expected_len:
            raise ValueError("wrong sequence length")
        return [element.deserialize(data[i * size : (i + 1) * size]) for i in range(n)]
    if not data:
        if expected_len not in (None, 0):
            raise ValueError("wrong sequence length")
        return []
    first_offset = int.from_bytes(data[:OFFSET_BYTES], "little")
    if first_offset % OFFSET_BYTES or first_offset > len(data):
        raise ValueError("bad first offset")
    n = first_offset // OFFSET_BYTES
    if expected_len is not None and n != expected_len:
        raise ValueError("wrong sequence length")
    offsets = [
        int.from_bytes(data[i * OFFSET_BYTES : (i + 1) * OFFSET_BYTES], "little")
        for i in range(n)
    ] + [len(data)]
    items = []
    for i in range(n):
        if offsets[i] > offsets[i + 1]:
            raise ValueError("offsets not monotonic")
        items.append(element.deserialize(data[offsets[i] : offsets[i + 1]]))
    return items


class Field:
    __slots__ = ("name", "type")

    def __init__(self, name: str, type_: SSZType):
        self.name = name
        self.type = type_


#: Container names whose VALUE INSTANCES are immutable by convention
#: everywhere in the codebase (every mutation goes through copy_with, which
#: builds a fresh instance) — their tree roots are memoized per instance.
#: BeaconState is deliberately absent: its attributes are reassigned in
#: place by the state transition. This memoization is the host-side analog
#: of the reference's cached_tree_hash: at 16k+ validators, re-hashing an
#: unchanged Validator (~15 sha256 + dispatch) per state root dominates
#: state-root time (consensus/cached_tree_hash/src/lib.rs:1).
MEMOIZED_ROOT_TYPES = frozenset(
    {
        "Validator",
        "PendingAttestation",
        "AttestationData",
        "Checkpoint",
        "Eth1Data",
        "Fork",
        "DepositData",
        "SyncCommittee",
        "ExecutionPayloadHeader",
        "HistoricalBatch",
        "HistoricalSummary",
        "Withdrawal",
        "PendingDeposit",
        "PendingPartialWithdrawal",
        "PendingConsolidation",
        "BeaconBlockHeader",
    }
)


class Container(SSZType):
    """Container descriptor built from (name, type) pairs; values are
    instances of a generated dataclass-like value type."""

    def __init__(self, name: str, fields: Sequence[tuple[str, SSZType]]):
        self.name = name
        self.fields = [Field(n, t) for n, t in fields]
        self.memoize_root = name in MEMOIZED_ROOT_TYPES
        self._value_cls = _make_value_class(name, [f.name for f in self.fields], self)

    def __repr__(self):
        return self.name

    @property
    def value_class(self):
        return self._value_cls

    def make(self, **kwargs):
        vals = {}
        for f in self.fields:
            vals[f.name] = kwargs.pop(f.name) if f.name in kwargs else f.type.default()
        if kwargs:
            raise TypeError(f"unknown fields for {self.name}: {sorted(kwargs)}")
        return self._value_cls(**vals)

    def is_fixed_size(self):
        return all(f.type.is_fixed_size() for f in self.fields)

    def fixed_size(self):
        assert self.is_fixed_size()
        return sum(f.type.fixed_size() for f in self.fields)

    def serialize(self, value) -> bytes:
        fixed_parts = []
        var_parts = []
        for f in self.fields:
            v = getattr(value, f.name)
            if f.type.is_fixed_size():
                fixed_parts.append(f.type.serialize(v))
                var_parts.append(None)
            else:
                fixed_parts.append(None)
                var_parts.append(f.type.serialize(v))
        fixed_len = sum(
            len(p) if p is not None else OFFSET_BYTES for p in fixed_parts
        )
        out = bytearray()
        offset = fixed_len
        for p, v in zip(fixed_parts, var_parts):
            if p is not None:
                out += p
            else:
                out += offset.to_bytes(OFFSET_BYTES, "little")
                offset += len(v)
        for v in var_parts:
            if v is not None:
                out += v
        return bytes(out)

    def deserialize(self, data: bytes):
        # first pass: find offsets
        pos = 0
        offsets = []
        var_fields = []
        fixed_vals: dict[str, Any] = {}
        for f in self.fields:
            if f.type.is_fixed_size():
                size = f.type.fixed_size()
                fixed_vals[f.name] = f.type.deserialize(data[pos : pos + size])
                pos += size
            else:
                offsets.append(int.from_bytes(data[pos : pos + OFFSET_BYTES], "little"))
                var_fields.append(f)
                pos += OFFSET_BYTES
        offsets.append(len(data))
        if var_fields and offsets[0] != pos:
            raise ValueError(f"{self.name}: bad first offset")
        if not var_fields and pos != len(data):
            # SSZ strictness: an all-fixed-size container must consume every
            # byte; trailing garbage is a non-canonical encoding
            raise ValueError(f"{self.name}: {len(data) - pos} trailing bytes")
        for i, f in enumerate(var_fields):
            if offsets[i] > offsets[i + 1]:
                raise ValueError("offsets not monotonic")
            fixed_vals[f.name] = f.type.deserialize(data[offsets[i] : offsets[i + 1]])
        return self._value_cls(**fixed_vals)

    def hash_tree_root(self, value) -> bytes:
        if self.memoize_root:
            cached = getattr(value, "_htr", None)
            if cached is not None:
                return cached
        roots = [f.type.hash_tree_root(getattr(value, f.name)) for f in self.fields]
        root = merkleize(roots, len(self.fields))
        if self.memoize_root:
            object.__setattr__(value, "_htr", root)
        return root

    def default(self):
        return self._value_cls(**{f.name: f.type.default() for f in self.fields})


class Union(SSZType):
    def __init__(self, options: Sequence[SSZType | None]):
        # options[0] may be None (the "null" arm)
        self.options = list(options)

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        selector, inner = value
        opt = self.options[selector]
        if opt is None:
            if inner is not None:
                raise ValueError("null union arm takes no value")
            return bytes([selector])
        return bytes([selector]) + opt.serialize(inner)

    def deserialize(self, data: bytes):
        if not data:
            raise ValueError("empty union")
        selector = data[0]
        if selector >= len(self.options):
            raise ValueError("bad union selector")
        opt = self.options[selector]
        if opt is None:
            if len(data) != 1:
                raise ValueError("null union arm with payload")
            return (0, None)
        return (selector, opt.deserialize(data[1:]))

    def hash_tree_root(self, value) -> bytes:
        selector, inner = value
        opt = self.options[selector]
        root = _ZERO_CHUNK if opt is None else opt.hash_tree_root(inner)
        return mix_in_selector(root, selector)

    def default(self):
        opt = self.options[0]
        return (0, None if opt is None else opt.default())


def _make_value_class(name: str, field_names: list[str], ssz_type: Container):
    cls = dataclass(eq=True, repr=True)(
        type(name, (), {"__annotations__": {n: Any for n in field_names}})
    )
    cls.ssz_type = ssz_type

    # Structural equality across type instances: the same container name is
    # materialized once per (preset, fork) SpecTypes, and values migrate
    # across fork boundaries (e.g. a Checkpoint built under phase0 types
    # inside an upgraded state vs one deserialized under deneb types).
    # Dataclass __eq__ demands identical classes, which made such equal
    # values compare unequal — a consensus-visible landmine.
    def _eq(self, other):
        if getattr(other.__class__, "__name__", None) != name:
            return NotImplemented
        try:
            return all(getattr(self, n) == getattr(other, n) for n in field_names)
        except AttributeError:
            return NotImplemented

    cls.__eq__ = _eq
    cls.__hash__ = None

    def serialize(self):
        return ssz_type.serialize(self)

    def hash_tree_root(self):
        return ssz_type.hash_tree_root(self)

    def copy_with(self, **kw):
        vals = {n: getattr(self, n) for n in field_names}
        vals.update(kw)
        return cls(**vals)

    cls.serialize = serialize
    cls.hash_tree_root = hash_tree_root
    cls.copy_with = copy_with
    return cls


# common aliases used throughout consensus types
Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)
