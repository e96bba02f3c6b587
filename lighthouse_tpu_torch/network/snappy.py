"""Snappy block-format codec, pure Python.

The eth2 wire protocol frames gossip messages and Req/Resp chunks with
snappy (raw block format for gossip, framed for RPC streams: the
ssz_snappy encoding of lighthouse/beacon_node/lighthouse_network/src/
rpc/codec/). The port's copy keeps the reference's pure-Python codec and
not its native C++ path (lighthouse_tpu/network/native/snappy.cc, built
with g++ at first use): the port reads the EF vectors' `*.ssz_snappy`
files with it, and the node's network layer is not ported yet.

Snappy block format: varint uncompressed length, then tagged elements:
  tag & 3 == 0: literal, length (tag>>2)+1 (or 1-4 extra length bytes)
  tag & 3 == 1: copy, 1-byte offset-ish (len 4-11, offset 11 bits)
  tag & 3 == 2: copy, 2-byte little-endian offset (len 1-64)
  tag & 3 == 3: copy, 4-byte offset
"""

from __future__ import annotations


class SnappyError(Exception):
    pass


# Decompression output bound: no eth2 message (gossip max ~10 MiB) comes
# close; an attacker-controlled length varint must never size an
# allocation (the claimed length is checked against this BEFORE any
# buffer is created).
MAX_UNCOMPRESSED_LEN = 32 << 20


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    expected, pos = _read_varint(data, 0)
    if expected > MAX_UNCOMPRESSED_LEN:
        raise SnappyError("uncompressed length over limit")
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        elem_type = tag & 3
        if elem_type == 0:  # literal
            length = tag >> 2
            if length < 60:
                length += 1
            else:
                extra = length - 59
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if elem_type == 1:
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif elem_type == 2:
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("bad copy offset")
        if offset >= length:
            start = len(out) - offset
            out += out[start : start + length]
        else:
            for _ in range(length):  # byte-wise: the copy overlaps itself
                out.append(out[-offset])
    if len(out) != expected:
        raise SnappyError(f"length mismatch: {len(out)} != {expected}")
    return bytes(out)


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    length = len(chunk) - 1
    if length < 60:
        out.append(length << 2)
    elif length < (1 << 8):
        out.append(60 << 2)
        out += length.to_bytes(1, "little")
    elif length < (1 << 16):
        out.append(61 << 2)
        out += length.to_bytes(2, "little")
    elif length < (1 << 24):
        out.append(62 << 2)
        out += length.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += length.to_bytes(4, "little")
    out += chunk


def compress(data: bytes) -> bytes:
    """Greedy hash-table matcher (4-byte anchors, 64KB window)."""
    out = bytearray(_write_varint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    i = 0
    lit_start = 0
    while i + 4 <= n:
        key = data[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and data[cand : cand + 4] == key:
            # extend match
            length = 4
            while i + length < n and length < 64 and data[cand + length] == data[i + length]:
                length += 1
            if lit_start < i:
                _emit_literal(out, data[lit_start:i])
            offset = i - cand
            # emit copy (type 2 covers len<=64, 16-bit offsets)
            out.append(((length - 1) << 2) | 2)
            out += offset.to_bytes(2, "little")
            i += length
            lit_start = i
        else:
            i += 1
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)
