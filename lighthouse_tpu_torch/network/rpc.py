"""Req/Resp RPC layer: protocol registry, ssz_snappy chunk codec, status
handshake, rate limiting.

Parity surface: lighthouse/beacon_node/lighthouse_network/src/rpc/ —
protocol ids (protocol.rs:236-260), the <varint length><snappy payload>
chunk codec (codec/), Status/Goodbye/Ping/Metadata/BlocksByRange/
BlocksByRoot/BlobsByRange/BlobsByRoot semantics, and the token-bucket rate
limiter (rate_limiter.rs). Transport is pluggable: the in-process channel
pair used by the simulator mirrors how sync tests in the reference mock
the network layer (network/src/sync/block_lookups/tests.rs).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum

from ..ssz.core import Container, uint64, Bytes4, Bytes32
from . import snappy


class Protocol(str, Enum):
    status = "/eth2/beacon_chain/req/status/1/ssz_snappy"
    goodbye = "/eth2/beacon_chain/req/goodbye/1/ssz_snappy"
    ping = "/eth2/beacon_chain/req/ping/1/ssz_snappy"
    metadata = "/eth2/beacon_chain/req/metadata/2/ssz_snappy"
    blocks_by_range = "/eth2/beacon_chain/req/beacon_blocks_by_range/2/ssz_snappy"
    blocks_by_root = "/eth2/beacon_chain/req/beacon_blocks_by_root/2/ssz_snappy"
    blobs_by_range = "/eth2/beacon_chain/req/blob_sidecars_by_range/1/ssz_snappy"
    blobs_by_root = "/eth2/beacon_chain/req/blob_sidecars_by_root/1/ssz_snappy"


StatusMessage = Container("StatusMessage", [
    ("fork_digest", Bytes4),
    ("finalized_root", Bytes32),
    ("finalized_epoch", uint64),
    ("head_root", Bytes32),
    ("head_slot", uint64),
])

BlocksByRangeRequest = Container("BlocksByRangeRequest", [
    ("start_slot", uint64),
    ("count", uint64),
    ("step", uint64),
])

MetaData = Container("MetaData", [
    ("seq_number", uint64),
    # attnets/syncnets bitfields carried as raw uint64 for compactness here
    ("attnets", uint64),
    ("syncnets", uint64),
])

GoodbyeReason = uint64
Ping = uint64


class RpcError(Exception):
    pass


# response codes (protocol.rs)
RESP_SUCCESS = 0
RESP_INVALID_REQUEST = 1
RESP_SERVER_ERROR = 2
RESP_RESOURCE_UNAVAILABLE = 3


def encode_chunk(payload_ssz: bytes) -> bytes:
    """<varint uncompressed-length><snappy(payload)> (codec/base.rs)."""
    comp = snappy.compress(payload_ssz)
    return snappy._write_varint(len(payload_ssz)) + comp


def decode_chunk(data: bytes) -> tuple[bytes, int]:
    """Returns (payload, bytes_consumed)."""
    expected, pos = snappy._read_varint(data, 0)
    payload = snappy.decompress(data[pos:])
    if len(payload) != expected:
        raise RpcError("length prefix mismatch")
    return payload, len(data)


def encode_response_chunk(code: int, payload_ssz: bytes) -> bytes:
    return bytes([code]) + encode_chunk(payload_ssz)


def decode_response_chunk(data: bytes) -> tuple[int, bytes]:
    if not data:
        raise RpcError("empty response")
    code = data[0]
    payload, _ = decode_chunk(data[1:])
    return code, payload


# ------------------------------------------------------------ rate limiting


@dataclass
class TokenBucket:
    """rate_limiter.rs token bucket: `capacity` tokens refilled over
    `period` seconds."""

    capacity: int
    period: float
    tokens: float = field(default=0.0)
    last: float = field(default_factory=time.monotonic)

    def __post_init__(self):
        self.tokens = float(self.capacity)

    def allow(self, cost: int = 1, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        self.tokens = min(
            self.capacity, self.tokens + (now - self.last) * self.capacity / self.period
        )
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


DEFAULT_LIMITS = {
    Protocol.status: (5, 15.0),
    Protocol.ping: (2, 10.0),
    Protocol.metadata: (2, 5.0),
    Protocol.blocks_by_range: (1024, 10.0),   # cost = blocks requested
    Protocol.blocks_by_root: (128, 10.0),
    Protocol.blobs_by_range: (768, 10.0),
    Protocol.blobs_by_root: (128, 10.0),
    Protocol.goodbye: (1, 10.0),
}


class RpcRateLimiter:
    def __init__(self, limits=None):
        self.limits = limits or DEFAULT_LIMITS
        self.buckets: dict[tuple[str, Protocol], TokenBucket] = {}

    def allow(self, peer_id: str, protocol: Protocol, cost: int = 1, now=None) -> bool:
        key = (peer_id, protocol)
        if key not in self.buckets:
            cap, period = self.limits[protocol]
            self.buckets[key] = TokenBucket(cap, period)
        return self.buckets[key].allow(cost, now=now)


# ------------------------------------------------------------ server logic


class RpcHandler:
    """Serves Req/Resp against a BeaconChain (network_beacon_processor/
    rpc_methods.rs analog)."""

    MAX_REQUEST_BLOCKS = 1024

    def __init__(self, chain, fork_digest: bytes = b"\x00" * 4):
        self.chain = chain
        self.fork_digest = fork_digest
        self.limiter = RpcRateLimiter()
        self.metadata_seq = 1

    def local_status(self):
        chain = self.chain
        fc = chain.fork_choice.store.finalized_checkpoint
        head_state = chain.head_state()
        return StatusMessage.make(
            fork_digest=self.fork_digest,
            finalized_root=fc[1],
            finalized_epoch=fc[0],
            head_root=chain.head_root,
            head_slot=head_state.slot,
        )

    def handle(self, peer_id: str, protocol: Protocol, request_bytes: bytes,
               timeout: float | None = None) -> list[bytes]:
        """Returns a list of encoded response chunks. `timeout` is part of
        the shared handler surface (SyncManager passes its per-batch
        deadline); a local in-process handler answers synchronously, so it
        is accepted and ignored here — transport-backed peers (RemotePeer)
        enforce it."""
        cost = 1
        if protocol == Protocol.blocks_by_range:
            req = BlocksByRangeRequest.deserialize(decode_chunk(request_bytes)[0])
            cost = min(req.count, self.MAX_REQUEST_BLOCKS)
        if not self.limiter.allow(peer_id, protocol, cost):
            return [encode_response_chunk(RESP_RESOURCE_UNAVAILABLE, b"rate limited")]

        if protocol == Protocol.status:
            return [
                encode_response_chunk(
                    RESP_SUCCESS, StatusMessage.serialize(self.local_status())
                )
            ]
        if protocol == Protocol.ping:
            _seq = Ping.deserialize(decode_chunk(request_bytes)[0])
            return [encode_response_chunk(RESP_SUCCESS, Ping.serialize(self.metadata_seq))]
        if protocol == Protocol.metadata:
            md = MetaData.make(seq_number=self.metadata_seq, attnets=0, syncnets=0)
            return [encode_response_chunk(RESP_SUCCESS, MetaData.serialize(md))]
        if protocol == Protocol.goodbye:
            return []
        if protocol == Protocol.blocks_by_range:
            req = BlocksByRangeRequest.deserialize(decode_chunk(request_bytes)[0])
            if req.count == 0 or req.step != 1:
                return [encode_response_chunk(RESP_INVALID_REQUEST, b"bad range")]
            from ..state_transition.slot import types_for_slot

            out = []
            count = min(req.count, self.MAX_REQUEST_BLOCKS)
            # walk canonical chain via block_slots index
            by_slot = {s: r for r, s in self.chain.block_slots.items()}
            for slot in range(req.start_slot, req.start_slot + count):
                root = by_slot.get(slot)
                if root is None:
                    continue
                types = types_for_slot(self.chain.spec, slot)
                blk = self.chain.store.get_block(root, types)
                if blk is not None:
                    out.append(
                        encode_response_chunk(
                            RESP_SUCCESS, types.SignedBeaconBlock.serialize(blk)
                        )
                    )
            return out
        if protocol == Protocol.blobs_by_range:
            req = BlocksByRangeRequest.deserialize(decode_chunk(request_bytes)[0])
            from ..state_transition.slot import types_for_slot

            out = []
            by_slot = {s: r for r, s in self.chain.block_slots.items()}
            count = min(req.count, self.MAX_REQUEST_BLOCKS)
            for slot in range(req.start_slot, req.start_slot + count):
                root = by_slot.get(slot)
                if root is None:
                    continue
                for sc in self.chain.get_blobs(root):
                    types = types_for_slot(self.chain.spec, slot)
                    out.append(
                        encode_response_chunk(
                            RESP_SUCCESS, types.BlobSidecar.serialize(sc)
                        )
                    )
            return out
        if protocol == Protocol.blobs_by_root:
            payload, _ = decode_chunk(request_bytes)
            roots = [payload[i : i + 32] for i in range(0, len(payload), 32)]
            from ..state_transition.slot import types_for_slot

            out = []
            for root in roots[: self.MAX_REQUEST_BLOCKS]:
                slot = self.chain.block_slots.get(root)
                if slot is None:
                    continue
                types = types_for_slot(self.chain.spec, slot)
                for sc in self.chain.get_blobs(root):
                    out.append(
                        encode_response_chunk(
                            RESP_SUCCESS, types.BlobSidecar.serialize(sc)
                        )
                    )
            return out
        if protocol == Protocol.blocks_by_root:
            payload, _ = decode_chunk(request_bytes)
            roots = [payload[i : i + 32] for i in range(0, len(payload), 32)]
            from ..state_transition.slot import types_for_slot

            out = []
            for root in roots[: self.MAX_REQUEST_BLOCKS]:
                slot = self.chain.block_slots.get(root)
                if slot is None:
                    continue
                types = types_for_slot(self.chain.spec, slot)
                blk = self.chain.store.get_block(root, types)
                if blk is not None:
                    out.append(
                        encode_response_chunk(
                            RESP_SUCCESS, types.SignedBeaconBlock.serialize(blk)
                        )
                    )
            return out
        return [encode_response_chunk(RESP_INVALID_REQUEST, b"unknown protocol")]
