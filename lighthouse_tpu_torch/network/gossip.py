"""Gossip layer: eth2 topic naming, message ids, subnets, and an
in-process router (the port's copy of the JAX package's network/gossip.py,
on the port's pure-Python snappy codec).

Parity surface: lighthouse/beacon_node/lighthouse_network — topic
formatting (`/eth2/{fork_digest}/{name}/ssz_snappy`), the gossipsub
message-id function (SHA-256 over a domain + decompressed payload,
gossipsub config in service/mod.rs), attestation subnet computation
(subnet_service/attestation_subnets.rs), and peer scoring parameters
(gossipsub_scoring_parameters.rs). The full libp2p mesh is host-side
networking the design keeps on the host (SURVEY §5); the
InProcessGossipRouter gives the simulator the same pub/sub semantics the
reference's testing rigs get from real libp2p on localhost.
"""

from __future__ import annotations

import hashlib
from collections import defaultdict
from dataclasses import dataclass, field

from . import snappy

MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"
MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
GOSSIP_MAX_SIZE = 10 * 1024 * 1024


CORE_TOPICS = [
    "beacon_block",
    "beacon_aggregate_and_proof",
    "voluntary_exit",
    "proposer_slashing",
    "attester_slashing",
    "sync_committee_contribution_and_proof",
    "bls_to_execution_change",
]


def topic_name(fork_digest: bytes, name: str) -> str:
    return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"


def attestation_subnet_topic(fork_digest: bytes, subnet_id: int) -> str:
    return topic_name(fork_digest, f"beacon_attestation_{subnet_id}")


def blob_sidecar_topic(fork_digest: bytes, index: int) -> str:
    return topic_name(fork_digest, f"blob_sidecar_{index}")


def sync_committee_topic(fork_digest: bytes, subnet_id: int) -> str:
    return topic_name(fork_digest, f"sync_committee_{subnet_id}")


def message_id(topic: str, compressed_payload: bytes) -> bytes:
    """Gossipsub message-id: sha256(domain ++ len(topic) ++ topic ++ data)[:20]
    with the domain chosen by snappy validity."""
    try:
        data = snappy.decompress(compressed_payload)
        domain = MESSAGE_DOMAIN_VALID_SNAPPY
    except snappy.SnappyError:
        data = compressed_payload
        domain = MESSAGE_DOMAIN_INVALID_SNAPPY
    topic_bytes = topic.encode()
    pre = (
        domain
        + len(topic_bytes).to_bytes(8, "little")
        + topic_bytes
        + data
    )
    return hashlib.sha256(pre).digest()[:20]


def compute_subnet_for_attestation(
    committees_per_slot: int, slot: int, committee_index: int, spec
) -> int:
    """Spec compute_subnet_for_attestation."""
    slots_since_epoch_start = slot % spec.preset.SLOTS_PER_EPOCH
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (committees_since_epoch_start + committee_index) % spec.attestation_subnet_count


@dataclass
class GossipMessage:
    topic: str
    payload: bytes            # snappy-compressed SSZ
    message_id: bytes
    source_peer: str
    # wire-propagated origin context (observability/propagation.py
    # WireTraceContext), when the frame envelope carried one — handlers
    # adopt it into their local Trace for the cross-node causal join
    ctx: object = None


def ingest_scope(topic: str) -> str:
    """QoS rate-limit scope for a topic (matches the scopes NetworkNode
    configures: per batchable gossip kind, everything else unlimited)."""
    if "beacon_attestation_" in topic:
        return "gossip_attestation"
    if "beacon_aggregate_and_proof" in topic:
        return "gossip_aggregate"
    return "gossip_other"


class InProcessGossipRouter:
    """Pub/sub bus connecting in-process nodes (simulator network).

    Handlers return True to propagate (ACCEPT) and False to drop (REJECT/
    IGNORE) — the gossip validation outcome the reference signals back to
    gossipsub.

    `ingest_limiter` (qos/ratelimit.RateLimiter, optional)
    sheds over-quota messages at the bus edge — after dedup (duplicates
    were always free no-ops and must not drain tokens), before delivery —
    the in-process analog of the TCP node's `--gossip-ingest-rate`. Scopes
    follow `ingest_scope`; shed messages count in `rate_limited` and stay
    un-seen, so a later re-publish can retry.

    `fault_filter(source_peer, dest_peer, topic) -> reason|None` (optional,
    see loadgen/netfaults.NetFaultInjector.router_filter) vetoes individual
    deliveries — the in-process analog of a partitioned or lossy link.
    Vetoed deliveries count per reason in `faulted`, so no message is lost
    without a counted cause."""

    def __init__(self, ingest_limiter=None, fault_filter=None):
        self.subscriptions: dict[str, list] = defaultdict(list)   # topic -> [(peer_id, handler)]
        self.seen: set[bytes] = set()
        self.delivered = 0
        self.dropped = 0
        self.rate_limited = 0
        self.ingest_limiter = ingest_limiter
        self.fault_filter = fault_filter
        self.faulted: dict[str, int] = {}

    def subscribe(self, peer_id: str, topic: str, handler) -> None:
        self.subscriptions[topic].append((peer_id, handler))

    def unsubscribe(self, peer_id: str, topic: str) -> None:
        self.subscriptions[topic] = [
            (p, h) for p, h in self.subscriptions[topic] if p != peer_id
        ]

    def publish(self, source_peer: str, topic: str, ssz_payload: bytes) -> int:
        compressed = snappy.compress(ssz_payload)
        if len(compressed) > GOSSIP_MAX_SIZE:
            raise ValueError("gossip message too large")
        mid = message_id(topic, compressed)
        if mid in self.seen:
            return 0
        # rate limit AFTER dedup: a duplicate publish was always a free
        # no-op and must not drain tokens meant for fresh messages
        if self.ingest_limiter is not None and not self.ingest_limiter.allow(
            ingest_scope(topic)
        ):
            self.rate_limited += 1
            return 0
        self.seen.add(mid)
        msg = GossipMessage(topic, compressed, mid, source_peer)
        count = 0
        for peer_id, handler in list(self.subscriptions.get(topic, [])):
            if peer_id == source_peer:
                continue
            if self.fault_filter is not None:
                reason = self.fault_filter(source_peer, peer_id, topic)
                if reason is not None:
                    self.faulted[reason] = self.faulted.get(reason, 0) + 1
                    continue
            ok = handler(msg)
            if ok:
                count += 1
                self.delivered += 1
            else:
                self.dropped += 1
        return count
