"""Naive aggregation pools: self-built aggregates from gossip singles.

Parity surface: lighthouse/beacon_node/beacon_chain/src/
naive_aggregation_pool.rs — the BN aggregates every verified single-bit
attestation (and sync-committee message) it sees on its subnets, so that
when a local validator turns out to be an aggregator it can serve
`aggregate_attestation` / `sync_committee_contribution` without having seen
someone else's aggregate. Aggregation here is signature point addition over
the active BLS backend's G2 math; slots are pruned once stale."""

from __future__ import annotations

from collections import defaultdict

from ..crypto import bls
from ..crypto.bls381 import curve as cv

SLOT_RETENTION = 3


def _sig_point(sig_bytes: bytes):
    return bls.Signature.deserialize(bytes(sig_bytes))


def _agg_bytes(points) -> bytes:
    acc = None
    fake = bls.get_backend().name == "fake"
    if fake:
        # fake backend: signatures aren't points; carry the first one through
        return points[0].serialize() if points else bls.INFINITY_SIGNATURE_BYTES
    for s in points:
        acc = cv.g2_add(acc, s.point)
    return bls.Signature(acc).serialize()


class NaiveAttestationPool:
    """(data_root, committee) -> aggregated bits + signature per slot.

    Electra (EIP-7549) note: all committees of a slot share ONE
    AttestationData (index=0), so the data root alone cannot bucket — the
    committee index (from committee_bits) is part of the key, and served
    aggregates carry the committee's bit set."""

    def __init__(self, spec):
        self.spec = spec
        # slot -> (data_root, committee|None) -> (data, cb, bits, [sigs])
        self._by_slot: dict[int, dict] = defaultdict(dict)

    @staticmethod
    def _committee_of(att):
        cb = getattr(att, "committee_bits", None)
        if cb is None:
            return None, None
        set_bits = [i for i, b in enumerate(cb) if b]
        if len(set_bits) != 1:
            raise ValueError("expected exactly one committee bit")
        return set_bits[0], tuple(cb)

    def insert(self, att, types) -> bool:
        """Insert a verified single attestation; returns True if it added
        new bits."""
        slot = int(att.data.slot)
        cidx, cb = self._committee_of(att)
        key = (types.AttestationData.hash_tree_root(att.data), cidx)
        bucket = self._by_slot[slot].get(key)
        bits = list(att.aggregation_bits)
        sig = _sig_point(att.signature)
        if bucket is None:
            self._by_slot[slot][key] = (att.data, cb, bits, [sig])
            return True
        _data, _cb, cur, sigs = bucket
        new = [b and not c for b, c in zip(bits, cur)]
        if not any(new):
            return False
        merged = [b or c for b, c in zip(bits, cur)]
        self._by_slot[slot][key] = (_data, _cb, merged, sigs + [sig])
        return True

    def get_aggregate(self, slot: int, data_root: bytes, types,
                      committee_index: int | None = None):
        """Best aggregate for (slot, data root[, committee]). Pre-electra
        callers omit committee_index; electra aggregation duties supply it
        (the v2 aggregate_attestation API carries it)."""
        slot_map = self._by_slot.get(slot, {})
        bucket = slot_map.get((data_root, committee_index))
        if bucket is None and committee_index is None:
            # electra entries under an unspecified committee: serve the
            # first matching data root
            for (root, _cidx), b in slot_map.items():
                if root == data_root:
                    bucket = b
                    break
        if bucket is None:
            return None
        data, cb, bits, sigs = bucket
        kwargs = dict(
            aggregation_bits=bits, data=data, signature=_agg_bytes(sigs)
        )
        if cb is not None:
            kwargs["committee_bits"] = list(cb)
        return types.Attestation.make(**kwargs)

    def prune(self, current_slot: int) -> None:
        for s in list(self._by_slot):
            if s + SLOT_RETENTION < current_slot:
                del self._by_slot[s]


class NaiveSyncContributionPool:
    """(slot, root, subcommittee) -> aggregated sync contribution."""

    def __init__(self, spec):
        self.spec = spec
        self._by_slot: dict[int, dict] = defaultdict(dict)

    def insert(self, slot: int, beacon_block_root: bytes, subcommittee_index: int,
               index_in_subcommittee: int, signature_bytes: bytes) -> bool:
        key = (bytes(beacon_block_root), subcommittee_index)
        size = (
            self.spec.preset.SYNC_COMMITTEE_SIZE
            // self.spec.sync_committee_subnet_count
        )
        bucket = self._by_slot[slot].get(key)
        sig = _sig_point(signature_bytes)
        if bucket is None:
            bits = [False] * size
            bits[index_in_subcommittee] = True
            self._by_slot[slot][key] = (bits, [sig])
            return True
        bits, sigs = bucket
        if bits[index_in_subcommittee]:
            return False
        bits[index_in_subcommittee] = True
        sigs.append(sig)
        return True

    def get_contribution(self, slot: int, beacon_block_root: bytes,
                         subcommittee_index: int, types):
        bucket = self._by_slot.get(slot, {}).get(
            (bytes(beacon_block_root), subcommittee_index)
        )
        if bucket is None:
            return None
        bits, sigs = bucket
        return types.SyncCommitteeContribution.make(
            slot=slot,
            beacon_block_root=beacon_block_root,
            subcommittee_index=subcommittee_index,
            aggregation_bits=bits,
            signature=_agg_bytes(sigs),
        )

    def get_sync_aggregate(self, slot: int, beacon_block_root: bytes, types):
        """Merge every subcommittee's contribution for (slot, root) into a
        block-ready SyncAggregate (operation_pool get_sync_aggregate analog,
        lighthouse/beacon_node/operation_pool/src/lib.rs:158). Returns
        None when no contribution matches."""
        size = self.spec.preset.SYNC_COMMITTEE_SIZE
        n_sub = self.spec.sync_committee_subnet_count
        sub_size = size // n_sub
        bits = [False] * size
        points = []
        found = False
        for sub in range(n_sub):
            bucket = self._by_slot.get(slot, {}).get((bytes(beacon_block_root), sub))
            if bucket is None:
                continue
            found = True
            sub_bits, sub_sigs = bucket
            for i, bit in enumerate(sub_bits):
                if bit:
                    bits[sub * sub_size + i] = True
            points.extend(sub_sigs)
        if not found:
            return None
        return types.SyncAggregate.make(
            sync_committee_bits=bits, sync_committee_signature=_agg_bytes(points)
        )

    def prune(self, current_slot: int) -> None:
        for s in list(self._by_slot):
            if s + SLOT_RETENTION < current_slot:
                del self._by_slot[s]
