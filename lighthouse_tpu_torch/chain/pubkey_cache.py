"""ValidatorPubkeyCache — index -> decompressed pubkey, store-backed.

Parity surface: lighthouse/beacon_node/beacon_chain/src/
validator_pubkey_cache.rs:17-146. This cache is THE feed for batch
verification: signature-set constructors resolve indices through it, and the
torch backend packs the decompressed affine coordinates straight into device
arrays (a per-pubkey Montgomery-form limb array, packed by the port's
crypto/torchbls/limbs.py exactly as the reference packs it, is memoized so
repeat verifications skip the int->limb conversion)."""

from __future__ import annotations

import numpy as np

from ..crypto import bls
from ..crypto.bls381.constants import P
from ..crypto.torchbls import limbs as lb
from ..store.kv import Column, KeyValueOp


class ValidatorPubkeyCache:
    def __init__(self, store=None):
        self.store = store
        self.pubkeys: list[bls.PublicKey] = []
        self.pubkey_bytes: list[bytes] = []
        self.index_by_bytes: dict[bytes, int] = {}
        self._mont_coords: list[tuple[np.ndarray, np.ndarray] | None] = []
        if store is not None:
            self._load()

    def _load(self):
        items = sorted(self.store.hot.iter_column(Column.pubkey_cache))
        for key, value in items:
            index = int.from_bytes(key, "little")
            assert index == len(self.pubkeys), "pubkey cache gap"
            pk = bls.PublicKey.deserialize(value)
            self._push(pk, value)

    def _push(self, pk: bls.PublicKey, pk_bytes: bytes):
        self.index_by_bytes[bytes(pk_bytes)] = len(self.pubkeys)
        self.pubkeys.append(pk)
        self.pubkey_bytes.append(bytes(pk_bytes))
        self._mont_coords.append(None)

    def import_new_pubkeys(self, state) -> None:
        """Add any validators beyond the cache length (import_new_pubkeys
        analog; called on state advance/import)."""
        if len(state.validators) <= len(self.pubkeys):
            return
        ops = []
        for i in range(len(self.pubkeys), len(state.validators)):
            pkb = bytes(state.validators[i].pubkey)
            pk = bls.PublicKey.deserialize(pkb)
            self._push(pk, pkb)
            if self.store is not None:
                ops.append(
                    KeyValueOp.put(Column.pubkey_cache, i.to_bytes(8, "little"), pkb)
                )
        if ops:
            self.store.hot.do_atomically(ops)

    def get(self, index: int) -> bls.PublicKey:
        return self.pubkeys[index]

    def get_index(self, pubkey_bytes: bytes) -> int | None:
        return self.index_by_bytes.get(bytes(pubkey_bytes))

    def mont_coords(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """Montgomery-form limb arrays (x, y) for direct device packing."""
        cached = self._mont_coords[index]
        if cached is None:
            x, y = self.pubkeys[index].point
            cached = (
                lb.pack(x * lb.R_MONT % P),
                lb.pack(y * lb.R_MONT % P),
            )
            self._mont_coords[index] = cached
        return cached

    def __len__(self):
        return len(self.pubkeys)

    def pubkey_getter(self):
        """A get_pubkey callable for signature_sets with by-bytes support."""

        def get_pubkey(index: int) -> bls.PublicKey:
            return self.pubkeys[index]

        def by_bytes(pkb: bytes) -> bls.PublicKey:
            idx = self.index_by_bytes.get(bytes(pkb))
            if idx is not None:
                return self.pubkeys[idx]
            return bls.PublicKey.deserialize(bytes(pkb))

        get_pubkey.by_bytes = by_bytes
        return get_pubkey
