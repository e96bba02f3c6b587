"""Slasher — offline slashing detection over min/max target arrays.

Parity surface: lighthouse/slasher/src/ — attestation queues
(attestation_queue.rs), per-epoch batch processing (slasher.rs), and the
min-max chunked arrays (array.rs) that answer "does any prior attestation
surround / get surrounded by this one" in O(1) per validator via running
minima/maxima of target epochs indexed by source epoch; block proposal
double-signing detection (block_queue.rs). Backing storage is the same
KeyValueStore abstraction the beacon store uses (LMDB/MDBX role).

Detection invariants (array.rs):
  min_targets[v][e] = min target of attestations by v with source >= e
                      (suffix aggregate — updating an insert at source s
                      walks DOWN from s and stops at the first entry that
                      is already <= t, so updates are amortized O(1))
  max_targets[v][e] = max target of attestations by v with source <= e
                      (prefix aggregate, walking UP with the same early
                      stop)
  new att (s, t) is SURROUNDED by an existing one iff max_targets[v][s-1] > t
  new att (s, t) SURROUNDS an existing one        iff min_targets[v][s+1] < t
Both queries are ONE chunk read. Arrays are stored in fixed-size chunks per
validator (chunked columns); `prune()` drops records and chunks below the
retention horizon (the slasher service calls it as finalization advances).
tests/test_slasher_scale.py drives thousands-of-validators batches, a
brute-force differential, chunk/window boundaries, and pruning.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from ..store.kv import Column, KeyValueStore, MemoryStore

CHUNK = 16  # epochs per chunk (C, array.rs chunk size analog)
MAX_HISTORY = 4096  # epochs of history kept (slasher config default)


@dataclass
class AttestationRecord:
    validator_index: int
    source: int
    target: int
    data_root: bytes
    indexed: object = None     # full IndexedAttestation for evidence


@dataclass
class ProposalRecord:
    proposer_index: int
    slot: int
    block_root: bytes
    signed_header: object = None


@dataclass
class SlashingEvidence:
    kind: str                  # "double_vote" | "surround" | "double_proposal"
    validator_index: int
    prior: object
    new: object


class Slasher:
    def __init__(self, store: KeyValueStore | None = None):
        # `is not None`, not truthiness: an EMPTY store with __len__ is falsy
        self.store = store if store is not None else MemoryStore()
        self.attestation_queue: list[AttestationRecord] = []
        self.proposal_queue: list[ProposalRecord] = []
        self.found: list[SlashingEvidence] = []

    # ------------------------------------------------------------- queues

    def accept_attestation(self, rec: AttestationRecord) -> None:
        self.attestation_queue.append(rec)

    def accept_proposal(self, rec: ProposalRecord) -> None:
        self.proposal_queue.append(rec)

    # ------------------------------------------------------------- storage

    @staticmethod
    def _chunk_key(validator: int, kind: str, chunk_idx: int) -> bytes:
        return kind.encode() + validator.to_bytes(8, "little") + chunk_idx.to_bytes(8, "little")

    def _get_chunk(self, validator: int, kind: str, chunk_idx: int) -> list[int]:
        raw = self.store.get(Column.metadata, self._chunk_key(validator, kind, chunk_idx))
        default = 2**63 if kind.startswith("min") else 0
        if raw is None:
            return [default] * CHUNK
        return [int.from_bytes(raw[i * 8 : (i + 1) * 8], "little") for i in range(CHUNK)]

    def _put_chunk(self, validator: int, kind: str, chunk_idx: int, vals: list[int]) -> None:
        raw = b"".join(v.to_bytes(8, "little") for v in vals)
        self.store.put(Column.metadata, self._chunk_key(validator, kind, chunk_idx), raw)

    def _att_key(self, validator: int, target: int) -> bytes:
        return b"att" + validator.to_bytes(8, "little") + target.to_bytes(8, "little")

    # ------------------------------------------------------------- detection

    def _check_double_vote(self, rec: AttestationRecord) -> SlashingEvidence | None:
        raw = self.store.get(Column.metadata, self._att_key(rec.validator_index, rec.target))
        if raw is not None:
            prior_root = raw[16:48]
            if prior_root != rec.data_root:
                return SlashingEvidence("double_vote", rec.validator_index, raw, rec)
        return None

    # Per-validator source-range bounds (L, S) and global extrema
    # (G_min, G_max): the aggregate arrays are only materialized for source
    # indices in [L, S]; queries outside that window answer from the global
    # extrema (below L every attestation has source >= L; above S none do).
    # This is what keeps updates O(gap) instead of O(MAX_HISTORY) on first
    # insert — the array.rs role of the per-validator current-epoch cursor.

    def _get_bounds(self, v: int):
        raw = self.store.get(Column.metadata, b"bnd" + v.to_bytes(8, "little"))
        if raw is None:
            return None
        return tuple(
            int.from_bytes(raw[i * 8 : (i + 1) * 8], "little") for i in range(4)
        )

    def _put_bounds(self, v: int, lo: int, hi: int, gmin: int, gmax: int) -> None:
        self.store.put(
            Column.metadata,
            b"bnd" + v.to_bytes(8, "little"),
            b"".join(x.to_bytes(8, "little") for x in (lo, hi, gmin, gmax)),
        )

    def _min_target_with_source_gt(self, v: int, source: int) -> int:
        """min target over attestations with source > `source`: ONE read of
        the suffix-aggregate array at index source+1."""
        bounds = self._get_bounds(v)
        if bounds is None:
            return 2**63
        lo, hi, gmin, _gmax = bounds
        e = source + 1
        if e > hi:
            return 2**63            # no attestation has source > hi
        if e <= lo:
            return gmin             # every attestation has source >= lo
        return self._get_chunk(v, "minbysrc", e // CHUNK)[e % CHUNK]

    def _max_target_with_source_lt(self, v: int, source: int) -> int:
        """max target over attestations with source < `source`: ONE read of
        the prefix-aggregate array at index source-1."""
        bounds = self._get_bounds(v)
        if bounds is None or source == 0:
            return 0
        lo, hi, _gmin, gmax = bounds
        e = source - 1
        if e < lo:
            return 0                # no attestation has source < lo
        if e >= hi:
            return gmax             # every attestation has source <= hi
        return self._get_chunk(v, "maxbysrc", e // CHUNK)[e % CHUNK]

    def _walk_chunks(self, v: int, kind: str, start: int, stop: int, step: int,
                     value: int, early_stop) -> None:
        """Write `value` into arr[e] for e from start to stop (inclusive,
        direction `step`), stopping early when `early_stop(existing)` —
        valid because both aggregates are monotone in e."""
        e = start
        while (e >= stop) if step < 0 else (e <= stop):
            ci = e // CHUNK
            chunk = self._get_chunk(v, kind, ci)
            dirty = False
            chunk_edge = ci * CHUNK if step < 0 else (ci + 1) * CHUNK - 1
            bound = max(stop, chunk_edge) if step < 0 else min(stop, chunk_edge)
            while (e >= bound) if step < 0 else (e <= bound):
                if early_stop(chunk[e % CHUNK]):
                    if dirty:
                        self._put_chunk(v, kind, ci, chunk)
                    return
                chunk[e % CHUNK] = value
                dirty = True
                e += step
            if dirty:
                self._put_chunk(v, kind, ci, chunk)

    def _fill_range(self, v: int, kind: str, lo_e: int, hi_e: int, value: int) -> None:
        """Write `value` into arr[lo_e..hi_e] chunk-granularly: interior
        chunks are written as ONE prebuilt constant chunk (no read), so an
        offline gap of G epochs costs G/CHUNK puts — not G element writes."""
        if hi_e < lo_e:
            return
        full = [value] * CHUNK
        ci = lo_e // CHUNK
        last_ci = hi_e // CHUNK
        while ci <= last_ci:
            c_lo, c_hi = ci * CHUNK, (ci + 1) * CHUNK - 1
            if lo_e <= c_lo and c_hi <= hi_e:
                self._put_chunk(v, kind, ci, full)
            else:
                chunk = self._get_chunk(v, kind, ci)
                for e in range(max(lo_e, c_lo), min(hi_e, c_hi) + 1):
                    chunk[e % CHUNK] = value
                self._put_chunk(v, kind, ci, chunk)
            ci += 1

    def _record_attestation(self, v: int, source: int, target: int) -> None:
        """Fold (source, target) into both aggregate arrays + the bounds."""
        bounds = self._get_bounds(v)
        if bounds is None:
            self._walk_chunks(v, "minbysrc", source, source, -1, target,
                              lambda x: x <= target)
            self._walk_chunks(v, "maxbysrc", source, source, 1, target,
                              lambda x: x >= target)
            self._put_bounds(v, source, source, target, target)
            return
        lo, hi, gmin, gmax = bounds
        if source > hi:
            # extend the materialized window upward, carrying the prefix
            # aggregate across the WHOLE gap — clamping the fill would
            # leave a hole inside [lo, hi'] that reads as "no attestations"
            # and mask surrounds that are well within the history window
            self._fill_range(v, "maxbysrc", hi + 1, source, gmax)
            hi = source
        if source < lo:
            self._fill_range(v, "minbysrc", source, lo - 1, gmin)
            lo = source
        self._walk_chunks(v, "minbysrc", source, max(lo, source - MAX_HISTORY),
                          -1, target, lambda x: x <= target)
        self._walk_chunks(v, "maxbysrc", source, min(hi, source + MAX_HISTORY),
                          1, target, lambda x: x >= target)
        self._put_bounds(v, lo, hi, min(gmin, target), max(gmax, target))

    def process_queued(self) -> list[SlashingEvidence]:
        """Epoch-batch processing (slasher.rs process_batch)."""
        new_evidence: list[SlashingEvidence] = []
        for rec in self.attestation_queue:
            v = rec.validator_index
            ev = self._check_double_vote(rec)
            if ev is None:
                # surround checks against recorded extrema
                max_t = self._max_target_with_source_lt(v, rec.source)
                if max_t > rec.target:
                    ev = SlashingEvidence("surround", v, ("surrounded_by_prior", max_t), rec)
                else:
                    min_t = self._min_target_with_source_gt(v, rec.source)
                    if min_t < rec.target and min_t != 2**63:
                        ev = SlashingEvidence("surround", v, ("surrounds_prior", min_t), rec)
            if ev is not None:
                new_evidence.append(ev)
                continue
            # record
            self.store.put(
                Column.metadata,
                self._att_key(v, rec.target),
                rec.source.to_bytes(8, "little")
                + rec.target.to_bytes(8, "little")
                + rec.data_root,
            )
            self._record_attestation(v, rec.source, rec.target)
        self.attestation_queue.clear()

        for rec in self.proposal_queue:
            key = b"blk" + rec.proposer_index.to_bytes(8, "little") + rec.slot.to_bytes(8, "little")
            raw = self.store.get(Column.metadata, key)
            if raw is not None and raw != rec.block_root:
                new_evidence.append(
                    SlashingEvidence("double_proposal", rec.proposer_index, raw, rec)
                )
            else:
                self.store.put(Column.metadata, key, rec.block_root)
        self.proposal_queue.clear()

        self.found.extend(new_evidence)
        return new_evidence

    # ------------------------------------------------------------- pruning

    def prune(self, before_epoch: int, before_slot: int | None = None) -> int:
        """Drop history below the retention horizon (slasher.rs prune):
        attestation records with target < before_epoch, proposal records
        below before_slot, and aggregate-array chunks lying wholly below
        before_epoch. Aggregates above the horizon keep their values, so a
        surround flagged against pruned history remains a TRUE offense —
        only the prior's full record is no longer reproducible. Returns the
        number of deleted keys (full column scan: call at finalization
        cadence, not per batch)."""
        doomed: list[bytes] = []
        for key, _val in self.store.iter_column(Column.metadata):
            if key.startswith(b"att") and len(key) == 19:
                if int.from_bytes(key[11:19], "little") < before_epoch:
                    doomed.append(key)
            elif key.startswith(b"blk") and before_slot is not None and len(key) == 19:
                if int.from_bytes(key[11:19], "little") < before_slot:
                    doomed.append(key)
            elif key.startswith((b"minbysrc", b"maxbysrc")) and len(key) == 24:
                ci = int.from_bytes(key[16:24], "little")
                if (ci + 1) * CHUNK <= before_epoch:
                    doomed.append(key)
        for key in doomed:
            self.store.delete(Column.metadata, key)
        return len(doomed)
