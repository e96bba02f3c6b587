"""Sync state machines: range sync, backfill, block lookups.

Parity surface: lighthouse/beacon_node/network/src/sync/ —
SyncManager (manager.rs:191) dispatching to RangeSync (range_sync/: forward
sync in EPOCHS_PER_BATCH=2-epoch batches against finalized/head targets
from peer Status), BackFillSync (backfill_sync/mod.rs: downward from a
checkpoint anchor with batched verification), and BlockLookups (parent
lookups for unknown-parent gossip blocks). Transport is the Req/Resp layer
(network/rpc.py) against any peer object exposing
`handle(peer_id, protocol, request_bytes, timeout=...)` — real sockets or
in-process handlers (the reference tests sync exactly this way with mocked
channels, sync/block_lookups/tests.rs).

Failure handling (hardened for the netfaults scenarios): every batch
request carries a deadline derived from its size, a failed attempt blames
the peer (the `on_peer_failure` hook feeds the connection-level peer
manager so repeat offenders get deprioritized), and the manager fails over
to an alternate peer with exponential backoff between attempts instead of
stalling the whole range behind one stuck peer. After `max_batch_retries`
attempts the batch is abandoned (recorded in `failed_batches`) and the
range re-targets. Every retry/failover/abandon lands in the labeled
`sync_*` metric families AND in the instance-local `stats` dict (the
deterministic per-run view loadgen reports consume).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum

from ..state_transition.slot import types_for_slot
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY
from .rpc import (
    BlocksByRangeRequest,
    Protocol,
    RESP_SUCCESS,
    StatusMessage,
    decode_response_chunk,
    encode_chunk,
)

log = get_logger("sync")

EPOCHS_PER_BATCH = 2

#: default Req/Resp round-trip budget (seconds) when the owner plumbs no
#: --rpc-timeout; batch requests ADD per-block time on top (see
#: SyncManager._batch_timeout)
DEFAULT_REQUEST_TIMEOUT = 10.0
#: extra deadline per requested block in a range batch: a 64-slot batch
#: is allowed to stream longer than a status ping
PER_BLOCK_TIMEOUT = 0.05

# Failures survived in place are counted per pipeline stage and logged
# with the error shape — node.py's heartbeat treatment.
SYNC_ERRORS = REGISTRY.counter_vec(
    "sync_errors_total",
    "sync pipeline failures survived (peer blamed / batch retried), by "
    "stage (range_request / blobs_request / segment_import / "
    "backfill_request / backfill_import)",
    ("stage",),
)
SYNC_BATCHES = REGISTRY.counter_vec(
    "sync_batches_total",
    "range-sync batch outcomes (ok / empty / error / abandoned)",
    ("outcome",),
)
SYNC_RETRIES = REGISTRY.counter_vec(
    "sync_retries_total",
    "batch retry attempts after a failure, by stage (range / backfill)",
    ("stage",),
)
SYNC_PEER_EVENTS = REGISTRY.counter_vec(
    "sync_peer_events_total",
    "per-peer sync events (blamed / failover / dropped)",
    ("event",),
)
SYNC_STATE_TRANSITIONS = REGISTRY.counter_vec(
    "sync_state_transitions_total",
    "SyncManager state transitions, by the state entered",
    ("state",),
)
SYNC_BACKFILL_WINDOW = REGISTRY.counter_vec(
    "sync_backfill_window_total",
    "backfill window decisions on an empty/unlinked range "
    "(widened / exhausted / reset)",
    ("outcome",),
)


def peek_block_slot(ssz: bytes) -> int:
    """Slot of a serialized SignedBeaconBlock without full decode: the
    message offset sits at [0:4], and slot is the message's first field —
    this is how fork-aware decoding picks the right container for mixed-
    fork ranges (the reference selects by fork context instead)."""
    off = int.from_bytes(ssz[0:4], "little")
    return int.from_bytes(ssz[off : off + 8], "little")


def peek_sidecar_slot(spec, ssz: bytes) -> int:
    """Header slot of a serialized BlobSidecar: fixed layout up to the
    header (index u64, blob, commitment 48, proof 48, then header.slot)."""
    off = 8 + spec.preset.FIELD_ELEMENTS_PER_BLOB * 32 + 48 + 48
    return int.from_bytes(ssz[off : off + 8], "little")


class SyncState(Enum):
    idle = "idle"
    syncing_finalized = "syncing_finalized"
    syncing_head = "syncing_head"
    synced = "synced"


@dataclass
class BatchRequest:
    start_slot: int
    count: int
    peer_id: str
    attempts: int = 0


def _count_error(stats: dict, stage: str, e: Exception, **fields) -> None:
    """One owner of survived-failure accounting: the labeled metric, the
    per-run stats mirror, and the structured warn."""
    SYNC_ERRORS.labels(stage).inc()
    stats["errors"][stage] = stats["errors"].get(stage, 0) + 1
    log.warn("sync stage failed", stage=stage,
             error=f"{type(e).__name__}: {e}", **fields)


def _new_stats() -> dict:
    """Instance-local counters mirroring the sync_* metric families —
    the global registry is cumulative across runs, these are per-manager,
    so a deterministic loadgen report can carry exact values."""
    return {
        "batch_attempts": 0,
        "batch_retries": 0,
        "batches_ok": 0,
        "batches_abandoned": 0,
        "peers_blamed": 0,
        "failovers": 0,
        "errors": {},            # stage -> count
        "backfill_widened": 0,
        "backfill_retries": 0,
    }


class BackFillSync:
    """Downward sync from the checkpoint anchor to genesis
    (backfill_sync/mod.rs): batches of EPOCHS_PER_BATCH requested BELOW the
    oldest known block, hash-linked to it, and signature-verified as ONE
    batch per segment via chain.import_historical_blocks.

    Skipped-slot runs longer than one batch are handled by WIDENING the
    request window (up to MAX_WINDOW_EPOCHS) before a peer is blamed — an
    empty range is not by itself misbehavior."""

    MAX_WINDOW_EPOCHS = 32

    def __init__(self, chain, stats: dict | None = None,
                 request_timeout: float | None = None):
        self.chain = chain
        self.window_epochs = EPOCHS_PER_BATCH
        self.stats = stats if stats is not None else _new_stats()
        self.request_timeout = (
            DEFAULT_REQUEST_TIMEOUT if request_timeout is None
            else float(request_timeout)
        )

    def complete(self) -> bool:
        return self.chain.oldest_block_slot == 0

    def _count_error(self, stage: str, e: Exception, **fields) -> None:
        _count_error(self.stats, stage, e, **fields)

    def request_and_import(self, rpc_peer, peer_id: str) -> int:
        """One batch: request [start, oldest) by range, import. Returns
        blocks imported; 0 with an exhausted window means the peer failed
        (caller drops it), otherwise the window was widened for retry."""
        spec = self.chain.spec
        oldest = self.chain.oldest_block_slot
        if oldest == 0:
            return 0
        batch_slots = self.window_epochs * spec.preset.SLOTS_PER_EPOCH
        start = max(0, oldest - batch_slots)
        count = oldest - start
        msg = BlocksByRangeRequest.make(start_slot=start, count=count, step=1)
        timeout = self.request_timeout + count * PER_BLOCK_TIMEOUT
        try:
            chunks = rpc_peer.handle(
                peer_id, Protocol.blocks_by_range,
                encode_chunk(BlocksByRangeRequest.serialize(msg)),
                timeout=timeout,
            )
        except Exception as e:  # noqa: BLE001 — any transport/peer failure
            self._count_error("backfill_request", e, peer=peer_id,
                              start_slot=start, count=count)
            return 0
        blocks = []
        for c in chunks:
            code, payload = decode_response_chunk(c)
            if code != RESP_SUCCESS:
                return 0
            types = types_for_slot(spec, peek_block_slot(payload))
            blocks.append(types.SignedBeaconBlock.deserialize(payload))
        if not blocks:
            return self._widen(start)
        try:
            got = self.chain.import_historical_blocks(blocks)
        except Exception as e:  # noqa: BLE001 — torn/unlinked segment
            self._count_error("backfill_import", e, peer=peer_id,
                              start_slot=start, n_blocks=len(blocks))
            if start > 0:
                # maybe the linkage parent lies below the window: widen once
                return self._widen(start)
            return 0
        if self.window_epochs != EPOCHS_PER_BATCH:
            SYNC_BACKFILL_WINDOW.labels("reset").inc()
        self.window_epochs = EPOCHS_PER_BATCH
        return got

    def _widen(self, start: int) -> int:
        """Empty/unlinked response: widen the window unless exhausted.
        Returns -1 ("retry, not peer's fault") or 0 (give up on peer)."""
        if start == 0 or self.window_epochs >= self.MAX_WINDOW_EPOCHS:
            SYNC_BACKFILL_WINDOW.labels("exhausted").inc()
            return 0
        self.window_epochs = min(self.MAX_WINDOW_EPOCHS, self.window_epochs * 2)
        SYNC_BACKFILL_WINDOW.labels("widened").inc()
        self.stats["backfill_widened"] += 1
        return -1


class SyncManager:
    """Range sync + backfill + parent lookups against the peer set.

    `on_peer_failure(peer_id, stage)` (optional) is called once per blamed
    failure — NetworkNode wires it to the peer manager so sync misbehavior
    deprioritizes the peer for future selection. `sleep_fn` is injectable
    so tests (and the deterministic loadgen harness) can observe backoffs
    without wall-clock waits."""

    #: exponential backoff between batch retry attempts (seconds):
    #: base * 2^(attempt-1), capped
    BACKOFF_BASE = 0.05
    BACKOFF_CAP = 2.0

    def __init__(self, chain, max_batch_retries: int = 3,
                 request_timeout: float | None = None,
                 sleep_fn=time.sleep, on_peer_failure=None):
        self.chain = chain
        self.peers: dict[str, object] = {}         # peer_id -> rpc handler-ish
        self.peer_status: dict[str, StatusMessage.value_class] = {}
        self.state = SyncState.idle
        self.failed_batches: list[BatchRequest] = []
        self.imported_blocks = 0
        self.max_batch_retries = max_batch_retries
        self.request_timeout = (
            DEFAULT_REQUEST_TIMEOUT if request_timeout is None
            else float(request_timeout)
        )
        self.sleep_fn = sleep_fn
        self.on_peer_failure = on_peer_failure
        self.stats = _new_stats()
        self.backoffs_taken: list[float] = []       # test/report surface

    # ------------------------------------------------------------- plumbing

    def _set_state(self, new: SyncState) -> None:
        if new is self.state:
            return
        self.state = new
        SYNC_STATE_TRANSITIONS.labels(new.value).inc()
        # the black box keeps the transition even when nobody is watching
        # the logs (flight_recorder is import-light: metrics + trace only)
        from ..observability.flight_recorder import RECORDER

        RECORDER.record("sync_state", state=new.value)

    def _batch_timeout(self, count: int) -> float:
        """Deadline for one range batch: base round-trip budget plus
        per-block streaming time — a 2-epoch batch gets longer than a
        status ping, and a stuck peer costs one deadline, not forever."""
        return self.request_timeout + count * PER_BLOCK_TIMEOUT

    def _blame(self, peer_id: str, stage: str, error: str = "") -> None:
        SYNC_PEER_EVENTS.labels("blamed").inc()
        self.stats["peers_blamed"] += 1
        log.warn("sync peer blamed", peer=peer_id, stage=stage, error=error)
        if self.on_peer_failure is not None:
            try:
                self.on_peer_failure(peer_id, stage)
            except Exception:  # noqa: BLE001 — blame must never break sync
                pass

    def _count_error(self, stage: str, e: Exception, **fields) -> None:
        _count_error(self.stats, stage, e, **fields)

    def _backoff(self, attempt: int) -> None:
        delay = min(self.BACKOFF_CAP, self.BACKOFF_BASE * (2 ** max(0, attempt - 1)))
        self.backoffs_taken.append(delay)
        self.sleep_fn(delay)

    # ------------------------------------------------------------- peers

    def add_peer(self, peer_id: str, rpc_peer) -> None:
        """Handshake: exchange Status and record the peer's view."""
        chunks = rpc_peer.handle(peer_id, Protocol.status, encode_chunk(b""),
                                 timeout=self.request_timeout)
        if not chunks:
            # peer hung up mid-handshake (or rate-limited us to nothing):
            # not a peer we can sync from
            return
        code, payload = decode_response_chunk(chunks[0])
        if code != RESP_SUCCESS:
            return
        status = StatusMessage.deserialize(payload)
        self.peers[peer_id] = rpc_peer
        self.peer_status[peer_id] = status

    def remove_peer(self, peer_id: str) -> None:
        if self.peers.pop(peer_id, None) is not None:
            SYNC_PEER_EVENTS.labels("dropped").inc()
        self.peer_status.pop(peer_id, None)

    # ------------------------------------------------------------- sync

    def _best_target(self) -> tuple[str, int] | None:
        """Highest advertised head among peers above our head."""
        our_head = self.chain.head_state().slot
        best = None
        for pid, st in self.peer_status.items():
            if st.head_slot > our_head and (best is None or st.head_slot > best[1]):
                best = (pid, st.head_slot)
        return best

    def _failover_peer(self, req: BatchRequest, tried: set[str]) -> str | None:
        """An alternate peer whose advertised head covers the batch —
        highest head first, never one already tried for this batch."""
        best = None
        for pid, st in self.peer_status.items():
            if pid in tried or pid not in self.peers:
                continue
            if st.head_slot < req.start_slot:
                continue
            if best is None or st.head_slot > best[1]:
                best = (pid, st.head_slot)
        return None if best is None else best[0]

    def sync(self) -> int:
        """Drive range sync to the best peer target; returns blocks imported.
        Synchronous batch loop (the tokio select loop of manager.rs collapsed
        to explicit pumping — deterministic for tests)."""
        spec = self.chain.spec
        batch_slots = EPOCHS_PER_BATCH * spec.preset.SLOTS_PER_EPOCH
        imported = 0
        while True:
            target = self._best_target()
            if target is None:
                self._set_state(
                    SyncState.synced if self.peers else SyncState.idle
                )
                return imported
            peer_id, target_slot = target
            self._set_state(SyncState.syncing_head)
            start = self.chain.head_state().slot + 1
            req = BatchRequest(
                start_slot=start,
                count=min(batch_slots, target_slot - start + 1),
                peer_id=peer_id,
            )
            blocks = self._batch_with_retries(req)
            if not blocks:
                # every candidate exhausted its attempts: abandon the batch
                # (failed peers were blamed + dropped inside the retry loop)
                self.failed_batches.append(req)
                SYNC_BATCHES.labels("abandoned").inc()
                self.stats["batches_abandoned"] += 1
                continue
            blobs_by_root = self._request_blobs_for(req, blocks)
            if blobs_by_root is None:
                self._blame(req.peer_id, "blobs_request")
                self.remove_peer(req.peer_id)
                continue
            try:
                self.chain.process_chain_segment(blocks, blobs_by_root=blobs_by_root)
            except Exception as e:  # noqa: BLE001 — bad segment = bad peer
                self._count_error("segment_import", e, peer=req.peer_id,
                                  start_slot=req.start_slot,
                                  n_blocks=len(blocks))
                self.failed_batches.append(req)
                self._blame(req.peer_id, "segment_import")
                self.remove_peer(req.peer_id)
                continue
            SYNC_BATCHES.labels("ok").inc()
            self.stats["batches_ok"] += 1
            imported += len(blocks)
            self.imported_blocks += len(blocks)

    def _batch_with_retries(self, req: BatchRequest):
        """One batch through the retry/failover engine: each failed attempt
        blames + drops the serving peer, backs off exponentially, and fails
        over to the best untried alternate. Returns the blocks, or None
        when `max_batch_retries` attempts (or the peer set) are exhausted."""
        tried: set[str] = set()
        while req.attempts < self.max_batch_retries:
            req.attempts += 1
            self.stats["batch_attempts"] += 1
            blocks = self._request_batch(req)
            if blocks:
                return blocks
            outcome = "error" if blocks is None else "empty"
            SYNC_BATCHES.labels(outcome).inc()
            tried.add(req.peer_id)
            # an rpc failure OR an empty response from a peer advertising a
            # higher head (it lied) both blame the peer and drop it
            self._blame(req.peer_id, "range_request", error=outcome)
            self.remove_peer(req.peer_id)
            if req.attempts >= self.max_batch_retries:
                break
            alt = self._failover_peer(req, tried)
            if alt is None:
                break
            SYNC_PEER_EVENTS.labels("failover").inc()
            self.stats["failovers"] += 1
            SYNC_RETRIES.labels("range").inc()
            self.stats["batch_retries"] += 1
            self._backoff(req.attempts)
            req.peer_id = alt
        return None

    def _request_batch(self, req: BatchRequest):
        peer = self.peers.get(req.peer_id)
        if peer is None:
            return None
        msg = BlocksByRangeRequest.make(start_slot=req.start_slot, count=req.count, step=1)
        try:
            chunks = peer.handle(
                req.peer_id, Protocol.blocks_by_range,
                encode_chunk(BlocksByRangeRequest.serialize(msg)),
                timeout=self._batch_timeout(req.count),
            )
        except Exception as e:  # noqa: BLE001 — timeout/stall/transport
            self._count_error("range_request", e, peer=req.peer_id,
                              start_slot=req.start_slot, count=req.count)
            return None
        blocks = []
        for c in chunks:
            code, payload = decode_response_chunk(c)
            if code != RESP_SUCCESS:
                return None
            # fork-aware decode: pick container types by the block's own slot
            types = types_for_slot(self.chain.spec, peek_block_slot(payload))
            blocks.append(types.SignedBeaconBlock.deserialize(payload))
        return blocks

    def _request_blobs_for(self, req: BatchRequest, blocks):
        """Fetch the range's blob sidecars when any block carries
        commitments; returns {block_root: [sidecar]} (block_sidecar_coupling
        analog), None on peer failure."""
        from ..types.spec import ForkName

        spec = self.chain.spec
        need = any(
            spec.fork_name_at_slot(b.message.slot) >= ForkName.deneb
            and len(b.message.body.blob_kzg_commitments) > 0
            for b in blocks
        )
        if not need:
            return {}
        peer = self.peers.get(req.peer_id)
        if peer is None:
            return None
        msg = BlocksByRangeRequest.make(
            start_slot=req.start_slot, count=req.count, step=1
        )
        try:
            chunks = peer.handle(
                req.peer_id, Protocol.blobs_by_range,
                encode_chunk(BlocksByRangeRequest.serialize(msg)),
                timeout=self._batch_timeout(req.count),
            )
        except Exception as e:  # noqa: BLE001 — timeout/stall/transport
            self._count_error("blobs_request", e, peer=req.peer_id,
                              start_slot=req.start_slot, count=req.count)
            return None
        out: dict[bytes, list] = {}
        for c in chunks:
            code, payload = decode_response_chunk(c)
            if code != RESP_SUCCESS:
                return None
            types = types_for_slot(spec, peek_sidecar_slot(spec, payload))
            sc = types.BlobSidecar.deserialize(payload)
            hdr = sc.signed_block_header.message
            root = types.BeaconBlockHeader.hash_tree_root(hdr)
            out.setdefault(root, []).append(sc)
        for scs in out.values():
            scs.sort(key=lambda s: int(s.index))
        return out

    # ------------------------------------------------------------- backfill

    def backfill(self) -> int:
        """Drive BackFillSync to genesis; returns blocks stored."""
        bf = BackFillSync(self.chain, stats=self.stats,
                          request_timeout=self.request_timeout)
        total = 0
        attempts = 0
        while not bf.complete():
            peer_id = next(iter(self.peers), None)
            if peer_id is None:
                return total
            got = bf.request_and_import(self.peers[peer_id], peer_id)
            if got == 0:
                self._blame(peer_id, "backfill")
                self.remove_peer(peer_id)
                continue
            if got > 0:
                total += got
                attempts = 0
                continue
            # got == -1: window widened — retry the same peer with backoff
            attempts += 1
            SYNC_RETRIES.labels("backfill").inc()
            self.stats["backfill_retries"] += 1
            self._backoff(attempts)
        return total

    # ------------------------------------------------------------- lookups

    def lookup_parent_chain(self, peer_id: str, unknown_root: bytes, max_depth: int = 32):
        """Parent lookup: fetch by root backwards until a known parent, then
        import forward (block_lookups/ parent chains)."""
        peer = self.peers.get(peer_id)
        if peer is None:
            return 0
        chain_blocks = []
        root = unknown_root
        for _ in range(max_depth):
            if self.chain.store.block_exists(root):
                break
            chunks = peer.handle(peer_id, Protocol.blocks_by_root,
                                 encode_chunk(root),
                                 timeout=self.request_timeout)
            if not chunks:
                return 0
            code, payload = decode_response_chunk(chunks[0])
            if code != RESP_SUCCESS:
                return 0
            types = types_for_slot(self.chain.spec, self.chain.current_slot)
            blk = types.SignedBeaconBlock.deserialize(payload)
            chain_blocks.append(blk)
            root = bytes(blk.message.parent_root)
        else:
            return 0  # chain too deep / never connected
        chain_blocks.reverse()
        if not chain_blocks:
            return 0
        self.chain.process_chain_segment(chain_blocks)
        self.imported_blocks += len(chain_blocks)
        return len(chain_blocks)
