"""NetworkNode: one node's full networking stack over real TCP.

Assembly mirror of lighthouse/beacon_node/network/src/service.rs +
router.rs: owns the transport (TcpHost), the gossipsub router, the Req/Resp
server (RpcHandler), the peer manager and the sync manager, and dispatches
gossip topics into the beacon chain's verification pipelines
(network_beacon_processor/gossip_methods.rs analogs)."""

from __future__ import annotations

import itertools
import threading
import time
from time import perf_counter

from ..chain.beacon_chain import AttestationError, BlockError
from ..chain.data_availability import (
    AvailabilityPendingError,
    BlobError,
    BlobIgnoreError,
)
from ..observability.propagation import (
    PropagationTracker,
    WireTraceContext,
    short_topic,
)
from ..observability.trace import TRACER, next_trace_id
from ..state_transition.slot import types_for_slot
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY
from ..utils.supervisor import Supervisor
from . import gossip as gs
from .gossipsub import IGNORE_RETRY, Gossipsub
from .peer_manager import PeerManager
from .rpc import Protocol, RpcHandler
from .sync import SyncManager
from .transport import RemotePeer, TcpHost

log = get_logger("network")

# Heartbeat stage failures survived in place (the loop continues; the
# supervisor only sees a crash if the loop ITSELF dies). Each one is
# a counted, logged event.
_HEARTBEAT_ERRORS = REGISTRY.counter_vec(
    "node_heartbeat_errors_total",
    "heartbeat-loop stage failures survived (loop continues), by stage",
    ("stage",),
)

# Gossip/dial path failures survived in place (the surrounding iteration
# continues): PX/discovery dials that raced a vanished peer, sidecar
# retries whose dependency import failed. Each is a counted, logged
# event (as sync_errors_total counts sync's).
_GOSSIP_ERRORS = REGISTRY.counter_vec(
    "node_gossip_errors_total",
    "gossip/dial path failures survived in place (iteration continues), "
    "by stage",
    ("stage",),
)


class NetworkNode:
    def __init__(
        self,
        chain,
        node_id: str,
        fork_digest: bytes = b"\x00" * 4,
        port: int = 0,
        listen_host: str = "127.0.0.1",
        trusted_addrs: set | None = None,
        heartbeat_interval: float = 0.3,
        subnets: int | None = None,
        op_pool=None,
        encrypt: bool = True,
        require_encryption: bool = False,
        batch_gossip: bool = True,
        processor_autostart: bool = True,
        processor_config=None,
        ingest_rate: float | None = None,
        rpc_timeout: float | None = None,
        tracer=None,
    ):
        self.chain = chain
        chain._network_node = self          # identity/peers API surface
        self.node_id = node_id
        # span sink for publish/consume traces: the process-global TRACER
        # on a live node; the multinode harness hands each node a PRIVATE
        # Tracer so the cluster merge can render per-node process groups
        self.tracer = tracer if tracer is not None else TRACER
        # cross-node propagation SLIs, clocked on the chain's slot clock
        # (logical under ManualSlotClock -> seed-deterministic harness
        # distributions; wall time live)
        self.propagation = PropagationTracker(node_id,
                                              clock=chain.slot_clock)
        self._pub_seq = itertools.count()   # logical publish offset
        self.trusted_addrs = trusted_addrs or set()
        self.fork_digest = fork_digest
        # Gossip attestations/aggregates route through the beacon
        # processor's priority queues so they coalesce into device-sized
        # batches (the reference's Work::GossipAttestationBatch feeder,
        # beacon_processor/src/lib.rs:970-1087 — THE upstream of the torch
        # backend on the card). batch_gossip=False falls back to inline per-message
        # verification (deterministic single-threaded tests).
        from ..chain.beacon_processor import BeaconProcessor
        from ..qos.admission import AdmissionController

        self.batch_gossip = batch_gossip
        # QoS: the admission controller reads slot time from the chain's
        # clock (manual under test -> deterministic deadlines); the
        # processor consults it on submit and sheds expired work at pop
        self.admission = AdmissionController(chain.slot_clock)
        self.processor = BeaconProcessor(processor_config,
                                         admission=self.admission)
        # SLO slot attribution rides the same clock. First node wins (tests
        # assemble many nodes; the live process has one) — and slots only
        # CLOSE from the bn slot timer, so merely binding a clock never
        # emits reports or trips incident triggers on its own.
        from ..observability import slo as obs_slo

        if not obs_slo.ACCOUNTANT.clock_bound():
            obs_slo.ACCOUNTANT.bind_clock(chain.slot_clock)
        # optional gossip ingest token buckets (msgs/sec per batchable
        # kind; over-quota messages become gossip IGNOREs before touching
        # the queues). None = unlimited, the default.
        self.ingest_limiter = None
        if ingest_rate is not None:
            from ..qos.ratelimit import RateLimiter

            self.ingest_limiter = RateLimiter()
            for scope in ("gossip_attestation", "gossip_aggregate"):
                self.ingest_limiter.configure(
                    scope, float(ingest_rate), burst=2 * float(ingest_rate)
                )
        if batch_gossip and processor_autostart:
            # processor_autostart=False is the lock-step harness seam
            # (loadgen/multinode.py): gossip work queues through the REAL
            # processor + capacity scheduler, but the harness pumps it
            # synchronously at its phase barriers instead of worker
            # threads, so reports stay functions of the seed
            self.processor.start()
        self.op_pool = op_pool
        self.peer_manager = PeerManager()
        self.rpc = RpcHandler(chain, fork_digest)
        # Req/Resp round-trip budget: explicit arg > env > 10 s default.
        # One resolution feeds both the transport's default and the sync
        # manager's per-batch deadlines.
        if rpc_timeout is None:
            import os as _os

            env = _os.environ.get("LIGHTHOUSE_TPU_RPC_TIMEOUT")
            rpc_timeout = float(env) if env else 10.0
        self.rpc_timeout = float(rpc_timeout)
        self.sync = SyncManager(chain, request_timeout=self.rpc_timeout,
                                on_peer_failure=self._on_sync_peer_failure)
        # beacon-shaped score params for the core topics this node serves
        # (gossipsub_scoring_parameters.rs analog) — topics left out (blob
        # subnets, sync-committee) score neutral, so an idle topic can
        # never decay honest peers toward the graylist
        from .peer_score import beacon_score_params

        n_subnets = (
            subnets if subnets is not None else chain.spec.attestation_subnet_count
        )
        score_params = beacon_score_params(
            block_topic=gs.topic_name(fork_digest, "beacon_block"),
            aggregate_topic=gs.topic_name(
                fork_digest, "beacon_aggregate_and_proof"
            ),
            subnet_topics=[
                gs.attestation_subnet_topic(fork_digest, i)
                for i in range(n_subnets)
            ],
        )
        self.gossipsub = Gossipsub(
            node_id,
            self._gossip_send,
            self.peer_manager,
            addr_provider=self._peer_dial_addr,
            px_handler=self._on_px,
            score_params=score_params,
            # every publish without an explicit context gets one minted
            # here; every first delivery feeds the propagation SLIs
            ctx_factory=self._make_ctx,
            propagation=self.propagation,
        )
        # transport consults this: when True, plaintext-HELLO peers are
        # rejected instead of served unencrypted
        self.require_encryption = require_encryption
        self.host = TcpHost(self, node_id, host=listen_host, port=port,
                            encrypt=encrypt, rpc_timeout=self.rpc_timeout)
        self.heartbeat_interval = heartbeat_interval
        self._hb_stop = threading.Event()
        # the heartbeat runs supervised: a crash of the LOOP (not a caught
        # per-stage failure) restarts it with backoff instead of silently
        # stranding the mesh (utils/supervisor.py)
        self.supervisor = Supervisor(name="node")
        self._hb_thread = self.supervisor.spawn(self._heartbeat_loop, "heartbeat")
        self._lock = threading.Lock()  # serializes chain mutation from gossip
        # PX dial rate limiting (see _on_px)
        self._px_lock = threading.Lock()
        self._px_dialing = False
        self._px_seen: dict[tuple[str, int], float] = {}
        # Local reprocess queue (ReprocessQueue analog): sidecars whose
        # parent block hasn't arrived yet, keyed by the missing parent root.
        # Gossip redelivery is NOT guaranteed (mesh peers forward once), so
        # retriable-ignored sidecars are retried locally when a block
        # imports; by-root sync remains the fallback of last resort.
        self._pending_sidecars: dict[bytes, list] = {}
        self._pending_sidecar_count = 0
        # sidecars that arrived a moment early (future slot): retried by the
        # heartbeat once their slot starts — gossip dedup stays intact
        self._early_sidecars: dict[int, list] = {}

        self._subscribe_core(subnets)

    # ------------------------------------------------------------ topics

    def _subscribe_core(self, subnets: int | None) -> None:
        spec = self.chain.spec
        fd = self.fork_digest
        self.gossipsub.subscribe(gs.topic_name(fd, "beacon_block"), self._on_block)
        self.gossipsub.subscribe(
            gs.topic_name(fd, "beacon_aggregate_and_proof"), self._on_aggregate
        )
        n_subnets = subnets if subnets is not None else spec.attestation_subnet_count
        for i in range(n_subnets):
            self.gossipsub.subscribe(
                gs.attestation_subnet_topic(fd, i), self._mk_attestation_handler()
            )
        from ..types.spec import ForkName

        fork = spec.fork_name_at_slot(self.chain.current_slot)
        if fork >= ForkName.deneb:
            for i in range(spec.max_blobs(fork)):
                self.gossipsub.subscribe(gs.blob_sidecar_topic(fd, i), self._on_blob)

    # ------------------------------------------------------------ transport glue

    def _gossip_send(self, peer_id: str, rpc_bytes: bytes) -> None:
        conn = self.host.connections.get(peer_id)
        if conn is None:
            raise ConnectionError(f"no connection to {peer_id}")
        conn.send_gossip(rpc_bytes)

    def _serve_rpc(self, peer_id: str, protocol_str: str, request_bytes: bytes):
        try:
            protocol = Protocol(protocol_str)
        except ValueError:
            return []
        return self.rpc.handle(peer_id or "?", protocol, request_bytes)

    def _on_gossip(self, peer_id: str, rpc_bytes: bytes) -> None:
        if peer_id is None:
            return
        self.gossipsub.on_rpc(peer_id, rpc_bytes)

    def _register_connection(self, conn) -> None:
        self.host.connections[conn.peer_id] = conn
        self.peer_manager.connect(conn.peer_id)
        # trust is keyed on the configured DIALABLE address (socket IP +
        # HELLO-advertised listen port), so a trusted peer is exempt from
        # scoring however the connection arises — inbound, discovery, or a
        # re-dial long after a failed startup attempt
        if conn.peer_dial_addr and conn.peer_dial_addr in self.trusted_addrs:
            self.peer_manager._peer(conn.peer_id).trusted = True
        self.gossipsub.add_peer(conn.peer_id)
        # the Status handshake is a blocking round trip and we are ON this
        # connection's reader thread — hand it to a helper thread or the
        # response could never be read (deadlock)
        threading.Thread(
            target=self.sync.add_peer,
            args=(conn.peer_id, RemotePeer(conn)),
            daemon=True,
        ).start()

    def _unregister_connection(self, conn) -> None:
        if conn.peer_id is None:
            return
        self.host.connections.pop(conn.peer_id, None)
        self.peer_manager.disconnect(conn.peer_id)
        self.gossipsub.remove_peer(conn.peer_id)
        self.sync.remove_peer(conn.peer_id)

    def connect(self, other: "NetworkNode") -> None:
        host, port = other.host.listen_addr
        self.host.dial(host, port)

    def _on_sync_peer_failure(self, peer_id: str, stage: str) -> None:
        """SyncManager blame hook: a failed batch/backfill attempt
        deprioritizes the peer in the connection-level peer manager, so
        repeat offenders sink below honest peers in best_peers() selection
        and eventually cross the disconnect/ban thresholds."""
        from .peer_manager import PeerAction

        self.peer_manager.report(peer_id, PeerAction.mid_tolerance)

    # ------------------------------------------------------ peer exchange

    MAX_PX_DIALS = 4
    PX_ADDR_COOLDOWN = 60.0     # never re-dial a PX address within this

    def _peer_dial_addr(self, peer_id: str):
        """addr_provider for gossipsub PX: the peer's advertised listen
        address learned in the transport HELLO."""
        conn = self.host.connections.get(peer_id)
        return None if conn is None else conn.peer_dial_addr

    def _on_px(self, topic: str, px) -> None:
        """A PRUNE carried peer-exchange candidates: dial a few unknown
        ones on ONE helper thread (dials block; the gossip reader must
        not). Rate-limited: at most one dial batch in flight and a per-
        address cooldown — PX from peers is attacker-influencable, so it
        must not become a thread bomb or traffic amplifier."""
        import time as _t

        now = _t.monotonic()
        with self._px_lock:
            if self._px_dialing:
                return
            fresh = []
            for pid, host, port in px:
                if pid == self.node_id or pid in self.host.connections:
                    continue
                if now - self._px_seen.get((host, port), -1e9) < self.PX_ADDR_COOLDOWN:
                    continue
                self._px_seen[(host, port)] = now
                fresh.append((host, port))
                if len(fresh) >= self.MAX_PX_DIALS:
                    break
            if len(self._px_seen) > 1024:           # bound the dedup table
                cutoff = now - self.PX_ADDR_COOLDOWN
                self._px_seen = {
                    k: t for k, t in self._px_seen.items() if t >= cutoff
                }
            if not fresh:
                return
            self._px_dialing = True

        def dial_all():
            try:
                for host, port in fresh:
                    try:
                        self.host.dial(host, port)
                    except Exception as e:  # noqa: BLE001 — one dead PX
                        _GOSSIP_ERRORS.labels("px_dial").inc()  # candidate
                        log.warn("PX dial failed; trying next candidate",
                                 node=self.node_id, peer=f"{host}:{port}",
                                 error=f"{type(e).__name__}: {e}")
                        continue
            finally:
                with self._px_lock:
                    self._px_dialing = False

        threading.Thread(target=dial_all, name="px-dial", daemon=True).start()

    # ------------------------------------------------------------ discovery

    def enable_discovery(self, boot_nodes=(), attnets: int = 0):
        """Attach a UDP discovery endpoint advertising this node's TCP
        listen address (discovery/mod.rs + ENR analog)."""
        from .discovery import DiscoveryService, NodeRecord

        host, port = self.host.listen_addr
        rec = NodeRecord(
            id=self.node_id, ip=host, tcp_port=port, udp_port=0,
            fork_digest=self.fork_digest.hex(), attnets=attnets,
        )
        self.discovery = DiscoveryService(record=rec, host=host, boot_nodes=list(boot_nodes))
        return self.discovery

    def discover_and_dial(self, max_peers: int = 8) -> int:
        """Bootstrap discovery and dial found peers not yet connected."""
        if getattr(self, "discovery", None) is None:
            return 0
        self.discovery.bootstrap()
        dialed = 0
        for rec in list(self.discovery.table.values()):
            if dialed >= max_peers:
                break
            if rec.id in self.host.connections or rec.tcp_port == 0:
                continue
            try:
                self.host.dial(rec.ip, rec.tcp_port)
                dialed += 1
            except Exception as e:  # noqa: BLE001 — stale table entry
                _GOSSIP_ERRORS.labels("discovery_dial").inc()
                log.warn("discovery dial failed; trying next record",
                         node=self.node_id, peer=f"{rec.ip}:{rec.tcp_port}",
                         error=f"{type(e).__name__}: {e}")
                continue
        return dialed

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_interval):
            try:
                self.gossipsub.heartbeat()
            except Exception as e:  # noqa: BLE001 — one bad tick must not
                _HEARTBEAT_ERRORS.labels("gossip").inc()      # kill the loop
                log.warn("gossip heartbeat tick failed; loop continues",
                         node=self.node_id,
                         error=f"{type(e).__name__}: {e}")
            try:
                self._drain_early_sidecars()
            except Exception as e:  # noqa: BLE001
                _HEARTBEAT_ERRORS.labels("sidecars").inc()
                log.warn("early-sidecar drain failed; loop continues",
                         node=self.node_id,
                         error=f"{type(e).__name__}: {e}")

    def close(self, drain_timeout: float | None = None) -> None:
        """Shut the node down. With `drain_timeout`, queued processor work
        is drained (bounded) BEFORE the pump stops — the graceful path, so
        a SIGTERM mid-flood does not strand accepted gossip work."""
        self._hb_stop.set()
        if self.batch_gossip:
            if drain_timeout is not None and not self.processor.drain(
                drain_timeout
            ):
                log.warn("drain deadline hit; shedding remaining queued work",
                         node=self.node_id, timeout_secs=drain_timeout)
            self.processor.stop()
        self.supervisor.stop(timeout=1.0)
        self.host.close()

    # ------------------------------------------------------------ handlers

    def _on_block(self, msg) -> bool:
        """process_gossip_block analog: verify -> propagate -> import.
        Runs under a consumer-side trace that ADOPTS the block's wire
        context (when the frame carried one), so this node's validate and
        import spans share the producer's causal id — the remote half of
        the cross-node timeline."""
        spec = self.chain.spec
        # decode with the right fork types: peek the slot (first 8 bytes of
        # the message body after the 96-byte signature container layout is
        # fork-independent for slot: use latest types to read slot)
        payload = msg.decompressed
        types = types_for_slot(spec, self.chain.current_slot)
        try:
            signed = types.SignedBeaconBlock.deserialize(payload)
        except Exception:
            return False
        from ..observability.trace import set_current_trace

        tr = self.tracer.begin("gossip_block")
        ctx = getattr(msg, "ctx", None)
        if ctx is not None:
            tr.adopt(ctx)
        # bind as the thread's current trace so a parent-lookup RPC fired
        # from inside this import (request_ctx -> current_trace) joins the
        # import's causal chain instead of minting a disconnected id
        set_current_trace(tr)
        try:
            return self._import_gossip_block(msg, signed, tr, ctx)
        finally:
            set_current_trace(None)
            self.tracer.finish(tr)

    def _import_gossip_block(self, msg, signed, tr, ctx) -> bool:
        with self._lock:
            t0 = perf_counter()
            try:
                root = self.chain.verify_block_for_gossip(signed)
            except BlockError as e:
                tr.add_span("validate", t0, perf_counter(),
                            outcome="rejected")
                if "already known" in str(e):
                    return False
                if "parent unknown" in str(e):
                    # parent lookup via the sender
                    self._lookup_parent(msg.source_peer, signed)
                    return False
                return False
            t1 = perf_counter()
            tr.add_span("validate", t0, t1)
            try:
                self.chain.process_block(
                    signed, block_root=root, proposal_already_verified=True
                )
            except AvailabilityPendingError:
                # block is NOT in the store yet — child sidecars still can't
                # verify, so no pending retry here (it would drop them)
                tr.add_span("import", t1, perf_counter(),
                            outcome="availability_pending")
                return True          # propagate; blobs will complete it
            except BlockError:
                tr.add_span("import", t1, perf_counter(), outcome="rejected")
                return False
            tr.add_span("import", t1, perf_counter())
            if ctx is not None and self.chain.head_root == root:
                # time-to-head SLI: origin publish -> this node's
                # fork-choice head update
                self.propagation.note_time_to_head(ctx)
            self._retry_pending_sidecars(root)
        return True

    MAX_PENDING_SIDECARS = 64

    @staticmethod
    def _sidecar_key(sidecar) -> tuple:
        # the proposer signature commits to the whole header; (sig, index)
        # identifies a sidecar without a tree-hash
        return (int(sidecar.index), bytes(sidecar.signed_block_header.signature))

    def _stash_pending_sidecar(self, parent: bytes, sidecar) -> None:
        """Hold a sidecar blocked on an unimported parent for local retry.
        Deduped per bucket: IGNORE_RETRY redeliveries of the same sidecar
        must not eat multiple stash slots."""
        bucket = self._pending_sidecars.setdefault(parent, [])
        key = self._sidecar_key(sidecar)
        if any(self._sidecar_key(sc) == key for sc in bucket):
            return
        if self._pending_sidecar_count >= self.MAX_PENDING_SIDECARS:
            # evict the oldest dependency bucket wholesale
            victim = next(iter(self._pending_sidecars), None)
            if victim is None:
                return
            evicted = self._pending_sidecars.pop(victim)
            self._pending_sidecar_count -= len(evicted)
            if victim == parent:
                bucket = self._pending_sidecars.setdefault(parent, [])
        bucket.append(sidecar)
        self._pending_sidecar_count += 1

    def _retry_pending_sidecars(self, imported_root: bytes) -> None:
        """A block just imported: sidecars of its children can now verify.
        A retry that fails RETRIABLY (e.g. on a different missing parent)
        is re-stashed rather than dropped; a retry that itself completes an
        import cascades to ITS waiters (recursion bounded by the stash
        cap). Caller holds self._lock."""
        waiting = self._pending_sidecars.pop(imported_root, None)
        if not waiting:
            return
        self._pending_sidecar_count -= len(waiting)
        for sc in waiting:
            try:
                root = self.chain.process_gossip_blob(sc)
                if root is not None:
                    self._retry_pending_sidecars(root)
            except BlobIgnoreError as e:
                if e.retriable and e.missing_parent is not None:
                    self._stash_pending_sidecar(e.missing_parent, sc)
            except Exception as e:  # noqa: BLE001 — one bad sidecar must
                _GOSSIP_ERRORS.labels("sidecar_retry").inc()  # not block
                log.warn("pending-sidecar retry failed; dropping it",
                         node=self.node_id, index=int(sc.index),
                         error=f"{type(e).__name__}: {e}")
                continue

    def _drain_early_sidecars(self) -> None:
        """Heartbeat hook: re-validate sidecars whose slot has started."""
        now = self.chain.current_slot
        with self._lock:
            # `due` must be computed under the lock: gossip threads mutate
            # the dict (insert/evict) while holding it
            due = [s for s in self._early_sidecars if s <= now]
            for s in due:
                for sc in self._early_sidecars.pop(s, ()):
                    try:
                        root = self.chain.process_gossip_blob(sc)
                        if root is not None:
                            self._retry_pending_sidecars(root)
                    except BlobIgnoreError as e:
                        if e.retriable and e.missing_parent is not None:
                            self._stash_pending_sidecar(e.missing_parent, sc)
                    except Exception as e:  # noqa: BLE001 — one bad early
                        _GOSSIP_ERRORS.labels("sidecar_drain").inc()
                        log.warn(              # sidecar must not block due
                            "early-sidecar revalidation failed; dropping it",
                            node=self.node_id, index=int(sc.index),
                            error=f"{type(e).__name__}: {e}",
                        )
                        continue

    def _lookup_parent(self, peer_id: str, signed) -> None:
        parent_root = bytes(signed.message.parent_root)
        try:
            self.sync.lookup_parent_chain(peer_id, parent_root)
        except Exception:
            return
        # the parent just imported: this block's OWN stashed sidecars (keyed
        # on its parent) must be fed to the DA checker BEFORE process_block,
        # or the block would raise AvailabilityPending while the node holds
        # every sidecar locally
        self._retry_pending_sidecars(parent_root)
        try:
            root = self.chain.process_block(signed)
        except Exception:
            return
        self._retry_pending_sidecars(root)

    def _mk_attestation_handler(self):
        def handler(msg):
            spec = self.chain.spec
            types = types_for_slot(spec, self.chain.current_slot)
            try:
                att = types.Attestation.deserialize(msg.decompressed)
            except Exception:
                return False
            if self.batch_gossip:
                from ..chain.beacon_processor import WorkItem, WorkKind
                from .gossipsub import PENDING

                if (
                    self.ingest_limiter is not None
                    and not self.ingest_limiter.allow("gossip_attestation")
                ):
                    return None   # over ingest quota: ignore, no penalty
                accepted = self.processor.submit(WorkItem(
                    kind=WorkKind.gossip_attestation,
                    payload=(att, msg.message_id),
                    run_batch=self._run_attestation_batch,
                    # shed-at-pop deadline: past the propagation window the
                    # verification result is unactionable
                    deadline_slot=self.admission.attestation_deadline_slot(
                        att.data.slot
                    ),
                    # a shed item must resolve its deferred validation or
                    # the PENDING entry strands until PENDING_TTL
                    on_shed=self._mk_shed_resolver(msg.message_id),
                ))
                # queue full -> oldest shed (its on_shed resolved the
                # displaced PENDING entry); admission refusal -> ignore
                return PENDING if accepted else None
            with self._lock:
                try:
                    results = self.chain.verify_unaggregated_attestations([att])
                except (AttestationError, BlockError):
                    return False
                for a, indices in results:
                    self.chain.apply_attestation_to_fork_choice(a, indices)
                    if self.op_pool is not None:
                        self.op_pool.insert_attestation(a, indices, types)
                # empty results = every attester already observed (a relayed
                # duplicate): gossip IGNORE, never a penalty — penalizing
                # honest relays −20 per duplicate decays the whole mesh
                return True if results else None

        return handler

    def _mk_shed_resolver(self, mid):
        """on_shed callback for a queued gossip work item: a shed/expired
        message resolves its deferred validation as a terminal ignore (no
        credit, no penalty, mid stays deduped)."""
        def resolve(_reason):
            self.gossipsub.report_validation_result(mid, None)

        return resolve

    def _run_attestation_batch(self, payloads):
        """Coalesced batch runner (pump thread): delegates the whole
        prepare -> ONE async device submission -> complete/fork-choice
        pipeline to chain.submit_attestation_batch, adding only the gossip
        deferred-validation bookkeeping (gossip_methods.rs
        process_gossip_attestation_batch analog)."""
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        atts = [a for a, _mid in payloads]
        prepared_ids: set = set()

        def on_prepared(prepared_atts):
            prepared_ids.update(id(a) for a in prepared_atts)
            # dropped at prepare = duplicate/unverifiable: terminal ignore
            for a, mid in payloads:
                if id(a) not in prepared_ids:
                    self.gossipsub.report_validation_result(mid, None)

        def on_done(results):
            valid_ids = {id(a) for a, _indices in results}
            for a, indices in results:
                if self.op_pool is not None:
                    self.op_pool.insert_attestation(a, indices, types)
            for a, mid in payloads:
                if id(a) in prepared_ids:
                    self.gossipsub.report_validation_result(
                        mid, id(a) in valid_ids
                    )

        with self._lock:
            try:
                pair = self.chain.submit_attestation_batch(
                    atts, on_done=on_done, on_prepared=on_prepared
                )
            except (AttestationError, BlockError):
                for _a, mid in payloads:
                    self.gossipsub.report_validation_result(mid, None)
                return None
        if pair is None:
            return None
        handle, cont = pair

        def wrapped(ok: bool):
            # chain mutation under the same lock the inline handlers use
            with self._lock:
                return cont(ok)

        return handle, wrapped

    def _on_aggregate(self, msg):
        spec = self.chain.spec
        types = types_for_slot(spec, self.chain.current_slot)
        try:
            signed = types.SignedAggregateAndProof.deserialize(msg.decompressed)
        except Exception:
            return False
        if self.batch_gossip:
            from ..chain.beacon_processor import WorkItem, WorkKind
            from .gossipsub import PENDING

            if (
                self.ingest_limiter is not None
                and not self.ingest_limiter.allow("gossip_aggregate")
            ):
                return None
            accepted = self.processor.submit(WorkItem(
                kind=WorkKind.gossip_aggregate,
                payload=(signed, msg.message_id),
                run_batch=self._run_aggregate_batch,
                deadline_slot=self.admission.attestation_deadline_slot(
                    signed.message.aggregate.data.slot
                ),
                on_shed=self._mk_shed_resolver(msg.message_id),
            ))
            return PENDING if accepted else None
        with self._lock:
            try:
                results = self.chain.verify_aggregated_attestations([signed])
            except (AttestationError, BlockError):
                return False
            for att, indices in results:
                self.chain.apply_attestation_to_fork_choice(att, indices)
                if self.op_pool is not None:
                    self.op_pool.insert_attestation(att, indices, types)
            # empty results = duplicate aggregator (already observed):
            # IGNORE, never a penalty (same mesh-decay hazard as the
            # unaggregated handler)
            return True if results else None

    def _run_aggregate_batch(self, payloads):
        """Coalesced aggregate runner: one multi-set device verification for
        the whole batch (3 sets per aggregate), then per-message gossip
        resolution (process_gossip_aggregate_batch analog)."""
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        signeds = [s for s, _mid in payloads]
        with self._lock:
            try:
                results = self.chain.verify_aggregated_attestations(signeds)
            except (AttestationError, BlockError):
                results = []
            valid_atts = set()
            for att, indices in results:
                valid_atts.add(id(att))
                self.chain.apply_attestation_to_fork_choice(att, indices)
                if self.op_pool is not None:
                    self.op_pool.insert_attestation(att, indices, types)
        # verify_aggregated_attestations returns the verified (aggregate,
        # indices); map back to the submitted containers by identity of the
        # embedded aggregate
        for signed, mid in payloads:
            self.gossipsub.report_validation_result(
                mid,
                True if id(signed.message.aggregate) in valid_atts else None,
            )
        return None

    def _on_blob(self, msg):
        spec = self.chain.spec
        types = types_for_slot(spec, self.chain.current_slot)
        try:
            sidecar = types.BlobSidecar.deserialize(msg.decompressed)
        except Exception:
            return False
        with self._lock:
            try:
                root = self.chain.process_gossip_blob(sidecar)
                # a returned root means the sidecar COMPLETED a block
                # import: children waiting on that block can now verify
                if root is not None:
                    self._retry_pending_sidecars(root)
            except BlobIgnoreError as e:
                # verification could not run. Three cases:
                #  - missing parent: retriable over gossip AND queued for a
                #    local retry when the parent imports
                #  - future slot: terminal for dedup (mesh duplicates must
                #    not burn retries) but queued for the slot start
                #  - duplicate/finalized: terminal, stay deduped
                if e.retry_at_slot is not None:
                    # hard-capped: these sidecars are UNVERIFIED (the
                    # future-slot check precedes proof/signature checks), so
                    # a flood of distinct junk must not grow memory
                    if (
                        sum(len(v) for v in self._early_sidecars.values())
                        < self.MAX_PENDING_SIDECARS
                    ):
                        self._early_sidecars.setdefault(
                            e.retry_at_slot, []
                        ).append(sidecar)
                        while len(self._early_sidecars) > 4:
                            # evict the FARTHEST future slot: junk for
                            # slot+5 must not displace the nearest-due
                            # bucket (which is about to be drained)
                            self._early_sidecars.pop(max(self._early_sidecars))
                    return None
                if e.retriable:
                    if e.missing_parent is not None:
                        self._stash_pending_sidecar(e.missing_parent, sidecar)
                    return IGNORE_RETRY
                return None
            except BlobError:
                return False
            except (BlockError, AvailabilityPendingError):
                # sidecar itself fully verified; only the joined block could
                # not import (yet) — still propagate
                return True
        return True

    # ------------------------------------------------------------ publishing

    def _make_ctx(self, _topic: str, trace_id: int | None = None
                  ) -> WireTraceContext:
        """Mint the compact origin context a publish (or Req/Resp request)
        carries on the wire: this node's id, a causal trace id, the slot,
        the logical publish offset, and the slot clock's raw time (logical
        under a ManualSlotClock, wall time live)."""
        clock = self.chain.slot_clock
        return WireTraceContext(
            origin=self.node_id,
            trace_id=trace_id if trace_id is not None else next_trace_id(),
            slot=int(clock.now() or 0),
            seq=next(self._pub_seq),
            sent_at=self.propagation.now(),
        )

    def request_ctx(self) -> WireTraceContext:
        """Origin context for outbound Req/Resp requests (transport CREQ
        frames). Reuses the in-flight trace's id when one is current, so a
        parent-lookup RPC fired from inside a block import joins that
        import's causal chain."""
        from ..observability.trace import current_trace

        tr = current_trace()
        return self._make_ctx(
            "", trace_id=tr.trace_id if tr is not None else None
        )

    def _publish(self, topic: str, ssz_payload: bytes) -> None:
        """Publish with a producer-side trace: one `publish` span whose
        wire context every remote validate/import span will adopt — the
        cross-node causal anchor the merged timeline's flow events key on."""
        tr = self.tracer.begin("gossip_publish")
        ctx = self._make_ctx(topic, trace_id=tr.trace_id)
        tr.adopt(ctx)
        t0 = perf_counter()
        try:
            self.gossipsub.publish(topic, ssz_payload, ctx=ctx)
        finally:
            # the trace lands (and feeds the stage histogram) even when
            # publish raises (oversized message) — the span still closed
            tr.add_span("publish", t0, perf_counter(),
                        topic=short_topic(topic))
            self.tracer.finish(tr)

    def publish_block(self, signed_block) -> None:
        types = types_for_slot(self.chain.spec, signed_block.message.slot)
        self._publish(
            gs.topic_name(self.fork_digest, "beacon_block"),
            types.SignedBeaconBlock.serialize(signed_block),
        )

    def publish_attestation(self, att, subnet_id: int) -> None:
        types = types_for_slot(self.chain.spec, att.data.slot)
        self._publish(
            gs.attestation_subnet_topic(self.fork_digest, subnet_id),
            types.Attestation.serialize(att),
        )

    def publish_aggregate(self, signed_agg) -> None:
        types = types_for_slot(self.chain.spec, signed_agg.message.aggregate.data.slot)
        self._publish(
            gs.topic_name(self.fork_digest, "beacon_aggregate_and_proof"),
            types.SignedAggregateAndProof.serialize(signed_agg),
        )

    def publish_blob(self, sidecar) -> None:
        types = types_for_slot(
            self.chain.spec, sidecar.signed_block_header.message.slot
        )
        self._publish(
            gs.blob_sidecar_topic(self.fork_digest, int(sidecar.index)),
            types.BlobSidecar.serialize(sidecar),
        )
