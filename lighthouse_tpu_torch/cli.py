"""lighthouse-tpu's PyTorch/CUDA port: the command line.

    python -m lighthouse_tpu_torch bn [--spec NAME|config.yaml] [--datadir DIR] ...
    python -m lighthouse_tpu_torch autotune calibrate [--smoke] [--out PATH] ...
    python -m lighthouse_tpu_torch autotune show [--profile PATH]

`bn` runs a beacon node (the JAX package's `cmd_bn`): the chain over the
native store, the p2p node (TCP transport, gossipsub, Req/Resp, range
sync), the Beacon HTTP API, the metrics server and the slot timer. Its BLS
backend defaults to "torch" and its tree-hash backend to "device": both
run on the card, and without one `bn` exits with the backend's error
("python", "fake" or "hybrid" and `--hash-backend host` serve from the
host).

`autotune calibrate` measures the BLS verification padding buckets on the
card (the "torch" backend; `--smoke`: a CPU dry-run on the "python"
backend and the small fixtures) and writes the autotune profile that
`autotune.runtime.autoload` installs; `autotune show` prints a profile and
the plan derived from it. The JAX package's CLI has more subcommands
(`bn`'s loadtest, doctor, perf and debug-bundle among them); they come
with the layers they drive.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def _add_spec_arg(p):
    p.add_argument(
        "--spec", default="mainnet",
        help="network name (mainnet/minimal/sepolia/holesky/gnosis) or a "
             "path to a config.yaml",
    )


def _load_spec(args):
    import os

    from .types.network_config import config_from_yaml, get_network_config

    looks_like_path = os.sep in args.spec or args.spec.endswith((".yaml", ".yml"))
    if looks_like_path and os.path.isfile(args.spec):
        with open(args.spec) as f:
            return config_from_yaml(f.read())
    return get_network_config(args.spec)


def _read_jwt_secret(path: str) -> bytes:
    """Hex JWT secret file (0x prefix tolerated) -> 32 raw bytes."""
    with open(path) as f:
        secret = bytes.fromhex(f.read().strip().removeprefix("0x"))
    if len(secret) != 32:
        raise ValueError(f"JWT secret must be 32 bytes, got {len(secret)}")
    return secret


# ------------------------------------------------------------------ bn


def cmd_bn(args):
    """Run a beacon node: chain + HTTP API + metrics (client/builder.rs)."""
    from .utils.logging import get_logger

    log = get_logger("beacon_node")
    from .chain.beacon_chain import BeaconChain
    from .api.http_api import serve
    from .crypto import bls
    from .state_transition.genesis import interop_genesis_state
    from .store.hot_cold import HotColdDB
    from .store.native_kv import NativeKVStore
    from .utils.metrics import metrics_http_server, HEAD_SLOT
    from .utils.slot_clock import SystemTimeSlotClock

    spec = _load_spec(args)
    import os as _os_env

    # hybrid-backend routing knobs ride env vars so the policy object can
    # be constructed lazily inside the registry (crypto/bls/hybrid.py)
    if getattr(args, "urgent_max_sets", None) is not None:
        _os_env.environ["LIGHTHOUSE_TPU_URGENT_MAX_SETS"] = str(args.urgent_max_sets)
    if getattr(args, "device_p99_budget_ms", None) is not None:
        _os_env.environ["LIGHTHOUSE_TPU_DEVICE_P99_BUDGET_MS"] = str(
            args.device_p99_budget_ms
        )
    if getattr(args, "device_probe_wait", None) is not None:
        _os_env.environ["LIGHTHOUSE_TPU_DEVICE_PROBE_WAIT_SECS"] = str(
            args.device_probe_wait
        )
    # pipelined-executor knobs (crypto/torchbls/pipeline.py) ride env for
    # the same reason: the dispatcher constructs lazily inside the
    # backend, and env sits above the autotune profile in precedence
    if getattr(args, "pipeline_depth", None) is not None:
        _os_env.environ["LIGHTHOUSE_TPU_PIPELINE_DEPTH"] = str(
            args.pipeline_depth
        )

    # autotune: install this device's persisted profile BEFORE the backend
    # and processor construct, so the hybrid router's knobs and the batch
    # caps derive from measured numbers (autotune/). Explicit
    # flags/env stay the stronger layer (knob precedence: profile < env <
    # constructor/CLI). Gated to device-backed backends unless the operator
    # pins a profile path explicitly — a python/fake node must not spend a
    # device-detection wait at startup.
    device_backed = args.bls_backend in ("torch", "hybrid")
    autotune_on = not args.no_autotune and (
        device_backed or args.autotune_profile is not None
    )
    if autotune_on:
        from .autotune import runtime as _at_runtime

        _at_runtime.autoload(path=args.autotune_profile)

    try:
        bls.set_backend(args.bls_backend)
    except RuntimeError as e:
        # "torch" without a card: the node must not verify on the CPU
        print(f"error: --bls-backend {args.bls_backend}: {e}", file=sys.stderr)
        return 1

    # the second device workload (torchhash/): tree-hash / state-root
    # routing. "device" is the default — large merkleizations and the epoch
    # vectors go to the card (bit-exact against hashlib); "hybrid" adds the
    # breaker's host fallback; "host" keeps hashlib.
    if getattr(args, "hash_backend", None):
        from .torchhash.router import set_hash_backend

        _os_env.environ["LIGHTHOUSE_TPU_HASH_BACKEND"] = args.hash_backend
        set_hash_backend(args.hash_backend)
    from .torchhash.router import hash_backend as _hash_backend

    if _hash_backend() in ("device", "hybrid"):
        from .torchhash.router import start_warmup as _hash_warmup

        # warm the plan's tree-hash ladders in the background (the autotune
        # profile carries tree_hash_buckets; default is the registry scale)
        # — same degradation contract as the BLS warmup
        _hash_warmup()
        log.info("tree-hash backend selected", hash_backend=_hash_backend())

    if autotune_on and device_backed:
        # warm the plan's buckets in the background (daemon thread; a
        # failure degrades to first-use cost on the first dispatch, never a
        # blocked node). Without a profile this warms the two
        # highest-traffic default buckets — the first node-path caller of
        # torchbls warm_stages.
        from .autotune import runtime as _at_runtime
        from .utils.supervisor import Supervisor as _Supervisor

        _at_runtime.start_warmup(
            supervisor=_Supervisor(name="autotune", max_restarts=2)
        )
        log.info("autotune warmup started (supervised)",
                 buckets=str(list(_at_runtime.warmup_buckets())))

    if args.zero_ports:
        args.http_port = 0
        args.metrics_port = 0
        args.p2p_port = 0

    from .utils.task_executor import Lockfile, TaskExecutor

    # store FIRST: a datadir holding a persisted chain can supply the whole
    # start state (restart resume), making the genesis-source flags optional
    store = None
    lock = None
    if args.datadir:
        import os

        os.makedirs(args.datadir, exist_ok=True)
        # exclusive datadir ownership (common/lockfile): two nodes sharing a
        # datadir is how operators get slashed
        lock = Lockfile(f"{args.datadir}/beacon.lock")
        lock.acquire()
        if args.purge_db:
            import glob as _glob

            purged = 0
            for pat in ("hot.db*", "cold.db*"):
                for f in _glob.glob(os.path.join(args.datadir, pat)):
                    os.remove(f)
                    purged += 1
            log.info("database purged", files=purged)
        from .store.hot_cold import StoreConfig

        store = HotColdDB(
            spec,
            hot=NativeKVStore(f"{args.datadir}/hot.db", fsync=args.fsync),
            cold=NativeKVStore(f"{args.datadir}/cold.db", fsync=args.fsync),
            config=StoreConfig(
                slots_per_restore_point=args.slots_per_restore_point,
                compact_on_migration=not args.no_compact_on_migration,
            ),
        )
        if args.compact_db:
            store.hot.compact()
            store.cold.compact()
            log.info("databases compacted")

    def bail(code: int = 1) -> int:
        # early-exit path between lock acquisition and the run loop: a
        # validation error must not leave the datadir's beacon.lock held
        # by a dead pid (or the store half-open)
        if store is not None:
            store.close()
        if lock is not None:
            lock.release()
        return code

    execution_layer = None
    if args.engine:
        from .chain.execution_layer import ExecutionLayer
        from .execution.engine_api import EngineApiClient, MockExecutionLayer

        if args.engine == "mock":
            engine = MockExecutionLayer()
        else:
            if not args.jwt_secret:
                print("error: --engine requires --jwt-secret", file=sys.stderr)
                return bail()
            secret = _read_jwt_secret(args.jwt_secret)
            engine = EngineApiClient(
                args.engine, secret, timeout=args.execution_timeout
            )
        fee = (
            bytes.fromhex(args.fee_recipient[2:])
            if args.fee_recipient
            else b"\x00" * 20
        )
        execution_layer = ExecutionLayer(engine, spec, default_fee_recipient=fee)
        log.info("execution engine connected", url=args.engine)

    from .chain.beacon_chain import BlockError, ChainConfig

    chain_cfg = ChainConfig(
        reorg_threshold_percent=args.reorg_threshold,
        import_max_skip_slots=args.max_skip_slots,
        epochs_per_migration=args.epochs_per_migration,
        slasher_history_epochs=args.slasher_history_length,
    )

    # restart resume: a datadir with a persisted head restarts from it
    # (builder.rs resume path); a corrupt/incomplete persist record falls
    # back to the configured start anchor below
    chain = None
    if store is not None and store.get_chain_item(
        BeaconChain.PERSIST_HEAD_KEY
    ) is not None:
        try:
            chain = BeaconChain.from_store(
                spec, store, execution_layer=execution_layer, config=chain_cfg
            )
        except BlockError as e:
            log.warn(
                "persisted chain unusable; starting from the configured "
                "anchor", error=str(e),
            )
    if chain is not None:
        # resume built the chain on a manual clock (wall time was unknown
        # until the anchor state supplied genesis_time): swap in the real
        # clock and re-tick fork choice to the current slot
        clock = SystemTimeSlotClock(
            int(chain.head_state().genesis_time), spec.seconds_per_slot
        )
        chain.slot_clock = clock
        chain.recompute_head()
        log.info(
            "restart resume complete",
            head=chain.head_root.hex()[:8],
            head_slot=chain.block_slots.get(chain.head_root),
            wall_slot=clock.now(),
        )
    anchor_block = None
    state = None
    if chain is not None:
        pass          # resumed from the datadir; no start anchor needed
    elif args.interop_validators:
        keypairs = bls.interop_keypairs(args.interop_validators)
        genesis_time = args.genesis_time or int(time.time())
        state = interop_genesis_state(keypairs, genesis_time, spec)
    elif args.genesis_state:
        from .state_transition.slot import types_for_slot as _tfs

        raw = open(args.genesis_state, "rb").read()
        state = _tfs(spec, 0).BeaconState.deserialize(raw)
    elif args.checkpoint_state:
        # weak-subjectivity start from a finalized state + its block
        # (client/src/builder.rs:366-528); backfill then fetches history
        from .state_transition.slot import types_for_slot as _tfs

        if not args.checkpoint_block:
            print("error: --checkpoint-state requires --checkpoint-block",
                  file=sys.stderr)
            return bail()
        raw = open(args.checkpoint_state, "rb").read()
        # every fork's BeaconState starts genesis_time(8) ||
        # genesis_validators_root(32) || slot(8): read the slot to pick the
        # fork's container types before the full decode
        slot = int.from_bytes(raw[40:48], "little")
        types = _tfs(spec, slot)
        state = types.BeaconState.deserialize(raw)
        anchor_block = types.SignedBeaconBlock.deserialize(
            open(args.checkpoint_block, "rb").read()
        )
    elif getattr(args, "checkpoint_sync_url", None):
        # weak-subjectivity start over HTTP: download the finalized
        # state+block pair from a trusted BN (client/src/builder.rs:366-390;
        # server side is get_debug_state + get_block_ssz)
        from .api.client import BeaconNodeHttpClient
        from .state_transition.slot import types_for_slot as _tfs

        remote = BeaconNodeHttpClient(args.checkpoint_sync_url, timeout=60.0)
        log.info("checkpoint sync: downloading finalized state",
                 url=args.checkpoint_sync_url)
        # the state and block are fetched in two requests; finalization can
        # advance between them, so the pair must be VERIFIED consistent
        # (block commits to the state) and refetched on a boundary race
        for attempt in range(3):
            raw = remote.debug_state_ssz("finalized")
            slot = int.from_bytes(raw[40:48], "little")
            types = _tfs(spec, slot)
            state = types.BeaconState.deserialize(raw)
            anchor_block = types.SignedBeaconBlock.deserialize(
                remote.block_ssz("finalized")
            )
            if bytes(anchor_block.message.state_root) == (
                types.BeaconState.hash_tree_root(state)
            ):
                break
            log.warn("checkpoint sync: state/block pair inconsistent "
                     "(finalization advanced mid-download); refetching",
                     attempt=attempt)
        else:
            print("error: checkpoint-sync pair never converged",
                  file=sys.stderr)
            return bail()
        log.info("checkpoint sync: anchor downloaded", slot=slot)
    else:
        print(
            "error: provide --interop-validators N, --genesis-state FILE, "
            "--checkpoint-state FILE --checkpoint-block FILE, or "
            "--checkpoint-sync-url URL (or a --datadir holding a "
            "persisted chain to resume)",
            file=sys.stderr,
        )
        return bail()

    if args.wss_checkpoint and chain is not None:
        log.info("restart resume: --wss-checkpoint was verified when this "
                 "datadir first synced; not re-checked")
    elif args.wss_checkpoint:
        # weak-subjectivity pin: the start anchor must BE the operator's
        # checkpoint (checkpoint.rs wss verification role)
        try:
            root_hex, _, epoch_s = args.wss_checkpoint.partition(":")
            wss_root = bytes.fromhex(root_hex.removeprefix("0x"))
            wss_epoch = int(epoch_s)
        except ValueError:
            print("error: --wss-checkpoint must be 0xROOT:EPOCH",
                  file=sys.stderr)
            return bail()
        if anchor_block is None:
            # a genesis/interop start builds history itself; enforcing a
            # wss pin requires an anchor to compare against — refuse to
            # silently drop a SECURITY flag
            print(
                "error: --wss-checkpoint requires a checkpoint start "
                "(--checkpoint-state/--checkpoint-sync-url); genesis "
                "starts have no anchor to verify against",
                file=sys.stderr,
            )
            return bail()
        anchor_root = type(anchor_block.message).hash_tree_root(
            anchor_block.message
        )
        # checkpoint providers hand out (root of the last block before the
        # boundary, checkpoint epoch): with a skipped boundary slot the
        # block's slot sits in the PREVIOUS epoch, so compare against the
        # ceiling epoch; root equality is the binding check
        spe = spec.preset.SLOTS_PER_EPOCH
        anchor_epoch = (int(anchor_block.message.slot) + spe - 1) // spe
        if anchor_root != wss_root or anchor_epoch != wss_epoch:
            print(
                f"error: anchor {anchor_root.hex()}:{anchor_epoch} does not "
                f"match --wss-checkpoint {wss_root.hex()}:{wss_epoch}",
                file=sys.stderr,
            )
            return bail()
        log.info("weak-subjectivity checkpoint verified", epoch=wss_epoch)

    if chain is None:
        clock = SystemTimeSlotClock(state.genesis_time, spec.seconds_per_slot)
        chain = BeaconChain(
            spec, state, store=store, slot_clock=clock,
            execution_layer=execution_layer, anchor_block=anchor_block,
            config=chain_cfg,
        )
    chain.shuffling_cache.capacity = args.shuffling_cache_size
    chain.state_cache.capacity = args.state_cache_size
    graffiti_text = args.graffiti
    if graffiti_text is None and getattr(args, "graffiti_file", None):
        with open(args.graffiti_file) as f:
            graffiti_text = f.readline().rstrip("\n")
    if graffiti_text:
        g = graffiti_text.encode()
        if len(g) > 32:
            print("error: --graffiti exceeds 32 bytes utf-8", file=sys.stderr)
            return bail()
        chain.graffiti = g.ljust(32, b"\x00")
    def register_monitor_tokens(raw, source):
        for tok in raw.replace(",", " ").split():
            try:
                chain.monitor.register(int(tok))
            except ValueError:
                print(f"error: {source}: invalid validator index {tok!r}",
                      file=sys.stderr)
                return False
        return True

    if getattr(args, "monitor_validators", None):
        if args.monitor_validators.strip().lower() == "auto":
            chain.monitor.auto_register = True
            log.info("validator monitor: tracking ALL validators")
        else:
            if not register_monitor_tokens(args.monitor_validators,
                                           "--monitor-validators"):
                return bail()
            log.info("validator monitor enabled",
                     watched=len(chain.monitor.watched))
    if getattr(args, "validator_monitor_file", None):
        with open(args.validator_monitor_file) as f:
            if not register_monitor_tokens(f.read(),
                                           "--validator-monitor-file"):
                return bail()
        log.info("validator monitor file loaded",
                 watched=len(chain.monitor.watched))

    eth1_service = None
    if args.eth1:
        from .chain.eth1 import Eth1Service, MockEth1Rpc
        from .state_transition.slot import types_for_slot as _tfs

        if args.eth1 == "mock":
            eth1_rpc = MockEth1Rpc(spec.deposit_contract_address)
        else:
            from .execution.engine_api import EngineApiClient

            # plain JSON-RPC (no JWT) — reuse the HTTP transport with an
            # empty secret; eth1 nodes ignore the Authorization header
            eth1_rpc = EngineApiClient(args.eth1, b"\x00" * 32)
        eth1_service = Eth1Service(
            eth1_rpc, spec, _tfs(spec, 0),
            follow_distance=args.eth1_cache_follow_distance,
            batch_blocks=args.eth1_blocks_per_log_query,
        )
        chain.eth1_cache = eth1_service.cache
        log.info("eth1 endpoint connected", url=args.eth1)

    from .chain.op_pool import OperationPool
    from .state_transition.slot import types_for_slot as _tfs_pool

    if store is not None:
        # pending operations survive restarts (persistence.rs)
        op_pool = OperationPool.load(store, spec, _tfs_pool(spec, 0))
    else:
        op_pool = OperationPool(spec)
    slasher_svc = None
    if args.slasher:
        from .slasher.service import SlasherService
        from .state_transition.slot import types_for_slot as _tfs

        slasher_svc = SlasherService(
            op_pool=op_pool, types=_tfs(spec, 0)
        )
        chain.slasher = slasher_svc
        log.info("slasher enabled")

    net = None
    if not args.disable_p2p:
        from .network.node import NetworkNode
        from .types import helpers as _h

        fork = spec.fork_name_at_slot(chain.current_slot)
        digest = _h.compute_fork_digest(
            spec.fork_version(fork), chain.genesis_validators_root
        )
        import os as _os

        from .chain.beacon_processor import BeaconProcessorConfig

        # the live node is the process's ONE capacity controller: its
        # scheduler publishes retuned knobs through the autotune plan
        # listeners (chain/scheduler.py) so the hybrid router and the
        # torchbls dispatcher follow; in-process harnesses with several
        # processors keep actuation per-instance
        proc_cfg = BeaconProcessorConfig(scheduler_publish_plan=True)
        if args.max_attestation_batch is not None:
            # post-construction assignment: pin explicitly (constructor
            # args self-describe via __post_init__; attribute writes
            # cannot). A pinned cap is never retuned by the scheduler.
            proc_cfg.max_attestation_batch = args.max_attestation_batch
            proc_cfg.max_attestation_batch_explicit = True
        if args.max_aggregate_batch is not None:
            proc_cfg.max_aggregate_batch = args.max_aggregate_batch
            proc_cfg.max_aggregate_batch_explicit = True
        if args.max_inflight_batches is not None:
            proc_cfg.max_inflight = args.max_inflight_batches
            proc_cfg.max_inflight_explicit = True
        if args.processor_workers is not None:
            proc_cfg.num_workers = args.processor_workers

        def parse_hostports(raw, label):
            out = []
            for addr in (raw or "").split(","):
                if not addr:
                    continue
                host_s, _, port_s = addr.partition(":")
                if not port_s.isdigit():
                    log.warn(f"ignoring malformed {label}", peer=addr)
                    continue
                out.append((host_s, int(port_s)))
            return out

        static_peers = parse_hostports(args.static_peers, "static peer")
        # trust is enforced by the NETWORK layer, keyed on the dialable
        # address (NetworkNode trusted_addrs) — so it must be configured
        # BEFORE the listener accepts or discovery dials anyone. Trust
        # matching compares against the socket's NUMERIC peer IP, so
        # hostnames resolve here; a peer that fails to resolve is still
        # DIALED (the OS resolves at connect time) — it just cannot be
        # trust-matched until its name resolves
        trusted_peers = parse_hostports(args.trusted_peers, "trusted peer")
        trusted_resolved = set()
        for host_s, port_i in trusted_peers:
            import socket as _socket

            try:
                trusted_resolved.add((_socket.gethostbyname(host_s), port_i))
            except OSError as e:
                log.warn("trusted peer does not resolve (dialing anyway, "
                         "trust exemption inactive)",
                         peer=f"{host_s}:{port_i}", error=str(e))
        net = NetworkNode(
            chain,
            # unique even when --p2p-port 0 picks a random bound port
            node_id=f"bn-{chain.genesis_block_root.hex()[:8]}-{_os.urandom(3).hex()}",
            fork_digest=digest,
            port=args.p2p_port,
            listen_host=args.listen_address,
            trusted_addrs=trusted_resolved,
            heartbeat_interval=args.gossip_heartbeat_interval,
            subnets=args.subnets,
            op_pool=op_pool,
            encrypt=not args.disable_p2p_encryption,
            require_encryption=args.require_p2p_encryption,
            batch_gossip=not args.disable_gossip_batching,
            processor_config=proc_cfg,
            ingest_rate=args.gossip_ingest_rate,
            rpc_timeout=args.rpc_timeout,
        )
        log.info("p2p listening", addr=str(net.host.listen_addr),
                 fork_digest=digest.hex())
        if args.boot_nodes:
            net.enable_discovery(boot_nodes=args.boot_nodes.split(","))
            dialed = net.discover_and_dial(max_peers=args.target_peers)
            log.info("discovery bootstrap", dialed=dialed)

        def dial_static():
            for host_s, port_i in static_peers + trusted_peers:
                try:
                    net.host.dial(host_s, port_i)
                except Exception as e:
                    log.warn("peer dial failed",
                             peer=f"{host_s}:{port_i}", error=str(e))

        dial_static()

    from .observability import TRACER as _bn_tracer

    server, _t, port = serve(
        chain, op_pool=op_pool, host=args.http_address, port=args.http_port,
        allow_origin=args.http_allow_origin,
        rate_limit=args.http_rate_limit,
        http_threads=args.http_threads,
        request_timeout=args.http_request_timeout,
        tracer=_bn_tracer,
    )
    log.info("HTTP API started", addr=args.http_address, port=port,
             workers=server.http_threads,
             request_timeout=server.request_timeout)
    mserver, mport = metrics_http_server(
        host=args.metrics_address, port=args.metrics_port,
        allow_origin=args.metrics_allow_origin,
    )
    log.info("metrics server started", addr=args.metrics_address, port=mport)

    if getattr(args, "device_trace", False):
        # per-stage device attribution: every torchbls dispatch is followed
        # by event-timed per-stage resolves feeding torchbls_stage_* series
        # and device:<stage> lanes in the --trace-out export. Serializes
        # the dispatch pipeline — a diagnostic mode, not a serving mode.
        from .observability import device as _obs_device

        _obs_device.set_enabled(True)
        log.info("per-stage device attribution enabled (--device-trace); "
                 "dispatch pipelining is serialized while active")

    # slot-level SLO accounting + flight recorder (observability/slo.py,
    # flight_recorder.py): the accountant attributes pipeline events to
    # slots via the chain clock and the slot timer below closes one
    # SlotReport per boundary; with a datadir, incident triggers (breaker
    # open, burn rate, miss streak) dump diagnosis snapshots to
    # <datadir>/incidents for `bn debug-bundle` to package.
    from .observability import flight_recorder as obs_fr
    from .observability import slo as obs_slo

    obs_slo.ACCOUNTANT.bind_clock(clock)
    if args.datadir:
        obs_fr.RECORDER.configure(
            incident_dir=_os_env.path.join(args.datadir, "incidents"),
            clock=clock,
            slo_provider=obs_slo.ACCOUNTANT.snapshot,
        )
        log.info("flight recorder armed",
                 incident_dir=_os_env.path.join(args.datadir, "incidents"))

    tracer = None
    if getattr(args, "trace_out", None):
        # pipeline tracing is always on (bounded ring); --trace-out adds a
        # Chrome trace-event export at shutdown. The startup probe pushes a
        # synthetic batch through a real BeaconProcessor so even a node
        # with no gossip traffic exports spans for every pipeline stage.
        from .observability import TRACER, pipeline as obs_pipeline

        tracer = TRACER
        tracer.out_path = args.trace_out
        executed = obs_pipeline.run_probe()
        log.info("pipeline trace probe complete", work_units=executed,
                 trace_out=args.trace_out)

    executor = TaskExecutor(name="bn", log=lambda m: log.info(m))

    # graceful termination: SIGTERM takes the same drain -> persist ->
    # flush path as Ctrl-C (beacon_chain.rs persist-on-shutdown analog)
    import signal as _signal

    try:
        _signal.signal(
            _signal.SIGTERM, lambda _s, _f: executor.shutdown("SIGTERM")
        )
    except ValueError:
        pass  # not the main thread (embedded/test use): signals stay default

    # persist the chain head whenever finalization advances, so a hard
    # crash loses at most the work since the last finalized checkpoint
    last_persisted_fin = [chain.fork_choice.store.finalized_checkpoint[0]]

    def persist_on_finalization():
        if store is None:
            return
        fin_epoch = chain.fork_choice.store.finalized_checkpoint[0]
        if fin_epoch > last_persisted_fin[0]:
            last_persisted_fin[0] = fin_epoch
            chain.persist()
            log.info("chain persisted on finalization",
                     finalized_epoch=fin_epoch)

    def slot_timer(exit_signal):
        while not exit_signal.wait(clock.duration_to_next_slot()):
            chain.per_slot_task()
            persist_on_finalization()
            # close the just-finished slot's SLO report (watermarked: a
            # missed tick emits empty reports for the skipped slots);
            # pre-genesis ticks (now() None) and slot 0 have no finished
            # slot to close
            now_slot = clock.now()
            if now_slot is not None and now_slot >= 1:
                obs_slo.ACCOUNTANT.close_slot(now_slot - 1)
                if net is not None:
                    # propagation-stall bookkeeping: peers connected but
                    # nothing delivered over gossip for consecutive slots
                    # fires the propagation_stall incident (hysteresis:
                    # the next delivery re-arms)
                    net.propagation.close_slot(
                        now_slot - 1, peers=len(net.host.connections)
                    )
            head_slot = chain.head_state().slot
            HEAD_SLOT.set(head_slot)
            log.info("slot", slot=clock.now(), head=chain.head_root.hex()[:8])
            now = clock.now() or 0
            if (
                args.shutdown_after_sync
                and chain.oldest_block_slot == 0
                and head_slot + 1 >= now
            ):
                log.info("synced (backfill complete, head current); "
                         "shutting down per --shutdown-after-sync")
                executor.shutdown("synced")
                return
            if slasher_svc is not None and now % spec.preset.SLOTS_PER_EPOCH == 0:
                found = slasher_svc.process()
                if found:
                    log.warn("slasher broadcast slashings", count=found)
            if eth1_service is not None:
                n = eth1_service.poll_once()
                if n:
                    log.info("eth1 deposits ingested", count=n)
            # slot tail: pre-compute the next-slot head state
            # (state_advance_timer analog)
            chain.advance_head_state()
            # keep the peer count topped up, once per epoch — on a helper
            # thread: each dial can block seconds and must not stall the
            # slot timer. Peerless nodes re-dial their static peers too
            # (transient startup failures must not strand the node).
            deficit = (
                args.target_peers - len(net.host.connections)
                if net is not None else 0
            )
            if deficit > 0 and now % spec.preset.SLOTS_PER_EPOCH == 1:

                def topup(deficit=deficit):
                    if not net.host.connections:
                        dial_static()
                    if getattr(net, "discovery", None) is not None:
                        net.discover_and_dial(max_peers=deficit)

                threading.Thread(target=topup, name="peer-topup",
                                 daemon=True).start()

    executor.spawn(slot_timer, "slot-timer")
    try:
        executor.exit_signal.wait()
    except KeyboardInterrupt:
        executor.shutdown("SIGINT")
    finally:
        # graceful drain: stop taking new work, finish what's queued
        # (bounded), THEN persist — so the persisted head reflects every
        # import the drain completed (service.rs shutdown ordering)
        server.shutdown()
        mserver.shutdown()
        if net is not None:
            net.close(drain_timeout=args.drain_timeout)
        if tracer is not None:
            try:
                n_events = tracer.write_chrome_trace(tracer.out_path)
                log.info("pipeline trace written", path=tracer.out_path,
                         events=n_events)
            except OSError as e:
                log.warn("pipeline trace write failed", error=str(e))
        if store is not None:
            chain.persist()
            op_pool.persist(store, _tfs_pool(spec, 0))
            store.close()
            log.info("chain persisted; store flushed and closed",
                     head=chain.head_root.hex()[:8],
                     head_slot=chain.block_slots.get(chain.head_root))
        if lock is not None:
            lock.release()
    return 1 if executor.panicked else 0


# ------------------------------------------------------------ autotune


def cmd_autotune(args):
    """`autotune calibrate` — measure this card's padding buckets and
    write its profile; `autotune show` — print a profile + derived plan
    (lighthouse_tpu_torch/autotune)."""
    import dataclasses

    from .autotune import calibrate as _cal
    from .autotune import planner as _planner
    from .autotune import profile as _prof

    if args.autotune_command == "calibrate":
        _profile, path = _cal.run_from_args(args)
        print(json.dumps({"profile": path}))
        return 0
    if args.autotune_command == "show":
        path = args.profile
        if path is None:
            # bounded detection: a first CUDA call must not hang this
            # command (the same guard as the runtime's autoload)
            from .autotune import runtime as _at_runtime

            key = _at_runtime.detect_device_key(wait_secs=10.0)
            if key is None:
                print("device detection failed or timed out; pass "
                      "--profile PATH explicitly", file=sys.stderr)
                return 1
            path = _prof.default_path(key)
        try:
            p = _prof.load(path)
        except FileNotFoundError:
            print(f"no autotune profile at {path} "
                  f"(run `autotune calibrate` on the device)",
                  file=sys.stderr)
            return 1
        except (ValueError, json.JSONDecodeError) as e:
            print(f"unreadable autotune profile at {path}: {e}",
                  file=sys.stderr)
            return 1
        plan = _planner.plan_from_profile(p)
        print(json.dumps(
            {"path": path, "plan": dataclasses.asdict(plan),
             "profile": p.to_json()},
            indent=1,
        ))
        return 0
    print("unknown autotune command", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lighthouse-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    # allow_abbrev=False: flags are matched whole, as in the JAX package's
    # parser (whose sub-subcommands would otherwise prefix-match them)
    bn = sub.add_parser("bn", help="run a beacon node", allow_abbrev=False)
    _add_spec_arg(bn)
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--metrics-port", type=int, default=5054)
    bn.add_argument("--datadir", default=None)
    bn.add_argument("--interop-validators", type=int, default=None)
    bn.add_argument("--genesis-time", type=int, default=None)
    bn.add_argument(
        "--bls-backend", default="torch",
        choices=["python", "torch", "fake", "hybrid"],
        help="BLS verification backend: 'torch' (default) verifies on the "
             "card and fails at startup without one; 'hybrid' routes "
             "urgent/small verifies to the host while the card is cold, "
             "absent, or over its latency budget; 'python' and 'fake' "
             "serve from the host",
    )
    bn.add_argument(
        "--hash-backend", default="device",
        choices=["host", "device", "hybrid"],
        help="tree-hash / state-root backend (torchhash/): 'device' "
             "(default) routes large merkleizations and the epoch vectors "
             "to the card; 'hybrid' adds the circuit-breaker guard with a "
             "hashlib fallback; 'host' keeps the hashlib ladder (small "
             "trees stay on the host either way — every device result is "
             "bit-exact vs hashlib)",
    )
    bn.add_argument("--slasher", action="store_true", help="enable the slasher")
    bn.add_argument(
        "--engine", default=None,
        help="execution engine URL (engine API JSON-RPC), or 'mock' for the "
             "in-process EL double",
    )
    bn.add_argument(
        "--jwt-secret", default=None,
        help="path to the hex-encoded engine-API JWT secret file",
    )
    bn.add_argument(
        "--fee-recipient", default=None,
        help="default fee recipient address (0x-hex, 20 bytes)",
    )
    bn.add_argument(
        "--eth1", default=None,
        help="eth1 JSON-RPC endpoint for deposit-log scraping, or 'mock'",
    )
    bn.add_argument(
        "--monitor-validators", default=None,
        help="comma list of validator indices to track (per-epoch summaries, "
             "missed-block/attestation alerts, /lighthouse_tpu/ui/"
             "validator-metrics), or 'auto' to track every validator",
    )
    bn.add_argument("--p2p-port", type=int, default=9000,
                    help="TCP listen port for the p2p stack (0 = random)")
    bn.add_argument("--disable-p2p", action="store_true",
                    help="run without the p2p stack (HTTP/metrics only)")
    bn.add_argument("--boot-nodes", default=None,
                    help="comma list of discovery boot nodes (host:udp_port)")
    bn.add_argument("--static-peers", default=None,
                    help="comma list of peers to dial directly (host:tcp_port)")
    bn.add_argument("--target-peers", type=int, default=16)
    bn.add_argument("--disable-p2p-encryption", action="store_true",
                    help="plaintext transport (EHELLO/AES-GCM is the default)")
    bn.add_argument("--require-p2p-encryption", action="store_true",
                    help="reject peers that refuse transport encryption")
    bn.add_argument("--graffiti", default=None,
                    help="default block graffiti (<=32 bytes utf-8)")
    bn.add_argument("--genesis-state", default=None,
                    help="SSZ BeaconState file to start from (genesis)")
    bn.add_argument("--checkpoint-state", default=None,
                    help="SSZ finalized BeaconState for checkpoint start")
    bn.add_argument("--checkpoint-block", default=None,
                    help="SSZ SignedBeaconBlock matching --checkpoint-state")
    bn.add_argument("--checkpoint-sync-url", default=None,
                    help="beacon-node URL to download the finalized "
                         "state+block pair from (weak-subjectivity start "
                         "over HTTP instead of local files)")
    # -- addresses / servers
    bn.add_argument("--http-address", default="127.0.0.1",
                    help="bind address for the Beacon API server")
    bn.add_argument("--metrics-address", default="127.0.0.1",
                    help="bind address for the Prometheus /metrics server")
    # -- store
    bn.add_argument("--slots-per-restore-point", type=int, default=2048,
                    help="freezer restore-point cadence (storage/replay "
                         "trade-off)")
    bn.add_argument("--fsync", default="batch",
                    choices=["always", "batch", "never"],
                    help="store durability policy: fsync every record "
                         "(always), every 64 records + at persist points "
                         "(batch, the default), or leave writes to the OS "
                         "page cache (never; crash-consistent but may "
                         "lose acknowledged work on power loss)")
    bn.add_argument("--drain-timeout", type=float, default=5.0,
                    help="seconds to let the beacon processor finish "
                         "queued work on shutdown before shedding it "
                         "(graceful SIGTERM/SIGINT drain)")
    bn.add_argument("--no-compact-on-migration", action="store_true",
                    help="skip store compaction during finalization "
                         "migration")
    # -- chain
    bn.add_argument("--reorg-threshold", type=int, default=20,
                    help="proposer re-org weight threshold (percent of "
                         "committee weight)")
    bn.add_argument("--max-skip-slots", type=int, default=None,
                    help="reject blocks skipping more than this many slots "
                         "from their parent (DoS guard; default unlimited)")
    bn.add_argument("--shuffling-cache-size", type=int, default=16,
                    help="committee shuffling cache entries")
    # -- execution
    bn.add_argument("--execution-timeout", type=float, default=8.0,
                    help="engine-API HTTP timeout seconds")
    bn.add_argument("--rpc-timeout", type=float, default=None,
                    help="p2p Req/Resp round-trip budget in seconds "
                         "(default: LIGHTHOUSE_TPU_RPC_TIMEOUT env or 10); "
                         "range-sync batch requests add per-block streaming "
                         "time on top, so a stuck peer costs one deadline "
                         "and a failover, never a stalled range")
    # -- gossip / processor
    bn.add_argument("--gossip-heartbeat-interval", type=float, default=0.3,
                    help="gossipsub mesh-maintenance heartbeat seconds")
    bn.add_argument("--subnets", type=int, default=None,
                    help="attestation subnet count to subscribe (default: "
                         "spec value)")
    bn.add_argument("--disable-gossip-batching", action="store_true",
                    help="verify gossip attestations inline instead of "
                         "coalescing device-sized batches in the beacon "
                         "processor")
    bn.add_argument("--max-attestation-batch", type=int, default=None,
                    help="max gossip attestations coalesced per device "
                         "batch")
    bn.add_argument("--max-aggregate-batch", type=int, default=None,
                    help="max gossip aggregates coalesced per device batch")
    bn.add_argument("--max-inflight-batches", type=int, default=None,
                    help="device verification batches in flight before the "
                         "processor blocks on the oldest")
    bn.add_argument("--pipeline-depth", type=int, default=None,
                    help="torchbls dispatch double-buffering depth: batches "
                         "in flight while the host marshals the next "
                         "(default: the autotune profile's measured "
                         "depth, else 4)")
    bn.add_argument("--processor-workers", type=int, default=None,
                    help="beacon-processor worker threads")
    # -- hybrid BLS routing (crypto/bls/hybrid.py)
    bn.add_argument("--urgent-max-sets", type=int, default=None,
                    help="batches at or under this size may take the host "
                         "urgent path (hybrid backend)")
    bn.add_argument("--device-p99-budget-ms", type=float, default=None,
                    help="device verify p99 budget before small batches "
                         "reroute to the host (hybrid backend)")
    bn.add_argument("--device-probe-wait", type=float, default=None,
                    help="seconds to wait for the device probe at startup "
                         "before serving from the host (hybrid backend)")
    # -- autotune (autotune/)
    bn.add_argument("--no-autotune", action="store_true",
                    help="skip loading the device autotune profile and the "
                         "startup bucket warmup (serve on built-in "
                         "defaults)")
    bn.add_argument("--autotune-profile", default=None,
                    help="explicit autotune profile JSON to install "
                         "(default: this card's canonical path under "
                         "build/autotune)")
    bn.add_argument("--listen-address", default="127.0.0.1",
                    help="bind address for the p2p listener")
    bn.add_argument("--zero-ports", action="store_true",
                    help="bind HTTP/metrics/p2p to ephemeral ports (testing)")
    bn.add_argument("--purge-db", action="store_true",
                    help="wipe the beacon database in --datadir before start")
    bn.add_argument("--compact-db", action="store_true",
                    help="compact the hot and cold databases at startup")
    bn.add_argument("--http-allow-origin", default=None,
                    help="Access-Control-Allow-Origin header for the API")
    bn.add_argument("--metrics-allow-origin", default=None,
                    help="Access-Control-Allow-Origin header for /metrics")
    bn.add_argument("--trusted-peers", default=None,
                    help="comma list host:port — always dialed, never "
                    "scored down or banned")
    bn.add_argument("--eth1-blocks-per-log-query", type=int, default=1000,
                    help="eth1 deposit-log scan batch size")
    bn.add_argument("--eth1-cache-follow-distance", type=int, default=0,
                    help="eth1 blocks to lag behind head when caching")
    bn.add_argument("--slasher-history-length", type=int, default=4096,
                    help="slasher retention horizon in epochs")
    bn.add_argument("--epochs-per-migration", type=int, default=1,
                    help="finalized epochs between hot->cold migrations "
                    "(0 disables the background migrator)")
    bn.add_argument("--state-cache-size", type=int, default=32,
                    help="hot beacon-state LRU capacity")
    bn.add_argument("--validator-monitor-file", default=None,
                    help="file of validator indices (comma/newline) to "
                    "register with the validator monitor")
    bn.add_argument("--wss-checkpoint", default=None,
                    help="0xBLOCK_ROOT:EPOCH weak-subjectivity checkpoint "
                    "the start anchor must match")
    bn.add_argument("--shutdown-after-sync", action="store_true",
                    help="exit once backfill is complete and the head is "
                    "at the wall clock")
    bn.add_argument("--graffiti-file", default=None,
                    help="file whose first line is the block graffiti "
                         "(alternative to --graffiti)")
    # -- QoS (qos/)
    bn.add_argument("--http-rate-limit", type=float, default=None,
                    help="HTTP API token-bucket rate (requests/sec, burst "
                         "2x); over-quota requests get 429 + Retry-After "
                         "instead of queued work (default: unlimited)")
    bn.add_argument("--http-threads", type=int, default=None,
                    help="HTTP API worker-pool size; when every worker is "
                         "busy and the bounded queue is full, new "
                         "connections are shed with 503 + Retry-After "
                         "(default: LIGHTHOUSE_TPU_HTTP_THREADS or 8)")
    bn.add_argument("--http-request-timeout", type=float, default=None,
                    help="per-request header/body read deadline in "
                         "seconds — a slow-loris peer costs one worker at "
                         "most this long (default: "
                         "LIGHTHOUSE_TPU_HTTP_REQUEST_TIMEOUT or 10)")
    bn.add_argument("--gossip-ingest-rate", type=float, default=None,
                    help="gossip ingest token-bucket rate per batchable "
                         "kind (messages/sec, burst 2x); over-quota "
                         "messages become gossip IGNOREs before touching "
                         "the queues (default: unlimited)")
    bn.add_argument("--trace-out", default=None,
                    help="write the verification pipeline's span traces as "
                         "Chrome trace-event JSON (load in Perfetto) to "
                         "this path at shutdown; also runs a synthetic "
                         "pipeline probe at startup so a quiet node still "
                         "traces every stage")
    bn.add_argument("--device-trace", action="store_true",
                    help="attribute device time per stage (prepare/"
                         "h2c/pairs/pairing): event-timed resolves feed "
                         "torchbls_stage_device_seconds{stage,n_sets,n_pks} "
                         "and add device:<stage> lanes to the --trace-out "
                         "export; SERIALIZES the dispatch pipeline, so "
                         "use for diagnosis, not serving")
    bn.set_defaults(fn=cmd_bn)

    at = sub.add_parser(
        "autotune",
        help="device autotuner: calibrate or inspect the BLS pipeline "
             "profile (lighthouse_tpu_torch/autotune)",
    )
    atsub = at.add_subparsers(dest="autotune_command", required=True)
    atc = atsub.add_parser(
        "calibrate",
        help="measure the padding buckets on this card and write its "
             "profile (use --smoke for a CPU dry-run)",
    )
    from .autotune.calibrate import add_calibrate_args

    add_calibrate_args(atc)
    ats = atsub.add_parser(
        "show", help="print a device profile and the plan derived from it"
    )
    ats.add_argument("--profile", default=None,
                     help="profile path (default: this card's canonical "
                          "path under build/autotune)")
    for p_ in (atc, ats):
        p_.set_defaults(fn=cmd_autotune)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    raise SystemExit(main())
