"""Beacon HTTP API server (stdlib http.server; warp analog).

Parity surface: the load-bearing route families of
lighthouse/beacon_node/http_api/src/lib.rs —
  /eth/v1/beacon/genesis | states/{id}/root | states/{id}/finality_checkpoints
  /eth/v1/beacon/states/{id}/validators[/{vid}] | headers/{id} | blocks/{id}/root
  /eth/v2/beacon/blocks/{id}   POST /eth/v1/beacon/pool/attestations
  POST /eth/v2/beacon/blocks (publish: broadcast-then-import semantics)
  /eth/v1/node/health | version | syncing      /eth/v1/config/spec
  /eth/v1/validator/duties/attester/{epoch} (POST) | duties/proposer/{epoch}
  /eth/v1/validator/attestation_data           /eth/v1/events (SSE)
plus /lighthouse-style extras under /lighthouse_tpu/*.

JSON encoding follows the beacon-api conventions: quoted integers, 0x-hex
byte strings.
"""

from __future__ import annotations

import json
import os
import queue
import re
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from time import perf_counter

from ..observability.propagation import decode_ctx, encode_ctx
from ..observability.trace import set_current_wire_ctx
from ..state_transition import accessors as acc
from ..state_transition.slot import types_for_slot
from ..types import helpers as h
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

log = get_logger("http_api")

VERSION = "lighthouse-tpu-torch/0.1.0"

# request latency by route family (handler name, stable across path params
# — `get_validators` not `/eth/v1/.../states/head/validators`) and method:
# the http_api/src/metrics.rs HTTP_API_PATHS_TOTAL idiom with a histogram
_REQUEST_SECONDS = REGISTRY.histogram_vec(
    "http_api_request_seconds",
    "Beacon API request latency, by route family and method",
    ("route", "method"),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0, 30.0),
)

# saturation SLIs for the bounded worker pool: how much work is in the
# house (workers busy / sockets queued / connections parked), what was
# turned away and why, and which read stage ate a deadline. All labeled
# families — an unlabeled aggregate cannot answer "was that shed a
# saturation event or a shutdown drain", and lint_metrics enforces it.
_INFLIGHT = REGISTRY.gauge_vec(
    "http_api_inflight",
    "Beacon API work in flight, by kind (workers busy / queued / parked)",
    ("kind",),
)
_SHED_TOTAL = REGISTRY.counter_vec(
    "http_api_shed_total",
    "Beacon API connections shed by the admission gate, by reason",
    ("reason",),
)
_TIMEOUTS_TOTAL = REGISTRY.counter_vec(
    "http_api_timeouts_total",
    "Beacon API per-request read-deadline expiries, by stage",
    ("stage",),
)
_ERRORS_TOTAL = REGISTRY.counter_vec(
    "http_api_errors_total",
    "Beacon API handler errors, by stage",
    ("stage",),
)


def resolve_http_threads(explicit=None) -> int:
    """Worker-pool size: explicit flag > LIGHTHOUSE_TPU_HTTP_THREADS env >
    default 8 (the `bn --http-threads` knob, resolve_call_timeout idiom)."""
    if explicit is not None:
        return max(1, int(explicit))
    env = os.environ.get("LIGHTHOUSE_TPU_HTTP_THREADS")
    if env:
        return max(1, int(env))
    return 8


def resolve_http_request_timeout(explicit=None) -> float:
    """Per-request header/body read deadline: explicit flag >
    LIGHTHOUSE_TPU_HTTP_REQUEST_TIMEOUT env > default 10s — a slow-loris
    peer costs one worker at most this long (`bn --http-request-timeout`)."""
    if explicit is not None:
        return float(explicit)
    env = os.environ.get("LIGHTHOUSE_TPU_HTTP_REQUEST_TIMEOUT")
    if env:
        return float(env)
    return 10.0


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _u(x: int) -> str:
    return str(int(x))


def _checkpoint(cp) -> dict:
    return {"epoch": _u(cp.epoch), "root": _hex(cp.root)}


def _validator_json(i, v, balance) -> dict:
    return {
        "index": _u(i),
        "balance": _u(balance),
        "status": "active_ongoing",
        "validator": {
            "pubkey": _hex(v.pubkey),
            "withdrawal_credentials": _hex(v.withdrawal_credentials),
            "effective_balance": _u(v.effective_balance),
            "slashed": bool(v.slashed),
            "activation_eligibility_epoch": _u(v.activation_eligibility_epoch),
            "activation_epoch": _u(v.activation_epoch),
            "exit_epoch": _u(v.exit_epoch),
            "withdrawable_epoch": _u(v.withdrawable_epoch),
        },
    }


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message


from contextlib import contextmanager


@contextmanager
def _client_input():
    """Context manager for BODY PARSING in submission handlers: a malformed
    client payload (missing keys, wrong types, bad hex) maps to 400, while
    the same exception types escaping chain internals stay 500 faults."""
    try:
        yield
    except (KeyError, TypeError, ValueError) as e:
        raise ApiError(400, f"malformed body: {type(e).__name__}: {e}") from e


class BeaconApiHandler(BaseHTTPRequestHandler):
    """Routes are matched with regexes against (method, path)."""

    server_version = VERSION
    # HTTP/1.1: keep-alive by default, so the pooled client's reused
    # connections survive between requests (every response path sends
    # Content-Length — _json, _rate_limited, get_health)
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: the response goes out as header-flush + body write;
    # with Nagle on, the body write waits on the peer's delayed ACK
    # (~40ms per keep-alive request)
    disable_nagle_algorithm = True
    chain = None           # injected by serve()
    op_pool = None
    event_bus = None
    allow_origin = None    # --http-allow-origin: CORS on every response
    # optional Tracer: each served request records an `http_serve` trace,
    # adopting the caller's X-LH-Trace-Ctx wire context so an HTTP-served
    # duty's spans carry the producer's causal id in the merged timeline
    tracer = None
    # QoS token bucket over the whole API (qos/ratelimit.py,
    # scope "http_api"): requests over quota are answered 429 with a
    # Retry-After header instead of queuing work behind an overloaded
    # chain. None (the default) disables limiting; `bn --http-rate-limit`
    # wires it. /eth/v1/node/health is exempt — liveness probes must answer
    # precisely when the node is busiest.
    rate_limiter = None
    RATE_LIMIT_EXEMPT = ("/eth/v1/node/health",)

    def end_headers(self):
        if self.allow_origin:
            self.send_header("Access-Control-Allow-Origin", self.allow_origin)
        ctx = getattr(self, "_wire_ctx", None)
        if ctx is not None:
            # echo the adopted context so the caller can confirm the causal
            # join (hex — header-safe encoding of the wire bytes)
            self.send_header("X-LH-Trace-Ctx", encode_ctx(ctx).hex())
        super().end_headers()

    def handle(self):
        """One request per pool dispatch: the worker decides afterwards
        whether to park the connection for keep-alive re-admission or
        close it — a handler thread never loops on one peer's socket."""
        self.close_connection = True
        self.handle_one_request()

    def log_error(self, fmt, *args):
        # handle_one_request swallows TimeoutError internally (discarding
        # the connection) and this hook is the only signal it leaves —
        # count the header-stage deadline here; body-stage deadlines are
        # counted in _read_body where the stage is known precisely
        if str(fmt).startswith("Request timed out"):
            _TIMEOUTS_TOTAL.labels("header").inc()
    # Backpressure for the HEAVY publish paths (block/attestation/sync-
    # committee import runs verification inline in the handler thread):
    # bounded gates — work beyond the limit gets 503 immediately, like the
    # reference sheds API work when the beacon-processor queues are full
    # (Work::ApiRequestP0/P1 bounded queues). Two deliberate properties:
    #   * permits are acquired AFTER the request body is read/parsed, so a
    #     slow client holds only its own handler thread, never a permit
    #     (and the 503 is written with the body already drained — no RST
    #     racing the response on big block bodies);
    #   * block publishes (the proposal path — P0 in the reference) have
    #     their OWN gate, so a burst of attestation/sync-committee posts
    #     can never 503 a proposer's block.
    _block_publish_gate = threading.BoundedSemaphore(
        int(os.environ.get("LIGHTHOUSE_TPU_MAX_CONCURRENT_BLOCK_PUBLISHES", "2"))
    )
    _bulk_publish_gate = threading.BoundedSemaphore(
        int(os.environ.get("LIGHTHOUSE_TPU_MAX_CONCURRENT_PUBLISHES", "8"))
    )

    @contextmanager
    def _publish_permit(self, gate):
        """Call only AFTER the body is fully read (see class comment)."""
        if not gate.acquire(blocking=False):
            raise ApiError(503, "publish pipeline overloaded; retry")
        try:
            yield
        finally:
            gate.release()

    def log_message(self, *args):  # silence default stderr logging
        pass

    # ------------------------------------------------------------- plumbing

    def _json(self, payload, code=200):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, message):
        self._json({"code": code, "message": message}, code=code)

    def _read_body(self):
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            return None
        try:
            raw = self.rfile.read(length)
        except (TimeoutError, socket.timeout):
            # mid-body stall: the read deadline freed this worker — the
            # connection is poisoned (partial body unread), so close it
            _TIMEOUTS_TOTAL.labels("body").inc()
            self.close_connection = True
            raise ApiError(408, "body read timed out") from None
        if len(raw) < length:
            self.close_connection = True
            raise ApiError(400, "truncated body")
        return json.loads(raw)

    def _state_by_id(self, state_id: str):
        chain = self.chain
        if state_id == "head":
            return chain.head_state()
        if state_id == "genesis":
            state_id = "0"
        if state_id == "finalized":
            # best-effort: finalized state if cached, else head
            froot = chain.fork_choice.store.finalized_checkpoint[1]
            sroot = chain.state_root_by_block.get(froot)
            if sroot and sroot in chain.state_cache:
                return chain.state_cache[sroot]
            return chain.head_state()
        if state_id.startswith("0x"):
            root = bytes.fromhex(state_id[2:])
            st = chain.state_cache.get(root)
            if st is None:
                raise ApiError(404, "state not found")
            return st
        # slot number: search cache
        slot = int(state_id)
        for st in chain.state_cache.values():
            if st.slot == slot:
                return st
        raise ApiError(404, "state not found")

    def _block_root_by_id(self, block_id: str) -> bytes:
        chain = self.chain
        if block_id == "head":
            return chain.head_root
        if block_id == "genesis":
            return chain.genesis_block_root
        if block_id == "finalized":
            return chain.fork_choice.store.finalized_checkpoint[1]
        if block_id.startswith("0x"):
            return bytes.fromhex(block_id[2:])
        slot = int(block_id)
        for root, s in chain.block_slots.items():
            if s == slot:
                return root
        raise ApiError(404, "block not found")

    # ------------------------------------------------------------- dispatch

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _rate_limited(self):
        retry = self.rate_limiter.retry_after_secs("http_api")
        body = json.dumps(
            {"code": 429, "message": "rate limit exceeded; retry later"}
        ).encode()
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", str(retry))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, method):
        path = self.path.split("?")[0].rstrip("/")
        # caller-propagated wire context (X-LH-Trace-Ctx, hex of the gossip
        # envelope encoding): tolerant decode — a malformed context must
        # never fail the request it rode in on
        ctx = None
        raw_ctx = self.headers.get("X-LH-Trace-Ctx")
        if raw_ctx:
            try:
                ctx = decode_ctx(bytes.fromhex(raw_ctx))
            except ValueError:
                ctx = None
        self._wire_ctx = ctx
        if (
            self.rate_limiter is not None
            and path not in self.RATE_LIMIT_EXEMPT
            and not self.rate_limiter.allow("http_api")
        ):
            return self._rate_limited()
        tr = None
        if self.tracer is not None:
            if ctx is not None:
                set_current_wire_ctx(ctx)
            tr = self.tracer.begin("http_serve")
        try:
            for pattern, meth, fn in _ROUTES:
                m = re.fullmatch(pattern, path)
                if m and meth == method:
                    t0 = perf_counter()
                    try:
                        return fn(self, *m.groups())
                    finally:
                        t1 = perf_counter()
                        _REQUEST_SECONDS.labels(fn.__name__, method).observe(
                            t1 - t0
                        )
                        if tr is not None:
                            tr.add_span(fn.__name__, t0, t1,
                                        path=path, method=method)
            self._error(404, f"unknown route {path}")
        except ApiError as e:
            self._error(e.code, e.message)
        except ConnectionError:
            # the PEER died mid-exchange (reset/broken pipe while we wrote
            # the response) — not a handler fault, and there is no socket
            # left to send an error envelope on
            self.close_connection = True
        except Exception as e:  # noqa: BLE001
            from ..chain.beacon_chain import BlockError

            if isinstance(e, BlockError):
                # invalid submissions are client errors, not server faults
                # (publish_blocks.rs maps verification failures to 400)
                self._error(400, f"BlockError: {e}")
            elif isinstance(e, (ValueError, json.JSONDecodeError)):
                # malformed ids/params are client errors (warp's invalid-
                # param rejections map to 400); submission handlers wrap
                # body parsing in _client_input() for the KeyError/TypeError
                # shapes so internal faults keep surfacing as 500s
                self._error(400, f"invalid request: {type(e).__name__}: {e}")
            else:
                _ERRORS_TOTAL.labels("handler").inc()
                log.warn(
                    "handler fault", route=path, method=method,
                    error=f"{type(e).__name__}: {e}",
                )
                self._error(500, f"{type(e).__name__}: {e}")
        finally:
            if tr is not None:
                self.tracer.finish(tr)
            if ctx is not None:
                set_current_wire_ctx(None)

    # ------------------------------------------------------------- handlers

    def get_genesis(self):
        st = self.chain.head_state()
        self._json(
            {
                "data": {
                    "genesis_time": _u(st.genesis_time),
                    "genesis_validators_root": _hex(st.genesis_validators_root),
                    "genesis_fork_version": _hex(self.chain.spec.genesis_fork_version),
                }
            }
        )

    def get_state_root(self, state_id):
        st = self._state_by_id(state_id)
        types = types_for_slot(self.chain.spec, st.slot)
        self._json({"data": {"root": _hex(types.BeaconState.hash_tree_root(st))}})

    def get_finality_checkpoints(self, state_id):
        st = self._state_by_id(state_id)
        self._json(
            {
                "data": {
                    "previous_justified": _checkpoint(st.previous_justified_checkpoint),
                    "current_justified": _checkpoint(st.current_justified_checkpoint),
                    "finalized": _checkpoint(st.finalized_checkpoint),
                }
            }
        )

    def get_validators(self, state_id):
        st = self._state_by_id(state_id)
        self._json(
            {
                "data": [
                    _validator_json(i, v, st.balances[i])
                    for i, v in enumerate(st.validators)
                ]
            }
        )

    def get_validator(self, state_id, vid):
        st = self._state_by_id(state_id)
        if vid.startswith("0x"):
            pkb = bytes.fromhex(vid[2:])
            if len(pkb) != 48:
                raise ApiError(400, "validator pubkey must be 48 bytes")
            for i, v in enumerate(st.validators):
                if bytes(v.pubkey) == pkb:
                    return self._json({"data": _validator_json(i, v, st.balances[i])})
            raise ApiError(404, "validator not found")
        i = int(vid)
        if i >= len(st.validators):
            raise ApiError(404, "validator not found")
        self._json({"data": _validator_json(i, st.validators[i], st.balances[i])})

    def get_block_root(self, block_id):
        self._json({"data": {"root": _hex(self._block_root_by_id(block_id))}})

    def get_block(self, block_id):
        root = self._block_root_by_id(block_id)
        chain = self.chain
        slot = chain.block_slots.get(root)
        if slot is None:
            raise ApiError(404, "block not found")
        types = types_for_slot(chain.spec, slot)
        blk = chain.store.get_block(root, types)
        if blk is None:
            raise ApiError(404, "block not found")
        self._json(
            {
                "version": chain.spec.fork_name_at_slot(slot).value,
                "data": {"message": {"slot": _u(blk.message.slot),
                                      "proposer_index": _u(blk.message.proposer_index),
                                      "parent_root": _hex(blk.message.parent_root),
                                      "state_root": _hex(blk.message.state_root)},
                          "signature": _hex(blk.signature),
                          "ssz": _hex(types.SignedBeaconBlock.serialize(blk))},
            }
        )

    def get_header(self, block_id):
        root = self._block_root_by_id(block_id)
        chain = self.chain
        slot = chain.block_slots.get(root)
        if slot is None:
            raise ApiError(404, "block not found")
        types = types_for_slot(chain.spec, slot)
        blk = chain.store.get_block(root, types)
        self._json(
            {
                "data": {
                    "root": _hex(root),
                    "canonical": True,
                    "header": {
                        "message": {
                            "slot": _u(blk.message.slot),
                            "proposer_index": _u(blk.message.proposer_index),
                            "parent_root": _hex(blk.message.parent_root),
                            "state_root": _hex(blk.message.state_root),
                            "body_root": _hex(
                                types.BeaconBlockBody.hash_tree_root(blk.message.body)
                            ),
                        },
                        "signature": _hex(blk.signature),
                    },
                }
            }
        )

    def get_health(self):
        """GET /eth/v1/node/health — reflects real signal instead of an
        unconditional 200: while the SLO burn rate exceeds its threshold or
        the device breaker is open the node is serving degraded, and a load
        balancer probing here should know (206 = serving-but-degraded, the
        beacon-api code the reference uses for a syncing-but-usable node).
        Stays rate-limit exempt; the check is two in-memory reads."""
        from ..observability import slo as obs_slo

        h = obs_slo.health()
        self.send_response(206 if h["degraded"] else 200)
        if h["degraded"]:
            # machine-visible reason without a body (health probes often
            # discard bodies): a header names what degraded
            self.send_header("X-Node-Degraded", ",".join(h["reasons"]))
        # bodyless response still needs an explicit length under HTTP/1.1
        # or the keep-alive peer would wait for a body that never comes
        self.send_header("Content-Length", "0")
        self.end_headers()

    def get_version(self):
        self._json({"data": {"version": VERSION}})

    def get_syncing(self):
        chain = self.chain
        head_slot = chain.head_state().slot
        current = chain.current_slot
        self._json(
            {
                "data": {
                    "head_slot": _u(head_slot),
                    "sync_distance": _u(max(0, current - head_slot)),
                    "is_syncing": current > head_slot + 1,
                    "is_optimistic": False,
                    "el_offline": True,
                }
            }
        )

    def get_spec(self):
        spec = self.chain.spec
        p = spec.preset
        self._json(
            {
                "data": {
                    "CONFIG_NAME": spec.config_name,
                    "PRESET_BASE": p.name,
                    "SLOTS_PER_EPOCH": _u(p.SLOTS_PER_EPOCH),
                    "SECONDS_PER_SLOT": _u(spec.seconds_per_slot),
                    "MAX_COMMITTEES_PER_SLOT": _u(p.MAX_COMMITTEES_PER_SLOT),
                    "TARGET_COMMITTEE_SIZE": _u(p.TARGET_COMMITTEE_SIZE),
                    "MAX_EFFECTIVE_BALANCE": _u(spec.max_effective_balance),
                    "GENESIS_FORK_VERSION": _hex(spec.genesis_fork_version),
                }
            }
        )

    def post_attester_duties(self, epoch):
        body = self._read_body() or []
        with _client_input():
            indices = [int(i) for i in body]
        from ..validator.beacon_node import InProcessBeaconNode

        node = InProcessBeaconNode(self.chain)
        duties = node.attester_duties(int(epoch), indices)
        self._json(
            {
                "dependent_root": _hex(self.chain.head_root),
                "execution_optimistic": False,
                "data": [
                    {
                        "pubkey": _hex(d.pubkey),
                        "validator_index": _u(d.validator_index),
                        "committee_index": _u(d.committee_index),
                        "committee_length": _u(d.committee_length),
                        "committees_at_slot": _u(d.committees_at_slot),
                        "validator_committee_index": _u(d.committee_position),
                        "slot": _u(d.slot),
                    }
                    for d in duties
                ],
            }
        )

    def get_proposer_duties(self, epoch):
        from ..validator.beacon_node import InProcessBeaconNode

        node = InProcessBeaconNode(self.chain)
        duties = node.proposer_duties(int(epoch))
        self._json(
            {
                "dependent_root": _hex(self.chain.head_root),
                "data": [
                    {
                        "pubkey": _hex(d.pubkey),
                        "validator_index": _u(d.validator_index),
                        "slot": _u(d.slot),
                    }
                    for d in duties
                ],
            }
        )

    def post_pool_attestations(self):
        body = self._read_body() or []
        chain = self.chain
        types = types_for_slot(chain.spec, chain.head_state().slot)
        atts = []
        with _client_input():
            for a in body:
                data = a["data"]
                att = types.Attestation.make(
                    aggregation_bits=_bits_from_hex(a["aggregation_bits"]),
                    data=types.AttestationData.make(
                        slot=int(data["slot"]),
                        index=int(data["index"]),
                        beacon_block_root=bytes.fromhex(data["beacon_block_root"][2:]),
                        source=types.Checkpoint.make(
                            epoch=int(data["source"]["epoch"]),
                            root=bytes.fromhex(data["source"]["root"][2:]),
                        ),
                        target=types.Checkpoint.make(
                            epoch=int(data["target"]["epoch"]),
                            root=bytes.fromhex(data["target"]["root"][2:]),
                        ),
                    ),
                    signature=bytes.fromhex(a["signature"][2:]),
                )
                atts.append(att)
        with self._publish_permit(self._bulk_publish_gate):
            verified = chain.verify_unaggregated_attestations(atts)
            for att, indices in verified:
                chain.apply_attestation_to_fork_choice(att, indices)
                if self.op_pool is not None:
                    self.op_pool.insert_attestation(att, indices, types)
        if len(verified) != len(atts):
            raise ApiError(400, f"{len(atts)-len(verified)} attestations failed")
        self._json({})

    def post_publish_block(self):
        body = self._read_body()
        chain = self.chain
        ssz_hex = body.get("ssz") if isinstance(body, dict) else None
        if not ssz_hex:
            raise ApiError(400, "expected {'ssz': '0x...'} body")
        # decode via head-fork types; forks with identical layouts decode fine
        types = types_for_slot(chain.spec, chain.current_slot)
        try:
            raw = bytes.fromhex(ssz_hex[2:])
            signed = types.SignedBeaconBlock.deserialize(raw)
        except Exception as e:  # noqa: BLE001
            _ERRORS_TOTAL.labels("block_ssz_decode").inc()
            log.warn("undecodable published block",
                     stage="block_ssz_decode",
                     error=f"{type(e).__name__}: {e}")
            raise ApiError(400, f"undecodable block SSZ: {e}") from e
        with self._publish_permit(self._block_publish_gate):
            self._import_published_block(signed)

    def _import_published_block(self, signed):
        """Shared import path for full + blinded publishes
        (publish_blocks.rs broadcast-then-import)."""
        chain = self.chain
        root = chain.verify_block_for_gossip(signed)
        # locally-produced deneb blocks: rebuild sidecars from the blobs
        # bundle the EL returned at production time (publish_blocks.rs)
        sidecars = chain.sidecars_for_produced_block(signed)
        chain.process_block(
            signed,
            block_root=root,
            proposal_already_verified=True,
            blobs=sidecars or None,
        )
        if self.event_bus is not None:
            self.event_bus.publish("block", {"slot": _u(signed.message.slot), "block": _hex(root)})
        self._json({})

    # -------------------------------------------------- more routes

    def _query(self) -> dict:
        from urllib.parse import parse_qs, urlsplit

        q = parse_qs(urlsplit(self.path).query)
        return {k: v[0] for k, v in q.items()}

    def get_blob_sidecars(self, block_id):
        """GET /eth/v1/beacon/blob_sidecars/{block_id}."""
        root = self._block_root_by_id(block_id)
        sidecars = self.chain.get_blobs(root)
        out = []
        for sc in sidecars:
            out.append(
                {
                    "index": _u(sc.index),
                    "blob": _hex(sc.blob),
                    "kzg_commitment": _hex(sc.kzg_commitment),
                    "kzg_proof": _hex(sc.kzg_proof),
                    "kzg_commitment_inclusion_proof": [
                        _hex(b) for b in sc.kzg_commitment_inclusion_proof
                    ],
                }
            )
        self._json({"data": out})

    def get_committees(self, state_id):
        st = self._state_by_id(state_id)
        spec = self.chain.spec
        epoch = acc.get_current_epoch(st, spec)
        q = self._query()
        if "epoch" in q:
            epoch = int(q["epoch"])
        cache = acc.build_committee_cache(st, spec, epoch)
        out = []
        start = h.compute_start_slot_at_epoch(epoch, spec)
        for slot in range(start, start + spec.preset.SLOTS_PER_EPOCH):
            if "slot" in q and int(q["slot"]) != slot:
                continue
            for cidx in range(cache.committees_per_slot):
                if "index" in q and int(q["index"]) != cidx:
                    continue
                out.append(
                    {
                        "index": _u(cidx),
                        "slot": _u(slot),
                        "validators": [_u(v) for v in cache.committee(slot, cidx)],
                    }
                )
        self._json({"data": out})

    def get_sync_committees(self, state_id):
        st = self._state_by_id(state_id)
        if not hasattr(st, "current_sync_committee"):
            raise ApiError(400, "pre-altair state")
        pk_to_idx = {bytes(v.pubkey): i for i, v in enumerate(st.validators)}
        try:
            indices = [
                pk_to_idx[bytes(pk)] for pk in st.current_sync_committee.pubkeys
            ]
        except KeyError:
            raise ApiError(500, "sync committee pubkey missing from registry")
        self._json({"data": {"validators": [_u(i) for i in indices]}})

    def get_fork_schedule(self):
        spec = self.chain.spec
        from ..types.spec import ForkName

        out = []
        prev = spec.genesis_fork_version
        for fork in ForkName:
            epoch = spec.fork_epoch(fork)
            if epoch is None:
                continue
            ver = spec.fork_version(fork)
            out.append(
                {
                    "previous_version": _hex(prev),
                    "current_version": _hex(ver),
                    "epoch": _u(epoch),
                }
            )
            prev = ver
        self._json({"data": out})

    def get_deposit_contract(self):
        spec = self.chain.spec
        self._json(
            {
                "data": {
                    "chain_id": _u(spec.deposit_chain_id),
                    "address": _hex(spec.deposit_contract_address),
                }
            }
        )

    def get_identity(self):
        net = getattr(self.chain, "_network_node", None)
        self._json(
            {
                "data": {
                    "peer_id": net.node_id if net else "in-process",
                    "enr": "",
                    "p2p_addresses": (
                        [f"/ip4/{net.host.listen_addr[0]}/tcp/{net.host.listen_addr[1]}"]
                        if net
                        else []
                    ),
                    "metadata": {"seq_number": "1", "attnets": "0x00"},
                }
            }
        )

    def get_peers(self):
        net = getattr(self.chain, "_network_node", None)
        peers = []
        if net is not None:
            for pid in net.host.connections:
                peers.append(
                    {
                        "peer_id": pid,
                        "state": "connected",
                        "direction": "outbound",
                        "score": net.peer_manager.score(pid),
                    }
                )
        self._json({"data": peers, "meta": {"count": len(peers)}})

    def post_sync_duties(self, epoch):
        body = self._read_body() or []
        with _client_input():
            indices = [int(i) for i in body]
        duties = []
        st = self.chain.head_state()
        for vi in indices:
            positions = self.chain.sync_subcommittee_positions(vi)
            if positions:
                duties.append(
                    {
                        "pubkey": _hex(st.validators[vi].pubkey),
                        "validator_index": _u(vi),
                        "validator_sync_committee_indices": [
                            _u(s * (self.chain.spec.preset.SYNC_COMMITTEE_SIZE
                                    // self.chain.spec.sync_committee_subnet_count) + p)
                            for s, p in positions
                        ],
                    }
                )
        self._json({"data": duties})

    def get_aggregate_attestation(self):
        q = self._query()
        slot = int(q.get("slot", 0))
        root = bytes.fromhex(q.get("attestation_data_root", "0x")[2:])
        types = types_for_slot(self.chain.spec, slot)
        agg = self.chain.naive_attestation_pool.get_aggregate(slot, root, types)
        if agg is None:
            raise ApiError(404, "no aggregate known")
        from ..ssz.core import Bitlist

        bits = list(agg.aggregation_bits)
        bits_ssz = Bitlist(max(len(bits), 1)).serialize(bits)
        self._json(
            {
                "data": {
                    "aggregation_bits": _hex(bits_ssz),
                    "signature": _hex(agg.signature),
                    "data": {
                        "slot": _u(agg.data.slot),
                        "index": _u(agg.data.index),
                        "beacon_block_root": _hex(agg.data.beacon_block_root),
                        "source": _checkpoint(agg.data.source),
                        "target": _checkpoint(agg.data.target),
                    },
                }
            }
        )

    def post_liveness(self, epoch):
        """POST /eth/v1/validator/liveness/{epoch}: seen-on-chain/gossip
        indicator per validator (the reference answers from its liveness
        cache; here the observed-attesters gossip dedup set)."""
        body = self._read_body() or []
        epoch = int(epoch)
        with _client_input():
            data = [
                {
                    "index": _u(int(i)),
                    "is_live": (epoch, int(i)) in self.chain.observed_attesters,
                }
                for i in body
            ]
        self._json({"data": data})

    def post_prepare_proposer(self):
        body = self._read_body()
        with _client_input():
            for item in body:
                self.chain.proposer_preparations[int(item["validator_index"])] = bytes.fromhex(
                    item["fee_recipient"][2:]
                )
        self._json({}, 200)

    def post_subscriptions(self):
        # beacon_committee/sync_committee subscriptions: acknowledged; subnet
        # topic management is the network node's job
        self._read_body()
        self._json({}, 200)

    def get_debug_state(self, state_id):
        st = self._state_by_id(state_id)
        types = types_for_slot(self.chain.spec, st.slot)
        self._json(
            {
                "version": self.chain.spec.fork_name_at_slot(st.slot).name,
                "data": _hex(types.BeaconState.serialize(st)),
            }
        )

    def get_block_ssz(self, block_id):
        """Full SSZ of a signed block (hex-wrapped) — the checkpoint-sync
        companion to get_debug_state: `bn --checkpoint-sync-url` fetches
        the finalized state + block pair from here (the reference fetches
        the same pair from a remote BN, client/src/builder.rs:366-390)."""
        root = self._block_root_by_id(block_id)
        chain = self.chain
        slot = chain.block_slots.get(root)
        if slot is None:
            raise ApiError(404, "block not found")
        types = types_for_slot(chain.spec, slot)
        blk = chain.store.get_block(root, types)
        if blk is None:
            raise ApiError(404, "block not found")
        self._json(
            {
                "version": chain.spec.fork_name_at_slot(slot).value,
                "data": _hex(types.SignedBeaconBlock.serialize(blk)),
            }
        )

    def get_lh_database_info(self):
        """/lighthouse_tpu/database/info (ops endpoint family analog)."""
        chain = self.chain
        store = chain.store
        counts = {}
        try:
            from ..store.kv import Column

            for col in Column:
                n = sum(1 for _ in store.hot.iter_column(col))
                if n:
                    counts[col.name] = n
        except Exception:  # noqa: BLE001 — memory stores may not iterate
            pass
        self._json(
            {
                "data": {
                    "split_slot": _u(store.split_slot),
                    "anchor_slot": _u(chain.anchor_slot),
                    "oldest_block_slot": _u(chain.oldest_block_slot),
                    "hot_columns": counts,
                }
            }
        )

    def get_lh_health(self):
        """/lighthouse_tpu/health: process+system snapshot."""
        from ..utils.monitoring import system_health

        self._json({"data": system_health()})

    def post_lh_validator_metrics(self):
        """/lighthouse_tpu/ui/validator-metrics: per-validator monitor
        summaries for the requested indices (http_api/src/ui.rs
        post_validator_monitor_metrics analog). Body:
        {"indices": [..], "epoch": optional} — epoch defaults to the last
        CLOSED epoch (current - 2: books for E close once E+1 ends).
        Read-only: registration is an operator decision
        (--monitor-validators), not a side effect of an unauthenticated
        query."""
        body = self._read_body() or {}
        if not isinstance(body, dict):
            raise ApiError(400, "body must be a JSON object")
        indices = [int(i) for i in body.get("indices", [])]
        spe = self.chain.spec.preset.SLOTS_PER_EPOCH
        epoch = int(body.get("epoch", max(0, self.chain.current_slot // spe - 2)))
        self._json(
            {
                "data": {
                    "validators": self.chain.monitor.metrics_for(indices, epoch),
                    "epoch": epoch,
                }
            }
        )

    def get_lh_pipeline(self):
        """/lighthouse_tpu/pipeline: stage-timing snapshot of the
        verification dataflow — aggregate per-stage/per-kind timings, live
        scheduler queue state, and the most recent completed traces
        (observability). The scrape-time analog of a
        `--trace-out` Perfetto export."""
        from ..observability import snapshot

        self._json({"data": snapshot()})

    def get_lh_slo(self):
        """/lighthouse_tpu/slo: the slot-level SLO accountant's snapshot —
        per-slot reports, the rolling 5-slot / 32-slot windows with burn
        rate, and the degraded verdict (observability/slo.py). This is the
        live SLI surface a closed-loop capacity controller consumes."""
        from ..observability import flight_recorder as obs_fr
        from ..observability import slo as obs_slo

        data = obs_slo.ACCOUNTANT.snapshot()
        data["health"] = obs_slo.health()
        data["flight_recorder"] = {
            "events_recorded": obs_fr.RECORDER.events_recorded,
            "breaker_states": dict(obs_fr.RECORDER.breaker_states),
            "incidents_written": list(obs_fr.RECORDER.incidents_written),
        }
        self._json({"data": data})

    def get_lh_peers_scores(self):
        net = getattr(self.chain, "_network_node", None)
        out = []
        if net is not None:
            for pid in net.peer_manager.connected_peers():
                out.append({"peer_id": pid, "score": net.peer_manager.score(pid)})
        self._json({"data": out})

    def get_lh_logs(self):
        """/lighthouse_tpu/logs: recent structured log records (the SSE
        log-streaming idiom of common/logging, served as a snapshot)."""
        from ..utils.logging import RECENT

        self._json(
            {
                "data": [
                    {
                        "ts": ts,
                        "level": level,
                        "component": component,
                        "msg": msg,
                        **{k: str(v) for k, v in fields.items()},
                    }
                    for ts, level, component, msg, fields in list(RECENT)[-128:]
                ]
            }
        )

    def get_attestation_data(self):
        """GET /eth/v1/validator/attestation_data?slot=&committee_index=."""
        from ..validator.beacon_node import InProcessBeaconNode

        q = self._query()
        slot = int(q["slot"])
        cidx = int(q.get("committee_index", 0))
        data = InProcessBeaconNode(self.chain).attestation_data(slot, cidx)
        self._json(
            {
                "data": {
                    "slot": _u(data.slot),
                    "index": _u(data.index),
                    "beacon_block_root": _hex(data.beacon_block_root),
                    "source": _checkpoint(data.source),
                    "target": _checkpoint(data.target),
                }
            }
        )

    def get_produce_block(self, slot):
        """GET /eth/v3/validator/blocks/{slot}?randao_reveal=0x... — returns
        the unsigned block as SSZ hex (the VC signs and POSTs it back)."""
        q = self._query()
        reveal_hex = q.get("randao_reveal")
        if not reveal_hex:
            raise ApiError(400, "randao_reveal required")
        slot = int(slot)
        graffiti = bytes.fromhex(q["graffiti"][2:]) if "graffiti" in q else None
        block = self.chain.produce_block(
            slot, bytes.fromhex(reveal_hex[2:]),
            op_pool=self.op_pool, graffiti=graffiti,
        )
        types = types_for_slot(self.chain.spec, slot)
        self._json(
            {
                "version": self.chain.spec.fork_name_at_slot(slot).name,
                "execution_payload_blinded": False,
                "data": _hex(types.BeaconBlock.serialize(block)),
            }
        )

    def get_lc_bootstrap(self, block_root_hex):
        """GET /eth/v1/beacon/light_client/bootstrap/{block_root}."""
        lc = getattr(self.chain, "light_client_cache", None)
        if lc is None:
            raise ApiError(404, "light client server not enabled")
        root = bytes.fromhex(block_root_hex[2:])
        bs = lc.bootstraps.get(root)
        if bs is None:
            raise ApiError(404, "no bootstrap for block")
        self._json(
            {
                "data": {
                    "header": {"beacon": {"slot": _u(bs.header.slot)}},
                    "current_sync_committee_branch": [
                        _hex(b) for b in bs.current_sync_committee_branch
                    ],
                }
            }
        )

    def get_lc_optimistic(self):
        lc = getattr(self.chain, "light_client_cache", None)
        if lc is None or lc.latest_optimistic_update is None:
            raise ApiError(404, "no optimistic update")
        u = lc.latest_optimistic_update
        self._json(
            {
                "data": {
                    "attested_header": {"beacon": {"slot": _u(u.attested_header.slot)}},
                    "signature_slot": _u(u.signature_slot),
                }
            }
        )

    def get_lc_finality(self):
        lc = getattr(self.chain, "light_client_cache", None)
        if lc is None or lc.latest_finality_update is None:
            raise ApiError(404, "no finality update")
        u = lc.latest_finality_update
        self._json(
            {
                "data": {
                    "attested_header": {"beacon": {"slot": _u(u.attested_header.slot)}},
                    "finalized_header": {"beacon": {"slot": _u(u.finalized_header.slot)}},
                    "signature_slot": _u(u.signature_slot),
                }
            }
        )

    # ---------------------------------------------------------- rewards

    def get_rewards_blocks(self, block_id):
        """GET /eth/v1/beacon/rewards/blocks/{block_id}
        (standard_block_rewards.rs)."""
        from . import rewards as rw

        root = self._block_root_by_id(block_id)
        try:
            data = rw.compute_block_rewards(self.chain, root)
        except KeyError as e:
            raise ApiError(404, str(e)) from e
        self._json(
            {
                "execution_optimistic": False,
                "finalized": self._is_finalized_root(root),
                "data": {k: str(v) for k, v in data.items()},
            }
        )

    def post_rewards_attestations(self, epoch):
        """POST /eth/v1/beacon/rewards/attestations/{epoch} with an optional
        JSON array of validator indices/pubkeys (attestation_rewards.rs)."""
        from . import rewards as rw

        validators = self._read_body() or []
        if not isinstance(validators, list):
            raise ApiError(400, "body must be a JSON array")
        try:
            data = rw.compute_attestation_rewards(self.chain, int(epoch), validators)
        except KeyError as e:
            raise ApiError(404, str(e)) from e
        except ValueError as e:
            raise ApiError(400, str(e)) from e

        def quoted(row):
            return {k: str(v) for k, v in row.items()}

        self._json(
            {
                "execution_optimistic": False,
                "finalized": False,
                "data": {
                    "ideal_rewards": [quoted(r) for r in data["ideal_rewards"]],
                    "total_rewards": [quoted(r) for r in data["total_rewards"]],
                },
            }
        )

    def post_rewards_sync_committee(self, block_id):
        """POST /eth/v1/beacon/rewards/sync_committee/{block_id}
        (sync_committee_rewards.rs)."""
        from . import rewards as rw

        root = self._block_root_by_id(block_id)
        validators = self._read_body() or []
        if not isinstance(validators, list):
            raise ApiError(400, "body must be a JSON array")
        try:
            data = rw.compute_sync_committee_rewards(self.chain, root, validators)
        except KeyError as e:
            raise ApiError(404, str(e)) from e
        except ValueError as e:
            raise ApiError(400, str(e)) from e
        self._json(
            {
                "execution_optimistic": False,
                "finalized": self._is_finalized_root(root),
                "data": [
                    {"validator_index": str(r["validator_index"]),
                     "reward": str(r["reward"])}
                    for r in data
                ],
            }
        )

    def _is_finalized_root(self, root: bytes) -> bool:
        slot = self.chain.block_slots.get(root)
        if slot is None:
            return False
        fin_epoch = self.chain.fork_choice.store.finalized_checkpoint[0]
        return slot <= fin_epoch * self.chain.spec.preset.SLOTS_PER_EPOCH

    # ------------------------------------------------- blinded production

    def get_produce_blinded_block(self, slot):
        """GET /eth/v1/validator/blinded_blocks/{slot} — the block with its
        execution payload replaced by the payload HEADER (produce_block.rs
        blinded path; the VC signs it and POSTs to blinded_blocks)."""
        q = self._query()
        reveal_hex = q.get("randao_reveal")
        if not reveal_hex:
            raise ApiError(400, "randao_reveal required")
        slot = int(slot)
        graffiti = bytes.fromhex(q["graffiti"][2:]) if "graffiti" in q else None
        block = self.chain.produce_block(
            slot, bytes.fromhex(reveal_hex[2:]),
            op_pool=self.op_pool, graffiti=graffiti,
        )
        types = types_for_slot(self.chain.spec, slot)
        payload_header_json = None
        payload = getattr(block.body, "execution_payload", None)
        if payload is not None:
            tx_type = next(
                f.type for f in types.ExecutionPayload.fields
                if f.name == "transactions"
            )
            payload_header_json = {
                "block_hash": _hex(payload.block_hash),
                "parent_hash": _hex(payload.parent_hash),
                "block_number": _u(payload.block_number),
                "transactions_root": _hex(tx_type.hash_tree_root(payload.transactions)),
            }
        self._json(
            {
                "version": self.chain.spec.fork_name_at_slot(slot).name,
                "execution_payload_blinded": True,
                "data": {
                    "message": {
                        "slot": _u(block.slot),
                        "proposer_index": _u(block.proposer_index),
                        "parent_root": _hex(block.parent_root),
                        "state_root": _hex(block.state_root),
                        "body": {"execution_payload_header": payload_header_json},
                    },
                    # full SSZ so the in-process publish path can reuse it
                    "ssz": _hex(types.BeaconBlock.serialize(block)),
                },
            }
        )

    def post_publish_blinded_block(self):
        """POST /eth/v1/beacon/blinded_blocks — accepts the signed blinded
        block; the payload is recovered from the local production cache
        (publish_blocks.rs ProvenancedBlock::Builder path, with the local-EL
        unblinding shortcut)."""
        body = self._read_body()
        raw = body.get("ssz") if isinstance(body, dict) else None
        if raw is None:
            raise ApiError(400, "expected {'ssz': block hex, 'signature': sig hex}")
        sig = body.get("signature")
        if sig is None:
            raise ApiError(400, "signature required")
        # same fork resolution as the full publish path (types_for_slot of
        # the CURRENT slot; re-resolved below once the real slot is known)
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        try:
            block = types.BeaconBlock.deserialize(bytes.fromhex(raw[2:]))
        except Exception as e:  # noqa: BLE001
            _ERRORS_TOTAL.labels("blinded_ssz_decode").inc()
            log.warn("undecodable blinded block",
                     stage="blinded_ssz_decode",
                     error=f"{type(e).__name__}: {e}")
            raise ApiError(400, f"undecodable block SSZ: {e}") from e
        types = types_for_slot(self.chain.spec, block.slot)
        signed = types.SignedBeaconBlock.make(
            message=block, signature=bytes.fromhex(sig[2:])
        )
        with self._publish_permit(self._block_publish_gate):
            self._import_published_block(signed)

    # ------------------------------------------------- deposit snapshot

    def get_deposit_snapshot(self):
        """GET /eth/v1/beacon/deposit_snapshot (EIP-4881; the reference
        serves it from the eth1 service cache)."""
        eth1 = getattr(self.chain, "eth1_cache", None)
        if eth1 is None:
            raise ApiError(404, "no eth1 deposit cache")
        tree = eth1.tree
        count = len(tree)
        latest = eth1.blocks[-1] if eth1.blocks else None
        self._json(
            {
                "data": {
                    "finalized": [_hex(tree.root(count))],
                    "deposit_root": _hex(tree.root(count)),
                    "deposit_count": _u(count),
                    "execution_block_hash": _hex(
                        latest.hash if latest else b"\x00" * 32
                    ),
                    "execution_block_height": _u(latest.number if latest else 0),
                }
            }
        )

    # ------------------------------------------------- LC updates by range

    def get_lc_updates(self):
        """GET /eth/v1/beacon/light_client/updates?start_period=&count=
        (http_api light_client updates-by-range)."""
        lc = getattr(self.chain, "light_client_cache", None)
        if lc is None:
            raise ApiError(404, "light client server not enabled")
        q = self._query()
        try:
            start = int(q["start_period"])
            count = int(q["count"])
        except (KeyError, ValueError) as e:
            raise ApiError(400, "start_period and count required") from e
        count = min(count, 128)  # MAX_REQUEST_LIGHT_CLIENT_UPDATES
        out = []
        for period in range(start, start + count):
            u = lc.best_updates.get(period)
            if u is None:
                continue
            out.append(
                {
                    "version": self.chain.spec.fork_name_at_slot(
                        u.attested_header.slot
                    ).value,
                    "data": {
                        "attested_header": {
                            "beacon": {"slot": _u(u.attested_header.slot)}
                        },
                        "finalized_header": {
                            "beacon": {"slot": _u(u.finalized_header.slot)}
                        },
                        "signature_slot": _u(u.signature_slot),
                        "next_sync_committee_branch": [
                            _hex(b) for b in u.next_sync_committee_branch
                        ],
                    },
                }
            )
        self._json(out)

    def post_pool_voluntary_exits(self):
        body = self._read_body()
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        with _client_input():
            exit_ = types.SignedVoluntaryExit.make(
                message=types.VoluntaryExit.make(
                    epoch=int(body["message"]["epoch"]),
                    validator_index=int(body["message"]["validator_index"]),
                ),
                signature=bytes.fromhex(body["signature"][2:]),
            )
        if self.op_pool is not None:
            self.op_pool.insert_voluntary_exit(exit_)
        if self.event_bus is not None:
            self.event_bus.publish(
                "voluntary_exit",
                {"validator_index": body["message"]["validator_index"]},
            )
        self._json({})

    def get_pool_voluntary_exits(self):
        out = []
        if self.op_pool is not None:
            for e in self.op_pool.voluntary_exits.values():
                out.append(
                    {
                        "message": {
                            "epoch": _u(e.message.epoch),
                            "validator_index": _u(e.message.validator_index),
                        },
                        "signature": _hex(e.signature),
                    }
                )
        self._json({"data": out})

    # ---------------------------------------------- pool: slashings/changes

    def post_pool_bls_changes(self):
        body = self._read_body() or []
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        if isinstance(body, dict):
            body = [body]
        with _client_input():
            for c in body:
                change = types.SignedBLSToExecutionChange.make(
                    message=types.BLSToExecutionChange.make(
                        validator_index=int(c["message"]["validator_index"]),
                        from_bls_pubkey=bytes.fromhex(c["message"]["from_bls_pubkey"][2:]),
                        to_execution_address=bytes.fromhex(
                            c["message"]["to_execution_address"][2:]
                        ),
                    ),
                    signature=bytes.fromhex(c["signature"][2:]),
                )
                if self.op_pool is not None:
                    self.op_pool.insert_bls_change(change)
        self._json({})

    def get_pool_bls_changes(self):
        out = []
        if self.op_pool is not None:
            for c in self.op_pool.bls_changes.values():
                out.append(
                    {
                        "message": {
                            "validator_index": _u(c.message.validator_index),
                            "from_bls_pubkey": _hex(c.message.from_bls_pubkey),
                            "to_execution_address": _hex(
                                c.message.to_execution_address
                            ),
                        },
                        "signature": _hex(c.signature),
                    }
                )
        self._json({"data": out})

    def get_pool_attester_slashings(self):
        def indexed(a):
            return {
                "attesting_indices": [_u(i) for i in a.attesting_indices],
                "data": {
                    "slot": _u(a.data.slot),
                    "index": _u(a.data.index),
                    "beacon_block_root": _hex(a.data.beacon_block_root),
                    "source": _checkpoint(a.data.source),
                    "target": _checkpoint(a.data.target),
                },
                "signature": _hex(a.signature),
            }

        out = []
        if self.op_pool is not None:
            for sl in self.op_pool.attester_slashings:
                out.append(
                    {
                        "attestation_1": indexed(sl.attestation_1),
                        "attestation_2": indexed(sl.attestation_2),
                    }
                )
        self._json({"data": out})

    def post_pool_attester_slashings(self):
        body = self._read_body()
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        ssz_hex = body.get("ssz") if isinstance(body, dict) else None
        if not ssz_hex:
            raise ApiError(400, "expected {'ssz': '0x...'} body")
        slashing = types.AttesterSlashing.deserialize(bytes.fromhex(ssz_hex[2:]))
        try:
            self.chain.verify_slashing_for_pool(slashing, "attester")
        except Exception as e:  # noqa: BLE001
            _ERRORS_TOTAL.labels("attester_slashing_verify").inc()
            log.warn("rejected attester slashing",
                     stage="attester_slashing_verify",
                     error=f"{type(e).__name__}: {e}")
            raise ApiError(400, f"invalid attester slashing: {e}") from e
        if self.op_pool is not None:
            self.op_pool.insert_attester_slashing(slashing)
        if self.event_bus is not None:
            self.event_bus.publish("attester_slashing", {})
        self._json({})

    def get_pool_proposer_slashings(self):
        def header(sh):
            m = sh.message
            return {
                "message": {
                    "slot": _u(m.slot),
                    "proposer_index": _u(m.proposer_index),
                    "parent_root": _hex(m.parent_root),
                    "state_root": _hex(m.state_root),
                    "body_root": _hex(m.body_root),
                },
                "signature": _hex(sh.signature),
            }

        out = []
        if self.op_pool is not None:
            for sl in self.op_pool.proposer_slashings.values():
                out.append(
                    {
                        "signed_header_1": header(sl.signed_header_1),
                        "signed_header_2": header(sl.signed_header_2),
                    }
                )
        self._json({"data": out})

    def post_pool_proposer_slashings(self):
        body = self._read_body()
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        ssz_hex = body.get("ssz") if isinstance(body, dict) else None
        if not ssz_hex:
            raise ApiError(400, "expected {'ssz': '0x...'} body")
        slashing = types.ProposerSlashing.deserialize(bytes.fromhex(ssz_hex[2:]))
        try:
            self.chain.verify_slashing_for_pool(slashing, "proposer")
        except Exception as e:  # noqa: BLE001
            _ERRORS_TOTAL.labels("proposer_slashing_verify").inc()
            log.warn("rejected proposer slashing",
                     stage="proposer_slashing_verify",
                     error=f"{type(e).__name__}: {e}")
            raise ApiError(400, f"invalid proposer slashing: {e}") from e
        if self.op_pool is not None:
            self.op_pool.insert_proposer_slashing(slashing)
        if self.event_bus is not None:
            self.event_bus.publish("proposer_slashing", {})
        self._json({})

    def post_pool_sync_committees(self):
        """POST /eth/v1/beacon/pool/sync_committees: verified in one batch
        and fed to the naive contribution pool (the VC's sync-message
        publish path)."""
        body = self._read_body() or []
        types = types_for_slot(self.chain.spec, self.chain.current_slot)
        with _client_input():
            msgs = [
                types.SyncCommitteeMessage.make(
                    slot=int(m["slot"]),
                    beacon_block_root=bytes.fromhex(m["beacon_block_root"][2:]),
                    validator_index=int(m["validator_index"]),
                    signature=bytes.fromhex(m["signature"][2:]),
                )
                for m in body
            ]
        with self._publish_permit(self._bulk_publish_gate):
            accepted = self.chain.process_sync_committee_messages(msgs)
        if accepted != len(msgs):
            raise ApiError(400, f"{len(msgs) - accepted} messages failed")
        self._json({})

    # ---------------------------------------------- states: balances/randao

    def get_state_validator_balances(self, state_id):
        st = self._state_by_id(state_id)
        q = self._query()
        wanted = None
        if "id" in q:
            wanted = set()
            by_pubkey = None
            for ident in q["id"].split(","):
                if ident.startswith("0x"):
                    if by_pubkey is None:
                        by_pubkey = {
                            bytes(v.pubkey): i for i, v in enumerate(st.validators)
                        }
                    idx = by_pubkey.get(bytes.fromhex(ident[2:]))
                    if idx is not None:
                        wanted.add(idx)
                elif ident.isdigit():
                    wanted.add(int(ident))
                else:
                    raise ApiError(400, f"bad validator id {ident!r}")
        self._json(
            {
                "data": [
                    {"index": _u(i), "balance": _u(b)}
                    for i, b in enumerate(st.balances)
                    if wanted is None or i in wanted
                ]
            }
        )

    def get_state_randao(self, state_id):
        from ..state_transition import accessors as acc

        st = self._state_by_id(state_id)
        spec = self.chain.spec
        current = acc.get_current_epoch(st, spec)
        epoch = current
        q = self._query()
        if "epoch" in q:
            epoch = int(q["epoch"])
        # get_randao_mix indexes modulo EPOCHS_PER_HISTORICAL_VECTOR: an
        # out-of-range epoch would silently alias an unrelated mix
        lo = max(0, current - spec.preset.EPOCHS_PER_HISTORICAL_VECTOR + 1)
        if not (lo <= epoch <= current):
            raise ApiError(400, f"epoch {epoch} outside stored randao range")
        mix = h.get_randao_mix(st, spec, epoch)
        self._json({"data": {"randao": _hex(mix)}})

    def get_node_peer_count(self):
        net = getattr(self.chain, "_network_node", None)
        connected = len(net.peer_manager.connected_peers()) if net else 0
        self._json(
            {
                "data": {
                    "disconnected": "0",
                    "connecting": "0",
                    "connected": str(connected),
                    "disconnecting": "0",
                }
            }
        )


def _bits_from_hex(hex_str: str):
    from ..ssz.core import Bitlist

    data = bytes.fromhex(hex_str[2:])
    # decode SSZ bitlist bytes (with delimiter)
    last = data[-1]
    total = (len(data) - 1) * 8 + (last.bit_length() - 1)
    return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(total)]


_ROUTES = [
    (r"/eth/v1/beacon/genesis", "GET", BeaconApiHandler.get_genesis),
    (r"/eth/v1/beacon/states/([^/]+)/root", "GET", BeaconApiHandler.get_state_root),
    (r"/eth/v1/beacon/states/([^/]+)/finality_checkpoints", "GET", BeaconApiHandler.get_finality_checkpoints),
    (r"/eth/v1/beacon/states/([^/]+)/validators", "GET", BeaconApiHandler.get_validators),
    (r"/eth/v1/beacon/states/([^/]+)/validators/([^/]+)", "GET", BeaconApiHandler.get_validator),
    (r"/eth/v1/beacon/blocks/([^/]+)/root", "GET", BeaconApiHandler.get_block_root),
    (r"/eth/v2/beacon/blocks/([^/]+)", "GET", BeaconApiHandler.get_block),
    (r"/eth/v1/beacon/headers/([^/]+)", "GET", BeaconApiHandler.get_header),
    (r"/eth/v1/node/health", "GET", BeaconApiHandler.get_health),
    (r"/eth/v1/node/version", "GET", BeaconApiHandler.get_version),
    (r"/eth/v1/node/syncing", "GET", BeaconApiHandler.get_syncing),
    (r"/eth/v1/config/spec", "GET", BeaconApiHandler.get_spec),
    (r"/eth/v1/validator/duties/attester/(\d+)", "POST", BeaconApiHandler.post_attester_duties),
    (r"/eth/v1/validator/duties/proposer/(\d+)", "GET", BeaconApiHandler.get_proposer_duties),
    (r"/eth/v1/beacon/pool/attestations", "POST", BeaconApiHandler.post_pool_attestations),
    (r"/eth/v2/beacon/blocks", "POST", BeaconApiHandler.post_publish_block),
    (r"/eth/v1/beacon/blob_sidecars/([^/]+)", "GET", BeaconApiHandler.get_blob_sidecars),
    (r"/eth/v1/beacon/states/([^/]+)/committees", "GET", BeaconApiHandler.get_committees),
    (r"/eth/v1/beacon/states/([^/]+)/sync_committees", "GET", BeaconApiHandler.get_sync_committees),
    (r"/eth/v1/config/fork_schedule", "GET", BeaconApiHandler.get_fork_schedule),
    (r"/eth/v1/config/deposit_contract", "GET", BeaconApiHandler.get_deposit_contract),
    (r"/eth/v1/node/identity", "GET", BeaconApiHandler.get_identity),
    (r"/eth/v1/node/peers", "GET", BeaconApiHandler.get_peers),
    (r"/eth/v1/validator/duties/sync/(\d+)", "POST", BeaconApiHandler.post_sync_duties),
    (r"/eth/v1/validator/aggregate_attestation", "GET", BeaconApiHandler.get_aggregate_attestation),
    (r"/eth/v1/validator/liveness/(\d+)", "POST", BeaconApiHandler.post_liveness),
    (r"/eth/v1/validator/prepare_beacon_proposer", "POST", BeaconApiHandler.post_prepare_proposer),
    (r"/eth/v1/validator/beacon_committee_subscriptions", "POST", BeaconApiHandler.post_subscriptions),
    (r"/eth/v1/validator/sync_committee_subscriptions", "POST", BeaconApiHandler.post_subscriptions),
    (r"/eth/v2/debug/beacon/states/([^/]+)", "GET", BeaconApiHandler.get_debug_state),
    (r"/lighthouse_tpu/blocks/([^/]+)/ssz", "GET", BeaconApiHandler.get_block_ssz),
    (r"/eth/v1/beacon/pool/bls_to_execution_changes", "GET", BeaconApiHandler.get_pool_bls_changes),
    (r"/eth/v1/beacon/pool/bls_to_execution_changes", "POST", BeaconApiHandler.post_pool_bls_changes),
    (r"/eth/v1/beacon/pool/attester_slashings", "GET", BeaconApiHandler.get_pool_attester_slashings),
    (r"/eth/v1/beacon/pool/attester_slashings", "POST", BeaconApiHandler.post_pool_attester_slashings),
    (r"/eth/v1/beacon/pool/proposer_slashings", "GET", BeaconApiHandler.get_pool_proposer_slashings),
    (r"/eth/v1/beacon/pool/proposer_slashings", "POST", BeaconApiHandler.post_pool_proposer_slashings),
    (r"/eth/v1/beacon/pool/sync_committees", "POST", BeaconApiHandler.post_pool_sync_committees),
    (r"/eth/v1/beacon/states/([^/]+)/validator_balances", "GET", BeaconApiHandler.get_state_validator_balances),
    (r"/eth/v1/beacon/states/([^/]+)/randao", "GET", BeaconApiHandler.get_state_randao),
    (r"/eth/v1/node/peer_count", "GET", BeaconApiHandler.get_node_peer_count),
    (r"/lighthouse_tpu/database/info", "GET", BeaconApiHandler.get_lh_database_info),
    (r"/lighthouse_tpu/health", "GET", BeaconApiHandler.get_lh_health),
    (r"/lighthouse_tpu/peers/scores", "GET", BeaconApiHandler.get_lh_peers_scores),
    (r"/lighthouse_tpu/ui/validator-metrics", "POST", BeaconApiHandler.post_lh_validator_metrics),
    (r"/lighthouse_tpu/logs", "GET", BeaconApiHandler.get_lh_logs),
    (r"/lighthouse_tpu/pipeline", "GET", BeaconApiHandler.get_lh_pipeline),
    (r"/lighthouse_tpu/slo", "GET", BeaconApiHandler.get_lh_slo),
    (r"/eth/v1/validator/attestation_data", "GET", BeaconApiHandler.get_attestation_data),
    (r"/eth/v3/validator/blocks/(\d+)", "GET", BeaconApiHandler.get_produce_block),
    (r"/eth/v1/beacon/light_client/bootstrap/(0x[0-9a-f]+)", "GET", BeaconApiHandler.get_lc_bootstrap),
    (r"/eth/v1/beacon/light_client/optimistic_update", "GET", BeaconApiHandler.get_lc_optimistic),
    (r"/eth/v1/beacon/light_client/finality_update", "GET", BeaconApiHandler.get_lc_finality),
    (r"/eth/v1/beacon/pool/voluntary_exits", "POST", BeaconApiHandler.post_pool_voluntary_exits),
    (r"/eth/v1/beacon/pool/voluntary_exits", "GET", BeaconApiHandler.get_pool_voluntary_exits),
    (r"/eth/v1/beacon/rewards/blocks/([^/]+)", "GET", BeaconApiHandler.get_rewards_blocks),
    (r"/eth/v1/beacon/rewards/attestations/(\d+)", "POST", BeaconApiHandler.post_rewards_attestations),
    (r"/eth/v1/beacon/rewards/sync_committee/([^/]+)", "POST", BeaconApiHandler.post_rewards_sync_committee),
    (r"/eth/v1/validator/blinded_blocks/(\d+)", "GET", BeaconApiHandler.get_produce_blinded_block),
    (r"/eth/v1/beacon/blinded_blocks", "POST", BeaconApiHandler.post_publish_blinded_block),
    (r"/eth/v1/beacon/deposit_snapshot", "GET", BeaconApiHandler.get_deposit_snapshot),
    (r"/eth/v1/beacon/light_client/updates", "GET", BeaconApiHandler.get_lc_updates),
]


class EventBus:
    """SSE topics (events.rs analog), minimal pub-sub."""

    def __init__(self):
        self.subscribers: list = []
        self._lock = threading.Lock()

    def publish(self, topic: str, payload: dict):
        with self._lock:
            for q in self.subscribers:
                q.append((topic, payload))


class WorkerPoolHTTPServer(HTTPServer):
    """Bounded worker pool behind an admission gate (the ThreadingHTTPServer
    replacement: thread-per-connection is unbounded — a connection flood IS
    a thread flood, and a slow-loris peer pins a thread forever).

    Topology: the accept loop never reads a byte — it only moves the
    accepted socket into a bounded work queue. `--http-threads` workers pop
    sockets, arm the per-request read deadline (`--http-request-timeout`),
    and serve exactly ONE request per dispatch; keep-alive connections are
    then *parked* and re-admitted through the same gate when they turn
    readable, so an idle pool of hundreds of keep-alive VC connections
    costs one select() set, not hundreds of threads. When the work queue is
    full, a small shed lane answers 503 + Retry-After (health stays exempt:
    `/eth/v1/node/health` is served inline off the shed lane so liveness
    probes answer precisely when the node is busiest) — counted in
    `http_api_shed_total{reason}` with a flight-recorder event on the
    saturation edge.

    `stats` (accepted / handled / shed / requeued / health_shed_path) are
    plain monotonic counters; the fleet's wedge check reads `handled` —
    a saturated-but-alive server keeps making progress as deadlines free
    workers, a wedged one does not."""

    allow_reuse_address = True
    request_queue_size = 128  # listen(2) backlog under accept bursts

    #: deadline for the shed lane's header read — sheds must stay cheap
    #: even against a slow-loris peer aimed at the shed lane itself
    SHED_READ_TIMEOUT = 1.0

    def __init__(self, addr, handler_cls, http_threads=None,
                 request_timeout=None, queue_depth=None):
        super().__init__(addr, handler_cls)
        self.http_threads = resolve_http_threads(http_threads)
        self.request_timeout = resolve_http_request_timeout(request_timeout)
        depth = (int(queue_depth) if queue_depth is not None
                 else max(16, 2 * self.http_threads))
        self._queue: queue.Queue = queue.Queue(depth)
        self._shed_queue: queue.Queue = queue.Queue(max(8, self.http_threads))
        self._parked: dict = {}  # socket -> parked_at (time.monotonic)
        self._park_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._saturated = False  # hysteresis for the flight-recorder event
        self.stats = {
            "accepted": 0, "handled": 0, "shed": 0, "requeued": 0,
            "health_shed_path": 0,
        }
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"http-worker-{i}")
            for i in range(self.http_threads)
        ]
        self._shedder = threading.Thread(
            target=self._shedder_loop, daemon=True, name="http-shedder"
        )
        # self-pipe: _park() wakes the parker so a connection reused
        # immediately after its response re-admits in microseconds, not
        # at the next poll tick
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._parker = threading.Thread(
            target=self._parker_loop, daemon=True, name="http-parker"
        )
        for t in self._workers:
            t.start()
        self._shedder.start()
        self._parker.start()

    def _bump(self, key, n=1):
        with self._stats_lock:
            self.stats[key] += n

    # --------------------------------------------------------- admission

    def process_request(self, request, client_address):
        # accept-loop override: hand off, never read — accept progress
        # must not depend on any peer's send rate
        self._bump("accepted")
        self._admit(request, client_address)

    def _admit(self, sock, addr, requeued=False):
        if self._stop.is_set():
            self._shed_now(sock, "shutdown")
            return
        try:
            self._queue.put_nowait((sock, addr))
        except queue.Full:
            self._note_saturated(addr)
            try:
                self._shed_queue.put_nowait((sock, addr))
            except queue.Full:
                # even the shed lane is full: close without a response —
                # spending accept-thread time on this peer is the DoS
                _SHED_TOTAL.labels("overflow").inc()
                self._bump("shed")
                self._close_sock(sock)
            return
        if requeued:
            self._bump("requeued")
        self._saturated = False
        _INFLIGHT.labels("queue").set(self._queue.qsize())

    def _note_saturated(self, addr):
        if self._saturated:
            return
        self._saturated = True
        from ..observability.flight_recorder import RECORDER

        RECORDER.record(
            "http_api_saturated", severity="warn",
            queue_depth=self._queue.maxsize, workers=self.http_threads,
            peer=str(addr[0]) if addr else "",
        )

    # --------------------------------------------------------- shed lane

    def _shedder_loop(self):
        while True:
            item = self._shed_queue.get()
            if item is None:
                return
            sock, _addr = item
            self._shed_now(sock, "saturated")

    def _shed_now(self, sock, reason):
        try:
            self._shed_one(sock, reason)
        except (OSError, TimeoutError):
            # peer trickling headers at the shed lane, or gone: the shed
            # still counts — the connection was turned away either way
            _SHED_TOTAL.labels(reason).inc()
            self._bump("shed")
        finally:
            self._close_sock(sock)

    def _shed_one(self, sock, reason):
        sock.settimeout(min(self.SHED_READ_TIMEOUT, self.request_timeout))
        rfile = sock.makefile("rb", -1)
        try:
            line = rfile.readline(4096)
            for _ in range(128):  # drain headers (bounded)
                hline = rfile.readline(4096)
                if hline in (b"\r\n", b"\n", b""):
                    break
        finally:
            rfile.close()
        parts = line.split()
        path = (parts[1].split(b"?")[0].decode("latin-1", "replace")
                if len(parts) > 1 else "")
        if (parts and parts[0] == b"GET"
                and path in BeaconApiHandler.RATE_LIMIT_EXEMPT):
            from ..observability import slo as obs_slo

            degraded = obs_slo.health()["degraded"]
            status = "206 Partial Content" if degraded else "200 OK"
            sock.sendall(
                (f"HTTP/1.1 {status}\r\nContent-Length: 0\r\n"
                 "Connection: close\r\n\r\n").encode()
            )
            self._bump("health_shed_path")
            return
        body = b'{"code": 503, "message": "worker pool saturated; retry"}'
        sock.sendall(
            b"HTTP/1.1 503 Service Unavailable\r\n"
            b"Content-Type: application/json\r\n"
            b"Retry-After: 1\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n"
            b"Connection: close\r\n\r\n" + body
        )
        _SHED_TOTAL.labels(reason).inc()
        self._bump("shed")

    # ----------------------------------------------------------- workers

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            sock, addr = item
            _INFLIGHT.labels("queue").set(self._queue.qsize())
            _INFLIGHT.labels("workers").inc()
            keep = False
            try:
                sock.settimeout(self.request_timeout)
                handler = self.RequestHandlerClass(sock, addr, self)
                keep = not handler.close_connection
            except Exception:  # noqa: BLE001 — a dead peer must not kill a worker
                keep = False
            finally:
                _INFLIGHT.labels("workers").dec()
                self._bump("handled")
            if keep and not self._stop.is_set():
                self._park(sock)
            else:
                self._close_sock(sock)

    # ----------------------------------------------------------- parking

    def _park(self, sock):
        with self._park_lock:
            self._parked[sock] = time.monotonic()
            _INFLIGHT.labels("parked").set(len(self._parked))
        try:
            self._wake_w.send(b"p")
        except OSError:
            pass

    def _parker_loop(self):
        while not self._stop.is_set():
            with self._park_lock:
                socks = list(self._parked)
            try:
                readable, _, errored = select.select(
                    socks + [self._wake_r], [], socks, 0.25
                )
            except (OSError, ValueError):
                with self._park_lock:
                    for s in list(self._parked):
                        if s.fileno() < 0:
                            del self._parked[s]
                continue
            if self._wake_r in readable:
                readable.remove(self._wake_r)
                try:
                    self._wake_r.recv(4096)
                except OSError:
                    pass
            for s in set(readable) | set(errored):
                with self._park_lock:
                    self._parked.pop(s, None)
                if s in errored:
                    self._close_sock(s)
                    continue
                try:
                    if not s.recv(1, socket.MSG_PEEK):
                        self._close_sock(s)  # peer sent FIN while parked
                        continue
                    addr = s.getpeername()
                except OSError:
                    self._close_sock(s)
                    continue
                # next request arrived: back through the admission gate —
                # a parked connection has no standing claim on a worker
                self._admit(s, addr, requeued=True)
            now = time.monotonic()
            with self._park_lock:
                idle = [s for s, t0 in self._parked.items()
                        if now - t0 > self.request_timeout]
                for s in idle:
                    del self._parked[s]
                _INFLIGHT.labels("parked").set(len(self._parked))
            for s in idle:
                self._close_sock(s)

    # ---------------------------------------------------------- teardown

    @staticmethod
    def _close_sock(sock):
        """Close with FIN, not RST: half-close the send side, then drain
        briefly so unread peer bytes cannot flip the close into a reset."""
        try:
            try:
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            sock.settimeout(0.05)
            try:
                while sock.recv(4096):
                    pass
            except (OSError, TimeoutError):
                pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def shutdown(self):
        """Graceful stop: accept halts, queued + in-flight requests
        complete (sentinels ride BEHIND queued sockets in the FIFO), late
        arrivals get a clean 503, every pool thread joins — repeated
        start/stop cycles leak no worker threads."""
        self._stop.set()
        super().shutdown()  # blocks until the accept loop exits
        for _ in self._workers:
            self._queue.put(None)
        for w in self._workers:
            w.join(timeout=max(5.0, 2 * self.request_timeout))
        self._shed_queue.put(None)
        self._shedder.join(timeout=5.0)
        try:
            self._wake_w.send(b"s")
        except OSError:
            pass
        self._parker.join(timeout=5.0)
        for ws in (self._wake_r, self._wake_w):
            try:
                ws.close()
            except OSError:
                pass
        with self._park_lock:
            parked = list(self._parked)
            self._parked.clear()
        for s in parked:
            self._close_sock(s)
        while True:  # anything that raced past the sentinels
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._shed_now(item[0], "shutdown")
        self.server_close()


def serve(chain, op_pool=None, host="127.0.0.1", port=0, allow_origin=None,
          rate_limit=None, http_threads=None, request_timeout=None,
          tracer=None):
    """Start the API server; returns (server, thread, actual_port).
    `rate_limit` (requests/second, burst 2x) enables the QoS token bucket —
    over-quota requests get 429 + Retry-After instead of queued work.
    `http_threads`/`request_timeout` size the bounded worker pool and the
    per-request read deadline (None = env/default via the resolvers);
    `tracer` records per-request `http_serve` traces that adopt the
    caller's X-LH-Trace-Ctx wire context."""
    limiter = None
    if rate_limit is not None:
        from ..qos.ratelimit import RateLimiter

        limiter = RateLimiter().configure(
            "http_api", float(rate_limit), burst=2 * float(rate_limit)
        )
    handler = type(
        "BoundHandler",
        (BeaconApiHandler,),
        {"chain": chain, "op_pool": op_pool, "event_bus": EventBus(),
         "allow_origin": allow_origin, "rate_limiter": limiter,
         "tracer": tracer},
    )
    server = WorkerPoolHTTPServer(
        (host, port), handler, http_threads=http_threads,
        request_timeout=request_timeout,
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, server.server_address[1]
