"""Typed Beacon-API HTTP client (common/eth2 BeaconNodeHttpClient analog).

Implements the same duck-typed surface as
validator.beacon_node.InProcessBeaconNode so the validator client can run
against a remote beacon node over HTTP exactly as it runs in-process."""

from __future__ import annotations

import http.client
import itertools
import json
import math
import socket
import threading
import time as _time
from time import perf_counter
from urllib.parse import urlsplit

from ..observability.propagation import WireTraceContext, encode_ctx
from ..observability.trace import current_wire_ctx, next_trace_id
from ..state_transition.slot import types_for_slot
from ..utils.metrics import REGISTRY
from ..validator.beacon_node import (
    AttesterDuty,
    BeaconNodeError,
    NodeRateLimited,
    NodeTimeout,
    ProposerDuty,
)

# timeout classification feeds the fallback's health scoring: a connect
# failure, a silent server, and a mid-body stall are different diseases
# and must demote differently — so each phase is its own series
HTTP_CLIENT_TIMEOUTS = REGISTRY.counter_vec(
    "http_client_timeouts_total",
    "beacon-API client timeouts, by phase (connect / read / body)",
    ("phase",),
)
HTTP_CLIENT_CONNECTIONS = REGISTRY.counter_vec(
    "http_client_connections_total",
    "beacon-API client connection events (new / reused / stale_retry)",
    ("event",),
)

#: a 429 with no usable Retry-After still deserves SOME backoff floor
RETRY_AFTER_DEFAULT = 1.0
#: and no server gets to park a validator client past this — a huge
#: Retry-After must never out-sleep a duty deadline
RETRY_AFTER_CAP = 30.0


def parse_retry_after(raw) -> float:
    """Clamp a Retry-After header to a sane bounded range: non-numeric,
    NaN, or missing values fall back to RETRY_AFTER_DEFAULT; negatives
    clamp to 0; huge values clamp to RETRY_AFTER_CAP. The old behavior
    (malformed -> 0.0, huge -> unbounded sleep) turned one bad header into
    either a hot retry loop or a missed slot."""
    try:
        v = float(raw)
    except (TypeError, ValueError):
        return RETRY_AFTER_DEFAULT
    if not math.isfinite(v):
        return RETRY_AFTER_DEFAULT
    return min(max(v, 0.0), RETRY_AFTER_CAP)


def _http_error(verb: str, path: str, status: int, headers, body: bytes):
    """429s — and 503s carrying Retry-After, the admission gate's shed
    shape — become the TYPED rate-limit error so the fallback retries
    without demoting the node and honors the header as a backoff floor
    (classification by type, not text)."""
    if status == 429 or (status == 503 and headers.get("Retry-After")):
        return NodeRateLimited(
            f"{verb} {path}: {status} rate limited",
            retry_after=parse_retry_after(headers.get("Retry-After")),
        )
    return BeaconNodeError(f"{verb} {path}: {status} {body[:200]!r}")


#: process-wide publish offsets for contexts minted at the client seam
_ctx_seq = itertools.count()


class BeaconNodeHttpClient:
    """Keep-alive pooled HTTP client: requests reuse per-node
    `http.client` connections instead of paying a TCP handshake per call
    (the reference's reqwest pool). A reused socket that the server closed
    between requests surfaces as RemoteDisconnected on the next write —
    retried ONCE on a fresh connection (stale-socket semantics), never for
    sockets that failed while fresh.

    Every request carries an `X-LH-Trace-Ctx` wire context: the caller's
    current context when one is bound to the thread (so a duty driven by a
    producer's publish joins its causal chain), else a context minted here
    — and the optional `tracer` records the serialization + socket cost as
    an `http_client` trace keyed on that context, which the cluster merge
    links to the server's `http_serve` span."""

    #: idle sockets kept per client; the fleet runs hundreds of clients
    #: per node, so each keeps a tiny pool rather than a deep one
    MAX_IDLE = 2

    def __init__(self, base_url: str, timeout: float = 5.0, tracer=None,
                 origin: str | None = None):
        self.base_url = base_url.rstrip("/")
        parts = urlsplit(self.base_url)
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self.timeout = timeout
        self.tracer = tracer
        self.origin = origin or f"http_client@{self._host}:{self._port}"
        self._idle: list = []
        self._pool_lock = threading.Lock()

    # ------------------------------------------------------------ plumbing

    def _checkout(self) -> tuple[http.client.HTTPConnection, bool]:
        with self._pool_lock:
            if self._idle:
                HTTP_CLIENT_CONNECTIONS.labels("reused").inc()
                return self._idle.pop(), True
        HTTP_CLIENT_CONNECTIONS.labels("new").inc()
        return (
            http.client.HTTPConnection(
                self._host, self._port, timeout=self.timeout
            ),
            False,
        )

    def _checkin(self, conn) -> None:
        with self._pool_lock:
            if len(self._idle) < self.MAX_IDLE:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._pool_lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()

    def _mint_ctx(self) -> WireTraceContext:
        return WireTraceContext(
            origin=self.origin, trace_id=next_trace_id(), slot=0,
            seq=next(_ctx_seq), sent_at=_time.time(),
        )

    def _request(self, method: str, path: str, payload=None):
        data = None
        headers = {}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        ctx = current_wire_ctx() or self._mint_ctx()
        headers["X-LH-Trace-Ctx"] = encode_ctx(ctx).hex()
        tr = None
        if self.tracer is not None:
            tr = self.tracer.begin("http_client")
            tr.adopt(ctx)
        t0 = perf_counter()
        try:
            status, resp_headers, body = self._roundtrip(
                method, path, data, headers
            )
        finally:
            if tr is not None:
                tr.add_span("http_request", t0, perf_counter(),
                            path=path, method=method)
                self.tracer.finish(tr)
        if status >= 400:
            raise _http_error(method, path, status, resp_headers, body)
        return json.loads(body) if body else {}

    def _roundtrip(self, method: str, path: str, data, headers):
        """One HTTP exchange over a pooled connection; returns (status,
        headers, body). Timeouts classify by phase — connect (no listener
        reachable in time), read (request sent, no response line), body
        (response started, then stalled) — because the fallback's health
        scoring treats them differently from hard errors."""
        last_exc = None
        for attempt in (0, 1):
            conn, reused = self._checkout()
            try:
                if conn.sock is None:
                    try:
                        conn.connect()
                    except (TimeoutError, socket.timeout) as e:
                        HTTP_CLIENT_TIMEOUTS.labels("connect").inc()
                        raise NodeTimeout(
                            f"{method} {path}: connect timed out"
                        ) from e
                try:
                    conn.request(method, path, body=data, headers=headers)
                    resp = conn.getresponse()
                except (TimeoutError, socket.timeout) as e:
                    HTTP_CLIENT_TIMEOUTS.labels("read").inc()
                    raise NodeTimeout(
                        f"{method} {path}: response timed out"
                    ) from e
                except (http.client.RemoteDisconnected,
                        http.client.BadStatusLine,
                        ConnectionResetError, BrokenPipeError) as e:
                    if reused and attempt == 0:
                        # server closed the pooled socket between requests
                        # (keep-alive expiry): retry once, fresh
                        HTTP_CLIENT_CONNECTIONS.labels("stale_retry").inc()
                        last_exc = e
                        conn.close()
                        continue
                    raise BeaconNodeError(f"{method} {path}: {e}") from e
                try:
                    body = resp.read()
                except (TimeoutError, socket.timeout) as e:
                    HTTP_CLIENT_TIMEOUTS.labels("body").inc()
                    raise NodeTimeout(
                        f"{method} {path}: response body stalled"
                    ) from e
                except (http.client.IncompleteRead,
                        ConnectionResetError) as e:
                    raise BeaconNodeError(
                        f"{method} {path}: truncated response: {e}"
                    ) from e
            except (NodeTimeout, BeaconNodeError):
                conn.close()
                raise
            except OSError as e:
                # anything unclassified above (refused, unreachable, DNS)
                conn.close()
                raise BeaconNodeError(f"{method} {path}: {e}") from e
            if resp.will_close:
                conn.close()
            else:
                self._checkin(conn)
            return resp.status, resp.headers, body
        raise BeaconNodeError(f"{method} {path}: {last_exc}") from last_exc

    def _get(self, path: str):
        return self._request("GET", path)

    def _post(self, path: str, payload):
        return self._request("POST", path, payload)

    # ------------------------------------------------------------ node

    def is_healthy(self) -> bool:
        try:
            self._get("/eth/v1/node/health")
            return True
        except BeaconNodeError:
            return False

    def version(self) -> str:
        return self._get("/eth/v1/node/version")["data"]["version"]

    def syncing(self) -> dict:
        return self._get("/eth/v1/node/syncing")["data"]

    def genesis(self) -> dict:
        return self._get("/eth/v1/beacon/genesis")["data"]

    def genesis_validators_root(self) -> bytes:
        return bytes.fromhex(self.genesis()["genesis_validators_root"][2:])

    def spec(self) -> dict:
        return self._get("/eth/v1/config/spec")["data"]

    # ------------------------------------------------------------ beacon

    def state_root(self, state_id: str = "head") -> bytes:
        return bytes.fromhex(
            self._get(f"/eth/v1/beacon/states/{state_id}/root")["data"]["root"][2:]
        )

    def finality_checkpoints(self, state_id: str = "head") -> dict:
        return self._get(f"/eth/v1/beacon/states/{state_id}/finality_checkpoints")["data"]

    def validators(self, state_id: str = "head") -> list[dict]:
        return self._get(f"/eth/v1/beacon/states/{state_id}/validators")["data"]

    def block_root(self, block_id: str = "head") -> bytes:
        return bytes.fromhex(
            self._get(f"/eth/v1/beacon/blocks/{block_id}/root")["data"]["root"][2:]
        )

    def header(self, block_id: str = "head") -> dict:
        return self._get(f"/eth/v1/beacon/headers/{block_id}")["data"]

    def debug_state_ssz(self, state_id: str = "finalized") -> bytes:
        """Full SSZ BeaconState (checkpoint-sync download)."""
        return bytes.fromhex(
            self._get(f"/eth/v2/debug/beacon/states/{state_id}")["data"][2:]
        )

    def block_ssz(self, block_id: str = "finalized") -> bytes:
        """Full SSZ SignedBeaconBlock (checkpoint-sync companion)."""
        return bytes.fromhex(
            self._get(f"/lighthouse_tpu/blocks/{block_id}/ssz")["data"][2:]
        )

    # ------------------------------------------------------------ duties

    def attester_duties(self, epoch: int, indices: list[int]) -> list[AttesterDuty]:
        resp = self._post(
            f"/eth/v1/validator/duties/attester/{epoch}", [str(i) for i in indices]
        )
        return [
            AttesterDuty(
                pubkey=bytes.fromhex(d["pubkey"][2:]),
                validator_index=int(d["validator_index"]),
                slot=int(d["slot"]),
                committee_index=int(d["committee_index"]),
                committee_length=int(d["committee_length"]),
                committee_position=int(d["validator_committee_index"]),
                committees_at_slot=int(d["committees_at_slot"]),
            )
            for d in resp["data"]
        ]

    def proposer_duties(self, epoch: int) -> list[ProposerDuty]:
        resp = self._get(f"/eth/v1/validator/duties/proposer/{epoch}")
        return [
            ProposerDuty(
                pubkey=bytes.fromhex(d["pubkey"][2:]),
                validator_index=int(d["validator_index"]),
                slot=int(d["slot"]),
            )
            for d in resp["data"]
        ]

    # ------------------------------------------------------------ publish

    def publish_attestations(self, attestations, types) -> int:
        payload = []
        for att in attestations:
            from ..ssz.core import Bitlist

            bl = None
            for f in types.Attestation.fields:
                if f.name == "aggregation_bits":
                    bl = f.type
            payload.append(
                {
                    "aggregation_bits": "0x" + bl.serialize(att.aggregation_bits).hex(),
                    "data": {
                        "slot": str(att.data.slot),
                        "index": str(att.data.index),
                        "beacon_block_root": "0x" + bytes(att.data.beacon_block_root).hex(),
                        "source": {
                            "epoch": str(att.data.source.epoch),
                            "root": "0x" + bytes(att.data.source.root).hex(),
                        },
                        "target": {
                            "epoch": str(att.data.target.epoch),
                            "root": "0x" + bytes(att.data.target.root).hex(),
                        },
                    },
                    "signature": "0x" + bytes(att.signature).hex(),
                }
            )
        self._post("/eth/v1/beacon/pool/attestations", payload)
        return len(attestations)

    def attestation_data(self, slot: int, committee_index: int, types=None):
        got = self._get(
            f"/eth/v1/validator/attestation_data?slot={slot}"
            f"&committee_index={committee_index}"
        )["data"]
        if types is None:
            from ..state_transition.slot import types_for_slot

            types = types_for_slot(self.spec_obj, slot) if hasattr(self, "spec_obj") else None
        if types is None:
            return got
        return types.AttestationData.make(
            slot=int(got["slot"]),
            index=int(got["index"]),
            beacon_block_root=bytes.fromhex(got["beacon_block_root"][2:]),
            source=types.Checkpoint.make(
                epoch=int(got["source"]["epoch"]),
                root=bytes.fromhex(got["source"]["root"][2:]),
            ),
            target=types.Checkpoint.make(
                epoch=int(got["target"]["epoch"]),
                root=bytes.fromhex(got["target"]["root"][2:]),
            ),
        )

    def produce_block(self, slot: int, randao_reveal: bytes, types, graffiti: bytes | None = None):
        path = (
            f"/eth/v3/validator/blocks/{slot}?randao_reveal=0x{randao_reveal.hex()}"
        )
        if graffiti is not None:
            path += f"&graffiti=0x{graffiti.hex()}"
        got = self._get(path)
        return types.BeaconBlock.deserialize(bytes.fromhex(got["data"][2:]))

    def publish_block(self, signed_block, types) -> None:
        self._post(
            "/eth/v2/beacon/blocks",
            {"ssz": "0x" + types.SignedBeaconBlock.serialize(signed_block).hex()},
        )
