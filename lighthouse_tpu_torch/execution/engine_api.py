"""Execution-layer interface: engine API client, JWT auth, engine state
machine, and a mock EL for tests.

Parity surface: lighthouse/beacon_node/execution_layer/src/ —
engine_api/http.rs (JSON-RPC engine_newPayloadV*, engine_forkchoiceUpdatedV*,
engine_getPayloadV* with JWT bearer auth, auth.rs), engines.rs (upcheck/
offline state machine with retry), and test_utils/ (the mock EL +
ExecutionBlockGenerator the whole beacon test-suite leans on, SURVEY §4).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.request
from dataclasses import dataclass, field
from enum import Enum


class PayloadStatus(str, Enum):
    valid = "VALID"
    invalid = "INVALID"
    syncing = "SYNCING"
    accepted = "ACCEPTED"


# ------------------------------------------------------------ JWT (auth.rs)


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def make_jwt(secret: bytes, issued_at: int | None = None) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = _b64url(
        json.dumps({"iat": issued_at or int(time.time())}).encode()
    )
    signing_input = header + b"." + claims
    sig = hmac.new(secret, signing_input, hashlib.sha256).digest()
    return (signing_input + b"." + _b64url(sig)).decode()


def verify_jwt(secret: bytes, token: str, max_age: int = 60) -> bool:
    try:
        header, claims, sig = token.split(".")
        signing_input = (header + "." + claims).encode()
        expected = _b64url(hmac.new(secret, signing_input, hashlib.sha256).digest())
        if not hmac.compare_digest(expected.decode(), sig):
            return False
        pad = "=" * (-len(claims) % 4)
        iat = json.loads(base64.urlsafe_b64decode(claims + pad))["iat"]
        return abs(time.time() - iat) <= max_age
    except Exception:
        return False


# ------------------------------------------------------------ engine states


class EngineHealth(Enum):
    synced = "synced"
    syncing = "syncing"
    offline = "offline"
    auth_failed = "auth_failed"


@dataclass
class EngineState:
    """engines.rs upcheck/fallback state machine."""

    health: EngineHealth = EngineHealth.offline
    consecutive_failures: int = 0
    last_upcheck: float = 0.0

    def on_success(self):
        self.health = EngineHealth.synced
        self.consecutive_failures = 0

    def on_failure(self):
        self.consecutive_failures += 1
        if self.consecutive_failures >= 3:
            self.health = EngineHealth.offline


class EngineApiClient:
    """JSON-RPC over HTTP with JWT (engine_api/http.rs analog)."""

    def __init__(self, url: str, jwt_secret: bytes, timeout: float = 8.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self.state = EngineState()
        self._id = 0

    def _call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "method": method, "params": params, "id": self._id}
        ).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {make_jwt(self.jwt_secret)}",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                resp = json.loads(r.read())
            self.state.on_success()
        except Exception:
            self.state.on_failure()
            raise
        if "error" in resp and resp["error"]:
            raise RuntimeError(f"engine error: {resp['error']}")
        return resp.get("result")

    # public generic JSON-RPC entry (duck-typed with MockEth1Rpc.call so the
    # same transport serves the eth1 scraper against a real endpoint)
    def call(self, method: str, params: list):
        return self._call(method, params)

    def new_payload(self, payload_json: dict, versioned_hashes=None,
                    parent_beacon_block_root: bytes | None = None) -> dict:
        """engine_newPayloadV3 requires THREE params: the payload, the
        expected blob versioned hashes, and the parent beacon block root —
        a real EL rejects the call without them."""
        return self._call(
            "engine_newPayloadV3",
            [
                payload_json,
                ["0x" + h.hex() for h in (versioned_hashes or [])],
                "0x" + (parent_beacon_block_root or b"\x00" * 32).hex(),
            ],
        )

    def forkchoice_updated(self, head: bytes, safe: bytes, finalized: bytes, attrs=None) -> dict:
        state = {
            "headBlockHash": "0x" + head.hex(),
            "safeBlockHash": "0x" + safe.hex(),
            "finalizedBlockHash": "0x" + finalized.hex(),
        }
        return self._call("engine_forkchoiceUpdatedV3", [state, attrs])

    def get_payload(self, payload_id: str) -> dict:
        return self._call("engine_getPayloadV3", [payload_id])


# ------------------------------------------------------------ mock EL


@dataclass
class MockExecutionLayer:
    """In-process EL double (execution_layer/src/test_utils analog):
    maintains a toy block tree, validates payload parent linkage, supports
    forced INVALID verdicts for invalidation tests."""

    blocks: dict[bytes, dict] = field(default_factory=dict)
    head: bytes = b"\x00" * 32
    invalid_hashes: set = field(default_factory=set)
    payload_counter: int = 0
    pending_payloads: dict = field(default_factory=dict)
    # deneb: queued (blob, commitment, proof) triples served with the next
    # getPayload as a blobsBundle (ExecutionBlockGenerator blob support)
    queued_blobs: list = field(default_factory=list)

    def __post_init__(self):
        self.blocks[self.head] = {"number": 0, "parent": None}

    # engine API surface (duck-typed like EngineApiClient)

    def new_payload(self, payload_json: dict, versioned_hashes=None,
                    parent_beacon_block_root: bytes | None = None) -> dict:
        block_hash = bytes.fromhex(payload_json["blockHash"][2:])
        parent = bytes.fromhex(payload_json["parentHash"][2:])
        if block_hash in self.invalid_hashes:
            return {"status": PayloadStatus.invalid.value, "latestValidHash": None}
        if parent not in self.blocks:
            return {"status": PayloadStatus.syncing.value}
        self.blocks[block_hash] = {
            "number": self.blocks[parent]["number"] + 1,
            "parent": parent,
        }
        return {"status": PayloadStatus.valid.value, "latestValidHash": payload_json["blockHash"]}

    def forkchoice_updated(self, head: bytes, safe: bytes, finalized: bytes, attrs=None) -> dict:
        if head not in self.blocks:
            return {"payloadStatus": {"status": PayloadStatus.syncing.value}, "payloadId": None}
        self.head = head
        payload_id = None
        if attrs is not None:
            self.payload_counter += 1
            payload_id = f"0x{self.payload_counter:016x}"
            self.pending_payloads[payload_id] = {"parent": head, "attrs": dict(attrs)}
        return {
            "payloadStatus": {"status": PayloadStatus.valid.value},
            "payloadId": payload_id,
        }

    def get_payload(self, payload_id: str) -> dict:
        """Build a payload echoing the fcU attributes (the real EL honors
        timestamp/prevRandao/feeRecipient/withdrawals from the attrs —
        ExecutionBlockGenerator does the same for the reference's tests)."""
        info = self.pending_payloads.pop(payload_id)
        parent = info["parent"]
        attrs = info["attrs"]
        number = self.blocks[parent]["number"] + 1
        seed = b"mock-el" + parent + number.to_bytes(8, "big") + repr(
            sorted(attrs.items())
        ).encode()
        block_hash = hashlib.sha256(seed).digest()
        payload = {
            "parentHash": "0x" + parent.hex(),
            "feeRecipient": attrs.get("suggestedFeeRecipient", "0x" + "00" * 20),
            "stateRoot": "0x" + hashlib.sha256(b"state" + seed).hexdigest(),
            "receiptsRoot": "0x" + "00" * 32,
            "logsBloom": "0x" + "00" * 256,
            "prevRandao": attrs.get("prevRandao", "0x" + "00" * 32),
            "blockNumber": hex(number),
            "gasLimit": hex(30_000_000),
            "gasUsed": hex(21_000),
            "timestamp": attrs.get("timestamp", "0x0"),
            "extraData": "0x",
            "baseFeePerGas": hex(7),
            "blockHash": "0x" + block_hash.hex(),
            "transactions": [],
        }
        if "withdrawals" in attrs:
            payload["withdrawals"] = attrs["withdrawals"]
        out = {"executionPayload": payload}
        if self.queued_blobs:
            triples, self.queued_blobs = self.queued_blobs, []
            payload["blobGasUsed"] = hex(0)
            payload["excessBlobGas"] = hex(0)
            out["blobsBundle"] = {
                "blobs": [b for b, _, _ in triples],
                "commitments": [c for _, c, _ in triples],
                "proofs": [p for _, _, p in triples],
            }
        return out


# ------------------------------------------------------------ mock EL server


def mock_el_server(port: int = 0, jwt_secret: bytes | None = None,
                   host: str = "127.0.0.1"):
    """Standalone engine-API JSON-RPC server over a MockExecutionLayer —
    the out-of-process EL double (`lighthouse-tpu mock-el`, the lcli
    `mock-el` analog: lighthouse/lcli/src/main.rs mock-el +
    execution_layer/src/test_utils' RPC handler). Speaks exactly the
    surface EngineApiClient calls (newPayloadV3 / forkchoiceUpdatedV3 /
    getPayloadV3) with real JWT verification, so `bn --engine
    http://host:port --jwt-secret FILE` exercises the true HTTP path.

    Returns (server, thread, port, mock). Caller owns shutdown."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    mock = MockExecutionLayer()
    mock_lock = threading.Lock()   # MockExecutionLayer is not thread-safe
    secret = jwt_secret if jwt_secret is not None else b"\x11" * 32

    class Handler(BaseHTTPRequestHandler):
        timeout = 30               # a stalled connection must not pin a thread

        def log_message(self, *a):
            pass

        def do_POST(self):
            auth = self.headers.get("Authorization", "")
            token = auth.removeprefix("Bearer ").strip()
            if not token or not verify_jwt(secret, token):
                self.send_response(401)
                self.end_headers()
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                method = req.get("method", "")
                params = req.get("params", [])
                if method == "engine_newPayloadV3":
                    payload, hashes, root = params
                    with mock_lock:
                        result = mock.new_payload(
                            payload,
                            [bytes.fromhex(x[2:]) for x in hashes],
                            bytes.fromhex(root[2:]),
                        )
                elif method == "engine_forkchoiceUpdatedV3":
                    state, attrs = params
                    with mock_lock:
                        result = mock.forkchoice_updated(
                            bytes.fromhex(state["headBlockHash"][2:]),
                            bytes.fromhex(state["safeBlockHash"][2:]),
                            bytes.fromhex(state["finalizedBlockHash"][2:]),
                            attrs,
                        )
                elif method == "engine_getPayloadV3":
                    with mock_lock:
                        result = mock.get_payload(params[0])
                else:
                    body = json.dumps({
                        "jsonrpc": "2.0", "id": req.get("id"),
                        "error": {"code": -32601,
                                  "message": f"unknown method {method}"},
                    }).encode()
                    self._reply(body)
                    return
                body = json.dumps(
                    {"jsonrpc": "2.0", "id": req.get("id"), "result": result}
                ).encode()
            except Exception as e:  # noqa: BLE001 - surfaced as RPC error
                body = json.dumps({
                    "jsonrpc": "2.0", "id": None,
                    "error": {"code": -32000,
                              "message": f"{type(e).__name__}: {e}"},
                }).encode()
            self._reply(body)

        def _reply(self, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, server.server_address[1], mock
