"""Chain-facing execution-layer bridge.

This is the circuit the reference runs between consensus and execution:
  - block import calls `engine_newPayload` and maps the verdict onto the
    fork-choice execution status (optimistic / valid / invalid)
    (lighthouse/beacon_node/beacon_chain/src/execution_payload.rs:113,
     lighthouse/beacon_node/execution_layer/src/lib.rs:807)
  - head updates send `engine_forkchoiceUpdated`
    (canonical_head.rs fcU-on-head-change)
  - block production requests payload attributes via fcU and collects the
    built payload (+ deneb blobs bundle) with `engine_getPayload`
    (execution_layer/src/lib.rs get_payload flow)

The engine handle is duck-typed: `EngineApiClient` (JSON-RPC + JWT over
HTTP) and `MockExecutionLayer` (in-process double) both fit. All JSON
conversions live here so the engine side stays a plain transport.
"""

from __future__ import annotations

from ..execution.engine_api import PayloadStatus


# ------------------------------------------------------ JSON conversions
# Engine-API wire format: camelCase keys, 0x-hex QUANTITY for integers,
# 0x-hex DATA for byte strings (engine_api/json_structures.rs analog).


def _hexb(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _hexq(n: int) -> str:
    return hex(int(n))


def _unb(s: str) -> bytes:
    return bytes.fromhex(s[2:]) if s else b""


def _unq(s) -> int:
    if isinstance(s, int):
        return s
    return int(s, 16)


def withdrawal_to_json(w) -> dict:
    return {
        "index": _hexq(w.index),
        "validatorIndex": _hexq(w.validator_index),
        "address": _hexb(w.address),
        "amount": _hexq(w.amount),
    }


def withdrawal_from_json(types, d: dict):
    return types.Withdrawal.make(
        index=_unq(d["index"]),
        validator_index=_unq(d["validatorIndex"]),
        address=_unb(d["address"]),
        amount=_unq(d["amount"]),
    )


def payload_to_json(payload) -> dict:
    """SSZ ExecutionPayload container -> engine-API JSON (fork-agnostic:
    fields absent from the container are simply not emitted)."""
    out = {
        "parentHash": _hexb(payload.parent_hash),
        "feeRecipient": _hexb(payload.fee_recipient),
        "stateRoot": _hexb(payload.state_root),
        "receiptsRoot": _hexb(payload.receipts_root),
        "logsBloom": _hexb(payload.logs_bloom),
        "prevRandao": _hexb(payload.prev_randao),
        "blockNumber": _hexq(payload.block_number),
        "gasLimit": _hexq(payload.gas_limit),
        "gasUsed": _hexq(payload.gas_used),
        "timestamp": _hexq(payload.timestamp),
        "extraData": _hexb(payload.extra_data),
        "baseFeePerGas": _hexq(payload.base_fee_per_gas),
        "blockHash": _hexb(payload.block_hash),
        "transactions": [_hexb(t) for t in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [withdrawal_to_json(w) for w in payload.withdrawals]
    if hasattr(payload, "blob_gas_used"):
        out["blobGasUsed"] = _hexq(payload.blob_gas_used)
        out["excessBlobGas"] = _hexq(payload.excess_blob_gas)
    return out


def payload_from_json(types, d: dict):
    """Engine-API JSON -> SSZ ExecutionPayload for the active fork's types.
    Missing optional fields default (tolerates minimal test doubles)."""
    kw = dict(
        parent_hash=_unb(d["parentHash"]),
        fee_recipient=_unb(d.get("feeRecipient", "0x" + "00" * 20)),
        state_root=_unb(d.get("stateRoot", "0x" + "00" * 32)),
        receipts_root=_unb(d.get("receiptsRoot", "0x" + "00" * 32)),
        logs_bloom=_unb(d.get("logsBloom", "0x" + "00" * 256)),
        prev_randao=_unb(d.get("prevRandao", "0x" + "00" * 32)),
        block_number=_unq(d.get("blockNumber", 0)),
        gas_limit=_unq(d.get("gasLimit", 0)),
        gas_used=_unq(d.get("gasUsed", 0)),
        timestamp=_unq(d.get("timestamp", 0)),
        extra_data=_unb(d.get("extraData", "0x")),
        base_fee_per_gas=_unq(d.get("baseFeePerGas", 0)),
        block_hash=_unb(d["blockHash"]),
        transactions=[_unb(t) for t in d.get("transactions", [])],
    )
    field_names = {f.name for f in types.ExecutionPayload.fields}
    if "withdrawals" in field_names:
        kw["withdrawals"] = [
            withdrawal_from_json(types, w) for w in d.get("withdrawals", [])
        ]
    if "blob_gas_used" in field_names:
        kw["blob_gas_used"] = _unq(d.get("blobGasUsed", 0))
        kw["excess_blob_gas"] = _unq(d.get("excessBlobGas", 0))
    return types.ExecutionPayload.make(**kw)


# ------------------------------------------------------------- the bridge


class ExecutionLayer:
    """Holds the engine handle + chain-side policy (execution_layer/src/lib.rs
    trimmed to the consensus-facing surface)."""

    def __init__(self, engine, spec, default_fee_recipient: bytes = b"\x00" * 20,
                 verify_block_hashes: bool = False):
        self.engine = engine
        self.spec = spec
        self.default_fee_recipient = default_fee_recipient
        # cross-check payload.block_hash == keccak(rlp(header)) on import
        # (block_hash.rs); OFF for test doubles whose hashes are synthetic
        self.verify_block_hashes = verify_block_hashes
        # metrics-ish counters
        self.new_payloads = 0
        self.forkchoice_updates = 0
        self.payloads_built = 0

    # ---- import side (execution_payload.rs notify_new_payload)

    def notify_new_payload(self, payload, parent_beacon_block_root=None,
                           kzg_commitments=()) -> str:
        """Submit an imported block's payload; returns the engine verdict
        (VALID / INVALID / SYNCING / ACCEPTED). When enabled, the payload's
        claimed block_hash is first re-derived locally — a wrong hash is
        INVALID without consulting the engine (block_hash.rs).
        `kzg_commitments` (the block body's) become the V3 call's expected
        blob versioned hashes (sha256(commitment) with a 0x01 version
        byte)."""
        if self.verify_block_hashes:
            from ..execution.block_hash import verify_payload_block_hash

            if not verify_payload_block_hash(payload, parent_beacon_block_root):
                return PayloadStatus.invalid.value
        self.new_payloads += 1
        import hashlib

        versioned = [
            b"\x01" + hashlib.sha256(bytes(c)).digest()[1:]
            for c in kzg_commitments
        ]
        res = self.engine.new_payload(
            payload_to_json(payload),
            versioned_hashes=versioned,
            parent_beacon_block_root=parent_beacon_block_root,
        )
        return res.get("status", PayloadStatus.syncing.value)

    # ---- head side (canonical_head.rs fcU)

    def notify_forkchoice_updated(
        self, head_hash: bytes, safe_hash: bytes, finalized_hash: bytes, attrs=None
    ) -> dict:
        self.forkchoice_updates += 1
        return self.engine.forkchoice_updated(head_hash, safe_hash, finalized_hash, attrs)

    # ---- production side (get_payload flow)

    def produce_payload(
        self,
        types,
        head_payload_hash: bytes,
        safe_hash: bytes,
        finalized_hash: bytes,
        timestamp: int,
        prev_randao: bytes,
        fee_recipient: bytes | None = None,
        withdrawals=None,
        parent_beacon_block_root: bytes | None = None,
    ):
        """fcU-with-attributes + getPayload. Returns (ExecutionPayload,
        blobs_bundle | None) where blobs_bundle = (blobs, commitments,
        proofs) as raw bytes."""
        attrs = {
            "timestamp": _hexq(timestamp),
            "prevRandao": _hexb(prev_randao),
            "suggestedFeeRecipient": _hexb(fee_recipient or self.default_fee_recipient),
        }
        if withdrawals is not None:
            attrs["withdrawals"] = [withdrawal_to_json(w) for w in withdrawals]
        if parent_beacon_block_root is not None:
            # PayloadAttributesV3 (deneb+): required or the fcU is rejected
            attrs["parentBeaconBlockRoot"] = _hexb(parent_beacon_block_root)
        res = self.notify_forkchoice_updated(
            head_payload_hash, safe_hash, finalized_hash, attrs
        )
        status = res.get("payloadStatus", {}).get("status")
        payload_id = res.get("payloadId")
        if payload_id is None:
            raise RuntimeError(f"engine did not start a payload build: {status}")
        out = self.engine.get_payload(payload_id)
        self.payloads_built += 1
        payload = payload_from_json(types, out["executionPayload"])
        bundle = None
        raw = out.get("blobsBundle")
        if raw is not None:
            bundle = (
                [b if isinstance(b, bytes) else _unb(b) for b in raw["blobs"]],
                [c if isinstance(c, bytes) else _unb(c) for c in raw["commitments"]],
                [p if isinstance(p, bytes) else _unb(p) for p in raw["proofs"]],
            )
        return payload, bundle
