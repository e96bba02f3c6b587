"""`bn doctor` — offline fsck for a beacon datadir (the port's copy of the
JAX package's store/doctor.py; the port's CLI has no `bn` yet, so it is
called as `fsck_datadir`).

Walks the log-structured KV files WITHOUT opening them through an engine
(an engine open auto-truncates the corrupt tail — exactly the mutation a
diagnostic pass must not make), and reports:

  - log integrity: CRC walk of every record; the first bad record (torn
    tail from a crash mid-write, or a CRC mismatch from bit rot) and how
    many bytes sit past the last valid record
  - stray compaction tmps (`*.compact` leaked by a crash mid-compaction)
  - schema version vs CURRENT_SCHEMA_VERSION (pending migrations are
    applied at the next node open; a FUTURE version is a hard problem)
  - persisted-head anchor completeness: the resume record unpickles and
    the finalized anchor block + state it references are present — the
    precondition for `BeaconChain.from_store` to restart from this datadir

`--repair` fixes what is mechanically fixable: truncates the corrupt tail
back to the last valid record (what an engine open would do, made explicit
and logged) and deletes stray tmps. Anything else (incomplete anchor,
future schema) is reported for the operator — the node itself degrades
gracefully (resume falls back to the configured start anchor).
"""

from __future__ import annotations

import os
import pickle

from .kv import Column
from . import metadata as md
from .native_kv import OP_DEL, OP_PUT, LogWalk, _ckey, iter_record_ops

DB_FILES = ("hot.db", "cold.db")


def scan_log(path, build_index: bool = False) -> dict:
    """CRC-walk a record log read-only (via the shared LogWalk, so this
    stays in lock-step with what the engines replay). Returns integrity
    facts and (when build_index) the replayed key->value index of the
    valid prefix."""
    index: dict[bytes, bytes] = {}
    with open(path, "rb") as f:
        walk = LogWalk(f)
        for _start, _end, payload in walk:
            if build_index:
                for op, key, val in iter_record_ops(payload):
                    if op == OP_PUT:
                        index[key] = val
                    elif op == OP_DEL:
                        index.pop(key, None)
    file_bytes = os.path.getsize(path)
    out = {
        "path": os.fspath(path),
        "file_bytes": file_bytes,
        "valid_bytes": walk.valid_end,
        "records": walk.records,
        "tail_error": walk.tail_error,
        "tail_bytes": file_bytes - walk.valid_end,
    }
    if build_index:
        out["index"] = index
    return out


def fsck_datadir(datadir, repair: bool = False) -> dict:
    """Check (and with repair=True, fix) a beacon datadir. Returns the
    machine-readable report; report["ok"] is True when nothing is wrong
    OR everything wrong was repaired."""
    datadir = os.fspath(datadir)
    problems: list[str] = []
    repaired: list[str] = []
    notes: list[str] = []
    logs: dict[str, dict] = {}

    hot_index: dict[bytes, bytes] = {}
    for name in DB_FILES:
        path = os.path.join(datadir, name)
        tmp = path + ".compact"
        if os.path.exists(tmp):
            if repair:
                os.unlink(tmp)
                repaired.append(f"{name}: deleted stray compaction tmp")
            else:
                problems.append(
                    f"{name}: stray compaction tmp (crash mid-compaction)"
                )
        if not os.path.exists(path):
            notes.append(f"{name}: absent (fresh datadir or never opened)")
            continue
        info = scan_log(path, build_index=(name == "hot.db"))
        if name == "hot.db":
            hot_index = info.pop("index")
        logs[name] = info
        if info["tail_error"] is not None:
            msg = (
                f"{name}: {info['tail_error']} tail — {info['tail_bytes']} "
                f"bytes past the last valid record "
                f"(record {info['records']}, offset {info['valid_bytes']})"
            )
            if repair:
                with open(path, "r+b") as f:
                    f.truncate(info["valid_bytes"])
                info["tail_bytes"] = 0
                info["file_bytes"] = info["valid_bytes"]
                repaired.append(msg + " — truncated")
            else:
                problems.append(msg)

    # schema version (from the hot index, never via an engine open)
    raw = hot_index.get(_ckey(Column.metadata, md.SCHEMA_VERSION_KEY))
    version = int.from_bytes(raw[:8], "little") if raw else None
    schema = {"version": version, "current": md.CURRENT_SCHEMA_VERSION}
    if version is None and hot_index:
        notes.append(
            "schema version record missing (legacy pre-v1 DB; migrated at "
            "next open)"
        )
    elif version is not None and version > md.CURRENT_SCHEMA_VERSION:
        problems.append(
            f"schema version {version} is newer than this build's "
            f"{md.CURRENT_SCHEMA_VERSION} (downgrade refused at open)"
        )
    elif version is not None and version < md.CURRENT_SCHEMA_VERSION:
        notes.append(
            f"schema version {version} behind current "
            f"{md.CURRENT_SCHEMA_VERSION}; migrations apply at next open"
        )

    # persisted-head anchor completeness (the from_store precondition)
    anchor: dict = {"persisted": False}
    raw = hot_index.get(_ckey(Column.beacon_chain, b"persisted-head"))
    if raw is None:
        notes.append("no persisted head (node never persisted; restart "
                     "will need a configured start anchor)")
    else:
        anchor["persisted"] = True
        try:
            meta = pickle.loads(raw)
        except Exception as e:  # noqa: BLE001 — corrupt record is the finding
            anchor["readable"] = False
            problems.append(f"persisted-head record unreadable: {e}")
            meta = None
        if meta is not None:
            anchor["readable"] = True
            block_slots = meta.get("block_slots", {})
            state_by_block = meta.get("state_root_by_block", {})
            fin_root = meta.get("finalized_root", b"")
            if fin_root == b"\x00" * 32 or fin_root not in block_slots:
                fin_root = meta.get("anchor_root", b"")
            anchor["finalized_root"] = fin_root.hex() if fin_root else None
            anchor["head_root"] = meta.get("head_root", b"").hex()
            missing = []
            if _ckey(Column.block, fin_root) not in hot_index:
                missing.append("anchor block")
            sroot = state_by_block.get(fin_root)
            if sroot is None or _ckey(Column.state, sroot) not in hot_index:
                missing.append("anchor state")
            if missing:
                problems.append(
                    "persisted-head anchor incomplete: missing "
                    + " + ".join(missing)
                    + " (resume will fall back to the configured anchor)"
                )
            anchor["complete"] = not missing

    return {
        "datadir": datadir,
        "logs": logs,
        "schema": schema,
        "anchor": anchor,
        "problems": problems,
        "repaired": repaired,
        "notes": notes,
        "ok": not problems,
    }
