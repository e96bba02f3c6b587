"""ctypes binding for the native C++ log-structured KV store.

The port's copy of the JAX package's store/native_kv.py. It tracks no
built library: at first use it builds native/kv_store.cc with g++ into the
checkout's build/native/ltkv-<digest of the source>/, as the CUDA kernels
build into build/kernels/ (utils/torchcfg.py); exposes the
KeyValueStore interface so HotColdDB can run on either MemoryStore (tests)
or NativeKVStore (production), mirroring how the reference picks
LevelDB vs MemoryStore behind its KeyValueStore trait.

Graceful degradation: when the shared library cannot be built OR loaded
(no g++ in the image, a libstdc++ older than the library's GLIBCXX
requirement, ...), `NativeKVStore(path)` transparently constructs a
PurePythonKVStore instead — a pure-Python replay of the SAME on-disk
format (CRC32-framed append-only record log, see kv_store.cc), so a
database written by either engine opens under the other. The swap is
announced with a single structured warn per process; everything else about
the node keeps working, just with Python-speed store IO."""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import time
import zlib
from pathlib import Path

from ..utils.logging import get_logger
from .kv import Column, KeyValueOp, KeyValueStore

# Durability policy for the append path (both engines):
#   always — fsync after every record (torn writes lose at most the record
#            being written; survives power loss)
#   batch  — fsync every FSYNC_BATCH_EVERY records and on flush()/close()
#            (bounded loss window; the default)
#   never  — OS page cache only (tests / throwaway datadirs)
# The on-disk format is crash-consistent under ALL policies (CRC-framed
# records, replay stops at the torn tail); the policy only bounds how much
# acknowledged work a power loss can undo.
FSYNC_POLICIES = ("always", "batch", "never")
FSYNC_BATCH_EVERY = 64


def _resolve_fsync(policy: str | None) -> str:
    if policy is None:
        policy = os.environ.get("LIGHTHOUSE_TPU_STORE_FSYNC", "batch")
    if policy not in FSYNC_POLICIES:
        raise ValueError(
            f"unknown fsync policy {policy!r} (have: {', '.join(FSYNC_POLICIES)})"
        )
    return policy


def _fsync_dir(path: str) -> None:
    """fsync the directory holding `path` so a rename/create survives power
    loss (the file's own fsync does not persist its directory entry)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # platform without directory open; best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)

# On-disk record framing, shared with the C++ engine (kv_store.cc):
#   record:  [u32 crc over payload][u32 payload_len][payload]
#   payload: sequence of ops [u8 op][u32 klen][u32 vlen][key][value]
OP_PUT = 1
OP_DEL = 2


class LogWalk:
    """Read-only CRC walk of a record log — the single Python owner of the
    framed record format (engine replay, doctor's fsck and the fault-
    injection helpers all read through it; the C++ loader mirrors it).
    Iterate for (start, end, payload) of each valid record; after
    iteration `valid_end`/`records`/`tail_error` say where and why the
    walk stopped (tail_error: None = clean EOF, "truncated" = short
    header/payload, "crc" = checksum mismatch)."""

    def __init__(self, f):
        self._f = f
        self.valid_end = f.tell()
        self.records = 0
        self.tail_error = None

    def __iter__(self):
        f = self._f
        while True:
            start = self.valid_end
            header = f.read(8)
            if len(header) < 8:
                if header:
                    self.tail_error = "truncated"
                return
            crc, length = struct.unpack("<II", header)
            payload = f.read(length)
            if len(payload) < length:
                self.tail_error = "truncated"
                return
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                self.tail_error = "crc"
                return
            self.records += 1
            self.valid_end = f.tell()
            yield start, self.valid_end, payload


def iter_record_ops(payload: bytes):
    """Yield (op, key, value) from one record payload; stops silently at a
    truncated op run (only possible inside an already-CRC-valid record if
    the writer was cut mid-encode, which the framing makes unreachable —
    kept for defense in depth)."""
    pos, n = 0, len(payload)
    while pos + 9 <= n:
        op = payload[pos]
        klen, vlen = struct.unpack_from("<II", payload, pos + 1)
        pos += 9
        if pos + klen + vlen > n:
            return
        key = payload[pos : pos + klen]
        pos += klen
        val = payload[pos : pos + vlen]
        pos += vlen
        yield op, key, val


_SRC = Path(__file__).parent / "native" / "kv_store.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_build_lock = threading.Lock()
# this process's g++ build, if it made one: {"path", "seconds"}
BUILD_INFO: dict = {}


def _lib_path() -> Path:
    """The library's place under build/, keyed by the source's digest: an
    edited source builds anew, and nothing built lands in a commit."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"ltkv-{digest}" / "libltkv.so"


def _build(dst: Path) -> Path:
    dst.parent.mkdir(parents=True, exist_ok=True)
    # built beside its place and renamed into it: processes that build at
    # once (test workers) never load a half-written library
    tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        str(_SRC), "-o", str(tmp),
    ]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, dst)
    BUILD_INFO.update(path=str(dst), seconds=time.perf_counter() - t0)
    return dst


def _ensure_built() -> Path:
    with _build_lock:
        dst = _lib_path()
        if dst.exists():
            return dst
        return _build(dst)


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _ensure_built()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        # a library built earlier can be unloadable on THIS host (e.g. it
        # requires a GLIBCXX newer than the system libstdc++): recompiling
        # from source links against the local toolchain, so try that once
        # before the caller degrades to the pure-Python engine
        with _build_lock:
            path = _build(_lib_path())
        lib = ctypes.CDLL(str(path))
    lib.kvs_open.restype = ctypes.c_void_p
    lib.kvs_open.argtypes = [ctypes.c_char_p]
    lib.kvs_close.argtypes = [ctypes.c_void_p]
    lib.kvs_put.restype = ctypes.c_int
    lib.kvs_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                            ctypes.c_char_p, ctypes.c_uint32]
    lib.kvs_delete.restype = ctypes.c_int
    lib.kvs_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.kvs_batch.restype = ctypes.c_int
    lib.kvs_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.kvs_get.restype = ctypes.c_int
    lib.kvs_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_uint32)]
    lib.kvs_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.kvs_count.restype = ctypes.c_uint64
    lib.kvs_count.argtypes = [ctypes.c_void_p]
    lib.kvs_compact.restype = ctypes.c_int
    lib.kvs_compact.argtypes = [ctypes.c_void_p]
    # durability controls — absent from pre-fsync builds of the library
    # (kept from the reference, whose tracked .so could predate them);
    # degrade to fflush-only rather than refusing to open the DB
    try:
        lib.kvs_set_fsync.restype = ctypes.c_int
        lib.kvs_set_fsync.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.kvs_flush.restype = ctypes.c_int
        lib.kvs_flush.argtypes = [ctypes.c_void_p]
        lib._has_fsync = True
    except AttributeError:
        lib._has_fsync = False
        get_logger("store").warn(
            "native kv library predates fsync support; durability policy "
            "degraded to OS page cache (rebuild with g++ to fix)"
        )
    _ITER_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32)
    lib._ITER_CB = _ITER_CB
    lib.kvs_iter_prefix.restype = ctypes.c_int
    lib.kvs_iter_prefix.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                                    _ITER_CB, ctypes.c_void_p]
    _lib = lib
    return lib


def _ckey(column: Column, key: bytes) -> bytes:
    return column.value.encode() + b":" + key


_fallback_warned = False


def _native_unavailable(err: Exception) -> None:
    """One structured warn per process when the C++ engine is unusable."""
    global _fallback_warned
    if not _fallback_warned:
        _fallback_warned = True
        get_logger("store").warn(
            "native kv store unavailable; falling back to the pure-Python "
            "log store (same on-disk format, slower IO)",
            error=f"{type(err).__name__}: {err}",
        )


class PurePythonKVStore(KeyValueStore):
    """Pure-Python engine over the native store's record-log format.

    Format (kv_store.cc): records of [u32 crc][u32 len][payload], payload a
    run of ops [u8 op][u32 klen][u32 vlen][key][value] with op 1=put 2=del;
    all integers little-endian, crc = CRC-32 (zlib) over the payload.
    Replay stops at the first truncated or CRC-failing record — the
    crash-consistent prefix wins, exactly like the C++ loader."""

    def __init__(self, path: str | os.PathLike, fsync: str | None = None):
        path = os.fspath(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._fsync = _resolve_fsync(fsync)
        self._unsynced = 0
        self._lock = threading.Lock()
        self._index: dict[bytes, bytes] = {}
        # a crash mid-compaction leaks its tmp file; left in place it would
        # sit there forever (and a later compaction would happily reuse the
        # name) — delete it before replay, it was never the live DB
        tmp = path + ".compact"
        if os.path.exists(tmp):
            os.unlink(tmp)
            get_logger("store").warn(
                "removed stale compaction tmp (crash mid-compaction)",
                path=tmp,
            )
        valid_end = self._replay()
        # drop the corrupt/truncated tail BEFORE appending: a new record
        # written after garbage would be unreachable on the next replay
        # (the scanner stops at the bad record), silently losing every
        # post-recovery write
        if valid_end is not None:
            with open(path, "r+b") as f:
                f.truncate(valid_end)
        self._log = open(path, "ab")

    # ------------------------------------------------------------ log IO

    def _replay(self) -> int | None:
        """Replay the log; returns the byte offset of the end of the last
        valid record (None when the file does not exist yet)."""
        try:
            f = open(self._path, "rb")
        except FileNotFoundError:
            return None  # fresh store
        with f:
            walk = LogWalk(f)
            for _start, _end, payload in walk:
                self._apply(payload)
            # a torn/corrupt tail ends the walk; the prefix wins
            return walk.valid_end

    def _apply(self, payload: bytes) -> None:
        for op, key, val in iter_record_ops(payload):
            if op == OP_PUT:
                self._index[key] = val
            elif op == OP_DEL:
                self._index.pop(key, None)

    @staticmethod
    def _encode_ops(ops: list[KeyValueOp]) -> bytes:
        payload = bytearray()
        for op in ops:
            k = _ckey(op.column, op.key)
            v = op.value if (op.kind == "put" and op.value) else b""
            payload.append(OP_PUT if op.kind == "put" else OP_DEL)
            payload += struct.pack("<II", len(k), len(v))
            payload += k
            payload += v
        return bytes(payload)

    def _write_record(self, fh, payload: bytes) -> None:
        fh.write(struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                             len(payload)))
        fh.write(payload)
        fh.flush()

    def _sync_policy(self) -> None:
        """Apply the fsync policy after an append (caller holds the lock and
        has already flushed Python buffers)."""
        if self._fsync == "always":
            os.fsync(self._log.fileno())
        elif self._fsync == "batch":
            self._unsynced += 1
            if self._unsynced >= FSYNC_BATCH_EVERY:
                os.fsync(self._log.fileno())
                self._unsynced = 0

    # ------------------------------------------------------------ interface

    def get(self, column: Column, key: bytes) -> bytes | None:
        with self._lock:
            return self._index.get(_ckey(column, key))

    def do_atomically(self, ops: list[KeyValueOp]) -> None:
        payload = self._encode_ops(ops)
        with self._lock:
            self._write_record(self._log, payload)
            self._sync_policy()
            self._apply(payload)

    def iter_column(self, column: Column):
        prefix = column.value.encode() + b":"
        with self._lock:
            items = sorted(
                (k[len(prefix):], v)
                for k, v in self._index.items()
                if k.startswith(prefix)
            )
        return iter(items)

    def compact(self) -> None:
        """Rewrite the log with only live records (stop-the-world).

        Crash-safe: the tmp file is fsynced BEFORE os.replace (a power loss
        after the rename must find the new bytes on disk, not a zero-length
        inode), and the directory entry is fsynced after, so the rename
        itself survives. A crash at any point leaves either the old log or
        the complete new one — never a mix (the stale tmp is swept at the
        next open)."""
        tmp_path = self._path + ".compact"
        with self._lock:
            with open(tmp_path, "wb") as tmp:
                for k, v in self._index.items():
                    payload = bytes(bytearray([1])
                                    + struct.pack("<II", len(k), len(v))
                                    + k + v)
                    self._write_record(tmp, payload)
                if self._fsync != "never":
                    os.fsync(tmp.fileno())
            self._log.close()
            os.replace(tmp_path, self._path)
            if self._fsync != "never":
                _fsync_dir(self._path)
            self._log = open(self._path, "ab")
            self._unsynced = 0

    def __len__(self):
        with self._lock:
            return len(self._index)

    def flush(self) -> None:
        """Durability barrier: everything written so far is on disk when
        this returns (called at persist points and shutdown)."""
        with self._lock:
            if self._log is not None:
                self._log.flush()
                if self._fsync != "never":
                    os.fsync(self._log.fileno())
                self._unsynced = 0

    def close(self) -> None:
        with self._lock:
            if self._log is not None:
                self._log.flush()
                if self._fsync != "never":
                    os.fsync(self._log.fileno())
                self._log.close()
                self._log = None


class NativeKVStore(KeyValueStore):
    """Production store on the C++ backend (pure-Python fallback when the
    native library cannot be built/loaded — see module docstring)."""

    def __new__(cls, path: str | os.PathLike, fsync: str | None = None):
        if cls is NativeKVStore:
            try:
                _load()
            except Exception as e:  # noqa: BLE001 — any load failure degrades
                _native_unavailable(e)
                return PurePythonKVStore(path, fsync=fsync)
        return super().__new__(cls)

    def __init__(self, path: str | os.PathLike, fsync: str | None = None):
        lib = _load()
        os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
        self._lib = lib
        self._fsync = _resolve_fsync(fsync)
        self._h = lib.kvs_open(os.fspath(path).encode())
        if not self._h:
            raise OSError(f"cannot open native kv store at {path}")
        if lib._has_fsync:
            lib.kvs_set_fsync(
                self._h, {"never": 0, "batch": 1, "always": 2}[self._fsync]
            )

    def get(self, column: Column, key: bytes) -> bytes | None:
        k = _ckey(column, key)
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint32()
        rc = self._lib.kvs_get(self._h, k, len(k), ctypes.byref(out), ctypes.byref(out_len))
        if rc == -1:
            return None
        if rc != 0:
            raise OSError(f"kvs_get failed: {rc}")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.kvs_free(out)

    def do_atomically(self, ops: list[KeyValueOp]) -> None:
        payload = bytearray()
        for op in ops:
            k = _ckey(op.column, op.key)
            v = op.value or b""
            payload.append(OP_PUT if op.kind == "put" else OP_DEL)
            payload += len(k).to_bytes(4, "little")
            payload += (len(v) if op.kind == "put" else 0).to_bytes(4, "little")
            payload += k
            if op.kind == "put":
                payload += v
        rc = self._lib.kvs_batch(self._h, bytes(payload), len(payload))
        if rc != 0:
            raise OSError(f"kvs_batch failed: {rc}")

    def iter_column(self, column: Column):
        results: list[tuple[bytes, bytes]] = []
        prefix = column.value.encode() + b":"

        @self._lib._ITER_CB
        def cb(_ctx, kptr, klen, vptr, vlen):
            k = ctypes.string_at(kptr, klen)
            v = ctypes.string_at(vptr, vlen)
            results.append((k[len(prefix):], v))

        self._lib.kvs_iter_prefix(self._h, prefix, len(prefix), cb, None)
        return iter(results)

    def compact(self) -> None:
        rc = self._lib.kvs_compact(self._h)
        if rc != 0:
            raise OSError(f"kvs_compact failed: {rc}")

    def flush(self) -> None:
        if self._h and self._lib._has_fsync:
            rc = self._lib.kvs_flush(self._h)
            if rc != 0:
                raise OSError(f"kvs_flush failed: {rc}")

    def __len__(self):
        return self._lib.kvs_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.kvs_close(self._h)
            self._h = None
