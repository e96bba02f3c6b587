"""TCP transport: framed, multiplexed peer connections.

The real-socket layer under Req/Resp and gossipsub. The reference runs
libp2p (tcp + noise + mplex/yamux); here the host-side transport is a
deliberately small equivalent: length-prefixed frames over TCP, one
connection per peer pair, with RPC streams multiplexed by id and gossip
pushed as fire-and-forget frames
(lighthouse/beacon_node/lighthouse_network/src/service/mod.rs is the
structural model; mplex stays out, encryption is the EHELLO/ENC layer below).

Frame format (big-endian): [u8 type][u32 length][payload]
  HELLO      0: [u16 id_len][peer_id][u16 listen_port] (plaintext peer)
  REQ        1: [u64 stream][u16 proto_len][protocol][request bytes]
  RESP_CHUNK 2: [u64 stream][chunk bytes]
  RESP_END   3: [u64 stream]
  GOSSIP     4: gossipsub RPC (see gossipsub.encode_rpc)
  CLOSE      5: goodbye
  EHELLO     6: HELLO payload plus a 32-byte X25519 ephemeral pubkey; when
                BOTH sides send EHELLO every later frame travels inside ENC
  ENC        7: AES-256-GCM(nonce = dir counter, inner frame bytes)
  CREQ       8: REQ with a leading wire trace context —
                [u16 ctx_len][WireTraceContext][REQ payload] — so Req/Resp
                requests carry the caller's origin context; the serving
                side adopts it (observability/propagation.py) and its
                spans join the caller's causal chain. NOTE: this transport
                has no version negotiation (HELLO carries no version), so
                a new frame type assumes same-binary peers — the property
                every prior frame addition (EHELLO/ENC) relied on; a host
                that must serve pre-CREQ peers can clear
                `Connection.ctx_provider` to fall back to plain REQ

Encryption (the libp2p-noise role in the reference's tcp+noise stack):
each side sends an ephemeral X25519 key in EHELLO; the shared secret
expands through HKDF-SHA256 into two directional AES-GCM keys with counter
nonces, so all post-handshake traffic - gossip, Req/Resp, goodbye - is
encrypted and integrity-protected. Ephemeral-only DH gives
confidentiality against passive observers but NO peer authentication (no
node identity keys yet); an active MITM is documented out of scope. A peer
that sends plain HELLO gets plaintext service (interop fallback) unless
the host requires encryption.

Threading model: a reader thread per connection; outbound requests block on
a per-stream queue (the synchronous `handle()` surface SyncManager already
consumes); gossip frames dispatch into the node's gossipsub router.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time

from ..utils.logging import get_logger

log = get_logger("transport")

HELLO, REQ, RESP_CHUNK, RESP_END, GOSSIP, CLOSE, EHELLO, ENC, CREQ = range(9)

_CRYPTO_AVAILABLE: bool | None = None


def crypto_available() -> bool:
    """Whether the `cryptography` package (X25519 + AES-GCM) is importable.
    Environments without it fall back to plaintext HELLO service — the
    interop path the protocol already defines — with one structured warn;
    `require_encryption` hosts still refuse plaintext peers, so the
    fallback can never silently weaken a host that demanded encryption."""
    global _CRYPTO_AVAILABLE
    if _CRYPTO_AVAILABLE is None:
        try:
            from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: F401
                AESGCM,
            )

            _CRYPTO_AVAILABLE = True
        except ImportError:
            _CRYPTO_AVAILABLE = False
            log.warn("cryptography package unavailable; p2p transport "
                     "falls back to plaintext HELLO (no link encryption)")
    return _CRYPTO_AVAILABLE

MAX_FRAME = 16 * 1024 * 1024
# ENC wraps an inner frame in 1 type byte + 16-byte GCM tag: the receiver
# allows that overhead so a MAX_FRAME payload is sendable on both transport
# modes
MAX_WIRE_FRAME = MAX_FRAME + 64


class TransportError(Exception):
    pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise TransportError("connection closed")
        buf += got
    return buf


def read_frame(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _recv_exact(sock, 5)
    ftype, ln = hdr[0], struct.unpack(">I", hdr[1:])[0]
    if ln > MAX_WIRE_FRAME:
        raise TransportError("frame too large")
    return ftype, _recv_exact(sock, ln)


def write_frame(sock: socket.socket, ftype: int, payload: bytes) -> None:
    sock.sendall(bytes([ftype]) + struct.pack(">I", len(payload)) + payload)


class Connection:
    """One live peer connection (either direction)."""

    def __init__(self, sock: socket.socket, local_id: str, node,
                 encrypt: bool = True, dialer: bool = False,
                 rpc_timeout: float = 10.0):
        self.sock = sock
        self.node = node
        self.local_id = local_id
        # default Req/Resp round-trip budget; request(timeout=...) overrides
        # per call (SyncManager derives batch deadlines from batch size)
        self.rpc_timeout = rpc_timeout
        self.peer_id: str | None = None
        # the peer's DIALABLE address: its socket IP + the listen port it
        # advertises in HELLO (the ephemeral source port is useless for
        # dialing back) — feeds gossipsub PX peer exchange
        self.peer_dial_addr: tuple[str, int] | None = None
        # optional () -> WireTraceContext|None: when set (TcpHost wires the
        # owning node's request_ctx), outbound requests ride CREQ frames
        # carrying the caller's origin context
        self.ctx_provider = None
        self._send_lock = threading.Lock()
        self._streams: dict[int, queue.Queue] = {}
        self._next_stream = 1
        self._stream_lock = threading.Lock()
        # Gossip frames dispatch on a dedicated per-connection thread (in
        # arrival order), NOT inline on the reader: a gossip handler that
        # performs a blocking Req/Resp round trip on this same connection
        # (parent lookup for an unknown-parent block — the standard path
        # out of a healed partition) would otherwise deadlock waiting for
        # a response only the occupied reader thread could deliver.
        self._gossip_q: queue.Queue = queue.Queue()
        self._gossip_thread: threading.Thread | None = None
        # frame counters: wire-level quiescence detection (a lock-step
        # harness can assert sent==received across a pair before advancing
        # its logical clock)
        self.sent_frames = 0
        self.recv_frames = 0
        self.alive = True
        # encryption state (see module docstring): keys exist only after
        # both EHELLOs; the dialer role fixes key directionality
        self.encrypt = encrypt
        self.dialer = dialer
        self._eph_priv = None
        self._tx = None            # (AESGCM, counter) for sending
        self._rx = None            # (AESGCM, counter) for receiving

    # --------------------------------------------------------- encryption

    def _derive_keys(self, peer_pub_bytes: bytes) -> None:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PublicKey,
        )
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        from cryptography.hazmat.primitives.kdf.hkdf import HKDF

        shared = self._eph_priv.exchange(X25519PublicKey.from_public_bytes(peer_pub_bytes))
        okm = HKDF(
            algorithm=hashes.SHA256(), length=64, salt=None,
            info=b"lighthouse-tpu/p2p/1",
        ).derive(shared)
        k_dial, k_listen = AESGCM(okm[:32]), AESGCM(okm[32:])
        if self.dialer:
            self._tx, self._rx = [k_dial, 0], [k_listen, 0]
        else:
            self._tx, self._rx = [k_listen, 0], [k_dial, 0]

    @staticmethod
    def _nonce(counter: int) -> bytes:
        return counter.to_bytes(12, "big")

    # ------------------------------------------------------------- sending

    def _send(self, ftype: int, payload: bytes) -> None:
        with self._send_lock:
            if self._tx is not None:
                key, ctr = self._tx
                self._tx[1] = ctr + 1
                inner = bytes([ftype]) + payload
                write_frame(self.sock, ENC, key.encrypt(self._nonce(ctr), inner, b""))
            else:
                write_frame(self.sock, ftype, payload)
            self.sent_frames += 1

    def _hello_payload(self) -> bytes:
        ident = self.local_id.encode()
        listen_port = 0
        host = getattr(self.node, "host", None)
        if host is not None:
            try:
                listen_port = host.listen_addr[1]
            except Exception:
                listen_port = 0
        return struct.pack(">H", len(ident)) + ident + struct.pack(">H", listen_port)

    def send_hello(self) -> None:
        if self.encrypt and not crypto_available():
            self.encrypt = False
        if self.encrypt:
            from cryptography.hazmat.primitives.asymmetric.x25519 import (
                X25519PrivateKey,
            )
            from cryptography.hazmat.primitives.serialization import (
                Encoding, PublicFormat,
            )

            self._eph_priv = X25519PrivateKey.generate()
            pub = self._eph_priv.public_key().public_bytes(
                Encoding.Raw, PublicFormat.Raw
            )
            self._send(EHELLO, self._hello_payload() + pub)
        else:
            self._send(HELLO, self._hello_payload())

    def send_gossip(self, rpc_bytes: bytes) -> None:
        try:
            self._send(GOSSIP, rpc_bytes)
        except OSError:
            self.close()

    def request(self, protocol: str, request_bytes: bytes,
                timeout: float | None = None) -> list[bytes]:
        """Blocking Req/Resp round trip; returns response chunks. `timeout`
        None means the connection's configured `rpc_timeout` (plumbed from
        `bn --rpc-timeout` / LIGHTHOUSE_TPU_RPC_TIMEOUT)."""
        if timeout is None:
            timeout = self.rpc_timeout
        with self._stream_lock:
            sid = self._next_stream
            self._next_stream += 1
            q: queue.Queue = queue.Queue()
            self._streams[sid] = q
        proto = protocol.encode()
        req_payload = struct.pack(">QH", sid, len(proto)) + proto + request_bytes
        ctx = self.ctx_provider() if self.ctx_provider is not None else None
        if ctx is not None:
            from ..observability.propagation import NET_CTX, encode_ctx

            cbytes = encode_ctx(ctx)
            NET_CTX.labels("req_sent").inc()
            self._send(CREQ, struct.pack(">H", len(cbytes)) + cbytes
                       + req_payload)
        else:
            self._send(REQ, req_payload)
        chunks = []
        deadline = time.monotonic() + timeout
        try:
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TransportError("request timeout")
                try:
                    item = q.get(timeout=remain)
                except queue.Empty:
                    raise TransportError("request timeout") from None
                if item is None:
                    return chunks
                chunks.append(item)
        finally:
            with self._stream_lock:
                self._streams.pop(sid, None)

    # ------------------------------------------------------------- receiving

    def run_reader(self) -> None:
        """Reader loop (own thread): dispatch frames until close."""
        try:
            while self.alive:
                ftype, payload = read_frame(self.sock)
                self.recv_frames += 1
                if ftype == ENC:
                    if self._rx is None:
                        raise TransportError("ENC frame before handshake")
                    key, ctr = self._rx
                    self._rx[1] = ctr + 1
                    try:
                        inner = key.decrypt(self._nonce(ctr), payload, b"")
                    except Exception as e:
                        raise TransportError(f"decryption failed: {e}") from e
                    if not inner:
                        raise TransportError("empty ENC frame")
                    ftype, payload = inner[0], inner[1:]
                if ftype in (HELLO, EHELLO):
                    # [u16 id_len][peer_id][u16 listen_port] (+ EHELLO:
                    # [32B X25519 pubkey])
                    try:
                        id_len = struct.unpack(">H", payload[:2])[0]
                        pid = payload[2 : 2 + id_len].decode()
                        port = struct.unpack(
                            ">H", payload[2 + id_len : 4 + id_len]
                        )[0]
                        if ftype == EHELLO:
                            pub = payload[4 + id_len : 36 + id_len]
                            if len(pub) != 32:
                                raise TransportError("bad EHELLO pubkey")
                            if self._eph_priv is not None:
                                # derive BEFORE exposing peer_id: dial()
                                # unblocks on peer_id, and its caller's
                                # first frame must already encrypt
                                self._derive_keys(pub)
                            # plaintext-configured host: serve the peer in
                            # plaintext (it accepts both until our HELLO)
                    except TransportError:
                        raise
                    except (struct.error, UnicodeDecodeError, ValueError) as e:
                        # malformed handshake (incl. low-order X25519
                        # points rejected by the key exchange): close via
                        # the reader's clean error path, not an unhandled
                        # thread traceback
                        raise TransportError(f"malformed HELLO: {e}") from e
                    if ftype == HELLO and self.encrypt and getattr(
                        self.node, "require_encryption", False
                    ):
                        raise TransportError("peer refused encryption")
                    if ftype == HELLO:
                        # peer is plaintext: drop our pending key material
                        self._eph_priv = None
                        self._tx = self._rx = None
                    if port:
                        try:
                            ip = self.sock.getpeername()[0]
                            self.peer_dial_addr = (ip, port)
                        except OSError:
                            pass
                    self.peer_id = pid
                    self.node._register_connection(self)
                elif ftype in (REQ, CREQ):
                    try:
                        ctx_bytes = None
                        if ftype == CREQ:
                            clen = struct.unpack(">H", payload[:2])[0]
                            ctx_bytes = payload[2 : 2 + clen]
                            payload = payload[2 + clen :]
                        sid, plen = struct.unpack(">QH", payload[:10])
                        protocol = payload[10 : 10 + plen].decode()
                    except (struct.error, UnicodeDecodeError) as e:
                        # malformed request frame: close via the reader's
                        # clean error path, not an unhandled thread
                        # traceback (the HELLO branch's discipline)
                        raise TransportError(
                            f"malformed request frame: {e}"
                        ) from e
                    req = payload[10 + plen :]
                    threading.Thread(
                        target=self._serve, args=(sid, protocol, req,
                                                  ctx_bytes), daemon=True
                    ).start()
                elif ftype == RESP_CHUNK:
                    sid = struct.unpack(">Q", payload[:8])[0]
                    q = self._streams.get(sid)
                    if q is not None:
                        q.put(payload[8:])
                elif ftype == RESP_END:
                    sid = struct.unpack(">Q", payload[:8])[0]
                    q = self._streams.get(sid)
                    if q is not None:
                        q.put(None)
                elif ftype == GOSSIP:
                    self._dispatch_gossip(payload)
                elif ftype == CLOSE:
                    break
        except (TransportError, OSError):
            pass
        finally:
            self.close()

    def _dispatch_gossip(self, payload: bytes) -> None:
        """Queue a gossip frame for the serial dispatcher (started lazily;
        only the reader thread calls this, so creation cannot race)."""
        if self._gossip_thread is None:
            self._gossip_thread = threading.Thread(
                target=self._gossip_loop, name="gossip-dispatch", daemon=True
            )
            self._gossip_thread.start()
        self._gossip_q.put(payload)

    def _gossip_loop(self) -> None:
        while True:
            payload = self._gossip_q.get()
            if payload is None:
                return
            try:
                self.node._on_gossip(self.peer_id, payload)
            except Exception as e:  # noqa: BLE001 — one bad frame must not
                log.warn("gossip dispatch failed",    # kill the dispatcher
                         peer=str(self.peer_id),
                         error=f"{type(e).__name__}: {e}")
            finally:
                self._gossip_q.task_done()

    def gossip_idle(self) -> bool:
        """No gossip frame queued or mid-handler on this connection
        (unfinished_tasks covers the queued-to-done window atomically)."""
        return self._gossip_q.unfinished_tasks == 0

    def _serve(self, sid: int, protocol: str, req: bytes,
               ctx_bytes: bytes | None = None) -> None:
        tr = tracer = None
        if ctx_bytes is not None:
            # adopt the caller's wire context: the serve itself becomes a
            # traced span under the caller's causal id (the remote half of
            # a parent-lookup chain in the merged timeline), and the
            # thread-local is bound so any deeper Trace the handler opens
            # can join too
            from ..observability.propagation import (
                NET_CTX,
                decode_ctx,
                set_current_wire_ctx,
            )

            ctx = decode_ctx(ctx_bytes)
            if ctx is not None:
                set_current_wire_ctx(ctx)
                NET_CTX.labels("req_adopted").inc()
                tracer = getattr(self.node, "tracer", None)
                if tracer is not None:
                    tr = tracer.begin("rpc_serve")
                    tr.adopt(ctx)
        t0 = time.perf_counter()
        try:
            chunks = self.node._serve_rpc(self.peer_id, protocol, req)
        except Exception:
            chunks = []
        finally:
            if tr is not None:
                tr.add_span("serve", t0, time.perf_counter(),
                            protocol=protocol)
                tracer.finish(tr)
        try:
            for c in chunks:
                self._send(RESP_CHUNK, struct.pack(">Q", sid) + c)
            self._send(RESP_END, struct.pack(">Q", sid))
        except OSError:
            self.close()

    def close(self) -> None:
        if not self.alive:
            return
        self.alive = False
        try:
            # shutdown BEFORE close: close() alone does not interrupt a
            # reader blocked in recv() on this same socket (the fd close
            # defers and no FIN reaches the peer) — shutdown forces the
            # FIN out and wakes both ends' readers immediately
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        # unblock pending requests
        with self._stream_lock:
            for q in self._streams.values():
                q.put(None)
        self._gossip_q.put(None)       # stop the gossip dispatcher
        self.node._unregister_connection(self)


class RemotePeer:
    """Synchronous Req/Resp proxy over a Connection — duck-types the
    `handle(peer_id, protocol, request_bytes)` surface SyncManager and the
    in-process rigs already consume."""

    def __init__(self, conn: Connection):
        self.conn = conn

    def handle(self, _peer_id: str, protocol, request_bytes: bytes,
               timeout: float | None = None) -> list[bytes]:
        proto = protocol.value if hasattr(protocol, "value") else str(protocol)
        return self.conn.request(proto, request_bytes, timeout=timeout)


class TcpHost:
    """Listens for inbound connections and dials outbound ones.

    The owning `node` must expose:
      _serve_rpc(peer_id, protocol_str, request_bytes) -> list[chunks]
      _on_gossip(peer_id, rpc_bytes)
      _register_connection(conn) / _unregister_connection(conn)
    """

    def __init__(self, node, local_id: str, host: str = "127.0.0.1", port: int = 0,
                 encrypt: bool = True, rpc_timeout: float = 10.0):
        self.node = node
        self.local_id = local_id
        self.encrypt = encrypt
        self.rpc_timeout = rpc_timeout
        self.server = socket.create_server((host, port))
        self.host, self.port = self.server.getsockname()
        self.connections: dict[str, Connection] = {}
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.running = True
        self._accept_thread.start()

    @property
    def listen_addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        while self.running:
            try:
                sock, _addr = self.server.accept()
            except OSError:
                return
            try:
                self._spawn(sock)
            except OSError:
                # a peer that connected and instantly reset (scanner,
                # health probe) must not kill the accept thread
                continue

    def _spawn(self, sock: socket.socket, dialer: bool = False) -> Connection:
        conn = Connection(sock, self.local_id, self.node,
                          encrypt=self.encrypt, dialer=dialer,
                          rpc_timeout=self.rpc_timeout)
        # Req/Resp requests carry the node's origin context when it
        # provides one (NetworkNode.request_ctx)
        conn.ctx_provider = getattr(self.node, "request_ctx", None)
        # HELLO must hit the wire BEFORE the reader starts: processing the
        # remote HELLO triggers registration, whose subscription announce
        # would otherwise overtake our own HELLO — the remote then drops
        # the announce frame (peer unidentified) and never learns our
        # topics, silently partitioning gossip.
        conn.send_hello()
        threading.Thread(target=conn.run_reader, daemon=True).start()
        return conn

    def dial(self, host: str, port: int, timeout: float = 5.0) -> Connection:
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        conn = self._spawn(sock, dialer=True)
        # wait until HELLO exchanged and registered
        deadline = time.monotonic() + timeout
        while conn.peer_id is None:
            if time.monotonic() > deadline:
                raise TransportError("hello timeout")
            time.sleep(0.005)
        return conn

    def close(self) -> None:
        self.running = False
        try:
            self.server.close()
        except OSError:
            pass
        for conn in list(self.connections.values()):
            conn.close()
