"""UDP peer discovery + standalone boot node (discv5 analog).

Parity surface: lighthouse/beacon_node/lighthouse_network/src/discovery/
and lighthouse/boot_node/ — node records (ENR analog: node id,
ip/tcp-port for the transport, fork digest, attnet bitfield), a UDP
request/response protocol (PING/PONG, FINDNODE/NODES), a routing table of
seen records, and subnet-predicate queries (discovery/subnet_predicate.rs)
so the node can find peers subscribed to a target attestation subnet.
Wire-compatibility with discv5 is a non-goal (that protocol's identity
crypto is tied to secp256k1 keys we don't carry); the behavior — bootstrap
from known boot nodes, iterative peer lookup, subnet filtering — is kept.

Wire format: JSON datagrams {t: "ping"|"pong"|"findnode"|"nodes", ...}
with records as {id, ip, tcp_port, fork_digest, attnets}."""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class NodeRecord:
    """ENR analog."""

    id: str
    ip: str
    tcp_port: int
    udp_port: int
    fork_digest: str = "00000000"
    attnets: int = 0          # bitfield of subscribed attestation subnets

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "NodeRecord":
        return cls(
            id=str(d["id"]), ip=str(d["ip"]), tcp_port=int(d["tcp_port"]),
            udp_port=int(d["udp_port"]), fork_digest=str(d.get("fork_digest", "00000000")),
            attnets=int(d.get("attnets", 0)),
        )

    def subscribes(self, subnet_id: int) -> bool:
        return bool(self.attnets >> subnet_id & 1)


class DiscoveryService:
    """One node's discovery endpoint: answers queries, maintains a table."""

    MAX_NODES_PER_RESPONSE = 16

    def __init__(self, record: NodeRecord | None = None, host: str = "127.0.0.1",
                 port: int = 0, boot_nodes: list[NodeRecord] = ()):  # type: ignore[assignment]
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.udp_port = self.sock.getsockname()[1]
        self.record = record or NodeRecord(
            id=f"node-{random.getrandbits(64):016x}", ip=host,
            tcp_port=0, udp_port=self.udp_port,
        )
        if self.record.udp_port != self.udp_port:
            self.record = NodeRecord(**{**self.record.to_json(), "udp_port": self.udp_port})
        self.table: dict[str, NodeRecord] = {}
        self.last_seen: dict[str, float] = {}
        self.boot_nodes = list(boot_nodes)
        self.running = True
        self._pending: dict[int, list] = {}
        self._pending_lock = threading.Lock()
        self._req_id = random.getrandbits(31)
        # client state must exist before the serve thread can race on it
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ server

    def _serve(self) -> None:
        while self.running:
            try:
                data, addr = self.sock.recvfrom(64 * 1024)
            except OSError:
                return
            try:
                msg = json.loads(data.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            t = msg.get("t")
            if t == "ping":
                self._learn(msg.get("from"))
                self._send(addr, {"t": "pong", "from": self.record.to_json(),
                                  "rid": msg.get("rid")})
            elif t == "findnode":
                self._learn(msg.get("from"))
                subnet = msg.get("subnet")
                records = [
                    r.to_json()
                    for r in self.table.values()
                    if r.id != msg.get("from", {}).get("id")
                    and (subnet is None or r.subscribes(int(subnet)))
                ][: self.MAX_NODES_PER_RESPONSE]
                self._send(addr, {"t": "nodes", "records": records,
                                  "from": self.record.to_json(), "rid": msg.get("rid")})
            elif t in ("pong", "nodes"):
                self._learn(msg.get("from"))
                if t == "nodes":
                    for rec in msg.get("records", []):
                        self._learn(rec)
                with self._pending_lock:
                    waiter = self._pending.pop(msg.get("rid"), None)
                if waiter is not None:
                    waiter.append(msg)
                    waiter[0].set()  # type: ignore[attr-defined]

    def _learn(self, rec_json) -> None:
        if not rec_json:
            return
        try:
            rec = NodeRecord.from_json(rec_json)
        except (KeyError, ValueError, TypeError):
            return
        if rec.id == self.record.id:
            return
        self.table[rec.id] = rec
        self.last_seen[rec.id] = time.monotonic()

    def _send(self, addr, payload: dict) -> None:
        try:
            self.sock.sendto(json.dumps(payload).encode(), addr)
        except OSError:
            pass

    # ------------------------------------------------------------ client

    def _request(self, rec: NodeRecord, payload: dict, timeout: float = 2.0):
        ev = threading.Event()
        waiter = [ev]
        with self._pending_lock:
            self._req_id += 1
            rid = self._req_id
            self._pending[rid] = waiter
        payload = dict(payload, rid=rid, **{"from": self.record.to_json()})
        self._send((rec.ip, rec.udp_port), payload)
        if not ev.wait(timeout):
            with self._pending_lock:
                self._pending.pop(rid, None)
            return None
        return waiter[1]

    def ping(self, rec: NodeRecord) -> bool:
        return self._request(rec, {"t": "ping"}) is not None

    def find_nodes(self, rec: NodeRecord, subnet: int | None = None) -> list[NodeRecord]:
        resp = self._request(rec, {"t": "findnode", "subnet": subnet})
        if resp is None:
            return []
        return [NodeRecord.from_json(r) for r in resp.get("records", [])]

    def bootstrap(self, rounds: int = 3) -> int:
        """Iterative lookup from the boot nodes: query everyone we know
        until the table stops growing (discovery's recursive FINDNODE)."""
        for b in self.boot_nodes:
            self._learn(b.to_json())
        for _ in range(rounds):
            before = len(self.table)
            for rec in list(self.table.values()):
                self.find_nodes(rec)
            if len(self.table) == before:
                break
        return len(self.table)

    def peers_for_subnet(self, subnet_id: int) -> list[NodeRecord]:
        return [r for r in self.table.values() if r.subscribes(subnet_id)]

    def update_attnets(self, attnets: int) -> None:
        self.record = NodeRecord(**{**self.record.to_json(), "attnets": attnets})

    def close(self) -> None:
        self.running = False
        try:
            self.sock.close()
        except OSError:
            pass


def run_boot_node(host: str = "127.0.0.1", port: int = 0) -> DiscoveryService:
    """Standalone bootstrap node: a discovery service that only relays
    records (boot_node/src analog)."""
    return DiscoveryService(host=host, port=port)
