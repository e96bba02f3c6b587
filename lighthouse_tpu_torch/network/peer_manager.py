"""Peer manager: scoring, banning, peer database.

Parity surface: lighthouse/beacon_node/lighthouse_network/src/
peer_manager/ — real-valued peer scores with exponential decay, action
thresholds (Disconnect < -20, Ban < -50 in the reference's scaling),
gossipsub score blending, and the peerdb's ban/trust states.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from enum import Enum


class PeerAction(Enum):
    """peer_manager::PeerAction analog."""

    fatal = "fatal"                 # instant ban
    low_tolerance = "low"           # -10
    mid_tolerance = "mid"           # -5
    high_tolerance = "high"         # -1


ACTION_PENALTY = {
    PeerAction.fatal: -100.0,
    PeerAction.low_tolerance: -10.0,
    PeerAction.mid_tolerance: -5.0,
    PeerAction.high_tolerance: -1.0,
}

DISCONNECT_THRESHOLD = -20.0
BAN_THRESHOLD = -50.0
SCORE_HALFLIFE_SECS = 600.0
BAN_DURATION_SECS = 1800.0


class ConnectionState(Enum):
    connected = "connected"
    disconnected = "disconnected"
    banned = "banned"


@dataclass
class PeerInfo:
    peer_id: str
    score: float = 0.0
    last_update: float = field(default_factory=time.monotonic)
    state: ConnectionState = ConnectionState.disconnected
    banned_until: float = 0.0
    trusted: bool = False
    status: object = None          # last Status handshake


class PeerManager:
    def __init__(self, target_peers: int = 50, now_fn=time.monotonic):
        self.peers: dict[str, PeerInfo] = {}
        self.target_peers = target_peers
        self._now = now_fn

    def _peer(self, peer_id: str) -> PeerInfo:
        if peer_id not in self.peers:
            self.peers[peer_id] = PeerInfo(peer_id, last_update=self._now())
        return self.peers[peer_id]

    # ------------------------------------------------------------- lifecycle

    def connect(self, peer_id: str) -> bool:
        p = self._peer(peer_id)
        now = self._now()
        if p.state == ConnectionState.banned:
            if now < p.banned_until:
                return False
            p.state = ConnectionState.disconnected
            p.score = 0.0
        p.state = ConnectionState.connected
        return True

    def disconnect(self, peer_id: str) -> None:
        self._peer(peer_id).state = ConnectionState.disconnected

    def connected_peers(self) -> list[str]:
        return [p.peer_id for p in self.peers.values() if p.state == ConnectionState.connected]

    # ------------------------------------------------------------- scoring

    def _decayed_score(self, p: PeerInfo) -> float:
        dt = self._now() - p.last_update
        return p.score * math.exp(-math.log(2) * dt / SCORE_HALFLIFE_SECS)

    def report(self, peer_id: str, action: PeerAction) -> None:
        p = self._peer(peer_id)
        if p.trusted:
            return
        p.score = self._decayed_score(p) + ACTION_PENALTY[action]
        p.last_update = self._now()
        self._apply_thresholds(p)

    def reward(self, peer_id: str, amount: float = 1.0) -> None:
        p = self._peer(peer_id)
        p.score = min(10.0, self._decayed_score(p) + amount)
        p.last_update = self._now()

    def score(self, peer_id: str) -> float:
        return self._decayed_score(self._peer(peer_id))

    def _apply_thresholds(self, p: PeerInfo) -> None:
        if p.score <= BAN_THRESHOLD:
            p.state = ConnectionState.banned
            p.banned_until = self._now() + BAN_DURATION_SECS
        elif p.score <= DISCONNECT_THRESHOLD and p.state == ConnectionState.connected:
            p.state = ConnectionState.disconnected

    def is_banned(self, peer_id: str) -> bool:
        p = self._peer(peer_id)
        if p.state == ConnectionState.banned and self._now() >= p.banned_until:
            p.state = ConnectionState.disconnected
            p.score = 0.0
        return p.state == ConnectionState.banned

    # ------------------------------------------------------------- selection

    def best_peers(self, n: int | None = None) -> list[str]:
        connected = [
            p for p in self.peers.values() if p.state == ConnectionState.connected
        ]
        connected.sort(key=lambda p: self._decayed_score(p), reverse=True)
        return [p.peer_id for p in connected[: n or self.target_peers]]

    def register_status(self, peer_id: str, status) -> None:
        self._peer(peer_id).status = status
