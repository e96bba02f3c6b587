"""Gossipsub v1.1 peer scoring: topic-parameterized score function.

Parity surface: the vendored fork's peer-score machinery
(lighthouse/beacon_node/lighthouse_network/gossipsub/src/peer_score/
 {mod.rs,params.rs}) and Lighthouse's beacon-chain parameterization
(lighthouse/beacon_node/lighthouse_network/src/service/
 gossipsub_scoring_parameters.rs). The score has the reference's shape:

  score(p) = sum_t w_t * ( P1 time-in-mesh + P2 first-deliveries
                         + P3 mesh-delivery-deficit^2 + P3b mesh-failure
                         + P4 invalid-messages^2 )
           + P5 app-specific + P7 behaviour-penalty^2

P3 is the load-bearing term the VERDICT called out: a mesh member that
fails to forward its share of messages accrues a quadratic deficit penalty
and gets pruned/graylisted even though it never sent an invalid byte.
Counters decay geometrically on a fixed refresh cadence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class TopicScoreParams:
    """Per-topic weights (peer_score/params.rs TopicScoreParams)."""

    topic_weight: float = 1.0

    # P1: time in mesh
    time_in_mesh_weight: float = 0.033
    time_in_mesh_quantum: float = 1.0      # seconds per point
    time_in_mesh_cap: float = 300.0

    # P2: first message deliveries
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_decay: float = 0.5
    first_message_deliveries_cap: float = 100.0

    # P3: mesh message delivery deficit (negative weight, squared)
    mesh_message_deliveries_weight: float = -1.0
    mesh_message_deliveries_decay: float = 0.5
    mesh_message_deliveries_threshold: float = 4.0
    mesh_message_deliveries_cap: float = 100.0
    # grace period after GRAFT before the deficit penalty activates
    mesh_message_deliveries_activation: float = 2.0

    # P3b: sticky failure penalty applied when pruned while in deficit
    mesh_failure_penalty_weight: float = -1.0
    mesh_failure_penalty_decay: float = 0.5

    # P4: invalid messages (negative weight, squared)
    invalid_message_deliveries_weight: float = -10.0
    invalid_message_deliveries_decay: float = 0.9


@dataclass
class PeerScoreThresholds:
    """Action thresholds (peer_score/params.rs PeerScoreThresholds; values
    follow lighthouse_network/src/service/mod.rs defaults in spirit)."""

    gossip_threshold: float = -40.0       # below: no IHAVE/IWANT exchange
    publish_threshold: float = -80.0      # below: don't flood-publish to it
    graylist_threshold: float = -160.0    # below: drop its RPCs entirely
    # median mesh score below this triggers opportunistic grafting of
    # better-scored peers (behaviour.rs opportunistic_graft_threshold)
    opportunistic_graft_threshold: float = 2.0


#: scoring identity for unparameterized topics: counters still accrue
#: (delivery bookkeeping is shared), but every weight is zero
_NEUTRAL_TOPIC = TopicScoreParams(
    topic_weight=0.0,
    time_in_mesh_weight=0.0,
    first_message_deliveries_weight=0.0,
    mesh_message_deliveries_weight=0.0,
    mesh_failure_penalty_weight=0.0,
    invalid_message_deliveries_weight=0.0,
)


@dataclass
class PeerScoreParams:
    topics: dict[str, TopicScoreParams] = field(default_factory=dict)
    #: whether topics ABSENT from `topics` get the (punishing) default
    #: TopicScoreParams (True — handy for small ad-hoc rigs) or score
    #: neutral (False — libp2p semantics; what beacon_score_params uses,
    #: see topic())
    score_unknown_topics: bool = True
    # cap on the TOTAL positive contribution across topics
    topic_score_cap: float = 400.0
    app_specific_weight: float = 1.0
    # P7: behaviour penalty (graft floods, broken promises)
    behaviour_penalty_weight: float = -5.0
    behaviour_penalty_decay: float = 0.9
    behaviour_penalty_threshold: float = 2.0
    decay_interval: float = 1.0            # seconds between refreshes
    decay_to_zero: float = 0.01            # counters below this snap to 0
    retain_score: float = 10.0             # seconds to keep disconnected peers

    def topic(self, t: str) -> TopicScoreParams:
        """Params for a topic. With `score_unknown_topics=False` (the
        beacon parameterization), topics nobody configured score NEUTRAL
        (every weight 0) — libp2p gossipsub semantics: only explicitly
        parameterized topics contribute. Scoring unknown topics by the
        punishing default meant an idle subscribed topic — blob-sidecar
        subnets in a blobless sim, any quiet subnet on a real node —
        accrued a P3 deficit of threshold^2 per mesh peer once the
        activation grace passed, dragging EVERY peer toward the
        publish/graylist thresholds until the whole mesh wedged (found
        by the fleet harness's steady soak)."""
        got = self.topics.get(t)
        if got is None:
            if not self.score_unknown_topics:
                return _NEUTRAL_TOPIC
            got = TopicScoreParams()
            self.topics[t] = got
        return got


def beacon_score_params(block_topic: str | None = None,
                        aggregate_topic: str | None = None,
                        subnet_topics: list[str] | None = None) -> PeerScoreParams:
    """Beacon-chain parameterization in the spirit of
    gossipsub_scoring_parameters.rs: blocks weigh most, aggregates next,
    per-subnet attestation topics least (there are 64 of them)."""
    # only the topics parameterized below contribute to scores: an idle
    # unconfigured topic (blob subnets with no blobs yet) must not accrue
    # mesh-delivery deficits against honest peers
    params = PeerScoreParams(score_unknown_topics=False)
    if block_topic:
        params.topics[block_topic] = TopicScoreParams(
            topic_weight=0.5,
            mesh_message_deliveries_threshold=2.0,
            first_message_deliveries_cap=20.0,
        )
    if aggregate_topic:
        params.topics[aggregate_topic] = TopicScoreParams(
            topic_weight=0.5,
            mesh_message_deliveries_threshold=4.0,
        )
    for t in subnet_topics or ():
        params.topics[t] = TopicScoreParams(
            topic_weight=0.015625,  # 1/64: one subnet can't dominate
            mesh_message_deliveries_threshold=2.0,
            invalid_message_deliveries_weight=-100.0,
        )
    return params


@dataclass
class _TopicStats:
    in_mesh: bool = False
    graft_time: float = 0.0
    time_in_mesh: float = 0.0
    first_message_deliveries: float = 0.0
    mesh_message_deliveries: float = 0.0
    mesh_failure_penalty: float = 0.0
    invalid_message_deliveries: float = 0.0


@dataclass
class _PeerStats:
    topics: dict[str, _TopicStats] = field(default_factory=dict)
    behaviour_penalty: float = 0.0
    app_specific: float = 0.0
    connected: bool = True
    disconnect_time: float = 0.0

    def topic(self, t: str) -> _TopicStats:
        got = self.topics.get(t)
        if got is None:
            got = _TopicStats()
            self.topics[t] = got
        return got


class PeerScore:
    """Tracks per-peer stats and computes the v1.1 score function."""

    def __init__(self, params: PeerScoreParams | None = None, now=time.monotonic):
        self.params = params or PeerScoreParams()
        self.now = now
        self.peers: dict[str, _PeerStats] = {}

    # ------------------------------------------------------------- events

    def add_peer(self, peer: str) -> None:
        st = self.peers.get(peer)
        if st is None:
            self.peers[peer] = _PeerStats()
        else:
            st.connected = True

    def remove_peer(self, peer: str) -> None:
        """Peer disconnected: apply mesh-failure penalties for any mesh
        topic still in deficit, then retain the score for retain_score s."""
        st = self.peers.get(peer)
        if st is None:
            return
        now = self.now()
        for t, ts in st.topics.items():
            if ts.in_mesh:
                self._apply_failure_penalty(t, ts, now)
                ts.in_mesh = False
        st.connected = False
        st.disconnect_time = now

    def graft(self, peer: str, topic: str) -> None:
        ts = self.peers.setdefault(peer, _PeerStats()).topic(topic)
        ts.in_mesh = True
        ts.graft_time = self.now()
        ts.mesh_message_deliveries = 0.0

    def _apply_failure_penalty(self, topic: str, ts: _TopicStats, now: float) -> None:
        p = self.params.topic(topic)
        active = now - ts.graft_time >= p.mesh_message_deliveries_activation
        if active and ts.mesh_message_deliveries < p.mesh_message_deliveries_threshold:
            deficit = p.mesh_message_deliveries_threshold - ts.mesh_message_deliveries
            ts.mesh_failure_penalty += deficit * deficit

    def prune(self, peer: str, topic: str) -> None:
        st = self.peers.get(peer)
        if st is None:
            return
        ts = st.topic(topic)
        if ts.in_mesh:
            self._apply_failure_penalty(topic, ts, self.now())
        ts.in_mesh = False

    def deliver_message(self, peer: str, topic: str) -> None:
        """First delivery of a message by this peer."""
        st = self.peers.get(peer)
        if st is None:
            return
        p = self.params.topic(topic)
        ts = st.topic(topic)
        ts.first_message_deliveries = min(
            p.first_message_deliveries_cap, ts.first_message_deliveries + 1
        )
        self._count_mesh_delivery(p, ts)

    def duplicate_message(self, peer: str, topic: str) -> None:
        """A duplicate from a mesh member still proves it forwards traffic."""
        st = self.peers.get(peer)
        if st is None:
            return
        self._count_mesh_delivery(self.params.topic(topic), st.topic(topic))

    def _count_mesh_delivery(self, p: TopicScoreParams, ts: _TopicStats) -> None:
        if ts.in_mesh:
            ts.mesh_message_deliveries = min(
                p.mesh_message_deliveries_cap, ts.mesh_message_deliveries + 1
            )

    def reject_message(self, peer: str, topic: str) -> None:
        st = self.peers.get(peer)
        if st is None:
            return
        st.topic(topic).invalid_message_deliveries += 1

    def add_penalty(self, peer: str, count: int = 1) -> None:
        """P7 behaviour penalty (graft flood, broken IWANT promises)."""
        st = self.peers.get(peer)
        if st is None:
            return
        st.behaviour_penalty += count

    def set_app_score(self, peer: str, value: float) -> None:
        st = self.peers.setdefault(peer, _PeerStats())
        st.app_specific = value

    # ------------------------------------------------------------- refresh

    def refresh(self) -> None:
        """Decay counters; accrue time-in-mesh; drop expired ghosts.
        Call once per decay_interval (the gossipsub heartbeat)."""
        now = self.now()
        z = self.params.decay_to_zero
        dead = []
        for peer, st in self.peers.items():
            if not st.connected:
                if now - st.disconnect_time > self.params.retain_score:
                    dead.append(peer)
                continue
            for t, ts in st.topics.items():
                p = self.params.topic(t)
                if ts.in_mesh:
                    ts.time_in_mesh = min(
                        p.time_in_mesh_cap,
                        ts.time_in_mesh + self.params.decay_interval / p.time_in_mesh_quantum,
                    )
                ts.first_message_deliveries *= p.first_message_deliveries_decay
                if ts.first_message_deliveries < z:
                    ts.first_message_deliveries = 0.0
                ts.mesh_message_deliveries *= p.mesh_message_deliveries_decay
                if ts.mesh_message_deliveries < z:
                    ts.mesh_message_deliveries = 0.0
                ts.mesh_failure_penalty *= p.mesh_failure_penalty_decay
                if ts.mesh_failure_penalty < z:
                    ts.mesh_failure_penalty = 0.0
                ts.invalid_message_deliveries *= p.invalid_message_deliveries_decay
                if ts.invalid_message_deliveries < z:
                    ts.invalid_message_deliveries = 0.0
            st.behaviour_penalty *= self.params.behaviour_penalty_decay
            if st.behaviour_penalty < z:
                st.behaviour_penalty = 0.0
        for peer in dead:
            del self.peers[peer]

    # ------------------------------------------------------------- scoring

    def score(self, peer: str) -> float:
        st = self.peers.get(peer)
        if st is None:
            return 0.0
        now = self.now()
        topic_total = 0.0
        for t, ts in st.topics.items():
            p = self.params.topic(t)
            topic_score = 0.0
            topic_score += p.time_in_mesh_weight * ts.time_in_mesh
            topic_score += p.first_message_deliveries_weight * ts.first_message_deliveries
            if (
                ts.in_mesh
                and now - ts.graft_time >= p.mesh_message_deliveries_activation
                and ts.mesh_message_deliveries < p.mesh_message_deliveries_threshold
            ):
                deficit = p.mesh_message_deliveries_threshold - ts.mesh_message_deliveries
                topic_score += p.mesh_message_deliveries_weight * deficit * deficit
            topic_score += p.mesh_failure_penalty_weight * ts.mesh_failure_penalty
            topic_score += (
                p.invalid_message_deliveries_weight
                * ts.invalid_message_deliveries
                * ts.invalid_message_deliveries
            )
            topic_total += p.topic_weight * topic_score
        if topic_total > self.params.topic_score_cap:
            topic_total = self.params.topic_score_cap
        total = topic_total
        total += self.params.app_specific_weight * st.app_specific
        if st.behaviour_penalty > self.params.behaviour_penalty_threshold:
            excess = st.behaviour_penalty - self.params.behaviour_penalty_threshold
            total += self.params.behaviour_penalty_weight * excess * excess
        return total
