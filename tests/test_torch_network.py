"""The port's p2p stack (network/{transport,rpc,gossipsub,peer_score,
peer_manager,sync,node}.py, observability/propagation.py) on the CPU
against the JAX package's.

- Req/Resp: chunk and response-chunk encodings, Status, BlocksByRange and
  MetaData messages on seeded inputs: byte-equal, and each package decodes
  the other's bytes;
- gossipsub: the RPC frame codec on a seeded frame, and one seeded event
  sequence (subscriptions, grafts, messages valid, invalid and duplicated,
  heartbeats, a prune) through a router of each package on a manual
  clock: the same message ids, handler calls, frames sent and peer
  scores; the peer-score function on its own over a seeded sequence;
- the TCP transport between the two packages, plaintext and encrypted
  (EHELLO, AES-GCM): a Status round trip each way and a gossip frame;
- a port NetworkNode range-syncs 20 blocks over localhost TCP from a JAX
  package NetworkNode (minimal spec, 16 validators, "fake" BLS) into its
  chain's process_chain_segment: the same head root and state root.

Tolerance: exact (bytes, roots, ids, scores). No JAX compile.
"""

import importlib
import random
import time
import types as pytypes

import pytest

from lighthouse_tpu.crypto import bls as jbls

PACKAGES = ("lighthouse_tpu", "lighthouse_tpu_torch")
MODULES = {"rpc": "network.rpc", "gsub": "network.gossipsub", "ps": "network.peer_score",
           "pm": "network.peer_manager", "transport": "network.transport",
           "gossip": "network.gossip", "snappy": "network.snappy",
           "sup": "utils.supervisor", "prop": "observability.propagation"}
VALIDATORS, BLOCKS = 16, 20


def mods(package: str):
    return pytypes.SimpleNamespace(
        **{k: importlib.import_module(f"{package}.{v}") for k, v in MODULES.items()})


def on_both(step):
    """step(m) on the JAX package, then on the port; the results must be equal."""
    want, got = (step(mods(p)) for p in PACKAGES)
    assert got == want
    return got


def wait_for(cond, what: str, timeout: float = 20.0) -> None:
    t = time.monotonic()
    while not cond():
        assert time.monotonic() - t < timeout, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_rpc_chunks_and_messages_byte_equal():
    r = random.Random(18)
    payloads = [b"", bytes(1), bytes(r.getrandbits(8) for _ in range(3))] + [
        bytes(r.getrandbits(8) for _ in range(n)) for n in (31, 64, 200, 4096)]
    payloads.append(bytes(300) + b"\x07" * 700)          # runs the codec copies

    def encodings(m):
        rpc = m.rpc
        out = []
        for p in payloads:
            chunk = rpc.encode_chunk(p)
            resp = rpc.encode_response_chunk(rpc.RESP_SUCCESS, p)
            assert rpc.decode_chunk(chunk)[0] == p
            assert rpc.decode_response_chunk(resp) == (rpc.RESP_SUCCESS, p)
            out += [chunk, resp]
        status = rpc.StatusMessage.make(
            fork_digest=bytes(r.getrandbits(8) for _ in range(4)),
            finalized_root=bytes(range(32)), finalized_epoch=r.getrandbits(64),
            head_root=bytes(range(32, 64)), head_slot=r.getrandbits(64))
        req = rpc.BlocksByRangeRequest.make(start_slot=r.getrandbits(64),
                                           count=r.getrandbits(10), step=1)
        meta = rpc.MetaData.make(seq_number=3, attnets=r.getrandbits(64), syncnets=5)
        out += [rpc.StatusMessage.serialize(status), rpc.BlocksByRangeRequest.serialize(req),
                rpc.MetaData.serialize(meta), [p.value for p in rpc.Protocol]]
        return out

    state = r.getstate()
    want = encodings(mods(PACKAGES[0]))
    r.setstate(state)
    got = encodings(mods(PACKAGES[1]))
    assert got == want
    # each package decodes the other's frames
    for a, b in (PACKAGES, PACKAGES[::-1]):
        ma, mb = mods(a), mods(b)
        for p in payloads:
            assert mb.rpc.decode_response_chunk(ma.rpc.encode_response_chunk(0, p)) == (0, p)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def gossip_sequence(m, monkeypatch) -> dict:
    """A seeded sequence through one package's Gossipsub on a manual clock:
    every frame the router sends, every handler call and the scores."""
    clock = Clock()
    monkeypatch.setattr(m.gsub, "time", pytypes.SimpleNamespace(monotonic=clock, time=clock))
    digest = b"\x01\x02\x03\x04"
    topics = [m.gossip.topic_name(digest, "beacon_block")] + [
        m.gossip.attestation_subnet_topic(digest, i) for i in range(3)]
    params = m.ps.beacon_score_params(block_topic=topics[0], subnet_topics=topics[1:])
    sent, calls = [], []
    router = m.gsub.Gossipsub("local", lambda peer, raw: sent.append((peer, raw)),
                              m.pm.PeerManager(now_fn=clock), rng=random.Random(7),
                              score_params=params)
    router.peer_score.now = clock
    r = random.Random(2026)

    def handler(topic):
        def on_message(msg):
            calls.append((topic, msg.message_id, msg.decompressed))
            verdict = msg.decompressed[0] % 3       # accept, reject, ignore
            return True if verdict == 0 else (False if verdict == 1 else None)
        return on_message

    for t in topics:
        router.subscribe(t, handler(t))
    peers = [f"peer{i}" for i in range(5)]
    for p in peers:
        router.add_peer(p)
        rpc = m.gsub.Rpc(subs=[(True, t) for t in topics if r.random() < 0.8])
        router.on_rpc(p, m.gsub.encode_rpc(rpc))
    for step in range(40):
        clock.t += r.choice((0.1, 0.5, 1.0))
        kind = r.random()
        peer = r.choice(peers)
        topic = r.choice(topics)
        if kind < 0.6:
            payload = bytes([r.getrandbits(8)]) + bytes(r.getrandbits(8) for _ in range(40))
            data = m.snappy.compress(payload)
            rpc = m.gsub.Rpc(msgs=[(topic, data)])
            router.on_rpc(peer, m.gsub.encode_rpc(rpc))
            if r.random() < 0.3:                      # a duplicate from another peer
                router.on_rpc(r.choice(peers), m.gsub.encode_rpc(rpc))
        elif kind < 0.75:
            router.on_rpc(peer, m.gsub.encode_rpc(m.gsub.Rpc(graft=[topic])))
        elif kind < 0.85:
            router.on_rpc(peer, m.gsub.encode_rpc(m.gsub.Rpc(prune=[(topic, [])])))
        else:
            router.heartbeat()
        if step == 30:
            router.publish(topics[1], b"\x00own message")
    router.peer_score.refresh()
    return {"sent": sent, "calls": calls, "delivered": router.delivered,
            "duplicates": router.duplicates, "rejected": router.rejected,
            "mesh": {t: sorted(ps) for t, ps in router.mesh.items()},
            "scores": {p: router.peer_score.score(p) for p in peers}}


def test_gossipsub_ids_frames_and_scores_equal(monkeypatch):
    frame_r = random.Random(5)

    def frame(m):
        r = random.Random(frame_r.random())
        rpc = m.gsub.Rpc(subs=[(True, "/eth2/a/b/ssz_snappy"), (False, "t2")],
                         msgs=[("t3", bytes(r.getrandbits(8) for _ in range(50)))],
                         ihave=[("t3", [bytes(20), b"\x01" * 20])], iwant=[[b"\x02" * 20]],
                         graft=["t3"], prune=[("t4", [("p", "127.0.0.1", 9000)])])
        raw = m.gsub.encode_rpc(rpc)
        return raw, m.gsub.encode_rpc(m.gsub.decode_rpc(raw))

    state = frame_r.getstate()
    want = frame(mods(PACKAGES[0]))
    frame_r.setstate(state)
    assert frame(mods(PACKAGES[1])) == want
    out = on_both(lambda m: gossip_sequence(m, monkeypatch))
    assert out["calls"] and out["sent"] and out["rejected"] and out["duplicates"]


def test_peer_score_function_equal():
    def scores(m):
        clock = Clock()
        topics = ["block", "agg", "s0", "s1"]
        ps = m.ps.PeerScore(m.ps.beacon_score_params(
            block_topic=topics[0], aggregate_topic=topics[1], subnet_topics=topics[2:]),
            now=clock)
        r = random.Random(99)
        peers = [f"p{i}" for i in range(4)]
        trace = []
        for p in peers:
            ps.add_peer(p)
        for _ in range(200):
            clock.t += r.choice((0.05, 0.5, 2.0, 12.0))
            p, t = r.choice(peers), r.choice(topics)
            op = r.randrange(8)
            if op == 0:
                ps.graft(p, t)
            elif op == 1:
                ps.prune(p, t)
            elif op in (2, 3):
                ps.deliver_message(p, t)
            elif op == 4:
                ps.duplicate_message(p, t)
            elif op == 5:
                ps.reject_message(p, t)
            elif op == 6:
                ps.add_penalty(p, r.randrange(1, 3))
            else:
                ps.refresh()
            trace.append(tuple(ps.score(q) for q in peers))
        ps.remove_peer(peers[0])
        trace.append(tuple(ps.score(q) for q in peers))
        return trace

    trace = on_both(scores)
    assert any(s < 0 for row in trace for s in row) and any(s > 0 for row in trace for s in row)


class _Endpoint:
    """The node surface a TcpHost serves: Status over Req/Resp, gossip frames
    recorded."""

    def __init__(self, m, head_slot: int):
        self.m, self.head_slot = m, head_slot
        self.gossip = []
        self.require_encryption = False
        self.host = None

    def _register_connection(self, conn):
        self.host.connections[conn.peer_id] = conn

    def _unregister_connection(self, conn):
        self.host.connections.pop(conn.peer_id, None)

    def _serve_rpc(self, peer_id, protocol, request_bytes):
        rpc = self.m.rpc
        assert rpc.decode_chunk(request_bytes)[0] == b"\x00" * 5
        status = rpc.StatusMessage.make(fork_digest=b"\x00" * 4, finalized_root=bytes(32),
                                        finalized_epoch=0, head_root=bytes(32),
                                        head_slot=self.head_slot)
        return [rpc.encode_response_chunk(rpc.RESP_SUCCESS,
                                          rpc.StatusMessage.serialize(status))]

    def _on_gossip(self, peer_id, raw):
        self.gossip.append((peer_id, raw))


@pytest.mark.parametrize("encrypt", [False, True], ids=["plaintext", "encrypted"])
def test_transport_round_trip_between_packages(encrypt):
    jm, tm = mods(PACKAGES[0]), mods(PACKAGES[1])
    assert tm.transport.crypto_available() == jm.transport.crypto_available()
    if encrypt and not tm.transport.crypto_available():
        pytest.skip("the cryptography package is not installed")
    ends = {}
    for name, m, slot in (("jax", jm, 7), ("port", tm, 9)):
        e = _Endpoint(m, slot)
        e.host = m.transport.TcpHost(e, f"{name}-host", encrypt=encrypt)
        ends[name] = e
    try:
        conn = ends["port"].host.dial(*ends["jax"].host.listen_addr)
        wait_for(lambda: "port-host" in ends["jax"].host.connections, "the accept side")
        back = ends["jax"].host.connections["port-host"]
        assert (conn._tx is not None) is encrypt and (back._tx is not None) is encrypt
        for here, there, peer, slot in ((tm, conn, "jax-host", 7), (jm, back, "port-host", 9)):
            got = there.request(here.rpc.Protocol.status.value, here.rpc.encode_chunk(bytes(5)))
            code, payload = here.rpc.decode_response_chunk(got[0])
            assert code == here.rpc.RESP_SUCCESS
            assert here.rpc.StatusMessage.deserialize(payload).head_slot == slot
        conn.send_gossip(b"frame from the port")
        back.send_gossip(b"frame from the JAX package")
        wait_for(lambda: ends["jax"].gossip and ends["port"].gossip, "both gossip frames")
        assert ends["jax"].gossip == [("port-host", b"frame from the port")]
        assert ends["port"].gossip == [("jax-host", b"frame from the JAX package")]
    finally:
        for e in ends.values():
            e.host.close()


@pytest.fixture(scope="module")
def jax_source():
    """A JAX package chain BLOCKS blocks ahead of genesis ("fake" BLS)."""
    from lighthouse_tpu.chain.beacon_chain import BeaconChain
    from lighthouse_tpu.testing.harness import StateHarness, clone_state
    from lighthouse_tpu.types.spec import minimal_spec

    jbls.set_backend("fake")
    spec = minimal_spec()
    harness = StateHarness.new(spec, VALIDATORS)
    genesis = clone_state(harness.state, spec)
    source = BeaconChain(spec, clone_state(genesis, spec))
    for _ in range(BLOCKS):
        slot = harness.state.slot + 1
        signed, _post = harness.produce_block(slot, attestations=[], full_sync=False)
        harness.apply_block(signed)
        source.slot_clock.set_slot(slot)
        source.per_slot_task()
        source.process_block(signed)
    return spec, genesis, source


def test_port_node_range_syncs_from_a_jax_node(jax_source):
    from lighthouse_tpu.network.node import NetworkNode as JNode
    from lighthouse_tpu.state_transition.slot import types_for_slot as j_types
    from lighthouse_tpu.types import helpers as jh

    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.network.node import NetworkNode
    from lighthouse_tpu_torch.state_transition.slot import types_for_slot
    from lighthouse_tpu_torch.torchhash import router
    from lighthouse_tpu_torch.types.spec import minimal_spec

    jspec, jgenesis, source = jax_source
    jbls.set_backend("fake")
    bls.set_backend("fake")
    hash_backend = router.hash_backend()
    router.set_hash_backend("host")
    spec = minimal_spec()
    genesis = types_for_slot(spec, 0).BeaconState.deserialize(
        j_types(jspec, 0).BeaconState.serialize(jgenesis))
    digest = jh.compute_fork_digest(jspec.fork_version(jspec.fork_name_at_slot(BLOCKS)),
                                    bytes(jgenesis.genesis_validators_root))
    target = BeaconChain(spec, genesis)
    target.slot_clock.set_slot(BLOCKS)
    target.per_slot_task()
    jnode = JNode(source, "jax-source", fork_digest=digest, subnets=1)
    node = NetworkNode(target, "port-target", fork_digest=digest, subnets=1)
    try:
        assert target.head_state().slot == 0
        node.host.dial(*jnode.host.listen_addr)
        wait_for(lambda: "jax-source" in node.sync.peer_status, "the Status handshake")
        assert node.sync.peer_status["jax-source"].head_slot == BLOCKS
        imported = node.sync.sync()
        assert imported == BLOCKS
        assert target.head_root == source.head_root
        assert target.head_state().slot == BLOCKS
        t_types = types_for_slot(spec, BLOCKS)
        assert t_types.BeaconState.hash_tree_root(target.head_state()) == j_types(
            jspec, BLOCKS).BeaconState.hash_tree_root(source.head_state())
        assert node.sync.state.value == "synced"
        link = node.host.connections["jax-source"]
        assert (link._tx is not None) is mods(PACKAGES[1]).transport.crypto_available()
    finally:
        node.close()
        jnode.close()
        router.set_hash_backend(hash_backend)


def test_supervisor_and_propagation_tracker_match():
    """The helpers the node stands on: the supervisor's backoff schedule on
    a seeded rng, and the propagation tracker's stall trigger on a manual
    slot clock."""
    on_both(lambda m: [round(m.sup.Supervisor(name="t", rng=random.Random(3), backoff_base=0.5,
                                              backoff_cap=4.0).backoff(a), 12)
                       for a in range(8)])

    def stalls(m):
        fired = []
        rec = pytypes.SimpleNamespace(
            trigger=lambda reason, **kw: fired.append(reason) or True,
            clear=lambda reason, **kw: fired.append(f"clear:{reason}"),
            record=lambda *a, **k: None)
        tracker = m.prop.PropagationTracker("n", recorder=rec, stall_slots=2)
        out = []
        for slot in range(6):
            if slot == 4:
                tracker.note_delivery("/eth2/00000000/beacon_block/ssz_snappy", None)
            tracker.close_slot(slot, peers=3)
            out.append((tracker.stall_streak, tracker.stalls_fired))
        return out, fired, tracker.ctx_missing

    out, fired, missing = on_both(stalls)
    assert fired and missing == 1
