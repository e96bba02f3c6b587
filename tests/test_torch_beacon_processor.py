"""The port's beacon processor and what it stands on (chain/
{beacon_processor,scheduler}.py, qos/{admission,ratelimit}.py,
network/gossip.py, observability/pipeline.py) on the CPU against the JAX
package's.

- tests/test_beacon_processor.py's sequences and the QoS processor
  sequences of tests/test_qos.py, run on both packages: equal `stats()`
  (processed, dropped, expired, shed, batches formed, the scheduler's
  decisions) apart from the cost model's seconds, the same batch sizes in
  the same order, the same shed callbacks;
- tests/test_capacity.py's scheduler sequences: the same decisions, caps
  and retunes after the same SLO slot reports;
- admission classes, deadlines and token buckets on a manual clock: the
  same verdicts;
- gossip topics, message ids and subnets: byte-equal;
- run_probe on "fake" BLS: the same count and the same stages in
  snapshot();
- the slice on the minimal spec: gossip singles published through the
  InProcessGossipRouter into a BeaconProcessor behind an
  AdmissionController, run_until_idle, submit_attestation_batch into fork
  choice and an OperationPool, then produce_block on the pool: the same
  verified attestations and an SSZ-byte-equal block (both on "fake", the
  JAX package's keys carried across);
- one processor batch of 4 real singles on "torch" (TorchBackend on the
  CPU, the kernels' plain versions) against the JAX package on "python":
  the same verdicts.

Tolerance: exact everywhere. No JAX compile.
"""

import dataclasses
import importlib
import threading
import types as pytypes

import pytest

from lighthouse_tpu.crypto import bls as jbls

PACKAGES = ("lighthouse_tpu", "lighthouse_tpu_torch")
MODULES = {"bp": "chain.beacon_processor", "sched": "chain.scheduler", "adm": "qos.admission",
           "rl": "qos.ratelimit", "clock": "utils.slot_clock", "slo": "observability.slo",
           "gossip": "network.gossip", "snappy": "network.snappy",
           "pipeline": "observability.pipeline", "fr": "observability.flight_recorder",
           "planner": "autotune.planner", "bls": "crypto.bls", "bc": "chain.beacon_chain",
           "op_pool": "chain.op_pool", "hm": "testing.harness", "slot": "state_transition.slot",
           "acc": "state_transition.accessors", "h": "types.helpers", "spec": "types.spec"}


def mods(package: str):
    return pytypes.SimpleNamespace(
        **{k: importlib.import_module(f"{package}.{v}") for k, v in MODULES.items()})


def on_both(step):
    """step(m) on the JAX package, then on the port; the results must be equal."""
    want, got = (step(mods(p)) for p in PACKAGES)
    assert got == want
    return got


def stats_core(st: dict) -> dict:
    """A processor's stats() without the cost model's seconds."""
    st = dict(st)
    sched = dict(st.pop("scheduler"))
    sched["model"] = {"samples": sched["model"]["samples"]}
    return {**st, "scheduler": sched}


def shed_counts(m) -> dict:
    return {key: child.value for key, child in m.adm.SHED_TOTAL.children()}


@pytest.fixture(autouse=True)
def _clean_recorders():
    """Cap retuning freezes while a bls_device breaker is open: no earlier
    test's breaker state leaks in (tests/test_capacity.py's isolation)."""
    for p in PACKAGES:
        importlib.import_module(f"{p}.observability.flight_recorder").RECORDER.reset()
    yield


# --------------------------------------------------------------- processor


def seq_priority_order(m):
    W = m.bp.WorkKind
    proc = m.bp.BeaconProcessor()
    order = []
    proc.submit(m.bp.WorkItem(W.gossip_attestation, payload=1,
                              run_batch=lambda xs: order.append(("att", xs))))
    proc.submit(m.bp.WorkItem(W.gossip_block, run=lambda: order.append(("block", None))))
    proc.submit(m.bp.WorkItem(W.chain_segment, run=lambda: order.append(("segment", None))))
    n = proc.run_until_idle()
    return n, order, stats_core(proc.stats())


def seq_coalescing(m):
    W = m.bp.WorkKind
    proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(max_attestation_batch=10))
    got = []
    for i in range(25):
        proc.submit(m.bp.WorkItem(W.gossip_attestation, payload=i,
                                  run_batch=lambda xs: got.append(list(xs))))
    proc.run_until_idle()
    return [len(b) for b in got], got, proc.batches_formed, stats_core(proc.stats())


def seq_bounded_queue(m):
    W = m.bp.WorkKind
    proc = m.bp.BeaconProcessor()
    proc.max_lengths[W.gossip_block] = 2
    verdicts = [proc.submit(m.bp.WorkItem(W.gossip_block, run=lambda: None)) for _ in range(3)]
    return verdicts, proc.dropped[W.gossip_block], stats_core(proc.stats())


def seq_pipelined(m):
    W = m.bp.WorkKind
    order, done = [], []

    class Handle:
        def __init__(self, tag):
            self.tag = tag

        def result(self):
            order.append(("resolve", self.tag))
            return True

    def runner(tag):
        def run_batch(_payloads):
            order.append(("submit", tag))
            return Handle(tag), lambda ok: done.append((tag, ok))
        return run_batch

    proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(max_inflight=2,
                                                           max_attestation_batch=1))
    for i in range(5):
        proc.submit(m.bp.WorkItem(kind=W.gossip_attestation, payload=i, run_batch=runner(i)))
    proc.run_until_idle()
    return order, done, proc.pipelined_batches, stats_core(proc.stats())


def seq_oldest_first_shed(m):
    W = m.bp.WorkKind
    proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(max_attestation_batch=64))
    proc.max_lengths[W.gossip_attestation] = 4
    before, shed = shed_counts(m), []
    accepted = [proc.submit(m.bp.WorkItem(
        kind=W.gossip_attestation, payload=i, run_batch=lambda xs: None,
        on_shed=lambda reason, i=i: shed.append((i, reason)))) for i in range(10)]
    queued = [it.payload for it in proc.queues[W.gossip_attestation]]
    proc.max_lengths[W.gossip_block] = 1
    blocks = [proc.submit(m.bp.WorkItem(W.gossip_block, run=lambda: None)) for _ in range(2)]
    after = shed_counts(m)
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return accepted, shed, queued, blocks, delta, stats_core(proc.stats())


def seq_expired_at_pop(m):
    W = m.bp.WorkKind
    clock = m.clock.ManualSlotClock(0, 1)
    clock.set_slot(50)
    proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(max_attestation_batch=64),
                                admission=m.adm.AdmissionController(clock))
    ran, shed = [], []
    for i in range(6):
        proc.submit(m.bp.WorkItem(
            kind=W.gossip_attestation, payload=i, run_batch=lambda xs: ran.extend(xs),
            deadline_slot=50 if i % 2 == 0 else 50 + 32,
            on_shed=lambda reason, i=i: shed.append((i, reason))))
    clock.set_slot(51)
    proc.run_until_idle()
    return sorted(ran), shed, stats_core(proc.stats()), proc.qos_totals()


def seq_admission_refuses_bulk(m):
    W = m.bp.WorkKind
    proc = m.bp.BeaconProcessor(admission=m.adm.AdmissionController(None))
    proc.max_lengths[W.backfill_segment] = 4
    verdicts = [proc.submit(m.bp.WorkItem(W.backfill_segment, run=lambda: None))
                for _ in range(4)]
    return verdicts, stats_core(proc.stats()), proc.qos_totals()


def seq_threaded_pump(m):
    """Live mode: worker threads pump 100 items; the batch sizes depend on
    the threads' timing, so only the totals are compared."""
    W = m.bp.WorkKind
    proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(num_workers=2,
                                                           max_attestation_batch=8))
    done, lock, count = threading.Event(), threading.Lock(), [0]

    def on_batch(xs):
        with lock:
            count[0] += len(xs)
            if count[0] >= 100:
                done.set()

    proc.start()
    try:
        for i in range(100):
            proc.submit(m.bp.WorkItem(W.gossip_attestation, payload=i, run_batch=on_batch))
        finished = done.wait(timeout=10)
        drained = proc.drain(timeout=5)
    finally:
        proc.stop()
    st = proc.stats()
    return finished, drained, count[0], st["processed"], st["dropped"], st["workers"]


SEQUENCES = {f.__name__[4:]: f for f in (
    seq_priority_order, seq_coalescing, seq_bounded_queue, seq_pipelined,
    seq_oldest_first_shed, seq_expired_at_pop, seq_admission_refuses_bulk, seq_threaded_pump)}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_processor_sequence_matches_jax(name):
    out = on_both(SEQUENCES[name])
    if name == "coalescing":
        assert out[0] == [10, 10, 5]
    if name == "threaded_pump":
        assert out[:3] == (True, True, 100)


# --------------------------------------------------------------- scheduler


def feed_linear_model(m, sched, a=0.025, b=0.00065):
    for lanes in (128, 256, 512, 1024):
        sched.observe_verify("gossip_attestation", lanes, a + b * lanes)
    return sched.model()


def sched_decisions(m):
    W = m.bp.WorkKind
    sched = m.sched.CapacityScheduler(m.bp.BeaconProcessorConfig(max_attestation_batch=10))
    kind = W.gossip_attestation
    out = [sched.decide(kind, 25), sched.decide(kind, 3, inflight=0, max_inflight=4),
           sched.decide(kind, 3, inflight=4, max_inflight=4),
           sched.decide(kind, 3, inflight=4, max_inflight=4, force=True)]
    sched.set_budget_gate(lambda k, n: False)
    out.append(sched.decide(kind, 3, force=True))
    return [(d.dispatch, d.cap, d.reason) for d in out], sched.stats()


def sched_deadline(m):
    clock = m.clock.ManualSlotClock(0, 1)
    sched = m.sched.CapacityScheduler(m.bp.BeaconProcessorConfig(),
                                      admission=m.adm.AdmissionController(clock))
    model = feed_linear_model(m, sched, a=0.0, b=0.025)
    out = []
    for t in (0.95, 0.1):
        clock.set_time(t)
        d = sched.decide(m.bp.WorkKind.gossip_attestation, 3, inflight=4, max_inflight=4)
        out.append((d.dispatch, d.cap, d.reason))
    return model, out


def sched_best_cap(m):
    sched = m.sched.CapacityScheduler(m.bp.BeaconProcessorConfig())
    model = feed_linear_model(m, sched)
    with sched._lock:
        caps = [sched._best_cap_locked(d, budget) for d, budget in (
            (640.0, None), (208.0, None), (2560.0, None), (2560.0, 0.5))]
    return model, caps, [m.sched.pow2ceil(n) for n in (0, 1, 3, 4, 5, 511, 512, 640)]


def slot_accountant(m, sched, clock):
    acct = m.slo.SlotAccountant(export_metrics=False)
    acct.bind_clock(clock)
    sched.bind_slo(acct)
    return acct


def sched_pinned_and_unpinned(m):
    out = []
    for cfg in (m.bp.BeaconProcessorConfig(max_attestation_batch=777, max_aggregate_batch=99),
                m.bp.BeaconProcessorConfig()):
        clock = m.clock.ManualSlotClock(0, 1)
        sched = m.sched.CapacityScheduler(cfg, admission=m.adm.AdmissionController(clock))
        feed_linear_model(m, sched)
        acct = slot_accountant(m, sched, clock)
        acct.record_admitted("gossip_attestation", 640)
        acct.record_admitted("gossip_aggregate", 320)
        acct.record_processed("gossip_attestation", 640)
        clock.set_slot(0)
        acct.close_slot(0)
        out.append((dict(sched.caps), sched.retunes, sched.stats()))
    return out


def sched_watermarks(m):
    clock = m.clock.ManualSlotClock(0, 1)
    adm = m.adm.AdmissionController(clock)
    sched = m.sched.CapacityScheduler(m.bp.BeaconProcessorConfig(), admission=adm)
    acct = slot_accountant(m, sched, clock)
    marks = []
    for slot in range(16):
        if slot < 2:
            acct.record_shed("gossip_attestation", "queue_full", 50)
        else:
            acct.record_admitted("gossip_attestation", 100)
            acct.record_processed("gossip_attestation", 100)
        clock.set_slot(slot)
        acct.close_slot(slot)
        marks.append((round(adm.bulk_watermark, 6), round(adm.backfill_watermark, 6)))
    return marks, sched.retunes, sched.stats()


def sched_rebase(m):
    sched = m.sched.CapacityScheduler(m.bp.BeaconProcessorConfig())
    sched.caps["gossip_attestation"] = 512
    caps = []
    for cap, source in ((64, "scheduler:9"), (256, "profile:xyz")):
        sched.on_plan_installed(dataclasses.replace(
            m.planner.DEFAULT_PLAN, max_attestation_batch=cap, source=source))
        caps.append(sched.caps["gossip_attestation"])
    return caps


SCHEDULER = {f.__name__[6:]: f for f in (
    sched_decisions, sched_deadline, sched_best_cap, sched_pinned_and_unpinned,
    sched_watermarks, sched_rebase)}


@pytest.mark.parametrize("name", sorted(SCHEDULER))
def test_scheduler_sequence_matches_jax(name):
    out = on_both(SCHEDULER[name])
    if name == "decisions":
        assert [r for _d, _c, r in out[0]] == ["cap_full", "idle", "coalesce", "drain", "budget"]
    if name == "watermarks":
        assert out[0][1][0] < 0.75 and out[0][-1][0] > out[0][1][0]


# ------------------------------------------------------- admission, limits


def test_admission_and_rate_limits_match_jax():
    def step(m):
        W, P = m.bp.WorkKind, m.adm.PriorityClass
        clock = m.clock.ManualSlotClock(0, 1)
        adm = m.adm.AdmissionController(clock)
        classes = [int(adm.classify(k)) for k in W]
        admits = [adm.admit(k, depth, 100) for k in W for depth in (0, 49, 50, 74, 75, 99, 100)]
        clock.set_slot(10)
        item = m.bp.WorkItem(W.gossip_attestation, payload=0)
        expired = [adm.is_expired(item)]
        for deadline in (10, 9, 11):
            item.deadline_slot = deadline
            expired.append(adm.is_expired(item))
        expired.append(m.adm.AdmissionController(None).is_expired(item))
        deadlines = [adm.attestation_deadline_slot(s) for s in (0, 5, 64)]

        now = [0.0]
        bucket = m.rl.TokenBucket(rate=2.0, burst=4.0, time_fn=lambda: now[0])
        answers = [bucket.allow() for _ in range(5)] + [bucket.retry_after()]
        now[0] += 1.0
        answers += [bucket.allow() for _ in range(3)]
        zero = m.rl.TokenBucket(rate=0.0, burst=0.0, time_fn=lambda: now[0])
        answers += [zero.allow(), zero.retry_after() >= 3600.0]
        lim = m.rl.RateLimiter(time_fn=lambda: now[0]).configure("api", 1.0, burst=2.0)
        answers += [lim.allow("unconfigured-scope")] + [lim.allow("api") for _ in range(3)]
        answers += [lim.denied("api"), lim.retry_after_secs("api")]
        now[0] += 1.0
        answers.append(lim.allow("api"))
        return classes, admits, expired, deadlines, answers, int(P.BACKFILL)

    classes, _admits, expired, deadlines, _answers, _ = on_both(step)
    assert expired == [False, False, True, False, False] and deadlines[1] == 5 + 32


# ------------------------------------------------------------------ gossip


def test_gossip_topics_ids_and_subnets_match_jax():
    def step(m):
        spec = m.spec.minimal_spec()
        mainnet = m.spec.mainnet_spec()
        digest = m.h.compute_fork_digest(spec.deneb_fork_version, b"\x42" * 32)
        topics = [m.gossip.topic_name(digest, name) for name in m.gossip.CORE_TOPICS]
        topics += [m.gossip.attestation_subnet_topic(digest, i) for i in (0, 1, 63)]
        topics += [m.gossip.blob_sidecar_topic(digest, 5), m.gossip.sync_committee_topic(digest, 3)]
        payloads = [b"", b"\x00" * 100, bytes(range(256)) * 3]
        ids = [m.gossip.message_id(t, m.snappy.compress(p)) for t in topics[-3:] for p in payloads]
        ids.append(m.gossip.message_id(topics[0], b"\xff not snappy"))
        subnets = [m.gossip.compute_subnet_for_attestation(cps, slot, index, s)
                   for s in (spec, mainnet) for cps in (1, 4, 64)
                   for slot in (0, 7, 31, 100) for index in range(min(cps, 4))]
        scopes = [m.gossip.ingest_scope(t) for t in topics]
        router = m.gossip.InProcessGossipRouter()
        got = []
        router.subscribe("b", topics[8], lambda msg: got.append(
            (msg.topic, msg.message_id, m.snappy.decompress(msg.payload))) or True)
        delivered = [router.publish("a", topics[8], p) for p in payloads + payloads[:1]]
        return topics, ids, subnets, scopes, got, delivered, router.delivered

    topics, ids, _subnets, _scopes, got, delivered, _ = on_both(step)
    assert len(set(ids)) == len(ids) and delivered == [1, 1, 1, 0] and len(got) == 3


# ------------------------------------------------------------------- probe


def test_run_probe_and_snapshot_match_jax():
    def step(m):
        prev = m.bls.get_backend().name if m.bls.api._active_backend is not None else None
        m.bls.set_backend("fake")
        try:
            n = m.pipeline.run_probe(8)
        finally:
            if prev is None:
                m.bls.api._active_backend = None
            else:
                m.bls.set_backend(prev)
        return n, m.pipeline.snapshot()["stages"]

    n, stages = on_both(step)
    assert n >= 1 and stages == list(importlib.import_module(
        "lighthouse_tpu_torch.observability.trace").PIPELINE_STAGES)


# --------------------------------------------------------------- the slice


def new_sides(n, backend="fake"):
    """The reference's and the port's harness and chain at genesis over the
    same n interop keys (the JAX package's, carried), on `backend` BLS."""
    from lighthouse_tpu_torch.testing import carry

    jkeys = jbls.interop_keypairs(n)
    for kp in jkeys:
        kp.pk.serialize()
    out = []
    for package in PACKAGES:
        m = mods(package)
        m.bls.set_backend(backend)
        spec = m.spec.minimal_spec()
        keys = jkeys if package == "lighthouse_tpu" else carry.carry_keypairs(jkeys)
        m.harness = m.hm.StateHarness(spec=spec, keypairs=keys)
        m.chain = m.bc.BeaconChain(spec, m.hm.clone_state(m.harness.state, spec))
        out.append(m)
    return out


@pytest.fixture
def restore_backends():
    from lighthouse_tpu_torch.crypto import bls

    prev, jprev = bls.api._active_backend, jbls.get_backend().name
    yield
    bls.api._active_backend = prev
    jbls.set_backend(jprev)


def singles_for(m, slot, head_root):
    """One single-bit attestation per member of the slot's committees."""
    spec = m.harness.spec
    types = m.slot.types_for_slot(spec, slot)
    st = m.hm.clone_state(m.harness.state, spec)
    atts = m.harness.build_attestations(m.hm.clone_state(st, spec), slot, head_root)
    epoch = m.acc.get_current_epoch(st, spec)
    cache = m.acc.build_committee_cache(st, spec, epoch)
    domain = m.h.get_domain(st, spec, m.spec.DOMAIN_BEACON_ATTESTER, epoch)
    out = []
    for index in range(cache.committees_per_slot):
        committee = cache.committee(slot, index)
        data = atts[index].data
        root = m.h.compute_signing_root(types.AttestationData, data, domain)
        for pos, vi in enumerate(committee):
            out.append(types.Attestation.make(
                aggregation_bits=[i == pos for i in range(len(committee))], data=data,
                signature=m.bls.sign(m.harness.sk(vi), root).serialize()))
    return out, cache.committees_per_slot


def gossip_into_processor(m, chain, proc, pool, singles, committees_per_slot):
    """Each single published as snappy-compressed SSZ on its attestation
    subnet; the subscriber submits it to the processor with its admission
    deadline, and the batch runner submits one batch through the chain
    (its continuation puts the verified ones in the pool)."""
    spec = chain.spec
    W = m.bp.WorkKind
    digest = m.h.compute_fork_digest(spec.deneb_fork_version, chain.genesis_validators_root)
    router, verified, batches = m.gossip.InProcessGossipRouter(), [], []

    def run_batch(atts):
        batches.append(len(atts))
        types = m.slot.types_for_slot(spec, chain.current_slot)

        def on_done(results):
            for att, indices in results:
                pool.insert_attestation(att, indices, types)
            verified.extend(results)
        return chain.submit_attestation_batch(list(atts), on_done=on_done)

    def on_attestation(msg):
        types = m.slot.types_for_slot(spec, chain.current_slot)
        att = types.Attestation.deserialize(m.snappy.decompress(msg.payload))
        return proc.submit(m.bp.WorkItem(
            kind=W.gossip_attestation, payload=att, run_batch=run_batch,
            deadline_slot=proc.admission.attestation_deadline_slot(att.data.slot)))

    topics = []
    for att in singles:
        subnet = m.gossip.compute_subnet_for_attestation(
            committees_per_slot, int(att.data.slot), int(att.data.index), spec)
        topic = m.gossip.attestation_subnet_topic(digest, subnet)
        if topic not in topics:
            topics.append(topic)
            router.subscribe("node", topic, on_attestation)
        types = m.slot.types_for_slot(spec, att.data.slot)
        router.publish("peer", topic, types.Attestation.serialize(att))
    return router, verified, batches, topics


def packed_validators(m, state, block):
    """The validators a block's attestations cover."""
    spec = m.harness.spec
    out = set()
    for att in block.body.attestations:
        out.update(m.acc.get_attesting_indices(state, spec, att.data, att.aggregation_bits))
    return sorted(out)


def test_slice_gossip_processor_pool_and_produced_block_match_jax(restore_backends):
    def step(m):
        spec, harness, chain = m.harness.spec, m.harness, m.chain
        signed, _post = harness.produce_block(1, attestations=[], full_sync=False)
        harness.apply_block(signed)
        chain.slot_clock.set_slot(1)
        chain.per_slot_task()
        head = chain.process_block(signed)
        singles, cps = singles_for(m, 1, head)
        pool = m.op_pool.OperationPool(spec)
        proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(),
                                    admission=m.adm.AdmissionController(chain.slot_clock))
        router, verified, batches, topics = gossip_into_processor(m, chain, proc, pool, singles,
                                                                  cps)
        executed = proc.run_until_idle()
        types = m.slot.types_for_slot(spec, 1)
        got = [(types.Attestation.hash_tree_root(a), list(i)) for a, i in verified]
        votes = sorted(chain.observed_attesters)

        chain.slot_clock.set_slot(2)
        chain.per_slot_task()
        st = m.hm.clone_state(chain.head_state(), spec)
        m.slot.process_slots(st, spec, 2)
        proposer = m.acc.get_beacon_proposer_index(st, spec)
        reveal = harness.randao_reveal(st, proposer, 0)
        block = chain.produce_block(2, reveal, op_pool=pool)
        types2 = m.slot.types_for_slot(spec, 2)
        packed = packed_validators(m, st, block)
        new_head = chain.process_block(harness.sign_block(block, types2))
        return (len(singles), topics, router.delivered, executed, batches, got, votes,
                stats_core(proc.stats()), types2.BeaconBlock.serialize(block), packed,
                new_head == chain.head_root)

    want, got = (step(m) for m in new_sides(64))
    assert got == want
    (n, _topics, delivered, _executed, batches, verified, votes, stats, block, packed,
     head_ok) = got
    assert n == delivered == len(verified) == len(votes) > 0 and sum(batches) == n
    assert packed == sorted(i for _a, (i,) in verified)
    assert stats["processed"] == {"gossip_attestation": n} and head_ok and block


# ---------------------------------------------------------------- on torch


def test_processor_batch_on_torch_cpu_matches_jax_python(restore_backends, monkeypatch):
    """4 singles of slot 0 with real signatures (signed once, on the JAX
    side, and carried): one processor batch on TorchBackend(device="cpu")
    at bucket (4, 1) against the JAX package on "python"."""
    import torch

    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend

    jside, pside = new_sides(32, backend="python")
    singles, cps = singles_for(jside, 0, jside.chain.head_root)
    jtypes = jside.slot.types_for_slot(jside.harness.spec, 0)
    ptypes = pside.slot.types_for_slot(pside.harness.spec, 0)
    carried = [ptypes.Attestation.deserialize(jtypes.Attestation.serialize(a)) for a in singles]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)                      # the suite's other workers share the cores
    monkeypatch.setattr(api, "_BACKENDS", dict(api._BACKENDS))
    api.register_backend("torch-cpu", TorchBackend(device="cpu"))
    pside.bls.set_backend("torch-cpu")
    marshalled = []
    backend = api.get_backend()
    monkeypatch.setattr(backend, "marshal", lambda sets, rands, _f=backend.marshal: (
        marshalled.append(len(sets)) or _f(sets, rands)))
    try:
        out = []
        for m, atts, types in ((jside, singles, jtypes), (pside, carried, ptypes)):
            m.chain.slot_clock.set_slot(1)
            m.chain.per_slot_task()
            pool = m.op_pool.OperationPool(m.harness.spec)
            proc = m.bp.BeaconProcessor(m.bp.BeaconProcessorConfig(),
                                        admission=m.adm.AdmissionController(m.chain.slot_clock))
            _r, verified, formed, _t = gossip_into_processor(m, m.chain, proc, pool, atts, cps)
            proc.run_until_idle()
            out.append(([(types.Attestation.hash_tree_root(a), list(i)) for a, i in verified],
                        formed, stats_core(proc.stats())["processed"],
                        sorted(pool.attestations), sorted(m.chain.observed_attesters)))
    finally:
        torch.set_num_threads(threads)
    assert out[1] == out[0]
    assert len(out[0][0]) == len(singles) == 4 and out[0][1] == [4]
    assert marshalled == [4]                      # one batch on the torch lanes
