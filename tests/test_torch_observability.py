"""The port's observability layer (lighthouse_tpu_torch/observability/) held
against the JAX package's: the same logical-clock event script through both
packages' DeviceLedger gives equal books (snapshot, contention matrix, busy
time, timeline, conservation); the same records through both SlotAccountants
give equal slot reports and incident triggers; the chrome-trace export of the
same spans is equal. Then the port's own wiring: the torch dispatcher books
its tenant in the ledger, and a breaker transition to open reaches the port's
flight recorder as one incident. No JAX program is compiled; nothing touches
a device.
"""

from __future__ import annotations

import json

import pytest

from lighthouse_tpu.observability import device_ledger as ref_dl
from lighthouse_tpu.observability import flight_recorder as ref_fr
from lighthouse_tpu.observability import slo as ref_slo
from lighthouse_tpu.observability import trace as ref_trace
from lighthouse_tpu_torch.observability import device_ledger as port_dl
from lighthouse_tpu_torch.observability import flight_recorder as port_fr
from lighthouse_tpu_torch.observability import slo as port_slo
from lighthouse_tpu_torch.observability import trace as port_trace

# (time, op, interval, argument): a bls batch busy while tree_hash waits
# (contention), an urgent bls verify beside it, an epoch interval pinned to
# chip 0, a failed close, an interval abandoned before dispatch, ticks
LEDGER_SCRIPT = (
    (0.0, "open", "a", {"workload": "bls", "lane": "batch", "bucket": (64, 128), "est_cost": 0.2}),
    (0.1, "start", "a", None),
    (0.3, "open", "b", {"workload": "tree_hash", "lane": "batch", "bucket": 4096}),
    (0.35, "open", "c", {"workload": "bls", "lane": "urgent", "bucket": (4, 1)}),
    (0.4, "start", "c", None),
    (0.8, "close", "a", "ok"),
    (0.85, "start", "b", None),
    (0.9, "close", "c", "ok"),
    (1.0, "open", "d", {"workload": "epoch", "bucket": 1 << 20, "chips": (0,)}),
    (1.1, "start", "d", None),
    (1.25, "tick", None, None),
    (1.3, "close", "b", "error"),
    (1.6, "close", "d", "ok"),
    (1.7, "open", "e", {"workload": "bls"}),
    (1.9, "close", "e", "error"),
    (2.0, "tick", None, None),
)


def _run_ledger(mod, n_chips: int):
    clock = {"t": 0.0}
    ledger = mod.DeviceLedger(n_chips=n_chips, clock=lambda: clock["t"])
    for w in ("bls", "tree_hash"):
        ledger.register(w, dispatcher=object())
    ledger.register("epoch")
    ivs = {}
    for t, op, name, arg in LEDGER_SCRIPT:
        clock["t"] = t
        if op == "open":
            ivs[name] = ledger.open(**arg)
        elif op == "start":
            ivs[name].start()
        elif op == "close":
            ivs[name].close(arg)
        else:
            ledger.tick()
    return ledger


@pytest.mark.parametrize("n_chips", [1, 2])
def test_ledger_books_match_reference(n_chips):
    ref, port = _run_ledger(ref_dl, n_chips), _run_ledger(port_dl, n_chips)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert port.contention_matrix() == ref.contention_matrix()
    assert port.busy_seconds() == ref.busy_seconds()
    assert port.perfetto_device_timeline() == ref.perfetto_device_timeline()
    json.dumps(snap)
    cons = snap["conservation"]
    assert cons["ok"] and cons["wall"] == pytest.approx(2.0)
    for chip in cons["per_chip"]:
        total = chip["busy"] + chip["contention_wait"] + chip["idle"]
        assert total == pytest.approx(chip["wall"], rel=1e-12)
    # tree_hash waited from 0.3 to its start at 0.85 while bls held the card
    assert port.contention_matrix()[("tree_hash", "bls")] == pytest.approx(0.55)
    assert set(port.busy_seconds()) == {"bls", "tree_hash", "epoch"}


class _Clock:
    """A manual slot clock (what SlotAccountant.bind_clock expects)."""

    seconds_per_slot = 12

    def __init__(self):
        self.slot = 0

    def now(self):
        return self.slot


def _run_accountant(slo_mod, fr_mod, dl_mod):
    """Four slots of records through a private accountant: a clean slot, a
    slot that sheds and verifies late (burn over threshold, a miss streak),
    another degraded one, and an empty one; contention booked in the
    package's global ledger between slots."""
    dl_mod.LEDGER.reset()
    clock_t = {"t": 0.0}
    dl_mod.LEDGER.configure(n_chips=1, clock=lambda: clock_t["t"])
    rec = fr_mod.FlightRecorder()
    acc = slo_mod.SlotAccountant(recorder=rec, export_metrics=False)
    clock = _Clock()
    acc.bind_clock(clock)
    reports = []
    try:
        acc.record_admitted("gossip_attestation", 64)
        acc.record_processed("gossip_attestation", 64)
        acc.record_route("device", 64)
        acc.record_queue_wait("gossip_attestation", 0.004)
        acc.record_verify_latency(0.014)
        acc.record_workload_deadline("bls", hits=64)
        reports += acc.close_slot(0)
        clock.slot = 1
        busy = dl_mod.LEDGER.open("bls", bucket=(64, 128))
        busy.start()
        waiter = dl_mod.LEDGER.open("tree_hash", bucket=1 << 20)
        clock_t["t"] = 0.5
        busy.close("ok")
        waiter.start()
        waiter.close("ok")
        acc.record_admitted("gossip_attestation", 100)
        acc.record_shed("gossip_attestation", "queue_full", 60)
        acc.record_processed("gossip_attestation", 40)
        acc.record_late(8, kind="gossip_attestation")
        acc.record_late(5, kind="block")             # not deadlined: ignored
        acc.record_route("host", 40)
        acc.record_workload_deadline("bls", hits=32, misses=8)
        acc.record_workload_deadline("tree_hash", misses=1)
        reports += acc.close_slot(1)
        clock.slot = 2
        acc.record_shed("gossip_aggregate", "expired", 10)
        acc.record_processed("gossip_aggregate", 5)
        reports += acc.close_slot(2)
        clock.slot = 4
        reports += acc.close_slot(3)                 # slot 3 empty
        snap = acc.snapshot()
        kinds = [(e["kind"], e.get("reason"), e.get("victim"), e.get("occupant"))
                 for e in rec.events()]
        return [r.as_dict() for r in reports], snap, kinds, acc.health()
    finally:
        dl_mod.LEDGER.reset()


def test_slo_reports_match_reference():
    ref = _run_accountant(ref_slo, ref_fr, ref_dl)
    port = _run_accountant(port_slo, port_fr, port_dl)
    assert port == ref
    reports, snap, kinds, _health = port
    assert [r["slot"] for r in reports] == [0, 1, 2, 3]
    assert reports[1]["deadline"] == {"hits": 32, "misses": 68, "late": 8,
                                      "hit_ratio": 0.32}
    # the burn-rate, miss-streak and device-contention triggers each fired once
    incidents = [k for k in kinds if k[0] == "incident"]
    assert sorted(r for _k, r, _v, _o in incidents) == [
        "deadline_miss_streak", "device_contention", "slo_burn_rate"]
    assert ("incident", "device_contention", "tree_hash", "bls") in kinds
    assert snap["windows"]["slot_5"]["slots"] == 4


def _export(trace_mod, timeline):
    tr = trace_mod.Trace("gossip_batch", n_items=64)
    tr.add_span("marshal", 1.0, 1.008, bytes=4096)
    tr.add_span("device", 1.008, 1.022)
    tr.add_span("device:pairing", 1.012, 1.020)
    tr.annotate(bucket="64x128", real_sets=64)
    tr2 = trace_mod.Trace("urgent", n_items=1)
    tr2.add_span("device", 1.010, 1.016)
    counters = [(1.001, "queue_depth", {"gossip_attestation": 64})]
    instants = [(1.015, "fr:breaker_transition", {"to": "open"})]
    return trace_mod.chrome_trace_events(
        [tr, tr2], counters=counters, instants=instants, pid=1, base=1.0,
        device_timeline=timeline)


def test_chrome_trace_export_matches_reference():
    timeline = _run_ledger(port_dl, 1).perfetto_device_timeline()
    events = _export(port_trace, timeline)
    assert events == _export(ref_trace, timeline)
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"device:pairing", "flight_recorder", "ledger:bls", "ledger:tree_hash:wait"} <= names


def _merged(trace_mod, timeline, path):
    tracers = []
    for name, kind, t in (("node_a", "gossip_batch", 1.0), ("node_b", "urgent", 1.5)):
        tracer = trace_mod.Tracer()
        tr = tracer.begin(kind, n_items=4)
        tr.add_span("device", t, t + 0.02)
        tracer.finish(tr)
        tracer.sample_counters("queue_depth", {"gossip_attestation": 3})
        tracers.append((name, tracer))
    n = trace_mod.merge_chrome_traces(tracers, str(path), instants=[(1.2, "fr:route_flip", {})],
                                      device_timeline=timeline)
    with open(path) as f:
        doc = json.load(f)
    for ev in doc["traceEvents"]:           # counter samples carry the wall clock
        if ev["ph"] == "C":
            ev.pop("ts")
    return n, doc


def test_merged_chrome_trace_matches_reference(tmp_path):
    timeline = _run_ledger(port_dl, 1).perfetto_device_timeline()
    n, doc = _merged(port_trace, timeline, tmp_path / "port.json")
    assert (n, doc) == _merged(ref_trace, timeline, tmp_path / "ref.json")
    groups = [e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert groups == ["flight_recorder", "node_a", "node_b", "device_ledger"]


def test_dispatcher_books_its_tenant_in_the_ledger():
    """A named torch dispatcher registers with the port's LEDGER; each
    submission opens an interval with its lane and bucket and closes it with
    its outcome; the torchbls_pipeline_* families move."""
    from lighthouse_tpu_torch.crypto.torchbls import pipeline as pl
    from lighthouse_tpu_torch.observability.device_ledger import LEDGER
    from lighthouse_tpu_torch.utils.metrics import REGISTRY

    class Handle:
        def __init__(self, value):
            self.value = value

        def result(self):
            if isinstance(self.value, Exception):
                raise self.value
            return self.value

    def submitted():
        return {k: c.value for k, c in pl._SUBMITTED.children()}

    LEDGER.reset()
    before = submitted()
    try:
        d = pl.PipelinedDispatcher(2, workload="bls_test")
        tickets = [d.submit(lambda v=v: Handle(v), bucket=(4, 1)) for v in (True, False)]
        tickets.append(d.submit(lambda: Handle(RuntimeError("boom")), urgent=True, bucket=(4, 1)))
        tickets.append(d.submit(lambda: Handle(True), bucket=(8, 2)))   # resolves the first to admit
        assert tickets[3].result() is True
        assert tickets[1].result() is False
        with pytest.raises(RuntimeError):
            tickets[2].result()
        snap = LEDGER.snapshot()
        assert snap["registry"]["bls_test"] == {"registrations": 1, "has_dispatcher": True}
        assert snap["open_intervals"] == [] and snap["conservation"]["ok"]
        busy = [s for s in LEDGER.perfetto_device_timeline() if s[0] == "bls_test"]
        assert sorted(s[4]["outcome"] for s in busy) == ["error", "ok", "ok", "ok"]
        assert {s[4]["lane"] for s in busy} == {"batch", "urgent"}
        assert LEDGER.last_bucket("bls_test") == (8, 2)
        after = submitted()
        assert after[("batch",)] - before.get(("batch",), 0) == 3
        assert after[("urgent",)] - before.get(("urgent",), 0) == 1
        text = REGISTRY.expose_text()
        assert 'torchbls_pipeline_depth{source="explicit"} 2' in text
        assert 'torchbls_pipeline_resolved_total{lane="urgent",outcome="error"}' in text
    finally:
        LEDGER.reset()


def test_breaker_open_reaches_the_flight_recorder(tmp_path):
    """A transition to open hands one incident trigger to the port's
    RECORDER (after the breaker's lock is released); an open -> half_open ->
    open flap does not dump again; closing re-arms the trigger. The dump
    passes the reference's schema check."""
    from lighthouse_tpu_torch.observability.flight_recorder import (
        INCIDENTS_TOTAL, RECORDER, validate_incident)
    from lighthouse_tpu_torch.qos.breaker import CircuitBreaker

    RECORDER.reset()
    RECORDER.configure(incident_dir=str(tmp_path))
    t = {"now": 0.0}
    before = INCIDENTS_TOTAL.labels("breaker_open").value
    try:
        br = CircuitBreaker("bls_device_test", failure_threshold=3, reset_timeout=10.0,
                            time_fn=lambda: t["now"])
        for _ in range(3):
            br.record_failure()
        assert RECORDER.breaker_states["bls_device_test"] == "open"
        t["now"] = 11.0
        assert br.allow()                         # half-open probe
        br.record_failure()                       # back to open: no second dump
        incidents = [e for e in RECORDER.events() if e["kind"] == "incident"]
        assert len(incidents) == 1 and incidents[0]["reason"] == "breaker_open"
        assert INCIDENTS_TOTAL.labels("breaker_open").value - before == 1
        assert "breaker_open:bls_device_test" in RECORDER.snapshot()["disarmed"]
        assert [e["to"] for e in RECORDER.events() if e["kind"] == "breaker_transition"] == [
            "open", "half_open", "open"]
        t["now"] = 22.0
        assert br.allow()
        br.record_success()
        assert "breaker_open:bls_device_test" not in RECORDER.snapshot()["disarmed"]
        (path,) = RECORDER.incidents_written
        with open(path) as f:
            doc = json.load(f)
        assert validate_incident(doc) == []
        assert doc["config_fingerprint"]["mesh_topology"] == "single"
    finally:
        RECORDER.reset()
