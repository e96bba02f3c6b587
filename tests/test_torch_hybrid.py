"""The port's hybrid host/device BLS router (lighthouse_tpu_torch/crypto/bls/
hybrid.py) held against the JAX package's (lighthouse_tpu/crypto/bls/
hybrid.py): one scripted scenario runs through both routers, each with the
same stub device and an injected breaker clock, and must give the same
routes, verdicts, route counters and breaker transitions. Then the port's
router drives the real TorchBackend on the CPU, and two threads marshal on
one TorchBackend at once.

No JAX program is compiled: the reference's router only reads the jaxbls
padding bucket, and its host lane is its pure-Python backend.
"""

from __future__ import annotations

import threading
import time
import types

import pytest
import torch

from lighthouse_tpu.crypto import bls as ref_bls
from lighthouse_tpu.crypto.bls import api as ref_api
from lighthouse_tpu.crypto.bls import hybrid as ref_hybrid
from lighthouse_tpu.crypto.bls381 import curve as ref_cv
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.crypto.bls import api as port_api
from lighthouse_tpu_torch.crypto.bls import hybrid as port_hybrid
from lighthouse_tpu_torch.crypto.bls381 import curve as port_cv

SK = 0x1234
MSG, OTHER = b"\x07" * 32, b"\x08" * 32
REF = types.SimpleNamespace(bls=ref_bls, api=ref_api, hybrid=ref_hybrid, cv=ref_cv)
PORT = types.SimpleNamespace(bls=port_bls, api=port_api, hybrid=port_hybrid, cv=port_cv)


def _sets(pkg):
    """(good, tampered, big): one valid set, its message changed, and 8
    copies of the valid set (a batch above the urgent threshold)."""
    pk = pkg.bls.PublicKey(pkg.cv.g1_mul(pkg.cv.G1_GEN, SK))
    sig = pkg.bls.Signature(pkg.cv.g2_mul(pkg.api.hash_to_g2_point(MSG), SK))
    good = [pkg.bls.SignatureSet(sig, [pk], MSG)]
    return good, [pkg.bls.SignatureSet(sig, [pk], OTHER)], good * 8


class StubDevice:
    """The reference test's stub (tests/test_bls_hybrid.py): counts calls;
    verdict and failures scriptable."""

    def __init__(self):
        self.verdict = True
        self.fail = False
        self.calls = 0
        self.lock = threading.Lock()

    def verify_signature_sets(self, sets, rands):
        with self.lock:
            self.calls += 1
        if self.fail:
            raise RuntimeError("device exploded")
        return self.verdict

    def verify_signature_sets_async(self, sets, rands):
        outer = self

        class H:
            def result(self):
                return outer.verify_signature_sets(sets, rands)

        return H()


def _probed(router, state, device):
    """Short-circuit the router's probe to a known state (the reference
    test's `_make`): no probe thread runs, so neither package touches a
    device."""
    router._probe_started.set()
    router._probe_done.set()
    with router._lock:
        router._state = state
        router._device = device
        router._device_failures = 0


def _routes(pkg) -> dict:
    return {k: c.value for k, c in pkg.hybrid._ROUTE_DECISIONS.children()}


def _scenario(pkg):
    """Down, cold small bucket (host, then a warm), large cold batch,
    async, latency budget, device errors marking the state down and opening
    the breaker, circuit open, a failed half-open probe, recovery."""
    good, bad, big = _sets(pkg)
    clock = {"t": 0.0}
    router = pkg.hybrid.HybridBackend(
        probe_startup_wait_secs=0.1, probe_retry_secs=3600.0,
        p99_budget_ms=50.0, breaker_reset_secs=10.0, urgent_max_sets=4,
    )
    router._breaker._time = lambda: clock["t"]
    dev = StubDevice()
    seq = []

    def verify(sets, use_async=False):
        before = _routes(pkg)
        rands = [1] * len(sets)
        if use_async:
            ok = router.verify_signature_sets_async(sets, rands).result()
        else:
            ok = router.verify_signature_sets(sets, rands)
        moved = {k: v - before.get(k, 0) for k, v in _routes(pkg).items()
                 if v != before.get(k, 0)}
        seq.append((moved, ok))

    routes_before = _routes(pkg)
    _probed(router, "down", None)
    verify(good)
    verify(bad)
    _probed(router, "up", dev)
    verify(good)                                 # cold small: host + warm
    bucket = router._bucket(good)
    for _ in range(200):
        with router._lock:
            if bucket in router._warm_buckets and not router._warming:
                break
        time.sleep(0.01)
    seq.append(("warm", dev.calls, bucket in router._warm_buckets))
    verify(good)
    dev.verdict = False
    verify(bad)
    dev.verdict = True
    verify(big)                                  # large: device even cold
    verify(big, use_async=True)
    with router._lock:
        router._lats.extend([0.5] * 16)          # 500 ms device verifies on record
    verify(good)
    with router._lock:
        router._lats.clear()
    dev.fail = True
    for _ in range(3):
        verify(good)
    seq.append(("after errors", router._state, router._breaker.state()))
    _probed(router, "up", dev)                   # the probe found the card again
    dev.fail = False
    verify(good)                                 # breaker still open
    clock["t"] += 11.0
    dev.fail = True
    verify(good)                                 # half-open probe fails
    seq.append(("probe failed", router._breaker.state()))
    clock["t"] += 11.0
    dev.fail = False
    verify(good)                                 # half-open probe succeeds
    verify(good)
    routes = {k: v - routes_before.get(k, 0) for k, v in _routes(pkg).items()
              if v != routes_before.get(k, 0)}
    return seq, routes, list(router._breaker.transitions), dev.calls


@pytest.fixture(scope="module")
def scenarios():
    return _scenario(REF), _scenario(PORT)


def test_route_sequence_matches_reference(scenarios):
    (ref_seq, *_), (port_seq, *_) = scenarios
    assert port_seq == ref_seq
    # the scenario exercises every reason but device_probing
    verifies = [e for e in port_seq if isinstance(e[0], dict)]
    assert all(len(moved) == 1 for moved, _ok in verifies)   # one route a verify
    assert {k for moved, _ok in verifies for k in moved} == {
        ("host", "device_down"), ("host", "device_cold"), ("device", "ok"),
        ("host", "latency_budget"), ("host", "device_error"), ("host", "circuit_open")}
    assert [ok for _moved, ok in verifies].count(False) == 2   # the tampered set, host and device


def test_route_counters_match_reference(scenarios):
    (_, ref_routes, _, ref_calls), (_, port_routes, _, port_calls) = scenarios
    assert port_routes == ref_routes
    assert port_calls == ref_calls
    assert port_routes[("device", "ok")] == 6


def test_breaker_transitions_match_reference(scenarios):
    (*_, ref_tr, _), (*_, port_tr, _) = scenarios
    assert port_tr == ref_tr
    assert port_tr == ["closed", "open", "half_open", "open", "half_open", "closed"]


def test_router_drives_the_torch_backend_on_the_cpu():
    """The port's router over a real TorchBackend(device="cpu") at bucket
    (4, 1), marked warm: a valid and a tampered set route to the device
    with the right verdicts, and CUDA is never initialized."""
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend

    good, bad, _ = _sets(PORT)
    router = port_hybrid.HybridBackend(probe_startup_wait_secs=0.1,
                                       probe_retry_secs=3600.0)
    _probed(router, "up", TorchBackend(device="cpu"))
    assert router._bucket(good) == ("urgent", (4, 1))
    router._warm_buckets.add(("urgent", (4, 1)))
    before = _routes(PORT)
    assert router.verify_signature_sets(good, [1]) is True
    assert router.verify_signature_sets(bad, [1]) is False
    after = _routes(PORT)
    assert after[("device", "ok")] - before[("device", "ok")] == 2
    assert sum(after.values()) - sum(before.values()) == 2
    assert not torch.cuda.is_initialized()


def test_pk_grid_cache_under_concurrent_marshalling():
    """Threads marshal different batches on one TorchBackend at once (the
    hybrid router's warm thread and its serving thread; here more threads
    than cores, with a short switch interval); every grid equals the one a
    serial run gives, and the cache and its eviction order stay one set."""
    import sys

    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend, padding_bucket

    keys = [PORT.bls.PublicKey(port_cv.g1_mul(port_cv.G1_GEN, k)) for k in range(2, 26)]
    sig = PORT.bls.Signature(port_cv.G2_GEN)
    # 24 batches, three times the cache's 8 entries, so the threads evict
    # each other's grids while they marshal
    batches = [[PORT.bls.SignatureSet(sig, keys[i:i + 1 + j % 3], bytes([i]) * 32)
                for i in range(j % 4 + 1)] for j in range(24)]
    shapes = [padding_bucket(len(b), max(len(x.signing_keys) for x in b)) for b in batches]
    serial = TorchBackend(device="cpu")
    want = [serial.marshal(b, [1] * len(b))[0][:3] for b in batches]
    shared = TorchBackend(device="cpu")
    n_threads = 12
    got = [[None] * len(batches) for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def worker(k):
        start.wait()
        for step in range(4 * len(batches)):
            j = (k * 5 + step) % len(batches)
            got[k][j] = shared._marshal_pubkeys(batches[j], *shapes[j])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(n_threads):
        for g, w in zip(got[k], want):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert len(shared._pk_cache_order) == len(set(shared._pk_cache_order)) <= 8
    assert set(shared._pk_cache_order) == set(shared._pk_cache)
