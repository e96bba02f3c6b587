"""The port's pipelined dispatcher (torchbls.pipeline), host-only with stub
handles: the cases of tests/test_jaxbls_pipeline.py that have a counterpart
in the port (FIFO resolution under out-of-order and concurrent resolves,
admission that blocks exactly at depth, concurrent submitters that never
overfill the window, the urgent lane's bypass of a full window, errors that
stay on their ticket, depth precedence), and the CPU backend's async
submission against its synchronous verdict.
"""

import threading
import time

import pytest

from lighthouse_tpu_torch.crypto.torchbls import pipeline as pl


class StubHandle:
    """Fake device handle: records the order result() fires in."""

    resolved: list = []   # class-level log, reset per test via fixture

    def __init__(self, tag, value=True, error=None):
        self.tag = tag
        self.value = value
        self.error = error

    def result(self):
        StubHandle.resolved.append(self.tag)
        if self.error is not None:
            raise self.error
        return self.value


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    StubHandle.resolved = []
    monkeypatch.delenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", raising=False)


def test_depth4_fifo_continuations_under_out_of_order_resolves():
    """Six batches through a depth-4 window, the newest resolved first:
    the handles still resolve in submission order, and the window never
    holds more than 4."""
    d = pl.PipelinedDispatcher(4)
    tickets = [d.submit(lambda i=i: StubHandle(i)) for i in range(6)]
    # submits 4 and 5 were admitted by resolving the two oldest
    assert StubHandle.resolved == [0, 1]
    assert [t.done for t in tickets] == [True, True, False, False, False, False]
    assert d.inflight() == 4

    assert tickets[5].result() is True
    assert StubHandle.resolved == [0, 1, 2, 3, 4, 5]
    assert all(t.done for t in tickets)
    assert d.inflight() == 0
    assert tickets[2].result() is True          # idempotent, in any order
    assert StubHandle.resolved == [0, 1, 2, 3, 4, 5]
    assert d.submitted == {"batch": 6, "urgent": 0}
    assert d.resolved == {"batch": 6, "urgent": 0}


def test_admit_blocks_exactly_at_depth():
    d = pl.PipelinedDispatcher(2)
    d.submit(lambda: StubHandle("a"))
    d.submit(lambda: StubHandle("b"))
    assert StubHandle.resolved == []            # the window holds both
    d.submit(lambda: StubHandle("c"))
    assert StubHandle.resolved == ["a"]         # the oldest resolved to admit c
    assert d.drain() == 2
    assert StubHandle.resolved == ["a", "b", "c"]


def test_depth4_fifo_under_concurrent_resolvers():
    """Threads resolving tickets concurrently still resolve each handle
    once, in submission order, and every thread gets its ticket's value."""
    d = pl.PipelinedDispatcher(4)
    tickets = [d.submit(lambda i=i: StubHandle(i, value=i)) for i in range(4)]
    got = {}
    threads = [threading.Thread(target=lambda i=i, t=t: got.__setitem__(i, t.result()))
               for i, t in reversed(list(enumerate(tickets)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert got == {0: 0, 1: 1, 2: 2, 3: 3}
    assert StubHandle.resolved == [0, 1, 2, 3]
    assert d.resolved == {"batch": 4, "urgent": 0}


def test_concurrent_submitters_never_exceed_depth():
    """Racing submitters cannot overfill the window between the admission
    check and the append: admission claims a slot atomically."""
    d = pl.PipelinedDispatcher(2)
    peak = []

    def slow_dispatch(i):
        def dispatch():
            with d._lock:
                peak.append(len(d._window) + d._reserved)
            time.sleep(0.005)   # widen the dispatch window for the race
            return StubHandle(i)

        return dispatch

    threads = [threading.Thread(target=lambda i=i: d.submit(slow_dispatch(i))) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert max(peak) <= 2, peak
    d.drain()
    assert sorted(StubHandle.resolved) == list(range(8))


def test_urgent_lane_bypasses_full_batch_window():
    """With the window full, an urgent submission dispatches and resolves
    at once, resolving no batch and taking no slot."""
    d = pl.PipelinedDispatcher(2)
    d.submit(lambda: StubHandle("batch0"))
    d.submit(lambda: StubHandle("batch1"))
    t = d.submit(lambda: StubHandle("urgent"), urgent=True)
    assert t.result() is True
    assert StubHandle.resolved == ["urgent"]
    assert d.inflight() == 2
    assert d.drain() == 2
    assert StubHandle.resolved == ["urgent", "batch0", "batch1"]
    assert d.submitted == {"batch": 2, "urgent": 1}


def test_error_ticket_does_not_poison_the_window():
    """A failed batch re-raises its own error on every result() call, and
    tickets after it resolve normally."""
    d = pl.PipelinedDispatcher(2)
    t_bad = d.submit(lambda: StubHandle("bad", error=RuntimeError("launch failed")))
    t_ok = d.submit(lambda: StubHandle("good"))
    with pytest.raises(RuntimeError, match="launch failed"):
        t_bad.result()
    with pytest.raises(RuntimeError, match="launch failed"):
        t_bad.result()                          # sticky, not retried
    assert d.submit(lambda: StubHandle("later")).result() is True
    assert t_ok.result() is True
    assert StubHandle.resolved == ["bad", "good", "later"]


def test_failing_oldest_batch_never_poisons_an_admitting_submitter():
    """Admission resolves the oldest batch; its failure belongs to its own
    ticket, not to the new submission."""
    d = pl.PipelinedDispatcher(1)
    t_bad = d.submit(lambda: StubHandle("bad", error=RuntimeError("boom")))
    t_ok = d.submit(lambda: StubHandle("ok"))   # admission resolves t_bad
    assert t_ok.result() is True
    with pytest.raises(RuntimeError, match="boom"):
        t_bad.result()


def test_depth_resolution_precedence(monkeypatch):
    monkeypatch.delenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", raising=False)
    assert pl.resolve_depth() == (4, "default")
    monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "9")
    assert pl.resolve_depth() == (9, "env")
    assert pl.resolve_depth(explicit=3) == (3, "explicit")
    assert pl.PipelinedDispatcher().depth == 9
    # a malformed variable falls through; clamping applies everywhere
    monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "nope")
    assert pl.resolve_depth() == (4, "default")
    monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", "40")
    assert pl.resolve_depth() == (16, "env")
    assert pl.resolve_depth(explicit=99) == (16, "explicit")
    assert pl.resolve_depth(explicit=0) == (1, "explicit")


@pytest.mark.parametrize("env", [None, "9", "nope", "40"])
@pytest.mark.parametrize("explicit", [None, 3, 99, 0])
def test_depth_resolution_is_the_references(monkeypatch, env, explicit):
    """The port's (depth, source) equals the JAX package's resolve_depth
    under the same environment, with no autotune plan installed (the
    reference's "profile" layer, which the port does not have yet)."""
    from lighthouse_tpu.crypto.jaxbls import pipeline as ref

    monkeypatch.setattr(ref, "_plan", lambda: None)
    if env is None:
        monkeypatch.delenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("LIGHTHOUSE_TPU_PIPELINE_DEPTH", env)
    assert pl.resolve_depth(explicit) == ref.resolve_depth(explicit)


def test_get_backend_honours_the_backend_variable(monkeypatch):
    """LIGHTHOUSE_TPU_BLS_BACKEND picks the backend at first use, as in the
    reference; an unknown name raises the same ValueError."""
    import torch

    from lighthouse_tpu_torch.crypto.bls import api

    monkeypatch.setattr(api, "_active_backend", None)
    monkeypatch.setenv("LIGHTHOUSE_TPU_BLS_BACKEND", "python")
    assert isinstance(api.get_backend(), api.PythonBackend)
    assert api.get_backend() is api._BACKENDS["python"]
    monkeypatch.setattr(api, "_active_backend", None)
    monkeypatch.setenv("LIGHTHOUSE_TPU_BLS_BACKEND", "no-such-backend")
    with pytest.raises(ValueError, match="unknown BLS backend 'no-such-backend'"):
        api.get_backend()
    assert api._active_backend is None
    # unset, the default is the card's backend: without a card it raises
    # rather than run on the CPU
    monkeypatch.delenv("LIGHTHOUSE_TPU_BLS_BACKEND")
    if "torch" not in api._BACKENDS and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.get_backend()


def test_cpu_backend_async_matches_the_synchronous_verdict():
    """TorchBackend(device="cpu"): the async submission resolves to the
    synchronous call's verdict, through the batch lane of the dispatcher."""
    import random

    import torch

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import api as bls_api
    from lighthouse_tpu_torch.crypto.bls381 import curve as cv
    from lighthouse_tpu_torch.crypto.torchbls.backend import TorchBackend

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = random.Random(0xA5)
        sk = rng.randrange(1, 1 << 255)
        msg = b"\x42" * 32
        s = bls.SignatureSet(bls.Signature(cv.g2_mul(bls_api.hash_to_g2_point(msg), sk)),
                             [bls.PublicKey(cv.g1_mul(cv.G1_GEN, sk))], msg)
        be = TorchBackend(device="cpu")
        ticket = be.verify_signature_sets_async([s], [1])
        assert isinstance(ticket, pl.PipelineTicket) and ticket.lane == "batch"
        assert ticket.result() is be.verify_signature_sets([s], [1]) is True
        assert be.dispatcher.resolved == {"batch": 2, "urgent": 0}
        # a batch that fails on the host resolves False without a dispatch
        inf = bls.SignatureSet(bls.Signature.infinity(), s.signing_keys, msg)
        assert be.verify_signature_sets_async([inf], [1]).result() is False
        assert be.dispatcher.submitted == {"batch": 2, "urgent": 0}
    finally:
        torch.set_num_threads(prev)
