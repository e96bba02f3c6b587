"""The torch BLS backend: batched multi-set signature verification on the card.

Registered as "torch" in crypto/bls/api.py. `verify_signature_sets` checks

    prod_i e(z_i * aggpk_i, H(m_i)) * e(-g1, sum_i z_i * sig_i) == 1

for 64-bit random coefficients z_i, in four stages on one device:

    1. prepare  (kernels.stage_prepare, csrc/prepare.cu): Montgomery
       conversion, per-set pubkey tree sums, z-scaling, signature tree sum
    2. h2c      (kernels.hash_to_g2, csrc/h2c.cu)
    3. pairs    (kernels.stage_pairs, csrc/pairs.cu): batched affine
       conversion and the n + 1 pairs with their mask
    4. pairing  (pairing_ops.pairing_product_is_one: csrc/miller.cu,
       csrc/easy_part.cu, csrc/hard_part.cu)

The verdict is `ok and not bad` (bad: some set's aggregate pubkey is the
identity). Shapes are padded to power-of-two (n, m) buckets with masked
lanes.

Every batch goes through a pipelined dispatcher (pipeline.py), as the JAX
backend's does: `verify_signature_sets_async` marshals on the caller's
thread (host hashing and packing, pinned host buffers copied without
blocking), then the dispatcher enqueues the four stages and a copy of the
verdict to pinned host memory behind a CUDA event, with no host
synchronisation in between; `VerifyHandle.result()` waits on that event.
Both lanes, batch and urgent, share the device's one stream. The
dispatcher books every batch in the device ledger as the `bls` tenant; a
resolved handle feeds the autotune profiler its bucket's time, and an
autotune plan installed later retunes the dispatcher's depth.
`verify_signature_sets` is `verify_signature_sets_async(...).result()`.
`warm_stages` builds or loads the kernel library and runs one dummy
verify at a bucket (autotune's startup warm-up), and with program
analytics on (observability/perf.py) counts the prepare and h2c programs'
work at it. The stages dispatch through observability/device.py's
`run_stage` (NVTX ranges; per-stage CUDA-event times when attribution is
on).
`aggregate_verify` (distinct messages) runs h2c, the pair assembly
`aggregate_pairs` and the pairing stage. KZG (crypto/kzg.py) reaches the
card through `g1_msm` (kernels.msm_varying), `g1_msm_fixed` (comb tables
of kernels.msm_precompute, cached per point set, and kernels.msm_fixed)
and `pairing_product_is_one` (the pairing stage). On CPU tensors
(device="cpu") every stage runs its plain PyTorch version, synchronously.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ...autotune import profiler
from ...observability import device as _obs_device
from ...observability import perf as _obs_perf
from ...observability.trace import current_trace
from ...utils import torchcfg
from ..bls381 import curve as pc
from ..bls381.constants import DST_POP
from . import curve_ops as co
from . import h2c_ops as h2
from . import kernels
from . import limbs as lb
from . import msm
from . import pairing_ops as po
from . import pipeline
from . import tower as tw

MIN_SETS = 4          # smallest set bucket
MIN_PKS = 1
Z_BITS = 64           # random coefficient width


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def padding_bucket(n_sets: int, n_pks: int) -> tuple[int, int]:
    """The (n, m) bucket of n_sets sets whose widest set has n_pks keys."""
    return max(MIN_SETS, _next_pow2(n_sets)), max(MIN_PKS, _next_pow2(n_pks))


def pack_ints_vec(xs) -> np.ndarray:
    """Host: ints < 2^384 -> (n, NL) uint32 standard-form 16-bit limbs."""
    buf = b"".join(x.to_bytes(48, "little") for x in xs)
    b8 = np.frombuffer(buf, np.uint8).reshape(len(xs), 48)
    return b8[:, 0::2].astype(np.uint32) | (b8[:, 1::2].astype(np.uint32) << 8)


# The four stages, in order. Each takes and returns tensors on one device.
stage_prepare = kernels.stage_prepare
stage_h2c = kernels.hash_to_g2
stage_pairs = kernels.stage_pairs


def stage_pairing(px, py, qxx, qyy, pair_mask):
    return po.pairing_product_is_one((px, py), (qxx, qyy), pair_mask)


def aggregate_pairs(pk_x, pk_y, mask, sig_xy, h_jac):
    """Pair assembly of distinct-message AggregateVerify (the JAX backend's
    _aggregate_kernel): standard-form pubkeys pk_x, pk_y (n, NL) with their
    mask (n,), the standard-form signature sig_xy (2, 2, NL) and the hashed
    messages h_jac -> (px, py, qxx, qyy, pair_mask) of the n + 1 pairs
    (pk_i, H(m_i)) and (-g1, sig). The Montgomery conversions are one
    kernels.fq_mont_mul, the affine conversion kernels.stage_pairs with Z =
    1 for the pubkeys and the signature. A pair whose H(m_i) is the
    identity (Z = 0) is masked and keeps its X and Y, as jac_to_affine
    leaves them (it inverts 1 there, where stage_pairs inverts 0)."""
    n = pk_x.shape[0]
    mont = kernels.fq_mont_mul(torch.cat([pk_x, pk_y, sig_xy.reshape(4, lb.NL)]))
    pk_x, pk_y, sig_x, sig_y = mont[:n], mont[n:2 * n], mont[2 * n:2 * n + 2], mont[2 * n + 2:]
    z_pk = (pk_x, pk_y, lb.const(lb.ONE_MONT, pk_x).expand_as(pk_x))
    sig = (sig_x, sig_y, lb.const(tw.FQ2_ONE, sig_x))
    px, py, qxx, qyy, pair_mask = kernels.stage_pairs(z_pk, h_jac, sig, mask)
    qinf = tw.fq2_is_zero(h_jac[2])[:, None, None]
    qxx = torch.cat([torch.where(qinf, h_jac[0], qxx[:n]), qxx[n:]])
    qyy = torch.cat([torch.where(qinf, h_jac[1], qyy[:n]), qyy[n:]])
    return px, py, qxx, qyy, pair_mask


class VerifyHandle:
    """An in-flight verification that resolves to a bool on `result()`.

    On the card the verdict (ok and not bad) is copied into pinned host
    memory behind a CUDA event, all enqueued without waiting; `result()`
    waits on that event only, so it never waits for batches enqueued after
    this one. `VerifyHandle()` is a batch that failed on the host. A
    handle given its padding bucket and dispatch time feeds the autotune
    profiler at its first resolve (`result()` is idempotent)."""

    __slots__ = ("_verdict", "_event", "_bucket", "_t0", "_n_real")

    def __init__(self, verdict=None, bucket=None, t0=None, n_real=0):
        self._bucket = bucket
        self._t0 = t0
        self._n_real = n_real
        self._event = None
        if verdict is not None and verdict.device.type == "cuda":
            host = torch.empty((), dtype=torch.bool, pin_memory=True)
            host.copy_(verdict, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            verdict = host
        self._verdict = verdict

    def result(self) -> bool:
        if self._verdict is None:
            return False
        if self._event is not None:
            self._event.synchronize()
        if self._t0 is not None and self._bucket is not None:
            dt, self._t0 = time.perf_counter() - self._t0, None
            profiler.observe_dispatch(*self._bucket, dt, self._n_real)
        return bool(self._verdict)


class TorchBackend:
    """Batched verification on one device (CUDA unless device="cpu")."""

    name = "torch"
    # every resolved dispatch feeds the autotune profiler from inside
    # VerifyHandle, so external measurement loops (autotune/calibrate.py)
    # must not record the same verify a second time
    autotune_self_recording = True

    def __init__(self, dst: bytes = DST_POP, device=None):
        self.dst = dst
        self.device = torchcfg.resolve_device(device)
        # the depth window and urgent lane; the `bls` tenant of the device
        # ledger. Depth resolves env > autotune plan > default here, and a
        # plan installed later re-resolves through the plan listener.
        self.dispatcher = pipeline.PipelinedDispatcher(workload="bls")
        try:
            from ...autotune import runtime

            runtime.add_plan_listener(self._on_plan_installed)
        except Exception:
            pass  # a broken autotune must never take down the backend
        # pubkey grids on the device, keyed by the identity of the key
        # objects and the set grouping (a validator registry re-verifies
        # the same PublicKey objects every slot); the lock lets two threads
        # (the hybrid router's warm-up and its serving thread) marshal at
        # once
        self._pk_cache: dict = {}
        self._pk_cache_order: list = []
        self._pk_lock = threading.Lock()
        # comb tables of fixed point sets (the KZG setup's Lagrange points),
        # keyed by the identity of the point list, whose reference they keep
        self._fixed_msm_cache: dict = {}
        self._fixed_msm_order: list = []

    def _on_plan_installed(self, _plan) -> None:
        """An autotune plan was installed or cleared: re-resolve the
        dispatcher's depth unless the constructor or the environment
        pinned it."""
        if self.dispatcher.depth_source in ("profile", "default"):
            self.dispatcher.set_depth(*pipeline.resolve_depth())

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> int64 tensor on the device; to the card through a
        pinned buffer and a copy that does not wait for the stream."""
        t = torch.from_numpy(a.astype(np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _marshal_pubkeys(self, sets, n: int, m: int):
        fp = (
            tuple(len(s.signing_keys) for s in sets),
            tuple(id(pk) for s in sets for pk in s.signing_keys),
        )
        with self._pk_lock:
            hit = self._pk_cache.get(fp)
            if hit is not None and hit[0].shape[:2] == (n, m):
                return hit[:3]
            pk_x = np.zeros((n, m, lb.NL), np.uint32)
            pk_y = np.zeros((n, m, lb.NL), np.uint32)
            pk_mask = np.zeros((n, m), np.uint32)
            for i, s in enumerate(sets):
                keys = s.signing_keys
                pk_x[i, : len(keys)] = pack_ints_vec([pk.point[0] for pk in keys])
                pk_y[i, : len(keys)] = pack_ints_vec([pk.point[1] for pk in keys])
                pk_mask[i, : len(keys)] = 1
            grid = (self._tensor(pk_x), self._tensor(pk_y), self._tensor(pk_mask))
            # strong refs to the key objects keep their ids valid while cached
            self._pk_cache[fp] = grid + ([pk for s in sets for pk in s.signing_keys],)
            self._pk_cache_order.append(fp)
            if len(self._pk_cache_order) > 8:
                self._pk_cache.pop(self._pk_cache_order.pop(0), None)
            return grid

    def marshal(self, sets, rands):
        """Host side of one batch: the prepare-stage inputs (pk_x, pk_y,
        pk_mask, sig_x, sig_y, z_bits, set_mask) and the h2c input us, on
        the device. Every signature must be finite."""
        n_real = len(sets)
        n, m = padding_bucket(n_real, max(len(s.signing_keys) for s in sets))
        pk_x, pk_y, pk_mask = self._marshal_pubkeys(sets, n, m)
        sig_x = np.zeros((n, 2, lb.NL), np.uint32)
        sig_y = np.zeros((n, 2, lb.NL), np.uint32)
        pts = [s.signature.point for s in sets]
        sig_x[:n_real, 0] = pack_ints_vec([sp[0][0] for sp in pts])
        sig_x[:n_real, 1] = pack_ints_vec([sp[0][1] for sp in pts])
        sig_y[:n_real, 0] = pack_ints_vec([sp[1][0] for sp in pts])
        sig_y[:n_real, 1] = pack_ints_vec([sp[1][1] for sp in pts])
        z_bits = np.zeros((n, Z_BITS), np.uint32)
        z_bits[:n_real] = co.scalars_to_bits([z & ((1 << Z_BITS) - 1) for z in rands], Z_BITS)
        set_mask = np.zeros((n,), np.uint32)
        set_mask[:n_real] = 1
        us = np.zeros((n, 2, 2, lb.NL), np.uint32)
        us[:n_real] = h2.hash_to_field_batch([s.message for s in sets], self.dst)
        prepare_in = (pk_x, pk_y, pk_mask) + tuple(
            self._tensor(a) for a in (sig_x, sig_y, z_bits, set_mask)
        )
        return prepare_in, self._tensor(us)

    @staticmethod
    def run(prepare_in, us):
        """The four stages on marshalled inputs -> (ok, bad) 0-dim bools.
        Each dispatches through observability/device.py's run_stage: an
        NVTX range on the card, and with attribution on, CUDA events around
        it (which serialise the stages) into the per-stage families and the
        current trace."""
        attr = _obs_device.begin(tuple(prepare_in[0].shape[:2]), trace=current_trace())
        z_pk, sig_acc, bad = _obs_device.run_stage(attr, "prepare", stage_prepare, *prepare_in)
        h_jac = _obs_device.run_stage(attr, "h2c", stage_h2c, us)
        pairs = _obs_device.run_stage(attr, "pairs", stage_pairs, z_pk, h_jac, sig_acc,
                                      prepare_in[-1])
        return _obs_device.run_stage(attr, "pairing", stage_pairing, *pairs), bad

    def verify_signature_sets_async(self, sets, rands, urgent: bool = False):
        """Marshal one batch here, on the caller's thread, then submit its
        four stages through the dispatcher: the batch lane waits for a
        window slot first, the urgent lane never does. Returns a ticket
        whose result() is the verdict."""
        if not sets or any(s.signature.point is None for s in sets):
            return VerifyHandle()
        prepare_in, us = self.marshal(sets, rands)
        bucket = tuple(prepare_in[0].shape[:2])
        tr = current_trace()
        if tr is not None:
            tr.annotate(bucket=f"{bucket[0]}x{bucket[1]}", real_sets=len(sets))

        def dispatch():
            t0 = time.perf_counter()
            ok, bad = self.run(prepare_in, us)
            return VerifyHandle(ok & ~bad, bucket=bucket, t0=t0, n_real=len(sets))

        return self.dispatcher.submit(dispatch, urgent=urgent, bucket=bucket)

    def verify_signature_sets(self, sets, rands) -> bool:
        return self.verify_signature_sets_async(sets, rands).result()

    # the urgent lane: small verifies that must not wait behind the window
    def verify_signature_sets_urgent_async(self, sets, rands):
        return self.verify_signature_sets_async(sets, rands, urgent=True)

    def verify_signature_sets_urgent(self, sets, rands) -> bool:
        return self.verify_signature_sets_urgent_async(sets, rands).result()

    def verify_single(self, pk, message: bytes, sig) -> bool:
        if sig.is_infinity():
            return False
        from ..bls import SignatureSet

        return self.verify_signature_sets_urgent([SignatureSet(sig, (pk,), message)], [1])

    def aggregate_verify(self, pks, messages, sig) -> bool:
        """Distinct-message AggregateVerify,
        prod_i e(pk_i, H(m_i)) * e(-g1, sig) == 1: no random coefficients,
        so no prepare stage; h2c, aggregate_pairs, then the pairing stage."""
        if len(pks) == 0 or sig.point is None:
            return False
        n_real = len(pks)
        n = max(MIN_SETS, _next_pow2(n_real))
        pk_x = np.zeros((n, lb.NL), np.uint32)
        pk_y = np.zeros((n, lb.NL), np.uint32)
        mask = np.zeros((n,), np.uint32)
        pk_x[:n_real] = pack_ints_vec([pk.point[0] for pk in pks])
        pk_y[:n_real] = pack_ints_vec([pk.point[1] for pk in pks])
        mask[:n_real] = 1
        (sx0, sx1), (sy0, sy1) = sig.point
        sig_xy = pack_ints_vec([sx0, sx1, sy0, sy1]).reshape(2, 2, lb.NL)
        us = np.zeros((n, 2, 2, lb.NL), np.uint32)
        us[:n_real] = h2.hash_to_field_batch(list(messages), self.dst)
        h_jac = stage_h2c(self._tensor(us))
        pairs = aggregate_pairs(*(self._tensor(a) for a in (pk_x, pk_y, mask, sig_xy)), h_jac)
        return bool(stage_pairing(*pairs))

    # -- accelerated primitives exposed to KZG ----------------------------

    def msm_inputs(self, points, scalars, window: int):
        """kernels.msm_varying's inputs on the device for host affine int
        pairs (None = the identity) and ints mod r: px, py, mask and the
        digits at `window`, padded to a power-of-two bucket of at least
        MIN_SETS masked lanes."""
        px, py, live = msm.pack_points(list(points), MIN_SETS)
        real_digits = msm.msm_digits(list(scalars), window)
        digits = np.zeros((len(live), real_digits.shape[1]), np.uint32)
        digits[: len(real_digits)] = real_digits
        return tuple(self._tensor(a) for a in (px, py, live.astype(np.uint32), digits))

    def g1_msm(self, points, scalars):
        """sum_i scalars[i] * points[i] over G1 for host affine int pairs
        (None = the identity) and ints mod r -> a host affine int pair or
        None: kernels.msm_varying at msm.msm_window's width."""
        if len(points) == 0:
            return None
        w = msm.msm_window()
        return msm.affine_result(*kernels.msm_varying(*self.msm_inputs(points, scalars, w),
                                                      window=w))

    def g1_msm_fixed(self, points, scalars):
        """The same sum over a STABLE point set (the KZG setup's Lagrange
        basis): its comb tables are built once (kernels.msm_precompute) and
        cached by the identity of the list, which the cache keeps alive
        (four sets at most); every call is one kernels.msm_fixed."""
        key = id(points)
        hit = self._fixed_msm_cache.get(key)
        if hit is None or hit[1] is not points:
            hit = (msm.FixedBaseMSM(points, self.device), points)
            self._fixed_msm_cache[key] = hit
            if key in self._fixed_msm_order:     # an id reused after GC
                self._fixed_msm_order.remove(key)
            self._fixed_msm_order.append(key)
            if len(self._fixed_msm_order) > 4:
                self._fixed_msm_cache.pop(self._fixed_msm_order.pop(0), None)
        return hit[0].msm(scalars)

    def pairing_inputs(self, live):
        """Host affine pairs, none of them the identity -> the pairing
        stage's (xp, yp, xq, yq, mask) in Montgomery form on the device,
        padded with masked zero lanes to a power of two >= MIN_SETS."""
        n = max(MIN_SETS, _next_pow2(len(live)))
        pad = n - len(live)

        def mont(xs):
            return self._tensor(lb.pack_batch([x * lb.R_MONT % pc.P for x in xs]))

        xq = torch.stack([mont([q[0][0] for _, q in live] + [0] * pad),
                          mont([q[0][1] for _, q in live] + [0] * pad)], dim=1)
        yq = torch.stack([mont([q[1][0] for _, q in live] + [0] * pad),
                          mont([q[1][1] for _, q in live] + [0] * pad)], dim=1)
        mask = torch.zeros((n,), dtype=torch.bool, device=self.device)
        mask[: len(live)] = True
        return (mont([p[0] for p, _ in live] + [0] * pad),
                mont([p[1] for p, _ in live] + [0] * pad), xq, yq, mask)

    def pairing_product_is_one(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1 for host affine pairs (None = identity), on
        the same pairing stage the signature verifier uses."""
        live = [(p, q) for p, q in pairs if p is not None and q is not None]
        if not live:
            return True
        return bool(stage_pairing(*self.pairing_inputs(live)))


def warm_stages(n_sets: int, n_pks: int) -> None:
    """Warm one padding bucket on the card: build (on a cold build/
    directory) or load the kernel library, then run one dummy verify at
    the bucket (generator points, distinct messages: the verdict is false,
    the four stages run) through the "torch" backend, which it loads if
    it is not yet (and which raises without a card). The wall time is
    recorded as the bucket's first-use cost in the autotune profiler;
    raises on failure. The autotune warm-up walks the plan's buckets
    through here on the "torch" backend."""
    from ..bls import api
    from ..bls.hybrid import _dummy_sets

    t0 = time.perf_counter()
    backend = api._BACKENDS.get("torch") or api._load_torch_backend()
    if backend.device.type == "cuda":
        kernels.library()
    sets = _dummy_sets(n_sets, n_pks)
    backend.verify_signature_sets(sets, [1] * len(sets))
    profiler.observe_compile(*padding_bucket(n_sets, n_pks), time.perf_counter() - t0)
    if _obs_perf.analytics_enabled():
        # the prepare and h2c programs' work at this bucket (pairs and
        # pairing are counted at their first attributed dispatch: their
        # inputs are stage outputs)
        prepare_in, us = backend.marshal(sets, [1] * len(sets))
        bucket = tuple(prepare_in[0].shape[:2])
        _obs_perf.maybe_capture_program("prepare", stage_prepare, prepare_in, bucket)
        _obs_perf.maybe_capture_program("h2c", stage_h2c, (us,), bucket)
