"""Top-level BLS operations + runtime backend registry of the port.

The multi-set verification equation (blst's
verify_multiple_aggregate_signatures, lighthouse/crypto/bls/src/impls/
blst.rs:35-117): with random nonzero 64-bit coefficients z_i (z_0 = 1),

    prod_i e(z_i * aggpk_i, H(m_i)) * e(-g1, sum_i z_i * sig_i) == 1

Backends: "torch" (crypto/torchbls, loaded at first use: it resolves the
CUDA device), "hybrid" (crypto/bls/hybrid.py, loaded at first use: it
routes each verify to the card or to the host and probes the card on its
own thread), "python", the pure-Python ground truth (KZG's host fallback
and the hybrid router's host lane), and "fake", which validates nothing
and proves the batch plumbing, like
lighthouse/crypto/bls/src/impls/fake_crypto.rs.
"""

from __future__ import annotations

import os
import secrets
from typing import Callable, Sequence

from ..bls381 import curve as cv
from ..bls381 import hash_to_curve as h2c
from ..bls381 import pairing as pr
from ..bls381.constants import DST_POP, R
from .keys import PublicKey, SecretKey
from .signature import Signature
from .signature_set import SignatureSet

RANDOM_BITS = 64


def _default_rands(n: int) -> list[int]:
    # z_0 may be 1 (blst does this too); all must be nonzero.
    return [1] + [secrets.randbits(RANDOM_BITS) | 1 for _ in range(n - 1)] if n else []


def hash_to_g2_point(message: bytes):
    return h2c.hash_to_g2(message, DST_POP)


class PythonBackend:
    """Pure-Python ground-truth backend."""

    name = "python"

    def verify_signature_sets(self, sets: Sequence[SignatureSet], rands: Sequence[int]) -> bool:
        pairs = []
        sig_acc = None
        for s, z in zip(sets, rands):
            agg_pk = None
            for pk in s.signing_keys:
                agg_pk = cv.g1_add(agg_pk, pk.point)
            if agg_pk is None:
                return False
            msg_pt = hash_to_g2_point(s.message)
            pairs.append((cv.g1_mul(agg_pk, z), msg_pt))
            sig_acc = cv.g2_add(sig_acc, cv.g2_mul(s.signature.point, z) if s.signature.point else None)
        pairs.append((cv.g1_neg(cv.G1_GEN), sig_acc))
        return pr.multi_pairing_is_one(pairs)

    def verify_signature_sets_async(self, sets, rands):
        return _ReadyHandle(self.verify_signature_sets(sets, rands))

    def verify_single(self, pk: PublicKey, message: bytes, sig: Signature) -> bool:
        if sig.is_infinity():
            return False
        msg_pt = hash_to_g2_point(message)
        return pr.multi_pairing_is_one([(pk.point, msg_pt), (cv.g1_neg(cv.G1_GEN), sig.point)])

    def aggregate_verify(self, pks: Sequence[PublicKey], messages: Sequence[bytes], sig: Signature) -> bool:
        pairs = [(pk.point, hash_to_g2_point(m)) for pk, m in zip(pks, messages)]
        pairs.append((cv.g1_neg(cv.G1_GEN), sig.point))
        return pr.multi_pairing_is_one(pairs)


class FakeBackend:
    """Always-valid stub (plumbing tests only); signing returns a fixed
    valid G2 point."""

    name = "fake"

    def verify_signature_sets(self, sets, rands) -> bool:
        return all(len(s.signing_keys) > 0 for s in sets)

    def verify_signature_sets_async(self, sets, rands):
        return _ReadyHandle(self.verify_signature_sets(sets, rands))

    def verify_single(self, pk, message, sig) -> bool:
        return True

    def aggregate_verify(self, pks, messages, sig) -> bool:
        return True

    def sign(self, sk: SecretKey, message: bytes) -> Signature:
        return Signature(cv.G2_GEN)


_BACKENDS: dict[str, object] = {"python": PythonBackend(), "fake": FakeBackend()}
_active_backend = None


def register_backend(name: str, backend) -> None:
    _BACKENDS[name] = backend


def _load_torch_backend():
    from ..torchbls.backend import TorchBackend

    backend = TorchBackend()
    register_backend("torch", backend)
    return backend


def _load_hybrid_backend():
    """Host/device routing policy (crypto/bls/hybrid.py): urgent or tiny
    verifies ride the host path while the card is cold, absent, or over
    its latency budget. Constructing it touches no device."""
    from .hybrid import HybridBackend

    backend = HybridBackend()
    register_backend("hybrid", backend)
    return backend


def available_backends() -> list[str]:
    return sorted(set(_BACKENDS) | {"torch", "hybrid"})


def set_backend(name: str):
    global _active_backend
    if name == "torch" and "torch" not in _BACKENDS:
        _load_torch_backend()
    if name == "hybrid" and "hybrid" not in _BACKENDS:
        _load_hybrid_backend()
    if name not in _BACKENDS:
        raise ValueError(f"unknown BLS backend {name!r}; have {available_backends()}")
    _active_backend = _BACKENDS[name]
    return _active_backend


def get_backend():
    """The active backend; at first use the one LIGHTHOUSE_TPU_BLS_BACKEND
    names, "torch" by default (the reference's default is its host
    backend, "python"; the port's entry points run on the card)."""
    if _active_backend is None:
        set_backend(os.environ.get("LIGHTHOUSE_TPU_BLS_BACKEND", "torch"))
    return _active_backend


# ----------------------------------------------------------------- operations


def sign(sk: SecretKey, message: bytes) -> Signature:
    backend_sign = getattr(get_backend(), "sign", None)
    if backend_sign is not None:
        return backend_sign(sk, message)
    return Signature(cv.g2_mul(hash_to_g2_point(message), sk.scalar))


def verify(pk: PublicKey, message: bytes, signature: Signature) -> bool:
    return get_backend().verify_single(pk, message, signature)


def aggregate_verify(pks: Sequence[PublicKey], messages: Sequence[bytes], signature: Signature) -> bool:
    """Distinct-message aggregate verification (IETF AggregateVerify)."""
    if len(pks) != len(messages) or not pks:
        return False
    if signature.is_infinity():
        return False
    return get_backend().aggregate_verify(pks, messages, signature)


def fast_aggregate_verify(pks: Sequence[PublicKey], message: bytes, signature: Signature) -> bool:
    """Same-message aggregate verification (IETF FastAggregateVerify)."""
    if not pks:
        return False
    return verify_signature_sets([SignatureSet(signature, pks, message)])


def eth_fast_aggregate_verify(pks: Sequence[PublicKey], message: bytes, signature: Signature) -> bool:
    """Spec variant: empty pubkeys + infinity signature is valid (empty sync
    aggregates)."""
    if not pks and signature.is_infinity():
        return True
    return fast_aggregate_verify(pks, message, signature)


def verify_signature_sets(
    sets: Sequence[SignatureSet],
    rand_fn: Callable[[int], Sequence[int]] | None = None,
) -> bool:
    """Verify a batch of signature sets with one combined pairing check.

    `rand_fn(n)` supplies the n random coefficients (a determinism seam for
    tests). As in blst, an empty batch and any infinity signature are
    deterministic failures."""
    sets = list(sets)
    if not sets:
        return False
    if any(s.signature.is_infinity() for s in sets):
        return False
    return get_backend().verify_signature_sets(sets, _coefficients(sets, rand_fn))


def _coefficients(sets, rand_fn) -> list[int]:
    rands = (rand_fn or _default_rands)(len(sets))
    if len(rands) != len(sets):
        raise ValueError("rand_fn returned wrong number of coefficients")
    if any(z % R == 0 for z in rands):
        raise ValueError("batch verification coefficients must be nonzero")
    return rands


class _ReadyHandle:
    """A handle that is already resolved: a batch that fails before any
    backend sees it, or the fake backend's verdict."""

    __slots__ = ("_value",)

    def __init__(self, value: bool):
        self._value = value

    def result(self) -> bool:
        return self._value


def verify_signature_sets_async(
    sets: Sequence[SignatureSet],
    rand_fn: Callable[[int], Sequence[int]] | None = None,
):
    """Submit a batch for verification; returns a handle whose .result()
    blocks for the verdict. On the torch backend the batch rides the
    pipelined dispatcher, so the card works on it while the caller marshals
    the next batch."""
    sets = list(sets)
    if not sets or any(s.signature.is_infinity() for s in sets):
        return _ReadyHandle(False)
    return get_backend().verify_signature_sets_async(sets, _coefficients(sets, rand_fn))
