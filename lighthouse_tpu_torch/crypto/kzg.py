"""KZG commitments / blob proofs (EIP-4844) on the shared BLS12-381 core.

Parity surface: lighthouse/crypto/kzg (c-kzg wrapper): trusted-setup
loading, blob_to_kzg_commitment, compute/verify_blob_kzg_proof and the
batch verifier (src/lib.rs:47-81). The pairing / G1 arithmetic is the SAME
code path the BLS backend uses (bls381 + torchbls) — the north star's
"blob proofs reuse the pairing kernel".

Scalar-field (Fr) polynomial math runs host-side (barycentric evaluation is
a few thousand bigint ops); the group operations dispatch to the ACTIVE BLS
backend when it exposes accelerated primitives — the torch backend
implements `g1_msm` (csrc/msm.cu's varying-base kernel), `g1_msm_fixed`
(its comb-table kernels) and `pairing_product_is_one` (the same pairing
stage the signature verifier runs) — and fall back to the pure-Python
curve/pairing layer otherwise (e.g. under the "python" backend).

Trusted setup: the production ceremony file (JSON with g1_lagrange /
g2_monomial points) loads via `TrustedSetup.from_json`. For tests,
`TrustedSetup.insecure_dev_setup(n)` derives one from a known tau — NEVER
for production (tau is public!).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from .bls381 import curve as cv
from .bls381 import pairing as pr
from .bls381 import serde
from .bls381.constants import R

BYTES_PER_FIELD_ELEMENT = 32
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_DOMAIN = b"RCKZGBATCH___V1_"

# Fr primitive root of unity for power-of-two subgroups: 7 is a generator
# of Fr*; omega_n = 7^((r-1)/n).
_FR_GENERATOR = 7


class KzgError(Exception):
    pass


def _fr_roots_of_unity(n: int) -> list[int]:
    assert (R - 1) % n == 0
    omega = pow(_FR_GENERATOR, (R - 1) // n, R)
    roots = [1] * n
    for i in range(1, n):
        roots[i] = roots[i - 1] * omega % R
    # bit-reversal permutation (c-kzg stores roots bit-reversed)
    bits = (n - 1).bit_length()
    return [roots[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)]


@dataclass
class TrustedSetup:
    g1_lagrange: list          # n G1 affine points (bit-reversed order)
    g2_monomial: list          # >=2 G2 affine points: [H, tau*H, ...]
    roots: list                # n roots of unity, bit-reversed

    @property
    def n(self) -> int:
        return len(self.g1_lagrange)

    @classmethod
    def from_json(cls, text: str) -> "TrustedSetup":
        data = json.loads(text)
        g1 = [serde.g1_decompress(bytes.fromhex(p.removeprefix("0x")))
              for p in data["g1_lagrange"]]
        g2 = [serde.g2_decompress(bytes.fromhex(p.removeprefix("0x")))
              for p in data["g2_monomial"]]
        return cls(g1_lagrange=g1, g2_monomial=g2, roots=_fr_roots_of_unity(len(g1)))

    @classmethod
    def insecure_dev_setup(cls, n: int = 64) -> "TrustedSetup":
        """Deterministic setup from a KNOWN tau — testing only."""
        lis, tau = cls.dev_setup_scalars(n)
        g1 = [cv.g1_mul(cv.G1_GEN, li) for li in lis]
        g2 = [cv.G2_GEN, cv.g2_mul(cv.G2_GEN, tau)]
        return cls(g1_lagrange=g1, g2_monomial=g2, roots=_fr_roots_of_unity(n))

    @classmethod
    def dev_setup_scalars(cls, n: int) -> tuple[list[int], int]:
        """(lagrange-basis scalars at tau, tau) for the insecure dev setup —
        lets callers with a batched device scalar-mul (bench.py) build the
        big setup without n host point multiplications.
        L_i(tau) = (tau^n - 1) * w_i / (n * (tau - w_i)) over the
        bit-reversed domain. NEVER for production (tau is public)."""
        tau = int.from_bytes(hashlib.sha256(b"lighthouse-tpu-dev-tau").digest(), "big") % R
        roots = _fr_roots_of_unity(n)
        tau_n = pow(tau, n, R)
        denom_invs = _fr_batch_inverse([n * (tau - w) % R for w in roots])
        return [(tau_n - 1) * w % R * dinv % R for w, dinv in zip(roots, denom_invs)], tau


# ------------------------------------------------------------ blob handling


def blob_to_polynomial(blob: bytes, setup: TrustedSetup) -> list[int]:
    n = setup.n
    if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob must be {n*32} bytes")
    out = []
    for i in range(n):
        fe = int.from_bytes(blob[i * 32 : (i + 1) * 32], "big")
        if fe >= R:
            raise KzgError("blob field element out of range")
        out.append(fe)
    return out


def _fr_batch_inverse(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: ONE field exponentiation + 3(n-1)
    multiplications for n inverses (vs n exponentiations) — the same trick
    c-kzg uses; this is what keeps barycentric evaluation of a 4096-element
    blob at ~milliseconds host-side. Zero entries map to zero."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x % R else 1) % R
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        x = xs[i] % R
        if x:
            out[i] = inv_all * prefix[i] % R
            inv_all = inv_all * x % R
    return out


def _evaluate_polynomial_in_evaluation_form(poly: list[int], z: int, setup: TrustedSetup) -> int:
    """Barycentric evaluation over the bit-reversed domain."""
    n = setup.n
    for i, w in enumerate(setup.roots):
        if z == w:
            return poly[i]
    # p(z) = (z^n - 1)/n * sum_i p_i * w_i / (z - w_i)
    invs = _fr_batch_inverse([(z - w) % R for w in setup.roots])
    total = 0
    for p_i, w, inv in zip(poly, setup.roots, invs):
        total = (total + p_i * w % R * inv) % R
    return total * (pow(z, n, R) - 1) % R * pow(n, R - 2, R) % R


def _compute_quotient_eval_form(poly, z: int, y: int, setup: TrustedSetup) -> list[int]:
    """q_i = (p_i - y) / (w_i - z) on the domain (z not in domain assumed
    handled by caller special-case)."""
    n = setup.n
    q = [0] * n
    inverses = _fr_batch_inverse([(w - z) % R for w in setup.roots])
    special = None
    for i, w in enumerate(setup.roots):
        if w == z:
            special = i
    if special is None:
        for i in range(n):
            q[i] = (poly[i] - y) * inverses[i] % R
        return q
    # z on domain: classic c-kzg special-case
    for i in range(n):
        if i == special:
            continue
        q[i] = (poly[i] - y) * inverses[i] % R
    acc = 0
    wz = setup.roots[special]
    denom_invs = _fr_batch_inverse([(wz - w) % R * wz % R for w in setup.roots])
    for i in range(n):
        if i == special:
            continue
        w = setup.roots[i]
        term = (poly[i] - y) * w % R * denom_invs[i] % R
        acc = (acc + term) % R
    q[special] = acc
    return q


def _g1_lincomb(points, scalars, fixed_base: bool = False) -> object:
    """MSM sum(scalars[i] * points[i]); dispatches to the active BLS backend
    if it exposes an accelerated MSM, else host-side.

    fixed_base=True marks a STABLE point set (the setup's Lagrange basis —
    identical list object every call): the backend may then build and cache
    per-point comb tables (torchbls/msm.py). Never set it for per-call
    varying points — the one-time table build would be paid every call."""
    from .bls import api as bls_api

    backend = bls_api.get_backend()
    if fixed_base and len(points) >= 256:
        msm_fixed = getattr(backend, "g1_msm_fixed", None)
        if msm_fixed is not None:
            return msm_fixed(points, scalars)
    msm = getattr(backend, "g1_msm", None)
    if msm is not None:
        return msm(points, scalars)
    acc = None
    for pt, s in zip(points, scalars):
        if s == 0 or pt is None:
            continue
        acc = cv.g1_add(acc, cv.g1_mul(pt, s))
    return acc


def _pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 via the active BLS backend's pairing kernel
    when available (the torch backend's device pairing stage), else the
    pure-Python pairing."""
    from .bls import api as bls_api

    backend = bls_api.get_backend()
    check = getattr(backend, "pairing_product_is_one", None)
    if check is not None:
        return check(pairs)
    return pr.multi_pairing_is_one(pairs)


# ------------------------------------------------------------ public API


def blob_to_kzg_commitment(blob: bytes, setup: TrustedSetup):
    poly = blob_to_polynomial(blob, setup)
    return _g1_lincomb(setup.g1_lagrange, poly, fixed_base=True)


def _hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


def compute_challenge(blob: bytes, commitment_bytes: bytes, setup: TrustedSetup) -> int:
    """Deneb compute_challenge: domain || degree_poly (16-byte big-endian
    FIELD_ELEMENTS_PER_BLOB) || blob || commitment. With a production 4096-
    element setup this transcript is byte-identical to c-kzg's."""
    degree = setup.n.to_bytes(16, "big")
    return _hash_to_bls_field(FIAT_SHAMIR_PROTOCOL_DOMAIN + degree + blob + commitment_bytes)


def compute_kzg_proof(blob: bytes, z: int, setup: TrustedSetup):
    """Returns (proof_point, y)."""
    poly = blob_to_polynomial(blob, setup)
    y = _evaluate_polynomial_in_evaluation_form(poly, z, setup)
    q = _compute_quotient_eval_form(poly, z, y, setup)
    return _g1_lincomb(setup.g1_lagrange, q, fixed_base=True), y


def compute_blob_kzg_proof(blob: bytes, commitment_bytes: bytes, setup: TrustedSetup):
    z = compute_challenge(blob, commitment_bytes, setup)
    proof, _y = compute_kzg_proof(blob, z, setup)
    return proof


def verify_kzg_proof(commitment, z: int, y: int, proof, setup: TrustedSetup) -> bool:
    """e(P - y*G1, H) == e(W, tau*H - z*H)  <=>
       e(P - y*G1, H) * e(-W, (tau - z)*H) == 1."""
    p_min_y = cv.g1_add(commitment, cv.g1_neg(cv.g1_mul(cv.G1_GEN, y)))
    tau_min_z = cv.g2_add(setup.g2_monomial[1], cv.g2_neg(cv.g2_mul(cv.G2_GEN, z)))
    return _pairing_product_is_one(
        [(p_min_y, cv.G2_GEN), (cv.g1_neg(proof), tau_min_z)]
    )


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes, proof_bytes: bytes, setup: TrustedSetup) -> bool:
    commitment = serde.g1_decompress(commitment_bytes)
    proof = serde.g1_decompress(proof_bytes)
    z = compute_challenge(blob, commitment_bytes, setup)
    poly = blob_to_polynomial(blob, setup)
    y = _evaluate_polynomial_in_evaluation_form(poly, z, setup)
    return verify_kzg_proof(commitment, z, y, proof, setup)


def verify_blob_kzg_proof_batch(blobs, commitments_bytes, proofs_bytes, setup: TrustedSetup) -> bool:
    """Batch verification with a random linear combination collapsing all
    blobs into ONE two-pairing check (crypto/kzg verify_blob_kzg_proof_batch
    analog — and the same shape the device pairing stage consumes)."""
    n = len(blobs)
    if not (n == len(commitments_bytes) == len(proofs_bytes)):
        raise KzgError("length mismatch")
    if n == 0:
        return True
    commitments = [serde.g1_decompress(c) for c in commitments_bytes]
    proofs = [serde.g1_decompress(p) for p in proofs_bytes]
    zs, ys = [], []
    for blob, cb in zip(blobs, commitments_bytes):
        z = compute_challenge(blob, cb, setup)
        poly = blob_to_polynomial(blob, setup)
        zs.append(z)
        ys.append(_evaluate_polynomial_in_evaluation_form(poly, z, setup))

    # r powers per deneb compute_r_powers: domain || degree_poly (8-byte BE)
    # || num_blobs (8-byte BE) || per-blob (commitment || z || y || proof)
    transcript = RANDOM_CHALLENGE_DOMAIN + setup.n.to_bytes(8, "big") + n.to_bytes(8, "big")
    for cb, z, y, pb in zip(commitments_bytes, zs, ys, proofs_bytes):
        transcript += cb + z.to_bytes(32, "big") + y.to_bytes(32, "big") + pb
    r = _hash_to_bls_field(transcript)
    r_pows = [pow(r, i, R) for i in range(n)]

    # C' = sum r^i (C_i - y_i G1 + z_i W_i); W' = sum r^i W_i
    # check e(C', H) * e(-W', tau H) == 1
    c_terms = []
    c_scalars = []
    for i in range(n):
        c_terms.append(commitments[i])
        c_scalars.append(r_pows[i])
        c_terms.append(cv.G1_GEN)
        c_scalars.append((-ys[i] * r_pows[i]) % R)
        c_terms.append(proofs[i])
        c_scalars.append(zs[i] * r_pows[i] % R)
    c_prime = _g1_lincomb(c_terms, c_scalars)
    w_prime = _g1_lincomb(proofs, r_pows)
    if w_prime is None:
        return False
    return _pairing_product_is_one(
        [(c_prime, cv.G2_GEN), (cv.g1_neg(w_prime), setup.g2_monomial[1])]
    )
