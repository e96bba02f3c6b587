"""Batched hash-to-G2 in PyTorch (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_).

Host: expand_message_xmd with SHA-256 and the hash_to_field reduction
(Python bigints). Device: simplified SWU with a single-exponentiation
sqrt_ratio (branch-free candidate selects), the 3-isogeny in projective
form, a Jacobian add and psi-based cofactor clearing — the formulas of the
JAX package's h2c_ops, so the Jacobian outputs agree bit for bit.

These are the plain versions; the backend's h2c stage, kernels.hash_to_g2,
routes CUDA tensors to the hand-written kernel csrc/h2c.cu, which follows
these formulas term for term wherever the result is a point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bls381 import fields as pyf
from ..bls381 import hash_to_curve as ph2c
from ..bls381.constants import P
from . import curve_ops as co
from . import limbs as lb
from . import tower as tw

Q = P * P  # order of Fq2

_ISO_A = tw._fq2_const_np(ph2c.ISO_A)
_ISO_B = tw._fq2_const_np(ph2c.ISO_B)
_ISO_Z = tw._fq2_const_np(ph2c.ISO_Z)
_NEG_A = tw._fq2_const_np(pyf.fq2_neg(ph2c.ISO_A))
_ZA = tw._fq2_const_np(pyf.fq2_mul(ph2c.ISO_Z, ph2c.ISO_A))

# sqrt_ratio exponent: s = u * v^7 * (u * v^15)^E with E = (q-9)/16 gives
# s^2 = omega * u/v for an 8th root of unity omega.
_E = (Q - 9) // 16

# Candidate corrections y = s*c: c^2 = 1/omega for omega in the 4th roots
# of unity (QR cases), c^2 = Z/omega for the primitive 8th roots (non-QR).
_I = (0, 1)
_RHO = pyf.fq2_sqrt(_I)
_QR_OMEGAS = [(1, 0), ((-1) % P, 0), _I, (0, (-1) % P)]
_NQR_OMEGAS = [_RHO, pyf.fq2_mul(_RHO, _I), pyf.fq2_neg(_RHO), pyf.fq2_mul(_RHO, (0, (-1) % P))]
_CANDS = [pyf.fq2_sqrt(pyf.fq2_inv(w)) for w in _QR_OMEGAS] + [
    pyf.fq2_sqrt(pyf.fq2_mul(ph2c.ISO_Z, pyf.fq2_inv(w))) for w in _NQR_OMEGAS
]
_CAND_CONSTS = np.stack([tw._fq2_const_np(c) for c in _CANDS])


def _poly4(coeffs):
    cs = list(coeffs) + [(0, 0)] * (4 - len(coeffs))
    return np.stack([tw._fq2_const_np(c) for c in cs])


# Isogeny coefficients: 4 polynomials x 4 coefficients (padded) in the
# shared monomial basis [xd^3, xn*xd^2, xn^2*xd, xn^3].
_ISO_K = np.stack([_poly4(ph2c.X_NUM), _poly4(ph2c.X_DEN), _poly4(ph2c.Y_NUM), _poly4(ph2c.Y_DEN)])


def _c(arr, like):
    return lb.const(arr, like).expand(like.shape)


def fq2_sgn0(a):
    """RFC 9380 sgn0 for Fq2 (needs standard form for parity)."""
    std = lb.from_mont(a)
    s0 = std[..., 0, 0] & 1
    z0 = (std[..., 0, :] == 0).all(dim=-1)
    s1 = std[..., 1, 0] & 1
    return s0 | (z0.to(s1.dtype) & s1)


def fq2_sqrt_ratio(u, v):
    """sqrt_ratio for Fq2 (q = p^2 = 9 mod 16). Returns (is_qr, y):
    y^2 * v == u if is_qr else y^2 * v == Z * u."""
    v2 = tw.fq2_sqr(v)
    v4 = tw.fq2_sqr(v2)
    v8 = tw.fq2_sqr(v4)
    v7 = tw.fq2_mul(v4, tw.fq2_mul(v2, v))
    v15 = tw.fq2_mul(v8, v7)
    uv15 = tw.fq2_mul(u, v15)
    s = tw.fq2_mul(tw.fq2_mul(u, v7), tw.fq2_pow_static(uv15, _E))

    ys = tw.fq2_mul(s[..., None, :, :], lb.const(_CAND_CONSTS, s))   # (..., 8, 2, NL)
    checks = tw.fq2_mul(tw.fq2_sqr(ys), v[..., None, :, :])            # y^2 * v
    zu = tw.fq2_mul(_c(_ISO_Z, u), u)
    ok_qr = tw.fq2_eq(checks[..., :4, :, :], u[..., None, :, :])
    ok_nqr = tw.fq2_eq(checks[..., 4:, :, :], zu[..., None, :, :])
    ok = torch.cat([ok_qr, ok_nqr], dim=-1)                             # (..., 8)
    # the first matching candidate
    y = torch.zeros_like(u)
    found = torch.zeros_like(ok[..., 0])
    for i in range(8):
        y = tw.fq2_select(ok[..., i] & ~found, ys[..., i, :, :], y)
        found = found | ok[..., i]
    return ok_qr.any(dim=-1), y


def sswu_projective(u):
    """Simplified SWU map to E2' (branch-free). u: (..., 2, NL) Montgomery.
    Returns (xn, xd, y): affine x = xn/xd on E2', y affine."""
    Z, A, B = _c(_ISO_Z, u), _c(_ISO_A, u), _c(_ISO_B, u)
    u2 = tw.fq2_sqr(u)
    tv1 = tw.fq2_mul(Z, u2)
    tv2 = tw.fq2_add(tw.fq2_sqr(tv1), tv1)
    x1n = tw.fq2_mul(B, tw.fq2_add(tv2, tw.one_like(tw.FQ2_ONE, u)))
    xd = tw.fq2_mul(_c(_NEG_A, u), tv2)
    xd = tw.fq2_select(tw.fq2_is_zero(xd), _c(_ZA, u), xd)

    xd2 = tw.fq2_sqr(xd)
    xd3 = tw.fq2_mul(xd2, xd)
    gx1 = tw.fq2_mul(tw.fq2_add(tw.fq2_sqr(x1n), tw.fq2_mul(A, xd2)), x1n)
    gx1 = tw.fq2_add(gx1, tw.fq2_mul(B, xd3))
    is_qr, y1 = fq2_sqrt_ratio(gx1, xd3)

    x2n = tw.fq2_mul(tv1, x1n)
    y2 = tw.fq2_mul(tw.fq2_mul(Z, tw.fq2_mul(u2, u)), y1)
    xn = tw.fq2_select(is_qr, x1n, x2n)
    y = tw.fq2_select(is_qr, y1, y2)
    flip = fq2_sgn0(y) != fq2_sgn0(u)                  # sgn0(y) == sgn0(u)
    return xn, xd, tw.fq2_select(flip, tw.fq2_neg(y), y)


def iso_map_jacobian(xn, xd, y):
    """3-isogeny E2' -> E2 on x = xn/xd, output Jacobian (X, Y, Z): all four
    polynomials in one batched fq2_mul against [xd^3, xn*xd^2, xn^2*xd, xn^3]."""
    xd2 = tw.fq2_sqr(xd)
    xn2 = tw.fq2_sqr(xn)
    m = torch.stack(
        [tw.fq2_mul(xd2, xd), tw.fq2_mul(xn, xd2), tw.fq2_mul(xn2, xd), tw.fq2_mul(xn2, xn)],
        dim=-3,
    )                                                           # (..., 4, 2, NL)
    terms = tw.fq2_mul(lb.const(_ISO_K, m), m[..., None, :, :, :])  # (..., 4, 4, 2, NL)
    sums = lb.add_mod(
        lb.add_mod(terms[..., 0, :, :], terms[..., 1, :, :]),
        lb.add_mod(terms[..., 2, :, :], terms[..., 3, :, :]),
    )                                     # x_num, x_den, y_num, y_den (all * xd^3)
    xo_n, xo_d, yo_d = sums[..., 0, :, :], sums[..., 1, :, :], sums[..., 3, :, :]
    yo_n = tw.fq2_mul(y, sums[..., 2, :, :])
    Zj = tw.fq2_mul(xo_d, yo_d)
    X = tw.fq2_mul(tw.fq2_mul(xo_n, xo_d), tw.fq2_sqr(yo_d))
    Y = tw.fq2_mul(tw.fq2_mul(yo_n, tw.fq2_sqr(xo_d)), tw.fq2_mul(xo_d, tw.fq2_sqr(yo_d)))
    return (X, Y, Zj)


def map_to_g2(u0, u1):
    """Two field elements per message -> Jacobian point in G2 (SSWU +
    isogeny on both in one batched pass, add, clear cofactor)."""
    xn, xd, y = sswu_projective(torch.stack([u0, u1], dim=0))
    q = iso_map_jacobian(xn, xd, y)
    r = co.jac_add(tuple(c[0] for c in q), tuple(c[1] for c in q), co.FQ2_OPS)
    return co.clear_cofactor_g2(r)


def hash_to_field_batch(messages, dst: bytes) -> np.ndarray:
    """Host: messages -> (n, 2, 2, NL) uint32 STANDARD-form limbs of the
    u-values (the device converts them to Montgomery form)."""
    out = np.zeros((len(messages), 2, 2, lb.NL), np.uint32)
    for i, msg in enumerate(messages):
        for j, u in enumerate(ph2c.hash_to_field_fq2(msg, 2, dst)):
            out[i, j, 0] = lb.pack(u[0])
            out[i, j, 1] = lb.pack(u[1])
    return out
