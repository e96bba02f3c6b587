"""Batched optimal ate pairing in PyTorch: the plain versions of the Miller
loop and the final exponentiation, and the pairing-product check that routes
through the CUDA kernels on the card (kernels.py).

Schedule and line formulas are those of the JAX package's pairing_ops: one
shared accumulator f for all pairs, per bit one fq12_sqr and every pair's
line folded in through a sparse line-pair product tree; lines are scaled by
the Fq2 unit 2YZ^3 (doubling) or Z3 (addition), which the final
exponentiation annihilates. Like the ground truth this computes the CUBED
pairing (the HHT final-exp chain); consensus only compares products to 1.
Masked lanes contribute the identity line (1, 0, 0).
"""

from __future__ import annotations

import torch

from ..bls381.constants import X_ABS
from . import curve_ops as co
from . import limbs as lb
from . import tower as tw

# Bits of X_ABS after the implicit leading 1, MSB first (63 bits).
X_BITS = [int(b) for b in bin(X_ABS)[3:]]


def _dbl_step(r, xp, yp):
    """Jacobian doubling of R (G2) + the tangent line at P = (xp, yp) (G1,
    Montgomery), scaled by 2YZ^3. Returns (R2, (l0, l1, l2)) with
    l(P) = l0 + l1*v + l2*v*w. rounds.dbl_step restates it term for term
    for csrc/miller.cu; tests/test_torch_rounds.py holds the two together,
    so change both."""
    X, Y, Z = r
    A = tw.fq2_sqr(X)
    B = tw.fq2_sqr(Y)
    C = tw.fq2_sqr(B)
    t = tw.fq2_sqr(tw.fq2_add(X, B))
    D = tw.fq2_mul_small(tw.fq2_sub(tw.fq2_sub(t, A), C), 2)
    E = tw.fq2_mul_small(A, 3)
    F = tw.fq2_sqr(E)
    X3 = tw.fq2_sub(F, tw.fq2_mul_small(D, 2))
    Y3 = tw.fq2_sub(tw.fq2_mul(E, tw.fq2_sub(D, X3)), tw.fq2_mul_small(C, 8))
    ZZ = tw.fq2_sqr(Z)
    Z3 = tw.fq2_mul_small(tw.fq2_mul(Y, Z), 2)
    # l0 = 3X^3 - 2Y^2 ; l1 = -3 X^2 Z^2 * xp ; l2 = Z3 * Z^2 * yp
    l0 = tw.fq2_sub(tw.fq2_mul(E, X), tw.fq2_mul_small(B, 2))
    l1 = tw.fq2_mul_fq(tw.fq2_neg(tw.fq2_mul(E, ZZ)), xp)
    l2 = tw.fq2_mul_fq(tw.fq2_mul(Z3, ZZ), yp)
    return (X3, Y3, Z3), (l0, l1, l2)


def _add_step(r, q_aff, xp, yp):
    """Mixed Jacobian + affine addition R + Q and the line through R, Q at
    P, scaled by Z3 = Z1*H. rounds.add_step restates it term for term for
    csrc/miller.cu; tests/test_torch_rounds.py holds the two together, so
    change both."""
    X1, Y1, Z1 = r
    xq, yq = q_aff
    Z1Z1 = tw.fq2_sqr(Z1)
    U2 = tw.fq2_mul(xq, Z1Z1)
    S2 = tw.fq2_mul(tw.fq2_mul(yq, Z1), Z1Z1)
    H = tw.fq2_sub(U2, X1)
    rr = tw.fq2_sub(S2, Y1)
    HH = tw.fq2_sqr(H)
    HHH = tw.fq2_mul(H, HH)
    V = tw.fq2_mul(X1, HH)
    X3 = tw.fq2_sub(tw.fq2_sub(tw.fq2_sqr(rr), HHH), tw.fq2_mul_small(V, 2))
    Y3 = tw.fq2_sub(tw.fq2_mul(rr, tw.fq2_sub(V, X3)), tw.fq2_mul(Y1, HHH))
    Z3 = tw.fq2_mul(Z1, H)
    l0 = tw.fq2_sub(tw.fq2_mul(rr, xq), tw.fq2_mul(yq, Z3))
    l1 = tw.fq2_mul_fq(tw.fq2_neg(rr), xp)
    l2 = tw.fq2_mul_fq(Z3, yp)
    return (X3, Y3, Z3), (l0, l1, l2)


def _line_to_fq12(line):
    l0, l1, l2 = line
    z = torch.zeros_like(l0)
    return torch.stack(
        [torch.stack([l0, l1, z], dim=-3), torch.stack([z, l2, z], dim=-3)], dim=-4
    )


def _line_mul_line(la, lb_):
    """Product of two sparse 014 lines -> dense Fq12: 6 Fq2 products in one
    batched fq2_mul (Karatsuba cross terms)."""
    l0, l1, l2 = la
    m0, m1, m2 = lb_
    A = torch.stack([l0, l1, l2, tw.fq2_add(l0, l1), tw.fq2_add(l0, l2), tw.fq2_add(l1, l2)], dim=-3)
    B = torch.stack([m0, m1, m2, tw.fq2_add(m0, m1), tw.fq2_add(m0, m2), tw.fq2_add(m1, m2)], dim=-3)
    t = tw.fq2_mul(A, B)
    p00, p11, p22 = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    s01, s02, s12 = t[..., 3, :, :], t[..., 4, :, :], t[..., 5, :, :]
    lo = torch.stack(
        [tw.fq2_add(p00, tw.fq2_mul_by_xi(p22)), tw.fq2_sub(tw.fq2_sub(s01, p00), p11), p11],
        dim=-3,
    )
    hi = torch.stack(
        [torch.zeros_like(p00), tw.fq2_sub(tw.fq2_sub(s02, p00), p22),
         tw.fq2_sub(tw.fq2_sub(s12, p11), p22)],
        dim=-3,
    )
    return torch.stack([lo, hi], dim=-4)


def _set_lane0(fs, folded):
    out = fs.clone()
    out[0] = folded[0]
    return out


def fq12_product_any(fs):
    """Tree product over the first axis, any length >= 1 (an odd straggler
    is folded into lane 0)."""
    n = fs.shape[0]
    while n > 1:
        half = n // 2
        prod = tw.fq12_mul(fs[:half], fs[half : 2 * half])
        if n % 2:
            prod = _set_lane0(prod, tw.fq12_mul(prod[0:1], fs[2 * half : n]))
        fs = prod
        n = half
    return fs[0]


def _mask_lines(line, valid_mask):
    """Replace invalid lanes with the identity line (1, 0, 0)."""
    l0, l1, l2 = line
    zero = torch.zeros_like(l0)
    return (
        tw.fq2_select(valid_mask, l0, tw.one_like(tw.FQ2_ONE, l0)),
        tw.fq2_select(valid_mask, l1, zero),
        tw.fq2_select(valid_mask, l2, zero),
    )


def _combine_lines(line, valid_mask):
    """All n masked lines -> ONE dense Fq12: pair the lines sparsely, then
    tree-reduce the halved batch."""
    l0, l1, l2 = _mask_lines(line, valid_mask)
    n = l0.shape[0]
    if n == 1:
        return _line_to_fq12((l0, l1, l2))[0]
    half = n // 2
    fs = _line_mul_line(
        (l0[:half], l1[:half], l2[:half]),
        (l0[half : 2 * half], l1[half : 2 * half], l2[half : 2 * half]),
    )
    if n % 2:
        fs = _set_lane0(fs, tw.fq12_mul_by_014(fs[0:1], l0[n - 1 : n], l1[n - 1 : n], l2[n - 1 : n]))
    return fq12_product_any(fs)


def miller_loop_product(p_aff, q_aff, valid_mask):
    """Multi-pairing Miller loop with ONE shared accumulator f over n affine
    pairs (G1 (n, NL) x2, G2 (n, 2, NL) x2, mask (n,) bool). Returns the
    Miller value prod_i f_i as one Fq12 (conjugated for x < 0)."""
    xp, yp = p_aff
    xq, yq = q_aff
    r = co.affine_to_jac(co.FQ2_OPS, (xq, yq))
    f = lb.const(tw.FQ12_ONE, xp)
    for bit in X_BITS:
        f = tw.fq12_sqr(f)
        r, line = _dbl_step(r, xp, yp)
        f = tw.fq12_mul(f, _combine_lines(line, valid_mask))
        if bit:
            r, line = _add_step(r, (xq, yq), xp, yp)
            f = tw.fq12_mul(f, _combine_lines(line, valid_mask))
    return tw.fq12_conj(f)


def miller_loop_batch(p_aff, q_aff, valid_mask):
    """Per-pair Miller loop over n affine pairs (the JAX package's
    pairing_ops.miller_loop_batch): each pair keeps its own f_i, squared per
    bit and multiplied by its own lines through the sparse fq12_mul_by_014;
    conjugated for x < 0; masked lanes give 1. Returns (n, 2, 3, 2, NL).
    Conjugation is a ring automorphism, so the tree product of these equals
    miller_loop_product on the same inputs bit for bit."""
    xp, yp = p_aff
    xq, yq = q_aff
    r = co.affine_to_jac(co.FQ2_OPS, (xq, yq))
    one = lb.const(tw.FQ12_ONE, xp).expand((xp.shape[0],) + tw.FQ12_ONE.shape)
    f = one
    for bit in X_BITS:
        f = tw.fq12_sqr(f)
        r, (l0, l1, l2) = _dbl_step(r, xp, yp)
        f = tw.fq12_mul_by_014(f, l0, l1, l2)
        if bit:
            r, (l0, l1, l2) = _add_step(r, (xq, yq), xp, yp)
            f = tw.fq12_mul_by_014(f, l0, l1, l2)
    f = tw.fq12_conj(f)
    keep = (valid_mask != 0).reshape((-1,) + (1,) * 4)
    return torch.where(keep, f, one)


def _exp_neg_x(a):
    """a^x for cyclotomic a (x < 0): Granger-Scott squarings over |x| and a
    final conjugate."""
    acc = a
    for bit in X_BITS:
        acc = tw.fq12_cyclotomic_sqr(acc)
        if bit:
            acc = tw.fq12_mul(acc, a)
    return tw.fq12_conj(acc)


def final_exp_easy_part(m):
    """m^((p^6 - 1)(p^2 + 1))."""
    t = tw.fq12_mul(tw.fq12_conj(m), tw.fq12_inv(m))
    return tw.fq12_mul(tw.fq12_frobenius(t, 2), t)


def final_exp_hard_part(t):
    """The hard part of the HHT chain on an easy-part output t: five
    |x|-exponentiation chains and the Frobenius/conjugate wiring."""
    y0 = tw.fq12_mul(_exp_neg_x(t), tw.fq12_conj(t))
    y1 = tw.fq12_mul(_exp_neg_x(y0), tw.fq12_conj(y0))
    y2 = tw.fq12_mul(_exp_neg_x(y1), tw.fq12_frobenius(y1, 1))
    y3 = tw.fq12_mul(
        tw.fq12_mul(_exp_neg_x(_exp_neg_x(y2)), tw.fq12_frobenius(y2, 2)),
        tw.fq12_conj(y2),
    )
    t3 = tw.fq12_mul(tw.fq12_mul(t, t), t)
    return tw.fq12_mul(y3, t3)


def final_exponentiation(m):
    """m^(3 (p^12 - 1) / r), matching bls381.pairing.final_exponentiation."""
    return final_exp_hard_part(final_exp_easy_part(m))


def pairing_product_is_one(p_aff, q_aff, valid_mask):
    """prod_{i valid} e(P_i, Q_i) == 1 as a 0-dim bool tensor. The Miller
    loop and both parts of the final exponentiation go through kernels.py
    (CUDA kernels for CUDA tensors, these plain versions for CPU ones), each
    its own launch."""
    from . import kernels

    f = kernels.miller_loop_product(p_aff, q_aff, valid_mask)
    f = kernels.final_exp_hard_part(kernels.final_exp_easy_part(f))
    return tw.fq12_eq_one(f)
