"""Batched G1/G2 group ops in PyTorch: Jacobian coordinates over the tower.

Points are tuples (X, Y, Z) with the identity encoded as Z == 0 and carried
as (one, one, zero); coordinates are Fq limb tensors (G1) or Fq2 pairs (G2)
in Montgomery form. The formulas and the select semantics of jac_add are
those of the JAX package's curve_ops, so Jacobian outputs agree bit for bit
(field results are exact, so only the formulas and the order of point
sums decide the representation).
"""

from __future__ import annotations

import torch

from ..bls381 import curve as pc
from ..bls381.constants import X_ABS
from . import limbs as lb
from . import tower as tw


class _Ops:
    """Field-generic namespace so G1 (Fq) and G2 (Fq2) share point formulas.
    `elem_dims` is the number of trailing dims of one field element."""

    def __init__(self, *, elem_dims, one_np, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        self.elem_dims = elem_dims
        self.one_np = one_np

    def one(self, like):
        """The field's unit, broadcast to the shape of element `like`."""
        return lb.const(self.one_np, like).expand(like.shape)


FQ_OPS = _Ops(
    add=lb.add_mod, sub=lb.sub_mod, mul=lb.mont_mul, sqr=lb.mont_sqr,
    neg=lb.neg_mod, small=lb.mul_small, select=lb.select, inv=lb.mont_inv,
    is_zero=lb.is_zero, elem_dims=1, one_np=tw.FQ_ONE,
)

FQ2_OPS = _Ops(
    add=lb.add_mod, sub=lb.sub_mod, mul=tw.fq2_mul, sqr=tw.fq2_sqr,
    neg=lb.neg_mod, small=lb.mul_small, select=tw.fq2_select, inv=tw.fq2_inv,
    is_zero=tw.fq2_is_zero, elem_dims=2, one_np=tw.FQ2_ONE,
)


def identity_like(ops, like):
    """(one, one, zero) with the shape of the coordinate tensor `like`."""
    one = ops.one(like)
    return (one, one, torch.zeros_like(like))


def pt_select(ops, cond, a, b):
    return tuple(ops.select(cond, x, y) for x, y in zip(a, b))


def _stk(ops, *els):
    """Stack field elements on a lane axis just above the element dims, so
    a point formula's independent products run as one batched multiply."""
    return torch.stack(torch.broadcast_tensors(*els), dim=-1 - ops.elem_dims)


def _lanes(ops, stacked):
    return stacked.unbind(dim=-1 - ops.elem_dims)


def jac_double(p, ops):
    """Identity-safe Jacobian doubling (Z=0 stays Z=0): 8 products in 3
    stacked multiply calls."""
    X, Y, Z = p
    A, B, YZ = _lanes(ops, ops.mul(_stk(ops, X, Y, Y), _stk(ops, X, Y, Z)))
    E = ops.small(A, 3)
    XB = ops.add(X, B)
    C, t, F = _lanes(ops, ops.mul(_stk(ops, B, XB, E), _stk(ops, B, XB, E)))
    D = ops.small(ops.sub(ops.sub(t, A), C), 2)
    X3 = ops.sub(F, ops.small(D, 2))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), ops.small(C, 8))
    return (X3, Y3, ops.small(YZ, 2))


def jac_add(p1, p2, ops):
    """Complete Jacobian addition via selects. Priority, lowest to highest:
    general sum; the doubling of p1 when H == r == 0; the identity when
    H == 0 != r; p2 when p1 is the identity; p1 when p2 is the identity."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1, Z2Z2, Y1Z2, Y2Z1, dB, dYZ = _lanes(ops, ops.mul(
        _stk(ops, Z1, Z2, Y1, Y2, Y1, Y1),
        _stk(ops, Z1, Z2, Z2, Z1, Y1, Z1),
    ))
    dXB = ops.add(X1, dB)
    U1, U2, S1, S2, dA, dC, dt = _lanes(ops, ops.mul(
        _stk(ops, X1, X2, Y1Z2, Y2Z1, X1, dB, dXB),
        _stk(ops, Z2Z2, Z1Z1, Z2Z2, Z1Z1, X1, dB, dXB),
    ))
    H = ops.sub(U2, U1)
    r = ops.sub(S2, S1)
    dE = ops.small(dA, 3)
    HH, rr, Z1Z2, dF = _lanes(ops, ops.mul(_stk(ops, H, r, Z1, dE), _stk(ops, H, r, Z2, dE)))
    dD = ops.small(ops.sub(ops.sub(dt, dA), dC), 2)
    dX3 = ops.sub(dF, ops.small(dD, 2))
    HHH, V, Z3, dY3a = _lanes(ops, ops.mul(
        _stk(ops, H, U1, Z1Z2, dE),
        _stk(ops, HH, HH, H, ops.sub(dD, dX3)),
    ))
    X3 = ops.sub(ops.sub(rr, HHH), ops.small(V, 2))
    rVX3, S1HHH = _lanes(ops, ops.mul(_stk(ops, r, S1), _stk(ops, ops.sub(V, X3), HHH)))
    general = (X3, ops.sub(rVX3, S1HHH), Z3)
    doubled = (dX3, ops.sub(dY3a, ops.small(dC, 8)), ops.small(dYZ, 2))

    h_zero = ops.is_zero(H)
    r_zero = ops.is_zero(r)
    out = pt_select(ops, h_zero & r_zero, doubled, general)
    out = pt_select(ops, h_zero & ~r_zero, identity_like(ops, X3), out)
    out = pt_select(ops, ops.is_zero(Z1), p2, out)
    return pt_select(ops, ops.is_zero(Z2), p1, out)


def affine_to_jac(ops, aff, inf_mask=None):
    """(x, y) affine -> Jacobian; inf_mask (...,) bool marks identity entries."""
    x, y = aff
    one = ops.one(x)
    if inf_mask is None:
        return (x, y, one)
    return (x, y, ops.select(inf_mask, torch.zeros_like(x), one))


def jac_to_affine(p, ops):
    """Jacobian -> affine (x, y, inf_mask); identity lanes invert Z = 1 and
    so keep their X and Y."""
    X, Y, Z = p
    inf = ops.is_zero(Z)
    zinv = ops.inv(ops.select(inf, ops.one(Z), Z))
    zinv2 = ops.sqr(zinv)
    zinv3 = ops.mul(zinv2, zinv)
    return (ops.mul(X, zinv2), ops.mul(Y, zinv3), inf)


def scalar_mul_bits(p_jac, bits, ops):
    """p * k where bits is a (..., nbits) tensor, MSB first: per bit one
    doubling, one addition, and a select of the sum where the bit is set."""
    acc = identity_like(ops, p_jac[0])
    for i in range(bits.shape[-1]):
        acc = jac_double(acc, ops)
        acc = pt_select(ops, bits[..., i] == 1, jac_add(acc, p_jac, ops), acc)
    return acc


def scalar_mul_static(p_jac, k: int, ops):
    """p * k for a static positive int k: double-and-add, adding only on the
    set bits."""
    acc = identity_like(ops, p_jac[0])
    for bit in bin(k)[2:]:
        acc = jac_double(acc, ops)
        if bit == "1":
            acc = jac_add(acc, p_jac, ops)
    return acc


def tree_sum(p_jac, ops):
    """Sum points along the FIRST axis by halving: lane i of each round adds
    lane i + half. The length must be a power of two."""
    n = p_jac[0].shape[0]
    if n & (n - 1):
        raise ValueError("tree_sum needs a power-of-two length")
    while n > 1:
        half = n // 2
        p_jac = jac_add(
            tuple(c[:half] for c in p_jac), tuple(c[half:n] for c in p_jac), ops
        )
        n = half
    return tuple(c[0] for c in p_jac)


def scalar_mul_windowed(p_jac, digits, ops, window: int = 4):
    """p * k for per-lane scalars given as base-2^w digits (..., ndigits),
    MSB first: a table of [0..2^w - 1] * P per lane, then per digit w
    doublings and one add of the digit's entry. The table is built in log
    rounds, j*P = (j//2)*P + (j - j//2)*P, one stacked jac_add per round,
    as the JAX package builds it, so every Jacobian entry has its bits; a
    direct index takes the place of its one-hot gather (the same entry)."""
    nt = 1 << window
    table = [identity_like(ops, p_jac[0]), p_jac]
    while len(table) < nt:
        m = len(table)
        idx = list(range(m, min(2 * (m - 1), nt - 1) + 1))
        A = tuple(torch.stack([table[j // 2][ci] for j in idx]) for ci in range(3))
        B = tuple(torch.stack([table[j - j // 2][ci] for j in idx]) for ci in range(3))
        S = jac_add(A, B, ops)
        for k, _j in enumerate(idx):
            table.append(tuple(S[ci][k] for ci in range(3)))
    table_arr = tuple(torch.stack([t[i] for t in table]) for i in range(3))
    elem = table_arr[0].shape[1 + digits.dim() - 1:]

    def gather(digit):
        index = digit.long().reshape((1,) + digit.shape + (1,) * len(elem))
        index = index.expand((1,) + digit.shape + elem)
        return tuple(torch.gather(c, 0, index)[0] for c in table_arr)

    acc = identity_like(ops, p_jac[0])
    for d in range(digits.shape[-1]):
        for _ in range(window):
            acc = jac_double(acc, ops)
        acc = jac_add(acc, gather(digits[..., d]), ops)
    return acc


def scalars_to_digits(zs, nbits: int, window: int = 4):
    """Host: list of ints -> (n, ceil(nbits / window)) numpy uint32 digit
    array, MSB first."""
    import numpy as np

    nd = (nbits + window - 1) // window
    out = np.zeros((len(zs), nd), np.uint32)
    for i, z in enumerate(zs):
        for j in range(nd):
            out[i, nd - 1 - j] = (z >> (j * window)) & ((1 << window) - 1)
    return out


def masked_tree_sum(p_jac, mask, ops):
    """Sum of the points where mask != 0 along the first axis; masked-out
    entries become the identity before the tree_sum."""
    inf = identity_like(ops, p_jac[0])
    return tree_sum(pt_select(ops, mask != 0, p_jac, inf), ops)


def scalars_to_bits(zs, nbits: int):
    """Host: list of ints -> (n, nbits) numpy bit array, MSB first."""
    import numpy as np

    out = np.zeros((len(zs), nbits), np.uint32)
    for i, z in enumerate(zs):
        for j in range(nbits):
            out[i, nbits - 1 - j] = (z >> j) & 1
    return out


# psi endomorphism + fast G2 cofactor clearing ---------------------------

_PSI_CX = tw._fq2_const_np(pc.PSI_CX)
_PSI_CY = tw._fq2_const_np(pc.PSI_CY)


def psi_jac(p):
    """Untwist-Frobenius-twist endomorphism on Jacobian G2 points:
    (c_x*conj(X), c_y*conj(Y), conj(Z))."""
    X, Y, Z = p
    return (
        tw.fq2_mul(tw.fq2_conj(X), lb.const(_PSI_CX, X)),
        tw.fq2_mul(tw.fq2_conj(Y), lb.const(_PSI_CY, Y)),
        tw.fq2_conj(Z),
    )


def _neg_pt(p, ops):
    X, Y, Z = p
    return (X, ops.neg(Y), Z)


def clear_cofactor_g2(p):
    """h_eff * P via the psi trick: [x^2-x-1]P + [x-1]psi(P) + psi^2(2P)."""
    ops = FQ2_OPS

    def xmul(q):
        return _neg_pt(scalar_mul_static(q, X_ABS, ops), ops)

    t1 = xmul(p)                                       # x P
    t2 = psi_jac(p)
    t3 = psi_jac(psi_jac(jac_double(p, ops)))          # psi^2(2P)
    t3 = jac_add(t3, _neg_pt(t2, ops), ops)
    t2 = xmul(jac_add(t1, t2, ops))                    # x^2 P + x psi(P)
    t3 = jac_add(t3, t2, ops)
    t3 = jac_add(t3, _neg_pt(t1, ops), ops)
    return jac_add(t3, _neg_pt(p, ops), ops)
