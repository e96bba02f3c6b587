"""Pure-Python optimal ate pairing on BLS12-381.

Convention: we compute the *cubed* ate pairing e(P, Q)^3 — the final
exponentiation uses the Hayashida-Hayasaka-Teruya hard-part chain which
computes f^(3*(p^4-p^2+1)/r). Since gcd(3, r) = 1, this is still a
non-degenerate bilinear pairing and all signature verification equations
(which compare products of pairings against 1) are unaffected. blst makes the
same choice (see lighthouse/crypto/bls/src/impls/blst.rs consumers, which
only ever compare pairing products to the identity).

miller_loop takes G1 points in affine (x, y) over Fq and G2 points in affine
over Fq2. Identity inputs are handled by returning 1 for that pair.
"""

from . import fields as f
from .constants import P, R, X_ABS

# Signed binary expansion of X_ABS, most significant bit first (after the
# implicit leading 1). X_ABS = 0xd201000000010000 has low hamming weight.
_X_BITS = bin(X_ABS)[3:]  # skip '0b1'


def _dbl_step(r_pt):
    """Doubling step: returns (2*R, line_eval at P) with R in affine Fq2 coords.

    Ground truth favors clarity: affine doubling with the tangent line
    l(P) = (y_P - lambda * x_P - c) embedded into Fq12 via the twist.
    """
    xr, yr = r_pt
    lam = f.fq2_mul(f.fq2_mul_scalar(f.fq2_sqr(xr), 3), f.fq2_inv(f.fq2_mul_scalar(yr, 2)))
    x3 = f.fq2_sub(f.fq2_sqr(lam), f.fq2_mul_scalar(xr, 2))
    y3 = f.fq2_sub(f.fq2_mul(lam, f.fq2_sub(xr, x3)), yr)
    c = f.fq2_sub(yr, f.fq2_mul(lam, xr))
    return (x3, y3), (lam, c)


def _add_step(r_pt, q_pt):
    xr, yr = r_pt
    xq, yq = q_pt
    lam = f.fq2_mul(f.fq2_sub(yq, yr), f.fq2_inv(f.fq2_sub(xq, xr)))
    x3 = f.fq2_sub(f.fq2_sub(f.fq2_sqr(lam), xr), xq)
    y3 = f.fq2_sub(f.fq2_mul(lam, f.fq2_sub(xr, x3)), yr)
    c = f.fq2_sub(yr, f.fq2_mul(lam, xr))
    return (x3, y3), (lam, c)


def _line_fq12(lam, c, xp, yp):
    """Sparse Fq12 element: line y - lam*x - c through untwisted G2 points,
    evaluated at the G1 point P = (xp, yp), scaled by w^3.

    BLS12-381 uses a D-type twist: a G2 point (X, Y) on E'/Fq2 (y^2 = x^3 +
    4*xi) untwists to (X/w^2, Y/w^3) on E/Fq12 (y^2 = x^3 + 4), since
    w^6 = v^3 = xi. The line through two untwisted points has slope
    lam_12 = lam / w and intercept c_12 = c / w^3 (lam, c computed on E').

    l(P) = yp - (lam/w)*xp - c/w^3. We scale every line by the constant w^3;
    the aggregate extra factor is a power of w^3, and (w^3)^2 = xi lies in
    Fq2, whose units are annihilated by the final exponentiation (the easy
    part contains the factor 2*(p^2 - 1)). Scaled line:

        l' = yp * w^3 - (lam * xp) * w^2 - c
           = -c  +  (-(lam*xp)) * v  +  (yp * v) * w        [w^2 = v, w^3 = v*w]

        c0 (Fq6) = (-c, -(lam*xp), 0)
        c1 (Fq6) = (0, yp, 0)
    """
    c0 = (f.fq2_neg(c), f.fq2_neg(f.fq2_mul_scalar(lam, xp)), f.FQ2_ZERO)
    c1 = (f.FQ2_ZERO, (yp, 0), f.FQ2_ZERO)
    return (c0, c1)


def miller_loop(pairs):
    """Product of Miller loops over [(P_g1_affine, Q_g2_affine), ...].

    Pairs where either element is None (identity) contribute 1.
    """
    result = f.FQ12_ONE
    state = [(p_pt, q_pt, q_pt) for p_pt, q_pt in pairs if p_pt is not None and q_pt is not None]
    if not state:
        return result
    for bit in _X_BITS:
        result = f.fq12_sqr(result)
        new_state = []
        for p_pt, q_pt, r_pt in state:
            r2, (lam, c) = _dbl_step(r_pt)
            result = f.fq12_mul(result, _line_fq12(lam, c, p_pt[0], p_pt[1]))
            if bit == "1":
                r2, (lam, c) = _add_step(r2, q_pt)
                result = f.fq12_mul(result, _line_fq12(lam, c, p_pt[0], p_pt[1]))
            new_state.append((p_pt, q_pt, r2))
        state = new_state

    # x < 0: conjugate the Miller value (Frobenius^6 == inversion in the
    # cyclotomic subgroup, and the unit factors die in final exponentiation).
    result = f.fq12_conj(result)
    return result


def _cyclotomic_exp_abs_x(a):
    """a^|x| for cyclotomic a (plain square-and-multiply; ground truth)."""
    result = f.FQ12_ONE
    base = a
    e = X_ABS
    while e:
        if e & 1:
            result = f.fq12_mul(result, base)
        base = f.fq12_sqr(base)
        e >>= 1
    return result


def _exp_neg_x(a):
    """a^x with x negative: (a^|x|) conjugated (a must be cyclotomic)."""
    return f.fq12_conj(_cyclotomic_exp_abs_x(a))


def final_exponentiation(m):
    """Compute m^(3 * (p^12 - 1) / r) — the cubed pairing's final exp.

    Easy part: m^((p^6 - 1)(p^2 + 1)). Hard part (HHT18 / as used by blst):
    f^(3(p^4-p^2+1)/r) = f^( (x-1)^2 (x+p) (x^2+p^2-1) + 3 ).
    The chain below is verified against integer exponentiation in tests
    (tests/test_bls381_core.py::test_final_exp_chain_matches_integer_pow).
    """
    # Easy part.
    t = f.fq12_mul(f.fq12_conj(m), f.fq12_inv(m))       # m^(p^6 - 1)
    t = f.fq12_mul(f.fq12_frobenius(t, 2), t)            # ^(p^2 + 1)

    # Hard part on cyclotomic element t: t^((x-1)^2 (x+p) (x^2+p^2-1) + 3).
    # y0 = t^(x-1):
    y0 = f.fq12_mul(_exp_neg_x(t), f.fq12_conj(t))       # t^x * t^-1
    # y1 = y0^(x-1):
    y1 = f.fq12_mul(_exp_neg_x(y0), f.fq12_conj(y0))
    # y2 = y1^(x+p) = y1^x * y1^p:
    y2 = f.fq12_mul(_exp_neg_x(y1), f.fq12_frobenius(y1, 1))
    # y3 = y2^(x^2 + p^2 - 1) = (y2^x)^x * y2^(p^2) * y2^-1:
    y3 = f.fq12_mul(
        f.fq12_mul(_exp_neg_x(_exp_neg_x(y2)), f.fq12_frobenius(y2, 2)),
        f.fq12_conj(y2),
    )
    # result = y3 * t^3
    t3 = f.fq12_mul(f.fq12_mul(t, t), t)
    return f.fq12_mul(y3, t3)


def pairing(p_g1, q_g2):
    """Full (cubed) ate pairing e(P, Q)^3 for single points."""
    return final_exponentiation(miller_loop([(p_g1, q_g2)]))


def multi_pairing_is_one(pairs):
    """Check prod_i e(P_i, Q_i) == 1 (shared Miller loop + one final exp)."""
    return final_exponentiation(miller_loop(pairs)) == f.FQ12_ONE
