"""Team programs: the point steps of csrc/prepare.cu and the hash-to-G2 steps
of csrc/h2c.cu, for one *team* of lanes of a warp (csrc/team.cuh).

A team keeps its state in shared-memory slots of one Fq element each and
runs a program level by level: each level is one list of independent Fq
products of two forms (rounds.FormProgram), one product per lane, and a
__syncwarp of the team's lanes after it; a last pass writes the outputs'
forms into their state slots. A level is the product depth of a formula, so
a G2 doubling is 3 levels of 7 / 6 / 3 Fq products, a general G2 addition 5
levels of 13 / 12 / 7 / 6 / 6, and the sums between them cost no level of
their own: the lane that reads an operand evaluates its form.

The formulas are traced from the point arithmetic of curve_ops (jac_double,
the general case of jac_add) and the hash-to-G2 steps of h2c_ops
(sswu_projective, fq2_sqrt_ratio with its 4-bit windowed a^E, the
isogeny's polynomials and iso_map_jacobian's X, Y, Z, psi). Field results
are exact and fully reduced, so any formula for the same polynomials gives
the plain versions' bits. The branches (jac_add's cases, the xd == 0 select,
sqrt_ratio's first matching candidate, sgn0) are not in the programs: the
kernels take them between programs, uniformly over a team.

`header()` emits the programs into the generated team_programs.cuh, one set
of tables per prefix (TG1: G1 points, TG2: G2 points, TSW: the SWU map and
isogeny of one u-value); tests/test_torch_team.py runs the same tables on
Python integers against the plain versions.
"""

from __future__ import annotations

import functools

from ..bls381 import curve as pc
from ..bls381 import fields as pyf
from ..bls381 import hash_to_curve as ph2c
from ..bls381.constants import P, X_ABS
from . import h2c_ops as h2
from . import limbs as lb
from . import rounds as R

# ------------------------------------------------------------ field shims


class _F1:
    """Fq over tracer nodes."""

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def sqr(a):
        return a * a

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def flat(a):
        return [a]


class _F2:
    """Fq2 over tracer nodes: Karatsuba products (3 Fq products), squares of
    2 (rounds.f2_mul, rounds.f2_sqr)."""

    mul = staticmethod(R.f2_mul)
    sqr = staticmethod(R.f2_sqr)
    add = staticmethod(R.f2_add)
    sub = staticmethod(R.f2_sub)

    @staticmethod
    def flat(a):
        return list(a)


def _dbl(F, a):
    return F.add(a, a)


def _mul3(F, a):
    return F.add(_dbl(F, a), a)


def _mul8(F, a):
    return _dbl(F, _dbl(F, _dbl(F, a)))


def jac_double(p, F):
    """curve_ops.jac_double: A = X^2, B = Y^2, C = B^2, E = 3A,
    D = 2((X + B)^2 - A - C), X3 = E^2 - 2D, Y3 = E (D - X3) - 8C, Z3 = 2YZ."""
    X, Y, Z = p
    A, B, YZ = F.sqr(X), F.sqr(Y), F.mul(Y, Z)
    E = _mul3(F, A)
    C, T, E2 = F.sqr(B), F.sqr(F.add(X, B)), F.sqr(E)
    D = _dbl(F, F.sub(F.sub(T, A), C))
    X3 = F.sub(E2, _dbl(F, D))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), _mul8(F, C))
    return (X3, Y3, _dbl(F, YZ))


def jac_add_general(p1, p2, F):
    """curve_ops.jac_add's general sum, and its H = U2 - U1, R = S2 - S1
    (the kernels branch on them: H = 0 is the doubling or the identity)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1, Z2Z2 = F.sqr(Z1), F.sqr(Z2)
    U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
    S1, S2 = F.mul(F.mul(Y1, Z2), Z2Z2), F.mul(F.mul(Y2, Z1), Z1Z1)
    H, Rr = F.sub(U2, U1), F.sub(S2, S1)
    HH = F.sqr(H)
    HHH, V = F.mul(H, HH), F.mul(U1, HH)
    X3 = F.sub(F.sub(F.sqr(Rr), HHH), _dbl(F, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(Z1, Z2), H)
    return (X3, Y3, Z3), H, Rr


def psi(p, cx, cy, zero):
    """curve_ops.psi_jac: (c_x conj(X), c_y conj(Y), conj(Z))."""
    def conj(a):
        return (a[0], zero - a[1])

    X, Y, Z = p
    return (R.f2_mul(conj(X), cx), R.f2_mul(conj(Y), cy), conj(Z))


# ------------------------------------------------------------ state layouts

AREAS = ("A", "B", "P")            # accumulator (two, alternating), operand
COORDS = {"g1": ("x", "y", "z"), "g2": ("x0", "x1", "y0", "y1", "z0", "z1")}
FLAGS = {"g1": ("h", "r"), "g2": ("h0", "h1", "r0", "r1")}
PSI_CONSTS = ("cx0", "cx1", "cy0", "cy1")


def point_state(g: str) -> list:
    """A point program's slots: the areas A, B, P (X, Y, Z; for G2 each
    coordinate's two Fq components), jac_add's H and R, and for G2 psi's
    coefficients."""
    names = [f"{a}_{c}" for a in AREAS for c in COORDS[g]] + list(FLAGS[g])
    return names + (list(PSI_CONSTS) if g == "g2" else [])


def _point(F, v, area):
    cs = [v[f"{area}_{c}"] for c in COORDS["g1" if F is _F1 else "g2"]]
    if F is _F1:
        return tuple(cs)
    return tuple((cs[2 * k], cs[2 * k + 1]) for k in range(3))


def _program(name, names, build) -> R.FormProgram:
    """A form program over the slots `names`; build(v, zero) returns
    (slot name, node) outputs."""
    if len(set(names)) != len(names):
        raise ValueError(f"{name}: a slot name is given twice")
    t = R.Tracer()
    ins = [t.input(n) for n in names]
    v = dict(zip(names, ins))
    zero = t.input("zero")
    index = {n: k for k, n in enumerate(names)}
    return R.FormProgram(name, t, ins, [(index[n], x) for n, x in build(v, zero)])


def _point_outputs(F, g, area, p):
    flat = [x for c in p for x in F.flat(c)]
    return list(zip([f"{area}_{c}" for c in COORDS[g]], flat))


def point_programs(g: str) -> dict:
    """dbl_XY (2X into Y), add_XY (X + P into Y, with H and R) for the
    accumulator areas X, Y = A, B and B, A; for G2 also psi_XY."""
    F = _F1 if g == "g1" else _F2
    names = point_state(g)
    out = {}
    for src, dst in (("A", "B"), ("B", "A")):
        def dbl(v, zero, src=src, dst=dst):
            return _point_outputs(F, g, dst, jac_double(_point(F, v, src), F))

        def add(v, zero, src=src, dst=dst):
            p, H, Rr = jac_add_general(_point(F, v, src), _point(F, v, "P"), F)
            flags = list(zip(FLAGS[g], F.flat(H) + F.flat(Rr)))
            return _point_outputs(F, g, dst, p) + flags

        out[f"dbl_{src}{dst}"] = _program(f"{g}_dbl_{src}{dst}", names, dbl)
        out[f"add_{src}{dst}"] = _program(f"{g}_add_{src}{dst}", names, add)
        if g == "g2":
            def ps(v, zero, src=src, dst=dst):
                c = (v["cx0"], v["cx1"]), (v["cy0"], v["cy1"])
                return _point_outputs(F, g, dst, psi(_point(F, v, src), *c, zero))

            out[f"psi_{src}{dst}"] = _program(f"g2_psi_{src}{dst}", names, ps)
    return out


# ------------------------------------------------------------ hash to G2

# the 4-bit window digits of sqrt_ratio's exponent E, most significant first
E_DIGITS = lb.window_digits(h2._E, 4)
# the isogeny's nonzero coefficients: polynomial k (x_num, x_den, y_num,
# y_den), monomial j of [xd^3, xn xd^2, xn^2 xd, xn^3]
ISO_TERMS = [(k, j) for k, poly in enumerate((ph2c.X_NUM, ph2c.X_DEN, ph2c.Y_NUM, ph2c.Y_DEN))
             for j in range(len(poly))]


def _f2names(name):
    return [f"{name}0", f"{name}1"]


SW_CONSTS = (["one"] + _f2names("Z") + _f2names("A") + _f2names("B") + _f2names("nA")
             + _f2names("ZA") + [n for c in range(8) for n in _f2names(f"c{c}")]
             + [n for k, j in ISO_TERMS for n in _f2names(f"K{k}{j}")])
SW_VALUES = (["u", "tv1", "x1n", "xd", "zu3", "xd2", "xd3", "gx1", "s0", "zu"]
             + [f"T{d}" for d in range(1, 16)] + ["e"]
             + [f"ys{c}" for c in range(8)] + [f"chk{c}" for c in range(8)]
             + ["y1", "x2n", "y2", "xn", "ysg", "qx", "qy", "qz"])
SW_STATE = SW_CONSTS + [n for name in SW_VALUES for n in _f2names(name)]


def _f2(v, name):
    return (v[f"{name}0"], v[f"{name}1"])


def _out(name, x):
    return [(f"{name}0", x[0]), (f"{name}1", x[1])]


def sw_programs() -> dict:
    """One u-value's hash-to-G2 steps (h2c.cu's map_to_curve), over
    SW_STATE: swu1 (u^2, tv1, tv2, x1n, xd, Z u^3), then the kernel's
    xd == 0 select; swu2 (xd^2, xd^3, gx1, sqrt_ratio's v^15 and
    t = gx1 v^15, s0 = gx1 v^7, zu = Z gx1); table (t^2..t^15 into
    T2..T15), then the kernel's a^E = t^E over E_DIGITS into e (a chain of
    Fq2 squarings and table products in the lanes' registers, team.cuh
    team_fp2_sqr / team_fp2_mul); cands (s = s0 e, the eight candidates
    ys_c = s c and their checks chk_c = ys_c^2 v), then the kernel picks
    the first match; y2x2 (x2n = tv1 x1n, y2 = Z u^3 y1), then the is_qr
    selects (xn, and ysg = y1 or y2) and the sgn0 sign of ysg; iso (the
    isogeny to E2, Jacobian)."""
    F = _F2
    out = {}

    def swu1(v, zero):
        u = _f2(v, "u")
        u2 = F.sqr(u)
        tv1 = F.mul(_f2(v, "Z"), u2)
        tv2 = F.add(F.sqr(tv1), tv1)
        x1n = F.mul(_f2(v, "B"), F.add(tv2, (v["one"], zero)))
        xd = F.mul(_f2(v, "nA"), tv2)
        zu3 = F.mul(_f2(v, "Z"), F.mul(u2, u))
        return _out("tv1", tv1) + _out("x1n", x1n) + _out("xd", xd) + _out("zu3", zu3)

    def swu2(v, zero):
        xd, x1n = _f2(v, "xd"), _f2(v, "x1n")
        xd2 = F.sqr(xd)
        xd3 = F.mul(xd2, xd)
        gx1 = F.mul(F.add(F.sqr(x1n), F.mul(_f2(v, "A"), xd2)), x1n)
        gx1 = F.add(gx1, F.mul(_f2(v, "B"), xd3))
        v2 = F.sqr(xd3)
        v4 = F.sqr(v2)
        v8 = F.sqr(v4)
        v7 = F.mul(v4, F.mul(v2, xd3))
        v15 = F.mul(v8, v7)
        return (_out("xd2", xd2) + _out("xd3", xd3) + _out("gx1", gx1)
                + _out("T1", F.mul(gx1, v15)) + _out("s0", F.mul(gx1, v7))
                + _out("zu", F.mul(_f2(v, "Z"), gx1)))

    def table(v, zero):
        t = {1: _f2(v, "T1")}
        for j in range(2, 16):
            t[j] = F.mul(t[j // 2], t[j - j // 2])
        return [o for j in range(2, 16) for o in _out(f"T{j}", t[j])]

    out["swu1"] = _program("swu1", SW_STATE, swu1)
    out["swu2"] = _program("swu2", SW_STATE, swu2)
    out["table"] = _program("table", SW_STATE, table)

    def cands(v, zero):
        s = F.mul(_f2(v, "s0"), _f2(v, "e"))
        outs = []
        for c in range(8):
            ys = F.mul(s, _f2(v, f"c{c}"))
            outs += _out(f"ys{c}", ys) + _out(f"chk{c}", F.mul(F.sqr(ys), _f2(v, "xd3")))
        return outs

    def y2x2(v, zero):
        return (_out("x2n", F.mul(_f2(v, "tv1"), _f2(v, "x1n")))
                + _out("y2", F.mul(_f2(v, "zu3"), _f2(v, "y1"))))

    def iso(v, zero):
        xn, xd, xd2, xd3, y = (_f2(v, n) for n in ("xn", "xd", "xd2", "xd3", "ysg"))
        xn2 = F.sqr(xn)
        m = [xd3, F.mul(xn, xd2), F.mul(xn2, xd), F.mul(xn2, xn)]
        sums = [None] * 4
        for k, j in ISO_TERMS:
            term = F.mul(_f2(v, f"K{k}{j}"), m[j])
            sums[k] = term if sums[k] is None else F.add(sums[k], term)
        xo_n, xo_d, yo_n, yo_d = sums
        yo_n = F.mul(y, yo_n)
        yod2 = F.sqr(yo_d)
        X = F.mul(F.mul(xo_n, xo_d), yod2)
        Y = F.mul(F.mul(yo_n, F.sqr(xo_d)), F.mul(xo_d, yod2))
        return _out("qx", X) + _out("qy", Y) + _out("qz", F.mul(xo_d, yo_d))

    out["cands"] = _program("cands", SW_STATE, cands)
    out["y2x2"] = _program("y2x2", SW_STATE, y2x2)
    out["iso"] = _program("iso", SW_STATE, iso)
    return out


def sw_constants() -> dict:
    """SW_CONSTS' Montgomery-form values (integers): the unit, Z, A, B, -A,
    Z A, the candidates and the isogeny's nonzero coefficients."""
    def f2(c):
        return [x * lb.R_MONT % P for x in c]

    vals = {"one": lb.R_MONT % P}
    pairs = {"Z": ph2c.ISO_Z, "A": ph2c.ISO_A, "B": ph2c.ISO_B,
             "nA": pyf.fq2_neg(ph2c.ISO_A), "ZA": pyf.fq2_mul(ph2c.ISO_Z, ph2c.ISO_A)}
    pairs.update({f"c{c}": h2._CANDS[c] for c in range(8)})
    polys = (ph2c.X_NUM, ph2c.X_DEN, ph2c.Y_NUM, ph2c.Y_DEN)
    pairs.update({f"K{k}{j}": polys[k][j] for k, j in ISO_TERMS})
    for name, c in pairs.items():
        vals[f"{name}0"], vals[f"{name}1"] = f2(c)
    return vals


def psi_constants() -> dict:
    """PSI_CONSTS' Montgomery-form values (integers)."""
    c = [x * lb.R_MONT % P for x in pc.PSI_CX + pc.PSI_CY]
    return dict(zip(PSI_CONSTS, c))


# ------------------------------------------------------------ levels


def chain_levels(g: str, bits) -> int:
    """Team levels of team.cuh's double-and-add over `bits` (MSB first)
    from the identity: a doubling per bit, an addition per set bit after the
    first (the first add to the identity is a copy of the base)."""
    progs = point_programs(g)
    ones = sum(int(b) for b in bits)
    return len(bits) * levels(progs["dbl_AB"]) + max(ones - 1, 0) * levels(progs["add_AB"])


def h2c_levels() -> dict:
    """h2c.cu's dependent levels per message: form-program levels (a team's
    SWU programs, then the warp's add and cofactor clearing: two |x|
    chains, three psi maps, a doubling, five additions) and register levels
    (a^E's Fq2 squarings and table products)."""
    sw = sum(levels(p) for p in sw_programs().values())
    g2 = point_programs("g2")
    add, psi = levels(g2["add_AB"]), levels(g2["psi_AB"])
    xmul = chain_levels("g2", [int(b) for b in bin(X_ABS)[2:]])
    clear = 2 * xmul + 3 * psi + levels(g2["dbl_AB"]) + 5 * add
    reg = 4 * (len(E_DIGITS) - 1) + sum(1 for d in E_DIGITS[1:] if d)
    return {"program_levels": sw + add + clear, "register_levels": reg}


# ------------------------------------------------------------ the header


@functools.lru_cache(maxsize=None)
def program_sets() -> dict:
    """prefix -> (state slot names, {name: FormProgram})."""
    return {"TG1": (point_state("g1"), point_programs("g1")),
            "TG2": (point_state("g2"), point_programs("g2")),
            "TSW": (SW_STATE, sw_programs())}


def levels(prog: R.FormProgram) -> int:
    """Team levels of a program: its product rounds and its output pass."""
    return len(prog.passes)


def header() -> str:
    """team_programs.cuh: per prefix the tables of csrc/team.cuh (the ops,
    pass offsets, forms and terms of every program, each program's offsets
    into them), the program ids (<prefix>_<NAME>), the state slots
    (<prefix>_S_<name>) and the slot count; sqrt_ratio's exponent digits."""
    lines = ["// generated by lighthouse_tpu_torch.crypto.torchbls.team.header",
             "#pragma once", "#include <stdint.h>"]
    for prefix, (state, progs) in program_sets().items():
        ops, passes, forms, terms, cols = [], [], [], [], []
        for k, (name, prog) in enumerate(progs.items()):
            words, offsets = R._op_words(prog.passes)
            cols.append((len(ops), len(passes), len(forms), len(prog.passes)))
            ops += words
            passes += offsets
            forms += [len(terms) + f for f in prog.forms]
            terms += [((c & 0xFFFF) << 16) | (R.TERM_LAST if last else 0) | s
                      for s, c, last in prog.terms]
            lines.append(f"#define {prefix}_{name.upper()} {k}  // {prog.products} products, "
                         f"{prog.product_rounds} rounds, {prog.slots} slots")
        if len(terms) > 1 << 16:
            raise ValueError(f"{prefix}: {len(terms)} terms do not fit 16-bit form offsets")
        c = list(zip(*cols))
        lines += [
            f"#define {prefix}_SLOTS {max(p.slots for p in progs.values())}",
            f"#define {prefix}_NPROGS {len(progs)}",
            f"#define {prefix}_NOPS {len(ops)}",
            f"#define {prefix}_NPASS {len(passes)}",
            f"#define {prefix}_NFORMS {len(forms)}",
            f"#define {prefix}_NTERMS {len(terms)}",
            R._c_words("uint32_t", f"{prefix}_OPS", ops),
            R._c_words("uint16_t", f"{prefix}_PASS", passes),
            R._c_words("uint16_t", f"{prefix}_FORMS", forms),
            R._c_words("uint32_t", f"{prefix}_TERMS", terms),
            R._c_words("uint16_t", f"{prefix}_PROG_OPS", list(c[0])),
            R._c_words("uint16_t", f"{prefix}_PROG_PASS", list(c[1])),
            R._c_words("uint16_t", f"{prefix}_PROG_FORMS", list(c[2])),
            R._c_words("uint16_t", f"{prefix}_PROG_NPASSES", list(c[3])),
        ]
        lines += [f"#define {prefix}_S_{n.upper()} {k}" for k, n in enumerate(state)]
    consts = sw_constants()
    words = [(consts[n] >> (32 * i)) & 0xFFFFFFFF for n in SW_CONSTS for i in range(12)]
    lines += [f"#define SW_E_NDIGITS {len(E_DIGITS)}",
              R._c_words("uint32_t", "SW_CONST_WORDS", words),
              R._c_words("uint8_t", "SW_E_DIGITS", E_DIGITS),
              f"#define SW_NCONSTS {len(SW_CONSTS)}"]
    return "\n".join(lines) + "\n"
