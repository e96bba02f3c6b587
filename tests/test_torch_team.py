"""The team programs of csrc/team.cuh, prepare.cu and h2c.cu (torchbls.team),
and the carry-chain Montgomery product of csrc/fq.cuh, on Python integers.

The programs' tables run here as the card runs them, pass by pass with
every operand read before any result of the pass is written, and the
kernels' control flow between programs (jac_add's cases, the double-and-add
loop, the trees, the SWU selects and the cofactor clearing) is restated
step for step. Each is held against the port's plain versions (curve_ops,
kernels.stage_prepare_plain, kernels.hash_to_g2_plain), which
test_torch_curve.py and test_torch_backend.py hold against the JAX package;
so this file compiles no JAX. Tolerance: exact equality of every Fq
coefficient (Montgomery form).
"""

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto.bls381.constants import P

# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = T = R = K = CO = TL = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, T, R, K, CO, TL
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as CO
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as TL
    from lighthouse_tpu_torch.crypto.torchbls import rounds as R
    from lighthouse_tpu_torch.crypto.torchbls import team as T

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


R_INV = pow(1 << 384, -1, P)
ONE = (1 << 384) % P


def mont(x):
    return x * (1 << 384) % P


# ------------------------------------------------------------ the interpreter


def run(prog, S, base=0):
    """One form program on the slots S[base:] (updated in place), as
    team.cuh's team_run runs it; raises on a pass whose operations collide."""
    def terms(f):
        out = []
        for s, c, last in prog.terms[prog.forms[f]:]:
            out.append((s, c))
            if last:
                return out

    def form(f):
        return sum(c * S[base + s] for s, c in terms(f)) % P

    for p, ops in enumerate(prog.passes):
        writes = [o for _k, o, _a, _b in ops]
        reads = {s for _k, _o, a, b in ops for f in (a, b) for s, _c in terms(f)}
        assert len(set(writes)) == len(writes) and not reads.intersection(writes), \
            f"{prog.name}: pass {p} reads or writes a slot twice"
        res = [form(a) * form(b) * R_INV % P if k == R.MUL else form(a) for k, _o, a, b in ops]
        for o, r in zip(writes, res):
            S[base + o] = r


# ------------------------------------------------------------ team.cuh's point steps


class Points:
    """team.cuh's point steps over a TG1 (nc = 3) or TG2 (nc = 6) state."""

    def __init__(self, g):
        self.g, self.nc = g, 3 if g == "g1" else 6
        self.progs = T.point_programs(g)
        self.slots = max(p.slots for p in self.progs.values())

    def is_identity(self, S, area):
        nc = self.nc
        return all(S[area * nc + k] == 0 for k in range(2 * nc // 3, nc))

    def set_identity(self, S, area):
        nc = self.nc
        for k in range(nc):
            S[area * nc + k] = ONE if k in (0, nc // 3) else 0

    def dbl(self, S, a):
        run(self.progs["dbl_AB" if a == 0 else "dbl_BA"], S)
        return a ^ 1

    def add(self, S, a):
        nc = self.nc
        if self.is_identity(S, 2):
            return a
        if self.is_identity(S, a):
            S[a * nc:(a + 1) * nc] = S[2 * nc:3 * nc]
            return a
        run(self.progs["add_AB" if a == 0 else "add_BA"], S)
        h = S[3 * nc:3 * nc + nc // 3]
        r = S[3 * nc + nc // 3:3 * nc + 2 * nc // 3]
        if not any(h):
            if not any(r):
                run(self.progs["dbl_AB" if a == 0 else "dbl_BA"], S)
            else:
                self.set_identity(S, a ^ 1)
        return a ^ 1

    def scalar_mul(self, S, bits):
        self.set_identity(S, 0)
        a = 0
        for b in bits:
            a = self.dbl(S, a)
            if b:
                a = self.add(S, a)
        return a

    def state(self):
        S = [0] * self.slots
        if self.g == "g2":
            for name, v in T.psi_constants().items():
                S[T.point_state("g2").index(name)] = v
        return S

    def put(self, S, area, pt):
        S[area * self.nc:(area + 1) * self.nc] = list(pt)

    def get(self, S, area):
        return S[area * self.nc:(area + 1) * self.nc]


# ------------------------------------------------------------ plain versions


def to_tensor(values, g):
    """Flat Montgomery integers of one point -> curve_ops' (X, Y, Z)."""
    arr = np.stack([TL.pack(v) for v in values]).astype(np.int64)
    t = torch.as_tensor(arr)
    if g == "g1":
        return tuple(t[k] for k in range(3))
    return tuple(t[2 * k:2 * k + 2] for k in range(3))


def from_tensor(pt):
    return [TL.unpack(c) for x in pt for c in x.reshape(-1, TL.NL).numpy()]


def ops(g):
    return CO.FQ_OPS if g == "g1" else CO.FQ2_OPS


def rand_point(rng, nc):
    return [int(rng.integers(0, 1 << 62)) ** 6 % P for _ in range(nc)]


def scaled(pt, lam, nc):
    """The same projective point with Z scaled by lam (X lam^2, Y lam^3)."""
    k = nc // 3
    lam_m = mont(lam)

    def mul(vals, s):
        if k == 1:
            return [vals[0] * s * R_INV % P]
        a0, a1 = vals
        return [a0 * s * R_INV % P, a1 * s * R_INV % P]

    l2 = lam_m * lam_m * R_INV % P
    l3 = l2 * lam_m * R_INV % P
    return mul(pt[:k], l2) + mul(pt[k:2 * k], l3) + mul(pt[2 * k:], lam_m)


def negated(pt, nc):
    k = nc // 3
    return pt[:k] + [(-v) % P for v in pt[k:2 * k]] + pt[2 * k:]


# ------------------------------------------------------------ tests


@pytest.mark.parametrize("g", ["g1", "g2"])
def test_programs_are_team_levels(g):
    """Each point program does the plain formula's Fq products in its
    product depth of levels, none wider than a team of 16 lanes, and its
    output pass: a doubling 3 levels (G2: 7 / 6 / 3 products), a general
    addition 5, psi 1."""
    progs = T.point_programs(g)
    want = {"g1": {"dbl": (7, 3), "add": (16, 5)},
            "g2": {"dbl": (16, 3), "add": (44, 5), "psi": (6, 1)}}[g]
    for name, prog in progs.items():
        assert (prog.products, prog.product_rounds) == want[name[:3]]
        assert T.levels(prog) == prog.product_rounds + 1
        assert max(len(ops_) for ops_ in prog.passes[:-1]) <= 16
    if g == "g2":
        assert [len(x) for x in progs["dbl_AB"].passes[:-1]] == [7, 6, 3]


@pytest.mark.parametrize("g", ["g1", "g2"])
@pytest.mark.parametrize("case", ["general", "p2_identity", "p1_identity", "equal", "scaled_equal",
                                  "negated", "double"])
def test_point_steps_match_curve_ops(g, case):
    """team_add (the general program and every case of jac_add) and the
    doubling against curve_ops.jac_add / jac_double."""
    pts = Points(g)
    nc = pts.nc
    rng = np.random.default_rng(40 + len(case))
    p1, p2 = rand_point(rng, nc), rand_point(rng, nc)
    if case == "p2_identity":
        p2[2 * nc // 3:] = [0] * (nc // 3)
    elif case == "p1_identity":
        p1[2 * nc // 3:] = [0] * (nc // 3)
    elif case == "equal":
        p2 = list(p1)
    elif case == "scaled_equal":
        p2 = scaled(p1, 7, nc)
    elif case == "negated":
        p2 = negated(scaled(p1, 5, nc), nc)
    S = pts.state()
    pts.put(S, 0, p1)
    pts.put(S, 2, p2)
    if case == "double":
        got = pts.get(S, pts.dbl(S, 0))
        want = CO.jac_double(to_tensor(p1, g), ops(g))
    else:
        got = pts.get(S, pts.add(S, 0))
        want = CO.jac_add(to_tensor(p1, g), to_tensor(p2, g), ops(g))
    assert got == from_tensor(want)


@pytest.mark.parametrize("g", ["g1", "g2"])
def test_scalar_chain_matches_scalar_mul_bits(g):
    """A 64-bit double-and-add from the identity against
    curve_ops.scalar_mul_bits."""
    pts = Points(g)
    rng = np.random.default_rng(50)
    p = rand_point(rng, pts.nc)
    bits = [int(b) for b in rng.integers(0, 2, size=64)]
    S = pts.state()
    pts.put(S, 2, p)
    got = pts.get(S, pts.scalar_mul(S, bits))
    want = CO.scalar_mul_bits(to_tensor(p, g), torch.tensor(bits), ops(g))
    assert got == from_tensor(want)


def prepare(args):
    """prepare.cu's three launches on the team programs: per set the
    Montgomery conversion, masking and halving tree of the pubkeys, the G1
    and G2 chains (bad flag, padded sets to the identity), the G2 tree."""
    pk_x, pk_y, pk_mask, sig_x, sig_y, z_bits, set_mask = (a.numpy() for a in args)
    n, m = pk_mask.shape
    g1, g2 = Points("g1"), Points("g2")

    def to_mont(limbs):
        return mont(TL.unpack(limbs))

    def tree(points, pts):
        half = len(points) // 2
        while half:
            for i in range(half):
                S = pts.state()
                pts.put(S, 0, points[i])
                pts.put(S, 2, points[i + half])
                points[i] = pts.get(S, pts.add(S, 0))
            half //= 2
        return points[0]

    z_pk, zsig, bad = [], [], False
    for s in range(n):
        keys = [[to_mont(pk_x[s, i]), to_mont(pk_y[s, i]), ONE if pk_mask[s, i] else 0]
                for i in range(m)]
        agg = tree(keys, g1)
        bad = bad or bool(set_mask[s] and agg[2] == 0)
        S = g1.state()
        g1.put(S, 2, agg)
        z_pk.append(g1.get(S, g1.scalar_mul(S, z_bits[s])))
        S = g2.state()
        sig = [to_mont(sig_x[s, 0]), to_mont(sig_x[s, 1]), to_mont(sig_y[s, 0]),
               to_mont(sig_y[s, 1]), ONE if set_mask[s] else 0, 0]
        g2.put(S, 2, sig)
        a = g2.scalar_mul(S, z_bits[s])
        if not set_mask[s]:
            g2.set_identity(S, a)
        zsig.append(g2.get(S, a))
    return z_pk, tree(zsig, g2), bad


def test_prepare_teams_match_stage_prepare_plain():
    """The whole of prepare.cu's schedule at bucket (4, 4), with a padded
    last set, a set whose pubkeys are all masked (an aggregate at infinity)
    and two equal pubkeys in one set (the tree's doubling case)."""
    rng = np.random.default_rng(60)
    n, m = 4, 4

    def limbs(shape):
        a = rng.integers(0, 1 << 16, size=shape + (TL.NL,))
        a[..., -1] = 0
        return torch.as_tensor(a.astype(np.int64))

    pk_x, pk_y = limbs((n, m)), limbs((n, m))
    pk_x[0, 1], pk_y[0, 1] = pk_x[0, 0], pk_y[0, 0]
    pk_mask = torch.ones((n, m), dtype=torch.int64)
    pk_mask[1] = 0
    pk_mask[2, 3] = 0
    set_mask = torch.tensor([1, 1, 1, 0])
    args = (pk_x, pk_y, pk_mask, limbs((n, 2)), limbs((n, 2)),
            torch.as_tensor(rng.integers(0, 2, size=(n, 64))), set_mask)
    z_pk, sig_acc, bad = prepare(args)
    want_pk, want_sig, want_bad = K.stage_prepare_plain(*args)
    for s in range(n):
        assert z_pk[s] == [TL.unpack(c[s].numpy()) for c in want_pk]
    assert sig_acc == from_tensor(want_sig)
    assert bad == bool(want_bad)


# ------------------------------------------------------------ hash to G2


def sgn0(y):
    s0, s1 = (v * R_INV % P for v in y)
    return (s0 & 1) | (int(s0 == 0) & s1 & 1)


def fp2_sqr(a):
    """team.cuh team_fp2_sqr: (a0 + a1)(a0 - a1), 2 a0 a1 (Montgomery)."""
    a0, a1 = a
    return [(a0 + a1) * (a0 - a1) * R_INV % P, 2 * a0 * a1 * R_INV % P]


def fp2_mul(a, b):
    """team.cuh team_fp2_mul: Karatsuba (Montgomery)."""
    t0, t1 = a[0] * b[0] * R_INV % P, a[1] * b[1] * R_INV % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) * R_INV % P
    return [(t0 - t1) % P, (t2 - t0 - t1) % P]


def map_to_curve(u):
    """h2c.cu's per-u team sequence (u Montgomery): swu1, the xd == 0
    select, swu2, table, the register chain of a^E, cands and the first
    match, y2x2, the is_qr and sgn0 selects, iso. Returns (X, Y, Z) flat."""
    progs = T.sw_programs()
    sl = {n: k for k, n in enumerate(T.SW_STATE)}
    S = [0] * max(p.slots for p in progs.values())
    for name, v in T.sw_constants().items():
        S[sl[name]] = v
    S[sl["u0"]], S[sl["u1"]] = u

    def get(name):
        return [S[sl[f"{name}0"]], S[sl[f"{name}1"]]]

    def put(name, v):
        S[sl[f"{name}0"]], S[sl[f"{name}1"]] = v

    run(progs["swu1"], S)
    if get("xd") == [0, 0]:
        put("xd", get("ZA"))
    run(progs["swu2"], S)
    run(progs["table"], S)
    a = get(f"T{T.E_DIGITS[0]}")
    for d in T.E_DIGITS[1:]:
        for _ in range(4):
            a = fp2_sqr(a)
        if d:
            a = fp2_mul(a, get(f"T{d}"))
    put("e", a)
    run(progs["cands"], S)
    ok = [get(f"chk{c}") == get("gx1" if c < 4 else "zu") for c in range(8)]
    first = ok.index(True) if any(ok) else None
    put("y1", get(f"ys{first}") if first is not None else [0, 0])
    is_qr = any(ok[:4])
    run(progs["y2x2"], S)
    put("xn", get("x1n" if is_qr else "x2n"))
    y = get("y1" if is_qr else "y2")
    put("ysg", [(-v) % P for v in y] if sgn0(y) != sgn0(u) else y)
    run(progs["iso"], S)
    return get("qx") + get("qy") + get("qz")


def clear_cofactor(q0, q1):
    """h2c.cu's warp sequence on the TG2 programs: r = q0 + q1, then
    curve_ops.clear_cofactor_g2's order of |x| multiplications, psi maps,
    the doubling and the adds of negated points."""
    from lighthouse_tpu_torch.crypto.bls381.constants import X_ABS

    g2 = Points("g2")
    xbits = [int(b) for b in bin(X_ABS)[2:]]
    S = g2.state()

    def add(a_pt, p_pt):
        g2.put(S, 0, a_pt)
        g2.put(S, 2, p_pt)
        return g2.get(S, g2.add(S, 0))

    def xmul(pt):
        g2.put(S, 2, pt)
        return negated(g2.get(S, g2.scalar_mul(S, xbits)), 6)

    def psi_twice_of_double(pt):
        g2.put(S, 0, pt)
        g2.dbl(S, 0)                       # into B
        run(g2.progs["psi_BA"], S)
        run(g2.progs["psi_AB"], S)
        return g2.get(S, 1)

    r = add(q0, q1)
    t1 = xmul(r)
    g2.put(S, 0, r)
    run(g2.progs["psi_AB"], S)
    t2 = g2.get(S, 1)
    t3 = psi_twice_of_double(r)
    t3 = add(t3, negated(t2, 6))
    t2 = xmul(add(t1, t2))
    t3 = add(t3, t2)
    t3 = add(t3, negated(t1, 6))
    return add(t3, negated(r, 6))


def test_h2c_warp_sequence_matches_hash_to_g2_plain():
    """The two teams' map_to_curve and the warp's add and cofactor clearing
    against kernels.hash_to_g2_plain on four lanes of seeded standard-form
    u-values, lane 0 all zero (SWU's xd == 0 case); both is_qr classes occur."""
    rng = np.random.default_rng(13)
    us = rng.integers(0, 1 << 16, size=(4, 2, 2, TL.NL))
    us[..., -1] = 0
    us[0] = 0
    us = torch.as_tensor(us.astype(np.int64))
    want = K.hash_to_g2_plain(us)
    for i in range(4):
        qs = [map_to_curve([mont(TL.unpack(us[i, j, k].numpy())) for k in range(2)])
              for j in range(2)]
        got = clear_cofactor(*qs)
        assert got == [TL.unpack(c) for x in want for c in x[i].numpy()], f"lane {i}"


def test_sw_programs_fit_a_team():
    """Every SWU program's levels are at most 32 products wide (two passes of
    a 16-lane team at most) and its state and temporaries fit the 10-bit
    slots; a^E's chain is 189 digits of four squarings after the first."""
    progs = T.sw_programs()
    assert list(progs) == ["swu1", "swu2", "table", "cands", "y2x2", "iso"]
    for name, prog in progs.items():
        assert max(len(x) for x in prog.passes) <= 32, name
        assert prog.slots < 1 << R.SLOT_BITS
    assert [p.product_rounds for p in progs.values()] == [4, 7, 4, 4, 1, 6]
    assert len(T.E_DIGITS) == 190 and T.E_DIGITS[0] != 0


# ------------------------------------------------------------ fq.cuh's fp_mul


def carry_chain_mul(a, b):
    """fq.cuh's fp_mul restated word for word: 32-bit words, the even- and
    odd-indexed words' products in two accumulators that swap each row,
    PTX carry-flag semantics; dropped carries are asserted zero."""
    M = (1 << 32) - 1
    inv = (-pow(P, -1, 1 << 32)) % (1 << 32)
    pw = [(P >> (32 * i)) & M for i in range(12)]
    A = [(a >> (32 * i)) & M for i in range(12)]
    B = [(b >> (32 * i)) & M for i in range(12)]
    cc = [0]

    def mad(hi, x, y, c, cin, cout=True):
        prod = x * y
        v = (prod >> 32 if hi else prod & M) + c + (cc[0] if cin else 0)
        if cout:
            cc[0] = v >> 32
        else:
            assert v >> 32 == 0
        return v & M

    def add(x, y, cin, cout=True):
        return mad(False, x, 1, y, cin, cout)

    def cmad_even(E, w, k):
        E[0] = mad(False, w[0], k, E[0], False)
        E[1] = mad(True, w[0], k, E[1], True)
        for j in range(2, 12, 2):
            E[j] = mad(False, w[j], k, E[j], True)
            E[j + 1] = mad(True, w[j], k, E[j + 1], True)

    def row(E, O, bi, first):
        if first:
            for j in range(0, 12, 2):
                E[j], E[j + 1] = A[j] * bi & M, A[j] * bi >> 32
                O[j], O[j + 1] = A[j + 1] * bi & M, A[j + 1] * bi >> 32
        else:
            assert O[0] == 0
            E[0] = add(E[0], O[1], False)
            for j in range(0, 10, 2):
                O[j] = mad(False, A[j + 1], bi, O[j + 2], True)
                O[j + 1] = mad(True, A[j + 1], bi, O[j + 3], True)
            O[10] = mad(False, A[11], bi, 0, True)
            O[11] = mad(True, A[11], bi, 0, True, False)
            cmad_even(E, A, bi)
            O[11] = add(O[11], 0, True, False)
        m = E[0] * inv & M
        O[0] = mad(False, pw[1], m, O[0], False)
        O[1] = mad(True, pw[1], m, O[1], True)
        for j in range(2, 10, 2):
            O[j] = mad(False, pw[j + 1], m, O[j], True)
            O[j + 1] = mad(True, pw[j + 1], m, O[j + 1], True)
        O[10] = mad(False, pw[11], m, O[10], True)
        O[11] = mad(True, pw[11], m, O[11], True, False)
        cmad_even(E, pw, m)
        O[11] = add(O[11], 0, True, False)
        assert E[0] == 0

    X, Y = [0] * 12, [0] * 12
    for i in range(0, 12, 2):
        row(X, Y, B[i], i == 0)
        row(Y, X, B[i + 1], False)
    t = [add(X[0], Y[1], False)] + [0] * 11
    for k in range(1, 11):
        t[k] = add(X[k], Y[k + 1], True)
    t[11] = add(X[11], 0, True, False)
    d = [0] * 12
    borrow = 0
    for k in range(12):
        v = t[k] - pw[k] - borrow
        d[k], borrow = v & M, int(v < 0)
    words = t if borrow else d
    return sum(w << (32 * k) for k, w in enumerate(words))


def test_carry_chain_product_is_the_montgomery_product():
    """fq.cuh's fp_mul gives a b 2^-384 mod p, fully reduced, on the edge
    operands the card's field phase uses (0, 1, p - 1, p - 2, R mod p,
    R^2 mod p, (2^381 - k) mod p) and seeded random pairs, also with a
    second operand that is not reduced (below 2p, or near 2^384)."""
    top = (1 << 381) - 1
    edges = [0, 1, P - 1, P - 2, ONE, ONE * ONE % P, top % P, (top - 1) % P, (1 << 380) + 1]
    rng = np.random.default_rng(70)
    rand = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(400)]
    for a in edges + rand[:40]:
        for b in edges + rand[40:45]:
            assert carry_chain_mul(a, b) == a * b * R_INV % P
    for a, b in zip(rand[::2], rand[1::2]):
        assert carry_chain_mul(a, b) == a * b * R_INV % P
    # the second operand may be any value below 2^384 (a form left below 2p)
    for a, b in zip(rand[:100], rand[100:200]):
        for b2 in (b + P, (1 << 384) - 1 - (b % 7)):
            assert carry_chain_mul(a, b2) == a * b2 * R_INV % P


# ------------------------------------------------------------ rounds.cuh's form_reduce


def form_value(terms, full=True):
    """rounds.cuh's form_terms and form_reduce restated word for word: |c|
    times each word of the slot, complemented where c < 0, summed in 64-bit
    limbs; lifted by n (p_j - 2^32 + 1) per limb; the low words plus the
    high words one word up less the negative limbs' borrows (mod 2^416);
    the quotient estimate; v - q p on two borrow chains; for a fully reduced
    value one conditional subtraction (a product's second operand keeps
    v < 2p)."""
    M = (1 << 32) - 1
    pw = [(P >> (32 * i)) & M for i in range(12)]
    acc = [sum(abs(c) * (((x >> (32 * j)) & M) ^ (M if c < 0 else 0)) for x, c in terms)
           for j in range(12)]
    assert all(a < 1 << 64 for a in acc)
    n = sum(-c for _x, c in terms if c < 0)
    s = [a + n * (pw[j] - M) for j, a in enumerate(acc)]
    assert all(-(1 << 63) <= x < 1 << 63 for x in s)
    L = [x & M for x in s]
    H = [(x >> 32) & M for x in s]
    B = [int(x < 0) for x in s]
    v = (sum(w << (32 * j) for j, w in enumerate(L)) + sum(w << (32 * (j + 1)) for j, w in enumerate(H))
         - sum(b << (32 * (j + 2)) for j, b in enumerate(B[:11]))) % (1 << 416)
    assert v == sum(c * x for x, c in terms) + n * P
    words = [(v >> (32 * j)) & M for j in range(13)]
    hi = (words[12] << 54) | (words[11] << 22) | (words[10] >> 10)
    q = (hi * R.FORM_RECIP) >> 64
    v = (v - q * P) % (1 << 416)
    assert v < 2 * P
    if not full:
        return v % (1 << 384)
    return v - P if v >= P else v


def test_form_reduction_gives_the_form_value():
    """form_reduce on seeded forms of up to 8 terms with coefficients of
    both signs (and at the edges: p - 1 under the largest coefficients a
    form may have): the fully reduced value of the sum, and for a
    product's second operand a value below 2p congruent to it."""
    rng = np.random.default_rng(80)
    forms = [[(P - 1, -511), (P - 1, -512)], [(P - 1, 1023)], [(0, -1), (P - 1, -1)],
             [(P - 1, 500), (1, -523)]]
    for _ in range(3000):
        k = int(rng.integers(1, 9))
        cs = [int(c) or 1 for c in rng.integers(-120, 121, size=k)]
        xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(k)]
        forms.append(list(zip(xs, cs)))
    for terms in forms:
        if sum(abs(c) for _x, c in terms) < R.FORM_BOUND:
            want = sum(c * x for x, c in terms) % P
            assert form_value(terms) == want
            lazy = form_value(terms, full=False)
            assert lazy % P == want and lazy < 2 * P


def test_header_carries_the_programs_and_constants():
    """team_programs.cuh: every program's id and tables per prefix, the
    digits of sqrt_ratio's exponent E = (p^2 - 9) / 16, and the SWU
    constants as h2c_ops' tables hold them (Montgomery form)."""
    import re

    from lighthouse_tpu_torch.crypto.torchbls import h2c_ops as H2

    text = T.header()
    for prefix, (state, progs) in T.program_sets().items():
        assert f"#define {prefix}_NPROGS {len(progs)}\n" in text
        for k, name in enumerate(progs):
            assert f"#define {prefix}_{name.upper()} {k} " in text
        assert f"#define {prefix}_S_{state[-1].upper()} {len(state) - 1}\n" in text
    digits = [int(d.rstrip("u")) for d in
              re.search(r"SW_E_DIGITS\[190\] = \{([^}]*)\}", text).group(1).split(",")]
    e = 0
    for d in digits:
        e = 16 * e + d
    assert e == (P * P - 9) // 16
    words = [int(w.strip().rstrip("u")) for w in
             re.search(r"SW_CONST_WORDS\[\d+\] = \{([^}]*)\}", text).group(1).split(",")]
    consts = [sum(w << (32 * i) for i, w in enumerate(words[12 * k:12 * k + 12]))
              for k in range(len(T.SW_CONSTS))]
    got = dict(zip(T.SW_CONSTS, consts))
    assert got["one"] == ONE
    tables = {"Z": H2._ISO_Z, "A": H2._ISO_A, "B": H2._ISO_B, "nA": H2._NEG_A, "ZA": H2._ZA}
    tables.update({f"c{c}": H2._CAND_CONSTS[c] for c in range(8)})
    tables.update({f"K{k}{j}": H2._ISO_K[k][j] for k, j in T.ISO_TERMS})
    for name, limbs in tables.items():
        assert [got[f"{name}0"], got[f"{name}1"]] == [TL.unpack(limbs[0]), TL.unpack(limbs[1])]
