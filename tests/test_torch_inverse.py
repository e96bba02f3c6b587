"""fq.cuh's Fq inversion (fp_inv, Pornin's optimized binary GCD) restated on
32-bit words: the same divstep batches on 62-bit approximations, the same
matrix updates of a, b (exact, divided by 2^30) and u, v (mod p, with a
Montgomery division by 2^30), the same product by R^3. Held against
pow(x, p - 2, p) and against the port's plain inversion (limbs.mont_inv,
a Fermat chain) on numpy-seeded Montgomery elements and on edge inputs,
among them 2^380, the input that needs the most divsteps. The model also
checks the bounds the kernel's word widths rely on. No JAX. Tolerance:
exact equality.
"""

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto.bls381.constants import P

# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = K = TL = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, K, TL
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as TL

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


W = (1 << 32) - 1
LOW30 = (1 << 30) - 1
R = (1 << 384) % P
R2 = R * R % P
FP_INV = (-pow(P, -1, 1 << 32)) % (1 << 32)


def words(x, n=12):
    return [(x >> (32 * j)) & W for j in range(n)]


def value(w):
    return sum(x << (32 * j) for j, x in enumerate(w))


def inv_mad(t, x, k):
    """t (13 words) += x k: the low words of the products on one carry
    chain, the high words one word up on another; the last carries drop."""
    t, c = list(t), 0
    for j in range(12):
        s = ((x[j] * k) & W) + t[j] + c
        t[j], c = s & W, s >> 32
    t[12] = (t[12] + c) & W
    c = 0
    for j in range(1, 13):
        s = ((x[j - 1] * k) >> 32) + t[j] + c
        t[j], c = s & W, s >> 32
    return t


def inv_cneg(x, neg):
    """-x in two's complement over len(x) words where neg."""
    m = W if neg else 0
    out, c = [], m & 1
    for w in x:
        s = (w ^ m) + c
        out.append(s & W)
        c = s >> 32
    return out


def shift30(t):
    return [((t[j] >> 30) | (t[j + 1] << 2)) & W for j in range(12)]


def inv_lin(x, y, f, g):
    """(x f + y g) / 2^30: its magnitude in 12 words, and its sign."""
    X = inv_cneg(inv_mad([0] * 13, x, abs(f)), f < 0)
    Y = inv_cneg(inv_mad([0] * 13, y, abs(g)), g < 0)
    S = words((value(X) + value(Y)) % (1 << 416), 13)
    assert S[0] & LOW30 == 0                     # the divsteps cleared the low bits
    r = shift30(S)
    neg = bool(r[11] >> 31)
    r = inv_cneg(r, neg)
    assert value(r) < 1 << 381
    return r, neg


def fp_neg(x):
    return words((P - value(x)) % P)


def inv_lin_mod(u, v, f, g):
    """(u f + v g) / 2^30 mod p, fully reduced."""
    uu = fp_neg(u) if f < 0 else u
    vv = fp_neg(v) if g < 0 else v
    t = inv_mad(inv_mad([0] * 13, uu, abs(f)), vv, abs(g))
    t = inv_mad(t, words(P), (t[0] * FP_INV) & LOW30)
    assert t[0] & LOW30 == 0
    w = value(shift30(t))
    assert w < 2 * P
    return words(w - P if w >= P else w)


def inv_approx(x, s):
    q = s >> 5
    top = ((x[q + 1] << 32 | x[q]) >> (s & 31)) & W
    return (top << 30) | (x[0] & LOW30)


def fp_inv(x):
    """fq.cuh's fp_inv on the word value x (a in Montgomery form, x = aR):
    returns (a^-1 R, the final a and b, the number of batches after which
    a is zero)."""
    a, b, u, v = words(x), words(P), words(1), [0] * 12
    done = 0 if x == 0 else None
    for batch in range(K.INV_BATCHES):
        length = 0
        for j in range(12):
            if a[j] | b[j]:
                length = 32 * j + (a[j] | b[j]).bit_length()
        s = max(length, 62) - 32
        A, B = inv_approx(a, s), inv_approx(b, s)
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(K.INV_STEPS):
            odd = A & 1
            sw = odd and A < B
            A1, B1 = (B, A) if sw else (A, B)
            F0, G0, F1, G1 = (f1, g1, f0, g0) if sw else (f0, g0, f1, g1)
            A, B = (A1 - (B1 if odd else 0)) >> 1, B1
            f0, g0 = F0 - (F1 if odd else 0), G0 - (G1 if odd else 0)
            f1, g1 = 2 * F1, 2 * G1
            assert 0 <= A < 1 << 62 and 0 <= B < 1 << 62
        assert abs(f0) + abs(g0) <= 1 << 30 and abs(f1) + abs(g1) <= 1 << 30   # int32
        na, sa = inv_lin(a, b, f0, g0)
        nb, sb = inv_lin(a, b, f1, g1)
        f0, g0 = (-f0, -g0) if sa else (f0, g0)
        f1, g1 = (-f1, -g1) if sb else (f1, g1)
        u, v = inv_lin_mod(u, v, f0, g0), inv_lin_mod(u, v, f1, g1)
        a, b = na, nb
        if done is None and value(a) == 0:
            done = batch + 1
    r3 = pow(R, 3, P)
    return value(v) * r3 * pow(1 << 384, -1, P) % P, value(a), value(b), done


def want(x):
    """The Montgomery form of a^-1 for x = aR: x^-1 R^2 (0 for 0)."""
    return pow(x, P - 2, P) * R2 % P


def exact_divsteps(x):
    """Divsteps of the exact binary GCD of (x, p) until x is zero."""
    a, b, n = x, P, 0
    while a:
        if a & 1:
            if a < b:
                a, b = b, a
            a -= b
        a >>= 1
        n += 1
    return n


EDGES = {"zero": 0, "one": 1, "p-1": P - 1, "p-2": P - 2, "R": R, "R^2": R2,
         "2^381-1": ((1 << 381) - 1) % P, "2^381-2": ((1 << 381) - 2) % P,
         "2^381-3": ((1 << 381) - 3) % P, "2^380": 1 << 380}
EDGES.update({f"2^{k}": 1 << k for k in (1, 31, 32, 61, 62, 63, 64, 191, 352, 379)})


@pytest.mark.parametrize("name", sorted(EDGES))
def test_inverse_on_the_edges(name):
    """Each edge input: the model's result equals Fermat's (0 maps to 0),
    and a nonzero input ends at a = 0, b = gcd = 1."""
    x = EDGES[name]
    got, a, b, _done = fp_inv(x)
    assert got == want(x)
    assert (a, b) == ((0, P) if x == 0 else (0, 1))


def test_inverse_matches_fermat_on_seeded_elements():
    """200 numpy-seeded Montgomery elements and every power of two below
    2^381: equal to pow(x, p - 2, p) in Montgomery form."""
    rng = np.random.default_rng(41)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(200)]
    for x in xs + [1 << k for k in range(381)]:
        got, a, b, _done = fp_inv(x)
        assert (got, a, b) == (want(x), 0, 1), hex(x)


def test_inverse_matches_the_plain_inversion():
    """The model against limbs.mont_inv (the plain version's Fermat chain)
    on numpy-seeded elements and the edges, as one batch of limb tensors."""
    rng = np.random.default_rng(42)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(24)] + list(EDGES.values())
    t = torch.as_tensor(np.stack([TL.pack(x) for x in xs]).astype(np.int64))
    plain = [TL.unpack(row) for row in TL.mont_inv(t).numpy()]
    assert [fp_inv(x)[0] for x in xs] == plain


def test_the_most_divsteps_fit_the_batches():
    """2 * 381 - 1 divsteps bound the binary GCD of any x < 2^381 with p
    (each step shortens len(a) + len(b) by at least one); 2^380 takes all
    761, and in the model's batches a reaches zero only in the last one.
    Random inputs need fewer batches."""
    assert K.INV_BATCHES == -(-(2 * 381 - 1) // K.INV_STEPS) == 26
    assert exact_divsteps(1 << 380) == 2 * 381 - 1
    assert fp_inv(1 << 380)[3] == K.INV_BATCHES
    rng = np.random.default_rng(43)
    done = [fp_inv(int.from_bytes(rng.bytes(48), "little") % P)[3] for _ in range(20)]
    assert max(done) < K.INV_BATCHES


def test_header_carries_the_batch_counts():
    text = K.consts_header()
    assert f"#define INV_STEPS {K.INV_STEPS}" in text
    assert f"#define INV_BATCHES {K.INV_BATCHES}" in text
