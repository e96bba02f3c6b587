"""The port's hash-to-G2 and final-exponentiation easy part on CPU tensors
(kernels.hash_to_g2 and kernels.final_exp_easy_part, i.e. the plain
versions that csrc/h2c.cu and csrc/easy_part.cu are held to on the card):
hash-to-G2 lane by lane against the pure-Python RFC 9380 map of the JAX
package, and the easy part against the JAX final_exponentiation's first two
lines. Tolerance: exact equality.

The n = 4 batch holds two messages, a u = 0 lane (SWU's exceptional
xd == 0 case) and seeded random u-values whose first has is_qr false.
The Jacobian outputs against the JAX package's hash_to_g2_jacobian (its XLA
path) at n = 4 are held in tests/test_torch_backend.py, whose stage
comparison compiles that program once for both (a u = 0 lane and both
is_qr classes included).
"""

import numpy as np
import pytest

from lighthouse_tpu.crypto.bls381 import curve as ref_cv
from lighthouse_tpu.crypto.bls381 import fields as ref_f
from lighthouse_tpu.crypto.bls381 import hash_to_curve as ref_h2c
from lighthouse_tpu.crypto.bls381.constants import DST_POP, P

# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = K = ix = TL = TC = None

MESSAGES = (b"\x11" * 32, b"port-h2c-1")


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, K, ix, TL, TC
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as TC
    from lighthouse_tpu_torch.crypto.torchbls import interchange as ix
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import limbs as TL

    # many small int64 ops: intra-op threads would only contend with the
    # other test workers
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def is_qr(u) -> bool:
    """Whether sqrt_ratio finds gx1 square for u (pure Python, RFC 9380)."""
    tv1 = ref_f.fq2_mul(ref_h2c.ISO_Z, ref_f.fq2_sqr(u))
    tv2 = ref_f.fq2_add(ref_f.fq2_sqr(tv1), tv1)
    if ref_f.fq2_is_zero(tv2):
        x1 = ref_f.fq2_mul(ref_h2c.ISO_B, ref_f.fq2_inv(ref_f.fq2_mul(ref_h2c.ISO_Z, ref_h2c.ISO_A)))
    else:
        x1 = ref_f.fq2_mul(ref_f.fq2_mul(ref_f.fq2_neg(ref_h2c.ISO_B), ref_f.fq2_inv(ref_h2c.ISO_A)),
                           ref_f.fq2_add(ref_f.FQ2_ONE, ref_f.fq2_inv(tv2)))
    gx1 = ref_f.fq2_add(ref_f.fq2_mul(ref_f.fq2_add(ref_f.fq2_sqr(x1), ref_h2c.ISO_A), x1),
                        ref_h2c.ISO_B)
    return ref_f.fq2_legendre_is_square(gx1)


def random_fq2(rng):
    return tuple(int.from_bytes(rng.bytes(48), "little") % P for _ in range(2))


def lanes():
    """The four lanes' (u0, u1) as standard-form ints."""
    out = [tuple(ref_h2c.hash_to_field_fq2(m, 2, DST_POP)) for m in MESSAGES]
    out.append(((0, 0), (0, 0)))
    rng = np.random.default_rng(20261017)
    while True:
        u0 = random_fq2(rng)
        if not is_qr(u0):
            out.append((u0, random_fq2(rng)))
            return out


def pack(lanes_):
    return np.stack([np.stack([np.stack([_limbs(u[0]), _limbs(u[1])]) for u in lane])
                     for lane in lanes_]).astype(np.uint32)


def _limbs(x):
    return np.array([(x >> (16 * i)) & 0xFFFF for i in range(24)], np.uint32)


def affine(jac_lane):
    """One lane of port Jacobian output -> host affine ints (or None)."""
    x, y, inf = TC.jac_to_affine(jac_lane, TC.FQ2_OPS)
    if bool(inf):
        return None
    xs, ys = TL.from_mont(x).numpy(), TL.from_mont(y).numpy()
    return ((TL.unpack(xs[0]), TL.unpack(xs[1])), (TL.unpack(ys[0]), TL.unpack(ys[1])))


def test_hash_to_g2_matches_the_rfc_map():
    lanes_ = lanes()
    qr = [is_qr(u) for lane in lanes_ for u in lane]
    assert any(qr) and not all(qr)
    us = pack(lanes_)
    assert us.shape == (4, 2, 2, 24)

    got = K.hash_to_g2(ix.to_torch(us))
    assert K.hash_to_g2.launches == 0              # CPU tensors: the plain version
    for i, (u0, u1) in enumerate(lanes_):
        q0 = ref_h2c.iso_map(ref_h2c.sswu(u0))
        q1 = ref_h2c.iso_map(ref_h2c.sswu(u1))
        expected = ref_cv.g2_clear_cofactor(ref_cv.g2_add(q0, q1))
        if i < len(MESSAGES):
            assert expected == ref_h2c.hash_to_g2(MESSAGES[i], DST_POP)
        assert affine(tuple(c[i] for c in got)) == expected, i


def test_easy_part_matches_jax():
    import jax

    from lighthouse_tpu.crypto.jaxbls import tower as JT

    a = np.random.default_rng(7).integers(0, 1 << 16, size=(2, 3, 2, 24))
    a[..., -1] = 0                                 # < 2^368 < p
    m = a.astype(np.uint32)

    @jax.jit
    def easy(m):
        t = JT.fq12_mul(JT.fq12_conj(m), JT.fq12_inv(m))      # m^(p^6 - 1)
        return JT.fq12_mul(JT.fq12_frobenius(t, 2), t)        # ^(p^2 + 1)

    got = K.final_exp_easy_part(ix.to_torch(m))
    assert K.final_exp_easy_part.launches == 0
    assert np.array_equal(ix.to_numpy(got), np.asarray(easy(m)))
