"""The port's pairing (torchbls.pairing_ops, through the kernels' plain
versions on CPU tensors) against the JAX package's pairing_ops under
jax.jit: the Miller value, the per-pair Miller values of miller_loop_batch,
the final exponentiation and the product check, with 2 and 3 pairs (an odd
count) and a masked lane. Tolerance: exact equality of every Fq12 limb.
"""

import functools

import jax
import numpy as np
import pytest

from lighthouse_tpu.crypto.jaxbls import curve_ops as JC
from lighthouse_tpu.crypto.jaxbls import pairing_ops as JP
from lighthouse_tpu.crypto.jaxbls import tower as JT
from lighthouse_tpu_torch.crypto.bls381 import curve as pc


# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = ix = TP = TT = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, ix, TP, TT
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import interchange as ix
    from lighthouse_tpu_torch.crypto.torchbls import pairing_ops as TP
    from lighthouse_tpu_torch.crypto.torchbls import tower as TT

    # many small int64 ops: intra-op threads would only contend with the
    # other test workers
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def affine_pairs(g1_pts, g2_pts):
    """Host affine points -> Montgomery limb arrays (xp, yp), (xq, yq)."""
    xp = JT.fq_batch_to_device([p[0] for p in g1_pts])
    yp = JT.fq_batch_to_device([p[1] for p in g1_pts])
    xq = JT.fq2_batch_to_device([q[0] for q in g2_pts])
    yq = JT.fq2_batch_to_device([q[1] for q in g2_pts])
    return tuple(np.asarray(a) for a in (xp, yp)), tuple(np.asarray(a) for a in (xq, yq))


P1 = pc.g1_mul(pc.G1_GEN, 5)
Q1 = pc.g2_mul(pc.G2_GEN, 7)

# (pairs, mask, expected product check)
CASES = {
    # e(5G, 7H) * e(-5G, 7H) = 1, with a masked garbage lane between them
    "three_pairs_masked": (
        ([P1, pc.g1_mul(pc.G1_GEN, 9), pc.g1_neg(P1)], [Q1, pc.G2_GEN, Q1]),
        [True, False, True], True,
    ),
    # e(2*5G, 7H) * e(5G, -14H) = 1
    "two_pairs": (
        ([pc.g1_mul(P1, 2), P1], [Q1, pc.g2_neg(pc.g2_mul(Q1, 2))]),
        [True, True], True,
    ),
}


def test_miller_final_exp_and_check_match_jax():
    """One test (one worker) so the Miller-loop and final-exponentiation
    compiles serve every case."""
    fe = jax.jit(JP.final_exponentiation)
    miller = jax.jit(JP.miller_loop_product)
    for name, ((g1_pts, g2_pts), mask, expected) in CASES.items():
        p_aff, q_aff = affine_pairs(g1_pts, g2_pts)
        mask = np.array(mask)
        j_f = np.asarray(miller(p_aff, q_aff, mask))
        j_e = np.asarray(fe(j_f))
        t_f = TP.miller_loop_product(ix.to_torch(p_aff), ix.to_torch(q_aff), torch.as_tensor(mask))
        assert np.array_equal(ix.to_numpy(t_f), j_f), name
        t_e = TP.final_exponentiation(t_f)
        assert np.array_equal(ix.to_numpy(t_e), j_e), name
        t_ok = TP.pairing_product_is_one(ix.to_torch(p_aff), ix.to_torch(q_aff), torch.as_tensor(mask))
        assert bool(t_ok) == bool(np.asarray(JT.fq12_eq_one(j_e))) == expected, name


def test_product_check_rejects_an_unbalanced_product():
    p_aff, q_aff = affine_pairs([P1, pc.g1_neg(P1)], [Q1, pc.g2_mul(Q1, 2)])
    mask = torch.tensor([True, True])
    assert not bool(TP.pairing_product_is_one(ix.to_torch(p_aff), ix.to_torch(q_aff), mask))


def test_all_masked_pairs_give_one():
    p_aff, q_aff = affine_pairs([P1, P1], [Q1, Q1])
    mask = torch.tensor([False, False])
    f = TP.miller_loop_product(ix.to_torch(p_aff), ix.to_torch(q_aff), mask)
    assert bool(TT.fq12_eq_one(f))
    assert bool(TP.pairing_product_is_one(ix.to_torch(p_aff), ix.to_torch(q_aff), mask))


def test_easy_and_hard_parts_compose_to_the_final_exponentiation():
    p_aff, q_aff = affine_pairs([P1], [Q1])
    f = TP.miller_loop_product(ix.to_torch(p_aff), ix.to_torch(q_aff), torch.tensor([True]))
    assert torch.equal(TP.final_exp_hard_part(TP.final_exp_easy_part(f)), TP.final_exponentiation(f))


def test_line_product_tree_is_order_free():
    """The CUDA kernel multiplies the lines in another order than the plain
    version; Fq12 products are exact, so the fold order is invisible."""
    p_aff, q_aff = affine_pairs([P1, P1, P1], [Q1, pc.G2_GEN, Q1])
    r = JC.affine_to_jac(JC.FQ2_OPS, q_aff)
    del r
    xq, yq = ix.to_torch(q_aff)
    xp, yp = ix.to_torch(p_aff)
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as TC

    rj = TC.affine_to_jac(TC.FQ2_OPS, (xq, yq))
    _, line = TP._dbl_step(rj, xp, yp)
    mask = torch.tensor([True, True, True])
    tree = TP._combine_lines(line, mask)
    dense = [TP._line_to_fq12(tuple(c[i] for c in line)) for i in range(3)]
    left = TT.fq12_mul(TT.fq12_mul(dense[2], dense[0]), dense[1])
    assert torch.equal(tree, left)


def seeded_pairs(pairs, seed=41):
    """Seeded random Fq limbs (Montgomery form, < p) for P pairs, pair 1
    masked: the Miller loop's formulas need no points on the curve."""
    from lighthouse_tpu_torch.crypto.bls381.constants import P as FIELD_P
    from lighthouse_tpu_torch.crypto.torchbls import limbs as TL

    rng = np.random.default_rng(seed)

    def fq(shape):
        n = int(np.prod(shape))
        vals = [int.from_bytes(rng.bytes(48), "little") % FIELD_P for _ in range(n)]
        return np.stack([TL.pack(v) for v in vals]).reshape(tuple(shape) + (TL.NL,))

    mask = np.ones(pairs, bool)
    mask[1:2] = False
    return (fq((pairs,)), fq((pairs,))), (fq((pairs, 2)), fq((pairs, 2))), mask


@functools.lru_cache(maxsize=None)
def jax_miller_loop_batch():
    return jax.jit(JP.miller_loop_batch)


@functools.lru_cache(maxsize=None)
def port_miller_loop_batch(pairs):
    """The seeded inputs as torch tensors and the port's per-pair values,
    computed once for the tests below."""
    p_aff, q_aff, mask = seeded_pairs(pairs)
    args = (ix.to_torch(p_aff), ix.to_torch(q_aff), torch.as_tensor(mask))
    return (p_aff, q_aff, mask), args, TP.miller_loop_batch(*args)


def test_miller_loop_batch_matches_jax():
    """The per-pair values (sparse line products, masked lanes 1, conjugated
    per pair) at P = 3 with pair 1 masked, bit for bit."""
    (p_aff, q_aff, mask), _args, got = port_miller_loop_batch(3)
    want = np.asarray(jax_miller_loop_batch()(p_aff, q_aff, mask))
    assert got.shape == (3, 2, 3, 2, 24)
    assert np.array_equal(ix.to_numpy(got), want)
    assert bool(TT.fq12_eq_one(got[1]))


def test_tree_of_miller_loop_batch_is_miller_loop_product():
    """prod_i conj(f_i) equals the shared-accumulator value: what the CUDA
    kernel's phase 2 relies on."""
    _inputs, args, values = port_miller_loop_batch(3)
    tree = TP.fq12_product_any(values)
    assert torch.equal(tree, TP.miller_loop_product(*args))
