"""The port's CUDA kernels (torchbls.kernels): each against its plain
PyTorch version on the card, and the wrappers' routing on the CPU.

The `cuda` tests need a CUDA device and nvcc (they build csrc/ at first
use) and skip without one; on the GPU machine run

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q

This file imports no JAX, so it runs where the port runs. Tolerance: exact
equality (integer outputs, fully reduced field elements).
"""

import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from lighthouse_tpu_torch.crypto.bls381.constants import P

REPO = Path(__file__).resolve().parents[1]
FQ_MONT_MUL_CU = REPO / "lighthouse_tpu_torch" / "crypto" / "torchbls" / "csrc" / "fq_mont_mul.cu"


def cu_constants(path):
    """The `constexpr int NAME = expr;` lines of a CUDA source, evaluated in
    order (an expression may name an earlier constant)."""
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", path.read_text()):
        consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    return consts


FQ_TILE = cu_constants(FQ_MONT_MUL_CU)["TILE"]


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

    # many small int64 ops: intra-op threads would only contend with the
    # other test workers
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def rand_limbs(seed, shape):
    """Random limbs below 2^368 < p (top limb zero)."""
    a = np.random.default_rng(seed).integers(0, 1 << 16, size=tuple(shape) + (TL.NL,))
    a[..., -1] = 0
    return torch.as_tensor(a.astype(np.int64))


def flat(x):
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in flat(e)]
    return [x]


def assert_same(kernel_out, plain_out):
    ks, ps = flat(kernel_out), flat(plain_out)
    assert len(ks) == len(ps)
    for k, p in zip(ks, ps):
        assert torch.equal(k.cpu(), p.cpu())


def prepare_args(n, m, seed=1):
    rng = np.random.default_rng(seed)
    pk_mask = torch.as_tensor((np.arange(m)[None, :] < rng.integers(0, m + 1, size=(n, 1))).astype(np.int64))
    set_mask = torch.ones(n, dtype=torch.int64)
    set_mask[-1] = 0
    return (rand_limbs(seed, (n, m)), rand_limbs(seed + 1, (n, m)), pk_mask,
            rand_limbs(seed + 2, (n, 2)), rand_limbs(seed + 3, (n, 2)),
            torch.as_tensor(rng.integers(0, 2, size=(n, 64))), set_mask)


def pairs_args(n, seed=5):
    zp = tuple(rand_limbs(seed + i, (n,)) for i in range(3))
    zp[2][1] = 0                                  # an aggregate at infinity
    hj = tuple(rand_limbs(seed + 3 + i, (n, 2)) for i in range(3))
    sa = tuple(rand_limbs(seed + 6 + i, (2,)) for i in range(3))
    return zp, hj, sa, torch.tensor([1] * (n - 1) + [0])


def miller_args(pairs, seed=9):
    mask = torch.ones(pairs, dtype=torch.bool)
    mask[1:2] = False                             # pair 1 masked, where there is one
    return ((rand_limbs(seed, (pairs,)), rand_limbs(seed + 1, (pairs,))),
            (rand_limbs(seed + 2, (pairs, 2)), rand_limbs(seed + 3, (pairs, 2))), mask)


def h2c_args(n=4, seed=13):
    """Standard-form u-values (n, 2, 2, NL), lane 0 all zero (u = 0: SWU's
    exceptional xd == 0 case)."""
    us = rand_limbs(seed, (n, 2, 2))
    us[0] = 0
    return (us,)


CASES = {
    "fq_mont_mul": lambda: (rand_limbs(0, (1000,)), rand_limbs(1, (1000,))),
    "hash_to_g2": h2c_args,
    "final_exp_easy_part": lambda: (rand_limbs(12, (2, 3, 2)),),
    "stage_prepare": lambda: prepare_args(4, 8),
    "stage_pairs": lambda: pairs_args(4),
    "miller_loop_product": lambda: miller_args(5),
    "miller_loop_batch": lambda: miller_args(5),
    "final_exp_hard_part": lambda: (rand_limbs(11, (2, 3, 2)),),
}


def to_dev(x, dev):
    if isinstance(x, (tuple, list)):
        return type(x)(to_dev(e, dev) for e in x)
    return x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_the_card(name, cuda):
    wrapper, plain, _source, _replaces = K.KERNELS[name]
    args = CASES[name]()
    before = wrapper.launches
    got = wrapper(*to_dev(args, cuda))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert_same(got, plain(*args))


@pytest.mark.cuda
def test_fq_mont_mul_by_r2_on_the_card(cuda):
    """With no second operand the kernel multiplies by R^2 from constant
    memory: the Montgomery conversion h2c uses."""
    a = rand_limbs(3, (1000,))
    got = K.fq_mont_mul(a.to(cuda))
    assert_same(got, TL.mont_mul(a, TL.const(TL.R2_HOST, a)))


def test_fq_mont_mul_without_b_is_the_montgomery_conversion():
    a = rand_limbs(4, (3, 2, 2))
    assert_same(K.fq_mont_mul(a), TL.mont_mul(a, TL.const(TL.R2_HOST, a)))
    assert TL.unpack(TL.from_mont(K.fq_mont_mul(a))[1, 0, 1].numpy()) == TL.unpack(a[1, 0, 1].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [1, 2, 3, 5, 65, 129])
def test_miller_kernel_any_pair_count(pairs, cuda):
    """The product over any P (tree levels with odd stragglers), and each
    pair's value from phase 1 against the plain per-pair loop. The product
    launches phase 1 through miller_loop_batch, then its tree (none for
    P = 1)."""
    args = miller_args(pairs)
    before = (K.miller_loop_batch.launches, K.miller_loop_product.launches)
    assert_same(K.miller_loop_product(*to_dev(args, cuda)), K.miller_loop_product_plain(*args))
    assert (K.miller_loop_batch.launches - before[0],
            K.miller_loop_product.launches - before[1]) == (1, int(pairs > 1))
    assert_same(K.miller_loop_batch(*to_dev(args, cuda)), K.miller_loop_batch_plain(*args))


@pytest.mark.cuda
def test_hard_part_kernel_on_easy_part_outputs(cuda):
    """The hard-part kernel on the easy-part outputs of four seeded Fq12
    (cyclotomic, as on the main path) and on t = 1, whose hard part is 1:
    equal to the plain version."""
    one = torch.as_tensor(K.tw.FQ12_ONE.astype(np.int64))
    ts = [K.final_exp_easy_part(rand_limbs(30 + s, (2, 3, 2))) for s in range(4)] + [one]
    for t in ts:
        assert_same(K.final_exp_hard_part(t.to(cuda)), K.final_exp_hard_part(t))
    assert_same(K.final_exp_hard_part(one.to(cuda)), one)


@pytest.mark.cuda
def test_fq_mont_mul_edge_operands_on_the_card(cuda):
    """fq.cuh's carry-chain fp_mul on every pair of the edge operands 0, 1,
    p - 1, p - 2, R mod p, R^2 mod p and (2^381 - k) mod p: equal to the
    plain mont_mul."""
    r = (1 << 384) % P
    edges = [0, 1, P - 1, P - 2, r, r * r % P] + [((1 << 381) - k) % P for k in (1, 2, 3)]
    e = torch.as_tensor(np.stack([TL.pack(v) for v in edges]).astype(np.int64))
    a, b = e.repeat_interleave(len(edges), dim=0), e.repeat(len(edges), 1)
    assert_same(K.fq_mont_mul(a.to(cuda), b.to(cuda)), TL.mont_mul(a, b))


# 300007 elements are more tiles than a card-sized grid holds (132 SMs x at
# most 16 blocks of 128 threads, 270336 elements), so blocks take a second tile
FQ_SIZES = [0, 1, 31, 33, 130, FQ_TILE - 1, FQ_TILE, FQ_TILE + 1, 5 * FQ_TILE + 7, 300007]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["a*b", "r2"])
@pytest.mark.parametrize("n", FQ_SIZES)
def test_fq_mont_mul_tiles_and_tails_on_the_card(n, form, cuda):
    """fq_mont_mul in both forms (a * b, and by R^2) at sizes around its
    tile: none, one element, a warp either side, AggregateVerify's 130, a
    tile either side, several tiles and a partial one, more tiles than the
    grid has blocks. One launch each, equal to the plain version."""
    args = (rand_limbs(70, (n,)), rand_limbs(71, (n,)))[:2 if form == "a*b" else 1]
    dev_args = to_dev(args, cuda)
    before = K.fq_mont_mul.launches
    got = K.fq_mont_mul(*dev_args)
    torch.cuda.synchronize()
    assert K.fq_mont_mul.launches == before + 1
    assert got.shape == (n, TL.NL)
    assert_same(got, K.fq_mont_mul_plain(*dev_args))


@pytest.mark.cuda
def test_fq_mont_mul_on_strided_and_offset_views(cuda):
    """Every other row of a tensor (not contiguous: the wrapper copies it)
    and a slice that starts three elements in (contiguous, a storage offset
    of 3 x 192 bytes, 16-byte aligned), in both forms and as either
    operand: equal to the plain version."""
    n = 2 * FQ_TILE + 5
    every_other = rand_limbs(72, (2 * n,)).to(cuda)[::2]
    offset = rand_limbs(73, (n + 3,)).to(cuda)[3:]
    assert not every_other.is_contiguous() and offset.storage_offset() == 3 * TL.NL
    for args in ((every_other, offset), (offset, every_other), (every_other,), (offset,)):
        assert_same(K.fq_mont_mul(*args), K.fq_mont_mul_plain(*args))


@pytest.mark.cuda
def test_fq_mont_mul_refuses_a_misaligned_pointer(cuda):
    """The kernel moves 16-byte vectors, so the C entry point refuses a
    pointer off a 16-byte boundary, in any argument and in both forms, with
    cudaErrorMisalignedAddress (716) and the output untouched; the wrapper
    raises on a view that starts 8 bytes into an element, launching
    nothing."""
    n = FQ_TILE + 3
    flat = rand_limbs(74, (n + 1,)).to(cuda).reshape(-1)
    out = torch.full((n + 1, TL.NL), -1, dtype=torch.int64, device=cuda)
    a, o = flat.data_ptr(), out.data_ptr()
    lib = K.library().lib
    stream = torch.cuda.current_stream().cuda_stream
    for args in ((a + 8, a, o), (a, a + 8, o), (a, a, o + 8), (a + 8, None, o), (a, None, o + 8)):
        assert lib.lh_fq_mont_mul(*args, n, stream) == 716
    torch.cuda.synchronize()
    assert bool((out == -1).all())
    view = flat[1:1 + n * TL.NL].view(n, TL.NL)
    before = K.fq_mont_mul.launches
    for args in ((view, view), (view,)):
        with pytest.raises(RuntimeError, match="fq_mont_mul"):
            K.fq_mont_mul(*args)
    assert K.fq_mont_mul.launches == before


def test_fq_mont_mul_tile_layout():
    """csrc/fq_mont_mul.cu's tile as its header describes it, restated from
    its constants: a 16-byte vector is one 32-bit word (two int64 limbs);
    thread t's vectors k TILE + t cover the tile once, a warp's 32 at a
    time consecutive (512 bytes); the fill gives every (element, word) its
    own cell of the word-major rows with at most two-way bank conflicts, and
    a warp reading one word of its 32 elements hits 32 banks."""
    c = cu_constants(FQ_MONT_MUL_CU)
    tile, vecs, stride = c["TILE"], c["VECS"], c["STRIDE"]
    assert vecs * 16 == TL.NL * 8 and tile % 32 == 0 and stride >= tile
    cell = {}
    for k in range(vecs):
        for warp in range(tile // 32):
            v = [k * tile + 32 * warp + lane for lane in range(32)]
            assert v == list(range(v[0], v[0] + 32))
            for x in v:
                e, w = divmod(x, vecs)
                cell[x] = w * stride + e
            assert max(Counter(cell[x] % 32 for x in v).values()) <= 2
    assert sorted(cell) == list(range(tile * vecs))
    assert len(set(cell.values())) == tile * vecs
    for w in range(vecs):
        for warp in range(tile // 32):
            assert len({(w * stride + 32 * warp + i) % 32 for i in range(32)}) == 32


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 64, 65])
def test_hash_to_g2_at_warp_and_grid_edges(n, cuda):
    """hash_to_g2 (a warp per message, two teams of 16 lanes) at n = 1, 3,
    64 and 65, lane 0 u = 0 (the xd == 0 case), seeded u-values of both
    is_qr classes, against the plain version on the card."""
    (us,) = h2c_args(n, seed=20 + n)
    us_dev = us.to(cuda)
    got = K.hash_to_g2(us_dev)
    torch.cuda.synchronize()
    assert_same(got, K.hash_to_g2_plain(us_dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (4, 512), (64, 128)])
def test_stage_prepare_at_the_path_buckets(n, m, cuda):
    """stage_prepare on teams at (1, 1), the sync bucket (4, 512) and the
    gossip bucket (64, 128), with a padded last set (n > 1), a set whose
    pubkeys are all masked (an aggregate at infinity: the bad flag) and
    two equal pubkeys in set 0 (the tree's doubling case)."""
    args = list(prepare_args(n, m, seed=30 + n))
    if m > 1:
        args[0][0, 1], args[1][0, 1] = args[0][0, 0], args[1][0, 0]
        args[2][0, :2] = 1
    if n > 2:
        args[2][1] = 0
    dev_args = to_dev(tuple(args), cuda)
    got = K.stage_prepare(*dev_args)
    torch.cuda.synchronize()
    assert_same(got, K.stage_prepare_plain(*dev_args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16, 32, 64])
def test_stage_pairs_across_warp_edges(n, cuda):
    """stage_pairs (a thread per Z lane, a warp of 32 in step) at n = 4, 16,
    32 and 64: 9, 33, 65 and 129 lanes, one warp and a lane past whole
    warps. A G1 and a G2 lane at the identity (Z = 0), a G1 lane, a G2
    lane and the signature with Z = Montgomery one (AggregateVerify's
    lanes), a masked set: equal to the plain version."""
    zp, hj, sa, mask = pairs_args(n, seed=40 + n)
    one = torch.as_tensor(TL.ONE_MONT.astype(np.int64))
    zp[2][2] = one
    hj[2][0] = 0
    hj[2][3] = 0
    hj[2][3, 0] = one
    sa[2][:] = 0
    sa[2][0] = one
    args = (zp, hj, sa, mask)
    before = K.stage_pairs.launches
    got = K.stage_pairs(*to_dev(args, cuda))
    torch.cuda.synchronize()
    assert K.stage_pairs.launches == before + 1
    assert_same(got, K.stage_pairs_plain(*args))


@pytest.mark.cuda
def test_easy_part_on_seeded_and_half_zero_elements(cuda):
    """final_exp_easy_part (form programs around one thread's inversion) on
    three seeded Fq12 and on two with a zero Fq6 half: equal to the plain
    version."""
    ms = [rand_limbs(50 + s, (2, 3, 2)) for s in range(5)]
    ms[3][1] = 0
    ms[4][0] = 0
    for m in ms:
        assert_same(K.final_exp_easy_part(m.to(cuda)), K.final_exp_easy_part(m))


@pytest.mark.cuda
def test_fq_inversion_on_the_card(cuda):
    """fq.cuh's binary-GCD fp_inv (csrc/latency.cu's lh_inverse, variant 1)
    and the Fermat chain it replaced (variant 0) on seeded elements and the
    edges 0, 1, p - 1, p - 2, R mod p, R^2 mod p, 2^380, (2^381 - k) mod p:
    both equal to the plain limbs.mont_inv, across two warps."""
    r = (1 << 384) % P
    edges = [0, 1, P - 1, P - 2, r, r * r % P, 1 << 380] + [((1 << 381) - k) % P
                                                           for k in (1, 2, 3)]
    x = torch.cat([rand_limbs(60, (54,)),
                   torch.as_tensor(np.stack([TL.pack(v) for v in edges]).astype(np.int64))])
    lib = K.latency_library().lib
    xd = x.to(cuda)
    want = TL.mont_inv(x)
    for variant in (0, 1):
        out = torch.empty_like(xd)
        assert lib.lh_inverse(variant, x.shape[0], 1, xd.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert_same(out, want)


@pytest.mark.parametrize("name", ["fq_mont_mul", "final_exp_hard_part", "hash_to_g2",
                                  "final_exp_easy_part", "miller_loop_batch"])
def test_cpu_tensors_take_the_plain_version(name):
    wrapper, plain, _source, _replaces = K.KERNELS[name]
    args = CASES[name]()
    before = wrapper.launches
    assert_same(wrapper(*args), plain(*args))
    assert wrapper.launches == before


def test_other_devices_are_refused():
    a = torch.zeros((2, TL.NL), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        K.fq_mont_mul(a, a)


def test_consts_header_carries_the_field_constants():
    text = K.consts_header()
    inv = int(re.search(r"#define FP_INV 0x([0-9a-f]+)u", text).group(1), 16)
    assert (inv * P) % (1 << 32) == (1 << 32) - 1      # -p^-1 mod 2^32
    words = [int(w, 16) for w in re.search(r"FP_P\[12\] = \{([^}]*)\}", text).group(1)
             .replace("u", "").split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == P
    assert text.count("FROB1[6][2][12]") == text.count("FROB2[6][2][12]") == 1
    assert "PSI_CX[2][12]" in text and "PSI_CY[2][12]" in text
    r3 = [int(w, 16) for w in re.search(r"FP_R3\[12\] = \{([^}]*)\}", text).group(1)
          .replace("u", "").split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(r3)) == pow(1 << 384, 3, P)   # R^3 mod p
    assert "FP_PM2" not in text      # the Fermat chain is latency.cu's baseline alone


KERNEL_NAMES = ["final_exp_easy_part", "final_exp_hard_part", "fq_mont_mul", "hash_to_g2",
                "miller_loop_batch", "miller_loop_product", "msm_fixed", "msm_precompute",
                "msm_varying", "stage_pairs", "stage_prepare"]

# kernels that replace an XLA function of the JAX package, not a Pallas kernel
XLA_FUNCTIONS = {"final_exp_easy_part": "final_exponentiation",
                 "miller_loop_batch": "miller_loop_batch",
                 "msm_precompute": "_precompute_kernel",
                 "msm_fixed": "_msm_kernel",
                 "msm_varying": "varying_base_msm_kernel"}


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_table_points_at_sources_and_pallas_kernels(name):
    """Each kernel replaces a Pallas kernel (its def or its pallas_call),
    apart from the easy part, the per-pair Miller loop and the MSM's three
    programs, which replace the XLA functions that computed them: their
    `replaces` line holds that function's def."""
    assert sorted(K.KERNELS) == KERNEL_NAMES
    _wrapper, _plain, source, replaces = K.KERNELS[name]
    assert (K.CSRC / source).exists()
    assert source in K.SOURCES
    path, line = replaces.split(":")
    text = (REPO / path).read_text().splitlines()
    pattern = (rf"^def {XLA_FUNCTIONS[name]}\(" if name in XLA_FUNCTIONS
               else r"def _\w+_kernel\(|pl\.pallas_call\(")
    assert re.search(pattern, text[int(line) - 1]), replaces


# ------------------------------------------------------------ G1 MSM (csrc/msm.cu)


def msm_points(n, seed):
    """n seeded G1 points (every fourth the identity) and n scalars mod r."""
    import random

    from lighthouse_tpu_torch.crypto.bls381 import curve as cv
    from lighthouse_tpu_torch.crypto.bls381.constants import R

    rng = random.Random(seed)
    pts = [None if i % 4 == 3 else cv.g1_mul(cv.G1_GEN, rng.randrange(1, R)) for i in range(n)]
    return pts, [rng.randrange(R) for _ in range(n)]


def host_msm(points, scalars):
    from lighthouse_tpu_torch.crypto.bls381 import curve as cv
    from lighthouse_tpu_torch.crypto.bls381.constants import R

    acc = None
    for p, s in zip(points, scalars):
        if p is not None and s % R:
            acc = cv.g1_add(acc, cv.g1_mul(p, s % R))
    return acc


def msm_point_args(pts, dev):
    from lighthouse_tpu_torch.crypto.torchbls.backend import pack_ints_vec

    return tuple(torch.as_tensor(a, device=dev) for a in (
        pack_ints_vec([0 if p is None else p[0] for p in pts]).astype(np.int64),
        pack_ints_vec([0 if p is None else p[1] for p in pts]).astype(np.int64),
        np.array([p is None for p in pts])))


def chain_points(n, seed, every_identity):
    """n seeded G1 points a + i b (cheap at thousands of points), every
    every_identity-th the identity (none at 0)."""
    import random

    from lighthouse_tpu_torch.crypto.bls381 import curve as cv
    from lighthouse_tpu_torch.crypto.bls381.constants import R

    rng = random.Random(seed)
    a, b = (cv.g1_mul(cv.G1_GEN, rng.randrange(1, R)) for _ in range(2))
    pts = []
    for i in range(n):
        pts.append(None if every_identity and i % every_identity == every_identity - 1 else a)
        a = cv.g1_add(a, b)
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("every_identity", [4, 0])
@pytest.mark.parametrize("n", [1, 6, 129, 132 * 32 + 1, 4096])
def test_msm_precompute_kernel_matches_plain(cuda, n, every_identity):
    """Every Jacobian limb of the comb tables, with every fourth point the
    identity and with none; 4096 is the KZG setup's width, and 132 x 32 + 1
    points leave the last block one team."""
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    pts = chain_points(n, 0x100 + n, every_identity)
    args = msm_point_args(pts, cuda)
    before = K.msm_precompute.launches
    got = K.msm_precompute(*args)
    assert K.msm_precompute.launches == before + 1
    assert_same(got, TM.precompute_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "zero", "one_hot", "r", "r_minus_1"])
def test_msm_fixed_kernel_matches_plain_and_host(cuda, case):
    """The comb MSM over six points (one the identity) at random scalars and
    at the edge scalars: all zero, a one-hot 1, R (reduced to 0 on the host,
    so the same sums as all zero) and R - 1 (-P)."""
    import random

    from lighthouse_tpu_torch.crypto.bls381.constants import R
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    pts, _ = msm_points(6, 0x115)
    fixed = TM.FixedBaseMSM(pts, cuda)
    sel = [random.Random(0x117).randrange(R) for _ in pts] if case == "random" else [0] * 6
    if case != "random":
        sel[0] = {"zero": 0, "one_hot": 1, "r": R, "r_minus_1": R - 1}[case]
    bits = fixed.bits_tensor(sel)
    got = K.msm_fixed(*fixed._tables, bits)
    assert_same(got, TM.fixed_msm_plain(*fixed._tables, bits))
    assert TM.affine_result(*got) == host_msm(pts, sel)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_bucket", "zero", "quarter_identity"])
def test_msm_fixed_bucket_edges_on_the_card(cuda, case):
    """The bucket sum's edges over 16 points (256 comb lanes): every lane's
    chunk equal (one bucket a window, its tree at every level), every
    chunk 0 (no bucket), and random scalars with every fourth table point
    the identity (msm_points)."""
    import random

    from lighthouse_tpu_torch.crypto.bls381.constants import R
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    pts, _ = msm_points(16, 0x118)
    fixed = TM.FixedBaseMSM(pts, cuda)
    rng = random.Random(0x119)
    scalars = [rng.randrange(R) for _ in pts]
    bits = fixed.bits_tensor(scalars)
    if case == "one_bucket":
        bits[:] = torch.tensor([(0xA5C3 >> (15 - b)) & 1 for b in range(16)], device=cuda)
        scalars = [sum(0xA5C3 << (16 * j) for j in range(TM.N_CHUNKS))] * len(pts)
    elif case == "zero":
        bits[:] = 0
        scalars = [0] * len(pts)
    got = K.msm_fixed(*fixed._tables, bits)
    assert_same(got, TM.fixed_msm_plain(*fixed._tables, bits))
    assert TM.affine_result(*got) == host_msm(pts, scalars)


@pytest.mark.cuda
@pytest.mark.parametrize("window, n", [(0, 4), (0, 32), (4, 4), (4, 32), (4, 256), (2, 8),
                                       (5, 8), (6, 8)])
def test_msm_varying_kernel_matches_plain_and_host(cuda, window, n):
    """The varying-base MSM at each width (0: the bit form), over one block
    and over two (n = 256)."""
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    pts, scalars = msm_points(n, 0x200 + n)
    px, py, inf = msm_point_args(pts, cuda)
    digits = torch.as_tensor(TM.msm_digits(scalars, window).astype(np.int64), device=cuda)
    got = K.msm_varying(px, py, ~inf, digits, window)
    assert_same(got, TM.varying_base_msm_plain(px, py, ~inf, digits, window))
    assert TM.affine_result(*got) == host_msm(pts, scalars)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["opposite", "equal"])
@pytest.mark.parametrize("form", ["fixed", "varying_w4", "varying_w0"])
def test_msm_sums_of_opposite_and_equal_points(cuda, form, pair):
    """[P, -P] with equal scalars sums to the identity (the complete add's
    P == -Q branch, in the lanes' sum); [P, P] to 2 k P (its doubling
    branch). The comb MSM and the varying-base MSM at w = 4 and in the bit
    form, each against its plain version and the host curve."""
    from lighthouse_tpu_torch.crypto.bls381 import curve as cv
    from lighthouse_tpu_torch.crypto.torchbls import backend as TB
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    (pt,), (k,) = msm_points(1, 0x400)
    pts = [pt, cv.g1_neg(pt) if pair == "opposite" else pt]
    want = None if pair == "opposite" else cv.g1_mul(pt, 2 * k)
    if form == "fixed":
        fixed = TM.FixedBaseMSM(pts, cuda)
        args = (*fixed._tables, fixed.bits_tensor([k, k]))
        got, plain = K.msm_fixed(*args), TM.fixed_msm_plain(*args)
    else:
        w = 4 if form == "varying_w4" else 0
        args = TB.TorchBackend(device=cuda).msm_inputs(pts, [k, k], w)
        got, plain = K.msm_varying(*args, w), TM.varying_base_msm_plain(*args, w)
    assert_same(got, plain)
    assert TM.affine_result(*got) == want == host_msm(pts, [k, k])


@pytest.mark.cuda
def test_msm_varying_refuses_what_its_kernel_does_not_take(cuda):
    """A window with no form and digits that do not cover 256 bits are
    refused at the call; a digit past its window's table, on the card, as
    the REFUSED sum that affine_result raises on."""
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    pts, scalars = msm_points(4, 0x300)
    px, py, inf = msm_point_args(pts, cuda)
    digits = torch.as_tensor(TM.msm_digits(scalars, 4).astype(np.int64), device=cuda)
    with pytest.raises(ValueError, match="window 3"):
        K.msm_varying(px, py, ~inf, digits, 3)
    with pytest.raises(ValueError, match="digits"):
        K.msm_varying(px, py, ~inf, digits, 5)
    for w, past in ((4, 16), (0, 16), (4, -1), (2, 4), (5, 32), (6, 64)):
        wide = torch.as_tensor(TM.msm_digits(scalars, w).astype(np.int64), device=cuda)
        wide[1, 3] = past
        before = K.msm_varying.launches
        out = K.msm_varying(px, py, ~inf, wide, w)
        assert K.msm_varying.launches == before + 1
        with pytest.raises(ValueError, match="outside"):
            TM.affine_result(*out)


# ------------------------------------------------------------ tree hash and epoch (torchhash)

HASH_KERNELS = {"epoch_deltas": "_device_epoch_kernel", "sha256_ladder": "_make_ladder",
                "sha256_msgs": "sha256_msgs_device"}


@pytest.mark.parametrize("name", sorted(HASH_KERNELS))
def test_hash_kernel_table_points_at_sources_and_jax_programs(name):
    """Each torchhash kernel replaces a jitted program of the JAX package's
    jaxhash/: its `replaces` line holds that program's def."""
    from lighthouse_tpu_torch.torchhash import kernels as HK

    assert sorted(HK.KERNELS) == sorted(HASH_KERNELS)
    assert not set(HK.KERNELS) & set(K.KERNELS)
    _wrapper, _plain, source, replaces = HK.KERNELS[name]
    assert (HK.CSRC / source).exists() and source in HK.SOURCES
    path, line = replaces.split(":")
    text = (REPO / path).read_text().splitlines()
    assert re.search(rf"^def {HASH_KERNELS[name]}\(", text[int(line) - 1]), replaces


def hash_words(n, seed, dev):
    a = np.random.default_rng(seed).integers(-(1 << 31), 1 << 31, (n, 8), dtype=np.int64)
    return torch.as_tensor(a.astype(np.int32), device=dev)


def epoch_args(n, seed, dev, leaking=False, big_scores=False):
    """Seeded epoch inputs: effective balances of 0-32 ETH, flag masks, and
    scores below 50 or, with big_scores, near 2^64 / 32 ETH."""
    rng = np.random.default_rng(seed)
    eff = rng.choice([0, 16, 31, 32, 32], n).astype(np.int64) * 10**9
    hi = 500_000_000 if big_scores else 50
    scores = rng.integers(0, hi, n, dtype=np.int64)
    masks = [torch.as_tensor(rng.random(s) < 0.8, device=dev) for s in ((3, n), n, n)]
    return (torch.as_tensor(eff, device=dev), *masks, torch.as_tensor(scores, device=dev),
            21_845, 10**9, [n * 7, n * 8, n * 6], n * 30, 4 * 50_331_648, leaking)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 1023, 1024, 1025, 1 << 16])
def test_sha256_ladder_matches_plain_on_the_card(n, cuda):
    from lighthouse_tpu_torch.torchhash import kernels as HK

    words = hash_words(n, 0x5A + n, cuda)
    before = HK.sha256_ladder.launches
    got = HK.sha256_ladder(words)
    torch.cuda.synchronize()
    assert HK.sha256_ladder.launches == before + len(HK.ladder_widths(n))  # one a level
    assert [g.shape[0] for g in got] == HK.ladder_widths(n)
    assert_same(got, HK.sha256_ladder_plain(words))
    # an offset view (not on a 16-byte boundary) gives the same levels
    if n > 2:
        assert_same(HK.sha256_ladder(words[1:]), HK.sha256_ladder_plain(words[1:]))


@pytest.mark.cuda
def test_sha256_ladder_of_zero_leaves_on_the_card(cuda):
    from lighthouse_tpu_torch.ssz.core import ZERO_HASHES
    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import kernels as HK

    levels = HK.sha256_ladder(torch.zeros((1 << 12, 8), dtype=torch.int32, device=cuda))
    assert [engine.leaves_from_words(lvl[:1].cpu().numpy())[0].tobytes()
            for lvl in levels] == ZERO_HASHES[1:13]


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 55, 56, 63, 64, 65, 119, 128])
def test_sha256_msgs_matches_hashlib_on_the_card(length, cuda):
    import hashlib

    from lighthouse_tpu_torch.torchhash import engine
    from lighthouse_tpu_torch.torchhash import kernels as HK

    engine.set_device(cuda)
    try:
        msgs = np.random.default_rng(length).integers(0, 256, (300, length), dtype=np.uint8)
        before = HK.sha256_msgs.launches
        got = engine.sha256_msgs_device(msgs)
        assert HK.sha256_msgs.launches == before + 1
    finally:
        engine.set_device(None)
    assert all(got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest() for i in range(300))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["steady", "leak", "near_2_64"])
@pytest.mark.parametrize("n", [1, 255, 4097])
def test_epoch_deltas_matches_plain_on_the_card(case, n, cuda):
    from lighthouse_tpu_torch.torchhash import kernels as HK

    args = epoch_args(n, 0xE0 + n, cuda, leaking=case == "leak", big_scores=case == "near_2_64")
    before = HK.epoch_deltas.launches
    got = HK.epoch_deltas(*args)
    torch.cuda.synchronize()
    assert HK.epoch_deltas.launches == before + 1
    assert_same(got, HK.epoch_deltas_plain(*args))
    if case == "near_2_64":
        eff, scores = args[0].cpu().tolist(), args[4].cpu().tolist()
        assert any(e * s >= 2**63 for e, s in zip(eff, scores)) or n == 1


def test_hash_wrappers_take_the_plain_versions_on_the_cpu():
    from lighthouse_tpu_torch.torchhash import kernels as HK

    for name, args in (("sha256_ladder", (hash_words(65, 1, "cpu"),)),
                       ("sha256_msgs", (hash_words(6, 2, "cpu").reshape(3, 16),)),
                       ("epoch_deltas", epoch_args(33, 3, "cpu", big_scores=True))):
        wrapper, plain, _source, _replaces = HK.KERNELS[name]
        before = wrapper.launches
        assert_same(wrapper(*args), plain(*args))
        assert wrapper.launches == before
    with pytest.raises(ValueError, match="device"):
        HK.epoch_deltas(*epoch_args(4, 4, "meta"))


# ------------------------------------------- per-stage attribution (observability/device.py)


@pytest.mark.cuda
def test_attributed_stage_is_event_timed_on_the_card(cuda):
    """An attributed hash_to_g2 on CUDA tensors: its device seconds come from
    CUDA events (positive), the first dispatch at the bucket is the first
    use, and the span's host bounds hold the event time."""
    from lighthouse_tpu_torch.observability import device as obsdev
    from lighthouse_tpu_torch.observability.trace import Trace

    obsdev.reset_seen()
    us = rand_limbs(41, (4, 2, 2)).to(cuda)
    tr = Trace("gossip_attestation", 4)
    with obsdev.attributed():
        attr = obsdev.begin((4, 3), trace=tr)
        for _ in range(3):
            out = obsdev.run_stage(attr, "h2c", K.hash_to_g2, us)
    assert all(torch.equal(a, b) for a, b in zip(out, K.hash_to_g2_plain(us)))
    child = obsdev.STAGE_DEVICE_SECONDS.labels("h2c", 4, 3)
    assert child.n == 2 and child.total > 0
    assert obsdev.STAGE_COMPILE_SECONDS.labels("h2c", 4, 3).value > 0
    assert [s[3]["phase"] for s in tr.spans] == ["compile", "execute", "execute"]
    _name, t0, t1, _args = tr.spans[-1]
    assert t1 - t0 >= 0.5 * child.total / child.n


@pytest.mark.cuda
def test_stage_dispatch_opens_an_nvtx_range_on_the_card(cuda, monkeypatch):
    """Attribution off: a stage on CUDA tensors runs inside the NVTX range
    torchbls:<stage>, one on CPU tensors in none, and nothing is recorded."""
    from lighthouse_tpu_torch.observability import device as obsdev

    ranges = []
    real = torch.cuda.nvtx.range

    def spy(name):
        ranges.append(name)
        return real(name)

    monkeypatch.setattr(torch.cuda.nvtx, "range", spy)
    x = torch.ones((16,), device=cuda)
    n0 = obsdev.STAGE_DEVICE_SECONDS.labels("pairs", 4, 5).n
    assert obsdev.run_stage(None, "pairs", lambda t: t + 1, x).sum().item() == 32
    assert obsdev.run_stage(None, "pairs", lambda t: t + 1, x.cpu()).sum().item() == 32
    assert ranges == ["torchbls:pairs"]
    assert obsdev.STAGE_DEVICE_SECONDS.labels("pairs", 4, 5).n == n0

