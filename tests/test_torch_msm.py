"""The port's G1 MSM (torchbls.curve_ops' windowed scalar multiplication,
digits and masked tree sum; torchbls.msm's comb tables, fixed-base and
varying-base MSM; TorchBackend.g1_msm / g1_msm_fixed) against the JAX
package on the CPU, with the same seeded inputs.

Tolerance: exact equality. The Jacobian outputs (scalar_mul_windowed,
masked_tree_sum, the comb tables) are the same formulas over exact field
arithmetic, so their limbs agree bit for bit; the MSMs return host affine
ints. The JAX side runs at the shapes tests/test_jaxbls_msm.py compiles
(its six points, one of them the identity, in a bucket of 8) and compiles
no pairing. The csrc/msm.cu kernels are held against these plain versions
on the card by tests/test_torch_kernels.py, which imports no JAX.
"""

import functools
import random

import jax
import numpy as np
import pytest

from lighthouse_tpu.crypto.bls381 import curve as cv
from lighthouse_tpu.crypto.bls381.constants import P, R
from lighthouse_tpu.crypto.jaxbls import curve_ops as JC

# torch and the port's modules load when this file's first test runs, not
# at collection, so a test worker that only runs the JAX package's tests
# never loads torch.
torch = TC = TM = ix = TB = K = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    global torch, TC, TM, ix, TB, K
    import torch
    from lighthouse_tpu_torch.crypto.torchbls import backend as TB
    from lighthouse_tpu_torch.crypto.torchbls import curve_ops as TC
    from lighthouse_tpu_torch.crypto.torchbls import interchange as ix
    from lighthouse_tpu_torch.crypto.torchbls import kernels as K
    from lighthouse_tpu_torch.crypto.torchbls import msm as TM

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def host_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        if p is None or s % R == 0:
            continue
        acc = cv.g1_add(acc, cv.g1_mul(p, s % R))
    return acc


@pytest.fixture(scope="module")
def points():
    """tests/test_jaxbls_msm.py's six points, the identity at index 2."""
    rng = random.Random(0x115)
    pts = [cv.g1_mul(cv.G1_GEN, rng.randrange(1, R)) for _ in range(5)]
    pts.insert(2, None)
    return pts


def mont_jac(pts):
    """Host affine points (None = identity) -> Montgomery Jacobian uint32
    limbs (X, Y, Z), each (n, 24), Z = 0 on the identity lanes."""
    rm = (1 << 384) % P
    zero = JC.lb.pack(0)

    def mont(v):
        return JC.lb.pack(v * rm % P)

    x = np.stack([zero if p is None else mont(p[0]) for p in pts])
    y = np.stack([zero if p is None else mont(p[1]) for p in pts])
    z = np.stack([zero if p is None else mont(1) for p in pts])
    return x, y, z


EIGHT = [cv.g1_mul(cv.G1_GEN, k) for k in (3, 5, 7, 11, 13, 17, 19)]
EIGHT.insert(3, None)


def assert_same(port, ref):
    got = ix.to_numpy(port)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------ curve_ops


@pytest.mark.parametrize("window", [2, 4, 5, 6])
def test_scalars_to_digits_match_jax(window):
    rng = random.Random(0x5D + window)
    zs = [rng.randrange(R) for _ in range(8)] + [0, R - 1]
    got = TC.scalars_to_digits(zs, 256, window)
    np.testing.assert_array_equal(got, JC.scalars_to_digits(zs, 256, window))
    assert got.shape == (10, -(-256 // window))


@pytest.mark.parametrize("window", [2, 4, 5, 6])
def test_scalar_mul_windowed_matches_jax(window):
    """Eight lanes (one the identity), 64-bit scalars (zero among them): the
    Jacobian outputs of the two packages' windowed multiplication."""
    rng = random.Random(0x3A + window)
    zs = [rng.getrandbits(64) for _ in range(7)] + [0]
    digits = JC.scalars_to_digits(zs, 64, window)
    pt = mont_jac(EIGHT)
    fn = jax.jit(functools.partial(JC.scalar_mul_windowed, ops=JC.FQ_OPS, window=window))
    want = jax.device_get(fn(pt, digits))
    got = TC.scalar_mul_windowed(ix.to_torch(pt), ix.to_torch(digits), TC.FQ_OPS, window=window)
    assert_same(got, want)
    # and the affine values are the host's
    x, y, inf = TC.jac_to_affine(got, TC.FQ_OPS)
    xs, ys = TM.lb.from_mont(x).numpy(), TM.lb.from_mont(y).numpy()
    for i, (p, z) in enumerate(zip(EIGHT, zs)):
        want_pt = None if p is None or z == 0 else cv.g1_mul(p, z)
        assert bool(inf[i]) == (want_pt is None)
        if want_pt is not None:
            assert (TM.lb.unpack(xs[i]), TM.lb.unpack(ys[i])) == want_pt


def test_masked_tree_sum_matches_jax():
    mask = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.uint32)
    pt = mont_jac(EIGHT)
    fn = jax.jit(lambda p, m: JC.masked_tree_sum(p, m, JC.FQ_OPS))
    want = jax.device_get(fn(pt, mask))
    got = TC.masked_tree_sum(ix.to_torch(pt), ix.to_torch(mask), TC.FQ_OPS)
    assert_same(got, want)


# ------------------------------------------------------------ msm_window


@pytest.mark.parametrize(
    "window, windowed, want",
    [("", "", 4), ("6", "", 6), ("0", "1", 0), ("3", "", 4), ("bad", "0", 0), ("", "0", 0),
     ("", "off", 0), ("", "1", 4), ("", "yes", 4), ("2", "0", 2), ("5", "", 5)],
)
def test_msm_window_env_precedence(monkeypatch, window, windowed, want):
    """LIGHTHOUSE_TPU_MSM_WINDOW (0, 2, 4, 5 or 6; anything else falls
    through) over the legacy LIGHTHOUSE_TPU_MSM_WINDOWED over the default,
    w = 4 on every device."""
    for name, value in (("LIGHTHOUSE_TPU_MSM_WINDOW", window),
                        ("LIGHTHOUSE_TPU_MSM_WINDOWED", windowed)):
        if value:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)
    assert TM.msm_window() == want


# ------------------------------------------------------------ fixed base


@pytest.fixture(scope="module")
def jax_fixed(points):
    from lighthouse_tpu.crypto.jaxbls.msm import FixedBaseMSM

    return FixedBaseMSM(points)


@pytest.fixture(scope="module")
def port_fixed(points):
    return TM.FixedBaseMSM(points, "cpu")


def test_precompute_tables_match_jax(jax_fixed, port_fixed):
    """The comb tables, Montgomery Jacobian (16 rows of 8 lanes), through
    the interchange function that carries the JAX tables across."""
    want = ix.fixed_base_tables(jax_fixed._tables)
    assert [tuple(t.shape) for t in want] == [(16 * 8, 24)] * 3
    for got, w in zip(port_fixed._tables, want):
        assert torch.equal(got, w)


def test_fixed_base_msm_matches_jax(points, jax_fixed, port_fixed):
    rng = random.Random(0x116)
    for trial in range(2):
        scalars = [rng.randrange(0, R) for _ in range(len(points))]
        got = port_fixed.msm(scalars)
        assert got == jax_fixed.msm(scalars), f"trial {trial}"
        assert got == host_msm(points, scalars)


@pytest.mark.parametrize("case", ["zero", "one_hot", "r", "r_minus_1"])
def test_fixed_base_msm_edge_scalars(points, port_fixed, case):
    """All zero -> the identity; a one-hot 1 -> the point; R -> the
    identity (R is reduced to 0 on the host, as JAX's _bits does); R - 1
    -> -P."""
    sel = [0] * len(points)
    sel[0] = {"zero": 0, "one_hot": 1, "r": R, "r_minus_1": R - 1}[case]
    want = {"zero": None, "one_hot": points[0], "r": None,
            "r_minus_1": cv.g1_neg(points[0])}[case]
    assert port_fixed.msm(sel) == want


def test_fixed_msm_takes_scalars_of_the_set_only(port_fixed):
    with pytest.raises(ValueError, match="expected 6 scalars"):
        port_fixed.msm([1, 2])


# ------------------------------------------------------------ varying base


@pytest.mark.parametrize("window", [0, 4])
def test_g1_msm_matches_jax(points, monkeypatch, window):
    """TorchBackend.g1_msm (kernels.msm_varying's plain version on the CPU)
    against JaxBackend.g1_msm, both at `window`: bucket 8, the identity
    lane masked."""
    from lighthouse_tpu.crypto.bls import api as jax_api

    monkeypatch.setenv("LIGHTHOUSE_TPU_MSM_WINDOW", str(window))
    rng = random.Random(0x7711)
    scalars = [rng.randrange(R) for _ in points]
    want = jax_api.set_backend("jax").g1_msm(points, scalars)
    got = TB.TorchBackend(device="cpu").g1_msm(points, scalars)
    assert got == want == host_msm(points, scalars)


def test_g1_msm_fixed_caches_tables_by_point_list(points, monkeypatch):
    """One precompute per point list (the list is kept, so its id stays
    valid); another list of the same points builds its own tables; the
    cache holds four lists at most."""
    be = TB.TorchBackend(device="cpu")
    built = []
    real = TM.FixedBaseMSM

    class Counting(real):
        def __init__(self, pts, device):
            built.append(len(pts))
            super().__init__(pts, device)

    class Recording:
        """Stands in for the tables of the later lists, whose sums this
        test does not read."""

        def __init__(self, pts, device):
            built.append(len(pts))

        def msm(self, scalars):
            return None

    monkeypatch.setattr(TM, "FixedBaseMSM", Counting)
    small = [points[0], points[1], None, points[3]]
    be.g1_msm_fixed(small, [1, 0, 5, 0])
    assert be.g1_msm_fixed(small, [2, 0, 0, 0]) == cv.g1_mul(points[0], 2)
    assert built == [4]
    monkeypatch.setattr(TM, "FixedBaseMSM", Recording)
    others = [list(small) for _ in range(4)]
    for o in others:
        be.g1_msm_fixed(o, [0, 1, 0, 0])
    assert built == [4] * 5
    assert len(be._fixed_msm_cache) == 4 and id(small) not in be._fixed_msm_cache
    assert all(id(o) in be._fixed_msm_cache for o in others)


def test_kzg_lincomb_takes_the_fixed_base_path_from_256_points():
    """kzg._g1_lincomb: the comb path for a stable set of 256 points or
    more, the varying-base MSM otherwise."""
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.crypto.bls import api

    calls = []

    class Recorder:
        def g1_msm_fixed(self, pts, scalars):
            calls.append(("fixed", len(pts)))
            return cv.G1_GEN

        def g1_msm(self, pts, scalars):
            calls.append(("var", len(pts)))
            return cv.G1_GEN

    prev = api._active_backend
    try:
        api._active_backend = Recorder()
        big = [cv.G1_GEN] * 256
        kzg._g1_lincomb(big, [1] * 256, fixed_base=True)
        kzg._g1_lincomb(big, [1] * 256)
        kzg._g1_lincomb(big[:4], [1] * 4, fixed_base=True)
    finally:
        api._active_backend = prev
    assert calls == [("fixed", 256), ("var", 256), ("var", 4)]


def test_msm_wrappers_take_the_plain_version_on_cpu(points):
    """CPU tensors take the plain versions and launch nothing; a tensor on
    another device is refused."""
    before = {k: K.KERNELS[k][0].launches for k in ("msm_precompute", "msm_fixed", "msm_varying")}
    fixed = TM.FixedBaseMSM(points[:4], "cpu")
    fixed.msm([3, 1, 4, 1])
    TB.TorchBackend(device="cpu").g1_msm(points[:2], [5, 7])
    assert {k: K.KERNELS[k][0].launches for k in before} == before
    meta = torch.zeros((4, 24), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        K.msm_precompute(meta, meta, torch.zeros((4,), dtype=torch.bool, device="meta"))
