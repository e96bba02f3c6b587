"""The port's hand-written CUDA kernels (csrc/*.cu), their ctypes wrappers,
launch counters and plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors; there is no fallback from one to the other. A wrapper adds
one to its `launches` attribute where it launches, and nowhere else. The
kernels are built at first use (utils/torchcfg.build_kernels), never at
import, and take the JAX package's interchange layout: int64 tensors of 24
16-bit limbs per Fq element, Montgomery form, fully reduced.

Kernel, source, and the TPU kernel (or XLA function) it replaces:
  fq_mont_mul          csrc/fq_mont_mul.cu  scripts/probe_pallas.py:49, :76
  stage_prepare        csrc/prepare.cu      pallas_ops.py:410 _prepare_kernel
  stage_pairs          csrc/pairs.cu        pallas_ops.py:557 _pairs_kernel
  miller_loop_product  csrc/miller.cu       pallas_ops.py:229 _miller_kernel
  miller_loop_batch    csrc/miller.cu       pairing_ops.py:226 miller_loop_batch
                                            (phase 1 of miller_loop_product)
  final_exp_hard_part  csrc/hard_part.cu    pallas_ops.py:292 _hard_part_kernel
  hash_to_g2           csrc/h2c.cu          pallas_ops.py:641 _h2c_kernel
  final_exp_easy_part  csrc/easy_part.cu    pairing_ops.py:296 final_exponentiation
                                            (its easy part, kept in XLA there)
  msm_precompute       csrc/msm.cu          msm.py:134 _precompute_kernel (XLA)
  msm_fixed            csrc/msm.cu          msm.py:157 _msm_kernel (XLA)
  msm_varying          csrc/msm.cu          msm.py:99 varying_base_msm_kernel (XLA)
(pallas_ops.py, pairing_ops.py and msm.py are under
lighthouse_tpu/crypto/jaxbls/.)
csrc/latency.cu (lh_product_latency, lh_inverse) times chains of Fq
products, team levels and Fq inversions (the Fermat chain against fq.cuh's
binary GCD) for chip_smoke.py's product_latency phase; no path launches it,
and it builds into a library of its own (latency_library).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ...utils import torchcfg
from ..bls381 import curve as pc
from ..bls381.constants import P, R, X_ABS
from . import curve_ops as co
from . import h2c_ops as h2
from . import limbs as lb
from . import msm
from . import pairing_ops as po
from . import rounds
from . import team
from . import tower as tw

NL = lb.NL
CSRC = Path(__file__).resolve().parent / "csrc"
# fq.cuh's fp_inv, a binary GCD: batches of INV_STEPS divsteps on 62-bit
# approximations, 2 * 381 - 1 divsteps in all, rounded up to whole batches
INV_STEPS = 30
INV_BATCHES = -(-(2 * P.bit_length() - 1) // INV_STEPS)
SOURCES = ("fq_mont_mul.cu", "prepare.cu", "pairs.cu", "miller.cu", "hard_part.cu", "h2c.cu",
           "easy_part.cu", "msm.cu")


# ------------------------------------------------------------ build + load


def _words32(limbs16) -> list[int]:
    """24 16-bit limbs -> 12 32-bit words, little-endian."""
    a = [int(v) for v in np.asarray(limbs16).reshape(-1)]
    return [a[2 * i] | (a[2 * i + 1] << 16) for i in range(NL // 2)]


def _c_array(name: str, words) -> str:
    return f"static __constant__ uint32_t {name}[12] = {{{', '.join(f'0x{w:08x}u' for w in words)}}};"


def _c_words(name: str, value: int, n: int) -> str:
    """An n-word little-endian __constant__ array of a nonnegative int."""
    words = ", ".join(f"0x{(value >> 32 * i) & 0xFFFFFFFF:08x}u" for i in range(n))
    return f"static __constant__ uint32_t {name}[{n}] = {{{words}}};"


def _c_table(name: str, limbs16) -> str:
    """A __constant__ table of Fq elements: an array of 16-bit limbs with
    the limbs on its last axis -> uint32_t name[...][12]."""
    arr = np.asarray(limbs16)

    def braces(a):
        if a.ndim == 1:
            return "{" + ", ".join(f"0x{w:08x}u" for w in _words32(a)) + "}"
        return "{" + ", ".join(braces(x) for x in a) + "}"

    dims = "".join(f"[{d}]" for d in arr.shape[:-1])
    return f"static __constant__ uint32_t {name}{dims}[12] = {braces(arr)};"


def consts_header() -> str:
    """bls_consts.cuh: the field and Frobenius constants of the kernels,
    from the same tables as the plain versions."""
    inv32 = (-pow(P, -1, 1 << 32)) % (1 << 32)
    lines = [
        "// generated by lighthouse_tpu_torch.crypto.torchbls.kernels.consts_header",
        "#pragma once",
        "#include <stdint.h>",
        f"#define FP_INV 0x{inv32:08x}u",
        f"#define X_ABS 0x{X_ABS:016x}ull",
        # rounds.cuh's form_load (the same definition as round_programs.cuh's)
        f"#define RND_FORM_RECIP 0x{rounds.FORM_RECIP:016x}ull",
        _c_array("FP_P", _words32(lb.N_HOST)),
        _c_array("FP_ONE", _words32(lb.ONE_MONT)),
        _c_array("FP_R2", _words32(lb.R2_HOST)),
        # fq.cuh's fp_inv: its batches, and R^3 for its last product
        f"#define INV_STEPS {INV_STEPS}",
        f"#define INV_BATCHES {INV_BATCHES}",
        _c_array("FP_R3", _words32(lb.pack(pow(lb.R_MONT, 3, P)))),
        # msm.cu's GLV split: r, lambda and beta (Montgomery form)
        _c_words("FR_R", R, 8),
        _c_words("GLV_LAMBDA", msm.GLV_LAMBDA, 4),
        _c_array("FP_BETA", _words32(lb.pack(msm.GLV_BETA * lb.R_MONT % P))),
        # psi's coefficients for h2c.cu's cofactor clearing (curve_ops'
        # tables; the SWU map's constants are in team_programs.cuh)
        _c_table("PSI_CX", co._PSI_CX),
        _c_table("PSI_CY", co._PSI_CY),
    ]
    for k in (1, 2):
        coeff = tw.FROB12_COEFF[k].reshape(6, 2, NL)
        rows = ",\n  ".join(
            "{" + ", ".join("{" + ", ".join(f"0x{w:08x}u" for w in _words32(coeff[c, ri])) + "}"
                            for ri in range(2)) + "}"
            for c in range(6)
        )
        lines.append(f"static __constant__ uint32_t FROB{k}[6][2][12] = {{\n  {rows}}};")
    return "\n".join(lines) + "\n"


def _generated() -> dict[str, str]:
    return {"bls_consts.cuh": consts_header(), "round_programs.cuh": rounds.header(),
            "team_programs.cuh": team.header()}


@functools.lru_cache(maxsize=None)
def latency_library() -> torchcfg.KernelLibrary:
    """Build (or reuse) and load csrc/latency.cu's timing chains."""
    kl = torchcfg.build_kernels("lh_latency", [CSRC / "latency.cu"], CSRC, _generated())
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    kl.lib.lh_product_latency.argtypes = [i32, i32, vp, vp, vp, vp]
    kl.lib.lh_product_latency.restype = i32
    kl.lib.lh_inverse.argtypes = [i32, i32, i32, vp, vp, vp]
    kl.lib.lh_inverse.restype = i32
    return kl


@functools.lru_cache(maxsize=None)
def library() -> torchcfg.KernelLibrary:
    """Build (or reuse) and load the kernel library, declaring every entry."""
    kl = torchcfg.build_kernels("lh_bls", [CSRC / s for s in SOURCES], CSRC, _generated())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "lh_fq_mont_mul": ([vp, vp, vp, i64, vp], i32),
        "lh_prepare_scratch_words": ([i32, i32], i64),
        "lh_stage_prepare": ([vp] * 7 + [i32, i32, i32] + [vp] * 9, i32),
        "lh_stage_pairs": ([vp] * 10 + [i32] + [vp] * 9, i32),
        "lh_miller_loop_batch": ([vp] * 5 + [i32, vp, vp], i32),
        "lh_miller_tree": ([vp, i32, vp, vp], i32),
        "lh_final_exp_hard_part": ([vp, vp, vp], i32),
        "lh_hash_to_g2": ([vp, i32, vp, vp, vp, vp], i32),
        "lh_final_exp_easy_part": ([vp, vp, vp], i32),
        "lh_msm_fixed_scratch_words": ([i64], i64),
        "lh_msm_varying_scratch_words": ([i64], i64),
        "lh_msm_precompute": ([vp, vp, vp, i32, vp, vp, vp, vp], i32),
        "lh_msm_fixed": ([vp] * 4 + [i32] + [vp] * 5, i32),
        "lh_msm_varying": ([vp] * 4 + [i32, i32, i32] + [vp] * 5, i32),
    }
    for fname, (argtypes, restype) in sigs.items():
        fn = getattr(kl.lib, fname)
        fn.argtypes = argtypes
        fn.restype = restype
    return kl


def _lib():
    return library().lib


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _limbs(t: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
    """A CUDA int64 limb tensor of exactly `shape`, made contiguous."""
    if t.device.type != "cuda" or t.dtype != torch.int64 or tuple(t.shape) != shape:
        raise ValueError(f"{what}: want a CUDA int64 tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _flags(t: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
    """A CUDA 0/1 (bool or integer) tensor as contiguous int32."""
    if t.device.type != "cuda" or t.dtype.is_floating_point or tuple(t.shape) != shape:
        raise ValueError(f"{what}: want a CUDA bool/int tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return (t != 0).to(torch.int32).contiguous()


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# ------------------------------------------------------------ fq_mont_mul


def fq_mont_mul_plain(a, b=None):
    return lb.to_mont(a) if b is None else lb.mont_mul(a, b)


def fq_mont_mul(a, b=None):
    """Batched Montgomery product of two (..., NL) limb tensors; with b None,
    the product by R^2 (the Montgomery conversion of a). The kernel reads
    16-byte vectors, so it refuses (and this raises on) a tensor whose data
    does not start on a 16-byte boundary: a view that starts inside an
    element."""
    if _on_cpu(a):
        return fq_mont_mul_plain(a, b)
    a = _limbs(a, tuple(a.shape), "a")
    b_ptr = None                       # NULL: the kernel multiplies by R^2
    if b is not None:
        b = _limbs(b, tuple(a.shape), "b")
        b_ptr = _ptr(b)
    out = torch.empty_like(a)
    n = a.numel() // NL
    _check(_lib().lh_fq_mont_mul(_ptr(a), b_ptr, _ptr(out), n, _stream()), "fq_mont_mul")
    fq_mont_mul.launches += 1
    return out


# ------------------------------------------------------------ stage_prepare


def stage_prepare_plain(pk_x, pk_y, pk_mask, sig_x, sig_y, z_bits, set_mask):
    """Stage 1 (backend._stage_prepare of the JAX package): Montgomery
    conversion, per-set pubkey tree sums, z-scaling of the aggregates and
    the signatures, the signature tree sum. Shapes: pk (n, m, NL), pk_mask
    (n, m), sig (n, 2, NL), z_bits (n, 64) MSB first, set_mask (n,).
    Returns (z_pk (X, Y, Z) each (n, NL), sig_acc (X, Y, Z) each (2, NL),
    bad 0-dim bool)."""
    pk_x, pk_y = lb.to_mont(pk_x), lb.to_mont(pk_y)
    sig_x, sig_y = lb.to_mont(sig_x), lb.to_mont(sig_y)
    set_on = set_mask != 0
    pk_jac = co.affine_to_jac(co.FQ_OPS, (pk_x, pk_y), inf_mask=pk_mask == 0)
    aggpk = co.tree_sum(tuple(c.transpose(0, 1) for c in pk_jac), co.FQ_OPS)
    bad = (co.FQ_OPS.is_zero(aggpk[2]) & set_on).any()
    z_pk = co.scalar_mul_bits(aggpk, z_bits, co.FQ_OPS)
    sig_jac = co.affine_to_jac(co.FQ2_OPS, (sig_x, sig_y), inf_mask=~set_on)
    z_sig = co.scalar_mul_bits(sig_jac, z_bits, co.FQ2_OPS)
    z_sig = co.pt_select(co.FQ2_OPS, set_on, z_sig, co.identity_like(co.FQ2_OPS, z_sig[0]))
    return z_pk, co.tree_sum(z_sig, co.FQ2_OPS), bad


def stage_prepare(pk_x, pk_y, pk_mask, sig_x, sig_y, z_bits, set_mask):
    """Stage 1 through csrc/prepare.cu (plain version on CPU tensors)."""
    if _on_cpu(pk_x):
        return stage_prepare_plain(pk_x, pk_y, pk_mask, sig_x, sig_y, z_bits, set_mask)
    n, m = pk_x.shape[0], pk_x.shape[1]
    nbits = z_bits.shape[-1]
    if n & (n - 1) or m & (m - 1):
        raise ValueError(f"stage_prepare takes power-of-two buckets, got ({n}, {m})")
    pk_x = _limbs(pk_x, (n, m, NL), "pk_x")
    pk_y = _limbs(pk_y, (n, m, NL), "pk_y")
    pk_mask = _flags(pk_mask, (n, m), "pk_mask")
    sig_x = _limbs(sig_x, (n, 2, NL), "sig_x")
    sig_y = _limbs(sig_y, (n, 2, NL), "sig_y")
    z_bits = _flags(z_bits, (n, nbits), "z_bits")
    set_mask = _flags(set_mask, (n,), "set_mask")
    dev = pk_x.device
    z_pk = tuple(torch.empty((n, NL), dtype=torch.int64, device=dev) for _ in range(3))
    sig_acc = tuple(torch.empty((2, NL), dtype=torch.int64, device=dev) for _ in range(3))
    bad = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = _lib()
    scratch = torch.empty((lib.lh_prepare_scratch_words(n, m),), dtype=torch.int32, device=dev)
    _check(lib.lh_stage_prepare(
        _ptr(pk_x), _ptr(pk_y), _ptr(pk_mask), _ptr(sig_x), _ptr(sig_y), _ptr(z_bits),
        _ptr(set_mask), n, m, nbits, *[_ptr(t) for t in z_pk], *[_ptr(t) for t in sig_acc],
        _ptr(bad), _ptr(scratch), _stream(),
    ), "stage_prepare")
    stage_prepare.launches += 1
    return z_pk, sig_acc, bad[0] != 0


# ------------------------------------------------------------ stage_pairs

_NEG_G1 = tuple(tw._mont_const(c) for c in pc.g1_neg(pc.G1_GEN))


def batched_affine(z_pk, h_jac, sig_acc):
    """Jacobian -> affine for the three pairing inputs with ONE batched Fq2
    inversion of all 2n+1 Z coordinates (G1 Z embedded with a zero
    imaginary part); identity lanes invert to 0 and stay flagged."""
    Xp, Yp, Zp = z_pk
    Xh, Yh, Zh = h_jac
    Xs, Ys, Zs = sig_acc
    n = Zp.shape[0]
    zs = torch.cat([torch.stack([Zp, torch.zeros_like(Zp)], dim=-2), Zh, Zs[None]])
    zinv = tw.fq2_inv(zs)
    zinv2 = tw.fq2_sqr(zinv)
    zinv3 = tw.fq2_mul(zinv2, zinv)
    p = (lb.mont_mul(Xp, zinv2[:n, 0]), lb.mont_mul(Yp, zinv3[:n, 0]), lb.is_zero(Zp))
    q = (tw.fq2_mul(Xh, zinv2[n : 2 * n]), tw.fq2_mul(Yh, zinv3[n : 2 * n]), tw.fq2_is_zero(Zh))
    s = (tw.fq2_mul(Xs, zinv2[2 * n]), tw.fq2_mul(Ys, zinv3[2 * n]), tw.fq2_is_zero(Zs))
    return p, q, s


def _append_sig_pair(p1x, p1y, qx, qy, set_pair, sx, sy, sinf):
    """The n set pairs plus the (-G1, sum z*sig) pair, and the pair mask."""
    neg_x = lb.const(_NEG_G1[0], p1x)[None]
    neg_y = lb.const(_NEG_G1[1], p1y)[None]
    return (
        torch.cat([p1x, neg_x]),
        torch.cat([p1y, neg_y]),
        torch.cat([qx, sx[None]]),
        torch.cat([qy, sy[None]]),
        torch.cat([set_pair, ~sinf.reshape(1)]),
    )


def stage_pairs_plain(z_pk, h_jac, sig_acc, set_mask):
    """Stage 3 (backend._stage_pairs of the JAX package): affine pairing
    inputs (n + 1 pairs) and the pair mask."""
    (p1x, p1y, p1inf), (qx, qy, qinf), (sx, sy, sinf) = batched_affine(z_pk, h_jac, sig_acc)
    set_pair = (set_mask != 0) & ~(p1inf | qinf)
    return _append_sig_pair(p1x, p1y, qx, qy, set_pair, sx, sy, sinf)


def stage_pairs(z_pk, h_jac, sig_acc, set_mask):
    """Stage 3 through csrc/pairs.cu (plain version on CPU tensors)."""
    if _on_cpu(z_pk[0]):
        return stage_pairs_plain(z_pk, h_jac, sig_acc, set_mask)
    n = z_pk[0].shape[0]
    zp = [_limbs(c, (n, NL), "z_pk") for c in z_pk]
    hj = [_limbs(c, (n, 2, NL), "h_jac") for c in h_jac]
    sa = [_limbs(c, (2, NL), "sig_acc") for c in sig_acc]
    set_mask = _flags(set_mask, (n,), "set_mask")
    dev = zp[0].device
    p1x, p1y = (torch.empty((n, NL), dtype=torch.int64, device=dev) for _ in range(2))
    qx, qy = (torch.empty((n, 2, NL), dtype=torch.int64, device=dev) for _ in range(2))
    sx, sy = (torch.empty((2, NL), dtype=torch.int64, device=dev) for _ in range(2))
    pm = torch.empty((n,), dtype=torch.int32, device=dev)
    sinf = torch.empty((1,), dtype=torch.int32, device=dev)
    _check(_lib().lh_stage_pairs(
        *[_ptr(t) for t in zp + hj + sa], _ptr(set_mask), n,
        _ptr(p1x), _ptr(p1y), _ptr(qx), _ptr(qy), _ptr(pm), _ptr(sx), _ptr(sy), _ptr(sinf),
        _stream(),
    ), "stage_pairs")
    stage_pairs.launches += 1
    return _append_sig_pair(p1x, p1y, qx, qy, pm != 0, sx, sy, sinf[0] != 0)


# ------------------------------------------------------------ Miller loop


def miller_loop_product_plain(p_aff, q_aff, valid_mask):
    return po.miller_loop_product(p_aff, q_aff, valid_mask != 0)


def _miller_args(p_aff, q_aff, valid_mask):
    n = p_aff[0].shape[0]
    xp, yp = (_limbs(c, (n, NL), "p_aff") for c in p_aff)
    xq, yq = (_limbs(c, (n, 2, NL), "q_aff") for c in q_aff)
    return n, (xp, yp, xq, yq, _flags(valid_mask, (n,), "valid_mask"))


def miller_loop_product(p_aff, q_aff, valid_mask):
    """Multi-Miller loop over P affine pairs through csrc/miller.cu: the
    per-pair values of miller_loop_batch (its own launch and count), then
    their product tree, lh_miller_tree (plain version, the
    shared-accumulator loop, on CPU tensors). Returns one Fq12."""
    if _on_cpu(p_aff[0]):
        return miller_loop_product_plain(p_aff, q_aff, valid_mask)
    values = miller_loop_batch(p_aff, q_aff, valid_mask)
    n = values.shape[0]
    if n == 1:
        return values[0]
    out = torch.empty(tw.FQ12_ONE.shape, dtype=torch.int64, device=values.device)
    _check(_lib().lh_miller_tree(_ptr(values), n, _ptr(out), _stream()), "miller_loop_product")
    miller_loop_product.launches += 1
    return out


def miller_loop_batch_plain(p_aff, q_aff, valid_mask):
    return po.miller_loop_batch(p_aff, q_aff, valid_mask != 0)


def miller_loop_batch(p_aff, q_aff, valid_mask):
    """Per-pair Miller values conj(f_i) (1 for a masked pair), (P, 2, 3, 2,
    NL), through phase 1 of csrc/miller.cu (plain version on CPU tensors)."""
    if _on_cpu(p_aff[0]):
        return miller_loop_batch_plain(p_aff, q_aff, valid_mask)
    n, args = _miller_args(p_aff, q_aff, valid_mask)
    out = torch.empty((n,) + tw.FQ12_ONE.shape, dtype=torch.int64, device=args[0].device)
    _check(_lib().lh_miller_loop_batch(*[_ptr(t) for t in args], n, _ptr(out), _stream()),
           "miller_loop_batch")
    miller_loop_batch.launches += 1
    return out


# ------------------------------------------------------------ final-exp hard part


def final_exp_hard_part(t):
    """The final exponentiation's hard part on one Fq12 through
    csrc/hard_part.cu (plain version on CPU tensors)."""
    if _on_cpu(t):
        return po.final_exp_hard_part(t)
    t = _limbs(t, tw.FQ12_ONE.shape, "t")
    out = torch.empty_like(t)
    _check(_lib().lh_final_exp_hard_part(_ptr(t), _ptr(out), _stream()), "final_exp_hard_part")
    final_exp_hard_part.launches += 1
    return out


# ------------------------------------------------------------ hash-to-G2


def hash_to_g2_plain(us):
    """Montgomery conversion of the standard-form u-values (n, 2, 2, NL),
    then h2c_ops.map_to_g2: Jacobian (X, Y, Z), each (n, 2, NL)."""
    us = lb.to_mont(us)
    return h2.map_to_g2(us[:, 0], us[:, 1])


def hash_to_g2(us):
    """Hash-to-G2 of n messages' standard-form u-values (n, 2, 2, NL)
    through csrc/h2c.cu (plain version on CPU tensors)."""
    if _on_cpu(us):
        return hash_to_g2_plain(us)
    n = us.shape[0]
    us = _limbs(us, (n, 2, 2, NL), "us")
    X, Y, Z = (torch.empty((n, 2, NL), dtype=torch.int64, device=us.device) for _ in range(3))
    _check(_lib().lh_hash_to_g2(_ptr(us), n, _ptr(X), _ptr(Y), _ptr(Z), _stream()), "hash_to_g2")
    hash_to_g2.launches += 1
    return X, Y, Z


# ------------------------------------------------------------ final-exp easy part


def final_exp_easy_part(m):
    """The final exponentiation's easy part m^((p^6 - 1)(p^2 + 1)) on one
    Fq12 through csrc/easy_part.cu (plain version on CPU tensors)."""
    if _on_cpu(m):
        return po.final_exp_easy_part(m)
    m = _limbs(m, tw.FQ12_ONE.shape, "m")
    out = torch.empty_like(m)
    _check(_lib().lh_final_exp_easy_part(_ptr(m), _ptr(out), _stream()), "final_exp_easy_part")
    final_exp_easy_part.launches += 1
    return out


# ------------------------------------------------------------ G1 MSM


def _digits(t: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
    """A CUDA integer tensor of exactly `shape` as contiguous int32."""
    if t.device.type != "cuda" or t.dtype.is_floating_point or tuple(t.shape) != shape:
        raise ValueError(f"{what}: want a CUDA integer tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.to(torch.int32).contiguous()


def _affine_out(dev):
    """The sums' outputs: standard-form x, y (NL,) and the flag."""
    return (torch.empty((NL,), dtype=torch.int64, device=dev),
            torch.empty((NL,), dtype=torch.int64, device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))


def msm_precompute(px, py, inf_mask):
    """Comb tables of n standard-form affine points px, py (n, NL) with
    their infinity mask (n,) -> (tx, ty, tz), each (16 n, NL), Montgomery
    Jacobian, through csrc/msm.cu (plain version on CPU tensors)."""
    if _on_cpu(px):
        return msm.precompute_plain(px, py, inf_mask)
    n = px.shape[0]
    px = _limbs(px, (n, NL), "px")
    py = _limbs(py, (n, NL), "py")
    inf_mask = _flags(inf_mask, (n,), "inf_mask")
    tx, ty, tz = (torch.empty((msm.N_CHUNKS * n, NL), dtype=torch.int64, device=px.device)
                  for _ in range(3))
    _check(_lib().lh_msm_precompute(_ptr(px), _ptr(py), _ptr(inf_mask), n, _ptr(tx), _ptr(ty),
                                    _ptr(tz), _stream()), "msm_precompute")
    msm_precompute.launches += 1
    return tx, ty, tz


def msm_fixed(tx, ty, tz, bits):
    """The comb MSM over L lanes of tables (L, NL) with their 16-bit chunks
    as bits (L, 16), MSB first -> the sum's standard-form affine x, y (NL,)
    and its infinity flag, through csrc/msm.cu (plain version on CPU
    tensors)."""
    if _on_cpu(tx):
        return msm.fixed_msm_plain(tx, ty, tz, bits)
    lanes = tx.shape[0]
    tx, ty, tz = (_limbs(c, (lanes, NL), "tables") for c in (tx, ty, tz))
    bits = _flags(bits, (lanes, msm.CHUNK_BITS), "bits")
    x, y, inf = _affine_out(tx.device)
    lib = _lib()
    scratch = torch.empty((lib.lh_msm_fixed_scratch_words(lanes),), dtype=torch.int32,
                          device=tx.device)
    _check(lib.lh_msm_fixed(_ptr(tx), _ptr(ty), _ptr(tz), _ptr(bits), lanes, _ptr(scratch),
                            _ptr(x), _ptr(y), _ptr(inf), _stream()), "msm_fixed")
    msm_fixed.launches += 1
    return x, y, inf[0] != 0


def msm_varying(px, py, mask, digits, window: int = 4):
    """The varying-base MSM of n standard-form affine points px, py (n, NL)
    with their mask (n,) by MSB-first digits (n, nd) from msm.msm_digits at
    `window` (0: the bit form) -> the sum's standard-form affine x, y (NL,)
    and its infinity flag, through csrc/msm.cu (plain version on CPU
    tensors)."""
    if _on_cpu(px):
        return msm.varying_base_msm_plain(px, py, mask, digits, window)
    if window != 0 and window not in msm.ALLOWED_WINDOWS:
        raise ValueError(f"msm_varying: window {window} is not 0 or one of {msm.ALLOWED_WINDOWS}")
    n, nd = digits.shape
    if nd != -(-256 // (window or 4)):
        raise ValueError(f"msm_varying: {nd} digits do not cover 256 bits at window {window}")
    px = _limbs(px, (n, NL), "px")
    py = _limbs(py, (n, NL), "py")
    mask = _flags(mask, (n,), "mask")
    # a digit outside the window's table is refused on the card, without a
    # sync here: the sum comes back as msm.REFUSED, which affine_result
    # raises on
    digits = _digits(digits, (n, nd), "digits")
    x, y, inf = _affine_out(px.device)
    lib = _lib()
    scratch = torch.empty((lib.lh_msm_varying_scratch_words(n),), dtype=torch.int32,
                          device=px.device)
    _check(lib.lh_msm_varying(_ptr(px), _ptr(py), _ptr(mask), _ptr(digits), n, nd, window,
                              _ptr(scratch), _ptr(x), _ptr(y), _ptr(inf), _stream()),
           "msm_varying")
    msm_varying.launches += 1
    return x, y, inf[0] != 0


# Every wrapper with its plain version, its source and the TPU kernel (or,
# for the easy part, the per-pair Miller loop and the MSM, the XLA
# function) it replaces. chip_smoke.py walks this table.
KERNELS = {
    "fq_mont_mul": (fq_mont_mul, fq_mont_mul_plain, "fq_mont_mul.cu",
                    "scripts/probe_pallas.py:76"),
    "stage_prepare": (stage_prepare, stage_prepare_plain, "prepare.cu",
                      "lighthouse_tpu/crypto/jaxbls/pallas_ops.py:410"),
    "stage_pairs": (stage_pairs, stage_pairs_plain, "pairs.cu",
                    "lighthouse_tpu/crypto/jaxbls/pallas_ops.py:557"),
    "miller_loop_product": (miller_loop_product, miller_loop_product_plain, "miller.cu",
                            "lighthouse_tpu/crypto/jaxbls/pallas_ops.py:229"),
    "miller_loop_batch": (miller_loop_batch, miller_loop_batch_plain, "miller.cu",
                          "lighthouse_tpu/crypto/jaxbls/pairing_ops.py:226"),
    "final_exp_hard_part": (final_exp_hard_part, po.final_exp_hard_part, "hard_part.cu",
                            "lighthouse_tpu/crypto/jaxbls/pallas_ops.py:292"),
    "hash_to_g2": (hash_to_g2, hash_to_g2_plain, "h2c.cu",
                   "lighthouse_tpu/crypto/jaxbls/pallas_ops.py:641"),
    "final_exp_easy_part": (final_exp_easy_part, po.final_exp_easy_part, "easy_part.cu",
                            "lighthouse_tpu/crypto/jaxbls/pairing_ops.py:296"),
    "msm_precompute": (msm_precompute, msm.precompute_plain, "msm.cu",
                       "lighthouse_tpu/crypto/jaxbls/msm.py:134"),
    "msm_fixed": (msm_fixed, msm.fixed_msm_plain, "msm.cu",
                  "lighthouse_tpu/crypto/jaxbls/msm.py:157"),
    "msm_varying": (msm_varying, msm.varying_base_msm_plain, "msm.cu",
                    "lighthouse_tpu/crypto/jaxbls/msm.py:99"),
}

for _wrapper, *_rest in KERNELS.values():
    _wrapper.launches = 0


def reset_launches() -> None:
    for wrapper, *_rest in KERNELS.values():
        wrapper.launches = 0
