"""G1 multi-scalar multiplication: the varying-base MSM and the fixed-base
comb MSM of the JAX package's jaxbls/msm.py, in PyTorch.

The fixed-base method trades a one-time precompute for a 16x cut in
sequential depth on every later MSM. The KZG commitments and proofs reuse
the SAME 4096 Lagrange points every call, so:

  precompute (once per setup):  T[j][i] = 2^(16 j) * P_i   (j = 0..15)
  every MSM:   sum_i s_i P_i = sum_{i,j} c_{ij} * T[j][i]
               where s_i = sum_j c_{ij} 2^(16 j), c_{ij} 16-bit chunks

i.e. one double-and-add over 16 n lanes of 16-bit scalars and one sum
over the lanes.

The three device programs are kernels of csrc/msm.cu (kernels.py:
msm_precompute, msm_fixed, msm_varying); their plain versions are here.
On the card the sums take other methods than the plain versions (msm_fixed
by buckets over the comb lanes, msm_varying by bit windows over the GLV
split below), which give the same affine sums.
Points are standard-form affine limbs at the boundary, Montgomery Jacobian
inside, and the sums come back as standard-form affine coordinates with an
infinity flag, which are unique: the kernels may sum in any order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...utils import torchcfg
from ..bls381.constants import P, R, X_ABS
from . import curve_ops as co
from . import limbs as lb

CHUNK_BITS = 16
N_CHUNKS = 256 // CHUNK_BITS      # 16 comb rows cover the 256-bit scalar

#: msm_varying's GLV split on the card: lambda = x^2 - 1 is a root of
#: l^2 + l + 1 = r (r = x^4 - x^2 + 1), so every k < r is k2 lambda + k1
#: with k1 < lambda and k2 <= lambda + 1, both below 2^128, and the map
#: (x, y) -> (GLV_BETA x, y), beta a cube root of unity in Fq, is
#: multiplication by lambda on G1
GLV_LAMBDA = X_ABS * X_ABS - 1
GLV_BETA = pow(2, 2 * (P - 1) // 3, P)

#: window widths of the varying-base MSM besides 0 (the bit form)
ALLOWED_WINDOWS = (2, 4, 5, 6)
#: the default width, on the card and on the CPU alike: the JAX package
#: takes the bit form on the CPU because XLA compiles it faster, a cost the
#: port's kernels (built once) and plain versions do not pay; w = 4 does
#: 256 doublings and 78 additions where the bit form does 256 of each
DEFAULT_WINDOW = 4


def msm_window() -> int:
    """Varying-base MSM window width; 0 selects the bit double-and-add form.

    Resolution:
      LIGHTHOUSE_TPU_MSM_WINDOW=<0|2|4|5|6>         explicit width
      LIGHTHOUSE_TPU_MSM_WINDOWED=0/1 (legacy)      bit form / w=4
      the installed autotune plan's msm_window      the calibrated width
      DEFAULT_WINDOW                                the same on every device
    The plan's width 0 is a measured verdict (the bit form won the
    calibration sweep on this device) and is honoured; None means
    unmeasured."""
    raw = os.environ.get("LIGHTHOUSE_TPU_MSM_WINDOW", "").strip()
    if raw:
        try:
            w = int(raw)
            if w == 0 or w in ALLOWED_WINDOWS:
                return w
        except ValueError:
            pass  # malformed env falls through to the next layer
    legacy = os.environ.get("LIGHTHOUSE_TPU_MSM_WINDOWED", "").strip().lower()
    if legacy:
        return 0 if legacy in ("0", "no", "off", "false") else 4
    try:
        from ...autotune import runtime

        plan = runtime.active_plan()
    except Exception:
        plan = None
    w = getattr(plan, "msm_window", None) if plan is not None else None
    if w == 0 or w in ALLOWED_WINDOWS:
        return int(w)
    return DEFAULT_WINDOW


def msm_digits(scalars, window: int) -> np.ndarray:
    """Host packing for the varying-base MSM: ints mod r -> (n,
    ceil(256/w)) MSB-first digit array at width `window` (the bit form,
    window=0, takes base-16 digits and expands them to bits itself)."""
    return co.scalars_to_digits([s % R for s in scalars], 256, window or 4)


def digits_to_bits(digits):
    """(n, 64) base-16 digits -> (n, 256) bits, MSB first."""
    weights = torch.tensor([8, 4, 2, 1], dtype=digits.dtype, device=digits.device)
    return ((digits[..., :, None] // weights) % 2).reshape(digits.shape[0], -1)


# ------------------------------------------------------------ plain versions


def varying_base_msm_plain(px, py, mask, digits, window: int = 4):
    """G1 MSM over per-call bases: standard-form affine px, py (n, NL) with
    their mask (n,) and MSB-first digits from msm_digits at `window` ->
    (x, y) standard form (NL,) and the infinity flag. Montgomery
    conversion, a Jacobian point per live lane, a scalar multiplication per
    lane (windowed, or the bit form at window 0), the masked tree sum and
    the affine conversion: jaxbls/msm.py varying_base_msm_kernel."""
    valid = mask != 0
    jac = co.affine_to_jac(co.FQ_OPS, (lb.to_mont(px), lb.to_mont(py)), inf_mask=~valid)
    if window:
        prod = co.scalar_mul_windowed(jac, digits, co.FQ_OPS, window=window)
    else:
        prod = co.scalar_mul_bits(jac, digits_to_bits(digits), co.FQ_OPS)
    acc = co.masked_tree_sum(prod, valid, co.FQ_OPS)
    x, y, inf = co.jac_to_affine(acc, co.FQ_OPS)
    return lb.from_mont(x), lb.from_mont(y), inf


def precompute_plain(px, py, inf_mask):
    """(n,) standard-form affine points -> the comb tables (tx, ty, tz),
    each (N_CHUNKS * n, NL), Montgomery Jacobian; row j (lanes j n .. j n +
    n - 1) holds 2^(16 j) * P_i: jaxbls/msm.py _precompute_kernel, whose
    scan emits each row before its 16 doublings."""
    jac = co.affine_to_jac(co.FQ_OPS, (lb.to_mont(px), lb.to_mont(py)), inf_mask=inf_mask != 0)
    rows = []
    for j in range(N_CHUNKS):
        rows.append(jac)
        if j + 1 < N_CHUNKS:
            for _ in range(CHUNK_BITS):
                jac = co.jac_double(jac, co.FQ_OPS)
    return tuple(torch.cat([row[c] for row in rows]) for c in range(3))


def fixed_msm_plain(tx, ty, tz, bits):
    """Comb tables (J n lanes) and per-lane 16-bit chunks as bits (J n, 16),
    MSB first -> the affine sum (x, y) standard form and the infinity flag:
    jaxbls/msm.py _msm_kernel."""
    prod = co.scalar_mul_bits((tx, ty, tz), bits, co.FQ_OPS)
    acc = co.tree_sum(prod, co.FQ_OPS)
    x, y, inf = co.jac_to_affine(acc, co.FQ_OPS)
    return lb.from_mont(x), lb.from_mont(y), inf


# ------------------------------------------------------------ host side

#: the coordinates msm_varying's kernel gives for digits outside its
#: window's table: 2^384 - 1, above every standard-form coordinate
REFUSED = (1 << 16 * lb.NL) - 1


def pack_points(points, least: int):
    """Host affine int pairs (None = the identity) -> standard-form limbs
    px, py (n, NL) uint32 and the live mask (n,) bool, padded with the
    identity to n, a power of two and at least `least`."""
    from .backend import _next_pow2, pack_ints_vec

    n = max(least, _next_pow2(len(points)))
    px = np.zeros((n, lb.NL), np.uint32)
    py = np.zeros((n, lb.NL), np.uint32)
    live = np.zeros((n,), bool)
    idx = [i for i, p in enumerate(points) if p is not None]
    if idx:
        px[idx] = pack_ints_vec([points[i][0] for i in idx])
        py[idx] = pack_ints_vec([points[i][1] for i in idx])
        live[idx] = True
    return px, py, live


def affine_result(x, y, inf):
    """A standard-form affine sum and its flag -> host int pair or None;
    raises on msm_varying's REFUSED sum."""
    if bool(inf):
        return None
    xy = (lb.unpack(x.cpu().numpy()), lb.unpack(y.cpu().numpy()))
    if xy[0] == REFUSED:
        raise ValueError("msm_varying: a digit outside [0, 2^w) (16 in the bit form)")
    return xy


class FixedBaseMSM:
    """Comb tables for one fixed point set, on one device (the CUDA device
    unless the caller passes another)."""

    def __init__(self, points, device=None):
        from . import kernels

        self.device = torchcfg.resolve_device(device)
        self.n_real = len(points)
        px, py, live = pack_points(points, 4)
        self._n = len(live)
        args = (torch.as_tensor(px.astype(np.int64), device=self.device),
                torch.as_tensor(py.astype(np.int64), device=self.device),
                torch.as_tensor(~live, device=self.device))
        self._tables = kernels.msm_precompute(*args)   # on the device, reused per call

    def _bits(self, scalars) -> np.ndarray:
        """host: n_real ints mod r -> (J*n, 16) uint32 bit array, MSB first,
        lane (j, i) holding chunk c_ij of scalar i (vectorized byte view)."""
        buf = b"".join(int(s % R).to_bytes(32, "little") for s in scalars)
        chunks = np.frombuffer(buf, np.uint8).reshape(self.n_real, 32)
        c16 = chunks[:, 0::2].astype(np.uint32) | (
            chunks[:, 1::2].astype(np.uint32) << 8
        )                                          # (n_real, J) LE chunks
        full = np.zeros((self._n, N_CHUNKS), np.uint32)
        full[: self.n_real] = c16
        ct = full.T                                # (J, n)
        shifts = np.arange(CHUNK_BITS - 1, -1, -1, dtype=np.uint32)
        bits = (ct[..., None] >> shifts) & 1       # (J, n, 16) MSB first
        return bits.reshape(-1, CHUNK_BITS)

    def bits_tensor(self, scalars) -> torch.Tensor:
        """_bits as a bool tensor on the tables' device."""
        bits = torch.from_numpy(self._bits(scalars).astype(np.bool_))
        if self.device.type == "cuda":
            return bits.pin_memory().to(self.device, non_blocking=True)
        return bits

    def msm(self, scalars):
        """sum_i scalars[i] * P_i -> host affine int pair or None."""
        from . import kernels

        if len(scalars) != self.n_real:
            raise ValueError(f"expected {self.n_real} scalars, got {len(scalars)}")
        return affine_result(*kernels.msm_fixed(*self._tables, self.bits_tensor(scalars)))
