"""The work each stage of the verify must do, counted on its inputs.

One copy serves the roofline of observability/perf.py (a stage's integer
instructions and bytes) and the bounds of `chip_smoke.py` (each kernel's
least time on the card). The counts are of the function, not of a kernel's
method: 381-bit Montgomery products ("Fq products") on this run's data, the
32-bit integer instructions of the binary-GCD inversions, and the bytes the
function must move.

Fq products: G1 double 7, G1 add 16; G2 double 16, G2 add 44 (an Fq2
product is 3, an Fq2 square 2); Fq12 product 54, cyclotomic square 18,
Fq12 square 36; an Fq inversion one product (by R^3) beside its binary
GCD, which is counted apart as 32-bit integer instructions
(int_ops_inverse). An addition with an identity operand does no product.
The Miller loop's count is the least of two forms (fq_products_miller).

Peaks of one H100 SXM (NVIDIA data sheet; the name and limit
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives:
NVIDIA H100 80GB HBM3, 700.00 W): HBM 3.35 TB/s; 32-bit integer
instructions 64 per clock per SM for multiply-add (IMAD), add, shift,
compare, select and logic alike (CUDA C++ Programming Guide, throughput
table, compute capability 9.0) x 132 SMs x 1.98 GHz boost = 16.7 T/s.

Counting reads the masks and bits (a host copy of them on the card), so it
runs once per (stage, bucket), never on the serving path.
"""

from __future__ import annotations

import torch

from .limbs import NL

HBM_BYTES_PER_S = 3.35e12
INT32_PER_S = 64 * 132 * 1.98e9
#: bytes an Fq element holds (its 381 bits as 12 32-bit words); the port's
#: interchange passes it as 24 int64 limbs, 192 bytes, a choice of the port
#: and not work the function must do
ELEMENT_BYTES = 48
#: one 381-bit Montgomery product, 12 x 32-bit limbs (CIOS): 2*12*12 + 12
#: 32x32->64-bit multiply-adds, two IMAD issues each (low and high word)
IMAD_PER_FQ_MUL = 2 * (2 * 12 * 12 + 12)

# fq.cuh's fp_inv (a binary GCD) in 32-bit integer instructions, counted
# from its source loop by loop (a 64-bit operation is two): INV_BATCHES
# batches, each of INV_STEPS divsteps of 24 (the parity 1, a 64-bit
# compare 2, the swap flag 1, the swap's selects of A and B 4 and of the
# four factors 4, a masked 64-bit subtraction 4 and shift 2, the factor
# updates 6) and of 878 more: the bit length over 12 words 50, two 62-bit
# approximations 38 each, two exact updates of a and b 156 each (per
# factor its magnitude 2, a product of 12 words by it 25 and a 13-word
# conditional negation 26; a 13-word sum 13, a 12-word shift 12, the sign
# 1, a 12-word conditional negation 24), the factors' signs 8, and two
# updates of u and v mod p 216 each (two negations mod p 37 each, selects
# 24, magnitudes 4, three products by a factor 25 each, the quotient 2, a
# 12-word shift 12, a conditional subtraction 25). Its last product by R^3
# is an Fq product.
INV_DIVSTEP_OPS = 24
INV_BATCH_OPS = 50 + 2 * 38 + 2 * 156 + 8 + 2 * 216


def leaves(x) -> list:
    """The tensors of a nest of tuples and lists, in order."""
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in leaves(e)]
    return [x]


def _popcount(x: int) -> int:
    return bin(x).count("1")


def int_ops_inverse() -> int:
    from . import kernels as K

    return K.INV_BATCHES * (K.INV_STEPS * INV_DIVSTEP_OPS + INV_BATCH_OPS)


def fq_products_prepare(pk_mask, z_bits, set_mask) -> int:
    n, m = pk_mask.shape
    keys = pk_mask.sum(dim=1).tolist()
    live = set_mask.tolist()
    bits = z_bits.sum(dim=1).tolist()
    total = 2 * n * m + 4 * n                         # Montgomery conversions
    total += 16 * sum(max(k - 1, 0) for k in keys)    # pubkey trees
    for s in range(n):
        adds = max(int(bits[s]) - 1, 0)               # the first add is from identity
        total += z_bits.shape[1] * 7 + (adds * 16 if keys[s] else 0)
        total += z_bits.shape[1] * 16 + (adds * 44 if live[s] else 0)
    total += 44 * max(int(sum(live)) - 1, 0)          # signature tree
    return total


def fq_products_pairs(n: int) -> int:
    """Per Z lane an Fq2 inversion (the norm's two squares, the inversion's
    product by R^3, two products by the norm's inverse; its GCD is
    int_ops_inverse) and Z^-2, Z^-3 (2 + 3); the G1 lanes' X and Y 2, the
    other lanes' 6."""
    return (2 * n + 1) * (4 + 1 + 2 + 3) + n * 2 + (n + 1) * 6


def fq_products_miller_batch(mask) -> int:
    """miller_loop_batch's least work: per unmasked pair 63 Fq12 squarings
    (36), doubling steps (31) and sparse 014 line products (13 Fq2 products,
    39), and the addition steps (40) with theirs on the other 1-bits of |x|;
    the first squaring and line product, of f = 1, are free. A masked pair
    gives 1 and costs nothing."""
    from ..bls381.constants import X_ABS

    per_pair = 63 * (36 + 31 + 39) + (_popcount(X_ABS) - 1) * (40 + 39) - 36 - 39
    return int((mask != 0).sum()) * per_pair


def fq_products_miller(mask) -> int:
    """miller_loop_product's least work over this run's unmasked pairs L:
    the fewer of one shared f (62 squarings past the first, of f = 1; each
    pair's 63 doubling and 5 addition steps; every line multiplied into f by
    the sparse 014 product, the first one into f = 1 free) and the per-pair
    values of miller_loop_batch with a tree of L - 1 dense Fq12 products."""
    from ..bls381.constants import X_ABS

    live = int((mask != 0).sum())
    if not live:
        return 0
    adds = _popcount(X_ABS) - 1
    shared = 62 * 36 + live * (63 * (31 + 39) + adds * (40 + 39)) - 39
    return min(shared, fq_products_miller_batch(mask) + (live - 1) * 54)


def fq_products_hard_part() -> int:
    """pairing_ops.final_exp_hard_part's least work: five |x| chains (63
    cyclotomic squarings, 18, and a product, 54, on each of the other
    1-bits of |x|), seven Fq12 products, the square of t (36) and the two
    Frobenius maps (per Fq2 coefficient none for 1, two for one in Fq or in
    u Fq, three otherwise)."""
    from ..bls381.constants import P, X_ABS
    from . import limbs as lb
    from . import tower as tw

    one, frob = lb.R_MONT % P, 0
    for k in (1, 2):
        c = [lb.unpack(x) for x in tw.FROB12_COEFF[k].reshape(12, lb.NL)]
        frob += sum(0 if (re, im) == (one, 0) else 2 if 0 in (re, im) else 3
                    for re, im in zip(c[0::2], c[1::2]))
    exp = 63 * 18 + (_popcount(X_ABS) - 1) * 54
    return 5 * exp + 7 * 54 + 36 + frob


def fq_products_h2c(n: int) -> int:
    """h2c.cu per message: per u-value the Montgomery conversion (2), SWU
    before sqrt_ratio (29), sqrt_ratio (91 + the a^E window chain: a
    14-product table, 4 squarings per later digit, a product per nonzero
    one), after it (12), two sgn0 (4) and the isogeny (84); then the add
    (44) and the cofactor clearing (two |x| multiplications of 64
    doublings and 5 adds past the first, three psi maps, a doubling, five
    adds)."""
    from ..bls381.constants import X_ABS
    from . import h2c_ops as h2
    from . import limbs as lb

    digits = lb.window_digits(h2._E, 4)
    pow_e = 14 * 3 + (len(digits) - 1) * 4 * 2 + sum(1 for d in digits[1:] if d) * 3
    per_u = 2 + 29 + 91 + pow_e + 12 + 4 + 84
    xmul = X_ABS.bit_length() * 16 + (_popcount(X_ABS) - 1) * 44
    clear = 2 * xmul + 3 * 6 + 16 + 5 * 44
    return n * (2 * per_u + 44 + clear)


def fq_products_easy_part() -> int:
    """easy_part.cu: the Fq12 inversion (four Fq6 products; the Fq6
    adjugate's three Fq2 squares and nine Fq2 products; one Fq2 inversion,
    its Fq inversion one product beside its GCD, int_ops_inverse), two Fq12
    products and a Frobenius (six Fq2 products)."""
    return 4 * 18 + (3 * 2 + 9 * 3) + (4 + 1) + 2 * 54 + 6 * 3


def bound_ms(fq_products: int, bytes_moved: int, int_ops: int = 0) -> tuple[float, str]:
    """The larger of the bytes over HBM's rate and the integer instructions
    (each Fq product's IMADs, and int_ops more) over the integer rate."""
    ops_ms = (fq_products * IMAD_PER_FQ_MUL + int_ops) / INT32_PER_S * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bytes_needed(x) -> int:
    """Bytes a function must move for x: 48 per 381-bit Fq element (an
    int64 tensor whose last axis holds the 24 limbs; the int64 16-bit-limb
    layout is the port's choice, not the work's) and one bit per 0/1 flag
    (every other tensor of these stages)."""
    total = 0
    for t in leaves(x):
        if t.dtype == torch.int64 and t.shape[-1:] == (NL,):
            total += t.numel() // NL * ELEMENT_BYTES
        else:
            total += (t.numel() + 7) // 8
    return total


# ------------------------------------------------------- the four stages


def stage_work(stage: str, args) -> tuple[int, int]:
    """(Fq products, further 32-bit integer instructions) of one stage of
    the verify (crypto/torchbls/backend.py) on its arguments:
      prepare  (pk_x, pk_y, pk_mask, sig_x, sig_y, z_bits, set_mask)
      h2c      (us,)
      pairs    (z_pk, h_jac, sig_acc, set_mask): the binary GCD of each of
               its 2n + 1 Z lanes
      pairing  (px, py, qxx, qyy, pair_mask): the Miller loop's least work,
               the easy part (one GCD) and the hard part."""
    if stage == "prepare":
        return fq_products_prepare(args[2], args[5], args[6]), 0
    if stage == "h2c":
        return fq_products_h2c(args[0].shape[0]), 0
    if stage == "pairs":
        n = args[-1].shape[0]
        return fq_products_pairs(n), (2 * n + 1) * int_ops_inverse()
    if stage == "pairing":
        products = fq_products_miller(args[4]) + fq_products_easy_part() + fq_products_hard_part()
        return products, int_ops_inverse()
    raise ValueError(f"no work count for stage {stage!r}")


def stage_stats(stage: str, args, out) -> dict:
    """The program analytics of one stage at its arguments and outputs (the
    port's counterpart of an XLA program's cost and memory analysis):
    `int_ops` (its 32-bit integer instructions: IMAD_PER_FQ_MUL per Fq
    product and the GCDs'), `fq_products`, `bytes_accessed` (bytes_needed
    of the arguments and the outputs), and `argument_bytes`/`output_bytes`
    (what the tensors hold in the port's layout)."""
    products, extra = stage_work(stage, args)
    return {
        "int_ops": float(products * IMAD_PER_FQ_MUL + extra),
        "fq_products": int(products),
        "bytes_accessed": float(bytes_needed(args) + bytes_needed(out)),
        "argument_bytes": int(sum(t.numel() * t.element_size() for t in leaves(args))),
        "output_bytes": int(sum(t.numel() * t.element_size() for t in leaves(out))),
    }
