"""The tree-hash and epoch kernels (csrc/sha256.cu, csrc/epoch.cu), their
ctypes wrappers, launch counters and plain PyTorch versions.

The rules of crypto/torchbls/kernels.py hold here too: the tensor's device
picks the lane (the plain version for CPU tensors, the kernel for CUDA
tensors), there is no fallback from one to the other, a wrapper adds one to
its `launches` attribute for each kernel it launches and nowhere else (the
ladder's one a level), and the
kernels are built at first use (utils/torchcfg.build_kernels) into a
library of their own, lh_hash, never at import.

Interchange: SHA-256 words are int32 tensors holding the uint32 words (the
kernels read them as uint32), big-endian words of the hashed bytes as
ssz/sha256_batch.words_from_bytes makes them; the byte swap is the host's
(torchhash/engine.py). The epoch vectors are int64 tensors holding uint64
values (two's complement), masks bool tensors. The plain versions hold
SHA-256 words in int64 masked to 32 bits and compute the epoch numerators
mod 2^64 with an unsigned floor division, since CPU torch has no uint32 or
uint64 add, >> or //.

Kernel, source, and the JAX device program it replaces:
  sha256_ladder  csrc/sha256.cu  lighthouse_tpu/jaxhash/engine.py:159 _make_ladder
                                 (with compress_rolled, :132)
  sha256_msgs    csrc/sha256.cu  engine.py:364 sha256_msgs_device
  epoch_deltas   csrc/epoch.cu   lighthouse_tpu/jaxhash/epoch_vectors.py:149
                                 _device_epoch_kernel
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..ssz import sha256_batch as sb
from ..ssz.core import ZERO_HASHES
from ..state_transition import accessors as acc
from ..utils import torchcfg

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sha256.cu", "epoch.cu")
MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


# ------------------------------------------------------------ build + load


def _words(data: bytes) -> list[int]:
    return [int.from_bytes(data[i:i + 4], "big") for i in range(0, len(data), 4)]


def _pad_schedule() -> list[int]:
    """The 64-word message schedule of the fixed pad block that follows
    every 64-byte merkle pair (PAIR_PAD_WORDS): the same for every node."""
    w = list(sb.PAIR_PAD_WORDS)
    for t in range(16, 64):
        w.append(sb.schedule_word(w[t - 16], w[t - 15], w[t - 7], w[t - 2]) & MASK32)
    return w


def _c_u32(name: str, values) -> str:
    return (f"static __constant__ uint32_t {name}[{len(values)}] = {{"
            + ", ".join(f"0x{v:08x}u" for v in values) + "};")


def consts_header() -> str:
    """hash_consts.cuh: SHA-256's K and H0, the pad block's schedule added
    to K (so a pad round adds one constant), the zero-subtree roots as
    words (a level's odd tail pairs with ZERO_HASHES[level]) and the
    participation flag weights, all from the tables the plain versions
    use."""
    kw = [(k + w) & MASK32 for k, w in zip(sb.SHA256_K, _pad_schedule())]
    zero = ",\n  ".join("{" + ", ".join(f"0x{v:08x}u" for v in _words(z)) + "}"
                        for z in ZERO_HASHES[:64])
    weights = acc.PARTICIPATION_FLAG_WEIGHTS
    return "\n".join([
        "// generated by lighthouse_tpu_torch.torchhash.kernels.consts_header",
        "#pragma once",
        "#include <stdint.h>",
        _c_u32("SHA_K", sb.SHA256_K),
        _c_u32("SHA_H0", sb.SHA256_H0),
        _c_u32("PAD_KW", kw),
        f"static __constant__ uint32_t ZERO_HASH_W[64][8] = {{\n  {zero}}};",
        f"#define N_FLAGS {len(weights)}",
        "static __constant__ uint64_t FLAG_WEIGHT[N_FLAGS] = {"
        + ", ".join(f"{w}ull" for w in weights) + "};",
        f"#define WEIGHT_DENOMINATOR {acc.WEIGHT_DENOMINATOR}ull",
        f"#define HEAD_FLAG {acc.TIMELY_HEAD_FLAG_INDEX}",
    ]) + "\n"


@functools.lru_cache(maxsize=None)
def library() -> torchcfg.KernelLibrary:
    """Build (or reuse) and load lh_hash, declaring every entry."""
    kl = torchcfg.build_kernels("lh_hash", [CSRC / s for s in SOURCES], CSRC,
                                {"hash_consts.cuh": consts_header()})
    vp, i32, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
    sigs = {
        "lh_sha256_ladder": ([vp, i64, vp, vp], i32),
        "lh_sha256_msgs": ([vp, i64, i32, vp, vp], i32),
        "lh_epoch_deltas": ([vp] * 5 + [i64] + [u64] * 7 + [i32] + [vp] * 4, i32),
    }
    for fname, (argtypes, restype) in sigs.items():
        fn = getattr(kl.lib, fname)
        fn.argtypes = argtypes
        fn.restype = restype
    return kl


def _lib():
    return library().lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _cuda(t: torch.Tensor, dtype, shape: tuple, what: str) -> torch.Tensor:
    """A contiguous CUDA tensor of exactly this dtype and shape, whose data
    starts on a 16-byte boundary (the SHA kernels read 16-byte vectors)."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{what}: want a CUDA {dtype} tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


# ------------------------------------------------------------ SHA-256 (plain)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 tensor holding the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def compress_plain(state: list, w16: list) -> list:
    """One SHA-256 compression over a batch: state and message as lists of
    8 and 16 int64 tensors of words below 2^32, through sha256_batch's
    schedule_word and round_step. Their right shifts only ever see masked
    words, and their other operations carry the low 32 bits exactly, so
    masking each new word is all the 32-bit arithmetic needs."""
    w = list(w16)
    for t in range(16, 64):
        w.append(sb.schedule_word(w[t - 16], w[t - 15], w[t - 7], w[t - 2]) & MASK32)
    v = tuple(state)
    for t in range(64):
        a, b, c, d, e, f, g, h = sb.round_step(v, sb.SHA256_K[t], w[t])
        v = (a & MASK32, b, c, d, e & MASK32, f, g, h)
    return [(x + s) & MASK32 for x, s in zip(v, state)]


def _h0(m: int, like: torch.Tensor) -> list:
    return [torch.full((m,), h, dtype=torch.int64, device=like.device) for h in sb.SHA256_H0]


def hash_pairs_plain(nodes: torch.Tensor, level: int) -> torch.Tensor:
    """One merkle level: (n, 8) int64 words -> (ceil(n/2), 8), an odd tail
    paired with ZERO_HASHES[level]."""
    if nodes.shape[0] % 2:
        zero = torch.tensor(_words(ZERO_HASHES[level]), dtype=torch.int64, device=nodes.device)
        nodes = torch.cat([nodes, zero[None]])
    pairs = nodes.reshape(-1, 16)
    m = pairs.shape[0]
    st = compress_plain(_h0(m, pairs), [pairs[:, j] for j in range(16)])
    pad = [torch.full((m,), p, dtype=torch.int64, device=pairs.device) for p in sb.PAIR_PAD_WORDS]
    return torch.stack(compress_plain(st, pad), dim=1)


def sha256_ladder_plain(words: torch.Tensor) -> tuple:
    cur = words.long() & MASK32
    levels = []
    while cur.shape[0] > 1:
        cur = hash_pairs_plain(cur, len(levels))
        levels.append(_to_int32(cur))
    return tuple(levels)


def ladder_widths(n: int) -> list[int]:
    """The level widths of a ladder over n nodes: ceil halvings down to 1."""
    widths = []
    while n > 1:
        n = (n + 1) // 2
        widths.append(n)
    return widths


def sha256_ladder(words):
    """The merkle levels above n nodes: (n, 8) int32 words -> a tuple of
    (ceil(n/2), 8), ..., (1, 8) int32 words, each level's odd tail paired
    with the zero-subtree root of its height (so a zero-padded power of two
    gives the same prefixes). On the card every level lands in one buffer
    allocated here, the tuple's entries are views of it in level order, and
    the kernel launches once per level: the count rises by the levels."""
    if _on_cpu(words):
        return sha256_ladder_plain(words)
    n = int(words.shape[0])
    words = _cuda(words, torch.int32, (n, 8), "words")
    widths = ladder_widths(n)
    if not widths:
        return ()
    buf = torch.empty((sum(widths), 8), dtype=torch.int32, device=words.device)
    _check(_lib().lh_sha256_ladder(words.data_ptr(), n, buf.data_ptr(), _stream()),
           "sha256_ladder")
    sha256_ladder.launches += len(widths)
    return tuple(torch.split(buf, widths))


def sha256_msgs_plain(words: torch.Tensor) -> torch.Tensor:
    n, nw = words.shape
    w = words.long() & MASK32
    st = _h0(n, w)
    for blk in range(nw // 16):
        st = compress_plain(st, [w[:, 16 * blk + j] for j in range(16)])
    return _to_int32(torch.stack(st, dim=1)) if n else words.new_zeros((0, 8))


def sha256_msgs(words):
    """SHA-256 of n padded messages: (n, 16 * blocks) int32 big-endian words
    (sha256_batch.pad_blocks' padding already appended) -> (n, 8) int32
    digest words."""
    if _on_cpu(words):
        return sha256_msgs_plain(words)
    n, nw = (int(s) for s in words.shape)
    if nw % 16 or nw == 0:
        raise ValueError(f"words: want whole 16-word blocks, got {nw} words a message")
    words = _cuda(words, torch.int32, (n, nw), "words")
    out = torch.empty((n, 8), dtype=torch.int32, device=words.device)
    if n:
        _check(_lib().lh_sha256_msgs(words.data_ptr(), n, nw // 16, out.data_ptr(), _stream()),
               "sha256_msgs")
        sha256_msgs.launches += 1
    return out


# ------------------------------------------------------------ epoch deltas


def _i64(v: int) -> int:
    """The int64 that holds the uint64 value v mod 2^64."""
    v &= MASK64
    return v - (1 << 64) if v > INT64_MAX else v


def _uge(a: torch.Tensor, b: torch.Tensor | int) -> torch.Tensor:
    """Unsigned a >= b of the uint64 values that int64 tensors hold."""
    flip = b ^ INT64_MIN if isinstance(b, torch.Tensor) else _i64(b) ^ INT64_MIN
    return (a ^ INT64_MIN) >= flip


def udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """floor(x / d) of the uint64 values that int64 x holds, for a Python
    int 0 < d < 2^64: the quotient of x's upper 63 bits, doubled, and one
    more where the remainder, below 2d, reaches d."""
    if d > INT64_MAX:
        return _uge(x, d).long()
    q = (((x >> 1) & INT64_MAX) // d) << 1
    return q + _uge(x - q * d, d).long()


def epoch_deltas_plain(eff, part, eligible, target, scores, base_per_incr, incr, flag_incrs,
                       total_incr, denom, leaking):
    """_device_epoch_kernel's arithmetic mod 2^64, in its order: base, the
    three flags' rewards and penalties (head's penalty 0), the inactivity
    penalty. The products wrap exactly as uint64 does; every quotient is
    udiv's."""
    zero = torch.zeros_like(eff)
    base = udiv(eff, incr) * _i64(base_per_incr)
    reward_denom = (total_incr * acc.WEIGHT_DENOMINATOR) & MASK64
    rewards, penalties = [], []
    for f, weight in enumerate(acc.PARTICIPATION_FLAG_WEIGHTS):
        p = part[f]
        num = base * weight * _i64(flag_incrs[f])
        rewards.append(torch.where(p & eligible & (not leaking), udiv(num, reward_denom), zero))
        if f == acc.TIMELY_HEAD_FLAG_INDEX:
            penalties.append(zero)
        else:
            penalties.append(torch.where(eligible & ~p, udiv(base * weight,
                                                             acc.WEIGHT_DENOMINATOR), zero))
    inact = torch.where(eligible & ~target, udiv(eff * scores, denom), zero)
    return torch.stack(rewards), torch.stack(penalties), inact


def epoch_deltas(eff, part, eligible, target, scores, base_per_incr, incr, flag_incrs,
                 total_incr, denom, leaking):
    """Per validator: the three flag rewards, the flag penalties and the
    inactivity penalty of the altair epoch, from eff and scores ((n,) int64
    holding uint64), the flag masks part ((3, n) bool), eligible and target
    ((n,) bool) and the epoch scalars (Python ints below 2^64, leaking a
    bool). Returns (3, n), (3, n) and (n,) int64 holding uint64."""
    if _on_cpu(eff):
        return epoch_deltas_plain(eff, part, eligible, target, scores, base_per_incr, incr,
                                  flag_incrs, total_incr, denom, leaking)
    n = int(eff.shape[0])
    nf = len(acc.PARTICIPATION_FLAG_WEIGHTS)
    eff = _cuda(eff, torch.int64, (n,), "eff")
    scores = _cuda(scores, torch.int64, (n,), "scores")
    part = _cuda(part, torch.bool, (nf, n), "part")
    eligible = _cuda(eligible, torch.bool, (n,), "eligible")
    target = _cuda(target, torch.bool, (n,), "target")
    rew = torch.empty((nf, n), dtype=torch.int64, device=eff.device)
    pen = torch.empty_like(rew)
    inact = torch.empty_like(eff)
    scalars = [base_per_incr, incr, *flag_incrs, total_incr, denom]
    if any(not 0 <= int(s) <= MASK64 for s in scalars) or not incr or not denom:
        raise ValueError(f"epoch scalars out of uint64 range or zero divisors: {scalars}")
    if n:
        _check(_lib().lh_epoch_deltas(eff.data_ptr(), part.data_ptr(), eligible.data_ptr(),
                                      target.data_ptr(), scores.data_ptr(), n,
                                      *[int(s) for s in scalars], int(bool(leaking)),
                                      rew.data_ptr(), pen.data_ptr(), inact.data_ptr(),
                                      _stream()), "epoch_deltas")
        epoch_deltas.launches += 1
    return rew, pen, inact


# ------------------------------------------------------------ registry

# name -> (wrapper, plain version, source under csrc/, the JAX program it
# replaces: file:line of its def)
KERNELS = {
    "sha256_ladder": (sha256_ladder, sha256_ladder_plain, "sha256.cu",
                      "lighthouse_tpu/jaxhash/engine.py:159"),
    "sha256_msgs": (sha256_msgs, sha256_msgs_plain, "sha256.cu",
                    "lighthouse_tpu/jaxhash/engine.py:364"),
    "epoch_deltas": (epoch_deltas, epoch_deltas_plain, "epoch.cu",
                     "lighthouse_tpu/jaxhash/epoch_vectors.py:149"),
}

for _wrapper, *_rest in KERNELS.values():
    _wrapper.launches = 0


def reset_launches() -> None:
    for wrapper, *_rest in KERNELS.values():
        wrapper.launches = 0
