// Fq, the BLS12-381 base field, for the port's hand-written Hopper kernels.
//
// An element is 12 little-endian 32-bit limbs in Montgomery form with
// R = 2^384, always fully reduced (< p). The torch side keeps the JAX
// package's 24 x 16-bit limbs (int64 tensors); fp_load/fp_store repack at
// the kernel boundary. R is 2^384 in both layouts, so the kernels and the
// plain versions agree bit for bit.
//
// Multiplication is CIOS Montgomery over 32-bit words on PTX carry chains
// (mad.lo.cc / madc.hi.cc): 12 x 12 multiply-adds plus the interleaved
// reduction, each as a low and a high word, ~600 integer instructions.
// The constants (p, -p^-1 mod 2^32, R mod p, R^2 mod p, R^3 mod p, the
// inversion's batch counts, the Frobenius coefficients) come from the
// generated bls_consts.cuh, written at build time from the package's
// Python tables (kernels.py).
#pragma once
#include <stdint.h>

#include "bls_consts.cuh"

struct fp {
  uint32_t v[12];
};

// Carry-chain primitives: one PTX instruction each, kept in program order
// (asm volatile), so the carry flag set by one is read by the next.
static __device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
static __device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
static __device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
static __device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
static __device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
static __device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo/hi word of a * b, plus c, plus the carry (madc) or not (mad)
static __device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
static __device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
static __device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
static __device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
static __device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

static __device__ __forceinline__ void fp_load(fp &r, const int64_t *src) {
#pragma unroll
  for (int i = 0; i < 12; i++)
    r.v[i] = (uint32_t)src[2 * i] | ((uint32_t)src[2 * i + 1] << 16);
}

static __device__ __forceinline__ void fp_store(int64_t *dst, const fp &a) {
#pragma unroll
  for (int i = 0; i < 12; i++) {
    dst[2 * i] = a.v[i] & 0xFFFFu;
    dst[2 * i + 1] = a.v[i] >> 16;
  }
}

static __device__ __forceinline__ void fp_set_zero(fp &r) {
#pragma unroll
  for (int i = 0; i < 12; i++) r.v[i] = 0;
}

static __device__ __forceinline__ void fp_set_one(fp &r) {
#pragma unroll
  for (int i = 0; i < 12; i++) r.v[i] = FP_ONE[i];
}

static __device__ __forceinline__ bool fp_is_zero(const fp &a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) acc |= a.v[i];
  return acc == 0;
}

// r = t mod p for t < 2p given as 12 words plus a top word (0 or 1): one
// borrow chain of t - p, then a select
static __device__ __forceinline__ void fp_reduce_once(fp &r, const uint32_t *t, uint32_t top) {
  uint32_t d[12];
  d[0] = sub_cc(t[0], FP_P[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) d[i] = subc_cc(t[i], FP_P[i]);
  const bool lt = subc(top, 0) == 0xFFFFFFFFu;   // t < p
#pragma unroll
  for (int i = 0; i < 12; i++) r.v[i] = lt ? t[i] : d[i];
}

static __device__ __forceinline__ void fp_add(fp &r, const fp &a, const fp &b) {
  uint32_t t[12];
  t[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) t[i] = addc_cc(a.v[i], b.v[i]);
  fp_reduce_once(r, t, addc(0, 0));
}

static __device__ __forceinline__ void fp_sub(fp &r, const fp &a, const fp &b) {
  uint32_t t[12];
  t[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) t[i] = subc_cc(a.v[i], b.v[i]);
  const uint32_t mask = subc(0, 0);   // a < b: add p back (the carry out cancels the borrow)
  r.v[0] = add_cc(t[0], FP_P[0] & mask);
#pragma unroll
  for (int i = 1; i < 11; i++) r.v[i] = addc_cc(t[i], FP_P[i] & mask);
  r.v[11] = addc(t[11], FP_P[11] & mask);
}

static __device__ __forceinline__ void fp_neg(fp &r, const fp &a) {
  fp z;
  fp_set_zero(z);
  fp_sub(r, z, a);
}

static __device__ __forceinline__ void fp_dbl(fp &r, const fp &a) { fp_add(r, a, a); }

// E += w[0, 2, .., 10] * k: the even-indexed words' products fill the
// consecutive words of E (lo of w[j] k at j, hi at j + 1), one carry chain;
// the carry out is left in the flag.
static __device__ __forceinline__ void fp_cmad_even(uint32_t *E, const uint32_t *w, uint32_t k) {
  E[0] = mad_lo_cc(w[0], k, E[0]);
  E[1] = madc_hi_cc(w[0], k, E[1]);
#pragma unroll
  for (int j = 2; j < 12; j += 2) {
    E[j] = madc_lo_cc(w[j], k, E[j]);
    E[j + 1] = madc_hi_cc(w[j], k, E[j + 1]);
  }
}

// One row of the product, b_i = bi, and its reduction step. On entry E
// holds the words of weight 0..11 and O those of weight -1..10 (O[0] is the
// word the last reduction zeroed). On exit O holds weights 1..12 and E
// weights 0..11 with E[0] == 0, so the caller swaps the two for the next
// row. The accumulator stays below 2p between rows and below 2^415 inside
// one (p < 2^381), so the carries this drops are zero.
static __device__ __forceinline__ void fp_mul_row(uint32_t *E, uint32_t *O, const uint32_t *a,
                                                  uint32_t bi, bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < 12; j += 2) {
      E[j] = a[j] * bi;
      E[j + 1] = __umulhi(a[j], bi);
      O[j] = a[j + 1] * bi;
      O[j + 1] = __umulhi(a[j + 1], bi);
    }
  } else {
    // fold O[1] into E[0] and shift O down two words while adding the odd
    // words' products (weights 1..12), on one carry chain
    E[0] = add_cc(E[0], O[1]);
#pragma unroll
    for (int j = 0; j < 10; j += 2) {
      O[j] = madc_lo_cc(a[j + 1], bi, O[j + 2]);
      O[j + 1] = madc_hi_cc(a[j + 1], bi, O[j + 3]);
    }
    O[10] = madc_lo_cc(a[11], bi, 0);
    O[11] = madc_hi(a[11], bi, 0);
    fp_cmad_even(E, a, bi);
    O[11] = addc(O[11], 0);
  }
  const uint32_t m = E[0] * FP_INV;
  O[0] = mad_lo_cc(FP_P[1], m, O[0]);
  O[1] = madc_hi_cc(FP_P[1], m, O[1]);
#pragma unroll
  for (int j = 2; j < 10; j += 2) {
    O[j] = madc_lo_cc(FP_P[j + 1], m, O[j]);
    O[j + 1] = madc_hi_cc(FP_P[j + 1], m, O[j + 1]);
  }
  O[10] = madc_lo_cc(FP_P[11], m, O[10]);
  O[11] = madc_hi(FP_P[11], m, O[11]);
  uint32_t pe[12];
#pragma unroll
  for (int j = 0; j < 12; j++) pe[j] = FP_P[j];
  fp_cmad_even(E, pe, m);
  O[11] = addc(O[11], 0);
}

// Montgomery product a * b * 2^-384 mod p: CIOS over 32-bit words with PTX
// carry chains, the products of the even- and the odd-indexed words of a
// in two accumulators (so no carry waits on a high word), then one
// conditional subtraction. The same value as any Montgomery product.
static __device__ __forceinline__ void fp_mul_final(fp &r, const uint32_t *X, const uint32_t *Y) {
  // the result: X at weights 0..11 plus Y shifted down one word
  uint32_t t[12], d[12];
  t[0] = add_cc(X[0], Y[1]);
#pragma unroll
  for (int k = 1; k < 11; k++) t[k] = addc_cc(X[k], Y[k + 1]);
  t[11] = addc(X[11], 0);
  d[0] = sub_cc(t[0], FP_P[0]);
#pragma unroll
  for (int k = 1; k < 12; k++) d[k] = subc_cc(t[k], FP_P[k]);
  const uint32_t lt = subc(0, 0);   // all ones when t < p
#pragma unroll
  for (int k = 0; k < 12; k++) r.v[k] = lt ? t[k] : d[k];
}

static __device__ __forceinline__ void fp_mul(fp &r, const fp &a, const fp &b) {
  uint32_t X[12], Y[12];
#pragma unroll
  for (int i = 0; i < 12; i += 2) {
    fp_mul_row(X, Y, a.v, b.v[i], i == 0);
    fp_mul_row(Y, X, a.v, b.v[i + 1], false);
  }
  fp_mul_final(r, X, Y);
}

static __device__ __forceinline__ void fp_sqr(fp &r, const fp &a) { fp_mul(r, a, a); }

// standard form -> Montgomery form: the product by R^2
static __device__ __forceinline__ void fp_to_mont(fp &r, const fp &a) {
  fp r2;
#pragma unroll
  for (int i = 0; i < 12; i++) r2.v[i] = FP_R2[i];
  fp_mul(r, a, r2);
}

// ------------------------------------------------------------ inversion
//
// a^-1 for a in Montgomery form (0 maps to 0): Pornin's optimized binary
// GCD (eprint 2020/972, Algorithm 2, k = 31), not a Fermat chain. The
// inputs of a verification are public, so the inversion need not be
// constant-time; it is branch-free all the same, so the lanes of a warp
// that invert different values never diverge. From x = aR it runs
// INV_BATCHES batches of INV_STEPS divsteps, 2 * 381 - 1 divsteps in all
// rounded up (bls_consts.cuh): each batch takes the divsteps on 62-bit
// approximations of a and b (their low 30 bits exact, their top 32 bits
// at the bit length of the larger), collects them as a 2x2 matrix of
// signed factors with |f| + |g| <= 2^30, and applies it to the 12-word a,
// b (exactly, then divided by 2^30) and u, v (mod p, with a Montgomery
// division by 2^30). So b ends at gcd = 1 and v at x^-1 = a^-1 R^-1, and
// one product by R^3 gives a^-1 R. An inverse is unique and every result
// is fully reduced, so it equals a Fermat chain's bits.
// tests/test_torch_inverse.py restates it on 32-bit words.

// t (13 words) += x * k for a 12-word x; the sum stays below 2^416
static __device__ __forceinline__ void inv_mad(uint32_t *t, const uint32_t *x, uint32_t k) {
  t[0] = mad_lo_cc(x[0], k, t[0]);
#pragma unroll
  for (int j = 1; j < 12; j++) t[j] = madc_lo_cc(x[j], k, t[j]);
  t[12] = addc(t[12], 0);
  t[1] = mad_hi_cc(x[0], k, t[1]);
#pragma unroll
  for (int j = 2; j < 12; j++) t[j] = madc_hi_cc(x[j - 1], k, t[j]);
  t[12] = madc_hi(x[11], k, t[12]);
}

// x = -x (two's complement over n words) where neg
template <int N>
static __device__ __forceinline__ void inv_cneg(uint32_t *x, bool neg) {
  const uint32_t m = neg ? 0xFFFFFFFFu : 0u;
  x[0] = add_cc(x[0] ^ m, m & 1u);
#pragma unroll
  for (int j = 1; j < N - 1; j++) x[j] = addc_cc(x[j] ^ m, 0);
  x[N - 1] = addc(x[N - 1] ^ m, 0);
}

// r = (x f + y g) / 2^30 for x, y < 2^381, |f| + |g| <= 2^30: exact, as
// the batch's divsteps cleared the low 30 bits. r gets the magnitude; the
// sign is returned.
static __device__ __forceinline__ bool inv_lin(uint32_t *r, const uint32_t *x, const uint32_t *y,
                                               int32_t f, int32_t g) {
  uint32_t X[13], Y[13];
#pragma unroll
  for (int j = 0; j < 13; j++) X[j] = Y[j] = 0;
  inv_mad(X, x, f < 0 ? -f : f);
  inv_cneg<13>(X, f < 0);
  inv_mad(Y, y, g < 0 ? -g : g);
  inv_cneg<13>(Y, g < 0);
  X[0] = add_cc(X[0], Y[0]);
#pragma unroll
  for (int j = 1; j < 12; j++) X[j] = addc_cc(X[j], Y[j]);
  X[12] = addc(X[12], Y[12]);
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = __funnelshift_r(X[j], X[j + 1], 30);
  const bool neg = r[11] >> 31;   // |r| < 2^381: bit 383 is the sign
  inv_cneg<12>(r, neg);
  return neg;
}

// r = (u f + v g) / 2^30 mod p for u, v < p, |f| + |g| <= 2^30: u is taken
// as -u mod p where f < 0 (v likewise), so both terms are nonnegative; then
// q p, q = t (-p^-1) mod 2^30, clears the low 30 bits, and the quotient,
// below 2p, takes one conditional subtraction.
static __device__ __forceinline__ void inv_lin_mod(fp &r, const fp &u, const fp &v, int32_t f,
                                                   int32_t g) {
  fp nu, nv;
  fp_neg(nu, u);
  fp_neg(nv, v);
  uint32_t t[13];
#pragma unroll
  for (int j = 0; j < 13; j++) t[j] = 0;
  fp uu, vv;
#pragma unroll
  for (int j = 0; j < 12; j++) {
    uu.v[j] = f < 0 ? nu.v[j] : u.v[j];
    vv.v[j] = g < 0 ? nv.v[j] : v.v[j];
  }
  inv_mad(t, uu.v, f < 0 ? -f : f);
  inv_mad(t, vv.v, g < 0 ? -g : g);
  uint32_t pw[12];
#pragma unroll
  for (int j = 0; j < 12; j++) pw[j] = FP_P[j];
  inv_mad(t, pw, (t[0] * FP_INV) & 0x3FFFFFFFu);
  uint32_t w[12];
#pragma unroll
  for (int j = 0; j < 12; j++) w[j] = __funnelshift_r(t[j], t[j + 1], 30);
  fp_reduce_once(r, w, 0);
}

// the 62-bit approximation of x for n = s + 32: its low 30 bits, and its
// bits s .. s + 31 above them (30 <= s <= 349, so the word x[s / 32 + 1]
// exists); selects, not an indexed load, so x stays in registers
static __device__ __forceinline__ uint64_t inv_approx(const uint32_t *x, uint32_t s) {
  const uint32_t q = s >> 5;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 11; j++) {
    lo = j == q ? x[j] : lo;
    hi = j == q ? x[j + 1] : hi;
  }
  return ((uint64_t)__funnelshift_r(lo, hi, s & 31) << 30) | (x[0] & 0x3FFFFFFFu);
}

static __device__ __forceinline__ void fp_inv(fp &r, const fp &x) {
  fp a = x, b, u, v;
#pragma unroll
  for (int j = 0; j < 12; j++) {
    b.v[j] = FP_P[j];
    u.v[j] = v.v[j] = 0;
  }
  u.v[0] = 1;
#pragma unroll 1
  for (int batch = 0; batch < INV_BATCHES; batch++) {
    // n = max(len(a), len(b), 62), s = n - 32
    uint32_t len = 0;
#pragma unroll
    for (int j = 0; j < 12; j++) {
      const uint32_t w = a.v[j] | b.v[j];
      len = w ? 32 * j + 32 - __clz(w) : len;
    }
    const uint32_t s = (len > 62 ? len : 62) - 32;
    uint64_t A = inv_approx(a.v, s), B = inv_approx(b.v, s);
    int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
    for (int k = 0; k < INV_STEPS; k++) {
      // odd A: if A < B swap the pair (and the rows), then A -= B; halve A
      const bool odd = A & 1, sw = odd & (A < B);
      const uint64_t A1 = sw ? B : A, B1 = sw ? A : B;
      const int32_t F0 = sw ? f1 : f0, G0 = sw ? g1 : g0, F1 = sw ? f0 : f1, G1 = sw ? g0 : g1;
      A = (A1 - (odd ? B1 : 0)) >> 1;
      B = B1;
      f0 = F0 - (odd ? F1 : 0);
      g0 = G0 - (odd ? G1 : 0);
      f1 = 2 * F1;
      g1 = 2 * G1;
    }
    fp na, nb, nu, nv;
    const bool sa = inv_lin(na.v, a.v, b.v, f0, g0);
    const bool sb = inv_lin(nb.v, a.v, b.v, f1, g1);
    f0 = sa ? -f0 : f0;
    g0 = sa ? -g0 : g0;
    f1 = sb ? -f1 : f1;
    g1 = sb ? -g1 : g1;
    inv_lin_mod(nu, u, v, f0, g0);
    inv_lin_mod(nv, u, v, f1, g1);
    a = na;
    b = nb;
    u = nu;
    v = nv;
  }
  fp r3;
#pragma unroll
  for (int j = 0; j < 12; j++) r3.v[j] = FP_R3[j];
  fp_mul(r, v, r3);
}
