// The BLS12-381 tower for the hand-written kernels, over fq.cuh:
//   Fq2  = Fq[u]  / (u^2 + 1)
//   Fq6  = Fq2[v] / (v^3 - xi), xi = u + 1
//   Fq12 = Fq6[w] / (w^2 - v)
// Memory layout of an Fq12 is the JAX package's (2, 3, 2, 24) interchange
// block: [Fq6 half][Fq2 component][re/im][16-bit limb].
//
// Every result is exact mod p, so these textbook formulas agree bit for bit
// with the plain versions' batched ones. The larger products are
// __noinline__: an Fq12 product inlined everywhere would multiply the code
// size (and nvcc's time) for no gain in a first, latency-bound version.
#pragma once
#include "fq.cuh"

struct fp2 {
  fp c0, c1;
};
struct fp6 {
  fp2 c0, c1, c2;
};
struct fp12 {
  fp6 c0, c1;
};

// ------------------------------------------------------------------ Fq2

static __device__ __forceinline__ void fp2_load(fp2 &r, const int64_t *src) {
  fp_load(r.c0, src);
  fp_load(r.c1, src + 24);
}

static __device__ __forceinline__ void fp2_store(int64_t *dst, const fp2 &a) {
  fp_store(dst, a.c0);
  fp_store(dst + 24, a.c1);
}

static __device__ __forceinline__ void fp2_set_zero(fp2 &r) {
  fp_set_zero(r.c0);
  fp_set_zero(r.c1);
}

static __device__ __forceinline__ void fp2_set_one(fp2 &r) {
  fp_set_one(r.c0);
  fp_set_zero(r.c1);
}

static __device__ __forceinline__ bool fp2_is_zero(const fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

static __device__ __forceinline__ void fp2_add(fp2 &r, const fp2 &a, const fp2 &b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

static __device__ __forceinline__ void fp2_sub(fp2 &r, const fp2 &a, const fp2 &b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

static __device__ __forceinline__ void fp2_neg(fp2 &r, const fp2 &a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}

static __device__ __forceinline__ void fp2_conj(fp2 &r, const fp2 &a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}

// (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u
static __device__ __forceinline__ void fp2_mul_by_xi(fp2 &r, const fp2 &a) {
  fp t;
  fp_sub(t, a.c0, a.c1);
  fp_add(r.c1, a.c0, a.c1);
  r.c0 = t;
}

static __device__ __noinline__ void fp2_mul(fp2 &r, const fp2 &a, const fp2 &b) {
  fp t0, t1, sa, sb, t2;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t2, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

static __device__ __noinline__ void fp2_sqr(fp2 &r, const fp2 &a) {
  fp s, d, c1;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(c1, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_dbl(r.c1, c1);
}

// 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); 0 maps to 0
static __device__ __noinline__ void fp2_inv(fp2 &r, const fp2 &a) {
  fp n0, n1, ninv;
  fp_sqr(n0, a.c0);
  fp_sqr(n1, a.c1);
  fp_add(n0, n0, n1);
  fp_inv(ninv, n0);
  fp_mul(r.c0, a.c0, ninv);
  fp_mul(n1, a.c1, ninv);
  fp_neg(r.c1, n1);
}

// ------------------------------------------------------------------ Fq6

static __device__ __forceinline__ void fp6_add(fp6 &r, const fp6 &a, const fp6 &b) {
  fp2_add(r.c0, a.c0, b.c0);
  fp2_add(r.c1, a.c1, b.c1);
  fp2_add(r.c2, a.c2, b.c2);
}

static __device__ __forceinline__ void fp6_sub(fp6 &r, const fp6 &a, const fp6 &b) {
  fp2_sub(r.c0, a.c0, b.c0);
  fp2_sub(r.c1, a.c1, b.c1);
  fp2_sub(r.c2, a.c2, b.c2);
}

static __device__ __forceinline__ void fp6_neg(fp6 &r, const fp6 &a) {
  fp2_neg(r.c0, a.c0);
  fp2_neg(r.c1, a.c1);
  fp2_neg(r.c2, a.c2);
}

// (a0 + a1 v + a2 v^2) v = xi a2 + a0 v + a1 v^2
static __device__ __forceinline__ void fp6_mul_by_v(fp6 &r, const fp6 &a) {
  fp2 t;
  fp2_mul_by_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

static __device__ __noinline__ void fp6_mul(fp6 &r, const fp6 &a, const fp6 &b) {
  fp2 t0, t1, t2, x, y, c0, c1, c2;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  // c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
  fp2_add(x, a.c1, a.c2);
  fp2_add(y, b.c1, b.c2);
  fp2_mul(c0, x, y);
  fp2_sub(c0, c0, t1);
  fp2_sub(c0, c0, t2);
  fp2_mul_by_xi(c0, c0);
  fp2_add(c0, c0, t0);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  fp2_add(x, a.c0, a.c1);
  fp2_add(y, b.c0, b.c1);
  fp2_mul(c1, x, y);
  fp2_sub(c1, c1, t0);
  fp2_sub(c1, c1, t1);
  fp2_mul_by_xi(x, t2);
  fp2_add(c1, c1, x);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  fp2_add(x, a.c0, a.c2);
  fp2_add(y, b.c0, b.c2);
  fp2_mul(c2, x, y);
  fp2_sub(c2, c2, t0);
  fp2_sub(c2, c2, t2);
  fp2_add(c2, c2, t1);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// 1 / (a0 + a1 v + a2 v^2) by the adjugate: c0 = a0^2 - xi a1 a2,
// c1 = xi a2^2 - a0 a1, c2 = a1^2 - a0 a2, t = a0 c0 + xi (a1 c2 + a2 c1),
// result c / t (tower.fq6_inv's formula; an inverse is unique)
static __device__ __noinline__ void fp6_inv(fp6 &r, const fp6 &a) {
  fp2 s0, s1, s2, p01, p12, p20, c0, c1, c2, t, x, tinv;
  fp2_sqr(s0, a.c0);
  fp2_sqr(s1, a.c1);
  fp2_sqr(s2, a.c2);
  fp2_mul(p01, a.c0, a.c1);
  fp2_mul(p12, a.c1, a.c2);
  fp2_mul(p20, a.c2, a.c0);
  fp2_mul_by_xi(x, p12);
  fp2_sub(c0, s0, x);
  fp2_mul_by_xi(x, s2);
  fp2_sub(c1, x, p01);
  fp2_sub(c2, s1, p20);
  fp2_mul(t, a.c0, c0);
  fp2_mul(s0, a.c1, c2);
  fp2_mul(s1, a.c2, c1);
  fp2_add(x, s0, s1);
  fp2_mul_by_xi(x, x);
  fp2_add(t, t, x);
  fp2_inv(tinv, t);
  fp2_mul(r.c0, c0, tinv);
  fp2_mul(r.c1, c1, tinv);
  fp2_mul(r.c2, c2, tinv);
}

// ------------------------------------------------------------------ Fq12

static __device__ __forceinline__ void fp12_load(fp12 &r, const int64_t *src) {
  fp2_load(r.c0.c0, src);
  fp2_load(r.c0.c1, src + 48);
  fp2_load(r.c0.c2, src + 96);
  fp2_load(r.c1.c0, src + 144);
  fp2_load(r.c1.c1, src + 192);
  fp2_load(r.c1.c2, src + 240);
}

static __device__ __forceinline__ void fp12_store(int64_t *dst, const fp12 &a) {
  fp2_store(dst, a.c0.c0);
  fp2_store(dst + 48, a.c0.c1);
  fp2_store(dst + 96, a.c0.c2);
  fp2_store(dst + 144, a.c1.c0);
  fp2_store(dst + 192, a.c1.c1);
  fp2_store(dst + 240, a.c1.c2);
}

static __device__ __forceinline__ void fp12_set_one(fp12 &r) {
  fp2_set_one(r.c0.c0);
  fp2_set_zero(r.c0.c1);
  fp2_set_zero(r.c0.c2);
  fp2_set_zero(r.c1.c0);
  fp2_set_zero(r.c1.c1);
  fp2_set_zero(r.c1.c2);
}

static __device__ __forceinline__ void fp12_conj(fp12 &r, const fp12 &a) {
  r.c0 = a.c0;
  fp6_neg(r.c1, a.c1);
}

// 1 / (a0 + a1 w) = (a0 - a1 w) / (a0^2 - v a1^2); 0 maps to 0
static __device__ __noinline__ void fp12_inv(fp12 &r, const fp12 &a) {
  fp6 t0, t1, tinv;
  fp6_mul(t0, a.c0, a.c0);
  fp6_mul(t1, a.c1, a.c1);
  fp6_mul_by_v(t1, t1);
  fp6_sub(t0, t0, t1);
  fp6_inv(tinv, t0);
  fp6_mul(t1, a.c1, tinv);
  fp6_mul(r.c0, a.c0, tinv);
  fp6_neg(r.c1, t1);
}

static __device__ __noinline__ void fp12_mul(fp12 &r, const fp12 &a, const fp12 &b) {
  fp6 t0, t1, x, y, c1;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_add(y, b.c0, b.c1);
  fp6_mul(c1, x, y);
  fp6_sub(c1, c1, t0);
  fp6_sub(c1, c1, t1);
  fp6_mul_by_v(t1, t1);
  fp6_add(r.c0, t0, t1);
  r.c1 = c1;
}

// complex squaring: t = a0 a1; s = (a0 + a1)(a0 + v a1); c0 = s - t - v t; c1 = 2t
static __device__ __noinline__ void fp12_sqr(fp12 &r, const fp12 &a) {
  fp6 t, s, x, y;
  fp6_mul(t, a.c0, a.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_mul_by_v(y, a.c1);
  fp6_add(y, a.c0, y);
  fp6_mul(s, x, y);
  fp6_sub(s, s, t);
  fp6_mul_by_v(x, t);
  fp6_sub(r.c0, s, x);
  fp6_add(r.c1, t, t);
}

// a^(p^power), power 1 or 2: conjugate every Fq2 component for odd powers,
// then multiply component (i, j) by the generated coefficient FROB_k[3i + j]
static __device__ __noinline__ void fp12_frobenius(fp12 &r, const fp12 &a, int power) {
  fp2 *rc[6] = {&r.c0.c0, &r.c0.c1, &r.c0.c2, &r.c1.c0, &r.c1.c1, &r.c1.c2};
  const fp2 *ac[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int k = 0; k < 6; k++) {
    fp2 x, c;
    if (power & 1)
      fp2_conj(x, *ac[k]);
    else
      x = *ac[k];
#pragma unroll
    for (int i = 0; i < 12; i++) {
      c.c0.v[i] = power == 1 ? FROB1[k][0][i] : FROB2[k][0][i];
      c.c1.v[i] = power == 1 ? FROB1[k][1][i] : FROB2[k][1][i];
    }
    fp2_mul(*rc[k], x, c);
  }
}
