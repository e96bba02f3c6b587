// Fq2 = Fq[u] / (u^2 + 1) over fq.cuh, for pairs.cu's one-thread lanes
// (the kernels with wider Fq12 work run it as product rounds or team
// programs, rounds.cuh and team.cuh). Memory layout of an Fq2 is the JAX
// package's (2, 24) interchange block: [re/im][16-bit limb].
//
// Every result is exact mod p, so these textbook formulas agree bit for bit
// with the plain versions' batched ones. All of it is inlined, so a lane's
// values stay in registers: no call frame, no stack.
#pragma once
#include "fq.cuh"

struct fp2 {
  fp c0, c1;
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

static __device__ __forceinline__ bool fp2_is_zero(const fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

static __device__ __forceinline__ void fp2_mul(fp2 &r, const fp2 &a, const fp2 &b) {
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

static __device__ __forceinline__ void fp2_sqr(fp2 &r, const fp2 &a) {
  fp s, d, c1;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(c1, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_dbl(r.c1, c1);
}

// 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); 0 maps to 0
static __device__ __forceinline__ void fp2_inv(fp2 &r, const fp2 &a) {
  fp n0, n1, ninv;
  fp_sqr(n0, a.c0);
  fp_sqr(n1, a.c1);
  fp_add(n0, n0, n1);
  fp_inv(ninv, n0);
  fp_mul(r.c0, a.c0, ninv);
  fp_mul(n1, a.c1, ninv);
  fp_neg(r.c1, n1);
}
