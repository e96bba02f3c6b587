// The G1 multi-scalar multiplication's three device programs on the card.
//
// Replaces the XLA programs of lighthouse_tpu/crypto/jaxbls/msm.py, which
// have no Pallas form:
//   msm_precompute  _precompute_kernel (:134): standard-form affine points
//                   -> Montgomery Jacobian comb tables T[j][i] =
//                   2^(16 j) P_i, row j written before its 16 doublings, as
//                   the scan emits it; one thread per point;
//   msm_fixed       _msm_kernel (:157): per lane (j, i) a 16-bit
//                   double-and-add of T[j][i] by chunk c_ij (MSB first),
//                   then the sum of all lanes, its affine form in standard
//                   form and the infinity flag; one thread per lane;
//   msm_varying     varying_base_msm_kernel (:99): Montgomery form, the
//                   Jacobian point of each live lane, a windowed scalar
//                   multiplication (a per-thread table of 2^w points, w in
//                   {2, 4, 5, 6}) or, at w = 0, the bit form over base-16
//                   digits, the masked sum, the affine form; one thread per
//                   point, one instantiation per width. A digit outside
//                   [0, 2^w) (16 at w = 0) is never used as an index: the
//                   block flags it, and the sum comes back as x = y =
//                   2^384 - 1, which no standard-form coordinate is, so the
//                   host's read of it (msm.affine_result) refuses it.
//
// The point formulas are curve_ops' jac_double and its complete jac_add
// (the identity on either side, P == Q takes the doubling, P == -Q gives
// the identity (one, one, zero)), one thread each, so the Jacobian tables
// of msm_precompute equal the plain version's bits. The sums of msm_fixed
// and msm_varying return affine coordinates, which are unique (every
// identity these formulas make is (one, one, zero), which doubling keeps),
// so they sum in any order: a tree in shared memory inside each block, the
// block sums to scratch, then one block (msm_finish_kernel) sums those and
// converts with one fp_inv and a product by 1 (out of Montgomery form).
//
// Bound on this card: integer instructions, not bytes. msm_fixed at 4096
// points is 65536 lanes of ~16 doublings (7 Fq products) and ~8 additions
// (16), ~15M Fq products of ~600 IMADs each, and the 65536-lane sum: the
// one program here that fills the card, one lane a thread over 512
// blocks. msm_precompute (4096 chains of 240 doublings) and msm_varying
// (a few dozen chains of ~256 doublings) are chains of dependent products
// in one thread each, far below the card's width: their time is the chain's
// latency. The design is the simple one: one thread per point or lane,
// g1_add and g1_dbl out of line (one copy of their products in the
// library), the windowed table in local memory, sized by the width's
// instantiation (16 points, 2.3 KB a thread, at w = 4; 64 points, 9 KB, at
// w = 6). The interchange layout (24 16-bit limbs in int64) is repacked
// to 12 32-bit words at the boundary (fq.cuh).
#include "fq.cuh"

#define MSM_THREADS 128      // threads of the lane kernels' blocks
#define FINISH_THREADS 256   // threads of msm_finish_kernel's one block
#define CHUNK_BITS 16        // bits of a comb chunk (msm.py CHUNK_BITS)
#define N_CHUNKS 16          // comb rows (msm.py N_CHUNKS)

struct g1 {
  fp x, y, z;
};

#define G1_WORDS 36          // a g1 in scratch: three Fq elements of 12 words

static __device__ __forceinline__ void g1_set_identity(g1 &r) {
  fp_set_one(r.x);
  fp_set_one(r.y);
  fp_set_zero(r.z);
}

// r = k a for a small constant k, by additions (any method gives the same
// fully reduced value as curve_ops' mul_small)
static __device__ __forceinline__ void fp_x2(fp &r, const fp &a) { fp_add(r, a, a); }

// curve_ops.jac_double: A = X^2, B = Y^2, C = B^2, E = 3A, D = 2((X + B)^2
// - A - C), X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ. The identity
// (Z = 0) stays Z = 0, and (one, one, zero) maps to itself. r may be p.
static __device__ __noinline__ void g1_dbl(g1 &r, const g1 &p) {
  fp A, B, YZ, E, XB, C, t, F, D, X3, Y3;
  fp_mul(A, p.x, p.x);
  fp_mul(B, p.y, p.y);
  fp_mul(YZ, p.y, p.z);
  fp_x2(E, A);
  fp_add(E, E, A);
  fp_add(XB, p.x, B);
  fp_mul(C, B, B);
  fp_mul(t, XB, XB);
  fp_mul(F, E, E);
  fp_sub(D, t, A);
  fp_sub(D, D, C);
  fp_x2(D, D);
  fp_x2(t, D);
  fp_sub(X3, F, t);
  fp_sub(t, D, X3);
  fp_mul(Y3, E, t);
  fp_x2(C, C);
  fp_x2(C, C);
  fp_x2(C, C);
  fp_sub(r.y, Y3, C);
  fp_x2(r.z, YZ);
  r.x = X3;
}

// curve_ops.jac_add, complete: p when q is the identity, q when p is; the
// doubling of p when H == r == 0 (P == Q), the identity (one, one, zero)
// when H == 0 != r (P == -Q); else the general sum, U1 = X1 Z2^2, U2 = X2
// Z1^2, S1 = Y1 Z2^3, S2 = Y2 Z1^3, H = U2 - U1, r = S2 - S1, X3 = r^2 -
// H^3 - 2 U1 H^2, Y3 = r (U1 H^2 - X3) - S1 H^3, Z3 = Z1 Z2 H. Only the
// branch taken is computed; each gives the select's value. r may be p or q.
static __device__ __noinline__ void g1_add(g1 &r, const g1 &p, const g1 &q) {
  if (fp_is_zero(q.z)) {
    r = p;
    return;
  }
  if (fp_is_zero(p.z)) {
    r = q;
    return;
  }
  fp Z1Z1, Z2Z2, U1, U2, S1, S2, H, R, t;
  fp_mul(Z1Z1, p.z, p.z);
  fp_mul(Z2Z2, q.z, q.z);
  fp_mul(U1, p.x, Z2Z2);
  fp_mul(U2, q.x, Z1Z1);
  fp_mul(t, p.y, q.z);
  fp_mul(S1, t, Z2Z2);
  fp_mul(t, q.y, p.z);
  fp_mul(S2, t, Z1Z1);
  fp_sub(H, U2, U1);
  fp_sub(R, S2, S1);
  if (fp_is_zero(H)) {
    if (fp_is_zero(R))
      g1_dbl(r, p);
    else
      g1_set_identity(r);
    return;
  }
  fp HH, HHH, V, X3, Y3, Z3;
  fp_mul(HH, H, H);
  fp_mul(HHH, H, HH);
  fp_mul(V, U1, HH);
  fp_mul(t, R, R);
  fp_sub(X3, t, HHH);
  fp_x2(t, V);
  fp_sub(X3, X3, t);
  fp_sub(t, V, X3);
  fp_mul(Y3, R, t);
  fp_mul(t, S1, HHH);
  fp_sub(Y3, Y3, t);
  fp_mul(t, p.z, q.z);
  fp_mul(Z3, t, H);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// a standard-form affine point -> Montgomery Jacobian, Z = 0 where inf
static __device__ __forceinline__ void g1_load_affine(g1 &p, const int64_t *x, const int64_t *y,
                                                      bool inf) {
  fp a;
  fp_load(a, x);
  fp_to_mont(p.x, a);
  fp_load(a, y);
  fp_to_mont(p.y, a);
  if (inf)
    fp_set_zero(p.z);
  else
    fp_set_one(p.z);
}

static __device__ __forceinline__ void g1_store_words(uint32_t *dst, const g1 &p) {
#pragma unroll
  for (int k = 0; k < 12; k++) {
    dst[k] = p.x.v[k];
    dst[12 + k] = p.y.v[k];
    dst[24 + k] = p.z.v[k];
  }
}

static __device__ __forceinline__ void g1_load_words(g1 &p, const uint32_t *src) {
#pragma unroll
  for (int k = 0; k < 12; k++) {
    p.x.v[k] = src[k];
    p.y.v[k] = src[12 + k];
    p.z.v[k] = src[24 + k];
  }
}

// the sum of the block's points, in thread 0's acc: a halving tree in
// shared memory (T a power of two, every thread of the block calls it)
template <int T>
static __device__ __forceinline__ void block_sum(g1 &acc, g1 *sh) {
  sh[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll 1
  for (int s = T / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      g1 a = sh[threadIdx.x];
      g1_add(a, a, sh[threadIdx.x + s]);
      sh[threadIdx.x] = a;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) acc = sh[0];
}

__global__ void __launch_bounds__(MSM_THREADS)
    msm_precompute_kernel(const int64_t *px, const int64_t *py, const int32_t *inf, int n,
                          int64_t *tx, int64_t *ty, int64_t *tz) {
  const int i = blockIdx.x * MSM_THREADS + threadIdx.x;
  if (i >= n) return;
  g1 p;
  g1_load_affine(p, px + 24 * (size_t)i, py + 24 * (size_t)i, inf[i] != 0);
#pragma unroll 1
  for (int j = 0; j < N_CHUNKS; j++) {
    const size_t lane = (size_t)j * n + i;
    fp_store(tx + 24 * lane, p.x);
    fp_store(ty + 24 * lane, p.y);
    fp_store(tz + 24 * lane, p.z);
    if (j + 1 < N_CHUNKS) {
#pragma unroll 1
      for (int k = 0; k < CHUNK_BITS; k++) g1_dbl(p, p);
    }
  }
}

// one lane's 16-bit double-and-add, then the block's sum to partial
__global__ void __launch_bounds__(MSM_THREADS)
    msm_fixed_kernel(const int64_t *tx, const int64_t *ty, const int64_t *tz,
                     const int32_t *bits, int lanes, uint32_t *partial) {
  __shared__ g1 sh[MSM_THREADS];
  const int l = blockIdx.x * MSM_THREADS + threadIdx.x;
  g1 acc;
  g1_set_identity(acc);
  if (l < lanes) {
    g1 t;
    fp_load(t.x, tx + 24 * (size_t)l);
    fp_load(t.y, ty + 24 * (size_t)l);
    fp_load(t.z, tz + 24 * (size_t)l);
    const int32_t *b = bits + (size_t)l * CHUNK_BITS;
#pragma unroll 1
    for (int k = 0; k < CHUNK_BITS; k++) {
      // the identity's doubling is the identity (one, one, zero): skipped
      if (!fp_is_zero(acc.z)) g1_dbl(acc, acc);
      if (b[k]) g1_add(acc, acc, t);
    }
  }
  block_sum<MSM_THREADS>(acc, sh);
  if (threadIdx.x == 0) g1_store_words(partial + (size_t)blockIdx.x * G1_WORDS, acc);
}

// one point's scalar multiplication (window W > 0: a table of 2^W points
// built as j P = (j / 2) P + (j - j / 2) P, then per digit W doublings and
// an add; W = 0: per base-16 digit four doublings, each with an add of P
// on a set bit), then the block's sum to partial and the block's flag of a
// digit outside its table to bad; masked lanes give the identity
template <int W>
__global__ void __launch_bounds__(MSM_THREADS)
    msm_varying_kernel(const int64_t *px, const int64_t *py, const int32_t *mask,
                       const int32_t *digits, int n, int nd, uint32_t *partial, uint32_t *bad) {
  __shared__ g1 sh[MSM_THREADS];
  const int i = blockIdx.x * MSM_THREADS + threadIdx.x;
  const unsigned digit_end = W ? 1u << W : 16u;
  bool outside = false;
  g1 acc;
  g1_set_identity(acc);
  if (i < n && mask[i] != 0) {
    g1 p;
    g1_load_affine(p, px + 24 * (size_t)i, py + 24 * (size_t)i, false);
    const int32_t *d = digits + (size_t)i * nd;
    g1 table[W ? 1 << W : 1];
    if constexpr (W != 0) {
      g1_set_identity(table[0]);
      table[1] = p;
#pragma unroll 1
      for (int j = 2; j < (1 << W); j++) g1_add(table[j], table[j / 2], table[j - j / 2]);
    }
#pragma unroll 1
    for (int k = 0; k < nd && !outside; k++) {
      const int dk = d[k];
      if ((unsigned)dk >= digit_end) {
        outside = true;
      } else if constexpr (W == 0) {
#pragma unroll 1
        for (int b = 3; b >= 0; b--) {
          if (!fp_is_zero(acc.z)) g1_dbl(acc, acc);
          if ((dk >> b) & 1) g1_add(acc, acc, p);
        }
      } else {
#pragma unroll 1
        for (int b = 0; b < W; b++)
          if (!fp_is_zero(acc.z)) g1_dbl(acc, acc);
        if (dk) g1_add(acc, acc, table[dk]);
      }
    }
  }
  outside = __syncthreads_or(outside);
  block_sum<MSM_THREADS>(acc, sh);
  if (threadIdx.x == 0) {
    g1_store_words(partial + (size_t)blockIdx.x * G1_WORDS, acc);
    bad[blockIdx.x] = outside;
  }
}

// the sum of `count` block sums, then curve_ops.jac_to_affine (Z^-1 of 1
// for the identity, which keeps its X and Y) and the product by 1 out of
// Montgomery form; bad (null for msm_fixed) holds a flag per block sum,
// and any flag set gives x = y = 2^384 - 1 and no identity
__global__ void __launch_bounds__(FINISH_THREADS)
    msm_finish_kernel(const uint32_t *partial, const uint32_t *bad, int count, int64_t *x,
                      int64_t *y, int32_t *inf) {
  __shared__ g1 sh[FINISH_THREADS];
  g1 acc;
  g1_set_identity(acc);
  bool refused = false;
#pragma unroll 1
  for (int k = threadIdx.x; k < count; k += FINISH_THREADS) {
    g1 p;
    g1_load_words(p, partial + (size_t)k * G1_WORDS);
    g1_add(acc, acc, p);
    if (bad) refused |= bad[k] != 0;
  }
  refused = __syncthreads_or(refused);
  block_sum<FINISH_THREADS>(acc, sh);
  if (threadIdx.x != 0) return;
  if (refused) {
    for (int k = 0; k < 24; k++) x[k] = y[k] = 0xffff;
    inf[0] = 0;
    return;
  }
  const bool is_inf = fp_is_zero(acc.z);
  fp z = acc.z, zi, zi2, zi3, ax, ay, one;
  if (is_inf) fp_set_one(z);
  fp_inv(zi, z);
  fp_mul(zi2, zi, zi);
  fp_mul(zi3, zi2, zi);
  fp_mul(ax, acc.x, zi2);
  fp_mul(ay, acc.y, zi3);
  fp_set_zero(one);
  one.v[0] = 1;
  fp_mul(ax, ax, one);
  fp_mul(ay, ay, one);
  fp_store(x, ax);
  fp_store(y, ay);
  inf[0] = is_inf;
}

static int lane_blocks(long long lanes) { return (int)((lanes + MSM_THREADS - 1) / MSM_THREADS); }

// 32-bit words of the scratch for `lanes` lanes: the block sums, then a
// flag per block
extern "C" long long lh_msm_scratch_words(long long lanes) {
  return (long long)lane_blocks(lanes) * (G1_WORDS + 1);
}

extern "C" int lh_msm_precompute(const void *px, const void *py, const void *inf, int n,
                                 void *tx, void *ty, void *tz, void *stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  msm_precompute_kernel<<<lane_blocks(n), MSM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)px, (const int64_t *)py, (const int32_t *)inf, n, (int64_t *)tx,
      (int64_t *)ty, (int64_t *)tz);
  return (int)cudaGetLastError();
}

extern "C" int lh_msm_fixed(const void *tx, const void *ty, const void *tz, const void *bits,
                            int lanes, void *partial, void *x, void *y, void *inf,
                            void *stream) {
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = lane_blocks(lanes);
  cudaStream_t s = (cudaStream_t)stream;
  msm_fixed_kernel<<<blocks, MSM_THREADS, 0, s>>>((const int64_t *)tx, (const int64_t *)ty,
                                                  (const int64_t *)tz, (const int32_t *)bits,
                                                  lanes, (uint32_t *)partial);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  msm_finish_kernel<<<1, FINISH_THREADS, 0, s>>>((const uint32_t *)partial, nullptr, blocks,
                                                 (int64_t *)x, (int64_t *)y, (int32_t *)inf);
  return (int)cudaGetLastError();
}

extern "C" int lh_msm_varying(const void *px, const void *py, const void *mask,
                              const void *digits, int n, int nd, int w, void *partial, void *x,
                              void *y, void *inf, void *stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = lane_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *sums = (uint32_t *)partial, *bad = sums + (size_t)blocks * G1_WORDS;
  const int64_t *ax = (const int64_t *)px, *ay = (const int64_t *)py;
  const int32_t *m = (const int32_t *)mask, *d = (const int32_t *)digits;
  switch (w) {
    case 0: msm_varying_kernel<0><<<blocks, MSM_THREADS, 0, s>>>(ax, ay, m, d, n, nd, sums, bad); break;
    case 2: msm_varying_kernel<2><<<blocks, MSM_THREADS, 0, s>>>(ax, ay, m, d, n, nd, sums, bad); break;
    case 4: msm_varying_kernel<4><<<blocks, MSM_THREADS, 0, s>>>(ax, ay, m, d, n, nd, sums, bad); break;
    case 5: msm_varying_kernel<5><<<blocks, MSM_THREADS, 0, s>>>(ax, ay, m, d, n, nd, sums, bad); break;
    case 6: msm_varying_kernel<6><<<blocks, MSM_THREADS, 0, s>>>(ax, ay, m, d, n, nd, sums, bad); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  msm_finish_kernel<<<1, FINISH_THREADS, 0, s>>>(sums, bad, blocks, (int64_t *)x, (int64_t *)y,
                                                 (int32_t *)inf);
  return (int)cudaGetLastError();
}
