// product_latency: what one dependent Fq product and one team level cost on
// the card, for chip_smoke.py's product_latency phase. No path launches
// these kernels; they time chains of Montgomery products:
//   variant 0  one thread, a chain of dependent products with the CIOS
//              product on 64-bit emulated carries (fp_mul_cios64 below, the
//              port's fp_mul and final subtraction before the carry chains
//              of fq.cuh);
//   variant 1  the same chain through fq.cuh's fp_mul (PTX carry chains);
//   variant 2  one warp, 32 independent chains of fp_mul (throughput);
//   variant 3  one team level of team.cuh's design, iterated: each of 16
//              lanes multiplies its slot by its neighbour's, writes the
//              product to shared memory, __syncwarp, and the next level
//              reads the products back (two buffers, so no level reads a
//              slot it writes).
//   variant 4  iters G2 doublings through team.cuh's interpreter (the
//              TG2 dbl programs, 3 product levels and an output pass each,
//              from area A to B and back) by a 32-lane team, out of line
//              as the kernels call it (team_run);
//   variant 5  variant 4 with rounds.cuh's cycle hook stamping clock64():
//              lane 0's cycles in the operand forms' loads and sums, in
//              their reductions, in fp_mul, in the slot stores and in the
//              passes' __syncwarp, then its cycles in all.
// Variants 0 to 4 write their chains' last values, for the caller to hold
// against the plain chains. lh_inverse inverts n elements, a thread each,
// iters times in a chain (x <- x^-1): variant 0 by the Fermat chain below,
// the port's fp_inv before fq.cuh's binary GCD, variant 1 by that GCD (the
// fp_inv of the path kernels). This file builds into a library of its own
// (kernels.latency_library), apart from the kernels of the paths.
#include "team.cuh"

// the final subtraction of that product, on 64-bit emulated borrows
static __device__ __forceinline__ void fp_reduce_once64(fp &r, const uint32_t *t, uint32_t top) {
  uint32_t d[12];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    uint64_t s = (uint64_t)t[i] - FP_P[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  bool ge = top != 0 || borrow == 0;   // t >= p
#pragma unroll
  for (int i = 0; i < 12; i++) r.v[i] = ge ? d[i] : t[i];
}

// the CIOS product with 64-bit products and a serial carry per row
static __device__ __forceinline__ void fp_mul_cios64(fp &r, const fp &a, const fp &b) {
  uint32_t t[13];
#pragma unroll
  for (int j = 0; j < 13; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; j++) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[12] + c;
    t[12] = (uint32_t)s;
    uint32_t t13 = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FP_INV;
    s = (uint64_t)m * FP_P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 12; j++) {
      s = (uint64_t)m * FP_P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[12] + c;
    t[11] = (uint32_t)s;
    t[12] = t13 + (uint32_t)(s >> 32);
  }
  fp_reduce_once64(r, t, t[12]);
}

// a^(p-2) = a^-1 (0 maps to 0): square-and-multiply over the bits of
// p - 2, 381 squarings and 229 products in one dependent chain
static __device__ __noinline__ void fp_inv_fermat(fp &r, const fp &a) {
  fp acc;
  fp_set_one(acc);
  for (int i = 380; i >= 0; i--) {
    fp_sqr(acc, acc);
    const uint32_t w = FP_P[i >> 5] - (i < 32 ? 2u : 0u);   // p - 2 (p is odd: no borrow)
    if ((w >> (i & 31)) & 1u) fp_mul(acc, acc, a);
  }
  r = acc;
}

// x <- x * y, iters times, from x[lane] and y[lane]
template <int V>
__global__ void latency_chain(const int64_t *xs, const int64_t *ys, int64_t *out, int iters) {
  const int lane = threadIdx.x;
  fp x, y;
  fp_load(x, xs + 24 * lane);
  fp_load(y, ys + 24 * lane);
  for (int k = 0; k < iters; k++) {
    if (V == 0)
      fp_mul_cios64(x, x, y);
    else
      fp_mul(x, x, y);
  }
  fp_store(out + 24 * lane, x);
}

#define LAT_TEAM 16

__global__ void latency_team(const int64_t *xs, int64_t *out, int iters) {
  __shared__ fp S[2][LAT_TEAM];
  const int lane = threadIdx.x;
  fp x, y, r;
  fp_load(x, xs + 24 * lane);
  S[0][lane] = x;
  __syncwarp();
  int cur = 0;
  for (int k = 0; k < iters; k++) {
    x = S[cur][lane];
    y = S[cur][(lane + 1) % LAT_TEAM];
    fp_mul(r, x, y);
    S[cur ^ 1][lane] = r;
    __syncwarp();
    cur ^= 1;
  }
  fp_store(out + 24 * lane, S[cur][lane]);
}

// rounds.cuh's cycle hook with clock64() stamps: each lane books its
// intervals to c[part]; a mark re-reads the clock after its own update, so
// the bookkeeping falls outside every interval
struct clock_split {
  long long *c;
  long long t;
  __device__ __forceinline__ void begin() { t = clock64(); }
  __device__ __forceinline__ void mark(int part) {
    const long long now = clock64();
    c[part] += now - t;
    t = clock64();
  }
};

// the G2 point xs[0..6) doubled iters times through team_run, as the
// kernels call it; SPLIT also writes lane 0's cycles per part to out[0..5)
// and its cycles in all to out[5]
template <bool SPLIT>
__global__ void latency_program(const int64_t *xs, int64_t *out, int iters) {
  __shared__ TG2_tables T;
  __shared__ __align__(16) fp S[TG2_SLOTS];
  const int lane = threadIdx.x;
  const team tm{lane, 32, 0xFFFFFFFFu};
  T.stage(lane, 32);
  if (lane < 6) {
    fp c;
    fp_load(c, xs + 24 * lane);
    slot_store(S, lane, c);
  }
  __syncwarp();
  long long cycles[SPLIT_N] = {};
  const long long start = clock64();
  int a = 0;
  for (int k = 0; k < iters; k++) {
    const int prog = a ? TG2_DBL_BA : TG2_DBL_AB;
    const uint32_t *ops = T.ops + TG2_PROG_OPS[prog];
    const uint16_t *pass = T.pass + TG2_PROG_PASS[prog], *forms = T.forms + TG2_PROG_FORMS[prog];
    if constexpr (SPLIT)
      team_run(S, ops, pass, TG2_PROG_NPASSES[prog], forms, T.terms, tm, clock_split{cycles, 0});
    else
      team_run(S, ops, pass, TG2_PROG_NPASSES[prog], forms, T.terms, tm);
    a ^= 1;
  }
  if constexpr (SPLIT) {
    if (lane == 0) {
      for (int part = 0; part < SPLIT_N; part++) out[part] = cycles[part];
      out[SPLIT_N] = clock64() - start;
    }
    return;
  }
  if (lane < 6) {
    fp c;
    slot_load(c, S, 6 * a + lane);
    fp_store(out + 24 * lane, c);
  }
}

// x <- x^-1, iters times, for the n elements of xs, a thread each
template <bool FERMAT>
__global__ void inverse_chain(const int64_t *xs, int64_t *out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp x;
  fp_load(x, xs + 24 * i);
  for (int k = 0; k < iters; k++) {
    if (FERMAT)
      fp_inv_fermat(x, x);
    else
      fp_inv(x, x);
  }
  fp_store(out + 24 * i, x);
}

extern "C" int lh_inverse(int variant, int n, int iters, const void *xs, void *out,
                          void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t *x = (const int64_t *)xs;
  int64_t *o = (int64_t *)out;
  const int blocks = (n + 31) / 32;
  switch (variant) {
    case 0: inverse_chain<true><<<blocks, 32, 0, st>>>(x, o, n, iters); break;
    case 1: inverse_chain<false><<<blocks, 32, 0, st>>>(x, o, n, iters); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// xs, ys: 32 elements each (int64 limbs); out: 32 elements
extern "C" int lh_product_latency(int variant, int iters, const void *xs, const void *ys, void *out,
                                  void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t *x = (const int64_t *)xs, *y = (const int64_t *)ys;
  int64_t *o = (int64_t *)out;
  switch (variant) {
    case 0: latency_chain<0><<<1, 1, 0, st>>>(x, y, o, iters); break;
    case 1: latency_chain<1><<<1, 1, 0, st>>>(x, y, o, iters); break;
    case 2: latency_chain<1><<<1, 32, 0, st>>>(x, y, o, iters); break;
    case 3: latency_team<<<1, LAT_TEAM, 0, st>>>(x, o, iters); break;
    case 4: latency_program<false><<<1, 32, 0, st>>>(x, o, iters); break;
    case 5: latency_program<true><<<1, 32, 0, st>>>(x, o, iters); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
