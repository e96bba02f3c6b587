// Product rounds: Fq arithmetic spread over the threads of one block.
//
// A program is straight-line Fq code traced by torchbls/rounds.py from the
// tower formulas and emitted into the generated round_programs.cuh as
// operation words, kind << 30 | out << 20 | a << 10 | b, over slots of one
// Fq element (48 bytes) in shared memory, cut into passes by offsets. Each
// pass runs with one operation per thread (a loop where a pass is wider
// than the block) and a block barrier after it. A pass of products is a
// "round": independent Montgomery products, each held in one thread's
// registers by the inlined fp_mul, so no call frame and no local memory.
// In a slot program (run_program, miller.cu) a and b are slots, and linear
// passes between the rounds form the sums and differences (x xi, x 3, x 8
// and negation among them) and the final copies into the state. In a form
// program (run_form_program, hard_part.cu) a and b index forms, short sums
// of slots with small integer coefficients that the reading thread
// evaluates (form_load): a product multiplies two forms, a COPY writes one,
// so the sums between rounds take no pass of their own.
#pragma once
#include "fq.cuh"
#include "round_programs.cuh"

#define RND_MUL 0u
#define RND_ADD 1u
#define RND_SUB 2u
#define RND_COPY 3u

// slots are 16-byte aligned in shared memory: three 16-byte words each
static __device__ __forceinline__ void slot_load(fp &r, const fp *S, uint32_t k) {
  const uint4 *p = reinterpret_cast<const uint4 *>(S + k);
  const uint4 a = p[0], b = p[1], c = p[2];
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  r.v[8] = c.x; r.v[9] = c.y; r.v[10] = c.z; r.v[11] = c.w;
}

static __device__ __forceinline__ void slot_store(fp *S, uint32_t k, const fp &x) {
  uint4 *p = reinterpret_cast<uint4 *>(S + k);
  p[0] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  p[1] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
  p[2] = make_uint4(x.v[8], x.v[9], x.v[10], x.v[11]);
}

// Form f of a form program: the terms T[F[f]], T[F[f] + 1], ... up to the
// one flagged RND_TERM_LAST, each slot | flag | (int16) coefficient << 16;
// its value sum_i c_i S[slot_i] mod p, fully reduced. The sum is taken in
// signed 64-bit limbs, lifted by n p (n the negative coefficients' sizes)
// to v in [0, RND_FORM_BOUND p), and reduced by q = floor(v / p) or one
// less from v's top bits (rounds.FORM_RECIP), then at most one p.
#define RND_TERM_LAST 0x8000u

static __device__ __forceinline__ void form_load(fp &r, const fp *S, const uint16_t *F,
                                                 const uint32_t *T, uint32_t f) {
  uint32_t k = F[f], e = T[k];
  if ((e & 0xFFFF8000u) == (0x10000u | RND_TERM_LAST)) {  // one slot, coefficient 1
    slot_load(r, S, e & 1023u);
    return;
  }
  int64_t acc[12];
#pragma unroll
  for (int j = 0; j < 12; j++) acc[j] = 0;
  int32_t n = 0;
  for (;;) {
    e = T[k++];
    const int32_t c = (int32_t)e >> 16;
    fp x;
    slot_load(x, S, e & 1023u);
#pragma unroll
    for (int j = 0; j < 12; j++) acc[j] += (int64_t)c * x.v[j];
    n += c < 0 ? -c : 0;
    if (e & RND_TERM_LAST) break;
  }
  uint32_t v[13];
  int64_t carry = 0;
#pragma unroll
  for (int j = 0; j < 12; j++) {  // the running carry may be negative below the top
    carry += acc[j] + (int64_t)n * FP_P[j];
    v[j] = (uint32_t)carry;
    carry >>= 32;
  }
  v[12] = (uint32_t)carry;
  const uint64_t hi = ((uint64_t)v[12] << 54) | ((uint64_t)v[11] << 22) | (v[10] >> 10);
  const uint32_t q = (uint32_t)__umul64hi(hi, RND_FORM_RECIP);
  uint64_t m = 0;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 12; j++) {  // v -= q p
    m += (uint64_t)q * FP_P[j];
    const uint64_t s = (uint64_t)v[j] - (uint32_t)m - borrow;
    v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
    m >>= 32;
  }
  v[12] -= (uint32_t)m + borrow;
  fp_reduce_once(r, v, v[12]);
}

template <bool FORMS>
static __device__ __forceinline__ void round_op(fp *S, uint32_t w, const uint16_t *F,
                                                const uint32_t *T) {
  const uint32_t kind = w >> 30, o = (w >> 20) & 1023u, a = (w >> 10) & 1023u, b = w & 1023u;
  fp x, y, r;
  if constexpr (FORMS) {  // a product of two forms, or (COPY) a form's value
    form_load(x, S, F, T, a);
    if (kind == RND_MUL) {
      form_load(y, S, F, T, b);
      fp_mul(r, x, y);
      slot_store(S, o, r);
    } else {
      slot_store(S, o, x);
    }
    return;
  }
  slot_load(x, S, a);
  if (kind == RND_COPY) {
    slot_store(S, o, x);
    return;
  }
  slot_load(y, S, b);
  if (kind == RND_MUL)
    fp_mul(r, x, y);
  else if (kind == RND_ADD)
    fp_add(r, x, y);
  else
    fp_sub(r, x, y);
  slot_store(S, o, r);
}

template <bool FORMS>
static __device__ __forceinline__ void run_passes(fp *S, const uint32_t *ops, const uint16_t *pass,
                                                  int npasses, const uint16_t *F,
                                                  const uint32_t *T) {
  for (int p = 0; p < npasses; p++) {
    const int end = pass[p + 1];
    for (int k = pass[p] + threadIdx.x; k < end; k += blockDim.x)
      round_op<FORMS>(S, ops[k], F, T);
    __syncthreads();
  }
}

// ops and pass offsets in shared memory (copied by stage_program)
static __device__ __forceinline__ void run_program(fp *S, const uint32_t *ops,
                                                   const uint16_t *pass, int npasses) {
  run_passes<false>(S, ops, pass, npasses, nullptr, nullptr);
}

// a form program: its ops, pass offsets and forms, and the terms, all in
// shared memory
static __device__ __forceinline__ void run_form_program(fp *S, const uint32_t *ops,
                                                        const uint16_t *pass, int npasses,
                                                        const uint16_t *forms,
                                                        const uint32_t *terms) {
  run_passes<true>(S, ops, pass, npasses, forms, terms);
}

// copy a table from constant to shared memory (no barrier)
template <typename W>
static __device__ __forceinline__ void stage_table(W *dst, const W *src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

// copy a program's tables from constant to shared memory (no barrier)
static __device__ __forceinline__ void stage_program(uint32_t *ops, const uint32_t *ops_c, int nops,
                                                     uint16_t *pass, const uint16_t *pass_c,
                                                     int npasses) {
  stage_table(ops, ops_c, nops);
  stage_table(pass, pass_c, npasses + 1);
}
