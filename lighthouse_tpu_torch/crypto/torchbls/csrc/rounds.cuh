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
// program (run_form_program, hard_part.cu and easy_part.cu) a and b index
// forms, short sums of slots with small integer coefficients that the
// reading thread evaluates (form_load): a product multiplies two forms, a
// COPY writes one, so the sums between rounds take no pass of their own. The kernels include
// the generated tables they run (round_programs.cuh, team_programs.cuh)
// themselves; form_load's RND_FORM_RECIP comes with bls_consts.cuh.
#pragma once
#include "fq.cuh"

#define RND_MUL 0u
#define RND_ADD 1u
#define RND_SUB 2u
#define RND_COPY 3u

// A cycle hook of round_op and team.cuh's team_run: begin() starts an
// interval, mark(i) ends it and books it to part i. The kernels pass
// no_split, whose calls are empty; latency.cu's split stamps clock64() at
// them to share a level's cycles among the operand forms' loads and sums
// (SPLIT_TERMS) and reductions (SPLIT_REDUCE), the product, the slot store
// and the team's sync.
enum { SPLIT_TERMS, SPLIT_REDUCE, SPLIT_MUL, SPLIT_STORE, SPLIT_SYNC, SPLIT_N };

struct no_split {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
};

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
// its value sum_i c_i S[slot_i] mod p. form_terms sums |c_i| times each
// word of the slot, complemented (2^32 - 1 - w) where c_i < 0, in unsigned
// 64-bit limbs (one multiply-add per limb; n is the sum of the negative
// coefficients' sizes), so the form's value plus n p is
// v = sum_j (acc_j + n (p_j - 2^32 + 1)) 2^(32 j), in [0, RND_FORM_BOUND p).
// form_reduce takes v to 13 words (the limbs' low words plus their signed
// high words one word up, on carry chains), subtracts q p for
// q = floor(v / p) or one less from v's top bits (rounds.FORM_RECIP), and
// then, for a fully reduced value, at most one p. A product's second
// operand may stay below 2p (fq.cuh's fp_mul takes any b < 2^384), so it
// skips that last subtraction. A form that is one slot with coefficient 1
// is that slot's value.
#define RND_TERM_LAST 0x8000u

// true when the form is one slot with coefficient 1 (acc then holds it)
static __device__ __forceinline__ bool form_terms(uint64_t *acc, int32_t &n, const fp *S,
                                                  const uint16_t *F, const uint32_t *T,
                                                  uint32_t f) {
  uint32_t k = F[f], e = T[k];
  n = 0;
  if ((e & 0xFFFF8000u) == (0x10000u | RND_TERM_LAST)) {
    fp x;
    slot_load(x, S, e & 1023u);
#pragma unroll
    for (int j = 0; j < 12; j++) acc[j] = x.v[j];
    return true;
  }
#pragma unroll
  for (int j = 0; j < 12; j++) acc[j] = 0;
  for (;;) {
    e = T[k++];
    const int32_t c = (int32_t)e >> 16;
    const uint32_t m = c < 0 ? 0xFFFFFFFFu : 0u, cu = c < 0 ? -c : c;
    fp x;
    slot_load(x, S, e & 1023u);
#pragma unroll
    for (int j = 0; j < 12; j++) acc[j] += (uint64_t)cu * (x.v[j] ^ m);
    n += c < 0 ? -c : 0;
    if (e & RND_TERM_LAST) break;
  }
  return false;
}

template <bool FULL>
static __device__ __forceinline__ void form_reduce(fp &r, const uint64_t *acc, int32_t n) {
  // v = sum_j s_j 2^(32 j), s_j = acc_j + n (p_j - 2^32 + 1) signed: the
  // low words, plus the high words (two's complement) one word up, minus
  // 2^(32 (j + 2)) for each negative s_j, all mod 2^416 (v < 2^391)
  uint32_t L[12], H[12], B[12], v[13];
#pragma unroll
  for (int j = 0; j < 12; j++) {
    const int64_t s = (int64_t)acc[j] + (int64_t)n * ((int64_t)FP_P[j] - 0xFFFFFFFFll);
    L[j] = (uint32_t)s;
    H[j] = (uint32_t)((uint64_t)s >> 32);
    B[j] = s < 0 ? 1u : 0u;
  }
  v[0] = L[0];
  v[1] = add_cc(L[1], H[0]);
#pragma unroll
  for (int j = 2; j < 12; j++) v[j] = addc_cc(L[j], H[j - 1]);
  v[12] = addc(H[11], 0);
  v[2] = sub_cc(v[2], B[0]);
#pragma unroll
  for (int j = 3; j < 12; j++) v[j] = subc_cc(v[j], B[j - 2]);
  v[12] = subc(v[12], B[10]);
  const uint64_t hi = ((uint64_t)v[12] << 54) | ((uint64_t)v[11] << 22) | (v[10] >> 10);
  const uint32_t q = (uint32_t)__umul64hi(hi, RND_FORM_RECIP);
  // v -= q p: the low words of q p_j, then the high words one word up
  uint32_t lo[12], hq[12];
#pragma unroll
  for (int j = 0; j < 12; j++) {
    lo[j] = q * FP_P[j];
    hq[j] = __umulhi(q, FP_P[j]);
  }
  v[0] = sub_cc(v[0], lo[0]);
#pragma unroll
  for (int j = 1; j < 12; j++) v[j] = subc_cc(v[j], lo[j]);
  v[12] = subc(v[12], 0);
  v[1] = sub_cc(v[1], hq[0]);
#pragma unroll
  for (int j = 2; j < 12; j++) v[j] = subc_cc(v[j], hq[j - 1]);
  if (FULL) {
    v[12] = subc(v[12], hq[11]);
    fp_reduce_once(r, v, v[12]);
  } else {                       // v < 2p < 2^382: the top word is zero
#pragma unroll
    for (int j = 0; j < 12; j++) r.v[j] = v[j];
  }
}

template <class Split>
static __device__ __forceinline__ void form_load(fp &r, const fp *S, const uint16_t *F,
                                                 const uint32_t *T, uint32_t f, Split &sp) {
  uint64_t acc[12];
  int32_t n;
  const bool direct = form_terms(acc, n, S, F, T, f);
  sp.mark(SPLIT_TERMS);
  if (direct) {
#pragma unroll
    for (int j = 0; j < 12; j++) r.v[j] = (uint32_t)acc[j];
  } else {
    form_reduce<true>(r, acc, n);
  }
  sp.mark(SPLIT_REDUCE);
}

// both operands of a product: x fully reduced, y below 2p
template <class Split>
static __device__ __forceinline__ void form_load2(fp &x, fp &y, const fp *S, const uint16_t *F,
                                                  const uint32_t *T, uint32_t a, uint32_t b,
                                                  Split &sp) {
  uint64_t ax[12], ay[12];
  int32_t nx, ny;
  const bool dx = form_terms(ax, nx, S, F, T, a);
  const bool dy = form_terms(ay, ny, S, F, T, b);
  sp.mark(SPLIT_TERMS);
  if (dx) {
#pragma unroll
    for (int j = 0; j < 12; j++) x.v[j] = (uint32_t)ax[j];
  } else {
    form_reduce<true>(x, ax, nx);
  }
  if (dy) {
#pragma unroll
    for (int j = 0; j < 12; j++) y.v[j] = (uint32_t)ay[j];
  } else {
    form_reduce<false>(y, ay, ny);
  }
  sp.mark(SPLIT_REDUCE);
}

template <bool FORMS, class Split = no_split>
static __device__ __forceinline__ void round_op(fp *S, uint32_t w, const uint16_t *F,
                                                const uint32_t *T, Split sp = Split()) {
  const uint32_t kind = w >> 30, o = (w >> 20) & 1023u, a = (w >> 10) & 1023u, b = w & 1023u;
  fp x, y, r;
  if constexpr (FORMS) {  // a product of two forms, or (COPY) a form's value
    sp.begin();
    if (kind == RND_MUL) {
      form_load2(x, y, S, F, T, a, b, sp);
      fp_mul(r, x, y);
      sp.mark(SPLIT_MUL);
      slot_store(S, o, r);
    } else {
      form_load(x, S, F, T, a, sp);
      slot_store(S, o, x);
    }
    sp.mark(SPLIT_STORE);
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
