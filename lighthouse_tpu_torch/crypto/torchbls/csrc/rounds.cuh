// Product rounds: Fq arithmetic spread over the threads of one block.
//
// A program is straight-line Fq code traced by torchbls/rounds.py from the
// tower formulas and emitted into a generated header as operation words,
// kind << 30 | out << 20 | a << 10 | b, over slots of one Fq element
// (48 bytes) in shared memory, cut into passes by offsets. run_program runs
// each pass with one operation per thread (a loop where a pass is wider
// than the block) and a block barrier after it. A pass of products is a
// "round": independent Montgomery products, each held in one thread's
// registers by the inlined fp_mul, so no call frame and no local memory;
// the linear passes between rounds form the sums and differences (x xi,
// x 3, x 8 and negation among them) and the final copies into the state.
// Programs and the slot layout come from the generated miller_rounds.cuh.
#pragma once
#include "fq.cuh"

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

static __device__ __forceinline__ void round_op(fp *S, uint32_t w) {
  const uint32_t kind = w >> 30, o = (w >> 20) & 1023u, a = (w >> 10) & 1023u, b = w & 1023u;
  fp x, y, r;
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

// ops and pass offsets in shared memory (copied by stage_program)
static __device__ __forceinline__ void run_program(fp *S, const uint32_t *ops,
                                                   const uint16_t *pass, int npasses) {
  for (int p = 0; p < npasses; p++) {
    const int end = pass[p + 1];
    for (int k = pass[p] + threadIdx.x; k < end; k += blockDim.x) round_op(S, ops[k]);
    __syncthreads();
  }
}

// copy a program's tables from constant to shared memory (no barrier)
static __device__ __forceinline__ void stage_program(uint32_t *ops, const uint32_t *ops_c, int nops,
                                                     uint16_t *pass, const uint16_t *pass_c,
                                                     int npasses) {
  for (int k = threadIdx.x; k < nops; k += blockDim.x) ops[k] = ops_c[k];
  for (int k = threadIdx.x; k <= npasses; k += blockDim.x) pass[k] = pass_c[k];
}
