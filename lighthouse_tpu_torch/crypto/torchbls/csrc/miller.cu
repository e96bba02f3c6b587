// miller_loop_product and miller_loop_batch: the multi-Miller loop on the
// card, as per-pair chains of product rounds and one product tree.
//
// Replaces the Pallas kernel _miller_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:229, wrapper
// miller_loop_product_fused :271), the fused form of
// pairing_ops.miller_loop_product: over P = n_sets + 1 affine pairs with a
// validity mask, per bit of |x| after the leading 1 (63 bits, MSB first) one
// Fq12 squaring of the shared f, one doubling step and tangent line per
// pair, the product of all lines folded into f, and on the five 1-bits an
// addition step and its lines likewise; at the end f is conjugated (x < 0).
//
// Bound on this card: chains of dependent Fq products, not bytes (a few KB
// in and out). The shared accumulator is one chain of ~34k products; here
// phase 1 gives every pair its own f_i (pairing_ops.miller_loop_batch: per
// bit f_i^2 times the pair's own line through the sparse 014 product), one
// block of 64 threads per pair, and spreads each step over the threads as
// product rounds (rounds.cuh): the doubling step is 4 rounds (f_i^2 with
// X^2, Y^2, Z^2, YZ; then C, (X+B)^2, E^2, EX, E ZZ, Z3 ZZ; then
// E (D - X3) and the two products by xp and yp; then the 13 Fq2 products
// of the sparse line product), the addition step 5, so the chain is ~277
// rounds of about one Fq product each. The state (xp, yp, xq, yq, R, f_i)
// and every intermediate stay in shared memory. Phase 2 multiplies the P
// values in a tree of dense Fq12 products (one round of 54 products each),
// one launch per level, one block per product, the last level writing the
// result. kernels.miller_loop_product calls lh_miller_loop_batch, then
// lh_miller_tree on its output. Conjugation is a ring
// automorphism and Fq12 products are exact, so prod_i conj(f_i) equals the
// shared-accumulator value bit for bit, in any tree order; the point
// formulas and line scalings are pairing_ops' term for term (rounds.py).
// Masked pairs give f_i = 1, as the identity lines of the shared form do.
// No size gate (see prepare.cu).
#include "round_programs.cuh"
#include "rounds.cuh"

#define MILLER_THREADS 64
#define MILLER_SLOTS (MR_DBL_SLOTS > MR_ADD_SLOTS ? MR_DBL_SLOTS : MR_ADD_SLOTS)
static_assert(MR_SLOT_XP == 0 && MR_SLOT_YQ1 == 5 && MR_SLOT_X0 == 6 && MR_SLOT_Z0 == 10 &&
                  MR_SLOT_F0 == 12 && MR_SLOT_ZERO == 24,
              "miller.cu loads the state in rounds.MILLER_STATE's order");

// Phase 1: block i runs pair i; out[i] = conj(f_i), or 1 for a masked pair.
__global__ void __launch_bounds__(MILLER_THREADS)
    miller_batch_kernel(const int64_t *xp_in, const int64_t *yp_in, const int64_t *xq_in,
                        const int64_t *yq_in, const int32_t *mask, int64_t *out) {
  __shared__ __align__(16) fp S[MILLER_SLOTS];
  __shared__ uint32_t dbl_ops[MR_DBL_NOPS], add_ops[MR_ADD_NOPS];
  __shared__ uint16_t dbl_pass[MR_DBL_PASSES + 1], add_pass[MR_ADD_PASSES + 1];
  const int i = blockIdx.x, t = threadIdx.x;
  int64_t *o = out + 288 * i;
  if (!mask[i]) {
    if (t < 12) {
      fp c;
      if (t == 0)
        fp_set_one(c);
      else
        fp_set_zero(c);
      fp_store(o + 24 * t, c);
    }
    return;
  }
  stage_program(dbl_ops, MR_DBL_OPS, MR_DBL_NOPS, dbl_pass, MR_DBL_PASS, MR_DBL_PASSES);
  stage_program(add_ops, MR_ADD_OPS, MR_ADD_NOPS, add_pass, MR_ADD_PASS, MR_ADD_PASSES);
  // the state: xp, yp, xq, yq, R = (xq, yq, 1), f = 1, the zero slot
  if (t <= MR_SLOT_ZERO) {
    fp c;
    if (t == MR_SLOT_XP)
      fp_load(c, xp_in + 24 * i);
    else if (t == MR_SLOT_YP)
      fp_load(c, yp_in + 24 * i);
    else if (t < MR_SLOT_X0 + 4) {  // xq0 xq1 yq0 yq1, then X = xq, Y = yq
      const int k = (t - 2) & 3;
      fp_load(c, (k < 2 ? xq_in : yq_in) + 48 * i + 24 * (k & 1));
    } else if (t == MR_SLOT_Z0 || t == MR_SLOT_F0)
      fp_set_one(c);
    else
      fp_set_zero(c);
    slot_store(S, t, c);
  }
  __syncthreads();
  for (int b = 62; b >= 0; b--) {
    run_program(S, dbl_ops, dbl_pass, MR_DBL_PASSES);
    if ((X_ABS >> b) & 1ull) run_program(S, add_ops, add_pass, MR_ADD_PASSES);
  }
  if (t < 12) {  // conj(f): the w-half negated
    fp c;
    slot_load(c, S, MR_SLOT_F0 + t);
    if (t >= 6) fp_neg(c, c);
    fp_store(o + 24 * t, c);
  }
}

// Phase 2, one tree level over n values: block j < n / 2 sets
// dst[j] = v[j] * v[j + m], m = ceil(n / 2); an odd straggler v[n / 2] stays.
// dst is v (in place: block j reads only v[j] and v[j + m], and j < m) or,
// on the last level, the output.
__global__ void __launch_bounds__(MILLER_THREADS)
    tree_level_kernel(const int64_t *v, int m, int64_t *dst) {
  __shared__ __align__(16) fp S[MR_FQ12_MUL_SLOTS];
  __shared__ uint32_t ops[MR_FQ12_MUL_NOPS];
  __shared__ uint16_t pass[MR_FQ12_MUL_PASSES + 1];
  const int j = blockIdx.x, t = threadIdx.x;
  stage_program(ops, MR_FQ12_MUL_OPS, MR_FQ12_MUL_NOPS, pass, MR_FQ12_MUL_PASS,
                MR_FQ12_MUL_PASSES);
  if (t <= 24) {  // a = v[j], b = v[j + m], the zero slot
    fp c;
    if (t < 24)
      fp_load(c, v + 288 * (t < 12 ? j : j + m) + 24 * (t % 12));
    else
      fp_set_zero(c);
    slot_store(S, t, c);
  }
  __syncthreads();
  run_program(S, ops, pass, MR_FQ12_MUL_PASSES);
  if (t < 12) {
    fp c;
    slot_load(c, S, MR_FQ12_MUL_OUT[t]);
    fp_store(dst + 288 * j + 24 * t, c);
  }
}

extern "C" int lh_miller_loop_batch(const void *xp, const void *yp, const void *xq,
                                    const void *yq, const void *mask, int P, void *out,
                                    void *stream) {
  miller_batch_kernel<<<P, MILLER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)xp, (const int64_t *)yp, (const int64_t *)xq, (const int64_t *)yq,
      (const int32_t *)mask, (int64_t *)out);
  return (int)cudaGetLastError();
}

// The product of P >= 2 per-pair values (P, 2, 3, 2, 24) into out: the
// levels run in place over values (which they overwrite), the last one
// writes out.
extern "C" int lh_miller_tree(void *values, int P, void *out, void *stream) {
  int64_t *v = (int64_t *)values;
  int err = 0;
  for (int n = P; err == 0 && n > 1; n -= n / 2) {
    tree_level_kernel<<<n / 2, MILLER_THREADS, 0, (cudaStream_t)stream>>>(
        v, n - n / 2, n == 2 ? (int64_t *)out : v);
    err = (int)cudaGetLastError();
  }
  return err;
}
