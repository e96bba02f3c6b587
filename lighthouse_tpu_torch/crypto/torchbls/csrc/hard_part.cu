// final_exp_hard_part: the hard part of the final exponentiation on the card.
//
// Replaces the Pallas kernel _hard_part_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:292, wrapper
// final_exp_hard_part_fused :323): on an easy-part output t, five
// |x|-exponentiation chains of Granger-Scott cyclotomic squarings and the
// Frobenius/conjugate wiring of pallas_ops.py:312-320 (the HHT chain of the
// cubed pairing). The easy part, with its one Fq12 inversion, runs before
// it as a kernel of its own (easy_part.cu); final_exponentiation_fused kept
// it in XLA.
//
// Bound on this card: one dependent chain of ~340 cyclotomic squarings and
// ~40 Fq12 products (~10^4 Fq products), not bytes (576 in, 576 out). The
// chain is sequential, so the simple design runs it in one thread; sharing
// each Fq12 product across a warp is later work.
#include "tower.cuh"

// a^x for cyclotomic a (x < 0): squarings over the bits of |x| after the
// leading one, a multiply on each set bit, a final conjugate
static __device__ __noinline__ void exp_neg_x(fp12 &r, const fp12 &a) {
  fp12 acc = a;
  for (int b = 62; b >= 0; b--) {
    fp12_cyclotomic_sqr(acc, acc);
    if ((X_ABS >> b) & 1ull) fp12_mul(acc, acc, a);
  }
  fp12_conj(r, acc);
}

__global__ void hard_part_kernel(const int64_t *t_in, int64_t *out) {
  fp12 t, y0, y1, y2, y3, x, c;
  fp12_load(t, t_in);
  exp_neg_x(y0, t);                 // y0 = t^x * conj(t)
  fp12_conj(c, t);
  fp12_mul(y0, y0, c);
  exp_neg_x(y1, y0);                // y1 = y0^x * conj(y0)
  fp12_conj(c, y0);
  fp12_mul(y1, y1, c);
  exp_neg_x(y2, y1);                // y2 = y1^x * frob(y1, 1)
  fp12_frobenius(c, y1, 1);
  fp12_mul(y2, y2, c);
  exp_neg_x(y3, y2);                // y3 = (y2^x)^x * frob(y2, 2) * conj(y2)
  exp_neg_x(y3, y3);
  fp12_frobenius(c, y2, 2);
  fp12_mul(y3, y3, c);
  fp12_conj(c, y2);
  fp12_mul(y3, y3, c);
  fp12_mul(x, t, t);                // t^3
  fp12_mul(x, x, t);
  fp12_mul(y3, y3, x);
  fp12_store(out, y3);
}

extern "C" int lh_final_exp_hard_part(const void *t, void *out, void *stream) {
  hard_part_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int64_t *)t, (int64_t *)out);
  return (int)cudaGetLastError();
}
