// final_exp_easy_part: the easy part of the final exponentiation on the card.
//
// Replaces the easy part of pairing_ops.final_exponentiation
// (lighthouse_tpu/crypto/jaxbls/pairing_ops.py:296), which the JAX package
// kept in XLA outside its fused hard-part kernel (pallas_ops.py:336): on the
// Miller value m, t = conj(m) * m^-1 = m^(p^6 - 1), then
// frob^2(t) * t = m^((p^6 - 1)(p^2 + 1)).
//
// Bound on this card: one dependent chain of ~1000 Fq products (the Fq12
// inversion reduces to one Fermat inversion in Fq, 381 squarings), not
// bytes (576 in, 576 out). The simple design runs it in one thread, as
// hard_part.cu does; it is a launch of its own so that each stage keeps its
// own time. An inverse is unique, so any correct formula agrees with the
// plain version bit for bit.
#include "tower.cuh"

__global__ void easy_part_kernel(const int64_t *m_in, int64_t *out) {
  fp12 m, t, c;
  fp12_load(m, m_in);
  fp12_inv(t, m);
  fp12_conj(c, m);
  fp12_mul(t, c, t);                // m^(p^6 - 1)
  fp12_frobenius(c, t, 2);
  fp12_mul(t, c, t);                // ^(p^2 + 1)
  fp12_store(out, t);
}

extern "C" int lh_final_exp_easy_part(const void *m, void *out, void *stream) {
  easy_part_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int64_t *)m, (int64_t *)out);
  return (int)cudaGetLastError();
}
