// final_exp_easy_part: the easy part of the final exponentiation on the card.
//
// Replaces the easy part of pairing_ops.final_exponentiation
// (lighthouse_tpu/crypto/jaxbls/pairing_ops.py:296), which the JAX package
// kept in XLA outside its fused hard-part kernel (pallas_ops.py:336): on the
// Miller value m, t = conj(m) * m^-1 = m^(p^6 - 1), then
// frob^2(t) * t = m^((p^6 - 1)(p^2 + 1)).
//
// Bound on this card: one dependent chain, the Fq12 inversion's norm chain
// down to Fq, one Fq inversion (fq.cuh's binary GCD, ~38k integer
// instructions in one thread) and the way back up; bytes are 576 in, 576
// out. One block of 64 threads runs it on the hard part's round machinery
// (rounds.cuh): the form program EP_NORM (rounds.easy_programs, traced from
// tower.fq12_inv's, fq6_inv's and fq2_inv's formulas) takes m down to the
// Fq norm in 4 product rounds, one thread inverts the norm behind a block
// barrier, and EP_UP takes its inverse back up to m^-1, conj(m) m^-1, its
// p^2-Frobenius and the last product in 6 rounds. It is a launch of its
// own, so that each stage keeps its own time. An inverse is unique and every
// result is exact and fully reduced, so it equals the plain version's bits;
// tests/test_torch_rounds.py runs the same tables against it.
#include "round_programs.cuh"
#include "rounds.cuh"

#define EASY_THREADS 64

__global__ void __launch_bounds__(EASY_THREADS) easy_part_kernel(const int64_t *m_in, int64_t *out) {
  __shared__ __align__(16) fp S[EP_SLOTS];
  __shared__ uint32_t ops[EP_NOPS], terms[EP_NTERMS];
  __shared__ uint16_t pass[EP_NPASS], forms[EP_NFORMS];
  const int t = threadIdx.x;
  stage_table(ops, EP_OPS, EP_NOPS);
  stage_table(pass, EP_PASS, EP_NPASS);
  stage_table(forms, EP_FORMS, EP_NFORMS);
  stage_table(terms, EP_TERMS, EP_NTERMS);
  // the state the programs read first: m and the p^2-Frobenius coefficients
  for (int k = t; k < 24; k += EASY_THREADS) {
    fp c;
    if (k < 12) {
      fp_load(c, m_in + 24 * k);
    } else {
#pragma unroll
      for (int l = 0; l < 12; l++) c.v[l] = FROB2[(k - 12) / 2][k % 2][l];
    }
    slot_store(S, k < 12 ? EP_SLOT_M + k : EP_SLOT_FROB2 + k - 12, c);
  }
  __syncthreads();
  run_form_program(S, ops + EP_PROG_OPS[EP_NORM], pass + EP_PROG_PASS[EP_NORM],
                   EP_PROG_NPASSES[EP_NORM], forms + EP_PROG_FORMS[EP_NORM], terms);
  if (t == 0) {
    fp n;
    slot_load(n, S, EP_SLOT_NORM);
    fp_inv(n, n);
    slot_store(S, EP_SLOT_NINV, n);
  }
  __syncthreads();
  run_form_program(S, ops + EP_PROG_OPS[EP_UP], pass + EP_PROG_PASS[EP_UP],
                   EP_PROG_NPASSES[EP_UP], forms + EP_PROG_FORMS[EP_UP], terms);
  if (t < 12) {
    fp c;
    slot_load(c, S, EP_SLOT_OUT + t);
    fp_store(out + 24 * t, c);
  }
}

extern "C" int lh_final_exp_easy_part(const void *m, void *out, void *stream) {
  easy_part_kernel<<<1, EASY_THREADS, 0, (cudaStream_t)stream>>>((const int64_t *)m,
                                                                 (int64_t *)out);
  return (int)cudaGetLastError();
}
