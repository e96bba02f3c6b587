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
// Bound on this card: one dependent chain of 5 x 68 Fq12 squarings and
// products (~7.5k Fq products), not bytes (576 in, 576 out). One block of
// 64 threads runs it as product rounds (rounds.cuh) over Fq slots in shared
// memory: a cyclotomic squaring is one round of its 18 Fq products, a
// product by the chain's base one round of 54, and every sum between the
// rounds is folded into the forms the threads of the next pass read
// (rounds.FormProgram), so a step is two passes, its round and the pass
// that writes the new accumulator. Squarings and products alternate between
// two accumulator areas, so there is no copy pass. The links between the
// chains (y0, y1, y2, the Frobenius maps, t^3 and the last product) are
// form programs too. The order of the programs, 345 of them, 347 product
// rounds and 692 passes in all, is the generated table HP_SEQ
// (rounds.hard_sequence); tests/test_torch_rounds.py runs the same tables
// against the plain hard part. Products are exact and fully reduced, so
// the result equals the plain version's bits; the squaring follows
// tower.fq12_cyclotomic_sqr term for term, as it equals a^2 only in the
// cyclotomic subgroup.
#include "round_programs.cuh"
#include "rounds.cuh"

#define HARD_THREADS 64
static_assert(HP_AREA_T == 0 && HP_AREA_B == 12 && HP_AREA_A0 == 24 && HP_AREA_FROB1 == 72 &&
                  HP_AREA_FROB2 == 84 && HP_STATE_SLOTS == 96,
              "hard_part.cu loads the state in rounds.HARD_AREAS' order");

__global__ void __launch_bounds__(HARD_THREADS) hard_part_kernel(const int64_t *t_in, int64_t *out) {
  __shared__ __align__(16) fp S[HP_SLOTS];
  __shared__ uint32_t ops[HP_NOPS], terms[HP_NTERMS];
  __shared__ uint16_t pass[HP_NPASS], forms[HP_NFORMS];
  const int t = threadIdx.x;
  stage_table(ops, HP_OPS, HP_NOPS);
  stage_table(pass, HP_PASS, HP_NPASS);
  stage_table(forms, HP_FORMS, HP_NFORMS);
  stage_table(terms, HP_TERMS, HP_NTERMS);
  // the state: t in the areas t, b and a0 (the first chain's base and
  // accumulator), the Frobenius coefficient blocks, zero elsewhere
  for (int k = t; k < HP_STATE_SLOTS; k += HARD_THREADS) {
    const int area = k - k % 12, i = k % 12;
    fp c;
    if (area <= HP_AREA_A0) {
      fp_load(c, t_in + 24 * i);
    } else if (area == HP_AREA_FROB1 || area == HP_AREA_FROB2) {
#pragma unroll
      for (int l = 0; l < 12; l++)
        c.v[l] = area == HP_AREA_FROB1 ? FROB1[i / 2][i % 2][l] : FROB2[i / 2][i % 2][l];
    } else {
      fp_set_zero(c);
    }
    slot_store(S, k, c);
  }
  __syncthreads();
  for (int s = 0; s < HP_SEQ_LEN; s++) {
    const int p = HP_SEQ[s];
    run_form_program(S, ops + HP_PROG_OPS[p], pass + HP_PROG_PASS[p], HP_PROG_NPASSES[p],
                     forms + HP_PROG_FORMS[p], terms);
  }
  if (t < 12) {
    fp c;
    slot_load(c, S, HP_OUT + t);
    fp_store(out + 24 * t, c);
  }
}

extern "C" int lh_final_exp_hard_part(const void *t, void *out, void *stream) {
  hard_part_kernel<<<1, HARD_THREADS, 0, (cudaStream_t)stream>>>((const int64_t *)t,
                                                                 (int64_t *)out);
  return (int)cudaGetLastError();
}
