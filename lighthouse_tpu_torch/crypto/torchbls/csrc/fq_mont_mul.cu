// Batched Montgomery multiplication over Fq, one thread per element.
//
// The port's counterpart of the Mosaic lowering probes of
// scripts/probe_pallas.py (stage 0 at :49, stage 1 at :76, one mont_mul per
// lane): the first thing chip_smoke.py checks on the card, against the
// plain limbs.mont_mul. With b == NULL the second factor is R^2 from
// __constant__ memory, so the product is the Montgomery conversion of a
// (limbs.to_mont), the conversion h2c.cu applies to its inputs. No driven
// path launches this kernel; chip_smoke.py's field phase holds it. Bound:
// integer multiply-adds (~300 per product), not bytes (one 48-byte element
// read per operand, one written).
#include "fq.cuh"

__global__ void fq_mont_mul_kernel(const int64_t *a, const int64_t *b, int64_t *out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp x, y, r;
  fp_load(x, a + 24 * i);
  if (b) {
    fp_load(y, b + 24 * i);
  } else {
#pragma unroll
    for (int k = 0; k < 12; k++) y.v[k] = FP_R2[k];
  }
  fp_mul(r, x, y);
  fp_store(out + 24 * i, r);
}

extern "C" int lh_fq_mont_mul(const void *a, const void *b, void *out, long long n, void *stream) {
  if (n > 0) {
    unsigned blocks = (unsigned)((n + 127) / 128);
    fq_mont_mul_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (const int64_t *)a, (const int64_t *)b, (int64_t *)out, n);
  }
  return (int)cudaGetLastError();
}
