// stage_pairs: stage 3 of batched verification on the card.
//
// Replaces the Pallas kernel _pairs_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:557, wrapper stage_pairs_fused
// :599), the fused form of backend._batched_affine: inversion of the 2n+1 Z
// coordinates (n G1 aggregates embedded in Fq2, n hashed messages, the
// signature accumulator), affine coordinates, infinity flags and the pair
// mask. The (-G1, sum z*sig) row append stays in the wrapper, as it did.
//
// Bound on this card: integer multiply-adds of the Fermat inversions
// (~570 Fq products each, one dependent chain); bytes are ~100 KB. The
// simple design gives each Z element its own thread and its own Fq2
// inversion (the TPU shared one batched chain across lanes instead), so
// the 2n+1 chains run side by side. No size gate (see prepare.cu).
#include "tower.cuh"

__global__ void pairs_kernel(const int64_t *zx, const int64_t *zy, const int64_t *zz,
                             const int64_t *hx, const int64_t *hy, const int64_t *hz,
                             const int64_t *sx_in, const int64_t *sy_in, const int64_t *sz_in,
                             const int32_t *set_mask, int n, int64_t *px, int64_t *py,
                             int64_t *qx, int64_t *qy, int32_t *pm, int64_t *sx, int64_t *sy,
                             int32_t *sinf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    // G1 lane: Z embedded in Fq2 with a zero imaginary part
    fp2 z, zi, zi2, zi3;
    fp_load(z.c0, zz + 24 * i);
    fp_set_zero(z.c1);
    fp2_inv(zi, z);
    fp2_sqr(zi2, zi);
    fp2_mul(zi3, zi2, zi);
    fp x, y;
    fp_load(x, zx + 24 * i);
    fp_load(y, zy + 24 * i);
    fp_mul(x, x, zi2.c0);
    fp_mul(y, y, zi3.c0);
    fp_store(px + 24 * i, x);
    fp_store(py + 24 * i, y);
    fp2 h;
    fp2_load(h, hz + 48 * i);
    pm[i] = set_mask[i] != 0 && !(fp_is_zero(z.c0) || fp2_is_zero(h));
  } else if (i <= 2 * n) {
    const bool sig = i == 2 * n;
    const size_t j = sig ? 0 : (size_t)(i - n);
    fp2 z, zi, zi2, zi3, x, y;
    fp2_load(z, (sig ? sz_in : hz) + 48 * j);
    fp2_inv(zi, z);
    fp2_sqr(zi2, zi);
    fp2_mul(zi3, zi2, zi);
    fp2_load(x, (sig ? sx_in : hx) + 48 * j);
    fp2_load(y, (sig ? sy_in : hy) + 48 * j);
    fp2_mul(x, x, zi2);
    fp2_mul(y, y, zi3);
    fp2_store((sig ? sx : qx) + 48 * j, x);
    fp2_store((sig ? sy : qy) + 48 * j, y);
    if (sig) sinf[0] = fp2_is_zero(z);
  }
}

extern "C" int lh_stage_pairs(const void *zx, const void *zy, const void *zz, const void *hx,
                              const void *hy, const void *hz, const void *sx_in,
                              const void *sy_in, const void *sz_in, const void *set_mask, int n,
                              void *px, void *py, void *qx, void *qy, void *pm, void *sx,
                              void *sy, void *sinf, void *stream) {
  const int lanes = 2 * n + 1;
  pairs_kernel<<<(lanes + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int64_t *)zx, (const int64_t *)zy, (const int64_t *)zz, (const int64_t *)hx,
      (const int64_t *)hy, (const int64_t *)hz, (const int64_t *)sx_in, (const int64_t *)sy_in,
      (const int64_t *)sz_in, (const int32_t *)set_mask, n, (int64_t *)px, (int64_t *)py,
      (int64_t *)qx, (int64_t *)qy, (int32_t *)pm, (int64_t *)sx, (int64_t *)sy,
      (int32_t *)sinf);
  return (int)cudaGetLastError();
}
