// stage_pairs: stage 3 of batched verification on the card.
//
// Replaces the Pallas kernel _pairs_kernel
// (lighthouse_tpu/crypto/jaxbls/pallas_ops.py:557, wrapper stage_pairs_fused
// :599), the fused form of backend._batched_affine: inversion of the 2n+1 Z
// coordinates (n G1 aggregates embedded in Fq2, n hashed messages, the
// signature accumulator), affine coordinates, infinity flags and the pair
// mask. The (-G1, sum z*sig) row append stays in the wrapper, as it did.
//
// Bound on this card: one lane's dependent chain, its Fq inversion (fq.cuh's
// binary GCD, ~38k integer instructions in one thread) and ~15 Fq
// products; bytes are ~100 KB. Each Z lane is one thread with its own
// inversion (the TPU shared one batched chain across lanes instead), so
// the 2n+1 chains run side by side, a warp of 32 lanes in step: the GCD
// has no branch, and a G1 lane runs as an Fq2 element with a zero
// imaginary part through the same code as the G2 lanes, so no warp runs
// two branches (at n = 4 all 9 lanes share one warp). The results are exact
// and fully reduced, so an Fq2 product by (x, 0) gives the Fq product's
// bits. No size gate (see prepare.cu).
#include "tower.cuh"

#define PAIRS_THREADS 32

__global__ void __launch_bounds__(PAIRS_THREADS)
    pairs_kernel(const int64_t *zx, const int64_t *zy, const int64_t *zz, const int64_t *hx,
                 const int64_t *hy, const int64_t *hz, const int64_t *sx_in,
                 const int64_t *sy_in, const int64_t *sz_in, const int32_t *set_mask, int n,
                 int64_t *px, int64_t *py, int64_t *qx, int64_t *qy, int32_t *pm, int64_t *sx,
                 int64_t *sy, int32_t *sinf) {
  const int i = blockIdx.x * PAIRS_THREADS + threadIdx.x;
  if (i > 2 * n) return;
  const bool g1 = i < n, sig = i == 2 * n;
  const size_t j = g1 ? i : sig ? 0 : i - n;
  fp2 z, x, y;
  if (g1) {
    fp_load(z.c0, zz + 24 * j);
    fp_load(x.c0, zx + 24 * j);
    fp_load(y.c0, zy + 24 * j);
    fp_set_zero(z.c1);
    fp_set_zero(x.c1);
    fp_set_zero(y.c1);
  } else {
    fp2_load(z, (sig ? sz_in : hz) + 48 * j);
    fp2_load(x, (sig ? sx_in : hx) + 48 * j);
    fp2_load(y, (sig ? sy_in : hy) + 48 * j);
  }
  fp2 zi, zi2, zi3;
  fp2_inv(zi, z);
  fp2_sqr(zi2, zi);
  fp2_mul(zi3, zi2, zi);
  fp2_mul(x, x, zi2);
  fp2_mul(y, y, zi3);
  if (g1) {
    fp_store(px + 24 * j, x.c0);
    fp_store(py + 24 * j, y.c0);
    fp2 h;
    fp2_load(h, hz + 48 * j);
    pm[j] = set_mask[j] != 0 && !(fp2_is_zero(z) || fp2_is_zero(h));
  } else {
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
  pairs_kernel<<<(lanes + PAIRS_THREADS - 1) / PAIRS_THREADS, PAIRS_THREADS, 0,
                 (cudaStream_t)stream>>>(
      (const int64_t *)zx, (const int64_t *)zy, (const int64_t *)zz, (const int64_t *)hx,
      (const int64_t *)hy, (const int64_t *)hz, (const int64_t *)sx_in, (const int64_t *)sy_in,
      (const int64_t *)sz_in, (const int32_t *)set_mask, n, (int64_t *)px, (int64_t *)py,
      (int64_t *)qx, (int64_t *)qy, (int32_t *)pm, (int64_t *)sx, (int64_t *)sy,
      (int32_t *)sinf);
  return (int)cudaGetLastError();
}
