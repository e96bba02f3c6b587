// Batched Montgomery multiplication over Fq: a batch kernel bound by memory
// bandwidth, over tiles of consecutive elements staged in shared memory.
//
// The port's counterpart of the Mosaic lowering probes of
// scripts/probe_pallas.py (stage 0 at :49, stage 1 at :76, one mont_mul per
// lane), held against the plain limbs.mont_mul. With b == NULL the second
// factor is R^2 from __constant__ memory, so the product is the Montgomery
// conversion of a (limbs.to_mont). AggregateVerify launches it once, on the
// pubkeys and the signature (backend.aggregate_pairs); chip_smoke.py's field
// phase drives it at up to 2^22 elements.
//
// Bound: bytes. An element crosses the interface as 24 int64 limbs, 192 B,
// so a * b moves 3 x 192 B per product (2 x 192 B by R^2). At 2^20 products
// that is 0.180 ms at 3.35 TB/s (0.721 ms at 2^22); the 48 bytes an element
// holds would take 0.045 ms (0.180), and the ~600 integer multiply-adds of a
// product 0.038 ms (0.150) at 16.7 T/s.
//
// Design. A block owns a tile of TILE consecutive elements, one per thread,
// and walks over tiles with a grid sized to the card (SMs x resident blocks).
// A tile of an operand is one contiguous range of TILE x 192 B; the block
// reads it as 16-byte vectors, thread t taking vectors t, t + TILE, ..., so a
// warp reads 512 consecutive bytes. A vector holds limbs 2w, 2w + 1 of one
// element, i.e. its 32-bit word w, which goes to shared memory word-major:
// row w holds word w of the tile's elements, so thread i reads its element's
// words at a stride of one across the warp (rows padded to TILE + 2 words:
// the fill has at most two-way bank conflicts). Each thread runs fq.cuh's
// carry-chain fp_mul, writes its result words back over its own column of
// a's rows, and the block stores the tile as 16-byte vectors the same way it
// read it. Loads and stores stream past the caches (__ldcs, __stcs): every
// byte is touched once.
#include <stdint.h>

#include "fq.cuh"

namespace {

constexpr int TILE = 128;          // elements per tile = threads per block
constexpr int VECS = 12;           // 16-byte vectors per element (24 int64 limbs)
constexpr int STRIDE = TILE + 2;   // words from one row of a word-major tile to the next

// a vector's two int64 limbs (each below 2^16) <-> the 32-bit word they make
__device__ __forceinline__ uint32_t vec_word(uint4 q) { return q.x | (q.z << 16); }
__device__ __forceinline__ uint4 word_vec(uint32_t w) { return make_uint4(w & 0xFFFFu, 0, w >> 16, 0); }

template <bool HasB>
__device__ __forceinline__ void mont_mul_tiles(const uint4 *__restrict__ a, const uint4 *__restrict__ b,
                                               uint4 *__restrict__ out, long long n) {
  __shared__ uint32_t sa[VECS * STRIDE];
  __shared__ uint32_t sb[HasB ? VECS * STRIDE : 1];
  const long long tiles = (n + TILE - 1) / TILE;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long first = t * TILE;
    const int count = n - first < TILE ? (int)(n - first) : TILE;   // the last tile may be partial
    const int vecs = count * VECS;
    const uint4 *ta = a + first * VECS;
    const uint4 *tb = HasB ? b + first * VECS : nullptr;
    // every load of the tile in flight before the first is used
    uint4 qa[VECS], qb[VECS];
#pragma unroll
    for (int k = 0; k < VECS; k++) {
      const int v = k * TILE + threadIdx.x;
      if (v < vecs) {
        qa[k] = __ldcs(ta + v);
        if (HasB) qb[k] = __ldcs(tb + v);
      }
    }
#pragma unroll
    for (int k = 0; k < VECS; k++) {
      const int v = k * TILE + threadIdx.x;
      if (v < vecs) {
        const int e = v / VECS, w = v - e * VECS;
        sa[w * STRIDE + e] = vec_word(qa[k]);
        if (HasB) sb[w * STRIDE + e] = vec_word(qb[k]);
      }
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i < count) {
      fp x, y, r;
#pragma unroll
      for (int k = 0; k < 12; k++) {
        x.v[k] = sa[k * STRIDE + i];
        y.v[k] = HasB ? sb[k * STRIDE + i] : FP_R2[k];
      }
      fp_mul(r, x, y);
#pragma unroll
      for (int k = 0; k < 12; k++) sa[k * STRIDE + i] = r.v[k];   // column i is this thread's alone
    }
    __syncthreads();
    uint4 *to = out + first * VECS;
#pragma unroll
    for (int k = 0; k < VECS; k++) {
      const int v = k * TILE + threadIdx.x;
      if (v < vecs) {
        const int e = v / VECS, w = v - e * VECS;
        __stcs(to + v, word_vec(sa[w * STRIDE + e]));
      }
    }
    __syncthreads();   // the next tile's fill overwrites sa
  }
}

}  // namespace

__global__ void __launch_bounds__(TILE) fq_mont_mul_kernel(const uint4 *a, const uint4 *b, uint4 *out,
                                                           long long n) {
  mont_mul_tiles<true>(a, b, out, n);
}

__global__ void __launch_bounds__(TILE) fq_to_mont_kernel(const uint4 *a, uint4 *out, long long n) {
  mont_mul_tiles<false>(a, nullptr, out, n);
}

// blocks of `kernel` one SM holds at once, asked once per process
static int resident_blocks(const void *kernel) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TILE, 0);
  return blocks > 0 ? blocks : 1;
}

// out[i] = a[i] * b[i] * R^-1 mod p over n elements of 24 int64 limbs (by
// R^2 where b is NULL). Every pointer must be 16-byte aligned: the kernel
// reads and writes 16-byte vectors, and a misaligned pointer is refused with
// cudaErrorMisalignedAddress, nothing launched.
extern "C" int lh_fq_mont_mul(const void *a, const void *b, void *out, long long n, void *stream) {
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) return (int)cudaErrorMisalignedAddress;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  static const int per_sm_ab = resident_blocks((const void *)fq_mont_mul_kernel);
  static const int per_sm_r2 = resident_blocks((const void *)fq_to_mont_kernel);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + TILE - 1) / TILE;
  const long long resident = (long long)sms * (b ? per_sm_ab : per_sm_r2);
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  cudaStream_t s = (cudaStream_t)stream;
  if (b) {
    fq_mont_mul_kernel<<<grid, TILE, 0, s>>>((const uint4 *)a, (const uint4 *)b, (uint4 *)out, n);
  } else {
    fq_to_mont_kernel<<<grid, TILE, 0, s>>>((const uint4 *)a, (uint4 *)out, n);
  }
  return (int)cudaGetLastError();
}
