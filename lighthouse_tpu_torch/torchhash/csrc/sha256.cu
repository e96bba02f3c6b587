// SHA-256 merkle ladder and multi-block digests for Hopper (sm_90a).
//
// Replaces lighthouse_tpu/jaxhash/engine.py:159 _make_ladder (the XLA
// merkle ladder, with compress_rolled at :132) and engine.py:364
// sha256_msgs_device. The plain versions are torchhash/kernels.py's
// sha256_ladder_plain and sha256_msgs_plain.
//
// sha256_level_kernel: one thread per parent node, one launch per level.
// A parent is SHA-256 of its two 32-byte children, two compressions: the
// 64-byte message, then the fixed pad block, whose message schedule is the
// same for every node and is computed on the host (PAD_KW holds it added to
// K, so a pad round adds one constant). Words stay in uint32_t registers
// (the 16-word schedule window too: the rounds are unrolled, so every index
// is a constant); rotates are __funnelshift_r. The words arrive as the
// big-endian words of the hashed bytes: the host swaps the bytes
// (torchhash/engine.py), so the kernel never does. A level with an odd
// width pairs its last node with ZERO_HASH_W[level], the root of an
// all-zero subtree of that height, so a width that is not a power of two
// gives the prefixes of its zero-padded tree. Every level is written into
// one buffer that the wrapper allocates, in level order.
//
// What bounds it: 32-bit integer instructions. A node is two compressions
// (~2,300 instructions with Hopper's three-input LOP3 and IADD3) for 64
// bytes read and 32 written, far above the card's ~5 instructions per byte
// of HBM. The first redesign (levels fused in shared memory, fewer launches)
// waits for a benchmark.
//
// sha256_msgs_kernel: one thread per message, looping over its padded
// 64-byte blocks with the same compression.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_consts.cuh"

#define LEVEL_THREADS 256

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

// one round; kw is K[t] + W[t]
__device__ __forceinline__ void sha_round(uint32_t v[8], uint32_t kw) {
    const uint32_t e = v[4], a = v[0];
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & v[5]) ^ (~e & v[6]);
    const uint32_t t1 = v[7] + s1 + ch + kw;
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
    v[7] = v[6];
    v[6] = v[5];
    v[5] = e;
    v[4] = v[3] + t1;
    v[3] = v[2];
    v[2] = v[1];
    v[1] = a;
    v[0] = t1 + s0 + maj;
}

// one compression of the 16 message words w (overwritten by the schedule)
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = st[j];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        if (t >= 16) {
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        sha_round(v, SHA_K[t] + w[t & 15]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] += v[j];
}

// the compression of the fixed pad block of a 64-byte message
__device__ __forceinline__ void compress_pad(uint32_t st[8]) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = st[j];
#pragma unroll
    for (int t = 0; t < 64; ++t) sha_round(v, PAD_KW[t]);
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] += v[j];
}

__global__ void __launch_bounds__(LEVEL_THREADS)
sha256_level_kernel(const uint32_t* __restrict__ in, int64_t n_in, uint32_t* __restrict__ out,
                    int64_t n_out, int level) {
    const int64_t i = (int64_t)blockIdx.x * LEVEL_THREADS + threadIdx.x;
    if (i >= n_out) return;
    uint32_t w[16];
    const uint4* src = reinterpret_cast<const uint4*>(in + 16 * i);
    const uint4 l0 = src[0], l1 = src[1];
    w[0] = l0.x; w[1] = l0.y; w[2] = l0.z; w[3] = l0.w;
    w[4] = l1.x; w[5] = l1.y; w[6] = l1.z; w[7] = l1.w;
    if (2 * i + 1 < n_in) {
        const uint4 r0 = src[2], r1 = src[3];
        w[8] = r0.x;  w[9] = r0.y;  w[10] = r0.z; w[11] = r0.w;
        w[12] = r1.x; w[13] = r1.y; w[14] = r1.z; w[15] = r1.w;
    } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[8 + j] = ZERO_HASH_W[level][j];
    }
    uint32_t st[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] = SHA_H0[j];
    compress(st, w);
    compress_pad(st);
    uint4* dst = reinterpret_cast<uint4*>(out + 8 * i);
    dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
    dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

__global__ void __launch_bounds__(LEVEL_THREADS)
sha256_msgs_kernel(const uint32_t* __restrict__ words, int64_t n, int blocks,
                   uint32_t* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * LEVEL_THREADS + threadIdx.x;
    if (i >= n) return;
    const uint4* msg = reinterpret_cast<const uint4*>(words + 16 * blocks * i);
    uint32_t st[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] = SHA_H0[j];
    for (int b = 0; b < blocks; ++b) {
        uint32_t w[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint4 x = msg[4 * b + q];
            w[4 * q] = x.x; w[4 * q + 1] = x.y; w[4 * q + 2] = x.z; w[4 * q + 3] = x.w;
        }
        compress(st, w);
    }
    uint4* dst = reinterpret_cast<uint4*>(out + 8 * i);
    dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
    dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

static unsigned grid_for(int64_t n) {
    return (unsigned)((n + LEVEL_THREADS - 1) / LEVEL_THREADS);
}

// The levels above n nodes (n, 8 words each, 16-byte aligned) into out:
// ceil(n / 2) nodes, then ceil of that halved, ..., 1 node.
extern "C" int lh_sha256_ladder(const uint32_t* leaves, int64_t n, uint32_t* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* in = leaves;
    int level = 0;
    while (n > 1) {
        if (level >= 64) return (int)cudaErrorInvalidValue;
        const int64_t m = (n + 1) / 2;
        sha256_level_kernel<<<grid_for(m), LEVEL_THREADS, 0, s>>>(in, n, out, m, level);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        in = out;
        out += 8 * m;
        n = m;
        ++level;
    }
    return 0;
}

// SHA-256 of n messages of `blocks` padded 64-byte blocks each (16 words a
// block, 16-byte aligned) into out (8 words each).
extern "C" int lh_sha256_msgs(const uint32_t* words, int64_t n, int blocks, uint32_t* out,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    sha256_msgs_kernel<<<grid_for(n), LEVEL_THREADS, 0, s>>>(words, n, blocks, out);
    return (int)cudaGetLastError();
}
