// The altair epoch deltas for Hopper (sm_90a).
//
// Replaces lighthouse_tpu/jaxhash/epoch_vectors.py:149 _device_epoch_kernel
// (XLA, uint64 under enable_x64). The plain version is torchhash/kernels.py's
// epoch_deltas_plain.
//
// One thread per validator computes all seven outputs in uint64_t, with the
// reference's arithmetic in its order: base = (eff / incr) * base_per_incr;
// per flag f the reward base * weight_f * flag_incr_f / (total_incr * 64)
// where the validator took part, is eligible and the chain is not leaking,
// and the penalty base * weight_f / 64 where it is eligible and did not take
// part (0 for the head flag); the inactivity penalty eff * score / denom
// where it is eligible and missed the target. Products wrap mod 2^64 as the
// reference's do (its pre-check keeps them below 2^64); quotients are floor
// divisions by the runtime scalars, which the compiler emulates in software.
//
// What bounds it: bytes. Each validator reads 16 bytes and 5 flags and
// writes 56 bytes; its ~10 64-bit products and 7 divisions stay below the
// integer rate that those bytes allow.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_consts.cuh"

#define EPOCH_THREADS 256

static_assert(N_FLAGS == 3, "one flag_incr argument per participation flag");

__global__ void __launch_bounds__(EPOCH_THREADS)
epoch_deltas_kernel(const uint64_t* __restrict__ eff, const uint8_t* __restrict__ part,
                    const uint8_t* __restrict__ eligible, const uint8_t* __restrict__ target,
                    const uint64_t* __restrict__ scores, int64_t n, uint64_t base_per_incr,
                    uint64_t incr, uint64_t flag_incr0, uint64_t flag_incr1,
                    uint64_t flag_incr2, uint64_t total_incr, uint64_t denom, int leaking,
                    uint64_t* __restrict__ rewards, uint64_t* __restrict__ penalties,
                    uint64_t* __restrict__ inactivity) {
    const int64_t i = (int64_t)blockIdx.x * EPOCH_THREADS + threadIdx.x;
    if (i >= n) return;
    const uint64_t flag_incr[N_FLAGS] = {flag_incr0, flag_incr1, flag_incr2};
    const uint64_t e = eff[i];
    const bool el = eligible[i] != 0;
    const uint64_t base = (e / incr) * base_per_incr;
    const uint64_t reward_denom = total_incr * WEIGHT_DENOMINATOR;
#pragma unroll
    for (int f = 0; f < N_FLAGS; ++f) {
        const bool p = part[f * n + i] != 0;
        rewards[f * n + i] =
            (p && el && !leaking) ? base * FLAG_WEIGHT[f] * flag_incr[f] / reward_denom : 0;
        penalties[f * n + i] =
            (f != HEAD_FLAG && el && !p) ? base * FLAG_WEIGHT[f] / WEIGHT_DENOMINATOR : 0;
    }
    inactivity[i] = (el && target[i] == 0) ? e * scores[i] / denom : 0;
}

extern "C" int lh_epoch_deltas(const uint64_t* eff, const uint8_t* part, const uint8_t* eligible,
                               const uint8_t* target, const uint64_t* scores, int64_t n,
                               uint64_t base_per_incr, uint64_t incr, uint64_t flag_incr0,
                               uint64_t flag_incr1, uint64_t flag_incr2, uint64_t total_incr,
                               uint64_t denom, int leaking, uint64_t* rewards,
                               uint64_t* penalties, uint64_t* inactivity, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = (unsigned)((n + EPOCH_THREADS - 1) / EPOCH_THREADS);
    epoch_deltas_kernel<<<grid, EPOCH_THREADS, 0, s>>>(
        eff, part, eligible, target, scores, n, base_per_incr, incr, flag_incr0, flag_incr1,
        flag_incr2, total_incr, denom, leaking, rewards, penalties, inactivity);
    return (int)cudaGetLastError();
}
