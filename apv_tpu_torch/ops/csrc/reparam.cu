// Reparameterized Gaussian sampling with the noise drawn inside the kernel.
//
// Replaces apv_tpu/ops/kernels.py::_reparam_fwd (Pallas kernel
// _reparam_kernel, which draws from the TPU's hardware PRNG). For S samples
// of a [n]-element posterior (n = B * Z):
//     z[s, i] = mean[i] + exp(logvar[i] / 2) * eps[s, i],  eps ~ N(0, 1)
//
// The noise comes from a counter-based Philox4x32-10 (Salmon et al., SC'11),
// written out here: thread q encrypts the counter (q_lo, q_hi, offset_lo,
// offset_hi) under the key (seed_lo, seed_hi) and turns the four 32-bit
// words into four normals by Box-Muller, for output elements 4q .. 4q+3.
// The wrapper draws (seed, offset) from the caller's torch.Generator, so a
// fixed generator seed gives a fixed z and successive calls differ. The
// plain PyTorch version in ops/kernels.py computes the same stream.
//
// Bound on an H100: launch latency. The IWAE chunk [25, 64, 128] writes
// 0.82 MB, ~0.25 us at 3.35 TB/s, well under one launch; mean and logvar
// ([B, Z], 65.5 KB) are read once from memory and then from cache for each
// sample, instead of being broadcast to [S, B, Z] in memory first.
//
// Backward: replaces apv_tpu/ops/kernels.py::_reparam_bwd with
// _unbroadcast, the custom_vjp rule written in jnp. With g the incoming
// gradient [S, n] and z the forward's output [S, n]:
//     dmean[i]   = sum_s g[s, i]
//     dlogvar[i] = sum_s 0.5 * g[s, i] * (z[s, i] - mean[i])
// (dz/dlogvar = 0.5 * sigma * eps = 0.5 * (z - mean)), summed over the
// sample axis as _unbroadcast sums the broadcast one. Bound: memory, read g
// and z once and write two [n] vectors; the train step's S = 1, n = 10240
// moves 164 KB, launch-bound. Design: one thread per i walks s in order, so
// each step of the walk is one coalesced row of g and z across the block,
// no atomics are needed and the result is deterministic. The products and
// sums use __fmul_rn/__fadd_rn so that nvcc does not contract them into an
// FMA: each term rounds as the plain version's separate multiply and add.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
    constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
    constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
    for (int round = 0; round < 10; ++round) {
        const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
        const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += kW0;
        k.y += kW1;
    }
    return c;
}

// 23 random bits -> a uniform in (0, 1), computed exactly in float32:
// (m + 0.5) * 2^-23 for m < 2^23, never 0 or 1.
__device__ __forceinline__ float uniform_open(uint32_t bits) {
    return (static_cast<float>(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

// Box-Muller: (u1, u2) -> two independent normals. u1 is clamped away from
// 0 as in the Pallas kernel (uniform_open already keeps it >= 2^-24).
__device__ __forceinline__ float2 box_muller(uint32_t b1, uint32_t b2) {
    const float u1 = fmaxf(uniform_open(b1), 1e-12f);
    const float u2 = uniform_open(b2);
    const float r = sqrtf(-2.0f * logf(u1));
    const float theta = 6.2831855f * u2;
    return make_float2(r * cosf(theta), r * sinf(theta));
}

__global__ void __launch_bounds__(kThreads)
reparam_samples(const float* __restrict__ mean, const float* __restrict__ logvar,
                float* __restrict__ z, int64_t n, int64_t total,
                uint64_t seed, uint64_t offset) {
    const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t base = 4 * q;
    if (base >= total) return;
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   static_cast<uint32_t>(offset), static_cast<uint32_t>(offset >> 32)),
        make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)));
    const float2 n01 = box_muller(bits.x, bits.y);
    const float2 n23 = box_muller(bits.z, bits.w);
    const float eps[4] = {n01.x, n01.y, n23.x, n23.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int64_t e = base + j;
        if (e < total) {
            const int64_t i = e % n;
            z[e] = mean[i] + expf(0.5f * logvar[i]) * eps[j];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
reparam_bwd_sum(const float* __restrict__ g, const float* __restrict__ z,
                const float* __restrict__ mean, float* __restrict__ dmean,
                float* __restrict__ dlogvar, int64_t samples, int64_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    const float m = mean[i];
    float dm = 0.0f, dlv = 0.0f;
    for (int64_t s = 0; s < samples; ++s) {
        const float gv = g[s * n + i];
        dm = __fadd_rn(dm, gv);
        dlv = __fadd_rn(dlv, __fmul_rn(__fmul_rn(gv, 0.5f), __fadd_rn(z[s * n + i], -m)));
    }
    dmean[i] = dm;
    dlogvar[i] = dlv;
}

}  // namespace

extern "C" int apv_reparam(const float* mean, const float* logvar, float* z,
                           int64_t samples, int64_t n, uint64_t seed,
                           uint64_t offset, void* stream) {
    const int64_t total = samples * n;
    if (total <= 0) return 0;
    const int64_t quads = (total + 3) / 4;
    const int64_t blocks = (quads + kThreads - 1) / kThreads;
    reparam_samples<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        mean, logvar, z, n, total, seed, offset);
    return apv::launch_status();
}

extern "C" int apv_reparam_bwd(const float* g, const float* z, const float* mean,
                               float* dmean, float* dlogvar, int64_t samples,
                               int64_t n, void* stream) {
    if (n <= 0) return 0;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    reparam_bwd_sum<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(g, z, mean, dmean,
                                                           dlogvar, samples, n);
    return apv::launch_status();
}
