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
// Bound on an H100: the launch. The OOD chunk [50, 64, 128] writes 1.64 MB
// (0.49 us at 3.35 TB/s) and the train step's [256, 128] 0.13 MB, while a
// launch of any kernel costs the card ~1.1-1.3 us of device time (the
// launch floor in PERF.md). Above the floor it lost instructions: the
// first design spent more on a 64-bit remainder per output than on the
// Philox rounds, and wrote each quad as four scalar stores 16 B apart.
// This one gives each thread one counter (one quad of outputs), as the
// stream requires, and spends as little as it can around it:
// - one remainder a thread, in 32 bits when the output has fewer than
//   2^31 elements; the quad's other columns follow by increment and wrap;
// - mean and logvar as one float4 each when n % 4 == 0 (a quad then sits
//   in one row), the quad's z as one 16-byte store (the tail of a total
//   that is not a multiple of 4, and unaligned pointers, store scalars);
// - one sincosf per Box-Muller pair (one range reduction for both);
// - 64-thread blocks, so that the train step's S = 1 (8,192 quads) is
//   spread over 128 SMs and the OOD chunk's 102,400 quads over 1,600
//   blocks, all resident at once.
// The arithmetic is the first design's, operation for operation (the same
// libm calls, the same fma contraction), so the stream and its bits are
// unchanged. mean and logvar ([B, Z], 65.5 KB) are read from memory once
// and then from cache for each sample. It runs in 2.8 us at the OOD chunk
// and 1.7 us at the train step's S = 1, against 4.6 and 2.3 before
// (PERF.md).
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

constexpr int kThreads = 256;        // reparam_bwd_sum
constexpr int kSampleThreads = 64;  // reparam_samples

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

// Box-Muller: (u1, u2) -> two independent normals (r cos, r sin). u1 is
// clamped away from 0 as in the Pallas kernel (uniform_open already keeps
// it >= 2^-24).
__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float& n0, float& n1) {
    const float u1 = fmaxf(uniform_open(b1), 1e-12f);
    const float u2 = uniform_open(b2);
    const float r = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincosf(6.2831855f * u2, &s, &c);
    n0 = r * c;
    n1 = r * s;
}

constexpr int kVecLoad = 1;   // n % 4 == 0, mean and logvar 16-byte aligned
constexpr int kVecStore = 2;  // z 16-byte aligned

// Thread q: counter q, outputs 4q .. 4q+3 of the flat [S, n] z. Index is
// uint32_t when S * n < 2^31, else uint64_t.
template <typename Index>
__global__ void __launch_bounds__(kSampleThreads)
reparam_samples(const float* __restrict__ mean, const float* __restrict__ logvar,
                float* __restrict__ z, Index n, Index total, uint2 key,
                uint2 offset, int flags) {
    const Index q = static_cast<Index>(blockIdx.x) * kSampleThreads + threadIdx.x;
    const Index e0 = 4 * q;
    if (e0 >= total) return;
    const uint64_t q64 = q;
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q64), static_cast<uint32_t>(q64 >> 32),
                   offset.x, offset.y), key);
    float eps[4], out[4];
    box_muller(bits.x, bits.y, eps[0], eps[1]);
    box_muller(bits.z, bits.w, eps[2], eps[3]);
    Index i = e0 % n;
    if (flags & kVecLoad) {
        const float4 m = *reinterpret_cast<const float4*>(mean + i);
        const float4 lv = *reinterpret_cast<const float4*>(logvar + i);
        out[0] = m.x + expf(0.5f * lv.x) * eps[0];
        out[1] = m.y + expf(0.5f * lv.y) * eps[1];
        out[2] = m.z + expf(0.5f * lv.z) * eps[2];
        out[3] = m.w + expf(0.5f * lv.w) * eps[3];
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            out[j] = mean[i] + expf(0.5f * logvar[i]) * eps[j];
            i = (i + 1 == n) ? 0 : i + 1;   // the quad may wrap into the next row
        }
    }
    if ((flags & kVecStore) && e0 + 4 <= total) {
        *reinterpret_cast<float4*>(z + e0) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (e0 + j < total) z[e0 + j] = out[j];
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
    const unsigned blocks = static_cast<unsigned>((quads + kSampleThreads - 1) / kSampleThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const uint2 key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    const uint2 ctr = make_uint2(static_cast<uint32_t>(offset), static_cast<uint32_t>(offset >> 32));
    const int flags = (n % 4 == 0 && apv::aligned16(mean) && apv::aligned16(logvar) ? kVecLoad : 0)
                    | (apv::aligned16(z) ? kVecStore : 0);
    if (total < (int64_t{1} << 31)) {
        reparam_samples<uint32_t><<<blocks, kSampleThreads, 0, s>>>(
            mean, logvar, z, static_cast<uint32_t>(n), static_cast<uint32_t>(total),
            key, ctr, flags);
    } else {
        reparam_samples<uint64_t><<<blocks, kSampleThreads, 0, s>>>(
            mean, logvar, z, static_cast<uint64_t>(n), static_cast<uint64_t>(total),
            key, ctr, flags);
    }
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
