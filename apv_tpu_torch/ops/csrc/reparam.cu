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
// plain PyTorch version in ops/kernels.py computes the same stream. The
// key comes by value, or from device memory: a train step captured in a
// CUDA graph (training/graph.py) launches the kernel with a pointer into
// its static inputs, which each replay's key is written to, since a value
// passed at capture would be frozen into every replay.
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
// With a KL output (the ELBO paths: S = 1, the standard prior), the same
// launch also writes kl[r] = KL( N(mean_r, exp(logvar_r)) || N(0, I) ) for
// each row r of [B, Z]: the grid is the sample blocks followed by one KL
// block per two rows, each warp summing one row as kl.cu's kl_rows does
// (kl_terms.cuh), so z has apv_reparam's bits and kl apv_kl's. The branch
// on blockIdx.x is uniform within a block, and without a KL output the
// grid and the sampling code are the ones above. This removes the kl
// launch (~1.8 us of device time and the host's wrapper call and launch)
// from every ELBO step and scorer batch: the two kernels read the same
// [B, Z]. It runs in 1.80 us at [1, 256, 128], against 3.03 us for the
// two launches (PERF.md).
//
// Backward: replaces apv_tpu/ops/kernels.py::_reparam_bwd with
// _unbroadcast, the custom_vjp rule written in jnp, and, where the forward
// wrote a KL, apv_tpu/ops/kernels.py::_kl_bwd too. With g the incoming
// gradient [S, n], z the forward's output [S, n] and g_kl the KL's
// incoming gradient [B] (row r = i / Z):
//     dmean[i]   = sum_s g[s, i]                         + g_kl[r] * mean[i]
//     dlogvar[i] = sum_s 0.5 * g[s, i] * (z[s, i] - mean[i])
//                  + (g_kl[r] * 0.5) * (exp(logvar[i]) - 1)
// (dz/dlogvar = 0.5 * sigma * eps = 0.5 * (z - mean)), summed over the
// sample axis as _unbroadcast sums the broadcast one. Each part rounds as
// the separate kernels did (the s-ordered sum, kl.cu's products, each
// product and sum rounded on its own with __fmul_rn/__fadd_rn, so nvcc
// contracts nothing into an FMA), and one __fadd_rn joins them, the add
// autograd made of the two kernels' outputs: the same bits in one launch
// instead of three (reparam_bwd, kl_bwd, the add). Bound: memory, read g
// and z once, mean (and logvar) once and write two [n] vectors; the
// train step's S = 1 at [256, 128] moves 0.66 MB (0.79 MB with the KL
// term), the IWAE objective's S = 5 1.7 MB (0.51 us), all near the
// launch floor. The first design gave
// each thread one element and walked s in a loop whose loads waited on
// each other, in 128 blocks of 256 threads at [256, 128]. This one:
// - a thread takes four elements as float4 loads and stores when n % 4
//   == 0, the pointers are 16-byte aligned and (with g_kl) a quad lies
//   in one row (Z % 4 == 0); one element a thread otherwise;
// - the sample count is a template argument from 1 to 8 (a general
//   loop, unrolled by 8, past that), so a thread issues all its loads
//   (mean, logvar and g_kl first) before the first sum, and S = 1 runs
//   no loop at all;
// - one-warp blocks: 256 of them at n = 32,768, about two on every SM
//   (64-thread blocks measured 0.34 us slower at S = 5);
// - the row of g_kl by one 32-bit division while n < 2^31.
// One thread owns each output: deterministic, no atomics. With its inputs
// in L2 it runs in 1.20 us at [1, 256, 128], 1.36 us with the KL term
// (the three launches it replaces: 5.10 us) and 1.38 us at S = 5,
// against 1.26 and 1.63 for the first design (PERF.md).
#include "kl_terms.cuh"

namespace {

constexpr int kSampleThreads = 64;  // reparam_samples
constexpr int kKlRows = kSampleThreads / 32;   // rows a KL block sums
constexpr int kBwdThreads = 32;     // reparam_bwd_sum
constexpr int kBwdUnroll = 8;       // samples whose loads issue together

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

// The key (seed, offset) of a launch: read from ``dev`` ([seed, offset],
// 16 bytes of device memory) where it is set, else the values. Every
// thread of a launch reads the same two words.
struct Key {
    const uint64_t* dev;
    uint64_t seed, offset;
};

// -> (seed_lo, seed_hi) and (offset_lo, offset_hi)
__device__ __forceinline__ void unpack_key(const Key& k, uint2& key, uint2& ctr) {
    const auto* dev = reinterpret_cast<const unsigned long long*>(k.dev);
    const uint64_t seed = dev != nullptr ? __ldg(dev) : k.seed;
    const uint64_t offset = dev != nullptr ? __ldg(dev + 1) : k.offset;
    key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    ctr = make_uint2(static_cast<uint32_t>(offset), static_cast<uint32_t>(offset >> 32));
}

constexpr int kVecLoad = 1;   // n % 4 == 0, mean and logvar 16-byte aligned
constexpr int kVecStore = 2;  // z 16-byte aligned

// Thread q: counter q, outputs 4q .. 4q+3 of the flat [S, n] z. Index is
// uint32_t when S * n < 2^31, else uint64_t. With kKl, the blocks from
// sample_blocks on write kl instead, two rows [event] a block.
template <typename Index, bool kKl>
__global__ void __launch_bounds__(kSampleThreads)
reparam_samples(const float* __restrict__ mean, const float* __restrict__ logvar,
                float* __restrict__ z, Index n, Index total, Key k,
                int flags, float* __restrict__ kl,
                unsigned sample_blocks, int64_t rows, int64_t event) {
    if (kKl && blockIdx.x >= sample_blocks) {   // uniform within the block
        const int64_t row = static_cast<int64_t>(blockIdx.x - sample_blocks) * kKlRows
                          + (threadIdx.x >> 5);
        const int lane = threadIdx.x & 31;
        if (row >= rows) return;  // whole warps leave together
        const float acc = apv::kl_row_sum(mean + row * event, logvar + row * event,
                                          event, lane);
        if (lane == 0) kl[row] = acc;
        return;
    }
    const Index q = static_cast<Index>(blockIdx.x) * kSampleThreads + threadIdx.x;
    const Index e0 = 4 * q;
    if (e0 >= total) return;
    uint2 key, offset;
    unpack_key(k, key, offset);
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

template <int W>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[W]) {
    if constexpr (W == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
        v[0] = *p;
    }
}

template <int W>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[W]) {
    if constexpr (W == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
        *p = v[0];
    }
}

// One sample's terms of the sums, in the order of the walk over s.
template <int W>
__device__ __forceinline__ void add_sample(float (&dm)[W], float (&dlv)[W],
                                           const float (&gv)[W],
                                           const float (&zv)[W],
                                           const float (&m)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
        dm[w] = __fadd_rn(dm[w], gv[w]);
        dlv[w] = __fadd_rn(dlv[w], __fmul_rn(__fmul_rn(gv[w], 0.5f),
                                             __fadd_rn(zv[w], -m[w])));
    }
}

// Thread t: elements W*t .. W*t + W-1 of [n] (W = 4: one float4). kS > 0:
// exactly kS samples, every load issued before the first sum; kS = 0: any
// count, in unrolled chunks of kBwdUnroll and then one at a time. With kKl
// the KL's gradient terms are added for row i / event (one row a quad).
template <int W, bool kKl, int kS>
__global__ void __launch_bounds__(kBwdThreads)
reparam_bwd_sum(const float* __restrict__ g, const float* __restrict__ z,
                const float* __restrict__ mean, const float* __restrict__ logvar,
                const float* __restrict__ g_kl, float* __restrict__ dmean,
                float* __restrict__ dlogvar, int64_t samples, int64_t n,
                int64_t event) {
    const int64_t i = (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) * W;
    if (i >= n) return;
    float m[W], lv[W], dm[W], dlv[W];
    float gk = 0.0f;
    load<W>(mean + i, m);
    if constexpr (kKl) {
        load<W>(logvar + i, lv);
        const int64_t row = n < (int64_t{1} << 31)
            ? static_cast<int64_t>(static_cast<uint32_t>(i) / static_cast<uint32_t>(event))
            : i / event;
        gk = g_kl[row];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) dm[w] = dlv[w] = 0.0f;
    if constexpr (kS > 0) {
        float gv[kS][W], zv[kS][W];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
            load<W>(g + s * n + i, gv[s]);
            load<W>(z + s * n + i, zv[s]);
        }
#pragma unroll
        for (int s = 0; s < kS; ++s) add_sample<W>(dm, dlv, gv[s], zv[s], m);
    } else {
        int64_t s0 = 0;
        for (; s0 + kBwdUnroll <= samples; s0 += kBwdUnroll) {
            float gv[kBwdUnroll][W], zv[kBwdUnroll][W];
#pragma unroll
            for (int u = 0; u < kBwdUnroll; ++u) {
                load<W>(g + (s0 + u) * n + i, gv[u]);
                load<W>(z + (s0 + u) * n + i, zv[u]);
            }
#pragma unroll
            for (int u = 0; u < kBwdUnroll; ++u) add_sample<W>(dm, dlv, gv[u], zv[u], m);
        }
        for (; s0 < samples; ++s0) {
            float gv[W], zv[W];
            load<W>(g + s0 * n + i, gv);
            load<W>(z + s0 * n + i, zv);
            add_sample<W>(dm, dlv, gv, zv, m);
        }
    }
    if constexpr (kKl) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
            dm[w] = __fadd_rn(dm[w], apv::kl_dmean(gk, m[w]));
            dlv[w] = __fadd_rn(dlv[w], apv::kl_dlogvar(gk, lv[w]));
        }
    }
    store<W>(dmean + i, dm);
    store<W>(dlogvar + i, dlv);
}

template <int W, bool kKl, int kS>
void launch_bwd_grid(const float* g, const float* z, const float* mean,
                     const float* logvar, const float* g_kl, float* dmean,
                     float* dlogvar, int64_t samples, int64_t n, int64_t event,
                     cudaStream_t stream) {
    const int64_t threads = (n + W - 1) / W;
    const unsigned blocks = static_cast<unsigned>((threads + kBwdThreads - 1) / kBwdThreads);
    reparam_bwd_sum<W, kKl, kS><<<blocks, kBwdThreads, 0, stream>>>(
        g, z, mean, logvar, g_kl, dmean, dlogvar, samples, n, event);
}

// The sample count as a template argument from 1 to kBwdUnroll (the
// train steps' 1, the IWAE objective's k), else the general loop.
template <int W, bool kKl>
void launch_bwd(const float* g, const float* z, const float* mean,
                const float* logvar, const float* g_kl, float* dmean,
                float* dlogvar, int64_t samples, int64_t n, int64_t event,
                cudaStream_t stream) {
#define APV_BWD(S) launch_bwd_grid<W, kKl, S>(g, z, mean, logvar, g_kl, dmean, \
                                              dlogvar, samples, n, event, stream)
    switch (samples) {
        case 1: APV_BWD(1); break;
        case 2: APV_BWD(2); break;
        case 3: APV_BWD(3); break;
        case 4: APV_BWD(4); break;
        case 5: APV_BWD(5); break;
        case 6: APV_BWD(6); break;
        case 7: APV_BWD(7); break;
        case 8: APV_BWD(8); break;
        default: APV_BWD(0); break;
    }
#undef APV_BWD
}

template <typename Index, bool kKl>
void launch_sample_grid(const float* mean, const float* logvar, float* z, float* kl,
                    int64_t total, int64_t n, Key key, int flags,
                    unsigned sample_blocks, int64_t rows, int64_t event,
                    cudaStream_t stream) {
    const unsigned kl_blocks = kKl ? static_cast<unsigned>((rows + kKlRows - 1) / kKlRows) : 0;
    reparam_samples<Index, kKl><<<sample_blocks + kl_blocks, kSampleThreads, 0, stream>>>(
        mean, logvar, z, static_cast<Index>(n), static_cast<Index>(total), key,
        flags, kl, sample_blocks, rows, event);
}

template <typename Index>
void launch_samples(const float* mean, const float* logvar, float* z, float* kl,
                    int64_t total, int64_t n, Key key, int flags,
                    unsigned sample_blocks, int64_t rows, int64_t event,
                    cudaStream_t stream) {
    if (kl != nullptr) {
        launch_sample_grid<Index, true>(mean, logvar, z, kl, total, n, key, flags,
                                        sample_blocks, rows, event, stream);
    } else {
        launch_sample_grid<Index, false>(mean, logvar, z, kl, total, n, key, flags,
                                         sample_blocks, rows, event, stream);
    }
}

}  // namespace

// kl: null, or [n / event] per-row KLs written by the same launch. key:
// null (the key is seed and offset), or the device's [seed, offset].
extern "C" int apv_reparam(const float* mean, const float* logvar, float* z,
                           float* kl, int64_t samples, int64_t n, int64_t event,
                           uint64_t seed, uint64_t offset, const uint64_t* key,
                           void* stream) {
    const int64_t total = samples * n;
    if (total <= 0) return 0;
    const int64_t quads = (total + 3) / 4;
    const unsigned blocks = static_cast<unsigned>((quads + kSampleThreads - 1) / kSampleThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const Key k{key, seed, offset};
    const int flags = (n % 4 == 0 && apv::aligned16(mean) && apv::aligned16(logvar) ? kVecLoad : 0)
                    | (apv::aligned16(z) ? kVecStore : 0);
    const int64_t rows = kl != nullptr ? n / event : 0;
    if (total < (int64_t{1} << 31)) {
        launch_samples<uint32_t>(mean, logvar, z, kl, total, n, k, flags, blocks,
                                 rows, event, s);
    } else {
        launch_samples<uint64_t>(mean, logvar, z, kl, total, n, k, flags, blocks,
                                 rows, event, s);
    }
    return apv::launch_status();
}

// g: null when samples is 0 (z had no gradient). g_kl: null (no KL term;
// logvar and event unused), or [n / event], the KL's incoming gradient.
extern "C" int apv_reparam_bwd(const float* g, const float* z, const float* mean,
                               const float* logvar, const float* g_kl,
                               float* dmean, float* dlogvar, int64_t samples,
                               int64_t n, int64_t event, void* stream) {
    if (n <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const bool with_kl = g_kl != nullptr;
    const bool vec = n % 4 == 0 && apv::aligned16(g) && apv::aligned16(z)
                  && apv::aligned16(mean) && apv::aligned16(dmean)
                  && apv::aligned16(dlogvar)
                  && (!with_kl || (event % 4 == 0 && apv::aligned16(logvar)));
    if (vec && with_kl) {
        launch_bwd<4, true>(g, z, mean, logvar, g_kl, dmean, dlogvar, samples, n, event, s);
    } else if (vec) {
        launch_bwd<4, false>(g, z, mean, logvar, g_kl, dmean, dlogvar, samples, n, event, s);
    } else if (with_kl) {
        launch_bwd<1, true>(g, z, mean, logvar, g_kl, dmean, dlogvar, samples, n, event, s);
    } else {
        launch_bwd<1, false>(g, z, mean, logvar, g_kl, dmean, dlogvar, samples, n, event, s);
    }
    return apv::launch_status();
}

// The learned-prior variant (VDVAE's 43 layers): one layer's posterior
// and prior come as the branches' outputs q and p, [B, 2Z, H, W] in
// channels_last memory (the means in channels 0..Z-1, the log-sigmas in
// Z..2Z-1 of each pixel's 2Z), and are read in place: no slice is copied.
//     z[b, c, h, w] = qm + exp(qs) * eps,   eps from the stream above
//     kl[b] = sum over c, h, w of -1/2 + ps - qs
//                                 + 1/2 (e^{2 qs} + (qm - pm)^2) e^{-2 ps}
// z is written [B, Z, H, W] in channels_last memory, element e of that
// memory taking the stream's draw e: the stream of reparam_sample, so a
// key gives the plain version's draws (kernels.py, reparam_prior_plain).
// Z % 4 == 0, so a quad of z lies in one pixel: four channels of qm, qs,
// pm and ps are each one float4 load.
//
// Bound: memory. At r = 32, B = 128 it reads 33.6 MB and writes 8.4 MB;
// the 42 layers at r <= 16 are a few MB or less and sit near the launch
// floor. Design: a block an image (128 blocks at B = 128), 256 threads
// striding over the image's quads four at a time, so that each thread has
// 16 loads of 16 bytes in flight; the image's KL summed in registers, then
// by shuffles and a fixed-order pass over the warps' partials:
// deterministic, no atomics, and no second launch for the per-image sum.
//
// Backward, from g (z's gradient, z's layout; null: none) and g_kl [B]
// (null: none), with d = qm - pm and v = e^{-2 ps}:
//     dqm = g + g_kl d v            dqs = g (z - qm) + g_kl (e^{2 qs} v - 1)
//     dpm = -g_kl d v               dps = g_kl (1 - (e^{2 qs} + d^2) v)
// (z - qm = e^{qs} eps). Elementwise: a thread a quad, dq and dp written in
// q's layout. Bound: memory, 6 reads and 4 writes of [B, Z, H, W].
namespace {

constexpr int kPriorThreads = 256;

__device__ __forceinline__ float4 ld4(const float* __restrict__ p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float get(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A block an image; per_image = Z * H * W elements of z.
template <typename Index>
__global__ void __launch_bounds__(kPriorThreads)
reparam_samples(const float* __restrict__ q, const float* __restrict__ p,
                float* __restrict__ z, float* __restrict__ kl, Index per_image,
                int zdim, Key k) {
    const Index b = blockIdx.x;
    uint2 key, offset;
    unpack_key(k, key, offset);
    const Index quads = per_image / 4;
    const Index ld = 2 * static_cast<Index>(zdim);
    float acc = 0.0f;
#pragma unroll 4
    for (Index k = threadIdx.x; k < quads; k += kPriorThreads) {
        const Index e0 = b * per_image + 4 * k;       // in z's memory
        const Index pix = e0 / static_cast<Index>(zdim);
        const Index c = e0 - pix * static_cast<Index>(zdim);
        const float* qp = q + pix * ld + c;
        const float* pp = p + pix * ld + c;
        const float4 qm = ld4(qp), qs = ld4(qp + zdim);
        const float4 pm = ld4(pp), ps = ld4(pp + zdim);
        const uint64_t ctr = e0 / 4;
        const uint4 bits = philox4x32_10(
            make_uint4(static_cast<uint32_t>(ctr), static_cast<uint32_t>(ctr >> 32),
                       offset.x, offset.y), key);
        float eps[4], out[4];
        box_muller(bits.x, bits.y, eps[0], eps[1]);
        box_muller(bits.z, bits.w, eps[2], eps[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float m = get(qm, j), s = get(qs, j);
            const float d = m - get(pm, j), sp = get(ps, j);
            out[j] = m + expf(s) * eps[j];
            acc += -0.5f + sp - s + 0.5f * (expf(2.0f * s) + d * d) * expf(-2.0f * sp);
        }
        *reinterpret_cast<float4*>(z + e0) = make_float4(out[0], out[1], out[2], out[3]);
    }
    __shared__ float partial[kPriorThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kPriorThreads / 32; ++w) sum += partial[w];
        kl[b] = sum;
    }
}

// A thread a quad of z's memory.
template <typename Index>
__global__ void __launch_bounds__(kPriorThreads)
reparam_bwd_sum(const float* __restrict__ g, const float* __restrict__ z,
                const float* __restrict__ q, const float* __restrict__ p,
                const float* __restrict__ g_kl, float* __restrict__ dq,
                float* __restrict__ dp, Index total, Index per_image, int zdim) {
    const Index e0 = (static_cast<Index>(blockIdx.x) * kPriorThreads + threadIdx.x) * 4;
    if (e0 >= total) return;
    const Index pix = e0 / static_cast<Index>(zdim);
    const Index c = e0 - pix * static_cast<Index>(zdim);
    const Index at = pix * 2 * static_cast<Index>(zdim) + c;
    const float4 qm = ld4(q + at), qs = ld4(q + at + zdim);
    const float4 pm = ld4(p + at), ps = ld4(p + at + zdim);
    const float4 zv = ld4(z + e0);
    const float4 gv = g != nullptr ? ld4(g + e0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float gk = g_kl != nullptr ? g_kl[e0 / per_image] : 0.0f;
    float o[4][4];   // dqm, dqs, dpm, dps
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float m = get(qm, j), s = get(qs, j), gz = get(gv, j);
        const float d = m - get(pm, j), v = expf(-2.0f * get(ps, j));
        const float e2 = expf(2.0f * s);
        o[0][j] = gz + gk * (d * v);
        o[1][j] = gz * (get(zv, j) - m) + gk * (e2 * v - 1.0f);
        o[2][j] = -(gk * (d * v));
        o[3][j] = gk * (1.0f - (e2 + d * d) * v);
    }
    *reinterpret_cast<float4*>(dq + at) = make_float4(o[0][0], o[0][1], o[0][2], o[0][3]);
    *reinterpret_cast<float4*>(dq + at + zdim) = make_float4(o[1][0], o[1][1], o[1][2], o[1][3]);
    *reinterpret_cast<float4*>(dp + at) = make_float4(o[2][0], o[2][1], o[2][2], o[2][3]);
    *reinterpret_cast<float4*>(dp + at + zdim) = make_float4(o[3][0], o[3][1], o[3][2], o[3][3]);
}

}  // namespace

// q, p: [images, 2 zdim, H, W] channels_last; z: [images, zdim, H, W]
// channels_last; kl: [images]. per_image = zdim * H * W, zdim % 4 == 0.
// key: null (the key is seed and offset), or the device's [seed, offset].
extern "C" int apv_reparam_prior(const float* q, const float* p, float* z, float* kl,
                                 int64_t images, int64_t per_image, int64_t zdim,
                                 uint64_t seed, uint64_t offset, const uint64_t* key,
                                 void* stream) {
    if (images <= 0 || per_image <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const Key k{key, seed, offset};
    const int zd = static_cast<int>(zdim);
    if (2 * images * per_image < (int64_t{1} << 31)) {
        reparam_samples<uint32_t><<<static_cast<unsigned>(images), kPriorThreads, 0, s>>>(
            q, p, z, kl, static_cast<uint32_t>(per_image), zd, k);
    } else {
        reparam_samples<uint64_t><<<static_cast<unsigned>(images), kPriorThreads, 0, s>>>(
            q, p, z, kl, static_cast<uint64_t>(per_image), zd, k);
    }
    return apv::launch_status();
}

// g: null (z had no gradient) or z's layout; g_kl: null or [images].
extern "C" int apv_reparam_prior_bwd(const float* g, const float* z, const float* q,
                                     const float* p, const float* g_kl, float* dq,
                                     float* dp, int64_t images, int64_t per_image,
                                     int64_t zdim, void* stream) {
    const int64_t total = images * per_image;
    if (total <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const int zd = static_cast<int>(zdim);
    const unsigned blocks = static_cast<unsigned>((total / 4 + kPriorThreads - 1) / kPriorThreads);
    if (2 * total < (int64_t{1} << 31)) {
        reparam_bwd_sum<uint32_t><<<blocks, kPriorThreads, 0, s>>>(
            g, z, q, p, g_kl, dq, dp, static_cast<uint32_t>(total),
            static_cast<uint32_t>(per_image), zd);
    } else {
        reparam_bwd_sum<uint64_t><<<blocks, kPriorThreads, 0, s>>>(
            g, z, q, p, g_kl, dq, dp, static_cast<uint64_t>(total),
            static_cast<uint64_t>(per_image), zd);
    }
    return apv::launch_status();
}
