// Fused GroupNorm + tanh-GELU over NHWC activations, forward and backward.
//
// Replaces apv_tpu/ops/groupnorm.py::_fwd (Pallas kernel _gn_gelu_kernel):
// for x [B, HW, C] with G groups of cg = C/G channels,
//     mean, var = moments of x[b, :, g*cg:(g+1)*cg]      (float32, two-pass)
//     y = gelu_tanh(((x - mean) * rsqrt(var + eps)) * gamma + beta)
// written in x's dtype (bf16 or f32), with mean and rstd [B, G] saved as the
// residuals _fwd returns.
//
// The TPU kernel's one-hot membership matmuls and HW-chunked two passes
// exist because Mosaic cannot reshape the lane dim and VMEM is scoped; here
// a group's statistics are a plain block reduction. Layout: one 256-thread
// block per (b, g). Threads walk the group as (pixel, channel) with the
// channel fastest, so neighbouring threads read neighbouring addresses of a
// pixel's cg-channel run; each thread keeps one channel for the whole walk
// (threads per channel = 256 / cg), which makes the per-channel sums of the
// backward a fixed-order pass over shared memory. Three passes over the
// group (sum; sum of squared deviations; normalize and write): the group is
// read from device memory once and from L2 after that (a bf16 group at the
// flagship stage-1 shape [256, 32x32, 64] is 16 KB).
//
// Bound on an H100: memory. bf16 x in and y out at [256, 32, 32, 64] is
// 67.1 MB, 20.0 us at 3.35 TB/s; ~13 f32 operations per element take
// 3.3 us at 67 TFLOP/s.
//
// Backward: groupnorm_gelu_bwd_rows replaces the hand-derived custom_vjp
// rule apv_tpu/ops/groupnorm.py::_bwd, term for term:
//     dy_pre = dy * gelu'(y_pre),  y_pre = xhat*gamma + beta
//     dgamma = sum_{b,hw} dy_pre * xhat,  dbeta = sum_{b,hw} dy_pre
//     dxhat  = dy_pre * gamma
//     dx     = rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat))
// Same layout, two passes over the group: the first sums dxhat and
// dxhat*xhat for the group and dy_pre*xhat and dy_pre per channel, the
// second writes dx. dgamma and dbeta are deterministic: each block writes
// its channels' per-row partials [B, C] (a fixed-order sum over its threads),
// and groupnorm_gelu_param_sum adds the B rows of each column, one warp a
// column, in a fixed order. No float atomics. Bound: memory; dy, x in and
// dx out, 100.7 MB in bf16 at the flagship shape, 30.0 us.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kSqrt2OverPi = 0.7978845608028654f;

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
    p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float gelu(float y) {
    return 0.5f * y * (1.0f + tanhf(kSqrt2OverPi * (y + 0.044715f * y * y * y)));
}

__device__ __forceinline__ float gelu_grad(float y) {
    const float th = tanhf(kSqrt2OverPi * (y + 0.044715f * y * y * y));
    return 0.5f * (1.0f + th) + 0.5f * y * (1.0f - th * th) * kSqrt2OverPi
        * (1.0f + 3.0f * 0.044715f * y * y);
}

// Sum over the block, returned to every thread; fixed order, so the same
// inputs give the same bits. Safe to call repeatedly.
__device__ float block_allsum(float v, float* scratch) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = apv::warp_sum(v);
    __syncthreads();                       // scratch free from the last call
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
    return s;
}

// The thread's place in the walk over one chunk of a group's channels
// (chunks of at most 256 channels; one chunk unless cg > 256): channel
// c0 + ch, first pixel p0, pixel stride tpc (threads per channel). The last
// 256 mod cn threads hold no channel in the chunk.
struct Walk {
    int c0, cn, tpc, ch, p0;
    __device__ Walk(int chunk0, int cg) {
        c0 = chunk0;
        cn = min(cg - chunk0, kThreads);
        tpc = kThreads / cn;
        ch = threadIdx.x % cn;
        p0 = threadIdx.x / cn;
    }
    __device__ bool active() const { return p0 < tpc; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
groupnorm_gelu_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int64_t hw, int c, int groups, float eps) {
    __shared__ float scratch[kThreads / 32];
    const int b = blockIdx.x / groups, g = blockIdx.x % groups;
    const int cg = c / groups;
    const int64_t base = static_cast<int64_t>(b) * hw * c + static_cast<int64_t>(g) * cg;
    const float n = static_cast<float>(hw) * static_cast<float>(cg);

    float s = 0.0f;
    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        if (!wk.active()) continue;
        for (int64_t p = wk.p0; p < hw; p += wk.tpc) s += load(x, base + p * c + c0 + wk.ch);
    }
    const float mean = block_allsum(s, scratch) / n;

    float sq = 0.0f;
    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        if (!wk.active()) continue;
        for (int64_t p = wk.p0; p < hw; p += wk.tpc) {
            const float d = load(x, base + p * c + c0 + wk.ch) - mean;
            sq += d * d;
        }
    }
    const float rstd = 1.0f / sqrtf(block_allsum(sq, scratch) / n + eps);

    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        if (!wk.active()) continue;
        const int cc = g * cg + c0 + wk.ch;
        const float ga = gamma[cc], be = beta[cc];
        for (int64_t p = wk.p0; p < hw; p += wk.tpc) {
            const int64_t i = base + p * c + c0 + wk.ch;
            store(y, i, gelu((load(x, i) - mean) * rstd * ga + be));
        }
    }
    if (threadIdx.x == 0) {
        mean_out[blockIdx.x] = mean;
        rstd_out[blockIdx.x] = rstd;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
groupnorm_gelu_bwd_rows(const T* __restrict__ dy, const T* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ mean_in,
                        const float* __restrict__ rstd_in, T* __restrict__ dx,
                        float* __restrict__ part_dgamma,
                        float* __restrict__ part_dbeta, int64_t hw, int c,
                        int groups) {
    __shared__ float scratch[kThreads / 32];
    __shared__ float pg[kThreads], pb[kThreads];
    const int b = blockIdx.x / groups, g = blockIdx.x % groups;
    const int cg = c / groups;
    const int64_t base = static_cast<int64_t>(b) * hw * c + static_cast<int64_t>(g) * cg;
    const float n = static_cast<float>(hw) * static_cast<float>(cg);
    const float mean = mean_in[blockIdx.x], rstd = rstd_in[blockIdx.x];

    float s1 = 0.0f, s2 = 0.0f;
    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        float acc_g = 0.0f, acc_b = 0.0f;
        if (wk.active()) {
            const int cc = g * cg + c0 + wk.ch;
            const float ga = gamma[cc], be = beta[cc];
            for (int64_t p = wk.p0; p < hw; p += wk.tpc) {
                const int64_t i = base + p * c + c0 + wk.ch;
                const float xhat = (load(x, i) - mean) * rstd;
                const float dy_pre = load(dy, i) * gelu_grad(xhat * ga + be);
                const float dxhat = dy_pre * ga;
                acc_g += dy_pre * xhat;
                acc_b += dy_pre;
                s1 += dxhat;
                s2 += dxhat * xhat;
            }
        }
        // per-channel partials of this row: thread ch adds the tpc threads
        // of its channel in order
        __syncthreads();
        pg[threadIdx.x] = acc_g;
        pb[threadIdx.x] = acc_b;
        __syncthreads();
        if (threadIdx.x < wk.cn) {
            float tg = 0.0f, tb = 0.0f;
            for (int j = 0; j < wk.tpc; ++j) {
                tg += pg[j * wk.cn + threadIdx.x];
                tb += pb[j * wk.cn + threadIdx.x];
            }
            const int64_t o = static_cast<int64_t>(b) * c + g * cg + c0 + threadIdx.x;
            part_dgamma[o] = tg;
            part_dbeta[o] = tb;
        }
    }
    const float m1 = block_allsum(s1, scratch) / n;
    const float m2 = block_allsum(s2, scratch) / n;

    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        if (!wk.active()) continue;
        const int cc = g * cg + c0 + wk.ch;
        const float ga = gamma[cc], be = beta[cc];
        for (int64_t p = wk.p0; p < hw; p += wk.tpc) {
            const int64_t i = base + p * c + c0 + wk.ch;
            const float xhat = (load(x, i) - mean) * rstd;
            const float dxhat = load(dy, i) * gelu_grad(xhat * ga + be) * ga;
            store(dx, i, rstd * (dxhat - m1 - xhat * m2));
        }
    }
}

// dgamma[c] = sum_b part_dgamma[b, c], dbeta too: one warp per column,
// lane l adds rows l, l + 32, ... in order, then a shuffle tree of fixed
// shape, so the same partials always give the same bits.
__global__ void __launch_bounds__(kThreads)
groupnorm_gelu_param_sum(const float* __restrict__ part_dgamma,
                         const float* __restrict__ part_dbeta,
                         float* __restrict__ dgamma, float* __restrict__ dbeta,
                         int64_t rows, int c) {
    const int cc = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (cc >= c) return;  // whole warps leave together
    float tg = 0.0f, tb = 0.0f;
    for (int64_t r = lane; r < rows; r += 32) {
        tg += part_dgamma[r * c + cc];
        tb += part_dbeta[r * c + cc];
    }
    tg = apv::warp_sum(tg);
    tb = apv::warp_sum(tb);
    if (lane == 0) {
        dgamma[cc] = tg;
        dbeta[cc] = tb;
    }
}

}  // namespace

extern "C" int apv_groupnorm_gelu(const void* x, const float* gamma,
                                  const float* beta, void* y, float* mean,
                                  float* rstd, int64_t batch, int64_t hw,
                                  int64_t c, int64_t groups, float eps,
                                  int is_bf16, void* stream) {
    if (batch <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>(batch * groups);
    if (is_bf16) {
        groupnorm_gelu_rows<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), gamma, beta,
            static_cast<__nv_bfloat16*>(y), mean, rstd, hw,
            static_cast<int>(c), static_cast<int>(groups), eps);
    } else {
        groupnorm_gelu_rows<float><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(x), gamma, beta, static_cast<float*>(y),
            mean, rstd, hw, static_cast<int>(c), static_cast<int>(groups), eps);
    }
    return apv::launch_status();
}

extern "C" int apv_groupnorm_gelu_bwd(const void* dy, const void* x,
                                      const float* gamma, const float* beta,
                                      const float* mean, const float* rstd,
                                      void* dx, float* part_dgamma,
                                      float* part_dbeta, float* dgamma,
                                      float* dbeta, int64_t batch, int64_t hw,
                                      int64_t c, int64_t groups, int is_bf16,
                                      void* stream) {
    if (c <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (batch > 0) {
        const unsigned blocks = static_cast<unsigned>(batch * groups);
        if (is_bf16) {
            groupnorm_gelu_bwd_rows<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
                static_cast<const __nv_bfloat16*>(dy),
                static_cast<const __nv_bfloat16*>(x), gamma, beta, mean, rstd,
                static_cast<__nv_bfloat16*>(dx), part_dgamma, part_dbeta, hw,
                static_cast<int>(c), static_cast<int>(groups));
        } else {
            groupnorm_gelu_bwd_rows<float><<<blocks, kThreads, 0, s>>>(
                static_cast<const float*>(dy), static_cast<const float*>(x),
                gamma, beta, mean, rstd, static_cast<float*>(dx), part_dgamma,
                part_dbeta, hw, static_cast<int>(c), static_cast<int>(groups));
        }
        const int status = apv::launch_status();
        if (status != 0) return status;
    }
    constexpr int kCols = kThreads / 32;  // one warp per column
    const unsigned col_blocks = static_cast<unsigned>((c + kCols - 1) / kCols);
    groupnorm_gelu_param_sum<<<col_blocks, kThreads, 0, s>>>(
        part_dgamma, part_dbeta, dgamma, dbeta, batch, static_cast<int>(c));
    return apv::launch_status();
}
