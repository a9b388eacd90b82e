// Per-row Bernoulli reconstruction log-likelihood and its backward.
//
// Forward: replaces apv_tpu/ops/kernels.py::_bernoulli_fwd (Pallas kernel
// _bernoulli_kernel, via _reduce_call). For each row r of the logits
// [rows, E]:
//     out[r] = sum_e x[r % x_rows, e] * l[r,e] - softplus(l[r,e])
// with the stable softplus max(l, 0) + log1p(exp(-|l|)), full-precision
// expf/log1pf (the build has no --use_fast_math), float32 throughout. x
// holds x_rows distinct rows (x_rows divides rows): the IWAE path scores
// each image under S samples, rows = S * B, and row r reads image r % B,
// the order of x.expand(S, B, E).reshape(S * B, E).
//
// Bound on an H100: memory. The logits are read once, x once per image:
// at the IWAE chunk [3200, 784] with x [64, 784] that is 10.2 MB, ~3.05 us
// at 3.35 TB/s. At the train step's [256, 784] it is 1.6 MB, below the
// 1.13 us a one-element launch costs the card (PERF.md). What holds the
// IWAE chunk above its bound is instruction issue: the full-precision
// expf and log1pf cost ~44 instructions an element.
// Design: the backward's layout. A block a row, a thread per float4 of the
// row (per element on the scalar route: a length that is not a multiple
// of 4, or a pointer not 16-byte aligned), two from 1024 rows on; each
// thread loads its x and l before it computes, then one block reduction
// (warps in a fixed order) writes out[r]. At E = 784 that is 196 threads
// a row in blocks of 224: 256 blocks at the train step, one wave over 132
// SMs. x's row costs one 32-bit remainder a block and is served from L2
// to the S blocks that share it. (The first design, a warp per row in
// 128-thread blocks, gave the train step 64 blocks and each lane a serial
// walk of ~six float4s: 5.04 us there.)
//
// Backward: replaces apv_tpu/ops/kernels.py::_bernoulli_bwd, the custom_vjp
// rule written in jnp:
//     dl[r,e] = g[r] * (x[r,e] - sigmoid(l[r,e])),  dx[r,e] = g[r] * l[r,e]
// dx is written only when the caller asks for it (the training path's x is
// data and needs none). Bound: memory, 12 bytes per element without dx
// (read x and l, write dl): 2.4 MB at [256, 784], 0.72 us at 3.35 TB/s,
// below the 1.13 us a one-element launch costs an H100 80GB HBM3 at 700 W
// (PERF.md). So the grid has to fill the card at once: one thread per
// float4 of the row (per element on the scalar route), blockIdx.y the row,
// so that g[r] needs no division; each thread loads g, x and l first, then
// computes and stores. At [256, 784] that is 256 blocks of 224 threads,
// one wave over 132 SMs. (The first design, a warp per row, gave 64
// blocks of 128 threads, each lane walking ~six float4s with a store
// between loads: 4.41 us on that card.)
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;            // the forward's largest block
constexpr int kBwdThreads = 256;         // the backward's largest block

__device__ __forceinline__ float softplus(float v) {
    return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float elem(float x, float l) {
    return x * l - softplus(l);
}

// sigmoid as 1 / (1 + e^-v), the form PyTorch's and XLA's logistic use.
__device__ __forceinline__ float sigmoid(float v) {
    return 1.0f / (1.0f + expf(-v));
}

// One block a row; a thread per unit (a float4 where kVec, else an
// element), looping past blockDim.x units.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bernoulli_rows(const float* __restrict__ x, const float* __restrict__ logits,
               float* __restrict__ out, int event, unsigned x_rows) {
    const float* xr = x + static_cast<int64_t>(blockIdx.x % x_rows) * event;
    const float* lr = logits + static_cast<int64_t>(blockIdx.x) * event;
    float acc = 0.0f;
    if constexpr (kVec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* l4 = reinterpret_cast<const float4*>(lr);
        for (int i = threadIdx.x; i < event / 4; i += blockDim.x) {
            const float4 xv = x4[i], lv = l4[i];
            acc += elem(xv.x, lv.x) + elem(xv.y, lv.y)
                 + elem(xv.z, lv.z) + elem(xv.w, lv.w);
        }
    } else {
        for (int i = threadIdx.x; i < event; i += blockDim.x) acc += elem(xr[i], lr[i]);
    }
    acc = apv::block_sum(acc);
    if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// One unit of the row a thread: a float4 where kVec (event % 4 == 0, the
// tensors 16-byte aligned), else one element. blockIdx.y is the row; rows
// past gridDim.y (65,535) loop.
template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
bernoulli_bwd_elems(const float* __restrict__ g, const float* __restrict__ x,
                    const float* __restrict__ logits, float* __restrict__ dx,
                    float* __restrict__ dl, int64_t rows, int64_t event) {
    constexpr int kUnit = kVec ? 4 : 1;
    const int64_t e = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kUnit;
    if (e >= event) return;
    for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
        const int64_t i = row * event + e;
        const float gr = g[row];
        if constexpr (kVec) {
            const float4 xv = *reinterpret_cast<const float4*>(x + i);
            const float4 lv = *reinterpret_cast<const float4*>(logits + i);
            *reinterpret_cast<float4*>(dl + i) = make_float4(
                gr * (xv.x - sigmoid(lv.x)), gr * (xv.y - sigmoid(lv.y)),
                gr * (xv.z - sigmoid(lv.z)), gr * (xv.w - sigmoid(lv.w)));
            if (dx) *reinterpret_cast<float4*>(dx + i) = make_float4(gr * lv.x, gr * lv.y,
                                                                     gr * lv.z, gr * lv.w);
        } else {
            const float xv = x[i], lv = logits[i];
            dl[i] = gr * (xv - sigmoid(lv));
            if (dx) dx[i] = gr * lv;
        }
    }
}

}  // namespace

// x holds x_rows rows, x_rows dividing rows; row r reads x row r % x_rows.
extern "C" int apv_bernoulli(const float* x, const float* logits, float* out,
                             int64_t rows, int64_t event, int64_t x_rows,
                             void* stream) {
    if (rows <= 0) return 0;
    if (x_rows <= 0 || rows % x_rows != 0 || rows > INT32_MAX || event > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = event % 4 == 0 && apv::aligned16(x) && apv::aligned16(logits);
    const int64_t units = vec ? event / 4 : event;
    // a thread per unit; two units a thread from 1024 rows on, where the
    // grid is several waves deep anyway and each block's reduction is then
    // shared by twice the work
    const int64_t per = rows >= 1024 ? 2 : 1;
    const auto threads = static_cast<unsigned>(
        std::clamp<int64_t>(((units + per - 1) / per + 31) / 32 * 32, 32, kThreads));
    const auto blocks = static_cast<unsigned>(rows);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto n = static_cast<int>(event);
    const auto xr = static_cast<unsigned>(x_rows);
    if (vec) {
        bernoulli_rows<true><<<blocks, threads, 0, s>>>(x, logits, out, n, xr);
    } else {
        bernoulli_rows<false><<<blocks, threads, 0, s>>>(x, logits, out, n, xr);
    }
    return apv::launch_status();
}

// dx may be null: then only dl is written.
extern "C" int apv_bernoulli_bwd(const float* g, const float* x,
                                 const float* logits, float* dx, float* dl,
                                 int64_t rows, int64_t event, void* stream) {
    if (rows <= 0 || event <= 0) return 0;
    const bool vec = event % 4 == 0 && apv::aligned16(x) && apv::aligned16(logits)
                     && apv::aligned16(dl) && (dx == nullptr || apv::aligned16(dx));
    const int64_t units = vec ? event / 4 : event;          // threads a row
    const int64_t threads = std::min<int64_t>(kBwdThreads, (units + 31) / 32 * 32);
    const dim3 grid(static_cast<unsigned>((units + threads - 1) / threads),
                    static_cast<unsigned>(std::min<int64_t>(rows, 65535)));
    const auto s = static_cast<cudaStream_t>(stream);
    if (vec) {
        bernoulli_bwd_elems<true><<<grid, static_cast<unsigned>(threads), 0, s>>>(
            g, x, logits, dx, dl, rows, event);
    } else {
        bernoulli_bwd_elems<false><<<grid, static_cast<unsigned>(threads), 0, s>>>(
            g, x, logits, dx, dl, rows, event);
    }
    return apv::launch_status();
}
