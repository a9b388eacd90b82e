// Per-row Bernoulli reconstruction log-likelihood and its backward.
//
// Forward: replaces apv_tpu/ops/kernels.py::_bernoulli_fwd (Pallas kernel
// _bernoulli_kernel, via _reduce_call). For each row r of [rows, E]:
//     out[r] = sum_e x[r,e] * l[r,e] - softplus(l[r,e])
// with the stable softplus max(l, 0) + log1p(exp(-|l|)), full-precision
// expf/log1pf (the build has no --use_fast_math), float32 throughout.
//
// Bound on an H100: memory. Each element reads 8 bytes (x and the logit);
// at the IWAE chunk [3200, 784] that is 20.1 MB, ~6.0 us at 3.35 TB/s. At
// the train step's [256, 784] it is 1.6 MB, far below one launch.
// Design: one warp per row (4 rows per 128-thread block). A row of 784 is
// 196 float4, so each lane makes about six 16-byte loads of x and of l
// with neighbouring lanes on neighbouring addresses; the sum stays in
// registers and one warp-shuffle reduction writes [rows]. Rows whose length
// is not a multiple of 4, or inputs not 16-byte aligned, take the scalar
// loop instead.
//
// Backward: replaces apv_tpu/ops/kernels.py::_bernoulli_bwd, the custom_vjp
// rule written in jnp:
//     dl[r,e] = g[r] * (x[r,e] - sigmoid(l[r,e])),  dx[r,e] = g[r] * l[r,e]
// dx is written only when the caller asks for it (the training path's x is
// data and needs none). Bound: memory, 12 bytes per element without dx
// (read x and l, write dl): 2.4 MB at [256, 784], launch-bound. Same warp-
// per-row layout, so g[r] is read once per warp and no index is divided.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 32;

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

__global__ void __launch_bounds__(kThreads)
bernoulli_rows(const float* __restrict__ x, const float* __restrict__ logits,
               float* __restrict__ out, int64_t rows, int64_t event, bool vec) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;  // whole warps leave together
    const float* xr = x + row * event;
    const float* lr = logits + row * event;
    float acc = 0.0f;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* l4 = reinterpret_cast<const float4*>(lr);
        for (int64_t i = lane; i < event / 4; i += 32) {
            const float4 xv = x4[i], lv = l4[i];
            acc += elem(xv.x, lv.x) + elem(xv.y, lv.y)
                 + elem(xv.z, lv.z) + elem(xv.w, lv.w);
        }
    } else {
        for (int64_t i = lane; i < event; i += 32) acc += elem(xr[i], lr[i]);
    }
    acc = apv::warp_sum(acc);
    if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kThreads)
bernoulli_bwd_rows(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ logits, float* __restrict__ dx,
                   float* __restrict__ dl, int64_t rows, int64_t event, bool vec) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const float gr = g[row];
    const int64_t base = row * event;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(x + base);
        const float4* l4 = reinterpret_cast<const float4*>(logits + base);
        float4* dl4 = reinterpret_cast<float4*>(dl + base);
        float4* dx4 = dx ? reinterpret_cast<float4*>(dx + base) : nullptr;
        for (int64_t i = lane; i < event / 4; i += 32) {
            const float4 xv = x4[i], lv = l4[i];
            dl4[i] = make_float4(gr * (xv.x - sigmoid(lv.x)), gr * (xv.y - sigmoid(lv.y)),
                                 gr * (xv.z - sigmoid(lv.z)), gr * (xv.w - sigmoid(lv.w)));
            if (dx4) dx4[i] = make_float4(gr * lv.x, gr * lv.y, gr * lv.z, gr * lv.w);
        }
    } else {
        for (int64_t i = lane; i < event; i += 32) {
            const float lv = logits[base + i];
            dl[base + i] = gr * (x[base + i] - sigmoid(lv));
            if (dx) dx[base + i] = gr * lv;
        }
    }
}

unsigned blocks_for(int64_t rows) {
    return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" int apv_bernoulli(const float* x, const float* logits, float* out,
                             int64_t rows, int64_t event, void* stream) {
    if (rows <= 0) return 0;
    const bool vec = event % 4 == 0 && apv::aligned16(x) && apv::aligned16(logits);
    bernoulli_rows<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, logits, out, rows, event, vec);
    return apv::launch_status();
}

// dx may be null: then only dl is written.
extern "C" int apv_bernoulli_bwd(const float* g, const float* x,
                                 const float* logits, float* dx, float* dl,
                                 int64_t rows, int64_t event, void* stream) {
    if (rows <= 0) return 0;
    const bool vec = event % 4 == 0 && apv::aligned16(x) && apv::aligned16(logits)
                     && apv::aligned16(dl) && (dx == nullptr || apv::aligned16(dx));
    bernoulli_bwd_rows<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        g, x, logits, dx, dl, rows, event, vec);
    return apv::launch_status();
}
