// Per-row discretized-logistic reconstruction log-likelihood and its
// backward.
//
// Replaces apv_tpu/ops/kernels.py::_disc_logistic_fwd (Pallas kernel
// _disc_logistic_kernel / _disc_logistic_elem). For each row r:
//     out[r] = sum_e log P(x[r,e] | mean[r,e], log_scale[r,e])
// with bin 1/255, edge bins that integrate the tails, the two-branch stable
// log(expm1(t)) and float32 arithmetic throughout.
//
// Bound on an H100: memory. At the IWAE shape [1600, 3072] the three inputs
// are 59.0 MB, ~17.6 us at 3.35 TB/s; the ~8 transcendentals per element
// keep the SFU busy for a comparable time, so both are near the limit.
// Design: one block of 256 threads per row, float4 loads (16 B per thread,
// neighbouring threads on neighbouring addresses) when the row length is a
// multiple of 4, a scalar tail for any other length, the sum kept in
// registers and reduced by warp shuffles and one shared-memory pass. Each
// input byte is read once and only [rows] floats are written.
//
// Backward: disc_logistic_bwd_rows replaces
// apv_tpu/ops/kernels.py::_disc_logistic_bwd, the hand-derived custom_vjp
// rule, copied term for term. With a = (x-mu+h)/s, b = (x-mu-h)/s, t = bin/s:
//     interior:  dmu = -(1 - sig(b) - sig(a))/s
//                dls = a*sig(a) - b*(1 - sig(b)) - t/(1 - e^-t)
//                      (the t-term is 1 + t/2 for t <= 1e-4, as the rule's)
//     low edge:  dmu = -sig(-a)/s,  dls = -a*sig(-a)
//     high edge: dmu =  sig(b)/s,   dls =  b*sig(b)
// with the edges decided on x (x <= h, x >= 1 - h), then dmean = g[r]*dmu,
// dlog_scale = g[r]*dls and, only when asked, dx = -g[r]*dmu. The training
// path's x is data and needs no dx.
// Bound on an H100: memory. Without dx it reads x, mean, log_scale and
// writes two outputs, 20 bytes per element: 15.7 MB at the train step's
// [256, 3072], 4.70 us at 3.35 TB/s; its ~30 operations per element take
// 0.35 us at 67 TFLOP/s f32. Design: the forward's layout, one 256-thread
// block per row (g[r] read once per block, no index divided), float4 loads
// and stores when the row length is a multiple of 4 and every pointer is
// 16-byte aligned, a scalar loop otherwise.
//
// Compiled without --use_fast_math: __expf/__logf would lose the t -> 0
// branch of log(expm1(t)), and expm1f keeps the t-term exact near 1e-4.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float softplus(float v) {
    return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// Elementwise log pmf; mirrors apv_tpu/ops/kernels.py::_disc_logistic_elem.
__device__ __forceinline__ float elem(float x, float mu, float ls, float bin,
                                      float half, float lo_edge, float hi_edge) {
    const float inv_s = expf(-ls);
    const float a = (x - mu + half) * inv_s;
    const float b = (x - mu - half) * inv_s;
    if (x <= lo_edge) return -softplus(-a);
    if (x >= hi_edge) return -softplus(b);
    const float t = bin * inv_s;
    const float log_expm1_t = t > 1e-3f
        ? t + log1pf(-expf(-t))
        : logf(fmaxf(t, 1e-20f)) + log1pf(0.5f * t);
    return b + log_expm1_t - softplus(a) - softplus(b);
}

__global__ void __launch_bounds__(kThreads)
disc_logistic_rows(const float* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ log_scale, float* __restrict__ out,
                   int64_t event, float bin) {
    const int64_t row = blockIdx.x;
    const float* xr = x + row * event;
    const float* mr = mean + row * event;
    const float* sr = log_scale + row * event;
    const float half = 0.5f * bin;
    const float lo_edge = 0.0f + half;
    const float hi_edge = 1.0f - half;

    float acc = 0.0f;
    // Rows start 16-byte aligned when event % 4 == 0 (allocations are
    // 256-byte aligned): take the float4 path over the whole row then.
    const int64_t n4 = (event % 4 == 0) ? event / 4 : 0;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    const float4* s4 = reinterpret_cast<const float4*>(sr);
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
        const float4 xv = x4[i], mv = m4[i], sv = s4[i];
        acc += elem(xv.x, mv.x, sv.x, bin, half, lo_edge, hi_edge);
        acc += elem(xv.y, mv.y, sv.y, bin, half, lo_edge, hi_edge);
        acc += elem(xv.z, mv.z, sv.z, bin, half, lo_edge, hi_edge);
        acc += elem(xv.w, mv.w, sv.w, bin, half, lo_edge, hi_edge);
    }
    for (int64_t i = 4 * n4 + threadIdx.x; i < event; i += kThreads)
        acc += elem(xr[i], mr[i], sr[i], bin, half, lo_edge, hi_edge);

    acc = apv::block_sum<kThreads>(acc);
    if (threadIdx.x == 0) out[row] = acc;
}

// sigmoid as 1 / (1 + e^-v), the form PyTorch's and XLA's logistic use.
__device__ __forceinline__ float sigmoid(float v) {
    return 1.0f / (1.0f + expf(-v));
}

// Elementwise gradient of the log pmf in (mean, log_scale); mirrors
// apv_tpu/ops/kernels.py::_disc_logistic_bwd.
__device__ __forceinline__ void elem_bwd(float x, float mu, float ls, float bin,
                                         float half, float lo_edge, float hi_edge,
                                         float& dmu, float& dls) {
    const float inv_s = expf(-ls);
    const float a = (x - mu + half) * inv_s;
    const float b = (x - mu - half) * inv_s;
    if (x <= lo_edge) {
        const float s = sigmoid(-a);
        dmu = -inv_s * s;
        dls = -a * s;
        return;
    }
    if (x >= hi_edge) {
        const float s = sigmoid(b);
        dmu = inv_s * s;
        dls = b * s;
        return;
    }
    const float t = bin * inv_s;
    const float sa = sigmoid(a), sb = sigmoid(b);
    dmu = -inv_s * (1.0f - sb - sa);
    const float t_term = t > 1e-4f ? t / -expm1f(-t) : 1.0f + 0.5f * t;
    dls = a * sa - b * (1.0f - sb) - t_term;
}

__global__ void __launch_bounds__(kThreads)
disc_logistic_bwd_rows(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ log_scale, float* __restrict__ dx,
                       float* __restrict__ dmean, float* __restrict__ dls,
                       int64_t event, float bin, bool vec) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) * event;
    const float gr = g[blockIdx.x];
    const float half = 0.5f * bin;
    const float lo_edge = 0.0f + half;
    const float hi_edge = 1.0f - half;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(x + base);
        const float4* m4 = reinterpret_cast<const float4*>(mean + base);
        const float4* s4 = reinterpret_cast<const float4*>(log_scale + base);
        float4* dm4 = reinterpret_cast<float4*>(dmean + base);
        float4* ds4 = reinterpret_cast<float4*>(dls + base);
        float4* dx4 = dx ? reinterpret_cast<float4*>(dx + base) : nullptr;
        for (int64_t i = threadIdx.x; i < event / 4; i += kThreads) {
            const float4 xv = x4[i], mv = m4[i], sv = s4[i];
            float4 dm, ds;
            elem_bwd(xv.x, mv.x, sv.x, bin, half, lo_edge, hi_edge, dm.x, ds.x);
            elem_bwd(xv.y, mv.y, sv.y, bin, half, lo_edge, hi_edge, dm.y, ds.y);
            elem_bwd(xv.z, mv.z, sv.z, bin, half, lo_edge, hi_edge, dm.z, ds.z);
            elem_bwd(xv.w, mv.w, sv.w, bin, half, lo_edge, hi_edge, dm.w, ds.w);
            dm4[i] = make_float4(gr * dm.x, gr * dm.y, gr * dm.z, gr * dm.w);
            ds4[i] = make_float4(gr * ds.x, gr * ds.y, gr * ds.z, gr * ds.w);
            if (dx4) dx4[i] = make_float4(-gr * dm.x, -gr * dm.y, -gr * dm.z, -gr * dm.w);
        }
    } else {
        for (int64_t i = threadIdx.x; i < event; i += kThreads) {
            float dm, ds;
            elem_bwd(x[base + i], mean[base + i], log_scale[base + i], bin, half,
                     lo_edge, hi_edge, dm, ds);
            dmean[base + i] = gr * dm;
            dls[base + i] = gr * ds;
            if (dx) dx[base + i] = -gr * dm;
        }
    }
}

}  // namespace

extern "C" int apv_disc_logistic(const float* x, const float* mean,
                                 const float* log_scale, float* out,
                                 int64_t rows, int64_t event, float bin_size,
                                 void* stream) {
    if (rows <= 0) return 0;
    disc_logistic_rows<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, mean, log_scale, out, event, bin_size);
    return apv::launch_status();
}

// dx may be null: then only dmean and dlog_scale are written.
extern "C" int apv_disc_logistic_bwd(const float* g, const float* x,
                                     const float* mean, const float* log_scale,
                                     float* dx, float* dmean, float* dls,
                                     int64_t rows, int64_t event, float bin_size,
                                     void* stream) {
    if (rows <= 0) return 0;
    const bool vec = event % 4 == 0 && apv::aligned16(x) && apv::aligned16(mean)
                     && apv::aligned16(log_scale) && apv::aligned16(dmean) && apv::aligned16(dls)
                     && (dx == nullptr || apv::aligned16(dx));
    disc_logistic_bwd_rows<<<static_cast<unsigned>(rows), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        g, x, mean, log_scale, dx, dmean, dls, event, bin_size, vec);
    return apv::launch_status();
}
