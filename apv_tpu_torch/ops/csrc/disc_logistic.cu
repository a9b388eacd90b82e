// Per-row discretized-logistic reconstruction log-likelihood and its
// backward.
//
// Replaces apv_tpu/ops/kernels.py::_disc_logistic_fwd (Pallas kernel
// _disc_logistic_kernel / _disc_logistic_elem). For each row r of the
// parameters [rows, E]:
//     out[r] = sum_e log P(x[r % x_rows, e] | mean[r,e], log_scale[r,e])
// with bin 1/255, edge bins that integrate the tails, the two-branch stable
// log(expm1(t)) and float32 arithmetic throughout. x holds x_rows distinct
// rows (x_rows divides rows): on the IWAE and OOD paths one image is scored
// under S posterior samples, rows = S * B, and parameter row r reads image
// r % B, the order of x.expand(S, B, E).reshape(S * B, E). x_rows = rows is
// the unbroadcast call of the train step.
//
// Bound on an H100: memory. mean and log_scale are read once, x once per
// image: at the OOD chunk [3200, 3072] with x [64, 3072] that is 79.4 MB,
// 23.7 us at 3.35 TB/s. The first design spent ~140 instructions an
// element (seven libm calls), enough issue to hold it at 54.5 us there;
// this one is still held by issue, mostly expf and expm1f, kept exact.
// Design:
//  * arithmetic: softplus(a) + softplus(b) = max(a,0) + max(b,0)
//    + log((1 + e^-|a|)(1 + e^-|b|)), and with a = b + t the interior log
//    pmf is min(a,0) - max(b,0) + log((1 - e^-t) / ((1 + e^-|a|)(1 + e^-|b|))):
//    one accurate expf (1/s), two ex2.approx, one expm1f, one approximate
//    divide and one lg2.approx an element; the edge bins take the same log
//    with their one factor. The t <= 1e-3 branch keeps the reference's
//    libm series. Each approximate intrinsic's range and error are stated
//    where it is used.
//  * grid: a block a row (no atomics; a fixed reduction order, the same
//    bits on every call), x's row found by one 32-bit remainder a block and
//    served from L2 to the S blocks that share it. float4 loads when E % 4
//    == 0 and the pointers are 16-byte aligned, a scalar loop otherwise.
//    Block size by the entry point: at >= 1024 rows a thread takes ~3 float4
//    (256 threads at E = 3072, up to six blocks an SM); below, one float4 a
//    thread (768 at E = 3072) so that the train step's 256 rows still give
//    ~46 warps an SM.
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
// path's x is data and needs no dx. The backward takes x at [rows, E].
// Bound on an H100: memory. Without dx it reads x, mean, log_scale and
// writes two outputs, 20 bytes per element: 15.7 MB at the train step's
// [256, 3072], 4.70 us at 3.35 TB/s; its ~30 operations per element take
// 0.35 us at 67 TFLOP/s f32. Design: one 256-thread block per row (g[r]
// read once per block, no index divided), float4 loads and stores when the
// row length is a multiple of 4 and every pointer is 16-byte aligned, a
// scalar loop otherwise.
//
// Compiled without --use_fast_math: the intrinsics are chosen one by one,
// and expf, expm1f and the small-t series stay libm's.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // the backward's block
constexpr int kMaxThreads = 768;   // the forward's largest block

// Elementwise log pmf; computes apv_tpu/ops/kernels.py::_disc_logistic_elem.
__device__ __forceinline__ float elem(float x, float mu, float ls, float bin,
                                      float half, float lo_edge, float hi_edge) {
    const float inv_s = expf(-ls);
    const float a = (x - mu + half) * inv_s;
    const float b = (x - mu - half) * inv_s;
    // __expf is ex2.approx of v * log2(e): at most 2 + 1.173|v| ulp of
    // e^v (CUDA C Programming Guide), so for v = -|a| <= 0 the absolute
    // error of e^v in (0, 1] stays below 2^-23. These enter only as the
    // factors 1 + e^v of the log's denominator: error below 1.2e-7 in it.
    const float ea = __expf(-fabsf(a));
    const float eb = __expf(-fabsf(b));
    float lin, num, den;
    if (x <= lo_edge) {          // log sig(a) = min(a,0) - log(1 + e^-|a|)
        lin = fminf(a, 0.0f);
        num = 1.0f;
        den = 1.0f + ea;
    } else if (x >= hi_edge) {   // log(1 - sig(b)) = -max(b,0) - log(1 + e^-|b|)
        lin = -fmaxf(b, 0.0f);
        num = 1.0f;
        den = 1.0f + eb;
    } else {
        // b + log(e^t - 1) - softplus(a) - softplus(b), a = b + t
        lin = fminf(a, 0.0f) - fmaxf(b, 0.0f);
        den = (1.0f + ea) * (1.0f + eb);
        const float t = bin * inv_s;
        if (t <= 1e-3f)          // the reference's series for log(e^t - 1)
            return lin + (logf(fmaxf(t, 1e-20f)) + log1pf(0.5f * t) - t) - logf(den);
        num = -expm1f(-t);       // 1 - e^-t without cancellation
    }
    // num in [1e-3, 1], den in [1, 4]: __fdividef is within 2 ulp there, and
    // q = num / den lies in [2.5e-4, 1]. __logf is lg2.approx times ln 2:
    // absolute error at most 2^-21.41 on [0.5, 2] and 3 ulp of |log q| <= 8.3
    // below it, so at most 3e-6 an element (9e-3 over a row of 3072, within
    // the 1e-2 that chip_smoke.py allows a row sum).
    return lin + __logf(__fdividef(num, den));
}

// One block a row; blockDim.x (a multiple of 32, at most kMaxThreads) is
// the entry point's choice. vec: the float4 route.
__global__ void __launch_bounds__(kMaxThreads, 2)
disc_logistic_rows(const float* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ log_scale, float* __restrict__ out,
                   int event, unsigned x_rows, float bin, bool vec) {
    const int64_t base = static_cast<int64_t>(blockIdx.x) * event;
    const float* xr = x + static_cast<int64_t>(blockIdx.x % x_rows) * event;
    const float* mr = mean + base;
    const float* sr = log_scale + base;
    const float half = 0.5f * bin;
    const float lo_edge = 0.0f + half;
    const float hi_edge = 1.0f - half;

    float acc = 0.0f;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* m4 = reinterpret_cast<const float4*>(mr);
        const float4* s4 = reinterpret_cast<const float4*>(sr);
        for (int i = threadIdx.x; i < event / 4; i += blockDim.x) {
            const float4 xv = x4[i], mv = m4[i], sv = s4[i];
            acc += elem(xv.x, mv.x, sv.x, bin, half, lo_edge, hi_edge)
                 + elem(xv.y, mv.y, sv.y, bin, half, lo_edge, hi_edge)
                 + elem(xv.z, mv.z, sv.z, bin, half, lo_edge, hi_edge)
                 + elem(xv.w, mv.w, sv.w, bin, half, lo_edge, hi_edge);
        }
    } else {
        for (int i = threadIdx.x; i < event; i += blockDim.x)
            acc += elem(xr[i], mr[i], sr[i], bin, half, lo_edge, hi_edge);
    }
    acc = apv::block_sum(acc);
    if (threadIdx.x == 0) out[blockIdx.x] = acc;
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

// x holds x_rows rows, x_rows dividing rows; parameter row r reads x row
// r % x_rows.
extern "C" int apv_disc_logistic(const float* x, const float* mean,
                                 const float* log_scale, float* out,
                                 int64_t rows, int64_t event, int64_t x_rows,
                                 float bin_size, void* stream) {
    if (rows <= 0) return 0;
    if (x_rows <= 0 || rows % x_rows != 0 || rows > INT32_MAX || event > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = event % 4 == 0 && apv::aligned16(x) && apv::aligned16(mean)
                     && apv::aligned16(log_scale);
    const int64_t units = vec ? event / 4 : event;
    const int64_t per = rows >= 1024 ? 3 : 1;          // units a thread
    const int64_t threads = std::clamp<int64_t>(
        ((units + per - 1) / per + 31) / 32 * 32, 32, kMaxThreads);
    disc_logistic_rows<<<static_cast<unsigned>(rows), static_cast<unsigned>(threads), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, mean, log_scale, out, static_cast<int>(event),
        static_cast<unsigned>(x_rows), bin_size, vec);
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
