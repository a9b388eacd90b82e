// Per-row analytic KL( N(mean, exp(logvar)) || N(0, I) ).
//
// Replaces apv_tpu/ops/kernels.py::_kl_fwd (Pallas kernel _kl_kernel):
//     out[r] = sum_z 0.5 * (mean^2 + exp(logvar) - 1 - logvar)
//
// Bound on an H100: launch latency. At the scorer's [64, 128] the inputs
// are 65.5 KB, ~20 ns of memory time, far below the few microseconds a
// launch costs, so the design only keeps the work to one pass: one warp per
// row (8 rows per 256-thread block), coalesced loads striding by 32, and a
// shuffle reduction with no shared memory. Fusing it into the encoder head
// is the way to remove the launch, in a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
kl_rows(const float* __restrict__ mean, const float* __restrict__ logvar,
        float* __restrict__ out, int64_t rows, int64_t event) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;  // whole warps leave together
    const float* m = mean + row * event;
    const float* lv = logvar + row * event;
    float acc = 0.0f;
    for (int64_t i = lane; i < event; i += 32) {
        const float mu = m[i], l = lv[i];
        acc += 0.5f * (mu * mu + expf(l) - 1.0f - l);
    }
    acc = apv::warp_sum(acc);
    if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kThreads)
kl_bwd_rows(const float* __restrict__ g, const float* __restrict__ mean,
            const float* __restrict__ logvar, float* __restrict__ dmean,
            float* __restrict__ dlogvar, int64_t rows, int64_t event) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const float gr = g[row];
    const int64_t base = row * event;
    for (int64_t i = lane; i < event; i += 32) {
        dmean[base + i] = gr * mean[base + i];
        dlogvar[base + i] = gr * 0.5f * (expf(logvar[base + i]) - 1.0f);
    }
}

}  // namespace

extern "C" int apv_kl(const float* mean, const float* logvar, float* out,
                      int64_t rows, int64_t event, void* stream) {
    if (rows <= 0) return 0;
    const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    kl_rows<<<static_cast<unsigned>(blocks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(mean, logvar, out, rows, event);
    return apv::launch_status();
}

extern "C" int apv_kl_bwd(const float* g, const float* mean, const float* logvar,
                          float* dmean, float* dlogvar, int64_t rows,
                          int64_t event, void* stream) {
    if (rows <= 0) return 0;
    const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    kl_bwd_rows<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(g, mean, logvar, dmean,
                                                       dlogvar, rows, event);
    return apv::launch_status();
}
