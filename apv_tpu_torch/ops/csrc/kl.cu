// Per-row analytic KL( N(mean, exp(logvar)) || N(0, I) ).
//
// Replaces apv_tpu/ops/kernels.py::_kl_fwd (Pallas kernel _kl_kernel):
//     out[r] = sum_z 0.5 * (mean^2 + exp(logvar) - 1 - logvar)
//
// Bound on an H100: the launch. At the train step's [256, 128] the inputs
// are 131 KB, ~0.04 us of memory time, while a launch of any kernel costs
// the card ~1.1-1.3 us (the launch floor in PERF.md); this kernel takes
// ~1.8 us. A redesign of the kernel alone cannot remove the launch, so the
// ELBO paths, which draw z from the same mean and logvar, no longer launch
// it: reparam.cu's forward runs these rows in its own launch (its KL
// blocks) and its backward adds this file's gradient terms in its own
// launch. These two kernels stay for the callers of kl alone (the serving
// artifacts' apv::kl and ops.kl_standard). Design: one warp per row (8
// rows per 256-thread block), coalesced loads striding by 32, and a
// shuffle reduction with no shared memory; the terms are kl_terms.cuh's,
// shared with reparam.cu, so both give the same bits.
//
// Backward: replaces apv_tpu/ops/kernels.py::_kl_bwd, the custom_vjp rule
// (dmean, dlogvar) = (g * mean, g * 0.5 * (exp(logvar) - 1)), g per row.
#include "kl_terms.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
kl_rows(const float* __restrict__ mean, const float* __restrict__ logvar,
        float* __restrict__ out, int64_t rows, int64_t event) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;  // whole warps leave together
    const float acc = apv::kl_row_sum(mean + row * event, logvar + row * event,
                                      event, lane);
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
        dmean[base + i] = apv::kl_dmean(gr, mean[base + i]);
        dlogvar[base + i] = apv::kl_dlogvar(gr, logvar[base + i]);
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
