// The per-element terms of KL( N(mean, exp(logvar)) || N(0, I) ) and of its
// gradient, shared by kl.cu (the standalone kernels) and reparam.cu (the
// launches that fold the KL into the reparameterization), so that both
// compile the same expressions and give the same bits.
#pragma once

#include "common.cuh"

namespace apv {

// One warp sums one row of `event` elements: lane-strided terms
// 0.5 * (mu^2 + e^lv - 1 - lv), then warp_sum. Lane 0 holds the row's KL.
__device__ __forceinline__ float kl_row_sum(const float* __restrict__ m,
                                            const float* __restrict__ lv,
                                            int64_t event, int lane) {
    float acc = 0.0f;
    for (int64_t i = lane; i < event; i += 32) {
        const float mu = m[i], l = lv[i];
        acc += 0.5f * (mu * mu + expf(l) - 1.0f - l);
    }
    return warp_sum(acc);
}

// The gradient of g * KL in one element: d/dmean = g * mu and
// d/dlogvar = (g * 0.5) * (e^lv - 1), each product rounded on its own
// (no contraction into an FMA).
__device__ __forceinline__ float kl_dmean(float g, float mu) {
    return __fmul_rn(g, mu);
}

__device__ __forceinline__ float kl_dlogvar(float g, float lv) {
    return __fmul_rn(__fmul_rn(g, 0.5f), __fadd_rn(expf(lv), -1.0f));
}

}  // namespace apv
