// 3x3 SAME stride-1 convolution, NHWC x and HWIO w, bf16 or f32 in, f32
// accumulation and f32 out.
//
// Replaces scripts/conv_microbench.py::pallas_conv (Pallas kernel
// _pallas_kernel), the probe's hand-written contender: the conv as nine
// shifted [tb*H*W, Cin] x [Cin, Cout] dots accumulated in VMEM, out in f32.
//
// Here it is one implicit GEMM: out[m, n] = sum_k A[m, k] * Wf[k, n] with
// m = (b, h, w) an output pixel, k = (ky*3 + kx)*Cin + ci, A[m, k] =
// x[b, h+ky-1, w+kx-1, ci] (zero outside the image) gathered on the fly, and
// Wf = w viewed as [9*Cin, Cout] (HWIO is already that matrix). Tiles of
// 128 pixels x 64 output channels per 256-thread block, the K axis walked
// 16 at a time through shared memory (A stored k-major with padding, so the
// compute loop reads 8 pixels and 4 channels per k as broadcasts and float4s),
// 8 x 4 outputs per thread in registers, f32 FMAs. bf16 inputs are widened
// to f32 on their way into shared memory: products are exact and the sums
// f32, as the Pallas kernel's preferred_element_type=f32.
//
// Bound on an H100: operations. At the probe's shapes (B, H, W, Cin, Cout)
// 2*9*Cin FLOPs per output: 19.3 GFLOP at each shape, 19.5 us at 989 TFLOP/s
// on the bf16 tensor cores; at [256,32,32,64,64] the bytes (bf16 x and w in,
// f32 out) are 100.7 MB, 30.1 us at 3.35 TB/s. This kernel uses the f32
// units (67 TFLOP/s, 288 us at best), no tensor cores, no cp.async or TMA
// and no double buffering: it is the simple correct kernel, and cuDNN beats
// it; wgmma with TMA-fed tiles is the later design.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;   // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // K step through shared memory
constexpr int TM = 8;     // pixels per thread
constexpr int TN = 4;     // channels per thread
constexpr int kPadA = 4;  // A tile row padding: stores spread over banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_igemm(const T* __restrict__ x, const T* __restrict__ w,
              float* __restrict__ out, int batch, int h, int wd, int cin,
              int cout) {
    __shared__ float As[BK][BM + kPadA];
    __shared__ __align__(16) float Bs[BK][BN];

    const int64_t m_total = static_cast<int64_t>(batch) * h * wd;
    const int k_total = 9 * cin;
    const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
    const int n0 = blockIdx.x * BN;
    const int t = threadIdx.x;

    // A loads: thread t takes k = t % BK of pixels t / BK + 16*i, i < 8, so
    // 16 neighbouring threads read 16 neighbouring channels of one pixel.
    const int a_k = t % BK;
    const int a_m = t / BK;
    int a_b[BM / 16], a_h[BM / 16], a_w[BM / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
        const int64_t m = m0 + a_m + 16 * i;
        if (m < m_total) {
            a_b[i] = static_cast<int>(m / (static_cast<int64_t>(h) * wd));
            const int r = static_cast<int>(m - static_cast<int64_t>(a_b[i]) * h * wd);
            a_h[i] = r / wd;
            a_w[i] = r - a_h[i] * wd;
        } else {
            a_b[i] = -1;
            a_h[i] = a_w[i] = 0;
        }
    }
    // B loads: thread t takes n = t % BN of rows t / BN + 4*i, i < 4.
    const int b_n = t % BN;
    const int b_k = t / BN;

    const int tm = t / (BN / TN);   // 0..15: pixels tm*8 .. tm*8+7
    const int tn = t % (BN / TN);   // 0..15: channels tn*4 .. tn*4+3
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < k_total; k0 += BK) {
        const int k = k0 + a_k;
        int tap = 0, ci = 0, dy = 0, dx = 0;
        const bool k_ok = k < k_total;
        if (k_ok) {
            tap = k / cin;
            ci = k - tap * cin;
            dy = tap / 3 - 1;
            dx = tap % 3 - 1;
        }
#pragma unroll
        for (int i = 0; i < BM / 16; ++i) {
            float v = 0.0f;
            const int ih = a_h[i] + dy, iw = a_w[i] + dx;
            if (k_ok && a_b[i] >= 0 && ih >= 0 && ih < h && iw >= 0 && iw < wd) {
                const int64_t idx =
                    ((static_cast<int64_t>(a_b[i]) * h + ih) * wd + iw) * cin + ci;
                v = to_f32(x[idx]);
            }
            As[a_k][a_m + 16 * i] = v;
        }
#pragma unroll
        for (int i = 0; i < BK / (kThreads / BN); ++i) {
            const int kk = k0 + b_k + (kThreads / BN) * i;
            const int n = n0 + b_n;
            Bs[b_k + (kThreads / BN) * i][b_n] =
                (kk < k_total && n < cout) ? to_f32(w[static_cast<int64_t>(kk) * cout + n]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][tm * TM + i];
            const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tn * TN]);
            bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int64_t m = m0 + tm * TM + i;
        if (m >= m_total) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tn * TN + j;
            if (n < cout) out[m * cout + n] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" int apv_conv3x3(const void* x, const void* w, float* out,
                           int64_t batch, int64_t h, int64_t wd, int64_t cin,
                           int64_t cout, int is_bf16, void* stream) {
    const int64_t m_total = batch * h * wd;
    if (m_total <= 0 || cout <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>((cout + BN - 1) / BN),
                    static_cast<unsigned>((m_total + BM - 1) / BM));
    if (is_bf16) {
        conv3x3_igemm<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w), out, static_cast<int>(batch),
            static_cast<int>(h), static_cast<int>(wd), static_cast<int>(cin),
            static_cast<int>(cout));
    } else {
        conv3x3_igemm<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), out,
            static_cast<int>(batch), static_cast<int>(h), static_cast<int>(wd),
            static_cast<int>(cin), static_cast<int>(cout));
    }
    return apv::launch_status();
}
