// RMSNorm over the channels of NHWC rows, followed by the activation,
// forward and backward, one launch each way.
//
// Replaces no TPU kernel: in apv_tpu, flax's nn.RMSNorm and the activation
// after it (models/resnet_vae.py, norm="rms") are jnp code that XLA fuses
// into its neighbours (apv_tpu/utils/config.py). The port ran the same
// chain as about nine eager PyTorch kernels on float32 copies of a bf16
// tensor, each reading and writing the whole activation; at the IWAE
// chunk they took two thirds of the device's time (PERF.md).
//
// For x [rows, C] (bf16 or f32, one pixel a row) and w [C] (f32):
//     ms   = mean_C(x32^2)                          float32
//     rstd = 1 / sqrt(ms + eps)
//     n    = round_T(x32 * (rstd * w))              the norm, in x's dtype
//     y    = round_T(act(n))                        act in float32 from n
// These are the plain chain's rounding points, so y equals it except where
// the order of the channel sum moves ms by a rounding. The per-row rstd
// (f32) is written only when asked for (autograd's residual). The
// activation is a template argument: every entry of models/common.py's
// ACTIVATIONS, each as PyTorch computes it (gelu_sigmoid's three eager ops
// with their two roundings in between).
//
// Backward, from x, dy and rstd, n and act'(n) recomputed in registers:
//     d    = dy * act'(n),  g = d * w,  xh = x32 * rstd
//     dx   = rstd * (g - xh * mean_C(g * xh))       x's dtype
//     dw   = sum_rows d * xh                        f32
// dw is deterministic, with no float atomics: per-block partials [blocks,
// C] summed in a fixed order, then rmsnorm_act_param_sum adds the blocks'
// rows of each column, one warp a column, in a fixed order. The grid is
// fixed by the shape and the card, so two calls give the same bits.
//
// Bound on an H100: bytes. The forward reads x and writes y once, 4 bytes
// an element in bf16: at the IWAE chunk's stage 3 [1600*1024, 64] that is
// 419 MB, 125 us at 3.35 TB/s, against ~30 f32 operations an element (the
// activation's exp and division included), 50 us at 67 TFLOP/s. The
// backward reads x and dy and writes dx, 6 bytes an element in bf16.
// Design: the vector path (C = 8 * L with L lanes a row, L a power of two
// up to 32: C = 8 ... 256) gives each lane 8 channels, read in 16-byte
// loads (one for bf16, two for f32), w's 8 values held in registers, and
// sums a row's squares by shuffles within its group of L lanes: one warp a
// row at C = 256, 2 and 4 rows a warp at C = 128 and 64. No shared memory
// in the forward, and nothing but x in and y out crosses device memory.
// Blocks are persistent (as many as are resident) and stride over the
// rows. Other widths, or tensors off 16-byte alignment, take the scalar
// variant (one warp a row, each lane every 32nd channel, x read twice);
// the entry points report which of the two ran.
#include <cuda_bf16.h>

#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 8;                        // channels a lane, vector path
constexpr float kBeta = 0.7978845608028654f;     // sqrt(2 / pi), as PyTorch's gelu
constexpr float kKappa = 0.044715f;
constexpr float kSigmoidGelu = 1.702f;
constexpr float kLeakySlope = 0.2f;

// models/common.py's ACTIVATIONS, in ops/kernels.py's RMS_ACTIVATIONS order.
enum Act : int { kSilu = 0, kGeluTanh = 1, kGeluSigmoid = 2, kRelu = 3, kLeakyRelu = 4 };

// The kernel an entry point launched, as it reports it.
enum Route : int { kVector = 0, kScalar = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as PyTorch casts
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
    return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// act(a) in f32 from a = the rounded norm; rounded to T by the caller's
// store. Each as PyTorch's CUDA op computes it in its float math type.
template <int A, typename T>
__device__ __forceinline__ float act_fwd(float a) {
    if constexpr (A == kSilu) {
        return a / (1.0f + expf(-a));
    } else if constexpr (A == kGeluTanh) {
        const float inner = kBeta * (a + kKappa * (a * a * a));
        return 0.5f * a * (1.0f + tanhf(inner));
    } else if constexpr (A == kGeluSigmoid) {
        // x * sigmoid(1.702 * x): three eager ops, each rounded to T
        const float t = round_to<T>(a * kSigmoidGelu);
        return a * round_to<T>(sigmoid(t));
    } else if constexpr (A == kRelu) {
        return a > 0.0f ? a : 0.0f;
    } else {
        return a > 0.0f ? a : a * kLeakySlope;
    }
}

// act'(a), the derivative autograd takes through the activation.
template <int A>
__device__ __forceinline__ float act_grad(float a) {
    if constexpr (A == kSilu) {
        const float s = sigmoid(a);
        return s * (1.0f + a * (1.0f - s));
    } else if constexpr (A == kGeluTanh) {
        const float a2 = a * a;
        const float th = tanhf(kBeta * (a + kKappa * a2 * a));
        return 0.5f * (1.0f + th) +
               0.5f * a * (1.0f - th * th) * kBeta * (1.0f + 3.0f * kKappa * a2);
    } else if constexpr (A == kGeluSigmoid) {
        const float s = sigmoid(kSigmoidGelu * a);
        return s + a * kSigmoidGelu * s * (1.0f - s);
    } else if constexpr (A == kRelu) {
        return a > 0.0f ? 1.0f : 0.0f;
    } else {
        return a > 0.0f ? 1.0f : kLeakySlope;
    }
}

// A lane's 8 channels: one 16-byte load for bf16, two for f32.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float (&v)[kElems]) {
    constexpr int kWords = kElems * sizeof(T) / 16;
    uint4 raw[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < kElems; ++i) v[i] = to_f32<T>(e[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, const float (&v)[kElems]) {
    constexpr int kWords = kElems * sizeof(T) / 16;
    uint4 raw[kWords];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int i = 0; i < kElems; ++i) e[i] = from_f32<T>(v[i]);
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(p)[i] = raw[i];
}

// Sum over an aligned group of `lanes` lanes (a power of two up to 32),
// every lane of the warp taking part; each lane of the group gets it.
__device__ __forceinline__ float group_sum(float v, int lanes) {
    for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(apv::kFullMask, v, off);
    return v;
}

// Vector path: `lanes` lanes a row (log2 given), 8 channels a lane, blocks
// striding over the rows kThreads / lanes at a time. A lane past the last
// row computes on zeros, so every lane of a warp reaches every shuffle.
template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
rmsnorm_act_rows(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                 float* __restrict__ rstd_out, int64_t rows, int log2_lanes, float eps) {
    const int lanes = 1 << log2_lanes;
    const int c = kElems * lanes;
    const int rows_per_block = kThreads >> log2_lanes;
    const int q = threadIdx.x & (lanes - 1);  // channels q*8 .. q*8+7
    const int slot = threadIdx.x >> log2_lanes;
    float wv[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) wv[i] = w[q * kElems + i];
    const float inv_c = 1.0f / static_cast<float>(c);  // C a power of two: exact
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows_per_block; base < rows;
         base += static_cast<int64_t>(gridDim.x) * rows_per_block) {
        const int64_t row = base + slot;
        const bool valid = row < rows;
        float v[kElems];
        if (valid) {
            load8<T>(x + row * c + q * kElems, v);
        } else {
#pragma unroll
            for (int i = 0; i < kElems; ++i) v[i] = 0.0f;
        }
        float ss = 0.0f;
#pragma unroll
        for (int i = 0; i < kElems; ++i) ss += v[i] * v[i];
        ss = group_sum(ss, lanes);
        const float rstd = 1.0f / sqrtf(ss * inv_c + eps);
        if (valid) {
            float o[kElems];
#pragma unroll
            for (int i = 0; i < kElems; ++i) {
                o[i] = act_fwd<A, T>(round_to<T>(v[i] * (rstd * wv[i])));
            }
            store8<T>(y + row * c + q * kElems, o);
            if (rstd_out != nullptr && q == 0) rstd_out[row] = rstd;
        }
    }
}

// Vector path's backward: dx for each row as the forward walks them, and
// each thread's running sum of d * xh for its 8 channels; at the end the
// block sums its row slots in slot order into part_dw[blockIdx.x, :].
template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
rmsnorm_act_bwd_rows(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ w, const float* __restrict__ rstd_in,
                     T* __restrict__ dx, float* __restrict__ part_dw, int64_t rows,
                     int log2_lanes) {
    __shared__ float red[kThreads * kElems];
    const int lanes = 1 << log2_lanes;
    const int c = kElems * lanes;
    const int rows_per_block = kThreads >> log2_lanes;
    const int q = threadIdx.x & (lanes - 1);
    const int slot = threadIdx.x >> log2_lanes;
    float wv[kElems], acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
        wv[i] = w[q * kElems + i];
        acc[i] = 0.0f;
    }
    const float inv_c = 1.0f / static_cast<float>(c);
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows_per_block; base < rows;
         base += static_cast<int64_t>(gridDim.x) * rows_per_block) {
        const int64_t row = base + slot;
        const bool valid = row < rows;
        float xv[kElems], gv[kElems];
        float r = 0.0f;
        if (valid) {
            load8<T>(x + row * c + q * kElems, xv);
            load8<T>(dy + row * c + q * kElems, gv);
            r = rstd_in[row];
        } else {
#pragma unroll
            for (int i = 0; i < kElems; ++i) xv[i] = gv[i] = 0.0f;
        }
        float gx = 0.0f;
#pragma unroll
        for (int i = 0; i < kElems; ++i) {
            const float n = round_to<T>(xv[i] * (r * wv[i]));
            const float d = gv[i] * act_grad<A>(n);
            const float xh = xv[i] * r;
            acc[i] += d * xh;
            gv[i] = d * wv[i];  // g
            xv[i] = xh;
            gx += gv[i] * xh;
        }
        const float m = group_sum(gx, lanes) * inv_c;
        if (valid) {
            float o[kElems];
#pragma unroll
            for (int i = 0; i < kElems; ++i) o[i] = r * (gv[i] - xv[i] * m);
            store8<T>(dx + row * c + q * kElems, o);
        }
    }
    // threadIdx.x * 8 + i = slot * C + q * 8 + i
#pragma unroll
    for (int i = 0; i < kElems; ++i) red[threadIdx.x * kElems + i] = acc[i];
    __syncthreads();
    for (int k = threadIdx.x; k < c; k += kThreads) {
        float t = 0.0f;
        for (int s = 0; s < rows_per_block; ++s) t += red[s * c + k];
        part_dw[static_cast<int64_t>(blockIdx.x) * c + k] = t;
    }
}

__device__ __forceinline__ float warp_allsum(float v) { return group_sum(v, 32); }

// Scalar variant, any C: one warp a row, each lane every 32nd channel; x is
// read twice (the second time from L1 or L2).
template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
rmsnorm_act_rows_scalar(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd_out, int64_t rows, int c,
                        float eps) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
         row < rows; row += static_cast<int64_t>(gridDim.x) * kWarps) {
        const T* xr = x + row * c;
        float ss = 0.0f;
        for (int k = lane; k < c; k += 32) {
            const float v = to_f32<T>(xr[k]);
            ss += v * v;
        }
        const float rstd = 1.0f / sqrtf(warp_allsum(ss) / static_cast<float>(c) + eps);
        for (int k = lane; k < c; k += 32) {
            const float n = round_to<T>(to_f32<T>(xr[k]) * (rstd * w[k]));
            y[row * c + k] = from_f32<T>(act_fwd<A, T>(n));
        }
        if (rstd_out != nullptr && lane == 0) rstd_out[row] = rstd;
    }
}

// Scalar variant's backward: dx a warp a row; then part_dw[blockIdx.x, :]
// one column a thread over the block's rows in order (x and dy read again).
template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
rmsnorm_act_bwd_rows_scalar(const T* __restrict__ dy, const T* __restrict__ x,
                            const float* __restrict__ w, const float* __restrict__ rstd_in,
                            T* __restrict__ dx, float* __restrict__ part_dw, int64_t rows,
                            int c) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
    for (int64_t row = first + (threadIdx.x >> 5); row < rows; row += stride) {
        const float r = rstd_in[row];
        float gx = 0.0f;
        for (int k = lane; k < c; k += 32) {
            const float xv = to_f32<T>(x[row * c + k]);
            const float n = round_to<T>(xv * (r * w[k]));
            gx += to_f32<T>(dy[row * c + k]) * act_grad<A>(n) * w[k] * (xv * r);
        }
        const float m = warp_allsum(gx) / static_cast<float>(c);
        for (int k = lane; k < c; k += 32) {
            const float xv = to_f32<T>(x[row * c + k]);
            const float n = round_to<T>(xv * (r * w[k]));
            const float g = to_f32<T>(dy[row * c + k]) * act_grad<A>(n) * w[k];
            dx[row * c + k] = from_f32<T>(r * (g - (xv * r) * m));
        }
    }
    for (int k = threadIdx.x; k < c; k += kThreads) {
        float t = 0.0f;
        for (int64_t row0 = first; row0 < rows; row0 += stride) {
            const int64_t end = row0 + kWarps < rows ? row0 + kWarps : rows;
            for (int64_t row = row0; row < end; ++row) {
                const float r = rstd_in[row];
                const float xv = to_f32<T>(x[row * c + k]);
                const float n = round_to<T>(xv * (r * w[k]));
                t += to_f32<T>(dy[row * c + k]) * act_grad<A>(n) * (xv * r);
            }
        }
        part_dw[static_cast<int64_t>(blockIdx.x) * c + k] = t;
    }
}

// dw[k] = sum_b part_dw[b, k]: one warp a column, lane l adds blocks l,
// l + 32, ... in order, then a shuffle tree of fixed shape.
__global__ void __launch_bounds__(kThreads)
rmsnorm_act_param_sum(const float* __restrict__ part_dw, float* __restrict__ dw,
                      int64_t blocks, int c) {
    const int k = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= c) return;  // whole warps leave together
    float t = 0.0f;
    for (int64_t b = lane; b < blocks; b += 32) t += part_dw[b * c + k];
    t = apv::warp_sum(t);
    if (lane == 0) dw[k] = t;
}

// log2(C / 8) where the vector path takes C (C = 8 * 2^j, j <= 5) and every
// tensor is 16-byte aligned, else -1.
int vector_lanes(int64_t c, std::initializer_list<const void*> tensors) {
    if (c % kElems != 0 || c > kElems * 32) return -1;
    const int64_t lanes = c / kElems;
    if ((lanes & (lanes - 1)) != 0) return -1;
    for (const void* t : tensors) {
        if (t != nullptr && !apv::aligned16(t)) return -1;
    }
    int log2 = 0;
    while ((int64_t{1} << log2) < lanes) ++log2;
    return log2;
}

// Blocks of kernel_fn resident at once on the current card (persistent
// grids), found once a kernel.
template <typename Kernel>
int64_t resident_blocks(Kernel kernel_fn) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_fn, kThreads, 0);
    return std::max<int64_t>(1, static_cast<int64_t>(sms) * per_sm);
}

template <typename T, int A>
int launch_fwd(const void* x, const float* w, void* y, float* rstd, int64_t rows, int64_t c,
               float eps, int* kernel, cudaStream_t s) {
    const auto xt = static_cast<const T*>(x);
    const auto yt = static_cast<T*>(y);
    const int log2 = vector_lanes(c, {x, w, y});
    if (log2 < 0) {
        static const int64_t resident = resident_blocks(rmsnorm_act_rows_scalar<T, A>);
        const int64_t need = (rows + kThreads / 32 - 1) / (kThreads / 32);
        *kernel = kScalar;
        rmsnorm_act_rows_scalar<T, A>
            <<<static_cast<unsigned>(std::min(need, resident)), kThreads, 0, s>>>(
                xt, w, yt, rstd, rows, static_cast<int>(c), eps);
        return apv::launch_status();
    }
    static const int64_t resident = resident_blocks(rmsnorm_act_rows<T, A>);
    const int64_t per_block = kThreads >> log2;
    const int64_t need = (rows + per_block - 1) / per_block;
    *kernel = kVector;
    rmsnorm_act_rows<T, A><<<static_cast<unsigned>(std::min(need, resident)), kThreads, 0, s>>>(
        xt, w, yt, rstd, rows, log2, eps);
    return apv::launch_status();
}

// Launches the backward on at most part_rows blocks; *blocks gets how many.
template <typename T, int A>
int launch_bwd(const void* dy, const void* x, const float* w, const float* rstd, void* dx,
               float* part_dw, int64_t part_rows, int64_t rows, int64_t c, int64_t* blocks,
               int* kernel, cudaStream_t s) {
    const auto dyt = static_cast<const T*>(dy);
    const auto xt = static_cast<const T*>(x);
    const auto dxt = static_cast<T*>(dx);
    const int log2 = vector_lanes(c, {dy, x, w, dx});
    if (log2 < 0) {
        static const int64_t resident = resident_blocks(rmsnorm_act_bwd_rows_scalar<T, A>);
        const int64_t need = (rows + kThreads / 32 - 1) / (kThreads / 32);
        *blocks = std::min({need, resident, part_rows});
        *kernel = kScalar;
        rmsnorm_act_bwd_rows_scalar<T, A><<<static_cast<unsigned>(*blocks), kThreads, 0, s>>>(
            dyt, xt, w, rstd, dxt, part_dw, rows, static_cast<int>(c));
        return apv::launch_status();
    }
    static const int64_t resident = resident_blocks(rmsnorm_act_bwd_rows<T, A>);
    const int64_t per_block = kThreads >> log2;
    const int64_t need = (rows + per_block - 1) / per_block;
    *blocks = std::min({need, resident, part_rows});
    *kernel = kVector;
    rmsnorm_act_bwd_rows<T, A><<<static_cast<unsigned>(*blocks), kThreads, 0, s>>>(
        dyt, xt, w, rstd, dxt, part_dw, rows, log2);
    return apv::launch_status();
}

template <typename T>
int dispatch_fwd(int act, const void* x, const float* w, void* y, float* rstd, int64_t rows,
                 int64_t c, float eps, int* kernel, cudaStream_t s) {
    switch (act) {
        case kSilu: return launch_fwd<T, kSilu>(x, w, y, rstd, rows, c, eps, kernel, s);
        case kGeluTanh: return launch_fwd<T, kGeluTanh>(x, w, y, rstd, rows, c, eps, kernel, s);
        case kGeluSigmoid:
            return launch_fwd<T, kGeluSigmoid>(x, w, y, rstd, rows, c, eps, kernel, s);
        case kRelu: return launch_fwd<T, kRelu>(x, w, y, rstd, rows, c, eps, kernel, s);
        case kLeakyRelu: return launch_fwd<T, kLeakyRelu>(x, w, y, rstd, rows, c, eps, kernel, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
int dispatch_bwd(int act, const void* dy, const void* x, const float* w, const float* rstd,
                 void* dx, float* part_dw, int64_t part_rows, int64_t rows, int64_t c,
                 int64_t* blocks, int* kernel, cudaStream_t s) {
#define APV_RMS_BWD(A)                                                                    \
    launch_bwd<T, A>(dy, x, w, rstd, dx, part_dw, part_rows, rows, c, blocks, kernel, s)
    switch (act) {
        case kSilu: return APV_RMS_BWD(kSilu);
        case kGeluTanh: return APV_RMS_BWD(kGeluTanh);
        case kGeluSigmoid: return APV_RMS_BWD(kGeluSigmoid);
        case kRelu: return APV_RMS_BWD(kRelu);
        case kLeakyRelu: return APV_RMS_BWD(kLeakyRelu);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef APV_RMS_BWD
}

}  // namespace

// y and (when rstd is not null) rstd [rows]; act: Act; *kernel: Route.
extern "C" int apv_rmsnorm_act(const void* x, const float* w, void* y, float* rstd,
                               int64_t rows, int64_t c, float eps, int act, int is_bf16,
                               int* kernel, void* stream) {
    if (rows <= 0 || c <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? dispatch_fwd<__nv_bfloat16>(act, x, w, y, rstd, rows, c, eps, kernel, s)
                   : dispatch_fwd<float>(act, x, w, y, rstd, rows, c, eps, kernel, s);
}

// dx and dw [c]; part_dw holds part_rows rows of c floats of scratch.
// *kernel: Route (left as it was when rows = 0).
extern "C" int apv_rmsnorm_act_bwd(const void* dy, const void* x, const float* w,
                                   const float* rstd, void* dx, float* part_dw,
                                   int64_t part_rows, float* dw, int64_t rows, int64_t c,
                                   int act, int is_bf16, int* kernel, void* stream) {
    if (c <= 0) return 0;
    if (part_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    int64_t blocks = 0;
    if (rows > 0) {
        const int status =
            is_bf16 ? dispatch_bwd<__nv_bfloat16>(act, dy, x, w, rstd, dx, part_dw, part_rows,
                                                  rows, c, &blocks, kernel, s)
                    : dispatch_bwd<float>(act, dy, x, w, rstd, dx, part_dw, part_rows, rows, c,
                                          &blocks, kernel, s);
        if (status != 0) return status;
    }
    constexpr int kCols = kThreads / 32;  // one warp per column
    const unsigned col_blocks = static_cast<unsigned>((c + kCols - 1) / kCols);
    rmsnorm_act_param_sum<<<col_blocks, kThreads, 0, s>>>(part_dw, dw, blocks,
                                                          static_cast<int>(c));
    return apv::launch_status();
}
