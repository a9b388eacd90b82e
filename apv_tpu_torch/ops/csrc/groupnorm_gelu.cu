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
// a group's statistics are block reductions.
//
// Bound on an H100: memory. bf16 x in and y out at [256, 32, 32, 64] is
// 67.1 MB, 20.0 us at 3.35 TB/s (40.1 us in f32); ~13 f32 operations per
// element take 3.3 us at 67 TFLOP/s. The first design (a block per (b, g),
// one channel a thread, 2-byte loads, three passes over the group) took
// 97.2 us in bf16 on an H100 80GB HBM3 at 700 W (PERF.md), reading each
// group's slice of every 128-byte row, the layout that also bounded the
// first backward (below). So the forward now has the backward's two paths:
// - groupnorm_gelu_image, the fast path: the cluster-per-image layout of
//   groupnorm_gelu_bwd_image (below), staging x alone, two stages in both
//   dtypes; in bf16 a block takes twice the backward's pixels (K <= 4), in
//   f32 the same (K <= 8, three blocks an SM). Each block computes every
//   group's (count, mean, M2) over its slab in two passes on chip (the
//   sum, then the squared deviations from the slab's mean), posts (mean,
//   M2) into every block of the cluster, and after one cluster barrier an
//   image each block combines the slabs in rank order with Chan's pairwise
//   formula: two-pass accuracy, the same bits in every block and on every
//   call. x is read from device memory once, and from the stage in each
//   pass (holding it in registers would cost the blocks an SM); the third
//   pass is one fma an element (x * rstd*gamma + beta - mean*rstd*gamma),
//   tanh-GELU and 16-byte stores. On an H100 80GB HBM3 at 700 W it takes
//   ~44 us in bf16 and ~61 us in f32 at [256, 32, 32, 64] (PERF.md), where
//   tanh-GELU's arithmetic is a large share of the bf16 time.
// - groupnorm_gelu_rows, the general path (the shapes image_ranks refuses):
//   one 256-thread block per (b, g), each thread one channel, three passes
//   over the group (sum; squared deviations; normalize and write), the
//   second and third from L2.
// apv_groupnorm_gelu reports which of the two it launched; image_ranks is
// the rule for both directions, so the forward and the backward take the
// image kernels on exactly the same shapes.
//
// Backward: groupnorm_gelu_bwd_image and _rows replace the hand-derived
// custom_vjp rule apv_tpu/ops/groupnorm.py::_bwd, term for term:
//     dy_pre = dy * gelu'(y_pre),  y_pre = xhat*gamma + beta
//     dgamma = sum_{b,hw} dy_pre * xhat,  dbeta = sum_{b,hw} dy_pre
//     dxhat  = dy_pre * gamma
//     dx     = rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat))
// Bound on an H100: memory; dy, x in and dx out, 100.7 MB in bf16 at the
// flagship shape, 30.0 us at 3.35 TB/s. The first design (a block per
// (b, g), one channel a thread, 2-byte loads) took ~133 us, and how it
// read the rows bounded it: a plain copy of the same bytes with a block
// per (b, g), each thread 16 bytes of its group's slice of a 128-byte
// row, took over twice as long as one that read whole rows. So:
// - groupnorm_gelu_bwd_image, the fast path: a cluster of K <= 8 blocks
//   per image, each block a slab of whole pixel rows, each thread one
//   16-byte run of V channels at a fixed place in the row (neighbouring
//   threads read neighbouring 16 bytes). Persistent clusters walk the
//   images and copy the next image's slab into shared memory (cp.async;
//   two stages in bf16, one in f32) while they work on this one. x stays
//   in shared memory and dy_pre in registers between the passes: x and dy
//   are read from device memory once. The blocks' sums meet in
//   distributed shared memory behind one cluster barrier an image.
// - groupnorm_gelu_bwd_rows, the general path (cg not a multiple of 16
//   bytes, unaligned tensors, C > 256 or more than 64 runs a row, an
//   image past eight blocks): a block per (b, g), one channel a thread,
//   the group read twice (the second time from L2).
// apv_groupnorm_gelu_bwd reports which of the two it launched.
// What bounds the fast path now is latency, not bytes: per image a block
// spends the smaller part of its time in the two passes and the rest
// waiting on its loads, its reductions and the cluster barrier (PERF.md).
// Both compute gelu' once an element in the first pass, as s + 2k*y*s*(1
// - s)*(1 + 3*0.044715*y^2) with s = sigmoid(2a) = (1 + tanh a)/2: one
// ex2.approx and one rcp.approx, the same derivative without tanhf, at
// some cost in agreement (on an H100 in f32 at the flagship shape, 1.2e-6
// scale-relative to the plain version against 4.6e-7 with tanhf). dgamma and
// dbeta are deterministic, with no float atomics: fixed-order sums into
// per-row partials [B, C], then groupnorm_gelu_param_sum adds the B rows
// of each column, one warp a column, in a fixed order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <initializer_list>

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

__device__ __forceinline__ float ex2_ftz(float v) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ float rcp_ftz(float v) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

// gelu'(y) for gelu(y) = y * s, s = sigmoid(2a) = (1 + tanh a)/2,
// a = k*(y + 0.044715*y^3): s + y * 2 s (1 - s) * k (1 + 3*0.044715*y^2).
// exp(-2a) is 2^(y * (c0 + c1*y^2)), one ex2; it overflows to inf for
// y << 0 (s = 0, gelu' = 0) and flushes to 0 for y >> 0 (s = 1).
__device__ __forceinline__ float gelu_grad(float y) {
    constexpr float kLog2e = 1.4426950408889634f;
    constexpr float kC0 = -2.0f * kSqrt2OverPi * kLog2e;
    constexpr float kC1 = kC0 * 0.044715f;
    const float y2 = y * y;
    const float s = rcp_ftz(1.0f + ex2_ftz(y * fmaf(kC1, y2, kC0)));
    const float slope = y * fmaf(6.0f * kSqrt2OverPi * 0.044715f, y2,
                                 2.0f * kSqrt2OverPi);
    return fmaf(fmaf(-s, s, s), slope, s);
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

// The thread's place in the walk over one chunk of a group's units
// (channels in the forward, runs of V channels in the backward; chunks of
// at most 256 units, one chunk unless there are more): unit c0 + ch,
// first pixel p0, pixel stride tpc (threads per unit). The last 256 mod
// cn threads hold no unit in the chunk.
struct Walk {
    int c0, cn, tpc, ch, p0;
    __device__ Walk(int chunk0, int units) {
        c0 = chunk0;
        cn = min(units - chunk0, kThreads);
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

// V = 16 / sizeof(T) consecutive elements of T as the backward's fast path
// loads, keeps and stores them: one 16-byte access.
template <typename T, int V>
struct Run;

template <>
struct Run<__nv_bfloat16, 8> {
    using Raw = uint4;
    __device__ static Raw load(const __nv_bfloat16* p) {
        return *reinterpret_cast<const uint4*>(p);
    }
    __device__ static void unpack(const Raw& r, float (&f)[8]) {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {            // element 2k is the low half
            f[2 * k] = __uint_as_float(w[k] << 16);
            f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
    __device__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
            w[k] = *reinterpret_cast<const uint32_t*>(&h);
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
};

template <>
struct Run<float, 4> {
    using Raw = float4;
    __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
    __device__ static void unpack(const Raw& r, float (&f)[4]) {
        f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
    }
    __device__ static void store(float* p, const float (&f)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    }
};

constexpr int kKeepElems = 32;   // elements a thread may keep between passes

// The backward's first pass for one element, with mrs = -mean * rstd:
// adds dy_pre * xhat and dy_pre to the channel's (acc_g, acc_b) and
// returns dy_pre. The group's sums of dxhat and dxhat * xhat follow from
// the channel sums: sum_j gamma_j * acc_b_j and sum_j gamma_j * acc_g_j.
__device__ __forceinline__ float bwd_elem(float xv, float dyv, float ga, float be,
                                          float rstd, float mrs, float& acc_g,
                                          float& acc_b) {
    const float xhat = fmaf(xv, rstd, mrs);
    const float dy_pre = dyv * gelu_grad(fmaf(xhat, ga, be));
    acc_g = fmaf(dy_pre, xhat, acc_g);
    acc_b += dy_pre;
    return dy_pre;
}

// Sum over the block of (a, b), returned to every thread in a fixed order.
__device__ float2 block_allsum2(float a, float b, float2* scratch) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    a = apv::warp_sum(a);
    b = apv::warp_sum(b);
    __syncthreads();                       // scratch free from the last use
    if (lane == 0) scratch[warp] = make_float2(a, b);
    __syncthreads();
    float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        s.x += scratch[w].x;
        s.y += scratch[w].y;
    }
    return s;
}

// Sums each of the W values v[w] over the threads of each run of the walk,
// in a fixed order, and hands store(run, w, sum) the chunk's cn*W sums
// (run < cn). red holds kThreads*W floats. Every thread of the block calls
// it.
template <int W, typename Store>
__device__ void reduce_by_run(float (&v)[W], const Walk& wk, float* red, Store store) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int width = wk.cn * W;
    __syncthreads();                       // red free from the last use
    if (wk.cn <= 32 && (wk.cn & (wk.cn - 1)) == 0) {
        // lanes l, l + cn, ... of a warp hold run l % cn: a butterfly over
        // the offsets >= cn leaves each lane with its run's warp sum
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            if (off < wk.cn) break;
#pragma unroll
            for (int w = 0; w < W; ++w) v[w] += __shfl_xor_sync(apv::kFullMask, v[w], off);
        }
        if (lane < wk.cn) {
#pragma unroll
            for (int w = 0; w < W; ++w) red[warp * width + lane * W + w] = v[w];
        }
        __syncthreads();
        for (int t = threadIdx.x; t < width; t += kThreads) {
            float sum = 0.0f;
            for (int k = 0; k < kThreads / 32; ++k) sum += red[k * width + t];
            store(t / W, t % W, sum);
        }
    } else {
#pragma unroll
        for (int w = 0; w < W; ++w) red[threadIdx.x * W + w] = v[w];
        __syncthreads();
        for (int t = threadIdx.x; t < width; t += kThreads) {
            const int run = t / W, w = t % W;
            float sum = 0.0f;
            for (int k = 0; k < wk.tpc; ++k) sum += red[(k * wk.cn + run) * W + w];
            store(run, w, sum);
        }
    }
}

// The thread's share of the group sums (dxhat, dxhat * xhat) from its
// channel sums, before the block sums them.
template <int V>
__device__ __forceinline__ void add_group_sums(const float (&ga)[V], const float (&acc_g)[V],
                                               const float (&acc_b)[V], float& s1,
                                               float& s2) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
        s1 = fmaf(ga[j], acc_b[j], s1);
        s2 = fmaf(ga[j], acc_g[j], s2);
    }
}

// The general path, one block per (b, g): each thread one channel of the
// group (chunks of at most kThreads channels) at a stride of pixels. The
// first pass sums, the second reads the group again (from L2) and writes
// dx. With B = -rstd * mean_g(dxhat) and C = -rstd * mean_g(dxhat * xhat),
// dx = rstd * gamma_j * dy_pre + C * xhat + B.
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
    __shared__ float2 scratch[kThreads / 32];
    __shared__ float red[2 * kThreads];
    const int b = blockIdx.x / groups, g = blockIdx.x % groups;
    const int cg = c / groups;
    const int64_t base = static_cast<int64_t>(b) * hw * c + static_cast<int64_t>(g) * cg;
    const T* __restrict__ xg = x + base;
    const T* __restrict__ dyg = dy + base;
    T* __restrict__ dxg = dx + base;
    const float* const gag = gamma + g * cg;
    const float* const beg = beta + g * cg;
    float* const pg = part_dgamma + static_cast<int64_t>(b) * c + g * cg;
    float* const pb = part_dbeta + static_cast<int64_t>(b) * c + g * cg;
    const float n = static_cast<float>(hw) * static_cast<float>(cg);
    const float rstd = rstd_in[blockIdx.x];
    const float mrs = -mean_in[blockIdx.x] * rstd;

    float s1 = 0.0f, s2 = 0.0f;
    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        const int ch = c0 + wk.ch;
        float ga = 0.0f, sums[2] = {0.0f, 0.0f};   // the channel's dgamma, dbeta
        if (wk.active()) {
            ga = gag[ch];
            const float be = beg[ch];
            for (int64_t p = wk.p0; p < hw; p += wk.tpc)
                bwd_elem(load(xg, p * c + ch), load(dyg, p * c + ch), ga, be, rstd,
                         mrs, sums[0], sums[1]);
        }
        s1 = fmaf(ga, sums[1], s1);
        s2 = fmaf(ga, sums[0], s2);
        reduce_by_run(sums, wk, red, [&](int run, int w, float sum) {
            (w == 0 ? pg : pb)[c0 + run] = sum;
        });
    }
    const float2 m = block_allsum2(s1, s2, scratch);
    const float mb = -rstd * (m.x / n), mc = -rstd * (m.y / n);
    for (int c0 = 0; c0 < cg; c0 += kThreads) {
        const Walk wk(c0, cg);
        if (!wk.active()) continue;
        const int ch = c0 + wk.ch;
        const float ga = gag[ch], be = beg[ch];
        for (int64_t p = wk.p0; p < hw; p += wk.tpc) {
            const int64_t i = p * c + ch;
            const float xv = load(xg, i);
            float unused_g = 0.0f, unused_b = 0.0f;
            const float dy_pre = bwd_elem(xv, load(dyg, i), ga, be, rstd, mrs, unused_g,
                                          unused_b);
            store(dxg, i, fmaf(rstd * ga, dy_pre, fmaf(mc, fmaf(xv, rstd, mrs), mb)));
        }
    }
}

// Stores v at the address of `smem` in block `rank` of the cluster
// (distributed shared memory); visible there after the next cluster_sync.
__device__ __forceinline__ void st_dsmem(float* smem, int rank, float v) {
    const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The fast path: a cluster of K <= 8 blocks per image, each block a slab
// of whole pixel rows (all C channels in 16-byte runs of V channels: at
// cg = 8 in bf16, eight threads read one 128-byte row), kItems runs a
// thread. The clusters are persistent (as many as fit at once): each
// walks images b = cluster, cluster + clusters, ..., and in bf16 copies
// the next image's slab into shared memory (cp.async, image_stages) while
// it works on this one, so that the loads of one image overlap the
// arithmetic and the barrier of the last.
// A thread reads back only the runs it copied. dy_pre stays in registers
// (f32) between the passes and x in shared memory: x and dy are read from
// device memory once. After the first pass the block sums, by run of the
// row, the channel sums and each thread's share of its group's sums
// (sum_j gamma_j * channel sums, for mean_g(dxhat) and mean_g(dxhat *
// xhat)); it stores the run sums into every block of the cluster and each
// channel's sums into the block that writes that channel's dgamma and
// dbeta partial (distributed shared memory, an inbox per parity of the
// image), and one cluster barrier later every block adds what it received
// in rank order. Needs C <= kThreads, C / V <= kMaxRuns runs a row,
// K <= kMaxRanks; dynamic shared memory image_smem<V>().
constexpr int kMaxRuns = 64;              // runs a row on the fast path
constexpr int kMaxRanks = 8;              // blocks a cluster

// Two stages of x and dy in 2-byte types (the next image's copy overlaps
// this one); one for f32, whose stage is twice as large, so that two
// blocks still fit an SM.
template <int V>
__host__ __device__ constexpr int image_stages() { return V == 8 ? 2 : 1; }

template <int V>
__host__ __device__ constexpr int image_stage_bytes() {       // stages x [x, dy] x kItems x threads x 16 B
    return image_stages<V>() * 2 * (kKeepElems / V) * kThreads * 16;
}

template <int V>
__host__ __device__ constexpr int image_smem() {              // the stages, then red
    return image_stage_bytes<V>() + kThreads * (2 * V + 2) * 4;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
groupnorm_gelu_bwd_image(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const float* __restrict__ mean_in,
                         const float* __restrict__ rstd_in, T* __restrict__ dx,
                         float* __restrict__ part_dgamma,
                         float* __restrict__ part_dbeta, int64_t batch,
                         int64_t hw, int c, int groups) {
    static_assert(V * sizeof(T) == 16, "runs of 16 bytes");
    using R = Run<T, V>;
    using Raw = typename R::Raw;
    constexpr int kItems = kKeepElems / V;
    constexpr int kW = 2 * V + 2;         // a run's sums: V dgamma, V dbeta, s2, s1
    constexpr int kStages = image_stages<V>();
    extern __shared__ uint4 stage[];      // [kStages][x, dy][kItems][kThreads]
    float* const red = reinterpret_cast<float*>(stage + image_stage_bytes<V>() / 16);
    __shared__ float sums[kMaxRuns * kW];  // this block's sums by run
    // inboxes, by parity of the image: [rank][s2, s1][run] and
    // [rank][dgamma, dbeta][channel of this block's slice]
    __shared__ float inbox_run[2][kMaxRanks][2][kMaxRuns];
    __shared__ float inbox_ch[2][2 * (kThreads + kMaxRanks)];
    __shared__ float2 mm[kThreads];
    const int rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
    const int ranks = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
    const int64_t clusters = gridDim.x / ranks;
    const int cg = c / groups, runs = c / V;
    const Walk wk(0, runs);  // the thread's run of every row
    const bool act = wk.active();
    const int ch = wk.ch * V, grp = ch / cg;
    const int64_t p_lo = static_cast<int64_t>(rank) * wk.tpc * kItems;
    const float n = static_cast<float>(hw) * static_cast<float>(cg);
    // block r writes the dgamma and dbeta partials of channels
    // [r * slice, r * slice + slice) (clipped to c)
    const int slice = (c + ranks - 1) / ranks;
    const int ch_lo = min(c, rank * slice), ch_n = min(c, ch_lo + slice) - ch_lo;

    float ga[V], be[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        ga[j] = act ? gamma[ch + j] : 0.0f;
        be[j] = act ? beta[ch + j] : 0.0f;
    }
    // the thread's slot of item k in stage sg: x at slot(sg, 0, k), dy at slot(sg, 1, k)
    const auto slot = [&](int sg, int which, int k) {
        return stage + ((sg * 2 + which) * kItems + k) * kThreads + threadIdx.x;
    };
    const auto fetch = [&](int64_t b, int sg) {
        if (b < batch) {
            const int64_t base = b * hw * c;
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
                const int64_t p = p_lo + wk.p0 + static_cast<int64_t>(k) * wk.tpc;
                if (act && p < hw) {
                    cp_async16(slot(sg, 0, k), x + base + p * c + ch);
                    cp_async16(slot(sg, 1, k), dy + base + p * c + ch);
                }
            }
        }
        cp_async_commit();                 // an empty group past the last image
    };

    if constexpr (kStages == 2) fetch(blockIdx.x / ranks, 0);
    int st = 0;                            // the inboxes' parity
    for (int64_t b = blockIdx.x / ranks; b < batch; b += clusters, st ^= 1) {
        // the stage this image is in; its last reader was this thread
        const int buf = kStages == 2 ? st : 0;
        if constexpr (kStages == 2) fetch(b + clusters, st ^ 1);
        else fetch(b, 0);
        const float rstd_t = threadIdx.x < groups ? rstd_in[b * groups + threadIdx.x] : 0.0f;
        const float rstd = rstd_in[b * groups + grp];
        const float mrs = -mean_in[b * groups + grp] * rstd;
        if constexpr (kStages == 2) cp_async_wait_one();   // this image's runs have landed
        else cp_async_wait_all();
        const int64_t base = b * hw * c;
        float acc_g[V], acc_b[V], dyp[kItems][V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc_g[j] = acc_b[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            const int64_t p = p_lo + wk.p0 + static_cast<int64_t>(k) * wk.tpc;
            if (act && p < hw) {
                float xv[V], dv[V];
                R::unpack(*reinterpret_cast<const Raw*>(slot(buf, 0, k)), xv);
                R::unpack(*reinterpret_cast<const Raw*>(slot(buf, 1, k)), dv);
#pragma unroll
                for (int j = 0; j < V; ++j)
                    dyp[k][j] = bwd_elem(xv[j], dv[j], ga[j], be[j], rstd, mrs,
                                         acc_g[j], acc_b[j]);
            }
        }
        float acc[kW];                     // dgamma, dbeta, then s2 and s1
#pragma unroll
        for (int j = 0; j < V; ++j) {
            acc[j] = acc_g[j];
            acc[V + j] = acc_b[j];
        }
        acc[2 * V] = acc[2 * V + 1] = 0.0f;
        add_group_sums<V>(ga, acc_g, acc_b, acc[2 * V + 1], acc[2 * V]);
        reduce_by_run(acc, wk, red, [&](int run, int w, float sum) {
            sums[run * kW + w] = sum;
        });
        __syncthreads();
        // post: the run sums (s2, s1) to every block, each channel's sums
        // to the block that owns it
        for (int t = threadIdx.x; t < 2 * runs * ranks + 2 * c; t += kThreads) {
            if (t < 2 * runs * ranks) {
                const int r = t / (2 * runs), which = (t / runs) % 2, run = t % runs;
                st_dsmem(&inbox_run[st][rank][which][run], r,
                         sums[run * kW + 2 * V + which]);
            } else {
                const int i = t - 2 * runs * ranks, which = i / c, cc = i % c;
                st_dsmem(&inbox_ch[st][(rank * 2 + which) * slice + cc % slice], cc / slice,
                         sums[(cc / V) * kW + which * V + cc % V]);
            }
        }
        cluster_sync();                    // every block's sums have arrived
        if (threadIdx.x < groups) {
            const int t = threadIdx.x, r0 = t * cg / V, r1 = (t + 1) * cg / V;
            float s2 = 0.0f, s1 = 0.0f;    // rank by rank, run by run
            for (int r = 0; r < ranks; ++r) {
                for (int run = r0; run < r1; ++run) {
                    s2 += inbox_run[st][r][0][run];
                    s1 += inbox_run[st][r][1][run];
                }
            }
            mm[t] = make_float2(-rstd_t * (s1 / n), -rstd_t * (s2 / n));
        }
        for (int t = threadIdx.x; t < 2 * ch_n; t += kThreads) {
            const int which = t / ch_n, i = t % ch_n;
            float v = 0.0f;
            for (int r = 0; r < ranks; ++r) v += inbox_ch[st][(r * 2 + which) * slice + i];
            (which == 0 ? part_dgamma : part_dbeta)[b * c + ch_lo + i] = v;
        }
        __syncthreads();
        const float mb = mm[grp].x, mc = mm[grp].y;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            const int64_t p = p_lo + wk.p0 + static_cast<int64_t>(k) * wk.tpc;
            if (act && p < hw) {
                float xv[V], out[V];
                R::unpack(*reinterpret_cast<const Raw*>(slot(buf, 0, k)), xv);
#pragma unroll
                for (int j = 0; j < V; ++j)
                    out[j] = fmaf(rstd * ga[j], dyp[k][j], fmaf(mc, fmaf(xv[j], rstd, mrs), mb));
                R::store(dx + base + p * c + ch, out);
            }
        }
    }
}

// The forward's runs a thread an image: in bf16 twice the backward's
// (an image takes half the blocks; a block stages 32 KB of x), in f32 the
// same (a 64 KB stage of twice the runs would leave one block an SM).
template <int V>
__host__ __device__ constexpr int fwd_items() { return (V == 8 ? 2 : 1) * kKeepElems / V; }

// Blocks an SM the forward is compiled for: x is read back from shared
// memory in every pass, so f32 fits three in registers and shared memory.
template <int V>
__host__ __device__ constexpr int fwd_blocks_per_sm() { return V == 8 ? 2 : 3; }

// Dynamic shared memory of groupnorm_gelu_image: two stages of x.
template <int V>
__host__ __device__ constexpr int fwd_image_smem() {
    return 2 * fwd_items<V>() * kThreads * 16;
}

// Each group's sum over the block of v (the thread's share of its group,
// 0 where it holds none) into out[group], in a fixed order; red holds
// kThreads floats, run_sum kMaxRuns. Every thread calls it; out is
// visible to all on return.
__device__ void group_sums(float v, const Walk& wk, int runs_per_group, int groups,
                           float* red, float* run_sum, float* out) {
    float a[1] = {v};
    reduce_by_run(a, wk, red, [&](int run, int, float sum) { run_sum[run] = sum; });
    __syncthreads();
    if (threadIdx.x < groups) {
        float t = 0.0f;
        const int r0 = threadIdx.x * runs_per_group;
        for (int r = r0; r < r0 + runs_per_group; ++r) t += run_sum[r];
        out[threadIdx.x] = t;
    }
    __syncthreads();
}

// The forward's fast path (see the top of the file): persistent clusters
// of K = gridDim / clusters blocks, one image at a time, block `rank` the
// pixels [rank * rows, (rank + 1) * rows) with rows = tpc * kItems. x is
// read from the stage in each of the three passes.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, fwd_blocks_per_sm<V>())
groupnorm_gelu_image(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int64_t batch, int64_t hw, int c, int groups, float eps) {
    static_assert(V * sizeof(T) == 16, "runs of 16 bytes");
    using R = Run<T, V>;
    using Raw = typename R::Raw;
    constexpr int kItems = fwd_items<V>();
    extern __shared__ uint4 stage[];       // [2][kItems][kThreads]
    __shared__ float red[kThreads];
    __shared__ float run_sum[kMaxRuns];
    __shared__ float blk_sum[kMaxRuns], blk_m2[kMaxRuns];   // groups <= runs
    // (mean, M2) of each block's slab by parity of the image, rank, group
    __shared__ float inbox[2][kMaxRanks][kMaxRuns][2];
    __shared__ float2 stats[kMaxRuns];     // the image's (mean, rstd) by group
    const int rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
    const int ranks = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
    const int64_t clusters = gridDim.x / ranks;
    const int cg = c / groups, runs = c / V;
    const Walk wk(0, runs);                // the thread's run of every row
    const bool act = wk.active();
    const int ch = wk.ch * V, grp = ch / cg;
    const int64_t rows = static_cast<int64_t>(wk.tpc) * kItems;   // pixels a block
    const int64_t p_lo = rank * rows;
    // each group's elements in block r's slab
    const auto count = [&](int r) {
        return static_cast<float>(hw - r * rows < rows ? hw - r * rows : rows) * cg;
    };
    const float n_blk = count(rank);

    float ga[V], be[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        ga[j] = act ? gamma[ch + j] : 0.0f;
        be[j] = act ? beta[ch + j] : 0.0f;
    }
    const auto slot = [&](int sg, int k) {
        return stage + (sg * kItems + k) * kThreads + threadIdx.x;
    };
    const auto pixel = [&](int k) {
        return p_lo + wk.p0 + static_cast<int64_t>(k) * wk.tpc;
    };
    const auto fetch = [&](int64_t b, int sg) {
        if (b < batch) {
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
                if (act && pixel(k) < hw) cp_async16(slot(sg, k), x + (b * hw + pixel(k)) * c + ch);
            }
        }
        cp_async_commit();                 // an empty group past the last image
    };

    fetch(blockIdx.x / ranks, 0);
    int st = 0;                            // the stage and the inboxes' parity
    for (int64_t b = blockIdx.x / ranks; b < batch; b += clusters, st ^= 1) {
        fetch(b + clusters, st ^ 1);
        cp_async_wait_one();               // this image's runs have landed
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            if (act && pixel(k) < hw) {
                float xv[V];
                R::unpack(*reinterpret_cast<const Raw*>(slot(st, k)), xv);
#pragma unroll
                for (int j = 0; j < V; ++j) s += xv[j];
            }
        }
        group_sums(s, wk, cg / V, groups, red, run_sum, blk_sum);
        const float m_blk = blk_sum[grp] / n_blk;
        float sq = 0.0f;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            if (act && pixel(k) < hw) {
                float xv[V];
                R::unpack(*reinterpret_cast<const Raw*>(slot(st, k)), xv);
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    const float d = xv[j] - m_blk;
                    sq = fmaf(d, d, sq);
                }
            }
        }
        group_sums(sq, wk, cg / V, groups, red, run_sum, blk_m2);
        // post this slab's (mean, M2) of every group to every block
        for (int t = threadIdx.x; t < 2 * groups * ranks; t += kThreads) {
            const int r = t / (2 * groups), gi = (t / 2) % groups, which = t % 2;
            st_dsmem(&inbox[st][rank][gi][which], r,
                     which == 0 ? blk_sum[gi] / n_blk : blk_m2[gi]);
        }
        cluster_sync();                    // every block's slab has arrived
        if (threadIdx.x < groups) {
            const int gi = threadIdx.x;
            float n = 0.0f, mean = 0.0f, m2 = 0.0f;
            for (int r = 0; r < ranks; ++r) {   // Chan et al., rank by rank
                const float nb = count(r);
                const float mb = inbox[st][r][gi][0], m2b = inbox[st][r][gi][1];
                const float nt = n + nb, delta = mb - mean;
                mean = fmaf(delta, nb / nt, mean);
                m2 += m2b + delta * delta * (n * nb / nt);
                n = nt;
            }
            const float rstd = 1.0f / sqrtf(m2 / n + eps);
            stats[gi] = make_float2(mean, rstd);
            if (rank == 0) {
                mean_out[b * groups + gi] = mean;
                rstd_out[b * groups + gi] = rstd;
            }
        }
        __syncthreads();
        const float mean = stats[grp].x, rstd = stats[grp].y;
        float sc[V], sh[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            sc[j] = rstd * ga[j];
            sh[j] = fmaf(-mean, sc[j], be[j]);
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            if (act && pixel(k) < hw) {
                float xv[V], out[V];
                R::unpack(*reinterpret_cast<const Raw*>(slot(st, k)), xv);
#pragma unroll
                for (int j = 0; j < V; ++j) out[j] = gelu(fmaf(xv[j], sc[j], sh[j]));
                R::store(y + (b * hw + pixel(k)) * c + ch, out);
            }
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

template <typename T>
int launch_rows(const void* dy, const void* x, const float* gamma,
                const float* beta, const float* mean, const float* rstd,
                void* dx, float* part_dgamma, float* part_dbeta, int64_t batch,
                int64_t hw, int64_t c, int64_t groups, cudaStream_t s) {
    groupnorm_gelu_bwd_rows<T>
        <<<static_cast<unsigned>(batch * groups), kThreads, 0, s>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), gamma, beta,
            mean, rstd, static_cast<T*>(dx), part_dgamma, part_dbeta, hw,
            static_cast<int>(c), static_cast<int>(groups));
    return apv::launch_status();
}

// The kernel an entry point launched, as it reports it.
enum Route : int { kImage = 0, kRows = 1 };

// The fast path's rule, one for both directions: the blocks of a cluster
// for one image, or 0 where the image kernels cannot take the shape (cg not
// a multiple of 16-byte runs, a tensor off 16-byte alignment, C > kThreads
// or more than kMaxRuns runs a row, an image past kMaxRanks blocks of
// (kThreads / runs) * (kKeepElems / V) pixels).
template <typename T>
int64_t image_ranks(int64_t hw, int64_t c, int64_t groups,
                    std::initializer_list<const void*> tensors) {
    constexpr int kV = 16 / sizeof(T);
    const int64_t runs = c / kV;
    if ((c / groups) % kV != 0 || runs < 1 || c > kThreads || runs > kMaxRuns) return 0;
    for (const void* t : tensors) {
        if (!apv::aligned16(t)) return 0;
    }
    const int64_t rows_per_block = (kThreads / runs) * (kKeepElems / kV);
    const int64_t ranks = std::max<int64_t>(1, (hw + rows_per_block - 1) / rows_per_block);
    return ranks <= kMaxRanks ? ranks : 0;
}

// Launches kernel_fn as persistent clusters of `ranks` blocks, as many as
// are resident at once and at most one an image, with `smem` bytes of
// dynamic shared memory a block. Returns the first failing cudaError_t.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel_fn)(Params...), int smem, int64_t batch, int64_t ranks,
                    cudaStream_t s, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch * ranks));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = static_cast<unsigned>(ranks);
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    int resident = 0;                      // clusters resident at once
    err = cudaOccupancyMaxActiveClusters(&resident, kernel_fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cfg.gridDim = dim3(static_cast<unsigned>(std::min<int64_t>(batch, resident) * ranks));
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel_fn, args...));
}

template <typename T>
int launch_fwd(const void* x, const float* gamma, const float* beta, void* y,
               float* mean, float* rstd, int64_t batch, int64_t hw, int64_t c,
               int64_t groups, float eps, int* kernel, cudaStream_t s) {
    constexpr int kV = 16 / sizeof(T);
    const int64_t ranks = image_ranks<T>(hw, c, groups, {x, y});
    const auto xt = static_cast<const T*>(x);
    const auto yt = static_cast<T*>(y);
    if (ranks == 0) {
        *kernel = kRows;
        groupnorm_gelu_rows<T><<<static_cast<unsigned>(batch * groups), kThreads, 0, s>>>(
            xt, gamma, beta, yt, mean, rstd, hw, static_cast<int>(c),
            static_cast<int>(groups), eps);
        return apv::launch_status();
    }
    *kernel = kImage;
    constexpr int kPer = fwd_items<kV>() * kV / kKeepElems;   // backward blocks a block
    return launch_clusters(groupnorm_gelu_image<T, kV>, fwd_image_smem<kV>(), batch,
                           (ranks + kPer - 1) / kPer, s, xt, gamma, beta, yt, mean, rstd, batch, hw,
                           static_cast<int>(c), static_cast<int>(groups), eps);
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const float* gamma,
               const float* beta, const float* mean, const float* rstd,
               void* dx, float* part_dgamma, float* part_dbeta, int64_t batch,
               int64_t hw, int64_t c, int64_t groups, int* kernel,
               cudaStream_t s) {
    constexpr int kV = 16 / sizeof(T);
    const int64_t ranks = image_ranks<T>(hw, c, groups, {dy, x, dx});
    if (ranks == 0) {
        *kernel = kRows;
        return launch_rows<T>(dy, x, gamma, beta, mean, rstd, dx, part_dgamma,
                              part_dbeta, batch, hw, c, groups, s);
    }
    *kernel = kImage;
    return launch_clusters(groupnorm_gelu_bwd_image<T, kV>, image_smem<kV>(), batch, ranks,
                           s, static_cast<const T*>(dy), static_cast<const T*>(x), gamma,
                           beta, mean, rstd, static_cast<T*>(dx), part_dgamma, part_dbeta,
                           batch, hw, static_cast<int>(c), static_cast<int>(groups));
}

}  // namespace

// *kernel: the kernel that ran (Route).
extern "C" int apv_groupnorm_gelu(const void* x, const float* gamma,
                                  const float* beta, void* y, float* mean,
                                  float* rstd, int64_t batch, int64_t hw,
                                  int64_t c, int64_t groups, float eps,
                                  int is_bf16, int* kernel, void* stream) {
    if (batch <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, batch, hw, c,
                                               groups, eps, kernel, s)
                   : launch_fwd<float>(x, gamma, beta, y, mean, rstd, batch, hw, c, groups,
                                       eps, kernel, s);
}

extern "C" int apv_groupnorm_gelu_bwd(const void* dy, const void* x,
                                      const float* gamma, const float* beta,
                                      const float* mean, const float* rstd,
                                      void* dx, float* part_dgamma,
                                      float* part_dbeta, float* dgamma,
                                      float* dbeta, int64_t batch, int64_t hw,
                                      int64_t c, int64_t groups, int is_bf16,
                                      int* kernel, void* stream) {
    if (c <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (batch > 0) {
        const int status =
            is_bf16 ? launch_bwd<__nv_bfloat16>(dy, x, gamma, beta, mean, rstd,
                                                dx, part_dgamma, part_dbeta,
                                                batch, hw, c, groups, kernel, s)
                    : launch_bwd<float>(dy, x, gamma, beta, mean, rstd, dx,
                                        part_dgamma, part_dbeta, batch, hw, c,
                                        groups, kernel, s);
        if (status != 0) return status;
    }
    constexpr int kCols = kThreads / 32;  // one warp per column
    const unsigned col_blocks = static_cast<unsigned>((c + kCols - 1) / kCols);
    groupnorm_gelu_param_sum<<<col_blocks, kThreads, 0, s>>>(
        part_dgamma, part_dbeta, dgamma, dbeta, batch, static_cast<int>(c));
    return apv::launch_status();
}
