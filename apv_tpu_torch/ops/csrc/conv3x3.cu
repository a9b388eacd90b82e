// 3x3 SAME stride-1 convolution, NHWC x and HWIO w, bf16 or f32 in, f32
// accumulation and f32 out.
//
// Replaces scripts/conv_microbench.py::pallas_conv (Pallas kernel
// _pallas_kernel), the conv probe's hand-written contender: the conv as nine
// shifted [tb*H*W, Cin] x [Cin, Cout] dots accumulated in VMEM, out in f32.
//
// Here it is one implicit GEMM: out[m, n] = sum_k A[m, k] * Wf[k, n] with
// m = (b, h, w) an output pixel (M = B*H*W), k = (ky*3 + kx)*Cin + ci
// (K = 9*Cin), n an output channel (N = Cout), A[m, k] =
// x[b, h+ky-1, w+kx-1, ci] (zero outside the image) gathered on the fly and
// Wf = w viewed as [9*Cin, Cout].
//
// Bound on an H100 at the probe's shapes [B, H, W, Cin, Cout] =
// [256,32,32,64,64], [256,16,16,128,128], [256,8,8,256,256]: 19.3 GFLOP at
// each, 19.5 us on the bf16 tensor cores (989 TFLOP/s); at stage 1 the bytes
// (bf16 x and w in, f32 out: 100.7 MB, 30.1 us at 3.35 TB/s) bound it, at
// stages 2-3 the bf16 operations. The f32 out, as the TPU kernel returns,
// is two thirds of stage 1's bytes.
//
// conv3x3_wgmma, the tensor-core kernel (Cin and Cout multiples of 8):
// - Tiles of 128 output pixels x BN = 64 or 128 output channels. A block
//   is three warpgroups: one producer thread and two consumer warpgroups,
//   each owning 64 pixel rows and issuing wgmma.mma_async m64nBN: k16 on
//   bf16 (exact products, f32 sums), k8 on TF32 for f32 inputs. The grid
//   is persistent (one block an SM walks the tiles), so the epilogue of a
//   tile overlaps the loads of the next.
// - K is walked in blocks that never straddle a tap: (tap, 128 bytes of
//   channels), 64 bf16 or 32 f32. A tile's pixels are one TMA box of x,
//   bn images x bh rows x bw columns (tiling rule at PixelTiles); the box
//   for tap (ky, kx) is the same box moved by (ky - 1, kx - 1), and TMA
//   zero-fills what falls outside the image or past Cin: the im2col with
//   no padded copy of x and no per-thread address arithmetic.
// - B: bf16 reads HWIO as it is, MN-major (a 128-byte row is 64 output
//   channels of one k; wgmma's transpose bit), so no weight copy is made.
//   TF32 wgmma takes K-major operands only, so for f32 the wrapper passes
//   w transposed to [Cout, 9*Cin] (2.4 MB at 256x256).
// - Tiles land 128-byte swizzled (TMA's SWIZZLE_128B: 16-byte chunk c of
//   row r at chunk c ^ (r & 7)), the layout of wgmma's SW128 descriptors,
//   so the tensor cores read shared memory without bank conflicts.
// - A ring of STAGES stages with a full and an empty mbarrier each: the
//   producer waits for a stage to be empty, expects its bytes and issues
//   the TMA loads; the consumers wait for it to be full and free it once
//   their wgmmas on it have retired (bf16 keeps one group in flight).
// - f32 as 3xTF32: the consumers split each operand in shared memory into
//   hi = tf32(a) (cvt.rna) and lo = tf32(a - hi); lo*hi + hi*lo + hi*hi
//   drops only lo*lo (~2^-22 relative a product). Each K block's products
//   go into a fresh partial sum that the FP32 units add to the total. The
//   bound for f32-exact work on the tensor cores is three TF32 products a
//   MAC at 495 TFLOP/s: 117 us at each probe shape.
// - Epilogue: the accumulator fragments go straight to global memory as
//   16-byte stores (lane pairs swap halves with one shuffle), masked to
//   the image and to Cout.
//
// conv3x3_simt, the first kernel, takes the other widths: 128 x 64 tiles,
// K walked 16 at a time through shared memory, 8 x 4 outputs per thread
// in f32 FMAs.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, wgmma, TF32 rounding
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory writes by this thread made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle, 8-row groups 1024 bytes apart: start address >> 4 in
// bits 0-13, leading offset 16 B (unused by this layout) in bits 16-29,
// stride offset 1024 B in bits 32-45, swizzle mode 1 (128 B) in bits 62-63.
// The same descriptor with lead = 8192 B describes bf16 B stored MN-major:
// 128-byte rows of 64 output channels, one per k, 8-k groups 1024 B apart
// (stride offset) and 64-channel blocks 8192 B apart (leading offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lead = 16) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lead >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ float tf32_round(float a) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
    return __uint_as_float(r);
}

// mbarriers: a phase completes when all its arrivals (and, after
// expect_tx, all its expected bytes) are in.
__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(addr) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t addr, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(addr), "r"(bytes) : "memory");
}

// Wait for the phase of this parity to complete. A wait of ~4 s is a
// protocol fault: trap (the launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    const long long start = clock64();
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (!done && clock64() - start > (1ll << 33)) __trap();
    } while (!done);
}

// TMA tile loads into shared memory, completing on the mbarrier at bar;
// coordinates innermost first, out-of-bounds elements zero-filled.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global"
                 ".mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                    "r"(c1), "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global"
                 ".mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3, %4}], [%5];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                    "r"(c1), "r"(c2), "r"(bar) : "memory");
}

// d[BN/2] = A[64 x 16] * B[16 x BN] (bf16) or A[64 x 8] * B[8 x BN] (TF32)
// + (scale_d ? d : 0), A and B K-major in shared memory; per thread of the warpgroup, fragment j
// (d[4j .. 4j+3]) holds row 16*warp + lane/4 (+8 for the last two) and
// columns 8j + 2*(lane%4) + {0, 1}.
template <int BN>
__device__ void wgmma_bf16(float (&d)[BN / 2], uint64_t a, uint64_t b,
                           int scale_d);
template <int BN>
__device__ void wgmma_tf32(float (&d)[BN / 2], uint64_t a, uint64_t b,
                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d)
        : "memory");
}


// ---------------------------------------------------------------------------
// conv3x3_wgmma: the tensor-core implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kRowBytes = 128;  // a K block row: one swizzle row
constexpr int kThreads = 384;   // a producer warpgroup and two consumers

// One tiling: BM = 128 output pixels x BN output channels a tile, a ring of
// STAGES K blocks. bf16 keeps one wgmma group in flight and frees a stage a
// block late; f32 waits for each block's products (it adds them itself).
template <typename T, int BN_, int STAGES_>
struct Tiling {
    static constexpr int BN = BN_, STAGES = STAGES_;
    static constexpr bool kTf32 = sizeof(T) == 4;
    static constexpr int INFLIGHT = kTf32 ? 0 : 1;
    static constexpr int kBK = kRowBytes / static_cast<int>(sizeof(T));
    static constexpr int kATile = 128 * kRowBytes;                 // 16 KB
    static constexpr int kBTile = BN * kRowBytes;
    // f32 keeps the lo halves beside the hi ones: [A | B | A lo | B lo]
    static constexpr int kLo = kATile + kBTile;
    static constexpr int kStage = kTf32 ? 2 * kLo : kLo;
    // + 1024 B to align the swizzle atoms, + the 2 * STAGES mbarriers
    static constexpr int kSmem = STAGES * kStage + 1024 + 256;
    static_assert(STAGES >= INFLIGHT + 1 && 2 * STAGES * 8 <= 256, "ring");
};

// A tile's 128 pixels are one TMA box of x: bn images x bh rows x bw
// columns (powers of two, bw * bh * bn = 128, bw the smallest >= W up to
// 128, bh the smallest >= H that fits). Out-of-image pixels of a box are
// zeros on the way in and masked on the way out.
struct PixelTiles {
    int bw, bh, bn, lbw, lbh;           // lbw = log2(bw), lbh = log2(bh)
    int tiles_w, tiles_h, n_tiles;      // boxes across W and H; N tiles
};

__device__ __forceinline__ void tile_origin(int64_t tile, const PixelTiles& pt,
                                            int& img0, int& h0, int& w0,
                                            int& n0, int bn_cols) {
    const int64_t mt = tile / pt.n_tiles;
    n0 = static_cast<int>(tile % pt.n_tiles) * bn_cols;
    const int per_img = pt.tiles_w * pt.tiles_h;
    img0 = static_cast<int>(mt / per_img) * pt.bn;
    const int r = static_cast<int>(mt % per_img);
    h0 = (r / pt.tiles_w) * pt.bh;
    w0 = (r % pt.tiles_w) * pt.bw;
}

// Split the 4 floats at p into hi = tf32(v) in place and lo = tf32(v - hi)
// at p + lo_off.
__device__ __forceinline__ void split_tf32(uint8_t* p, int lo_off) {
    const float4 v = *reinterpret_cast<float4*>(p);
    const float4 hi = make_float4(tf32_round(v.x), tf32_round(v.y),
                                  tf32_round(v.z), tf32_round(v.w));
    const float4 lo = make_float4(tf32_round(v.x - hi.x), tf32_round(v.y - hi.y),
                                  tf32_round(v.z - hi.z), tf32_round(v.w - hi.w));
    *reinterpret_cast<float4*>(p) = hi;
    *reinterpret_cast<float4*>(p + lo_off) = lo;
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, float* __restrict__ out,
              int batch, int h, int wd, int cin, int cout, PixelTiles pt,
              int64_t tiles) {
    constexpr int BN = C::BN, STAGES = C::STAGES;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
    uint8_t* const smem = smem_raw + (base - raw);
    const uint32_t bars = base + STAGES * C::kStage;
    auto full = [&](int s) { return bars + 8u * s; };             // loaded
    auto empty = [&](int s) { return bars + 8u * (STAGES + s); }; // consumed

    const int t = threadIdx.x;
    if (t == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 256);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int cblocks = (cin + C::kBK - 1) / C::kBK;
    const int nk = 9 * cblocks;

    if (t < 128) {
        // Producer: one thread walks the same tiles and K blocks as the
        // consumers and keeps the ring full, each stage one box of x and
        // one or two boxes of w.
        if (t != 0) return;
        int64_t g = 0;                               // blocks issued
        for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            int img0, h0, w0, n0;
            tile_origin(tile, pt, img0, h0, w0, n0, BN);
            for (int kb = 0; kb < nk; ++kb, ++g) {
                const int s = static_cast<int>(g % STAGES);
                if (g >= STAGES)
                    mbar_wait(empty(s),
                              static_cast<uint32_t>((g / STAGES - 1) & 1));
                const uint32_t sa = base + static_cast<uint32_t>(s * C::kStage);
                const int tap = kb / cblocks;
                const int c0 = (kb - tap * cblocks) * C::kBK;
                mbar_expect_tx(full(s), C::kATile + C::kBTile);
                tma_load_4d(sa, &xmap, full(s), c0, w0 + tap % 3 - 1,
                            h0 + tap / 3 - 1, img0);
                if constexpr (C::kTf32) {
                    tma_load_3d(sa + C::kATile, &wmap, full(s), c0, tap, n0);
                } else {
#pragma unroll
                    for (int nb = 0; nb < BN / 64; ++nb)
                        tma_load_3d(sa + C::kATile + nb * 8192, &wmap, full(s),
                                    n0 + nb * 64, c0, tap);
                }
            }
        }
        return;
    }

    // Consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63.
    const int ct = t - 128;
    const int wg = ct / 128;
    const int lane = ct % 32;
    const bool odd = lane & 1;
    const int col = 2 * (lane % 4) - (odd ? 2 : 0);
    const int row = wg * 64 + (ct % 128) / 32 * 16 + lane / 4 + (odd ? 8 : 0);
    // f32 split: thread ct takes 16-byte chunk ct % 8 of rows ct / 8 + 32 i
    const uint32_t split_off = static_cast<uint32_t>(ct / 8 * kRowBytes +
                                                     ct % 8 * 16);
    // bf16 accumulates in acc on the tensor cores from the first product
    // (scale-d 0): no other instruction writes acc while wgmmas are in
    // flight, so ptxas keeps them asynchronous. f32 sums each K block in
    // part and adds it to acc.
    float acc[BN / 2];
    float part[BN / 2];
    int64_t g = 0;                                   // blocks consumed
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int img0, h0, w0, n0;
        tile_origin(tile, pt, img0, h0, w0, n0, BN);
        if constexpr (C::kTf32) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
        }
        for (int kb = 0; kb < nk; ++kb, ++g) {
            const int s = static_cast<int>(g % STAGES);
            mbar_wait(full(s), static_cast<uint32_t>((g / STAGES) & 1));
            const uint32_t sa = base + static_cast<uint32_t>(s * C::kStage);
            if constexpr (C::kTf32) {
                uint8_t* sp = smem + s * C::kStage + split_off;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    split_tf32(sp + i * 32 * kRowBytes, C::kLo);
#pragma unroll
                for (int i = 0; i < BN / 32; ++i)
                    split_tf32(sp + C::kATile + i * 32 * kRowBytes, C::kLo);
                fence_proxy_async();
                asm volatile("bar.sync 1, 256;\n" ::: "memory");  // consumers
            }
            const uint64_t da = sw128_desc(sa + wg * 64 * kRowBytes);
            const uint64_t db = sw128_desc(sa + C::kATile,
                                           C::kTf32 ? 16 : 8192);
            wgmma_fence();
            if constexpr (C::kTf32) {
                // 3xTF32 into a fresh partial sum per K block (the first
                // product with scale-d 0), added to acc by the FP32 units:
                // one tensor-core accumulation chain over all of K drifted
                // past the 1e-5 bar at the probe's largest K.
                constexpr uint64_t lo = C::kLo >> 4;
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {   // 32 bytes of K a step
                    const uint64_t a = da + 2 * kk, b = db + 2 * kk;
                    wgmma_tf32<BN>(part, a + lo, b, kk > 0);
                    wgmma_tf32<BN>(part, a, b + lo, 1);
                    wgmma_tf32<BN>(part, a, b, 1);
                }
            } else {
                // B is MN-major: a k16 step is two 8-k groups, 2048 bytes
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)     // 32 bytes of K a step
                    wgmma_bf16<BN>(acc, da + 2 * kk, db + 128 * kk,
                                   kb > 0 || kk > 0);
            }
            wgmma_commit();
            wgmma_wait<C::INFLIGHT>();
            if constexpr (C::kTf32) {
                fence_regs(part);
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
            }
            if (kb >= C::INFLIGHT)            // its wgmmas are retired
                mbar_arrive(empty(static_cast<int>((g - C::INFLIGHT) % STAGES)));
        }
        wgmma_wait<0>();
        if constexpr (C::INFLIGHT == 1)
            mbar_arrive(empty(static_cast<int>((g - 1) % STAGES)));
        fence_regs(acc);

        // Epilogue, overlapped with the producer's loads for the next
        // tile: lanes 2q and 2q+1 hold columns 4 apart of rows r and r + 8;
        // one shuffle gives each a float4 of one row, the even lane row r,
        // the odd lane row r + 8.
        const int pw = w0 + (row & (pt.bw - 1));
        const int ph = h0 + ((row >> pt.lbw) & (pt.bh - 1));
        const int pn = img0 + (row >> (pt.lbw + pt.lbh));
        const bool in_image = pw < wd && ph < h && pn < batch;
        const int64_t m = (static_cast<int64_t>(pn) * h + ph) * wd + pw;
        float* const dst = out + m * cout + n0 + col;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
            const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
            const float r0 = __shfl_xor_sync(apv::kFullMask, s0, 1);
            const float r1 = __shfl_xor_sync(apv::kFullMask, s1, 1);
            const float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                                 : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
            if (in_image && n0 + col + 8 * j < cout)
                *reinterpret_cast<float4*>(dst + 8 * j) = v;
        }
    }
}

// ---------------------------------------------------------------------------
// conv3x3_simt: widths that are not multiples of 8
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;
constexpr int kSimtBM = 128;   // output pixels per block
constexpr int kSimtBN = 64;    // output channels per block
constexpr int kSimtBK = 16;    // K step through shared memory
constexpr int kTM = 8;         // pixels per thread
constexpr int kTN = 4;         // channels per thread
constexpr int kPadA = 4;       // A tile row padding: stores spread over banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
conv3x3_simt(const T* __restrict__ x, const T* __restrict__ w,
             float* __restrict__ out, int batch, int h, int wd, int cin,
             int cout) {
    constexpr int BM = kSimtBM, BN = kSimtBN, BK = kSimtBK, TM = kTM, TN = kTN;
    __shared__ float As[BK][BM + kPadA];
    __shared__ __align__(16) float Bs[BK][BN];

    const int64_t m_total = static_cast<int64_t>(batch) * h * wd;
    const int k_total = 9 * cin;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
    const int n0 = blockIdx.y * BN;
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
        for (int i = 0; i < BK / (kSimtThreads / BN); ++i) {
            const int kk = k0 + b_k + (kSimtThreads / BN) * i;
            const int n = n0 + b_n;
            Bs[b_k + (kSimtThreads / BN) * i][b_n] =
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

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A 128-byte-swizzled map of `rank` dims (innermost first) over `base`.
bool encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                const void* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
    const EncodeTiledFn encode = encode_tiled();
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    return encode && encode(map, dtype, rank, const_cast<void*>(base), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int pow2_at_least(int64_t v, int cap) {
    int p = 1;
    while (p < v && p < cap) p *= 2;
    return p;
}

int log2_of(int pow2) {
    int l = 0;
    while ((1 << l) < pow2) ++l;
    return l;
}

template <typename T, typename C>
int launch_wgmma(const void* x, const void* wb, float* out, int64_t batch,
                 int64_t h, int64_t wd, int64_t cin, int64_t cout,
                 cudaStream_t s) {
    PixelTiles pt;
    pt.bw = pow2_at_least(wd, 128);
    pt.bh = pow2_at_least(h, 128 / pt.bw);
    pt.bn = 128 / (pt.bw * pt.bh);
    pt.lbw = log2_of(pt.bw);
    pt.lbh = log2_of(pt.bh);
    pt.tiles_w = static_cast<int>((wd + pt.bw - 1) / pt.bw);
    pt.tiles_h = static_cast<int>((h + pt.bh - 1) / pt.bh);
    pt.n_tiles = static_cast<int>((cout + C::BN - 1) / C::BN);
    const int64_t tiles = static_cast<int64_t>(pt.tiles_w) * pt.tiles_h *
                          ((batch + pt.bn - 1) / pt.bn) * pt.n_tiles;

    const CUtensorMapDataType dt = C::kTf32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const cuuint64_t es = sizeof(T);
    CUtensorMap xmap, wmap;
    // x as (Cin, W, H, B); a box is 128 bytes of channels x the pixel tile
    const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cin),
                                 static_cast<cuuint64_t>(wd),
                                 static_cast<cuuint64_t>(h),
                                 static_cast<cuuint64_t>(batch)};
    const cuuint64_t xstrides[3] = {cin * es, wd * cin * es, h * wd * cin * es};
    const cuuint32_t xbox[4] = {C::kBK, static_cast<cuuint32_t>(pt.bw),
                                static_cast<cuuint32_t>(pt.bh),
                                static_cast<cuuint32_t>(pt.bn)};
    if (!encode_map(&xmap, dt, 4, x, xdims, xstrides, xbox))
        return static_cast<int>(cudaErrorInvalidValue);
    bool ok;
    if constexpr (C::kTf32) {   // [Cout, 9, Cin] as (Cin, 9, Cout): K-major
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cin), 9,
                                    static_cast<cuuint64_t>(cout)};
        const cuuint64_t strides[2] = {cin * es, 9 * cin * es};
        const cuuint32_t box[3] = {C::kBK, 1, C::BN};
        ok = encode_map(&wmap, dt, 3, wb, dims, strides, box);
    } else {                    // HWIO as (Cout, Cin, 9): MN-major
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cout),
                                    static_cast<cuuint64_t>(cin), 9};
        const cuuint64_t strides[2] = {cout * es, cin * cout * es};
        const cuuint32_t box[3] = {64, C::kBK, 1};
        ok = encode_map(&wmap, dt, 3, wb, dims, strides, box);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);

    const auto kernel = conv3x3_wgmma<T, C>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return apv::launch_status();
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // persistent
    kernel<<<grid, kThreads, C::kSmem, s>>>(
        xmap, wmap, out, static_cast<int>(batch), static_cast<int>(h),
        static_cast<int>(wd), static_cast<int>(cin), static_cast<int>(cout),
        pt, tiles);
    return apv::launch_status();
}

}  // namespace

// Tensor-core route: Cin and Cout multiples of 8, x and wb 16-byte aligned
// (TMA's strides and base; the wrapper copies a misaligned view); wb is w in HWIO for bf16, w transposed to
// [Cout, 9*Cin] for f32. Tilings: BN = 64 for Cout <= 64, else 128; the
// ring as deep as ~190 KB of shared memory allows for bf16, 4 and 3 stages
// of hi and lo halves for f32. One block an SM, persistent.
extern "C" int apv_conv3x3_wgmma(const void* x, const void* wb, float* out,
                                 int64_t batch, int64_t h, int64_t wd,
                                 int64_t cin, int64_t cout, int is_bf16,
                                 void* stream) {
    using Bf16 = __nv_bfloat16;
    const int64_t m_total = batch * h * wd;
    if (m_total <= 0 || cout <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    if (cin == 0)
        return static_cast<int>(cudaMemsetAsync(
            out, 0, static_cast<size_t>(m_total * cout) * sizeof(float), s));
    if (is_bf16) {
        return cout <= 64
            ? launch_wgmma<Bf16, Tiling<Bf16, 64, 8>>(x, wb, out, batch, h, wd,
                                                    cin, cout, s)
            : launch_wgmma<Bf16, Tiling<Bf16, 128, 4>>(x, wb, out, batch, h, wd,
                                                     cin, cout, s);
    }
    return cout <= 64
        ? launch_wgmma<float, Tiling<float, 64, 4>>(x, wb, out, batch, h, wd,
                                                  cin, cout, s)
        : launch_wgmma<float, Tiling<float, 128, 3>>(x, wb, out, batch, h, wd,
                                                   cin, cout, s);
}

// Any widths; w in HWIO.
extern "C" int apv_conv3x3_simt(const void* x, const void* w, float* out,
                                int64_t batch, int64_t h, int64_t wd,
                                int64_t cin, int64_t cout, int is_bf16,
                                void* stream) {
    const int64_t m_total = batch * h * wd;
    if (m_total <= 0 || cout <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>((m_total + kSimtBM - 1) / kSimtBM),
                    static_cast<unsigned>((cout + kSimtBN - 1) / kSimtBN));
    if (is_bf16) {
        conv3x3_simt<__nv_bfloat16><<<grid, kSimtThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w), out, static_cast<int>(batch),
            static_cast<int>(h), static_cast<int>(wd), static_cast<int>(cin),
            static_cast<int>(cout));
    } else {
        conv3x3_simt<float><<<grid, kSimtThreads, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), out,
            static_cast<int>(batch), static_cast<int>(h), static_cast<int>(wd),
            static_cast<int>(cin), static_cast<int>(cout));
    }
    return apv::launch_status();
}
