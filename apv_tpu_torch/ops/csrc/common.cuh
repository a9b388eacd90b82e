// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point has a plain C interface (loaded with
// ctypes): raw device pointers, sizes, and the caller's cudaStream_t, and it
// returns the cudaError_t of its launch (0 on success). Kernels allocate
// nothing and never synchronise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apv {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
    return v;  // lane 0 holds the warp's sum
}

// Sum over a block of blockDim.x threads (a multiple of 32, at most 1024);
// the result is valid in thread 0. Warp shuffles first, then one
// shared-memory pass that sums the warps in warp order: the same bits on
// every call.
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float partial[32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) partial[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.0f;
        v = warp_sum(v);
    }
    return v;
}

inline bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace apv
