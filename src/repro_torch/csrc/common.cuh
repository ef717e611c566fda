// Shared device helpers for the HALO Hopper kernels.
//
// Every kernel reads float32, bfloat16 or float16 and computes in float32;
// results are rounded back to the input type to nearest-even, as PyTorch
// rounds.  The C entry points take a type code: 0 float32, 1 bfloat16,
// 2 float16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace halo {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// Elements of T in one 16-byte vector load.
template <typename T> struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

// Sum of v over the block, valid in thread 0.  Fixed order: warp shuffles,
// then the first warp over the per-warp sums.  blockDim.x must be a
// multiple of 32, at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace halo

// Runs `body` with `T` bound to the element type of type code `code`;
// returns cudaErrorInvalidValue from the enclosing function for an unknown
// code.
#define HALO_DISPATCH_TYPE(code, T, ...)                 \
  switch (code) {                                        \
    case 0: { using T = float; __VA_ARGS__; break; }     \
    case 1: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    case 2: { using T = __half; __VA_ARGS__; break; }    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
