// Shared device helpers for the HALO Hopper kernels.
//
// Every kernel reads float32, bfloat16 or float16 and computes in float32;
// results are rounded back to the input type to nearest-even, as PyTorch
// rounds.  The C entry points take a type code: 0 float32, 1 bfloat16,
// 2 float16.
#pragma once

#include <cstdint>

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

// x, y rounded to the 16-bit type T to nearest-even in one register (x in
// the low half); x and y are left holding their rounded values in float32.
template <typename T> __device__ __forceinline__ uint32_t round_pair(float& x, float& y);
template <>
__device__ __forceinline__ uint32_t round_pair<__nv_bfloat16>(float& x, float& y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  x = __low2float(p);
  y = __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}
template <> __device__ __forceinline__ uint32_t round_pair<__half>(float& x, float& y) {
  const __half2 p = __floats2half2_rn(x, y);
  x = __low2float(p);
  y = __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Elements of T in one 16-byte vector load.
template <typename T> struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

// The kN values of a 16-byte vector of T (as loaded into a uint4) in
// float32; the 16-bit types widen exactly.
template <typename T>
__device__ __forceinline__ void unpack16(uint4 u, float (&f)[Vec16<T>::kN]);
template <>
__device__ __forceinline__ void unpack16<float>(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<__half>(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
  }
}

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
