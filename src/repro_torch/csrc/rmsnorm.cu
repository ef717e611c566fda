// RMSNORM: out(R,D) = x * rsqrt(mean(x^2) + eps) * gamma, row by row, in
// float32, rounded once to the input type (float32, bfloat16 or float16).
//
// Replaces src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas
// (_rmsnorm_kernel), which keeps a (br, D) row tile in VMEM, masks the
// columns padded to 128 out of the variance, and writes the scaled tile.
//
// Bound on the H100: bytes.  Each element of x is read once and written
// once with three operations between, so at 4096x2560 bfloat16 the 42 MB
// take at least 0.0125 ms at 3.35 TB/s, against 32 MFLOP.
//
// Design: no padding, so any D works.  Rows that are 16-byte aligned and
// fill whole 16-byte vectors, up to 512 vectors (4096 bfloat16, 2048
// float32), take one warp per row, eight rows per 256-thread block: each
// lane loads its vectors once into registers, sums x^2 in float32, the warp
// reduces by shuffles, and the lane scales the values it holds, so x is
// read from device memory once.  Other rows take one 256-thread block per
// row: pass one sums x^2 (reduced across warps through shared memory), pass
// two reads the row again, from L1/L2.  Both write (x * r) * gamma with
// r = __frsqrt_rn(sum / D + eps), a correctly rounded reciprocal square
// root, never the approximate rsqrtf.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRows = kThreads / 32;
constexpr int kMaxVecs = 16;  // 16-byte vectors a lane holds in registers

// Sum of x^2 over elements [start, D) of row x with stride `step`.
template <typename T>
__device__ __forceinline__ float sum_squares(const T* __restrict__ x, int D, int start,
                                             int step, int vec) {
  float acc = 0.f;
  if (vec) {
    constexpr int V = halo::Vec16<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = start; i < D / V; i += step) {
      const uint4 r = xv[i];
      const T* p = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = halo::to_float(p[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    for (int i = start; i < D; i += step) {
      const float f = halo::to_float(x[i]);
      acc = fmaf(f, f, acc);
    }
  }
  return acc;
}

// out[i] = (x[i] * r) * gamma[i] over elements [start, D) with stride `step`.
template <typename T>
__device__ __forceinline__ void scale_row(const T* __restrict__ x, const T* __restrict__ g,
                                          T* __restrict__ out, int D, int start, int step,
                                          float r, int vec) {
  if (vec) {
    constexpr int V = halo::Vec16<T>::kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* gv = reinterpret_cast<const uint4*>(g);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int i = start; i < D / V; i += step) {
      const uint4 rx = xv[i], rg = gv[i];
      const T* px = reinterpret_cast<const T*>(&rx);
      const T* pg = reinterpret_cast<const T*>(&rg);
      uint4 ro;
      T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int j = 0; j < V; ++j)
        po[j] = halo::from_float<T>(__fmul_rn(__fmul_rn(halo::to_float(px[j]), r),
                                              halo::to_float(pg[j])));
      ov[i] = ro;
    }
  } else {
    for (int i = start; i < D; i += step)
      out[i] = halo::from_float<T>(__fmul_rn(__fmul_rn(halo::to_float(x[i]), r),
                                             halo::to_float(g[i])));
  }
}

__device__ __forceinline__ float inv_rms(float sum, int D, float eps) {
  return __frsqrt_rn(__fadd_rn(__fdiv_rn(sum, (float)D), eps));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_regs_kernel(const T* __restrict__ X, const T* __restrict__ G, T* __restrict__ O,
                    int R, int D, float eps) {
  constexpr int V = halo::Vec16<T>::kN;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform across the warp
  const int nvec = D / V;
  const uint4* xv = reinterpret_cast<const uint4*>(X + (size_t)row * D);
  uint4 held[kMaxVecs];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    if (lane + 32 * k < nvec) {
      held[k] = xv[lane + 32 * k];
      const T* p = reinterpret_cast<const T*>(&held[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = halo::to_float(p[j]);
        s = fmaf(f, f, s);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float r = inv_rms(s, D, eps);
  const uint4* gv = reinterpret_cast<const uint4*>(G);
  uint4* ov = reinterpret_cast<uint4*>(O + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      const uint4 rg = gv[i];
      const T* px = reinterpret_cast<const T*>(&held[k]);
      const T* pg = reinterpret_cast<const T*>(&rg);
      uint4 ro;
      T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int j = 0; j < V; ++j)
        po[j] = halo::from_float<T>(__fmul_rn(__fmul_rn(halo::to_float(px[j]), r),
                                              halo::to_float(pg[j])));
      ov[i] = ro;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_kernel(const T* __restrict__ X, const T* __restrict__ G, T* __restrict__ O,
                     int D, float eps, int vec) {
  __shared__ float total;
  const T* x = X + (size_t)blockIdx.x * D;
  const float s = halo::block_sum(sum_squares(x, D, threadIdx.x, kThreads, vec));
  if (threadIdx.x == 0) total = s;
  __syncthreads();
  scale_row(x, G, O + (size_t)blockIdx.x * D, D, threadIdx.x, kThreads,
            inv_rms(total, D, eps), vec);
}

}  // namespace

// x (rows, d) and gamma (d) in one type; vec: x, gamma and out 16-byte
// aligned and d * sizeof(T) a multiple of 16.
extern "C" int halo_rmsnorm(const void* x, const void* gamma, void* out, int rows, int d,
                            float eps, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned warp_blocks = (unsigned)((rows + kWarpRows - 1) / kWarpRows);
  HALO_DISPATCH_TYPE(dtype, T,
      if (vec && d <= 32 * kMaxVecs * halo::Vec16<T>::kN) {
        rmsnorm_regs_kernel<T><<<warp_blocks, kThreads, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out),
            rows, d, eps);
      } else {
        rmsnorm_block_kernel<T><<<(unsigned)rows, kThreads, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out),
            d, eps, vec);
      })
  return static_cast<int>(cudaGetLastError());
}
