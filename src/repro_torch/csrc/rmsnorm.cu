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
// fill whole 16-byte vectors, up to 4096 vectors, take the rows kernel
// under a launch plan (rmsnorm_plan in kernels/rmsnorm/rmsnorm.py, a pure
// function of rows, D, the element size and the SM count): W warps share
// a row (W = 1, 2, 4 or 8; 8 / W rows to a 256-thread block), and each
// lane holds V 16-byte vectors of x and the same V vectors of gamma in
// registers, V a template argument sized to the row (V = ceil(vectors /
// 32W), 1..16), so a lane's registers follow D rather than the longest
// row.  A lane loads gamma and x together, sums x^2 in float32, the warp
// reduces by shuffles, the W warps of a row add their sums through shared
// memory in warp order, and the lane scales the values it holds: x is read
// from device memory once and the reduction order is fixed by the plan,
// with no atomics, so two calls give the same bits.  The plan takes W up
// from 1 until a lane holds at most 4 vectors and the blocks cover every
// SM (danube's rows of 2560 bfloat16: 4 warps a row, 3 vectors a lane, 64
// registers, 4 blocks an SM; 512 rows make 256 blocks over 132 SMs;
// decode's 4 rows take 8 warps a row).  Other rows (off the 16-byte grid, or longer)
// take one 256-thread block per row: pass one sums x^2 (reduced across
// warps through shared memory), pass two reads the row again, from L1/L2.
// Both write (x * r) * gamma with r = __frsqrt_rn(sum / D + eps), a
// correctly rounded reciprocal square root, never the approximate rsqrtf.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 16;  // 16-byte vectors a lane holds in registers, at most

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

// The rows kernel: warps_per_row (W) warps to a row, 8 / W rows to a
// block; lane l of the row's warp p holds vectors i = 32 p + l + 32 W k,
// k < V, of x and of gamma.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ X, const T* __restrict__ G, T* __restrict__ O,
                    int R, int D, float eps, int warps_per_row) {
  constexpr int E = halo::Vec16<T>::kN;
  __shared__ float partial[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / warps_per_row, part = warp % warps_per_row;
  const int row = blockIdx.x * (kWarps / warps_per_row) + group;
  const bool live = row < R;  // uniform across the warp
  const int nvec = D / E, first = 32 * part + lane, step = 32 * warps_per_row;
  const uint4* gv = reinterpret_cast<const uint4*>(G);
  const uint4* xv = reinterpret_cast<const uint4*>(X + (size_t)row * D);
  uint4 g[V], x[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = first + step * k;
    if (live && i < nvec) {
      g[k] = gv[i];
      x[k] = xv[i];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (live && first + step * k < nvec) {
      const T* p = reinterpret_cast<const T*>(&x[k]);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = halo::to_float(p[j]);
        s = fmaf(f, f, s);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (warps_per_row > 1) {
    // every warp of the block passes the barrier, live or not
    if (lane == 0) partial[warp] = s;
    __syncthreads();
    s = partial[group * warps_per_row];
    for (int q = 1; q < warps_per_row; ++q) s += partial[group * warps_per_row + q];
  }
  if (!live) return;
  const float r = inv_rms(s, D, eps);
  uint4* ov = reinterpret_cast<uint4*>(O + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = first + step * k;
    if (i < nvec) {
      const T* px = reinterpret_cast<const T*>(&x[k]);
      const T* pg = reinterpret_cast<const T*>(&g[k]);
      uint4 ro;
      T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int j = 0; j < E; ++j)
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

template <typename T, int V>
void launch_rows(const void* x, const void* gamma, void* out, int rows, int d, float eps,
                 int warps_per_row, unsigned blocks, cudaStream_t s) {
  rmsnorm_rows_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out), rows, d,
      eps, warps_per_row);
}

#define HALO_RMSNORM_V(n) \
  case n: launch_rows<T, n>(x, gamma, out, rows, d, eps, warps_per_row, blocks, s); break;

template <typename T>
int launch_rows_v(int vecs, const void* x, const void* gamma, void* out, int rows, int d,
                  float eps, int warps_per_row, unsigned blocks, cudaStream_t s) {
  switch (vecs) {
    HALO_RMSNORM_V(1) HALO_RMSNORM_V(2) HALO_RMSNORM_V(3) HALO_RMSNORM_V(4)
    HALO_RMSNORM_V(5) HALO_RMSNORM_V(6) HALO_RMSNORM_V(7) HALO_RMSNORM_V(8)
    HALO_RMSNORM_V(9) HALO_RMSNORM_V(10) HALO_RMSNORM_V(11) HALO_RMSNORM_V(12)
    HALO_RMSNORM_V(13) HALO_RMSNORM_V(14) HALO_RMSNORM_V(15) HALO_RMSNORM_V(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
#undef HALO_RMSNORM_V

}  // namespace

// x (rows, d) and gamma (d) in one type; vec: x, gamma and out 16-byte
// aligned and d * sizeof(T) a multiple of 16.  The launch plan:
// warps_per_row 1, 2, 4 or 8 with vecs (1..16) vectors a lane and `blocks`
// blocks of 8 / warps_per_row rows takes the rows kernel (vec rows only;
// 32 * warps_per_row * vecs must cover the row's vectors); warps_per_row 0
// takes the block kernel, one block per row (`blocks` = rows).
extern "C" int halo_rmsnorm(const void* x, const void* gamma, void* out, int rows, int d,
                            float eps, int dtype, int vec, int warps_per_row, int vecs,
                            int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  HALO_DISPATCH_TYPE(dtype, T,
      if (warps_per_row == 0) {
        rmsnorm_block_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out),
            d, eps, vec);
        return static_cast<int>(cudaGetLastError());
      }
      const long long nvec = d / halo::Vec16<T>::kN;
      if (!vec || (warps_per_row != 1 && warps_per_row != 2 && warps_per_row != 4 &&
                   warps_per_row != 8) ||
          vecs < 1 || vecs > kMaxVecs || 32LL * warps_per_row * vecs < nvec)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_rows_v<T>(vecs, x, gamma, out, rows, d, eps, warps_per_row,
                              (unsigned)blocks, s);)
  return static_cast<int>(cudaErrorInvalidValue);
}
