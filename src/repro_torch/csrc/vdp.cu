// VDP: out = sum_i x[i] * y[i] over n elements, float32 accumulator, float32
// 0-d result.
//
// Replaces src/repro/kernels/vdp/vdp.py::vdp_pallas (_vdp_kernel), which
// reshapes the vectors to a (rows, 1024) panel and lets a sequential TPU
// grid revisit one (1, 1) output block, adding each tile's sum into it.
//
// Bound on the H100: bytes.  Each element is read once for one
// multiply-add, so 2^26 float32 pairs (537 MB) take at least 0.16 ms at
// 3.35 TB/s.
//
// Design: GPU blocks run in no order, so the TPU's read-modify-write of one
// block becomes two passes.  Pass 1: a fixed number of blocks (chosen by
// the caller) walk the vectors grid-stride with 16-byte loads where
// aligned, accumulate in float32 and write one partial per block after a
// fixed-order block reduction.  Pass 2: one block sums the partials in a
// fixed order.  No atomics, so the result is the same bits run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
vdp_partial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   float* __restrict__ partials, long long n, int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float acc = 0.f;
  long long start = 0;
  if (vec) {
    constexpr int V = halo::Vec16<T>::kN;
    const long long nv = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 rx = xv[i], ry = yv[i];
      const T* px = reinterpret_cast<const T*>(&rx);
      const T* py = reinterpret_cast<const T*>(&ry);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = fmaf(halo::to_float(px[j]), halo::to_float(py[j]), acc);
    }
    start = nv * V;
  }
  for (long long i = start + tid; i < n; i += stride)
    acc = fmaf(halo::to_float(x[i]), halo::to_float(y[i]), acc);
  acc = halo::block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
vdp_final_kernel(const float* __restrict__ partials, float* __restrict__ out, int nparts) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += partials[i];
  acc = halo::block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

// partials: nparts float32 scratch; out: one float32.  vec: x and y 16-byte
// aligned.
extern "C" int halo_vdp(const void* x, const void* y, void* partials, void* out,
                        long long n, int nparts, int dtype, int vec, void* stream) {
  if (nparts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  HALO_DISPATCH_TYPE(dtype, T,
      vdp_partial_kernel<T><<<(unsigned)nparts, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(y), p, n, vec))
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  vdp_final_kernel<<<1, kThreads, 0, s>>>(p, static_cast<float*>(out), nparts);
  return static_cast<int>(cudaGetLastError());
}
