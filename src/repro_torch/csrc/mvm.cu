// MVM: y(M) = A(M,K) @ x(K), row-major A, float32 accumulator, y in the
// input type.
//
// Replaces src/repro/kernels/mvm/mvm.py::mvm_pallas (_mvm_kernel), which
// tiles rows (bm) and contracts K tiles on the VPU into an f32 (1, bm)
// accumulator, lane-major for the TPU's (8, 128) layout.
//
// Bound on the H100: bytes.  Every element of A is read once and used in
// one multiply-add, so at 8192x8192 float32 the 268 MB of A take at least
// 0.08 ms at 3.35 TB/s; x (32 KB) stays in L1/L2.
//
// Design: one warp per row, eight rows per 256-thread block.  Lanes walk
// the row with coalesced 16-byte loads when the row starts and x are
// 16-byte aligned (else one element at a time), accumulate in float32 and
// finish with a warp-shuffle reduction; lane 0 rounds and writes y[row].
// With 64 warps resident per SM the loads in flight cover HBM latency.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mvm_kernel(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y,
           int M, int K, int vec) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // uniform across the warp
  const T* a = A + (size_t)row * K;
  float acc = 0.f;
  if (vec) {
    constexpr int V = halo::Vec16<T>::kN;
    const int kv = K / V;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = lane; i < kv; i += 32) {
      const uint4 ra = av[i], rx = xv[i];
      const T* pa = reinterpret_cast<const T*>(&ra);
      const T* px = reinterpret_cast<const T*>(&rx);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = fmaf(halo::to_float(pa[j]), halo::to_float(px[j]), acc);
    }
  } else {
    for (int i = lane; i < K; i += 32) acc = fmaf(halo::to_float(a[i]), halo::to_float(x[i]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = halo::from_float<T>(acc);
}

}  // namespace

// vec: A and x 16-byte aligned and K * sizeof(T) a multiple of 16.
extern "C" int halo_mvm(const void* a, const void* x, void* y, int m, int k, int dtype,
                        int vec, void* stream) {
  const unsigned blocks = (unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      mvm_kernel<T><<<blocks, kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y),
          m, k, vec))
  return static_cast<int>(cudaGetLastError());
}
