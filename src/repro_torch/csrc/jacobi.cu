// JS: one fused Jacobi sweep for a square system A x = b,
//   x'(i) = (b(i) - (sum_j A(i,j) x(j) - d(i) x(i))) / d(i),  d = diag(A),
// row-major A, float32 accumulator, x' in the input type.
//
// Replaces src/repro/kernels/jacobi/jacobi.py::jacobi_step_pallas
// (_jacobi_kernel), which walks (bm, bk) tiles of A with an f32 VMEM
// accumulator per row block and applies the update in the last K step; its
// wrapper pads A with an identity diagonal to whole tiles and passes diag(A)
// as a fourth operand.
//
// Bound on the H100: bytes.  Every element of A is read once for one
// multiply-add, so at n = 8192 float32 the 268 MB of A (plus x, b and x',
// 4(n^2 + 3n) bytes in all) take at least 0.080 ms at 3.35 TB/s.
//
// Design: the MVM kernel (mvm.cu) with the update fused into each row's
// end.  One warp per row, eight rows per 256-thread block; lanes walk the
// row with coalesced 16-byte loads where A's rows and x are 16-byte aligned,
// accumulate in float32 and reduce with warp shuffles.  Lane 0 then reads
// the diagonal A(i,i) itself and writes x'(i): the residual, the diagonal
// correction and the division cost no extra pass over A.  Rows past n are
// masked, so nothing is padded and no row divides by a padded zero.
//
// The diagonal product is left out of the sum instead of being added and
// then subtracted (A x - d x): in a diagonally dominant row d(i) x(i) is
// about sqrt(n) times the rest of the sum, so adding it first would make
// every later addition round at its scale and leave that rounding behind
// when it cancels (about u * n relative to x'(i)).  Left out, the row sums
// like an MVM row; the select costs no bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const T* __restrict__ A, const T* __restrict__ x, const T* __restrict__ b,
              T* __restrict__ out, int n, int vec) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const T* a = A + (size_t)row * n;
  float acc = 0.f;
  if (vec) {
    constexpr int V = halo::Vec16<T>::kN;
    const int nv = n / V;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = lane; i < nv; i += 32) {
      const uint4 ra = av[i], rx = xv[i];
      const T* pa = reinterpret_cast<const T*>(&ra);
      const T* px = reinterpret_cast<const T*>(&rx);
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc = fmaf(i * V + j == row ? 0.f : halo::to_float(pa[j]), halo::to_float(px[j]), acc);
    }
  } else {
    for (int i = lane; i < n; i += 32)
      acc = fmaf(i == row ? 0.f : halo::to_float(a[i]), halo::to_float(x[i]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // acc = sum over j != row of A(row,j) x(j)
    const float d = halo::to_float(a[row]);
    out[row] = halo::from_float<T>(__fdiv_rn(__fsub_rn(halo::to_float(b[row]), acc), d));
  }
}

}  // namespace

// vec: A and x 16-byte aligned and n * sizeof(T) a multiple of 16.
extern "C" int halo_jacobi(const void* a, const void* x, const void* b, void* out, int n,
                           int dtype, int vec, void* stream) {
  const unsigned blocks = (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      jacobi_kernel<T><<<blocks, kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const T*>(x), static_cast<const T*>(b),
          static_cast<T*>(out), n, vec))
  return static_cast<int>(cudaGetLastError());
}
