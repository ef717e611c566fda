// MMM: C(M,N) = A(M,K) @ B(K,N), row-major, float32 accumulator, output in
// the input type (float32, bfloat16 or float16).
//
// Replaces src/repro/kernels/matmul/matmul.py::mmm_pallas (_mmm_kernel),
// which walks (bm, bn) output tiles with K innermost and an f32 VMEM
// accumulator on the TPU's MXU.
//
// Bound on the H100: operations.  At 4096^3 the product needs 2*M*N*K =
// 137 GFLOP against 201 MB of operands and result, so float32 on the CUDA
// cores (67 TFLOP/s) takes at least 2.05 ms while the bytes take 0.06 ms.
//
// Design (simple first): one 256-thread block per 128x128 output tile; the
// K loop stages a 128x16 slice of A (transposed, padded against bank
// conflicts) and a 16x128 slice of B through shared memory as float32;
// each thread keeps an 8x8 register micro-tile whose rows and columns are
// strided by 16, so shared-memory reads broadcast or hit 16 distinct banks
// and the final stores are coalesced.  Edges are masked on load (zero
// fill) and on store, so any M, N, K works without padding copies.  Each
// operand element is reused 128 times from shared memory, which keeps the
// kernel on the arithmetic side; wgmma, TMA and pipelining are left for
// later work.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kTM = 8, kTN = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // As row padding: store conflicts drop from 16- to 2-way

template <typename T>
__global__ void __launch_bounds__(kThreads)
mmm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
           int M, int N, int K) {
  __shared__ float As[kBK][kBM + kPad];
  __shared__ float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns tx + 16*j
  const int ty = tid / 16;  // owns rows ty + 16*i
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? halo::to_float(A[(size_t)gr * K + gc]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? halo::to_float(B[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(size_t)r * N + c] = halo::from_float<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int halo_mmm(const void* a, const void* b, void* c, int m, int n, int k,
                        int dtype, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      mmm_kernel<T><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
          m, n, k))
  return static_cast<int>(cudaGetLastError());
}
