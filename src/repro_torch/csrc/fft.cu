// FFT: the DFT of each row of a real batch x(M,N) by twiddle matrices,
//   re(r,f) = sum_t x(r,t) C(t,f),  im(r,f) = sum_t x(r,t) S(t,f),
// C = cos and S = -sin of 2*pi*((t*f) mod N)/N in float32, float32
// accumulators, written as complex64 (re, im interleaved).
//
// Replaces src/repro/kernels/fft/fft.py::fft_pallas (_fft_kernel), which
// walks (bm, bn) frequency tiles with the time axis innermost and keeps two
// f32 VMEM accumulators, one per plane, for the MXU.
//
// Bound on the H100: bytes.  The transform reads x once and writes the
// complex output once, 96 MB at M = 2048, N = 4096, 0.03 ms at 3.35 TB/s;
// its 2.5*M*N*log2(N) operations take less.  This kernel's O(N^2)
// algorithm, the reference's, has a floor of its own: two products of
// (M,N) by (N,N), 4*M*N^2 = 137 GFLOP, at least 2.05 ms at 67 TFLOP/s
// (float32 on the CUDA cores).  A radix FFT is later work.
//
// Design (mmm.cu's tiling, two planes): one 256-thread block per 128-row x
// 64-frequency output tile; the time loop stages a 128x16 slice of x
// (transposed, padded against bank conflicts) and 16x64 slices of C and S
// through shared memory; each thread keeps an 8x4 register micro-tile per
// plane (64 accumulators), rows and columns strided by 16, so every x value
// read from shared memory feeds 8 multiply-adds and every twiddle 8.  Edges
// are masked on load (zero fill: a zero time sample adds nothing) and on
// store, so any M and N run without padding copies; each thread stores
// (re, im) as one 8-byte float2.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 16;
constexpr int kTM = 8, kTN = 4;
constexpr int kThreads = 256;
constexpr int kPad = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fft_kernel(const T* __restrict__ x, const float* __restrict__ C,
           const float* __restrict__ S, float2* __restrict__ out, int M, int N) {
  __shared__ float Xs[kBK][kBM + kPad];
  __shared__ float Cs[kBK][kBN];
  __shared__ float Ss[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns frequencies tx + 16*j
  const int ty = tid / 16;  // owns rows ty + 16*i
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float re[kTM][kTN], im[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) re[i][j] = im[i][j] = 0.f;

  for (int t0 = 0; t0 < N; t0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gt = t0 + c;
      Xs[c][r] = (gr < M && gt < N) ? halo::to_float(x[(size_t)gr * N + gt]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int gt = t0 + r, gf = col0 + c;
      const bool in = gt < N && gf < N;
      Cs[r][c] = in ? C[(size_t)gt * N + gf] : 0.f;
      Ss[r][c] = in ? S[(size_t)gt * N + gf] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], c[kTN], s[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        c[j] = Cs[kk][tx + 16 * j];
        s[j] = Ss[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int f = col0 + tx + 16 * j;
      if (f < N) out[(size_t)r * N + f] = make_float2(re[i][j], im[i][j]);
    }
  }
}

}  // namespace

// x (m, n) in the type of `dtype`; c, s (n, n) float32; out (m, n) complex64.
extern "C" int halo_fft(const void* x, const void* c, const void* s, void* out, int m,
                        int n, int dtype, void* stream) {
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      fft_kernel<T><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const float*>(c),
          static_cast<const float*>(s), static_cast<float2*>(out), m, n))
  return static_cast<int>(cudaGetLastError());
}
