// FFT, chirp route: the DFT of each row of a real batch x(M,n) for n not a
// power of two, 3 <= n <= 4095, by Bluestein's chirp-z identity on
// power-of-two Stockham FFTs in shared memory, written as complex64
// (re, im interleaved).
//
// Replaces src/repro/kernels/fft/fft.py::fft_pallas (_fft_kernel), the
// reference's O(n^2) DFT as two products against n x n twiddle matrices,
// for the transform sizes that are not powers of two (csrc/fft_radix.cu
// takes those).
//
// Bound on the H100: bytes.  The transform reads x once and writes the
// complex output once, 73.7 MB at M = 2048, n = 3000 float32, 0.0220 ms at
// 3.35 TB/s.  Each row also reads the L-point filter spectrum H (64 KB at
// L = 8192) and the n-point chirp from L2, which holds them for every row.
// The algorithm's own floor is higher: two complex L-point FFTs a row,
// 2 * 5*L*log2(L) operations (2.2 GFLOP at 2048 rows of L = 8192, 0.033 ms
// at 67 TFLOP/s), and 14 Stockham stages that each read and write the
// row's L values in shared memory (3.8 GB at 2048 rows, ~0.11 ms at the
// H100's ~33 TB/s of shared-memory bandwidth).  The DFT's floor was
// 4*M*n^2 operations, 1.1 ms at n = 3000.
//
// Design: with b_j = exp(-i*pi*j^2/n), X[k] = b_k * sum_t (x[t]*b_t) *
// conj(b_(k-t)), a circular convolution of length L, the least power of
// two >= 2n - 1 (at most 8192), computed as IFFT(FFT(a) * H) with a_t =
// x_t*b_t zero-padded to L and H the FFT of the wrapped filter h_j =
// conj(b_|j|), scaled by 1/L.  The wrapper builds the three tables once per
// n (kernels/fft/ref.py, chirp_tables): the chirp from j^2 mod 2n reduced
// in integers and the angle taken in float64, H in float64, and the
// L-point twiddles of radix_twiddles, each rounded to float32 once; the
// kernel computes no sine or cosine.  One fused pass per row in one
// dynamic shared-memory buffer of L complex values (64 KB at L = 8192; a
// 512-thread block takes 8192/L rows where L is shorter, as fft_radix.cu
// packs short rows): read the block's rows, which lie back to back in x,
// with 16-byte loads (scalar before and after the 16-byte grid) and
// multiply by the chirp, zero the padding; the forward L-point Stockham
// FFT (the stages of fft_stockham.cuh, shared with fft_radix.cu: a radix-2
// stage first when log2(L) is odd, then radix-4 stages, L/16 threads a
// row, at most 8 radix-2 or 4 radix-4 butterflies each, twiddles from the
// table in device memory through the read-only cache); conj(A * H) point
// by point; the forward FFT again, so that conj of its result is the
// inverse; X[k] = b_k * conj(.) for k < n, neighbouring threads on
// neighbouring outputs.  The stages, not the bytes, bound it: each reads
// and writes the whole row in shared memory, seven times per FFT.
#include <cstdint>

#include "common.cuh"
#include "fft_stockham.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = 4095;
constexpr int kMaxL = 8192;

// Threads per row of L complex values: L/16, so that a radix-4 stage gives
// each 4 butterflies and a radix-2 stage 8; one for L = 8.
__host__ __device__ __forceinline__ int threads_per_row(int L) {
  return L >= 16 ? L / 16 : 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fft_chirp_kernel(const T* __restrict__ x, const float2* __restrict__ chirp,
                 const float2* __restrict__ spectrum, const float2* __restrict__ tw,
                 float2* __restrict__ out, int M, int n, int L, int log2L) {
  extern __shared__ __align__(16) float2 buf[];
  const int tpr = threads_per_row(L);
  const int rpb = kThreads / tpr;
  const int row0 = blockIdx.x * rpb;
  const int rows = min(rpb, M - row0);
  const int span = rows * n;  // x values of this block, back to back

  // a[t] = x[t] * b[t] for t < n
  const T* xb = x + (size_t)row0 * n;
  const auto put = [&](int f, float v) {
    const int r = f / n, t = f - r * n;
    const float2 b = __ldg(chirp + t);
    buf[r * L + t] = make_float2(v * b.x, v * b.y);
  };
  constexpr int V = halo::Vec16<T>::kN;
  const int head = min(span, static_cast<int>(
      ((16 - reinterpret_cast<uintptr_t>(xb) % 16) % 16) / sizeof(T)));
  const int nv = (span - head) / V;
  for (int i = threadIdx.x; i < head; i += kThreads) put(i, halo::to_float(xb[i]));
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    float f[V];
    halo::unpack16<T>(__ldg(reinterpret_cast<const uint4*>(xb + head) + i), f);
#pragma unroll
    for (int j = 0; j < V; ++j) put(head + i * V + j, f[j]);
  }
  for (int i = head + nv * V + threadIdx.x; i < span; i += kThreads)
    put(i, halo::to_float(xb[i]));
  // and 0 for n <= t < L
  const int pad = L - n;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    buf[r * L + n + (i - r * pad)] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  // every thread runs every stage (a row past M transforms garbage it
  // never stores), so the block's barriers line up
  const int t = threadIdx.x % tpr;
  float2* row = buf + (threadIdx.x / tpr) * L;
  halo::stockham<8, 4>(row, tw, L, log2L, L, t, tpr);
  // conj(A * H): the next forward FFT of it is conj of the inverse
  for (int i = threadIdx.x; i < rows * L; i += kThreads) {
    const float2 c = halo::cmul(buf[i], __ldg(spectrum + (i & (L - 1))));
    buf[i] = make_float2(c.x, -c.y);
  }
  __syncthreads();
  halo::stockham<8, 4>(row, tw, L, log2L, L, t, tpr);

  // X[k] = b_k * conj(c_k)
  float2* o = out + (size_t)row0 * n;
  for (int f = threadIdx.x; f < span; f += kThreads) {
    const int r = f / n, k = f - r * n;
    const float2 c = buf[r * L + k];
    o[f] = halo::cmul(make_float2(c.x, -c.y), __ldg(chirp + k));
  }
}

template <typename T>
int launch(const void* x, const void* chirp, const void* spectrum, const void* tw, void* out,
           int m, int n, cudaStream_t s) {
  int L = 1, log2L = 0;
  while (L < 2 * n - 1) {
    L *= 2;
    ++log2L;
  }
  const int rpb = kThreads / threads_per_row(L);
  const size_t smem = (size_t)rpb * L * sizeof(float2);
  const cudaError_t e = cudaFuncSetAttribute(
      fft_chirp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((m + (long long)rpb - 1) / rpb);
  fft_chirp_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float2*>(chirp),
      static_cast<const float2*>(spectrum), static_cast<const float2*>(tw),
      static_cast<float2*>(out), m, n, L, log2L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, n) in the type of `dtype`, n not a power of two, 3 <= n <= 4095;
// chirp (n), spectrum and tw (L) complex64, L the least power of two >=
// 2n - 1 (kernels/fft/ref.py, chirp_tables); out (m, n) complex64.
extern "C" int halo_fft_chirp(const void* x, const void* chirp, const void* spectrum,
                              const void* tw, void* out, int m, int n, int dtype,
                              void* stream) {
  if (m < 1 || n < 3 || n > kMaxN || (n & (n - 1)) == 0 || 2 * n - 1 > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T, return launch<T>(x, chirp, spectrum, tw, out, m, n, s))
  return static_cast<int>(cudaErrorInvalidValue);
}
