// FFT, radix route: the DFT of each row of a real batch x(M,n) for n a
// power of two, 1 <= n <= 4096, by a Stockham (self-sorting) FFT in shared
// memory, written as complex64 (re, im interleaved).
//
// Replaces src/repro/kernels/fft/fft.py::fft_pallas (_fft_kernel), the
// reference's O(n^2) DFT as two products against n x n twiddle matrices,
// for the transform sizes that are powers of two (csrc/fft_chirp.cu takes
// the others).
//
// Bound on the H100: bytes.  The transform reads x once and writes the
// complex output once, 96 MB at M = 2048, n = 4096 float32, 0.030 ms at
// 3.35 TB/s; its 2.5*M*n*log2(n) operations take 0.004 ms at 67 TFLOP/s.
// The DFT's own floor was 4*M*n^2 operations, 2.05 ms.
//
// Design: a real row of n values is one complex FFT of h = n/2 values,
// z[t] = x[2t] + i*x[2t+1], and a post-pass: with E = (Z[k] +
// conj(Z[h-k]))/2 and O = -i*(Z[k] - conj(Z[h-k]))/2, X[k] = E + w^k*O and
// X[k+h] = E - w^k*O, w = exp(-2*pi*i/n), which halves the shared-memory
// work of a full complex transform.  A 256-thread block transforms one row
// (h >= 1024) or 1024/h rows in one static shared buffer of at most 2048
// complex values (16 KB).  It reads its rows, which lie back to back in x,
// with 16-byte loads (scalar where x is off the 16-byte grid), and each
// thread writes X[k] and X[k+h] for its k, neighbouring threads on
// neighbouring k.  The h-point FFT is a Stockham (self-sorting) one in
// place (the stages of fft_stockham.cuh, shared with fft_chirp.cu): with p
// the length of the sub-transforms done so far, a radix-2
// stage first when log2(h) is odd, then radix-4 stages; stage R reads
// u_r = buf[i + r*h/R] for each of its h/R butterflies i, multiplies u_r
// by w_h^(r*k*h/(R*p)) with k = i mod p, takes the R-point DFT and writes
// it to buf[(i - k)*R + k + r*p].  Each thread keeps its butterflies'
// values in registers between a read and a write phase, so one buffer
// suffices.  The twiddles come from one table of n complex values
// (w_h^e = w^(2e)) that the wrapper builds on the card once per n: angles
// 2*pi*j/n taken in float64 and rounded to float32 once
// (kernels/fft/ref.py, radix_twiddles); the kernel computes no sine or
// cosine.
#include "common.cuh"
#include "fft_stockham.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 4096;

// Threads per row of h complex values: one radix-4 butterfly each below
// h = 1024, 256 from there (1 to 4 butterflies each).
__host__ __device__ __forceinline__ int threads_per_row(int h) {
  return h >= 1024 ? kThreads : (h >= 4 ? h / 4 : 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fft_radix_kernel(const T* __restrict__ x, const float2* __restrict__ tw,
                 float2* __restrict__ out, int M, int n, int log2h, int vec) {
  __shared__ __align__(16) float2 buf[kMaxN / 2];
  if (n == 1) {  // X[0] = x[0]
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < M; i += gridDim.x * kThreads)
      out[i] = make_float2(halo::to_float(x[i]), 0.f);
    return;
  }
  const int h = n / 2;
  const int tpr = threads_per_row(h);
  const int rpb = kThreads / tpr;
  const int row0 = blockIdx.x * rpb;
  const int rows = min(rpb, M - row0);
  const int total = rows * h;  // complex values z of this block

  // z[t] = x[2t] + i*x[2t+1]: the block's rows lie back to back in x
  const T* xb = x + (size_t)row0 * n;
  int done = 0;
  if (vec) {
    constexpr int V = halo::Vec16<T>::kN;
    const int nv = 2 * total / V;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float f[V];
      halo::unpack16<T>(__ldg(reinterpret_cast<const uint4*>(xb) + i), f);
#pragma unroll
      for (int j = 0; j < V / 2; ++j) buf[i * (V / 2) + j] = make_float2(f[2 * j], f[2 * j + 1]);
    }
    done = nv * (V / 2);
  }
  for (int i = done + threadIdx.x; i < total; i += kThreads)
    buf[i] = make_float2(halo::to_float(xb[2 * i]), halo::to_float(xb[2 * i + 1]));
  __syncthreads();

  // Z = the h-point FFT of z; every thread runs every stage (a row past M
  // transforms garbage it never stores), so the block's barriers line up
  const int t = threadIdx.x % tpr;
  const int rl = threadIdx.x / tpr;
  float2* row = buf + rl * h;
  halo::stockham<4, 4>(row, tw, h, log2h, n, t, tpr);

  // X[k] = E[k] + w^k O[k] and X[k+h] = E[k] - w^k O[k], with
  // E = (Z[k] + conj(Z[h-k])) / 2 and O = -i (Z[k] - conj(Z[h-k])) / 2
  if (rl < rows) {
    float2* o = out + (size_t)(row0 + rl) * n;
    for (int k = t; k < h; k += tpr) {
      const float2 zk = row[k], zm = row[(h - k) & (h - 1)];
      const float2 e = make_float2((zk.x + zm.x) * 0.5f, (zk.y - zm.y) * 0.5f);
      const float2 od = make_float2((zk.y + zm.y) * 0.5f, (zm.x - zk.x) * 0.5f);
      const float2 wo = halo::cmul(od, __ldg(tw + k));
      o[k] = halo::cadd(e, wo);
      o[k + h] = halo::csub(e, wo);
    }
  }
}

}  // namespace

// x (m, n) in the type of `dtype`, n a power of two <= 4096; tw (n)
// complex64 twiddles exp(-2*pi*i*j/n); out (m, n) complex64, 16-byte
// aligned.  vec: x is 16-byte aligned.
extern "C" int halo_fft_radix(const void* x, const void* tw, void* out, int m, int n,
                              int vec, int dtype, void* stream) {
  if (m < 1 || n < 1 || n > kMaxN || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2h = 0;
  while ((2 << log2h) < n) ++log2h;
  const int rpb = n == 1 ? kThreads : kThreads / threads_per_row(n / 2);
  const long long blocks = (m + (long long)rpb - 1) / rpb;
  const unsigned grid = static_cast<unsigned>(n == 1 && blocks > 4096 ? 4096 : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      fft_radix_kernel<T><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const float2*>(tw),
          static_cast<float2*>(out), m, n, log2h, vec))
  return static_cast<int>(cudaGetLastError());
}
