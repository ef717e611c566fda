// MMM, skinny-M route: C(M,N) = A(M,K) @ B(K,N), row-major, float32
// accumulator, output in the input type (float32, bfloat16 or float16), for
// the few rows of a decode step (M = 1 to a few dozen).
//
// Replaces src/repro/kernels/matmul/matmul.py::mmm_pallas (_mmm_kernel) at
// small M, where the reference shrinks its row tile to 8
// (src/repro/kernels/matmul/ops.py::_mmm_raw, pick_block(m, 256, 8)).
//
// Bound on the H100: bytes.  At M = 4 the product does 2*M*K*N operations
// on 2*K*N bytes of B, 4 operations per byte, far below the ~295 where the
// tensor cores would become the limit; a 2560x6912 bfloat16 projection
// must read 35.4 MB, at least 10.6 us at 3.35 TB/s.  A 128-row output
// tile computes 124 masked rows at M = 4 and launches only ceil(N/128)
// blocks.
//
// Design: a 256-thread block owns a strip of 32*V columns (V = 8 bfloat16
// or float16, 4 float32: one 16-byte vector per thread, neighbouring lanes
// on neighbouring columns) and one segment of K, which its 8 warps split
// into 8 contiguous sub-segments.  Each warp walks its rows of B, 8 rows of
// 16-byte loads in flight per thread (4 at 16 rows), and multiplies them
// by A's rows, staged per warp in shared memory as float32 in chunks of 64
// k (a broadcast read per k and row) while the first loads of B are in
// flight; each thread keeps MT x V float32
// accumulators.  The block sums its 8 warps' partials through shared memory
// in warp order.  Where ceil(N / strip) blocks cannot fill the card, the
// grid also splits K across blocks (wrapper: skinny_plan, at most two
// blocks per SM, one wave); each split writes float32 partials to a workspace the wrapper
// allocated, and a second kernel sums the splits in split order and rounds
// once.  No atomics: two calls give the same bits.  Rows come in groups of
// MT = 1, 2, 4, 8 or 16 (grid.z walks groups of 16 beyond that).  A ragged
// N, an N that is not a multiple of V, or a B off the 16-byte grid takes
// the scalar load path (masked per element).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // rows of K staged per warp at a time

// Bits of one element, for the scalar loads that fill a 16-byte vector.
template <typename T> struct Bits { using type = unsigned short; };
template <> struct Bits<float> { using type = unsigned; };

// V elements of row k of B from column col: one 16-byte load, or V masked
// scalar loads (zero past N).
template <typename T, bool kVector>
__device__ __forceinline__ uint4 load_b(const T* __restrict__ B, int k, int col, int N) {
  constexpr int V = halo::Vec16<T>::kN;
  const T* p = B + (size_t)k * N + col;
  if (kVector) return __ldg(reinterpret_cast<const uint4*>(p));
  using U = typename Bits<T>::type;
  union { uint4 u; U v[V]; } x;
  const U* q = reinterpret_cast<const U*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) x.v[j] = col + j < N ? q[j] : U(0);
  return x.u;
}

// acc[m][j] += a[m] * b[j] for one row of K.
template <typename T, int MT>
__device__ __forceinline__ void fma_row(float (&acc)[MT][halo::Vec16<T>::kN],
                                        const float* a, uint4 raw) {
  constexpr int V = halo::Vec16<T>::kN;
  float b[V];
  halo::unpack16<T>(raw, b);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float am = a[m];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = fmaf(am, b[j], acc[m][j]);
  }
}

// Block (strip, split, group): the partial sums of rows group*MT ..
// +MT-1 over K segment [split*kb, split*kb + kb), warp w taking
// [split*kb + w*kw, +kw).  ws == nullptr: one split, round into C;
// otherwise float32 partials into ws[split][M][N].
template <typename T, int MT, bool kVector>
__global__ void __launch_bounds__(kThreads)
mmm_skinny_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
                  float* __restrict__ ws, int M, int N, int K, int kb, int kw) {
  constexpr int V = halo::Vec16<T>::kN;
  constexpr int BN = 32 * V;
  constexpr int kUnroll = MT >= 16 ? 4 : 8;
  __shared__ __align__(16) float As[kWarps][kChunk][MT];
  __shared__ __align__(16) float red[kWarps][BN];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.z * MT;
  const int rows = min(MT, M - row0);
  const int col = blockIdx.x * BN + lane * V;
  const bool active = col < N;
  const int seg0 = blockIdx.y * kb;
  const int k0 = seg0 + warp * kw;
  const int k1 = min(min(K, seg0 + kb), k0 + kw);
  const T* Ar = A + (size_t)row0 * K;

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;

  for (int c0 = k0; c0 < k1; c0 += kChunk) {
    const int cn = min(kChunk, k1 - c0);
    // every load of a batch is issued before its first use (the first
    // batch before A is staged); the guards of a short last batch are the
    // same for the whole warp
    uint4 raw[kUnroll];
    if (active) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < cn) raw[u] = load_b<T, kVector>(B, c0 + u, col, N);
    }
    // stage A[rows, c0 .. c0+cn) as As[warp][k][m]; lanes walk k, so the
    // global reads of each row are contiguous
    for (int idx = lane; idx < cn * MT; idx += 32) {
      const int m = idx / cn, r = idx - m * cn;
      As[warp][r][m] = m < rows ? halo::to_float(Ar[(size_t)m * K + c0 + r]) : 0.f;
    }
    __syncwarp();
    if (active) {
      for (int r = 0; r < cn; r += kUnroll) {
        if (r > 0) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (r + u < cn) raw[u] = load_b<T, kVector>(B, c0 + r + u, col, N);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (r + u < cn) fma_row<T, MT>(acc, As[warp][r + u], raw[u]);
      }
    }
    __syncwarp();
  }

  // sum the 8 warps' partials, warp 0 first, one output row at a time
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= rows) break;
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp][lane * V + j] = acc[m][j];
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      const int gc = blockIdx.x * BN + c;
      if (gc < N) {
        float s = red[0][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += red[w][c];
        const size_t o = (size_t)(row0 + m) * N + gc;
        if (ws) ws[(size_t)blockIdx.y * M * N + o] = s;
        else C[o] = halo::from_float<T>(s);
      }
    }
    __syncthreads();
  }
}

// C = the sum of the splits' partials, split 0 first, rounded once.  MT
// is the main kernel's, so a profile tells the two launches of each row
// count apart.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
mmm_skinny_reduce(const float* __restrict__ ws, T* __restrict__ C, long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < mn;
       i += (long long)gridDim.x * kThreads) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s += ws[(size_t)p * mn + i];
    C[i] = halo::from_float<T>(s);
  }
}

template <typename T, int MT>
cudaError_t launch(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
                   int splits, int kb, int kw, bool vec, cudaStream_t s) {
  constexpr int BN = 32 * halo::Vec16<T>::kN;
  const dim3 grid((n + BN - 1) / BN, splits, (m + MT - 1) / MT);
  if (vec)
    mmm_skinny_kernel<T, MT, true><<<grid, kThreads, 0, s>>>(a, b, c, ws, m, n, k, kb, kw);
  else
    mmm_skinny_kernel<T, MT, false><<<grid, kThreads, 0, s>>>(a, b, c, ws, m, n, k, kb, kw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)m * n;
  const long long blocks = (mn + kThreads - 1) / kThreads;
  mmm_skinny_reduce<T, MT><<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      ws, c, mn, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
                          int splits, int kb, int kw, bool vec, cudaStream_t s) {
  if (m <= 1) return launch<T, 1>(a, b, c, ws, m, n, k, splits, kb, kw, vec, s);
  if (m <= 2) return launch<T, 2>(a, b, c, ws, m, n, k, splits, kb, kw, vec, s);
  if (m <= 4) return launch<T, 4>(a, b, c, ws, m, n, k, splits, kb, kw, vec, s);
  if (m <= 8) return launch<T, 8>(a, b, c, ws, m, n, k, splits, kb, kw, vec, s);
  return launch<T, 16>(a, b, c, ws, m, n, k, splits, kb, kw, vec, s);
}

}  // namespace

// a (m, k), b (k, n), c (m, n) in the type of `dtype`; ws float32
// (splits, m, n), or null when splits == 1.  The K segment of a block is kb
// rows, of a warp kw rows (kb = 8 * kw, splits * kb >= k).  vec: b is
// 16-byte aligned and n a multiple of the vector.
extern "C" int halo_mmm_skinny(const void* a, const void* b, void* c, void* ws, int m,
                               int n, int k, int splits, int kb, int kw, int vec,
                               int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 0 || splits < 1 || splits > 65535 || kw < 1 ||
      kb != kWarps * kw || (long long)splits * kb < k || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  HALO_DISPATCH_TYPE(dtype, T,
      return static_cast<int>(dispatch_rows<T>(
          static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), w,
          m, n, k, splits, kb, kw, vec != 0, s)))
  return static_cast<int>(cudaErrorInvalidValue);
}
