// 1DCONV: valid cross-correlation of a signal x (N) with taps w (K <= N),
//   out(i) = sum_{t<K} x(i+t) w(t),  i < L = N - K + 1,
// float32 accumulation, out in the input type.
//
// Replaces src/repro/kernels/conv1d/conv1d.py::conv1d_pallas
// (_conv1d_kernel), which keeps the whole padded signal resident in VMEM,
// the taps in SMEM, and sums K statically unrolled shifted loads per
// (1, bn) output tile on the VPU.
//
// Bound on the H100: bytes.  The signal is read once and the output
// written once, 4(2N - K + 1 + K) bytes for float32; at N = 2^26 and
// K = 17 that is 537 MB, at least 0.160 ms at 3.35 TB/s, while the
// 2K(N - K + 1) = 2.3 GFLOP take 0.034 ms at 67 TFLOP/s.
//
// Design: an SM holds 227 KB, not a whole signal, so each 256-thread block
// owns a tile of 2048 outputs and stages its slice of the signal (the tile
// plus a K-1 halo) and the taps in shared memory as float32.  The tap count
// is a runtime value: taps are staged 1024 at a time, each chunk with its
// own halo, and the float32 sums carry over from chunk to chunk in
// registers, so any K <= N runs without padding.  Thread j owns outputs
// j + 256m (m < 8): shared reads hit 32 consecutive words per warp, the tap
// is a broadcast, and stores are coalesced.  Each output sums its taps in
// order t = 0 .. K-1 with a rounded multiply and a rounded add, no fused
// multiply-add: the plain version's arithmetic, so the two agree to the
// bit.  Signal reads past N load 0 and outputs past L are not stored.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // outputs per thread
constexpr int kTile = kThreads * kPer;     // outputs per block
constexpr int kTapChunk = 1024;            // taps staged per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              long long n, long long k) {
  __shared__ float xs[kTile + kTapChunk - 1];
  __shared__ float ws[kTapChunk];
  const long long len = n - k + 1;
  const long long base = (long long)blockIdx.x * kTile;
  float acc[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) acc[m] = 0.f;

  for (long long c0 = 0; c0 < k; c0 += kTapChunk) {
    const int kc = (int)(k - c0 < kTapChunk ? k - c0 : kTapChunk);
    const int span = kTile + kc - 1;
    if (c0 > 0) __syncthreads();  // every read of the previous chunk is done
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const long long g = base + c0 + i;
      xs[i] = g < n ? halo::to_float(x[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < kc; i += kThreads) ws[i] = halo::to_float(w[c0 + i]);
    __syncthreads();
    for (int t = 0; t < kc; ++t) {
      const float wt = ws[t];
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        acc[m] = __fadd_rn(acc[m], __fmul_rn(wt, xs[threadIdx.x + m * kThreads + t]));
    }
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const long long i = base + threadIdx.x + m * kThreads;
    if (i < len) out[i] = halo::from_float<T>(acc[m]);
  }
}

}  // namespace

// 1 <= k <= n.
extern "C" int halo_conv1d(const void* x, const void* w, void* out, long long n, long long k,
                           int dtype, void* stream) {
  if (k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n - k + 1 + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      conv1d_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), n, k))
  return static_cast<int>(cudaGetLastError());
}
