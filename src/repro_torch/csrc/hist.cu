// HIST: float32 counts (bins) of the values of x (n) over `bins` equal
// buckets of [lo, hi], under the reference's binning contract: a value v
// counts when lo <= v <= hi (NaN never does), in bucket
// clip(floor((v - lo) / width), 0, bins - 1), with lo, hi and width the
// float32 values the reference uses and an IEEE float32 division.
//
// Replaces src/repro/kernels/sorthist/sorthist.py::hist_pallas
// (_hist_kernel), which compares each (1, bk) block of values with the bin
// iota and sums the one-hot (bk x bpad) plane into counts that a
// sequential grid carries in VMEM.
//
// Bound on the H100: bytes.  Each value is read once: 4n bytes in float32,
// 268 MB at n = 2^26, 0.080 ms at 3.35 TB/s; a bucket costs a few
// operations per value, far below the byte time.
//
// Design: a grid-stride pass over x with 16-byte vector loads where x is
// aligned; integer counts in shared memory, one sub-histogram per warp
// (as many as 48 KB hold, up to one per warp) so a hot bin's atomics spread
// over the warps; at the end each block adds each nonzero bin once to
// 64-bit global counts with one atomicAdd; a last pass writes them as
// float32, rounded to nearest as torch's int64-to-float32 conversion is.
// When one sub-histogram does not fit (bins > 12288) the block counts
// straight into the global counts.  The counts are integers, so the result
// is the same whatever order the atomics land in.  The bucket is computed
// with __fsub_rn and __fdiv_rn (no --use_fast_math), floorf, then the range
// test, and only then the clip, in float32, and the conversion to int, so
// NaN and +-inf never reach a float-to-int conversion.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBudget = 48 * 1024;
constexpr int kBlocksPerSM = 8;

struct Binning {
  float lo, hi, width;
  int bins;
};

__device__ __forceinline__ void count(float v, const Binning& b, unsigned* sub,
                                      unsigned long long* counts) {
  const float q = floorf(__fdiv_rn(__fsub_rn(v, b.lo), b.width));
  if (!(v >= b.lo && v <= b.hi)) return;
  const int last = b.bins - 1;
  int id = q <= 0.f ? 0 : (q >= static_cast<float>(last) ? last : static_cast<int>(q));
  id = id < last ? id : last;
  if (sub)
    atomicAdd(sub + id, 1u);
  else
    atomicAdd(counts + id, 1ull);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ x, long long n, Binning b, int nsub, int vec,
            unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned subs[];
  for (int i = threadIdx.x; i < nsub * b.bins; i += kThreads) subs[i] = 0;
  __syncthreads();
  unsigned* mine = nsub ? subs + (threadIdx.x / 32 % nsub) * b.bins : nullptr;

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  constexpr int kV = halo::Vec16<T>::kN;
  long long done = 0;
  if (vec) {
    const long long nvec = n / kV;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = first; i < nvec; i += stride) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kV; ++u) count(halo::to_float(e[u]), b, mine, counts);
    }
    done = nvec * kV;
  }
  for (long long i = done + first; i < n; i += stride)
    count(halo::to_float(x[i]), b, mine, counts);

  if (nsub == 0) return;
  __syncthreads();
  for (int id = threadIdx.x; id < b.bins; id += kThreads) {
    unsigned s = 0;
    for (int w = 0; w < nsub; ++w) s += subs[w * b.bins + id];
    if (s) atomicAdd(counts + id, static_cast<unsigned long long>(s));
  }
}

__global__ void hist_finish_kernel(const unsigned long long* __restrict__ counts,
                                   float* __restrict__ out, int bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < bins) out[i] = __ull2float_rn(counts[i]);
}

}  // namespace

// x (n) in the type of `dtype`; counts: an int64 buffer of `bins`; out:
// float32 (bins).  bins >= 1.
extern "C" int halo_hist(const void* x, void* counts, void* out, long long n, int bins,
                         float lo, float hi, float width, int dtype, void* stream) {
  if (bins < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(counts);
  cudaError_t err = cudaMemsetAsync(c, 0, sizeof(unsigned long long) * bins, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    const long long fit = kSharedBudget / (4LL * bins);
    const int nsub = static_cast<int>(fit < kWarps ? fit : kWarps);
    const size_t shmem = sizeof(unsigned) * static_cast<size_t>(nsub) * bins;
    const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const long long per_block = static_cast<long long>(kThreads) * 8;
    const long long want = (n + per_block - 1) / per_block;
    const long long most = static_cast<long long>(sms) * kBlocksPerSM;
    const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
    const Binning b{lo, hi, width, bins};
    HALO_DISPATCH_TYPE(dtype, T,
        hist_kernel<T><<<blocks, kThreads, shmem, st>>>(static_cast<const T*>(x), n, b,
                                                        nsub, vec, c))
  }
  hist_finish_kernel<<<(bins + 255) / 256, 256, 0, st>>>(c, static_cast<float*>(out), bins);
  return static_cast<int>(cudaGetLastError());
}
