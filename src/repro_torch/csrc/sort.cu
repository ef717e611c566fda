// SORT, tile route: ascending sort of each row of x(rows, n) with
// next_pow2(n) <= 8192, in the input type (float32, bfloat16 or float16),
// NaN last.
//
// Replaces src/repro/kernels/sorthist/sorthist.py::sort_pallas
// (_sort_kernel), a bitonic network over whole (bm, npow2) rows resident in
// VMEM, with partners found by reshaping and flipping, +inf padding, and
// jnp.minimum/maximum, which pass a NaN to both sides of a compare.
//
// Bound on the H100: bytes.  A sort must read the input once and write the
// output once: 8 bytes per float32 element.  No comparison sort reaches
// that: this network does log2(n)(log2(n)+1)/2 compare-exchange steps.
//
// Design (the tile route; rows with next_pow2(n) > kTile take the radix
// route, sort_radix.cu, see kernels/sorthist/sorthist.py::sort_route):
// elements become 32-bit keys that order every float as an unsigned integer
// (sign flipped for positives, all bits flipped for negatives), every NaN
// is one key above +inf, and the places from n up to the next power of two
// read as a sentinel key above that, so NaN sorts last and stays in the
// first n places; no padded copy is made.  16-bit types sort their float32
// values, which is exact, and are rounded back exactly.  A row of at most
// kTile = 8192 keys (32 KB) sorts in shared memory in one launch, one block
// per row.  Keys compare as integers, so the order is exact and the same on
// every run.
#include "common.cuh"

namespace {

constexpr int kTile = 8192;                 // keys per shared-memory tile
constexpr int kMaxThreads = 1024;
constexpr unsigned kNanKey = 0xFFFFFFFEu;   // every NaN
constexpr unsigned kPadKey = 0xFFFFFFFFu;   // places from n to next_pow2(n)

__device__ __forceinline__ unsigned to_key(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return kNanKey;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  if (k >= kNanKey) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Lower index of compare-exchange pair p at stride j (a power of two).
__device__ __forceinline__ int pair_lo(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// One block per row of npow2 <= kTile places: load the row as keys (the
// sentinel past n), run every bitonic step, store the places below n
// decoded.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
sort_tile_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, int npow2) {
  extern __shared__ unsigned sh[];
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < npow2; i += blockDim.x)
    sh[i] = i < n ? to_key(halo::to_float(x[row * n + i])) : kPadKey;
  __syncthreads();
  const int half = npow2 / 2;
  for (int k = 2; k <= npow2; k <<= 1) {
    for (int j = k / 2; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = pair_lo(p, j);
        const bool up = (i & k) == 0;
        const unsigned a = sh[i], b = sh[i + j];
        if ((a > b) == up) {
          sh[i] = b;
          sh[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[row * n + i] = halo::from_float<T>(from_key(sh[i]));
}

}  // namespace

// x, out (rows, n) in the type of `dtype`; npow2 = next_pow2(n) <= kTile
// (longer rows take halo_sort_radix).
extern "C" int halo_sort(const void* x, void* out, long long rows, long long n,
                         long long npow2, int dtype, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || n < 1 || npow2 < n || npow2 > kTile ||
      (npow2 & (npow2 - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = static_cast<int>(npow2);
  const int threads = tile / 2 < 32 ? 32 : (tile / 2 > kMaxThreads ? kMaxThreads : tile / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      sort_tile_kernel<T><<<static_cast<unsigned>(rows), threads, tile * sizeof(unsigned),
                            st>>>(static_cast<const T*>(x), static_cast<T*>(out), n, tile);
      return static_cast<int>(cudaGetLastError()))
  return static_cast<int>(cudaErrorInvalidValue);
}
