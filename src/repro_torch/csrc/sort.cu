// SORT: ascending sort of each row of x(rows, n), any n, in the input type
// (float32, bfloat16 or float16), NaN last, as torch.sort orders.
//
// Replaces src/repro/kernels/sorthist/sorthist.py::sort_pallas
// (_sort_kernel), a bitonic network over whole (bm, npow2) rows resident in
// VMEM, with partners found by reshaping and flipping, +inf padding, and
// jnp.minimum/maximum, which pass a NaN to both sides of a compare.
//
// Bound on the H100: bytes.  A sort must read the input once and write the
// output once: 8 bytes per float32 element, 134 MB at n = 2^24, 0.040 ms at
// 3.35 TB/s.  No comparison sort reaches that: this network does
// log2(n)(log2(n)+1)/2 compare-exchange steps (300 at 2^24), and each
// global-memory step reads and writes every key.
//
// Design: elements become 32-bit keys that order every float as an
// unsigned integer (sign flipped for positives, all bits flipped for
// negatives), every NaN is one key above +inf, and the places from n up to
// the next power of two read as a sentinel key above that, so NaN sorts
// last and stays in the first n places; no padded copy is made.  16-bit
// types sort their float32 values, which is exact, and are rounded back
// exactly.  A row of at most kTile = 8192 keys (32 KB) sorts in shared
// memory in one launch, one block per row.  A longer row sorts in tiles
// (the tile's steps with the row's directions), then for each merge size
// k > kTile runs one global-memory compare-exchange pass per stride
// j >= kTile over an int32 key buffer of next_pow2(n) per row that the
// wrapper allocates, and one shared-memory pass per tile for the strides
// below kTile; the last writes the output.  Keys compare as integers, so
// the order is exact and the same on every run.
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
__device__ __forceinline__ long long pair_lo(long long p, long long j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// One block per tile of `tile` keys (a power of two dividing npow2): load
// the tile (from x, with the sentinel past n, or from the key buffer), run
// the bitonic steps of merge sizes k_first..k_last (strides below the tile
// only), store it (to out, decoded, only the places below n, or back to the
// key buffer).  Directions follow the place in the row, so tiles of one row
// sort as parts of one network.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
sort_tile_kernel(const T* __restrict__ x, unsigned* __restrict__ keys, T* __restrict__ out,
                 long long n, long long npow2, int tile, long long k_first,
                 long long k_last, int from_x, int to_out) {
  extern __shared__ unsigned sh[];
  const long long tiles_per_row = npow2 / tile;
  const long long row = blockIdx.x / tiles_per_row;
  const long long base = (blockIdx.x % tiles_per_row) * tile;
  unsigned* krow = keys + row * npow2;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    if (from_x)
      sh[i] = g < n ? to_key(halo::to_float(x[row * n + g])) : kPadKey;
    else
      sh[i] = krow[g];
  }
  __syncthreads();
  const int half = tile / 2;
  for (long long k = k_first; k <= k_last; k <<= 1) {
    for (int j = static_cast<int>((k < tile ? k : tile) / 2); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = static_cast<int>(pair_lo(p, j));
        const bool up = ((base + i) & k) == 0;
        const unsigned a = sh[i], b = sh[i + j];
        if ((a > b) == up) {
          sh[i] = b;
          sh[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long g = base + i;
    if (!to_out)
      krow[g] = sh[i];
    else if (g < n)
      out[row * n + g] = halo::from_float<T>(from_key(sh[i]));
  }
}

// One compare-exchange step of merge size k at stride j >= kTile over the
// key buffer, one thread per pair.
__global__ void sort_global_kernel(unsigned* __restrict__ keys, long long pairs_per_row,
                                   long long total, long long npow2, long long k,
                                   long long j) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < total; p += stride) {
    const long long row = p / pairs_per_row;
    const long long i = pair_lo(p % pairs_per_row, j);
    unsigned* r = keys + row * npow2;
    const bool up = (i & k) == 0;
    const unsigned a = r[i], b = r[i + j];
    if ((a > b) == up) {
      r[i] = b;
      r[i + j] = a;
    }
  }
}

template <typename T>
int sort_rows(const T* x, T* out, unsigned* keys, long long rows, long long n,
              long long npow2, cudaStream_t st) {
  if (npow2 <= kTile) {
    const int tile = static_cast<int>(npow2);
    const int threads = tile / 2 < 32 ? 32 : (tile / 2 > kMaxThreads ? kMaxThreads : tile / 2);
    sort_tile_kernel<T><<<static_cast<unsigned>(rows), threads, tile * sizeof(unsigned), st>>>(
        x, keys, out, n, npow2, tile, 2, npow2, 1, 1);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = rows * (npow2 / kTile);
  const size_t shmem = kTile * sizeof(unsigned);
  sort_tile_kernel<T><<<static_cast<unsigned>(blocks), kMaxThreads, shmem, st>>>(
      x, keys, out, n, npow2, kTile, 2, kTile, 1, 0);
  const long long pairs_per_row = npow2 / 2, total = rows * pairs_per_row;
  const long long want = (total + 255) / 256;
  const unsigned gblocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  for (long long k = 2LL * kTile; k <= npow2; k <<= 1) {
    for (long long j = k / 2; j >= kTile; j >>= 1)
      sort_global_kernel<<<gblocks, 256, 0, st>>>(keys, pairs_per_row, total, npow2, k, j);
    sort_tile_kernel<T><<<static_cast<unsigned>(blocks), kMaxThreads, shmem, st>>>(
        x, keys, out, n, npow2, kTile, k, k, 0, k == npow2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (rows, n) in the type of `dtype`; npow2 = next_pow2(n); keys: an
// int32 buffer of keys_len elements, at least rows * npow2 when npow2 >
// kTile (the merge path writes it), unused otherwise.
extern "C" int halo_sort(const void* x, void* out, void* keys, long long keys_len,
                         long long rows, long long n, long long npow2, int dtype,
                         void* stream) {
  if (rows < 1 || n < 1 || npow2 < n || (npow2 & (npow2 - 1)) != 0 ||
      rows * (npow2 > kTile ? npow2 / kTile : 1) > 0x7fffffffLL ||
      (npow2 > kTile && keys_len < rows * npow2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      return sort_rows<T>(static_cast<const T*>(x), static_cast<T*>(out),
                          static_cast<unsigned*>(keys), rows, n, npow2, st))
  return static_cast<int>(cudaErrorInvalidValue);
}
