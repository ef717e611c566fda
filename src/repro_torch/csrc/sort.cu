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
// that: this network does log2(n)(log2(n)+1)/2 compare-exchange steps, and
// it is bound by the integer min/max they take.
//
// Keys: elements become 32-bit keys that order every float as an unsigned
// integer (sign flipped for positives, all bits flipped for negatives),
// every NaN is one key above +inf, and the places from n up to the next
// power of two read as a sentinel key above that, so NaN sorts last and
// stays in the first n places; no padded copy is made.  16-bit types sort
// their float32 values, which is exact, and are rounded back exactly.  Keys
// compare as integers, so the order is exact and the same on every run.
//
// Design (the tile route; rows with next_pow2(n) > kTile take the radix
// route, sort_radix.cu, see kernels/sorthist/sorthist.py::sort_route): the
// keys stay in registers.  Under a launch plan (sort_tile_plan in
// kernels/sorthist/sorthist.py, a pure function of rows, n and the SM
// count) a thread holds E keys, place t*E + s of a row in slot s of thread
// t, and T = npow2 / E threads share a row (E = 16 from 16 places on: a row
// of 4096 is 8 warps); a block holds R rows.  A compare-exchange at stride
// j < E pairs two slots of one thread; at E <= j < 32E a thread and lane
// t ^ (j/E) of its warp (__shfl_xor_sync); only at j >= 32E, past a warp's
// span, does it go through shared memory: each thread writes its keys, one
// barrier, reads its partner's (slot-major, word s*T + t, so a warp touches
// 32 consecutive words), with two buffers taking turns so that a step needs
// no second barrier.  At 4096 places that is 42 register, 30 shuffle and 6
// shared steps of the 78.  From stage k = 2E on, every place of a thread
// has one direction for the whole stage, so a thread that sorts descending
// complements its keys, runs the stage ascending on plain min/max, and
// complements back.  Rows of at most 16 places take one thread each; short
// rows share a block (32 rows of <= 16 places, 16 of 32, ...), so no block
// is a partial warp.  An aligned row loads and stores each thread's E
// places as 16-byte vectors.  A row off the 16-byte grid loads striped
// (neighbouring threads read neighbouring elements: where a key starts does
// not change the sorted row) and stores striped through shared memory.
#include "common.cuh"

namespace {

constexpr int kTile = 8192;                 // places of the longest row
constexpr int kMaxKeys = 16;                // keys a thread holds
constexpr int kMaxThreads = kTile / kMaxKeys;
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

// The smaller key to a, the larger to b, where up; the other way round
// where not.
__device__ __forceinline__ void exchange(unsigned& a, unsigned& b, bool up) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// Thread t's E keys of row xr (n places, kPadKey past n).  A sort's result
// does not depend on where each key starts.  An aligned row loads thread
// t's E places t*E .. t*E + E - 1 as 16-byte vectors (faster on an H100
// than vectors striped over the threads); a row off the 16-byte
// grid loads striped, slot s of thread t from element s*tpr + t, so that
// a warp reads 32 neighbouring elements.
template <typename T, int E>
__device__ __forceinline__ void load_keys(const T* __restrict__ xr, long long n, int t,
                                          int tpr, bool live, bool vec, unsigned (&key)[E]) {
  constexpr int V = halo::Vec16<T>::kN;
  const int base = t * E;
  if constexpr (E % V == 0) {
    if (vec) {
      if (live && base + E <= n) {
        const uint4* xv = reinterpret_cast<const uint4*>(xr + base);
#pragma unroll
        for (int q = 0; q < E / V; ++q) {
          float f[V];
          halo::unpack16<T>(xv[q], f);
#pragma unroll
          for (int i = 0; i < V; ++i) key[q * V + i] = to_key(f[i]);
        }
      } else {
#pragma unroll
        for (int s = 0; s < E; ++s)
          key[s] = live && base + s < n ? to_key(halo::to_float(xr[base + s])) : kPadKey;
      }
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const long long i = static_cast<long long>(s) * tpr + t;
    key[s] = live && i < n ? to_key(halo::to_float(xr[i])) : kPadKey;
  }
}

// The values of thread t's places t*E .. t*E + E - 1 below n, in row orow.
// An aligned row stores each thread's places as 16-byte vectors.  A row
// off the 16-byte grid goes through shared memory (stage, the row's
// npow2 + npow2/32 words: place p at word p + p/32, so the E words a thread
// writes fall in distinct banks across a warp) and is stored striped,
// element s*tpr + t from slot s of thread t, so that a warp writes 32
// neighbouring elements rather than one element in each of 32 sectors.
template <typename T, int E>
__device__ __forceinline__ void store_keys(T* __restrict__ orow, long long n, int t, int tpr,
                                           bool live, bool vec, unsigned* stage,
                                           const unsigned (&key)[E]) {
  constexpr int V = halo::Vec16<T>::kN;
  const int base = t * E;
  if constexpr (E % V == 0) {
    if (vec) {
      if (!live) return;
      if (base + E <= n) {
        uint4* ov = reinterpret_cast<uint4*>(orow + base);
#pragma unroll
        for (int q = 0; q < E / V; ++q) {
          uint4 r;
          T* p = reinterpret_cast<T*>(&r);
#pragma unroll
          for (int i = 0; i < V; ++i) p[i] = halo::from_float<T>(from_key(key[q * V + i]));
          ov[q] = r;
        }
      } else {
#pragma unroll
        for (int s = 0; s < E; ++s)
          if (base + s < n) orow[base + s] = halo::from_float<T>(from_key(key[s]));
      }
      return;
    }
  }
  __syncthreads();  // every read of the exchange buffers is done
#pragma unroll
  for (int s = 0; s < E; ++s) stage[(base + s) + ((base + s) >> 5)] = key[s];
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int i = s * tpr + t;
    if (i < n) orow[i] = halo::from_float<T>(from_key(stage[i + (i >> 5)]));
  }
}

// R rows of npow2 = E * tpr places a block, tpr threads a row (a power of
// two); blockDim.x = tpr * R, a multiple of 32.  Dynamic shared memory
// (tile_smem): two buffers of R * npow2 keys when tpr > 32, and R staged
// rows of npow2 + npow2/32 words when the row is off the 16-byte grid.
template <typename T, int E>
__global__ void __launch_bounds__(kMaxThreads)
sort_tile_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows, long long n,
                 int tpr, int vec) {
  extern __shared__ unsigned sh[];
  const int t = threadIdx.x & (tpr - 1);
  const int r = threadIdx.x / tpr;
  const int rpb = blockDim.x / tpr;
  const int npow2 = tpr * E;
  const long long row = static_cast<long long>(blockIdx.x) * rpb + r;
  const bool live = row < rows;
  const int base = t * E;
  unsigned key[E];
  load_keys<T, E>(x + (live ? row : 0) * n, n, t, tpr, live, vec, key);

  // stages k <= E: every stride within the thread's slots, the direction by
  // place
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int s = 0; s < E; ++s)
        if ((s & j) == 0) exchange(key[s], key[s + j], ((base + s) & k) == 0);
    }
  }
  // stages k > E: one direction a thread; descending stages run on
  // complemented keys
  int turn = 0;
  for (int k = 2 * E; k <= npow2; k <<= 1) {
    const unsigned flip = (base & k) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int s = 0; s < E; ++s) key[s] ^= flip;
    int j = k >> 1;
    for (; j >= 32 * E; j >>= 1) {       // partner in another warp
      unsigned* buf = sh + (turn * rpb + r) * npow2;
      turn ^= 1;
      const int m = j / E;
      const bool lower = (t & m) == 0;
#pragma unroll
      for (int s = 0; s < E; ++s) buf[s * tpr + t] = key[s];
      __syncthreads();
#pragma unroll
      for (int s = 0; s < E; ++s) {
        const unsigned v = buf[s * tpr + (t ^ m)];
        key[s] = lower ? min(key[s], v) : max(key[s], v);
      }
    }
    for (; j >= E; j >>= 1) {            // partner in the same warp
      const int m = j / E;
      const bool lower = (t & m) == 0;
#pragma unroll
      for (int s = 0; s < E; ++s) {
        const unsigned v = __shfl_xor_sync(0xffffffffu, key[s], m);
        key[s] = lower ? min(key[s], v) : max(key[s], v);
      }
    }
#pragma unroll
    for (int jj = E >> 1; jj > 0; jj >>= 1) {   // partner in the same thread
#pragma unroll
      for (int s = 0; s < E; ++s)
        if ((s & jj) == 0) {
          const unsigned lo = min(key[s], key[s + jj]), hi = max(key[s], key[s + jj]);
          key[s] = lo;
          key[s + jj] = hi;
        }
    }
#pragma unroll
    for (int s = 0; s < E; ++s) key[s] ^= flip;
  }
  store_keys<T, E>(out + (live ? row : 0) * n, n, t, tpr, live, vec,
                   sh + r * (npow2 + npow2 / 32), key);
}

size_t tile_smem(int places, int tpr, int rpb, bool staged) {
  const size_t exchange = tpr > 32 ? 2 * sizeof(unsigned) * rpb * places : 0;
  const size_t stage = staged ? sizeof(unsigned) * rpb * (places + places / 32) : 0;
  return exchange > stage ? exchange : stage;
}

template <typename T, int E>
int launch(const void* x, void* out, long long rows, long long n, int tpr, int rpb,
           long long blocks, int vec, cudaStream_t st) {
  const int threads = tpr * rpb;
  const size_t smem = tile_smem(tpr * E, tpr, rpb, !vec || E % halo::Vec16<T>::kN != 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_tile_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sort_tile_kernel<T, E><<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, n, tpr, vec);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// x, out (rows, n) in the type of `dtype`, under the plan of
// kernels/sorthist/sorthist.py::sort_tile_plan: keys_per_thread (E, a power
// of two up to 16), threads_per_row (a power of two; E * threads_per_row is
// the row's places, from n up to kTile; longer rows take halo_sort_radix),
// rows_per_block (threads_per_row * rows_per_block a multiple of 32), and
// blocks (covering every row).  vec: x and out 16-byte aligned and n * the
// element size a multiple of 16.  The plan replaced the row's power of two
// of the signature before the register-resident network, which has no
// fixed block shape.
extern "C" int halo_sort(const void* x, void* out, long long rows, long long n,
                         int keys_per_thread, int threads_per_row, int rows_per_block,
                         long long blocks, int dtype, int vec, void* stream) {
  const long long places = static_cast<long long>(keys_per_thread) * threads_per_row;
  const long long threads = static_cast<long long>(threads_per_row) * rows_per_block;
  if (rows < 1 || n < 1 || !pow2(keys_per_thread) || keys_per_thread > kMaxKeys ||
      !pow2(threads_per_row) || places < n || places > kTile || rows_per_block < 1 ||
      threads % 32 != 0 || threads > kMaxThreads || blocks < 1 || blocks > 0x7fffffffLL ||
      blocks * rows_per_block < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tpr = threads_per_row, rpb = rows_per_block;
  HALO_DISPATCH_TYPE(dtype, T,
      switch (keys_per_thread) {
        case 1: return launch<T, 1>(x, out, rows, n, tpr, rpb, blocks, vec, st);
        case 2: return launch<T, 2>(x, out, rows, n, tpr, rpb, blocks, vec, st);
        case 4: return launch<T, 4>(x, out, rows, n, tpr, rpb, blocks, vec, st);
        case 8: return launch<T, 8>(x, out, rows, n, tpr, rpb, blocks, vec, st);
        default: return launch<T, 16>(x, out, rows, n, tpr, rpb, blocks, vec, st);
      })
  return static_cast<int>(cudaErrorInvalidValue);
}
