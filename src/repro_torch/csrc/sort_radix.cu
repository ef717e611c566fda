// SORT, radix route: ascending sort of each row of x(rows, n) in the input
// type (float32, bfloat16 or float16), NaN last, for rows longer than the
// shared-memory tile of sort.cu (next_pow2(n) > 8192).
//
// Replaces src/repro/kernels/sorthist/sorthist.py::sort_pallas
// (_sort_kernel), a bitonic network over whole (bm, npow2) rows resident in
// VMEM, with partners found by reshaping and flipping and +inf padding.
//
// Bound on the H100: bytes.  A sort must read the input once and write the
// output once: 8 bytes per float32 element, 134 MB at n = 2^24, 0.040 ms at
// 3.35 TB/s.  A comparison network does log2(n)(log2(n)+1)/2 passes over
// the row (300 at 2^24); this least-significant-digit radix sort does one
// counting read and at most four scatter passes, each a read and a write,
// plus a counting read of the keys before every pass but the first: 768 MB
// of keys at 2^24 float32 with all four passes (and ~16 MB of tile counts
// per pass), 5.7x the bound.
//
// Design: elements become 32-bit keys that order every float as an
// unsigned integer, as in sort.cu (sign flipped for positives, all bits
// flipped for negatives, every NaN 0xFFFFFFFE, above +inf).  16-bit types
// sort their float32 values, which is exact; the key bits below their
// mantissa (16 for bfloat16, 13 for float16) are 0 for every positive and
// 1 for every negative value, so they are cleared, which keeps the order
// and makes the low digits constant.  Keys decode back, and round back to
// the input type exactly, on the last pass's store; nothing is padded.
// Digits are 8 bits: four passes at most, and the 256 counters of a digit
// (1 KB) fit one per thread of a 256-thread block, which keeps every scan
// over digits one block scan; 11-bit digits would take three passes but 8x
// the tables and a multi-step scan per block.  One counting pass reads each
// row once and builds, per tile of 4096 keys, the counts of all four
// digits, and with global atomics the row's histogram of each digit
// (integer counts: the result does not depend on the atomics' order).  A
// plan kernel then marks, per row, the passes whose digit is not the same
// for every key; the others are skipped (as CUB does), so a bfloat16 row
// takes at most 2 passes, and a row whose keys are all equal takes one
// pass alone, a stable copy that writes the output.  Each pass is a stable
// scatter in three kernels, all launched for every pass and exiting at once
// for a row that skips it: (1) count the pass's digit per tile (the first
// pass a row takes reuses the counting pass's counts); (2) one block per
// (row, digit) turns its tile counts into an exclusive prefix over tiles
// in place; (3) per tile, rank keys stably: each of the 8 warps ranks its
// 512 keys in order, 32 at a time, by __match_any_sync on the digit and a
// popcount of the lower lanes of the same digit, against per-warp running
// counts in shared memory that only the lowest lane of each digit updates;
// a prefix over warps and over digits gives each key its place in the
// tile, sorted by digit in shared memory; the tile then writes each digit's
// run to the row's digit start + the tiles before + its offset in the run,
// so neighbouring threads write neighbouring places.  Nothing depends on
// the order of shared-memory atomics.  The first pass a row takes reads x
// and builds the keys; the others read and write two ping-pong key buffers
// of rows x n the wrapper allocates with the tables.  Loads are 16-byte
// vectors where the row starts on the 16-byte grid, scalar elsewhere and on
// the ragged edge.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTileKeys = 4096;                  // keys per tile (one block)
constexpr int kWarpKeys = kTileKeys / kWarps;    // 512: one warp's run
constexpr int kRounds = kWarpKeys / 32;          // 16 keys per lane
constexpr int kRadix = 256, kPasses = 4;
constexpr unsigned kNanKey = 0xFFFFFFFEu;

// Key bits kept for each type: the ones below a 16-bit type's mantissa are
// the same for all values of one sign.
template <typename T> struct KeyMask;
template <> struct KeyMask<float> { static constexpr unsigned kValue = 0xFFFFFFFFu; };
template <> struct KeyMask<__nv_bfloat16> { static constexpr unsigned kValue = 0xFFFF0000u; };
template <> struct KeyMask<__half> { static constexpr unsigned kValue = 0xFFFFE000u; };

template <typename T>
__device__ __forceinline__ unsigned to_key(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return kNanKey & KeyMask<T>::kValue;
  return ((u & 0x80000000u) ? ~u : (u | 0x80000000u)) & KeyMask<T>::kValue;
}

template <typename T>
__device__ __forceinline__ T from_key(unsigned k) {
  constexpr unsigned kMask = KeyMask<T>::kValue;
  if (k >= (kNanKey & kMask)) return halo::from_float<T>(__uint_as_float(0x7fc00000u));
  const unsigned u = ((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k) & kMask;
  return halo::from_float<T>(__uint_as_float(u));
}

__device__ __forceinline__ unsigned digit(unsigned key, int pass) {
  return (key >> (8 * pass)) & (kRadix - 1);
}

// f(i, key) for every place i < len of the tile that starts at row[0]:
// from x (T: keys built here) or from a key buffer (unsigned: as stored).
// 16-byte loads when row starts on the 16-byte grid, scalar otherwise and
// on the ragged edge.
template <typename T, typename F>
__device__ __forceinline__ void for_each_key(const T* row, int len, F f) {
  constexpr int kV = halo::Vec16<T>::kN;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int nv = len / kV;
    for (int vi = threadIdx.x; vi < nv; vi += kThreads) {
      const uint4 u = reinterpret_cast<const uint4*>(row)[vi];
      float vals[kV];
      halo::unpack16<T>(u, vals);
#pragma unroll
      for (int e = 0; e < kV; ++e) f(vi * kV + e, to_key<T>(vals[e]));
    }
    done = nv * kV;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) f(i, to_key<T>(halo::to_float(row[i])));
}

template <typename F>
__device__ __forceinline__ void for_each_key(const unsigned* row, int len, F f) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int nv = len / 4;
    for (int vi = threadIdx.x; vi < nv; vi += kThreads) {
      const uint4 u = reinterpret_cast<const uint4*>(row)[vi];
      f(4 * vi, u.x);
      f(4 * vi + 1, u.y);
      f(4 * vi + 2, u.z);
      f(4 * vi + 3, u.w);
    }
    done = nv * 4;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) f(i, row[i]);
}

// Exclusive prefix of one value per thread over the block (256 threads);
// *total gets the sum.  Fixed order: shuffles within warps, then the 8
// warp sums.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  unsigned before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < wid) before += warp_sums[w];
    all += warp_sums[w];
  }
  __syncthreads();  // warp_sums may be reused by the next call
  *total = all;
  return before + incl - v;
}

struct Tables {
  unsigned* row_hist;   // [rows][kPasses][kRadix], zeroed before counting
  unsigned* plan;       // [rows]: bit p set when pass p runs
  unsigned* tile_hist;  // [kPasses][rows][kRadix][tiles]
  long long rows, n;
  int tiles;            // tiles per row
  __device__ unsigned* tile_counts(int pass, long long row, unsigned d) const {
    return tile_hist + (((long long)pass * rows + row) * kRadix + d) * tiles;
  }
};

// Digit counts of every pass, per tile and per row.  One block per tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
count_kernel(const T* __restrict__ x, Tables tb) {
  __shared__ unsigned h[kPasses * kRadix];
  const long long row = blockIdx.x / tb.tiles;
  const int t = blockIdx.x % tb.tiles;
  const long long start = (long long)t * kTileKeys;
  const int len = (int)min((long long)kTileKeys, tb.n - start);
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) h[i] = 0;
  __syncthreads();
  for_each_key(x + row * tb.n + start, len, [&](int, unsigned key) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) atomicAdd(&h[p * kRadix + digit(key, p)], 1u);
  });
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) {
    const int p = i / kRadix, d = i % kRadix;
    const unsigned c = h[i];
    tb.tile_counts(p, row, d)[t] = c;
    if (c) atomicAdd(&tb.row_hist[(row * kPasses + p) * kRadix + d], c);
  }
}

// The passes each row takes: those whose digit is not constant over the
// row; a row of equal keys takes the last pass alone (a stable copy).
__global__ void plan_kernel(Tables tb) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= tb.rows) return;
  unsigned plan = 0;
  for (int p = 0; p < kPasses; ++p) {
    bool constant = false;
    const unsigned* hist = tb.row_hist + (row * kPasses + p) * kRadix;
    for (int d = 0; d < kRadix; ++d) constant |= hist[d] == (unsigned)tb.n;
    if (!constant) plan |= 1u << p;
  }
  tb.plan[row] = plan ? plan : 1u << (kPasses - 1);
}

// Where pass `pass` of a row with plan `plan` reads and writes: the k-th
// pass the row takes reads x when k = 0, else buffer (k - 1) % 2, and
// writes the output when it is the row's last pass, else buffer k % 2.
struct Route {
  bool runs, first, last;
  int src, dst;
};
__device__ __forceinline__ Route route(unsigned plan, int pass) {
  const int k = __popc(plan & ((1u << pass) - 1u));
  return {((plan >> pass) & 1u) != 0, k == 0, (plan >> (pass + 1)) == 0, (k - 1) & 1, k & 1};
}

// Pass `pass`'s digit counts per tile of the keys the row's previous pass
// wrote (the first pass a row takes has them from count_kernel).
__global__ void __launch_bounds__(kThreads)
upsweep_kernel(const unsigned* __restrict__ keys, Tables tb, int pass) {
  __shared__ unsigned h[kRadix];
  const long long row = blockIdx.x / tb.tiles;
  const Route r = route(tb.plan[row], pass);
  if (!r.runs || r.first) return;
  const int t = blockIdx.x % tb.tiles;
  const long long start = (long long)t * kTileKeys;
  const int len = (int)min((long long)kTileKeys, tb.n - start);
  h[threadIdx.x] = 0;
  __syncthreads();
  const unsigned* src = keys + (long long)r.src * tb.rows * tb.n + row * tb.n + start;
  for_each_key(src, len, [&](int, unsigned key) { atomicAdd(&h[digit(key, pass)], 1u); });
  __syncthreads();
  tb.tile_counts(pass, row, threadIdx.x)[t] = h[threadIdx.x];
}

// One block per (row, digit): the tile counts of the digit become an
// exclusive prefix over the row's tiles, in place.
__global__ void __launch_bounds__(kThreads) scan_kernel(Tables tb, int pass) {
  const long long row = blockIdx.x / kRadix;
  if (!route(tb.plan[row], pass).runs) return;
  unsigned* c = tb.tile_counts(pass, row, blockIdx.x % kRadix);
  unsigned running = 0;
  for (int base = 0; base < tb.tiles; base += 4 * kThreads) {
    unsigned v[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = base + 4 * threadIdx.x + e;
      v[e] = i < tb.tiles ? c[i] : 0u;
      sum += v[e];
    }
    unsigned total;
    unsigned ex = running + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = base + 4 * threadIdx.x + e;
      if (i < tb.tiles) c[i] = ex;
      ex += v[e];
    }
    running += total;
  }
}

// The stable scatter of pass `pass`, one block per tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const T* __restrict__ x, unsigned* __restrict__ keys, T* __restrict__ out,
               Tables tb, int pass) {
  __shared__ unsigned sh[kTileKeys];          // the tile's keys, then sorted by digit
  __shared__ unsigned warp_count[kWarps][kRadix];
  __shared__ unsigned local_start[kRadix];    // digit d's first place in the tile
  __shared__ long long global_start[kRadix];  // ... in the row
  const long long row = blockIdx.x / tb.tiles;
  const Route r = route(tb.plan[row], pass);
  if (!r.runs) return;
  const int t = blockIdx.x % tb.tiles;
  const long long start = (long long)t * kTileKeys;
  const int len = (int)min((long long)kTileKeys, tb.n - start);
  const long long plane = tb.rows * tb.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto to_shared = [&](int i, unsigned key) { sh[i] = key; };
  if (r.first)
    for_each_key(x + row * tb.n + start, len, to_shared);
  else
    for_each_key(static_cast<const unsigned*>(keys + r.src * plane + row * tb.n + start), len,
                 to_shared);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][tid] = 0;
  __syncthreads();

  // each warp ranks its 512 keys in index order, 32 at a time
  unsigned my_key[kRounds], my_rank[kRounds];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kRounds; ++c) {
    const int i = warp * kWarpKeys + c * 32 + lane;
    const bool valid = i < len;
    const unsigned key = valid ? sh[i] : 0u;
    const unsigned d = digit(key, pass);
    // places past len get a class of their own
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? d : kRadix + lane);
    const unsigned before = valid ? warp_count[warp][d] : 0u;
    __syncwarp();
    if (valid && (peers & lower) == 0) warp_count[warp][d] = before + __popc(peers);
    __syncwarp();
    my_key[c] = key;
    my_rank[c] = before + __popc(peers & lower);
  }
  __syncthreads();

  // per digit (one per thread): offsets of the warps, then of the digits
  unsigned tile_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned cnt = warp_count[w][tid];
    warp_count[w][tid] = tile_count;
    tile_count += cnt;
  }
  unsigned total;
  local_start[tid] = block_exclusive_scan(tile_count, &total);
  const unsigned row_count = tb.row_hist[(row * kPasses + pass) * kRadix + tid];
  const unsigned digit_start = block_exclusive_scan(row_count, &total);
  global_start[tid] = (long long)digit_start + tb.tile_counts(pass, row, tid)[t];
  __syncthreads();  // every key of sh is in a register

#pragma unroll
  for (int c = 0; c < kRounds; ++c) {
    const int i = warp * kWarpKeys + c * 32 + lane;
    if (i < len) {
      const unsigned d = digit(my_key[c], pass);
      sh[local_start[d] + warp_count[warp][d] + my_rank[c]] = my_key[c];
    }
  }
  __syncthreads();

  // each digit's run of the tile to its place in the row
  for (int i = tid; i < len; i += kThreads) {
    const unsigned key = sh[i];
    const unsigned d = digit(key, pass);
    const long long place = global_start[d] + (i - (long long)local_start[d]);
    if (r.last)
      out[row * tb.n + place] = from_key<T>(key);
    else
      keys[r.dst * plane + row * tb.n + place] = key;
  }
}

template <typename T>
int sort_radix_rows(const T* x, T* out, unsigned* keys, const Tables& tb, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(tb.row_hist, 0,
                                  sizeof(unsigned) * tb.rows * kPasses * kRadix, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned tiles = static_cast<unsigned>(tb.rows * tb.tiles);
  count_kernel<T><<<tiles, kThreads, 0, st>>>(x, tb);
  plan_kernel<<<static_cast<unsigned>((tb.rows + 255) / 256), 256, 0, st>>>(tb);
  for (int p = 0; p < kPasses; ++p) {
    upsweep_kernel<<<tiles, kThreads, 0, st>>>(keys, tb, p);
    scan_kernel<<<static_cast<unsigned>(tb.rows * kRadix), kThreads, 0, st>>>(tb, p);
    scatter_kernel<T><<<tiles, kThreads, 0, st>>>(x, keys, out, tb, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (rows, n) in the type of `dtype`; keys: a uint32 buffer of
// keys_len elements, at least 2 * rows * n (the two ping-pong key
// buffers); tables: a uint32 buffer of tables_len elements, at least
// rows * (4 * 256 + 1) + 4 * rows * 256 * ceil(n / 4096) (the row
// histograms, the plan and the tile counts).
extern "C" int halo_sort_radix(const void* x, void* out, void* keys, long long keys_len,
                               void* tables, long long tables_len, long long rows,
                               long long n, int dtype, void* stream) {
  if (rows < 1 || n < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTileKeys - 1) / kTileKeys;
  if (rows * tiles > 0x7fffffffLL || rows * kRadix > 0x7fffffffLL ||
      keys_len < 2 * rows * n ||
      tables_len < rows * (kPasses * kRadix + 1) + kPasses * rows * kRadix * tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* tab = static_cast<unsigned*>(tables);
  const Tables tb{tab, tab + rows * kPasses * kRadix, tab + rows * (kPasses * kRadix + 1),
                  rows, n, static_cast<int>(tiles)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* k = static_cast<unsigned*>(keys);
  HALO_DISPATCH_TYPE(dtype, T,
      return sort_radix_rows<T>(static_cast<const T*>(x), static_cast<T*>(out), k, tb, st))
  return static_cast<int>(cudaErrorInvalidValue);
}
