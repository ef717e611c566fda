// SMMM: blocked-ELL sparse A times dense B,
//   C(r*bm + i, :) = sum over slots s of row r with indices(r,s) >= 0 of
//                    values(r,s,i,:) @ B(indices(r,s)*bk : +bk, :),
// values (R,S,bm,bk) and B (K,N) row-major in one type, indices (R,S) int32
// (negative = pad), float32 sums, C (R*bm, N) in B's type.
//
// Replaces src/repro/kernels/spmm/spmm.py::smmm_pallas (_smmm_kernel),
// which walks a (R, N/bn, S) grid on the MXU, prefetches the index table
// into SMEM so each step's B-tile fetch follows the sparsity pattern, and
// skips pad slots with pl.when (its B fetch clamps -1 to block 0).
//
// Bound on the H100: operations.  P kept slots need 2*P*bm*bk*N
// operations; the template's 8192^2 A in 64x128 blocks (P = 2095 at
// density ~0.25) times an 8192x4096 B is 1.41e11, 0.284 ms at the 495
// TFLOP/s of the TF32 tensor cores, the card's fastest rate for float32
// operands (2.098 ms on the float32 CUDA cores at 67), while the operands
// move in ~0.07 ms.  The 3xTF32 algorithm's own floor, three products, is
// 0.852 ms.
//
// Design: mmm_wgmma.cu's 3xTF32 route, its K loop walking the kept slots
// of one block row instead of a dense K range.
// - Split pass (smmm_split_kernel): split_tf32 of every kept value block
//   into the planes [V_hi; V_lo], each block's rows padded with zeros to
//   bmp = bm rounded up to 64 and its columns to bkp = bk rounded up to 32;
//   and of B transposed into [B_hi^T; B_lo^T] (2N x nkb*bkp, nkb = K/bk),
//   block column c's bk rows of B at columns c*bkp .. c*bkp + bk - 1 and
//   zeros up to c*bkp + bkp - 1.  So a value block's pad columns meet
//   zeros of B^T and B^T's pad columns meet zeros of the values.  Pad
//   slots are neither split nor read: the workspace is sized from R*S and
//   the shapes (the wrapper counts no kept slots on the host, which would
//   cost a device sync).  A bfloat16 or float16 value is exact in TF32:
//   the 16-bit types take the same kernels with one hi plane (the value in
//   float32) and one product a step.
// - Product kernel (smmm_tf32_kernel): one 288-thread block per (64 rows
//   of a block row, 256 columns).  The producer warp's lane 0 walks the
//   row's slots, skips pads, and for each 32-deep stage of a kept slot
//   loads V_hi and V_lo (64 x 32, 128-byte rows) and B_hi^T and B_lo^T
//   (256 x 32 at column index*bkp + 32j) with TMA into a ring of stages,
//   each guarded by a full and an empty mbarrier.  A stage holds 80 KB, so
//   2 stages fit where 3 would pass the 227 KB a block may use (one hi
//   plane: 40 KB, 4 stages).  Two consumer warpgroups each own 128 of the
//   columns and share the V boxes; each K step of 8 issues m64n128k8
//   lo*hi, hi*lo, hi*hi (16-bit: hi*hi).  The tensor cores do not round
//   their accumulator to nearest, so each stage sums into a fresh one that
//   the CUDA cores add to the tile's float32 sums after wgmma.wait_group 0
//   (one accumulator over K = 4096 erred ~3e-5 in mmm_wgmma.cu).  The
//   consumers count the row's kept slots themselves (warp ballots over its
//   index row), so both sides walk the same stages with no index staged
//   in shared memory, at any S.  Slots are summed in slot order: two calls
//   give the same bits.
// - Block order: successive blocks take successive row tiles of one
//   column tile, so that tile's B^T planes (16 MB at the template's shape)
//   stay in the 50 MB L2 while every row reads them, and each row tile's
//   value planes are read once per column tile.  On the H100, at an 8192^2
//   A of 2173 kept 64x128 blocks times an 8192x4096 B, the product took
//   1.60 ms so, 1.74 ms with two column tiles side by side (32 MB of B^T
//   planes) and 2.19 ms with four (64 MB), 1.77-1.99 ms with 128-column
//   tiles (one warpgroup; 2 to 4 stages, one or two blocks an SM).
// The epilogue rounds to C's type and stores straight from registers,
// masked at bm and N.  TMA zero-fills boxes past the planes' edges: an
// index outside [-1, K/bk) reads zeros or another block's planes (an
// undefined result, as in the reference), never memory outside the
// workspace; the split pass reads values and B only within their shapes.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int kRows = 64;                        // a tile's rows: one row tile
constexpr int kCols = 256;                       // a tile's columns
constexpr int kDepth = 32;                       // a stage's K depth (128 bytes)
constexpr int kConsumerThreads = 256;            // two warpgroups of 128 columns
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr uint32_t kVBox = kRows * kDepth * 4;   // 8 KB
constexpr uint32_t kBBox = kCols * kDepth * 4;   // 32 KB

// The ring of a product kernel with kPlanes planes (2: hi and lo, 1: hi):
// a stage holds the planes' V boxes, then their B^T boxes.
template <int kPlanes> struct Ring {
  static constexpr uint32_t kStageBytes = kPlanes * (kVBox + kBBox);
  static constexpr int kStages = kPlanes == 2 ? 2 : 4;
  // 1 KB of alignment slack, the stages, a full and an empty barrier each
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

// x into the planes at `at`: hi and lo (lo `lo_off` values after hi), or
// the value itself where there is one plane.
template <int kPlanes>
__device__ __forceinline__ void put(float* ws, size_t at, size_t lo_off, float x) {
  if constexpr (kPlanes == 2) {
    split_tf32(x, ws[at], ws[lo_off + at]);
  } else {
    ws[at] = x;
  }
}

// The split pass.  Blocks 0 .. slots - 1 each take one slot: a pad slot
// returns at once, a kept one writes its bmp x bkp planes, zeros past bm
// and bk.  The other blocks each take a 32 x 32 tile of B^T, transposed
// through shared memory so that reads (along N) and writes (along K) both
// coalesce.
template <typename T, int kPlanes>
__global__ void __launch_bounds__(256)
smmm_split_kernel(const T* __restrict__ values, const int* __restrict__ indices,
                  const T* __restrict__ B, float* __restrict__ ws_v, float* __restrict__ ws_b,
                  long long slots, int bm, int bk, int bmp, int bkp, int N, int kq) {
  if (blockIdx.x < slots) {
    const long long slot = blockIdx.x;
    if (indices[slot] < 0) return;
    const T* v = values + slot * bm * bk;
    const size_t base = (size_t)slot * bmp * bkp, lo_off = (size_t)slots * bmp * bkp;
    for (int e = threadIdx.x; e < bmp * bkp; e += blockDim.x) {
      const int i = e / bkp, j = e - i * bkp;
      put<kPlanes>(ws_v, base + e, lo_off,
                   i < bm && j < bk ? halo::to_float(v[i * bk + j]) : 0.f);
    }
    return;
  }
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long b = blockIdx.x - slots;
  const int nx = (N + 31) / 32;
  const int q0 = static_cast<int>(b / nx) * 32, n0 = static_cast<int>(b % nx) * 32;
  for (int i = ty; i < 32; i += 8) {
    const int q = q0 + i, c = q / bkp, kk = q - c * bkp;  // B^T column q: row c*bk + kk of B
    tile[i][tx] = kk < bk && n0 + tx < N
                      ? halo::to_float(B[((size_t)c * bk + kk) * N + n0 + tx]) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    if (n0 + i >= N) continue;
    put<kPlanes>(ws_b, (size_t)(n0 + i) * kq + q0 + tx, (size_t)N * kq, tile[tx][i]);
  }
}

// One stage's products into d (its first product overwrites d): every
// operand K-major, rows of 128 B, 8-row atoms 1024 B apart, descriptors
// advanced 32 bytes per K step of 8.  Warpgroup wg takes B^T's rows
// wg*128 .. +127, each takes all 64 rows of V.
template <int kPlanes>
__device__ __forceinline__ void stage_products(float (&d)[64], uint32_t stage, int wg) {
  const uint32_t v_hi = stage, v_lo = stage + kVBox;
  const uint32_t b_hi = stage + kPlanes * kVBox + wg * 128 * 128, b_lo = b_hi + kBBox;
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) {
    const uint32_t off = kk * 32;
    if constexpr (kPlanes == 2) {
      WgmmaTf32::run(d, desc_sw128(v_lo + off, 16, 1024), desc_sw128(b_hi + off, 16, 1024),
                     kk > 0);
      WgmmaTf32::run(d, desc_sw128(v_hi + off, 16, 1024), desc_sw128(b_lo + off, 16, 1024), 1);
      WgmmaTf32::run(d, desc_sw128(v_hi + off, 16, 1024), desc_sw128(b_hi + off, 16, 1024), 1);
    } else {
      WgmmaTf32::run(d, desc_sw128(v_hi + off, 16, 1024), desc_sw128(b_hi + off, 16, 1024),
                     kk > 0);
    }
  }
}

// map_v: the value planes, kPlanes * v_rows rows of bkp floats, boxes of
// 64 rows; map_b: the B^T planes, kPlanes * N rows of kq floats, boxes of
// 256 rows.  Grid: x = R * row tiles, y = column tiles.
template <typename T, int kPlanes>
__global__ void __launch_bounds__(kThreads, 1)
smmm_tf32_kernel(const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_b, const int* __restrict__ indices,
                 T* __restrict__ C, int S, int bm, int row_tiles, int bkp, int N,
                 int v_rows) {
  using R = Ring<kPlanes>;
  const int r = blockIdx.x / row_tiles, t = blockIdx.x % row_tiles;
  const int n0 = blockIdx.y * kCols;
  const int* idx = indices + (size_t)r * S;
  const int steps = bkp / kDepth;  // stages of a kept slot

  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + R::kStages * R::kStageBytes;  // full[s], then empty[s]
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (R::kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warp: lane 0 keeps the ring full, one stage per 32-deep
    // slice of each kept slot, in slot order
    if (threadIdx.x == kConsumerThreads) {
      long long it = 0;
      for (int s = 0; s < S; ++s) {
        const int c = idx[s];
        if (c < 0) continue;  // a pad slot: nothing loaded, nothing summed
        const int vrow = static_cast<int>(((long long)r * S + s) * row_tiles * kRows) + t * kRows;
        const int col = static_cast<int>(static_cast<unsigned>(c) * static_cast<unsigned>(bkp));
        for (int j = 0; j < steps; ++j, ++it) {
          const int st = static_cast<int>(it % R::kStages);
          if (it >= R::kStages)
            mbar_wait(bars + 8 * (R::kStages + st), ((it / R::kStages) + 1) & 1);
          const uint32_t full = bars + 8 * st, stage = base + st * R::kStageBytes;
          const uint32_t sb = stage + kPlanes * kVBox;
          mbar_expect_tx(full, R::kStageBytes);
          tma_load_2d(stage, &map_v, full, j * kDepth, vrow);
          tma_load_2d(sb, &map_b, full, col + j * kDepth, n0);
          if constexpr (kPlanes == 2) {
            tma_load_2d(stage + kVBox, &map_v, full, j * kDepth, v_rows + vrow);
            tma_load_2d(sb + kBBox, &map_b, full, col + j * kDepth, N + n0);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;  // consumer warpgroup: columns wg*128 .. +127
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  // the stages the producer loads: each kept slot's, counted 32 slots a
  // ballot
  long long kept = 0;
  for (int s0 = 0; s0 < S; s0 += 32)
    kept += __popc(__ballot_sync(0xffffffffu, s0 + lane < S && idx[s0 + lane] >= 0));
  const long long stages = kept * steps;

  float d[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = part[i] = 0.f;
  fence_acc(d);
  for (long long it = 0; it < stages; ++it) {
    const int st = static_cast<int>(it % R::kStages);
    mbar_wait(bars + 8 * st, (it / R::kStages) & 1);
    wgmma_fence();
    stage_products<kPlanes>(part, base + st * R::kStageBytes, wg);
    wgmma_commit();
    wgmma_wait<0>();  // this stage's group is done: hand it back
    fence_acc(part);
    if (lane == 0) mbar_arrive(bars + 8 * (R::kStages + st));
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] += part[i];
  }

  // d[4j + 2h + v]: row warp*16 + lane/4 + 8h of the tile, column
  // wg*128 + 8j + 2*(lane%4) + v
  const int row = t * kRows + warp * 16 + lane / 4;  // inside block row r
  T* out = C + (size_t)r * bm * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + wg * 128 + j * 8 + 2 * (lane % 4);
    if (c >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h >= bm) continue;
      T* p = out + (size_t)(row + 8 * h) * N + c;
      p[0] = halo::from_float<T>(d[4 * j + 2 * h]);
      if (c + 1 < N) p[1] = halo::from_float<T>(d[4 * j + 2 * h + 1]);
    }
  }
}

int round_up(long long x, int to) { return static_cast<int>((x + to - 1) / to * to); }

template <typename T, int kPlanes>
int launch(const void* values, const int* indices, const void* b, void* c, float* ws,
           int nrows, int S, int bm, int bk, int k, int n, cudaStream_t s) {
  using R = Ring<kPlanes>;
  // a runtime call first: it also makes the device's primary context
  // current on this host thread, which cuTensorMapEncodeTiled needs
  cudaError_t rc = cudaFuncSetAttribute(smmm_tf32_kernel<T, kPlanes>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(R::kSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int bmp = round_up(bm, kRows), bkp = round_up(bk, kDepth), kq = k / bk * bkp;
  const long long slots = (long long)nrows * S, v_rows = slots * bmp;
  float* ws_b = ws + kPlanes * v_rows * bkp;
  CUtensorMap map_v, map_b;
  if (!make_map(&map_v, ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kPlanes * v_rows, bkp, kRows) ||
      !make_map(&map_b, ws_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, (long long)kPlanes * n, kq,
                kCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = slots + (long long)(kq / 32) * ((n + 31) / 32);
  smmm_split_kernel<T, kPlanes><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const T*>(values), indices, static_cast<const T*>(b), ws, ws_b, slots, bm,
      bk, bmp, bkp, n, kq);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int row_tiles = bmp / kRows;
  const dim3 grid(static_cast<unsigned>(nrows * row_tiles),
                  static_cast<unsigned>((n + kCols - 1) / kCols));
  smmm_tf32_kernel<T, kPlanes><<<grid, kThreads, R::kSmem, s>>>(
      map_v, map_b, indices, static_cast<T*>(c), S, bm, row_tiles, bkp, n,
      static_cast<int>(v_rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values (nrows, S, bm, bk), indices (nrows, S) int32, b (k, n), c
// (nrows*bm, n), all in the type of `dtype` but indices; ws a 16-byte
// aligned float32 workspace of P * (nrows*S*bmp*bkp + n*(k/bk)*bkp)
// values, P = 2 planes for float32 and 1 for the 16-bit types, bmp = bm
// rounded up to 64 and bkp = bk rounded up to 32.
extern "C" int halo_smmm(const void* values, const void* indices, const void* b, void* c,
                         void* ws, int nrows, int S, int bm, int bk, int k, int n, int dtype,
                         void* stream) {
  // TMA's coordinates and the grids are 32-bit: both planes' rows, B^T's
  // columns, a block's padded values, the split pass's blocks
  const long long bmp = round_up(bm, kRows), bkp = round_up(bk, kDepth);
  const long long slots = (long long)nrows * S, kq = bk > 0 ? k / bk * bkp : 0;
  if (nrows < 1 || S < 1 || bm < 1 || bk < 1 || k < bk || k % bk || n < 1 ||
      reinterpret_cast<uintptr_t>(ws) % 16 || encode_tiled() == nullptr ||
      2 * slots * bmp >= (1LL << 31) || kq >= (1LL << 31) || bmp * bkp >= (1LL << 31) ||
      2LL * n >= (1LL << 31) || (n + kCols - 1) / kCols > 65535 ||
      slots + kq / 32 * ((n + 31) / 32) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(indices);
  float* w = static_cast<float*>(ws);
  switch (dtype) {
    case 0: return launch<float, 2>(values, idx, b, c, w, nrows, S, bm, bk, k, n, s);
    case 1: return launch<__nv_bfloat16, 1>(values, idx, b, c, w, nrows, S, bm, bk, k, n, s);
    case 2: return launch<__half, 1>(values, idx, b, c, w, nrows, S, bm, bk, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
