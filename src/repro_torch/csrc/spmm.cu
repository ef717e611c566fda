// SMMM: blocked-ELL sparse A times dense B,
//   C(r*bm + i, :) = sum over slots s of row r with indices(r,s) >= 0 of
//                    values(r,s,i,:) @ B(indices(r,s)*bk : +bk, :),
// values (R,S,bm,bk) and B (K,N) row-major in one type, indices (R,S) int32
// (-1 = pad), float32 accumulator, C (R*bm, N) in B's type.
//
// Replaces src/repro/kernels/spmm/spmm.py::smmm_pallas (_smmm_kernel),
// which walks a (R, N/bn, S) grid on the MXU, prefetches the index table
// into SMEM so each step's B-tile fetch follows the sparsity pattern, and
// skips pad slots with pl.when (its B fetch clamps -1 to block 0).
//
// Bound on the H100: operations.  P non-pad slots need 2*P*bm*bk*N
// operations; at A 8192x8192 in 64x128 blocks of density 0.25
// (P ~ 2.1k) and N = 4096 that is ~144 GFLOP, at least ~2.1 ms in float32
// at 67 TFLOP/s, while the operands move in ~0.07 ms.
//
// Design (simple first): one 256-thread block per (64 rows of a block row,
// 256 columns of B).  The block loops over the row's S slots and reads
// indices(r,s) itself in place of scalar prefetch; the index is the same
// for every thread, so a pad slot is skipped by the whole block with
// nothing loaded for it.  For a kept slot, 16-deep slices of the value
// block (transposed, padded against bank conflicts) and of the B rows the
// index selects are staged in shared memory as float32; each thread keeps
// an 8x8 register micro-tile (rows strided by 8, columns by 32: broadcast
// and conflict-free shared reads, coalesced stores).  bm and
// bk are runtime values; rows past bm, columns past N and B rows past K
// load 0 and are not stored, so the kernel never reads outside values or
// B.  An index outside [-1, K/bk) gives an undefined result (as in the
// reference), never an out-of-bounds read.  Consecutive blocks take
// successive block rows of one column tile, so that tile's slice of B
// stays in L2 across the rows that use it.
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 256, kBK = 16;
constexpr int kTM = 8, kTN = 8;
constexpr int kThreads = 256;
constexpr int kPad = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
smmm_kernel(const T* __restrict__ values, const int* __restrict__ indices,
            const T* __restrict__ B, T* __restrict__ C, int S, int bm, int bk, int K,
            int N, int row_tiles) {
  __shared__ float As[kBK][kBM + kPad];
  __shared__ float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 32;  // owns columns tx + 32*j
  const int ty = tid / 32;  // owns rows ty + 8*i
  const int r = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x % row_tiles) * kBM;  // inside block row r
  const int col0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < S; ++s) {
    const int c = indices[(size_t)r * S + s];
    if (c < 0) continue;  // the same for the whole block: a pad slot loads nothing
    const T* V = values + ((size_t)r * S + s) * bm * bk;
    const long long brow0 = (long long)c * bk;
    for (int k0 = 0; k0 < bk; k0 += kBK) {
#pragma unroll
      for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
        const int idx = tid + l * kThreads;
        const int rr = idx / kBK, cc = idx % kBK;
        const int gr = row0 + rr, gc = k0 + cc;
        As[cc][rr] = (gr < bm && gc < bk) ? halo::to_float(V[(size_t)gr * bk + gc]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
        const int gk = k0 + l;
        const long long grow = brow0 + gk;
        const int gc = col0 + tid;
        Bs[l][tid] = (gk < bk && grow < K && gc < N)
                         ? halo::to_float(B[(size_t)grow * N + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 8 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty + 8 * i;
    if (row >= bm) continue;
    T* out = C + ((size_t)r * bm + row) * N;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 32 * j;
      if (col < N) out[col] = halo::from_float<T>(acc[i][j]);
    }
  }
}

}  // namespace

// values (nrows, S, bm, bk), indices (nrows, S) int32, b (k, n), c (nrows*bm, n).
extern "C" int halo_smmm(const void* values, const void* indices, const void* b, void* c,
                         int nrows, int S, int bm, int bk, int k, int n, int dtype,
                         void* stream) {
  if (nrows < 1 || bm < 1 || bk < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (bm + kBM - 1) / kBM;
  const long long gx = (long long)nrows * row_tiles;
  const long long gy = (n + kBN - 1) / kBN;
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
      smmm_kernel<T><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(values), static_cast<const int*>(indices),
          static_cast<const T*>(b), static_cast<T*>(c), S, bm, bk, k, n, row_tiles))
  return static_cast<int>(cudaGetLastError());
}
