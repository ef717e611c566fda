// MMM, tensor-core routes: C(M,N) = A(M,K) @ B(K,N), row-major, float32
// accumulator, output in the input type, for bfloat16 and float16 operands
// (the wgmma route) and for float32 by 3xTF32 (the tf32x3 route).  The
// routes (mmm_route in kernels/matmul/matmul.py) are pure functions of
// type and rows: M <= 64 (SKINNY_M_MAX) in every type goes to
// mmm_skinny.cu; every M above it comes here, at any K, N and alignment.
//
// Replaces src/repro/kernels/matmul/matmul.py::mmm_pallas (_mmm_kernel),
// which walks (bm, bn) output tiles with K innermost on the TPU's MXU:
// products into a float32 VMEM accumulator
// (preferred_element_type=float32), rounded to the input type at the last
// K step.  That is what the H100's tensor cores do.
//
// Bound on the H100: operations.  A danube prefill projection of 4200
// tokens (4200x2560 @ 2560x6912) does 2*M*N*K = 149 GFLOP, 0.150 ms at the
// 989 TFLOP/s of the bfloat16 tensor cores, against 114 MB of operands and
// result (0.034 ms at 3.35 TB/s).  float32 at 4096^3: the function's
// 2*M*N*K = 137 GFLOP take 0.278 ms at the 495 TFLOP/s of the TF32 tensor
// cores, the card's fastest rate for float32 operands; on the float32 CUDA
// cores (67 TFLOP/s), which torch.matmul (TF32 off) uses, 2.0513 ms.  The
// 3xTF32 algorithm's own floor, three products, is 0.833 ms.
//
// Design (Hopper's warp-specialised GEMM, simple first): one 288-thread
// block per 128 x BN output tile, not persistent.  One producer warp (its
// lane 0) streams boxes into a ring of shared-memory stages with TMA
// (cp.async.bulk.tensor.2d), each stage guarded by a "full" mbarrier
// (transaction bytes) and an "empty" one (one arrival per consumer warp);
// every box is loaded with the 128-byte swizzle.  Two consumer warpgroups
// each own 64 rows of the tile and run wgmma.mma_async on each stage; a
// stage goes back to the producer once the next stage's group is issued
// and wgmma.wait_group 1 shows the stage's own group done.  The ring is
// one kernel template; what a stage holds and how it is multiplied is its
// type argument:
// - 16-bit (Half16): BN = 128 or 256, 4 stages (32 KB each at BN = 128,
//   48 KB at 256).  A K-major in 128 x 64 boxes; B stays row-major
//   (N-major) as it lies in memory, in boxes of 64 columns, and wgmma
//   reads it through its transpose bit, so nothing copies or transposes B.
//   m64nBNk16 four times per stage, float32 accumulators (BN/2 registers a
//   thread).  No setmaxnreg: with one 288-thread block per SM each thread
//   may hold up to 224 registers, more than the 128 accumulators of a
//   128x256 tile and their addressing need.  Tile width (wgmma_tile_n in
//   matmul.py, an exact rule, no tuned constant): the width at which an
//   SM computes the fewer columns over the waves of tiles on the card's
//   SMs (read from the device), waves x the tile's width, so a wide tile's
//   padding past N counts in full; on a tie the wider tile, which reads
//   each A tile from shared memory once per 256 columns rather than twice.
//   Sums run over K in the same order at either width.
//   TMA needs each row stride a multiple of 16 bytes and each base
//   16-byte aligned.  An operand that breaks either (A: K off a multiple
//   of 8 or A off the grid; B: N off a multiple of 8 or B off the grid) is
//   first copied by pack16_kernel (pack16.cuh) into a zero-padded,
//   aligned workspace, A as M x Kp8 and B as K x Np8 (Kp8, Np8 rounded up
//   to 8); an operand TMA can load is read where it lies.  The pad columns
//   are zeros, and B's rows past K are TMA's zero fill, so the padded K
//   adds nothing.
// - float32 (Tf32x3): one split pass first (tf32_split_kernel) writes hi =
//   tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away from
//   zero (cvt.rna.tf32.f32; split_tf32 has the non-finite cases), of A as
//   [A_hi; A_lo] and of B transposed as [B_hi^T; B_lo^T] into a workspace
//   the wrapper allocates (at 4096^3 it moves ~400 MB, ~0.12 ms): TF32
//   wgmma takes both operands K-major and has no transpose bit for 32-bit
//   types.  The split pass reads A and B by scalar loads, so any base and
//   any K or N will do; it writes rows of Kp = K rounded up to 4 values,
//   the pad columns zeros, so the workspace's stride suits TMA.  Then BN =
//   128, 3 stages of four 128 x 32 boxes (A_hi, A_lo, B_hi^T, B_lo^T: 64
//   KB), and m64n128k8 lo*hi, hi*lo, hi*hi per K step of 8 into the same
//   float32 accumulators, the small terms first.  What is left out, lo*lo
//   and the rounding of lo, is about 2^-21 of each product: float32's own
//   range.
//   The tensor cores' accumulator does not round to nearest, so each stage
//   (K = 32) sums into a fresh one that the CUDA cores add to the tile's
//   float32 sums after wgmma.wait_group 0, which gives up the overlap of
//   one stage's products with the next one's.  One tile width, no rule.
//
// The epilogue rounds the accumulators to the output type and stores pairs
// of values straight from registers, masked at M and N; where N is odd a
// pair may cross the row's end and a row's start is not pair-aligned, so
// it stores one value at a time.  TMA zero-fills reads past M, N and K, so
// a ragged edge needs no load masks: danube's 4200 rows are 32 full row
// tiles and 104 rows.  (In the float32 route a hi box's rows past M or N
// read lo rows instead, which only reach output rows and columns that are
// never stored.)  The tensor maps are built on each call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// link needs no -lcuda) and passed as __grid_constant__ parameters.
// Persistent blocks (one tile's epilogue under the next one's loads) and a
// TMA-store epilogue are later work.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "pack16.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kConsumerThreads = 256;                 // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;        // and one producer warp
constexpr int kConsumerWarps = kConsumerThreads / 32;

// d(64xBN, float32) += A(64x16, K-major) @ B(16xBN, N-major: transpose
// bit set), both from shared memory through their descriptors.
template <typename T, int BN> struct Wgmma;
template <> struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HALO_WGMMA_REGS64
        ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : HALO_WGMMA_D64
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<__half, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HALO_WGMMA_REGS64
        ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : HALO_WGMMA_D64
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<__nv_bfloat16, 256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HALO_WGMMA_REGS128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : HALO_WGMMA_D128
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<__half, 256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " HALO_WGMMA_REGS128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : HALO_WGMMA_D128
        : "l"(a), "l"(b), "r"(1));
  }
};

// 16-bit operands (T bfloat16 or float16) into a 128 x BN tile: a stage
// holds A's 128 x 64 box (K-major, 128-byte rows) and BN/64 boxes of B of
// 64 K rows x 64 columns, N-major as B lies in memory, read through
// wgmma's transpose bit; a ring of 4 stages.
template <typename T, int BN> struct Half16 {
  using Out = T;
  static constexpr int kBN = BN, kBK = 64, kStages = 4, kAcc = BN / 2;
  static constexpr bool kPerStageSums = false;
  static constexpr uint32_t kABytes = kBM * kBK * 2;    // 16 KB: 128 rows of 128 B
  static constexpr uint32_t kBBoxBytes = kBK * 64 * 2;  // 8 KB: 64 K rows of 64 columns
  static constexpr uint32_t kStageBytes = kABytes + (BN / 64) * kBBoxBytes;

  static __device__ __forceinline__ void load(uint32_t stage, const CUtensorMap* map_a,
                                              const CUtensorMap* map_b, uint32_t full, int kt,
                                              int m0, int n0, int, int) {
    tma_load_2d(stage, map_a, full, kt * kBK, m0);
#pragma unroll
    for (int h = 0; h < BN / 64; ++h)
      tma_load_2d(stage + kABytes + h * kBBoxBytes, map_b, full, n0 + 64 * h, kt * kBK);
  }

  // A: K-major rows of 128 B, 8-row atoms 1024 B apart (the leading
  // offset is unused); B: N-major, boxes of 64 columns 8 KB apart, 8-row
  // K groups 1024 B apart; descriptors advanced 32 bytes (A) or 16 rows
  // (B) per K step of 16
  static __device__ __forceinline__ void mma(float (&d)[kAcc], uint32_t stage, int wg) {
    const uint32_t sa = stage + wg * 64 * 128, sb = stage + kABytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<T, BN>::run(d, desc_sw128(sa + kk * 32, 16, 1024),
                        desc_sw128(sb + kk * 16 * 128, kBBoxBytes, 1024));
  }

  static __device__ __forceinline__ void store(T* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = halo::round_pair<T>(x, y);
  }
  static __device__ __forceinline__ T one(float x) { return halo::from_float<T>(x); }
};

// float32 by 3xTF32 into a 128 x 128 tile: the operands come split, A as
// [A_hi; A_lo] (2M x K) and B transposed as [B_hi^T; B_lo^T] (2N x K), all
// K-major, and a stage holds four 128 x 32 boxes (128-byte rows), A_hi,
// A_lo, B_hi^T and B_lo^T, 64 KB; a ring of 3 stages.  Each K step of 8
// issues lo*hi, then hi*lo, then hi*hi into the same accumulators.
struct Tf32x3 {
  using Out = float;
  static constexpr int kBN = 128, kBK = 32, kStages = 3, kAcc = 64;
  static constexpr bool kPerStageSums = true;
  static constexpr uint32_t kBoxBytes = kBM * kBK * 4;  // 16 KB: 128 rows of 128 B
  static constexpr uint32_t kStageBytes = 4 * kBoxBytes;

  static __device__ __forceinline__ void load(uint32_t stage, const CUtensorMap* map_a,
                                              const CUtensorMap* map_b, uint32_t full, int kt,
                                              int m0, int n0, int M, int N) {
    tma_load_2d(stage, map_a, full, kt * kBK, m0);
    tma_load_2d(stage + kBoxBytes, map_a, full, kt * kBK, M + m0);
    tma_load_2d(stage + 2 * kBoxBytes, map_b, full, kt * kBK, n0);
    tma_load_2d(stage + 3 * kBoxBytes, map_b, full, kt * kBK, N + n0);
  }

  // every operand K-major: rows of 128 B, 8-row atoms 1024 B apart,
  // descriptors advanced 32 bytes per K step of 8; d = the stage's sum
  // (its first product overwrites d)
  static __device__ __forceinline__ void mma(float (&d)[kAcc], uint32_t stage, int wg) {
    const uint32_t a_hi = stage + wg * 64 * 128, a_lo = a_hi + kBoxBytes;
    const uint32_t b_hi = stage + 2 * kBoxBytes, b_lo = b_hi + kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint32_t off = kk * 32;
      WgmmaTf32::run(d, desc_sw128(a_lo + off, 16, 1024), desc_sw128(b_hi + off, 16, 1024),
                     kk > 0);
      WgmmaTf32::run(d, desc_sw128(a_hi + off, 16, 1024), desc_sw128(b_lo + off, 16, 1024), 1);
      WgmmaTf32::run(d, desc_sw128(a_hi + off, 16, 1024), desc_sw128(b_hi + off, 16, 1024), 1);
    }
  }

  static __device__ __forceinline__ void store(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};

// Outputs c and c + 1 of one row at p: one paired store where N is even
// (c is even, so the pair lies on its own boundary and inside the row),
// else one value at a time, the second only where c + 1 < N.
template <class S>
__device__ __forceinline__ void store_two(typename S::Out* p, float x, float y, bool pairs,
                                          bool second) {
  if (pairs) {
    S::store(p, x, y);
    return;
  }
  p[0] = S::one(x);
  if (second) p[1] = S::one(y);
}

// Dynamic shared memory of a tile: 1 KB of alignment slack, the stages, a
// full and an empty barrier per stage.
template <class S> constexpr size_t smem_bytes() {
  return 1024 + (size_t)S::kStages * S::kStageBytes + 16 * S::kStages;
}

template <class S>
__global__ void __launch_bounds__(kThreads, 1)
mmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, typename S::Out* __restrict__ C,
                 int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr int kStages = S::kStages;
  constexpr uint32_t kStageBytes = S::kStageBytes;
  const uint32_t bars = base + kStages * kStageBytes;  // full[s], then empty[s]
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * S::kBN;
  const int ktiles = (K + S::kBK - 1) / S::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warp: lane 0 keeps the ring full
    if (threadIdx.x == kConsumerThreads) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(bars + 8 * (kStages + s), ((kt / kStages) + 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, kStageBytes);
        S::load(base + s * kStageBytes, &map_a, &map_b, full, kt, m0, n0, M, N);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;  // consumer warpgroup: rows wg*64 .. +63
  const int lane = threadIdx.x % 32;
  float d[S::kAcc];
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) d[i] = 0.f;
  fence_acc(d);
  if constexpr (S::kPerStageSums) {
    // the tensor cores do not round their accumulator to nearest: one
    // accumulator over K = 4096 erred by ~3e-5 normwise on an H100, past
    // float32's 1e-5.  Each stage's products are summed in a fresh one,
    // which the CUDA cores then add to d, rounding to nearest (~3e-7)
    float part[S::kAcc];
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) part[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(bars + 8 * s, (kt / kStages) & 1);
      wgmma_fence();
      S::mma(part, base + s * kStageBytes, wg);
      wgmma_commit();
      wgmma_wait<0>();  // this stage's group is done: hand it back
      fence_acc(part);
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
#pragma unroll
      for (int i = 0; i < S::kAcc; ++i) d[i] += part[i];
    }
  } else {
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(bars + 8 * s, (kt / kStages) & 1);
      wgmma_fence();
      S::mma(d, base + s * kStageBytes, wg);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done: hand it back
      if (kt > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + (kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(d);
  }

  // d[4j + 2h + v]: row warp*16 + lane/4 + 8h, column 8j + 2*(lane%4) + v
  const int warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < S::kBN / 8; ++j) {
    const int c = n0 + j * 8 + 2 * (lane % 4);
    if (c >= N) continue;
    if (r0 < M)
      store_two<S>(C + (size_t)r0 * N + c, d[4 * j], d[4 * j + 1], pairs, c + 1 < N);
    if (r0 + 8 < M)
      store_two<S>(C + (size_t)(r0 + 8) * N + c, d[4 * j + 2], d[4 * j + 3], pairs, c + 1 < N);
  }
}

// The 3xTF32 route's split pass: split_tf32 of every element of A (M x K)
// into ws_a = [A_hi; A_lo] (2M x Kp), and of B (K x N), transposed through a
// shared tile so that reads and writes both coalesce, into ws_b = [B_hi^T;
// B_lo^T] (2N x Kp), with zeros (split as hi = lo = 0) in the columns K ..
// Kp - 1.  A and B are read by scalar loads: any base, any K and N.  One
// 32 x 32 tile per 256-thread block, the first tiles_a blocks on A.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ ws_a, float* __restrict__ ws_b, int M, int N, int K,
                  int Kp, int tiles_a) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int kx = (Kp + 31) / 32;
  if (static_cast<int>(blockIdx.x) < tiles_a) {
    const size_t mk = (size_t)M * Kp;
    const int r0 = blockIdx.x / kx * 32, c = blockIdx.x % kx * 32 + tx;
    for (int i = ty; i < 32 && c < Kp; i += 8) {
      if (r0 + i >= M) break;
      const size_t at = (size_t)(r0 + i) * Kp + c;
      split_tf32(c < K ? A[(size_t)(r0 + i) * K + c] : 0.f, ws_a[at], ws_a[mk + at]);
    }
    return;
  }
  const size_t nk = (size_t)N * Kp;
  const int b = blockIdx.x - tiles_a, nx = (N + 31) / 32;
  const int k0 = b / nx * 32, n0 = b % nx * 32;
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = k0 + i < K && n0 + tx < N ? B[(size_t)(k0 + i) * N + n0 + tx] : 0.f;
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    if (n0 + i >= N || k0 + tx >= Kp) continue;
    const size_t at = (size_t)(n0 + i) * Kp + k0 + tx;
    split_tf32(tile[tx][i], ws_b[at], ws_b[nk + at]);
  }
}

template <typename T> struct MapType;
template <> struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// Raise the kernel's dynamic shared-memory limit.  Being a runtime call, it
// also makes the device's primary context current on the calling host
// thread, which cuTensorMapEncodeTiled needs: a new thread (an agent's
// worker) has none until its first runtime call.
template <class S> cudaError_t allow_smem() {
  return cudaFuncSetAttribute(mmm_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<S>()));
}

template <class S>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, void* c, int m, int n, int k,
           cudaStream_t s) {
  const dim3 grid((n + S::kBN - 1) / S::kBN, (m + kBM - 1) / kBM);
  mmm_wgmma_kernel<S><<<grid, kThreads, smem_bytes<S>(), s>>>(
      map_a, map_b, static_cast<typename S::Out*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// a (m x kp, K-major) and b (k x np, N-major) as TMA loads them: kp >= k
// columns of a (a zero pad past k), np >= n columns of b; the K loop runs
// over kp, b's rows past k are TMA's zero fill.
template <typename T, int BN>
int launch_16(const void* a, const void* b, void* c, int m, int n, int k, int kp, int np,
              cudaStream_t s) {
  const cudaError_t rc = allow_smem<Half16<T, BN>>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  constexpr CUtensorMapDataType type = MapType<T>::value;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, type, 2, m, kp, kBM) || !make_map(&map_b, b, type, 2, k, np, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<Half16<T, BN>>(map_a, map_b, c, m, n, kp, s);
}

template <typename T>
int launch_width(const void* a, const void* b, void* c, int m, int n, int k, int kp, int np,
                 int bn, cudaStream_t s) {
  return bn == 256 ? launch_16<T, 256>(a, b, c, m, n, k, kp, np, s)
                   : launch_16<T, 128>(a, b, c, m, n, k, kp, np, s);
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

}  // namespace

// a (m, k), b (k, n), c (m, n) in the type of `dtype` (1 bfloat16, 2
// float16), c 16-byte aligned; bn the tile's columns, 128 or 256.  pack_a:
// a is first copied into ws as m x round_up(k, 8), zero-padded; else k is
// a multiple of 8 and a 16-byte aligned.  pack_b: b is copied into ws
// (after a's copy, if any) as k x round_up(n, 8); else n is a multiple of 8
// and b 16-byte aligned.  ws 16-byte aligned where either is packed.
extern "C" int halo_mmm_wgmma(const void* a, const void* b, void* c, void* ws, int m, int n,
                              int k, int bn, int pack_a, int pack_b, int dtype, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + kBM - 1) / kBM > 65535 || (bn != 128 && bn != 256) ||
      misaligned(c) || (!pack_a && (k % 8 || misaligned(a))) ||
      (!pack_b && (n % 8 || misaligned(b))) || ((pack_a || pack_b) && misaligned(ws)) ||
      encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = pack_a ? round_up(k, 8) : k, np = pack_b ? round_up(n, 8) : n;
  uint16_t* next = static_cast<uint16_t*>(ws);
  if (pack_a) {
    const int rc = pack16(a, next, m, k, kp, s);
    if (rc) return rc;
    a = next;
    next += static_cast<size_t>(m) * kp;
  }
  if (pack_b) {
    const int rc = pack16(b, next, k, n, np, s);
    if (rc) return rc;
    b = next;
  }
  switch (dtype) {
    case 1: return launch_width<__nv_bfloat16>(a, b, c, m, n, k, kp, np, bn, s);
    case 2: return launch_width<__half>(a, b, c, m, n, k, kp, np, bn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a (m, k), b (k, n), c (m, n) float32, c 16-byte aligned, a and b at any
// alignment; ws a 16-byte-aligned float32 workspace of 2*(m + n)*kp values,
// kp = k rounded up to a multiple of 4: the split pass writes [A_hi; A_lo]
// and [B_hi^T; B_lo^T] there, rows of kp values, and the product reads them.
extern "C" int halo_mmm_tf32x3(const void* a, const void* b, void* c, void* ws, int m,
                               int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + kBM - 1) / kBM > 65535 || 2LL * m >= (1LL << 31) ||
      2LL * n >= (1LL << 31) || misaligned(c) || misaligned(ws) || encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = allow_smem<Tf32x3>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int kp = round_up(k, 4);
  float* ws_a = static_cast<float*>(ws);
  float* ws_b = ws_a + 2 * (size_t)m * kp;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, ws_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2LL * m, kp, kBM) ||
      !make_map(&map_b, ws_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2LL * n, kp, Tf32x3::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_a = (m + 31LL) / 32 * ((kp + 31) / 32);
  const long long tiles = tiles_a + (kp + 31LL) / 32 * ((n + 31) / 32);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tf32_split_kernel<<<static_cast<unsigned>(tiles), 256, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), ws_a, ws_b, m, n, k, kp,
      static_cast<int>(tiles_a));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return launch<Tf32x3>(map_a, map_b, c, m, n, kp, s);
}
