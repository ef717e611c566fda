// MMM, tensor-core route: C(M,N) = A(M,K) @ B(K,N), row-major, bfloat16 or
// float16 operands, float32 accumulator, output in the input type.  K and N
// must be positive multiples of 8 and A, B, C 16-byte aligned: the Tensor
// Memory Accelerator's stride and address rules.  The route (mmm_route in
// kernels/matmul/matmul.py) is a pure function of type, shape and
// alignment: M <= 64 (SKINNY_M_MAX) in every type goes to mmm_skinny.cu,
// 16-bit operands above it that meet those rules come here (a prefill's
// projections), and everything else, float32 included, to mmm.cu.
//
// Replaces src/repro/kernels/matmul/matmul.py::mmm_pallas (_mmm_kernel),
// which walks (bm, bn) output tiles with K innermost on the TPU's MXU:
// 16-bit products into a float32 VMEM accumulator
// (preferred_element_type=float32), rounded to the input type at the last
// K step.  That is what the H100's tensor cores do.
//
// Bound on the H100: operations.  A danube prefill projection of 4200
// tokens (4200x2560 @ 2560x6912) does 2*M*N*K = 149 GFLOP, 0.150 ms at the
// 989 TFLOP/s of the bfloat16 tensor cores, against 114 MB of operands and
// result (0.034 ms at 3.35 TB/s).  mmm.cu widens every element to float32
// and multiplies on the CUDA cores (67 TFLOP/s): 2.2 ms at least.
//
// Design (Hopper's warp-specialised GEMM, simple first): one 288-thread
// block per 128 x BN output tile, BN = 128 or 256, not persistent.  One
// producer warp (its lane 0) streams 128x64 tiles of A and 64xBN tiles of
// B into a ring of 4 shared-memory stages (32 KB each at BN = 128, 48 KB
// at 256) with TMA (cp.async.bulk.tensor.2d), each stage guarded by a
// "full" mbarrier (transaction bytes) and an "empty" one (one arrival per
// consumer warp).  Both operands are loaded with the 128-byte swizzle: A is
// K-major, its 128-byte rows one box of 64 x 128; B stays row-major
// (N-major) as it lies in memory, in boxes of 64 columns, and wgmma reads
// it through its transpose bit, so nothing copies or transposes B.  Two
// consumer warpgroups each own 64 rows of the tile and run
// wgmma.mma_async m64nBNk16 (float32 accumulators, BN/2 registers a thread)
// four times per stage, the descriptors advanced 32 bytes (A) or 16 rows
// (B) per K step of 16; a stage goes back to the producer once the next
// stage's group is issued and wgmma.wait_group 1 shows the stage's own
// group done.  No setmaxnreg: with one 288-thread block per SM each thread
// may hold up to 224 registers, more than the 128 accumulators of a
// 128x256 tile and their addressing need, so there is nothing to move.
//
// Tile width (wgmma_tile_n in matmul.py, an exact rule, no tuned
// constant): the width at which an SM computes the fewer columns over the
// waves of tiles on the card's SMs (read from the device), waves x the
// tile's width, so a wide tile's padding past N counts in full; on a tie
// the wider tile, which reads each A tile from shared memory once per 256
// columns rather than twice.  Sums run over K in the same order at either
// width, so the bits do not depend on it.
//
// The epilogue rounds the accumulators to the input type and stores pairs
// of values straight from registers, masked at M and N.  TMA zero-fills
// reads past M, N and K, so a ragged edge needs no load masks: danube's
// 4200 rows are 32 full row tiles and 104 rows.  The tensor maps are built
// on each call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the link needs no -lcuda) and passed as
// __grid_constant__ parameters.  Sums run over K in another order than
// mmm.cu's, so the two agree within tolerance, not bit for bit.
// Persistent blocks (one tile's epilogue under the next one's loads) and a
// TMA-store epilogue are later work.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBK = 64;
constexpr int kConsumerThreads = 256;                 // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;        // and one producer warp
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr uint32_t kABytes = kBM * kBK * 2;            // 16 KB: 128 rows of 128 B
constexpr uint32_t kBBoxBytes = kBK * 64 * 2;           // 8 KB: 64 K rows of 64 columns

constexpr int kStages = 4;                              // the ring

// Geometry of a 128 x BN output tile: accumulators per consumer thread,
// the bytes of one stage and the dynamic shared memory (1 KB of alignment
// slack, the stages, a full and an empty barrier per stage).
template <int BN> struct Tile {
  static constexpr int kAcc = BN / 2;
  static constexpr uint32_t kStageBytes = kABytes + (BN / 64) * kBBoxBytes;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D box of the tensor map at (c0 innermost, c1) into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`
// (1024-byte aligned swizzle atoms): leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HALO_WGMMA_D64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define HALO_WGMMA_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,  " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,  " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,  " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,  " \
  "%58, %59, %60, %61, %62, %63}"

#define HALO_WGMMA_D128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),         \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),         \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),         \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),         \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),         \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),         \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),         \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),        \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),    \
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),    \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),    \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),    \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),    \
      "+f"(d[126]), "+f"(d[127])

#define HALO_WGMMA_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,  " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,  " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,  " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,  " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,  " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,  " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,  " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,  " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123,  " \
  "%124, %125, %126, %127}"

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

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float x, float y) {
    return __floats2bfloat162_rn(x, y);
  }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type make(float x, float y) {
    return __floats2half2_rn(x, y);
  }
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
mmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, T* __restrict__ C, int M,
                 int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  using G = Tile<BN>;
  constexpr uint32_t kStageBytes = G::kStageBytes;
  const uint32_t bars = base + kStages * kStageBytes;  // full[s], then empty[s]
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kBK - 1) / kBK;

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
        const uint32_t sa = base + s * kStageBytes, sb = sa + kABytes;
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(sa, &map_a, full, kt * kBK, m0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load_2d(sb + h * kBBoxBytes, &map_b, full, n0 + 64 * h, kt * kBK);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;  // consumer warpgroup: rows wg*64 .. +63
  const int lane = threadIdx.x % 32;
  float d[G::kAcc];
#pragma unroll
  for (int i = 0; i < G::kAcc; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(bars + 8 * s, (kt / kStages) & 1);
    const uint32_t stage = base + s * kStageBytes;
    const uint32_t sa = stage + wg * 64 * 128, sb = stage + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: K-major rows of 128 B, 8-row atoms 1024 B apart (the leading
      // offset is unused); B: N-major, boxes of 64 columns 8 KB apart,
      // 8-row K groups 1024 B apart
      Wgmma<T, BN>::run(d, desc_sw128(sa + kk * 32, 16, 1024),
                        desc_sw128(sb + kk * 16 * 128, kBBoxBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group is done: hand it back
    if (kt > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + (kt - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(d);

  // d[4j + 2h + v]: row warp*16 + lane/4 + 8h, column 8j + 2*(lane%4) + v
  const int warp = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  using P = Pair<T>;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + 2 * (lane % 4);
    if (c >= N) continue;
    if (r0 < M)
      *reinterpret_cast<typename P::type*>(C + (size_t)r0 * N + c) =
          P::make(d[4 * j], d[4 * j + 1]);
    if (r0 + 8 < M)
      *reinterpret_cast<typename P::type*>(C + (size_t)(r0 + 8) * N + c) =
          P::make(d[4 * j + 2], d[4 * j + 3]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's entry-point
// query.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, cols) 16-bit matrix in boxes of
// box_rows x 64 columns (128 bytes), 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int rows, int cols,
              int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T> struct MapType;
template <> struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

template <typename T, int BN>
int launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t s) {
  constexpr CUtensorMapDataType type = MapType<T>::value;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, type, m, k, kBM) || !make_map(&map_b, b, type, k, n, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Tile<BN>::kSmem;
  cudaError_t rc = cudaFuncSetAttribute(mmm_wgmma_kernel<T, BN>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM);
  mmm_wgmma_kernel<T, BN><<<grid, kThreads, smem, s>>>(map_a, map_b, static_cast<T*>(c),
                                                        m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* a, const void* b, void* c, int m, int n, int k, int bn,
                 cudaStream_t s) {
  return bn == 256 ? launch<T, 256>(a, b, c, m, n, k, s) : launch<T, 128>(a, b, c, m, n, k, s);
}

}  // namespace

// a (m, k), b (k, n), c (m, n) in the type of `dtype` (1 bfloat16, 2
// float16), 16-byte aligned, k and n multiples of 8; bn the tile's
// columns, 128 or 256.
extern "C" int halo_mmm_wgmma(const void* a, const void* b, void* c, int m, int n, int k,
                              int bn, int dtype, void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (m < 1 || n < 8 || k < 8 || n % 8 || k % 8 || (m + kBM - 1) / kBM > 65535 ||
      (bn != 128 && bn != 256) ||
      misaligned(a) || misaligned(b) || misaligned(c) || encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_width<__nv_bfloat16>(a, b, c, m, n, k, bn, s);
    case 2: return launch_width<__half>(a, b, c, m, n, k, bn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
