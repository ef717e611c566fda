// FLASH_ATTN for float32 on the tensor cores by 3xTF32: online-softmax GQA
// attention, q (B,H,Sq,D), k/v (B,Hkv,Skv,D) -> o (B,H,Sq,D), row-major and
// contiguous, head dims 32, 64, 80, 96, 128 and 256.  The masks, positions
// and the masked score -1e30 are those of attention.cuh, as in the other
// two FLASH_ATTN kernels (flash_attention_mma.cu for bfloat16 and float16
// up to head dim 128, flash_attention_wgmma.cu for them at head dim 256).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_fa_kernel), whose grid (B, H, Sq/bq, Skv/bk)
// runs the KV axis in order on the TPU and carries m, l and the f32
// accumulator in VMEM scratch from one KV step to the next; q is scaled
// and both products accumulate in float32.
//
// Bound on the H100: operations.  At (1,32,4200,80) with Hkv 8, causal and
// a 4096 window, the 2.8e8 visible (q, k) pairs need 4*D operations each,
// 90 GFLOP: 0.182 ms at the 495 TFLOP/s of the TF32 tensor cores (three
// products each, as below: 0.547 ms), 1.35 ms on the float32 CUDA cores,
// against 108 MB of q, k, v and o (0.032 ms at 3.35 TB/s).  So both
// products must run on the tensor cores, and TF32 alone keeps ~11 bits:
// each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (split_tf32 of tma_wgmma.cuh; a non-finite x goes whole into lo), and
// each product is lo*hi + hi*lo + hi*hi, which holds float32's 1e-5.
//
// Design (FlashAttention-2's loop, with wgmma): two kernels a call.
// - The split pass (fa_split_kernel) writes each (KV head, key tile) of K
//   and V once into a workspace as the product kernel's shared memory
//   holds it: the hi and lo planes of k (K-major, rows of 32 floats, the
//   128-byte swizzle that desc_sw128 reads) and of vᵀ (head-dim rows of 32
//   keys), the keys of each 8 permuted (position t holds key 2t, t + 4
//   holds key 2t + 1); keys past Skv are zeros.  Every query tile of a head
//   reads the same key tiles, so splitting them in the product kernel
//   would repeat the work once per query tile.
// - The product kernel (fa_wgmma_kernel): one block per (b, h, query tile)
//   of 128 rows (64 at D = 256), a warpgroup per 64 rows; the KV head is
//   h / (H / Hkv); query tiles run heaviest first.  q is split into its hi
//   and lo planes once.  Key tiles (64 keys; 32 at D = 128 and 256) are
//   copied from the workspace by cp.async into one buffer of k planes and
//   one of vᵀ planes (at D = 256 one buffer taking turns): vᵀ of a tile
//   while its scores are computed, k of the next visited tile while its
//   softmax and p·v run.
// - q·kᵀ: wgmma.m64nNk8 (N = the key tile), both operands from shared
//   memory, lo*hi, hi*lo and hi*hi per 8-deep step.  The tensor cores do
//   not round their accumulator to nearest, so each 32-deep stage of the
//   head dim (at D = 80: 32 + 32 + 16) sums into a fresh accumulator that
//   the CUDA cores add in float32.  Scores are scaled by D^-1/2 in float32;
//   masks are applied per element only on tiles that cross the band's
//   edge, the prefix or Skv.  Row maxima and sums reduce over the 4
//   threads of a quad by shuffles; o is rescaled by exp(m_old - m_new) per
//   key tile.
// - p·v: p = exp(s - m) is split in registers and is the A operand from
//   registers.  The m64nN accumulator holds keys (2t, 2t + 1) of a
//   thread's rows where the A fragment wants k-indices (t, t + 4): the
//   split pass permuted vᵀ's keys to match, so neither shuffles nor shared
//   memory are needed for p.  Each 32 keys sum into a fresh accumulator
//   (128 columns of o at a time: two passes at D = 256) that the CUDA
//   cores add to o in float32; l sums hi + lo, the p that the product uses.
// Tiles wholly outside the causal/window band (and the prefix) are
// skipped; keys past Skv take no part (score -inf, p = 0); a query row that
// sees no key gets the mean of v over the Skv real keys, as attention_ref
// does, and a tile holding one visits every key tile.  Key tiles run in
// order and every sum has a fixed order (no atomics), so two calls give
// the same bits.  Shared memory: q's planes and one key tile's, 185 KB at
// D = 80, 193 KB at D = 128 and 256.
#include <cstdint>

#include "attention.cuh"
#include "common.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int kStageD = 32;   // head-dim columns per q·kᵀ accumulator
constexpr int kChunk = 32;    // keys per p·v accumulator, at most

using Shape = halo::AttnShape;

// x as its TF32 parts (split_tf32), as mma operands.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split_tf32(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

__device__ __forceinline__ void split4(float4 x, float4& h, float4& l) {
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
}

// 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d (m64 x N, float32) += A·B, TF32 operands, B K-major in shared memory
// through its descriptor, A there too (WgSS) or in registers (WgRS, the
// m16n8k8 A fragment of each warp's 16 rows); scale_d = 0 writes d = A·B.
template <int N> struct WgSS;
template <int N> struct WgRS;
template <> struct WgSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct WgSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct WgRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct WgRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct WgRS<80> {
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct WgRS<96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
        "%41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
          "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <> struct WgRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
          "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
          "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the registers of an A operand alive until the wgmma that reads
// them has completed.
template <int N>
__device__ __forceinline__ void keep(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]));
}

// Byte offset of (row, col) in a K-major operand of `rows` rows stored as
// 128-byte-swizzled blocks of 32 floats (each block rows x 128 B, 8-row
// atoms of 1024 B, the 16-byte chunk c of row r at c ^ (r % 8)), the layout
// TMA writes and desc_sw128 reads.
__device__ __forceinline__ uint32_t sw128(int rows, int row, int col) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

template <int D>
struct WGeom {
  static constexpr int kBQ = D <= 128 ? 128 : 64;  // query rows: a warpgroup per 64
  static constexpr int kBK = D <= 96 ? 64 : 32;    // keys a tile
  static constexpr int kThreads = 2 * kBQ;
  static constexpr int kBlocks = (D + 31) / 32;    // 32-float column blocks of q and k
  static constexpr uint32_t kQPlane = kBQ * kBlocks * 128;   // bytes of a q plane
  static constexpr uint32_t kKPlane = kBK * kBlocks * 128;   // of a k plane
  static constexpr uint32_t kVPlane = D * (kBK / 32) * 128;  // of a vᵀ plane
  // a key tile's planes as the split pass writes them: k hi, k lo, vᵀ hi, vᵀ lo
  static constexpr uint32_t kTileBytes = 2 * (kKPlane + kVPlane);
  // at D = 256 k's and vᵀ's planes take turns in one buffer
  static constexpr bool kShareKV = D > 128;
  static constexpr uint32_t kKVBytes =
      kShareKV ? (kKPlane > kVPlane ? 2 * kKPlane : 2 * kVPlane) : kTileBytes;
  static constexpr size_t kSmem = 1024 + 2 * (size_t)kQPlane + kKVBytes;
  // p·v's columns a wgmma: at most 128 (64 accumulators a thread)
  static constexpr int kPvN = D < 128 ? D : 128;
};

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  return vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
}

// The split pass: each (key tile, KV head, batch) of K (even blocks) and
// V (odd blocks) into the tile's hi and lo planes, laid out as the product
// kernel's shared memory holds them: K's rows swizzled, V transposed with
// its keys permuted within each 8 (position t holds key 2t and t + 4 holds
// key 2t + 1, the order of p's A fragment).  Keys past Skv are zeros.
template <int D>
__global__ void __launch_bounds__(256)
fa_split_kernel(const float* __restrict__ K, const float* __restrict__ V,
                unsigned char* __restrict__ ws, Shape s, int vec) {
  using G = WGeom<D>;
  constexpr int kC = D / 4, kBK = G::kBK;
  const int kt = blockIdx.x >> 1, hk = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * s.Hkv + hk;
  const float* k = K + head * s.Skv * D;
  const float* v = V + head * s.Skv * D;
  unsigned char* kh = ws + (head * (gridDim.x >> 1) + kt) * G::kTileBytes;
  unsigned char* kl = kh + G::kKPlane;
  unsigned char* vh = kl + G::kKPlane;
  unsigned char* vl = vh + G::kVPlane;
  const int k0 = kt * kBK;
  const bool vec16 = vec != 0;
  if ((blockIdx.x & 1) == 0) {
    for (int c = threadIdx.x; c < kBK * kC; c += 256) {
      const int r = c / kC, col = (c % kC) * 4;
      float4 h, l;
      split4(k0 + r < s.Skv ? load4(k + (size_t)(k0 + r) * D + col, vec16)
                            : make_float4(0.f, 0.f, 0.f, 0.f),
             h, l);
      const uint32_t at = sw128(kBK, r, col);
      *reinterpret_cast<float4*>(kh + at) = h;
      *reinterpret_cast<float4*>(kl + at) = l;
    }
    return;
  }
  // a warp's lanes take 32 keys of one column: its stores fill a 128-byte
  // row of vᵀ
  for (int c = threadIdx.x; c < kBK * kC; c += 256) {
    const int j = c % kBK, col = (c / kBK) * 4;
    const int pos = (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
    const float4 x = k0 + j < s.Skv ? load4(v + (size_t)(k0 + j) * D + col, vec16)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split_tf32(xs[e], h, l);
      const uint32_t at = sw128(D, col + e, pos);
      *reinterpret_cast<float*>(vh + at) = h;
      *reinterpret_cast<float*>(vl + at) = l;
    }
  }
}

// `bytes` (a multiple of 16) from global to shared memory, asynchronously,
// by the block's kThreads threads.
template <int kThreads>
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           uint32_t bytes) {
  for (uint32_t c = threadIdx.x; c < bytes / 16; c += kThreads)
    cp_async16(dst + 16 * c, src + 16 * c);
}

template <int D>
__global__ void __launch_bounds__(WGeom<D>::kThreads, 1)
fa_wgmma_kernel(const float* __restrict__ Q, const unsigned char* __restrict__ ws,
                float* __restrict__ O, Shape s, int vec) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using G = WGeom<D>;
  constexpr int kBQ = G::kBQ, kBK = G::kBK, kThreads = G::kThreads, kPvN = G::kPvN;
  constexpr int kNT = kBK / 8;  // n-tiles of 8 keys
  constexpr int kDT = D / 8;    // n-tiles of 8 head-dim columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t qh_s = (raw_s + 1023) & ~1023u, ql_s = qh_s + G::kQPlane;
  const uint32_t kh_s = ql_s + G::kQPlane, kl_s = kh_s + G::kKPlane;
  const uint32_t vh_s = G::kShareKV ? kh_s : kl_s + G::kKPlane, vl_s = vh_s + G::kVPlane;
  unsigned char* const qh = smem_raw + (qh_s - raw_s);
  unsigned char* const ql = qh + G::kQPlane;
  unsigned char* const kh = ql + G::kQPlane;
  unsigned char* const vh = kh + (vh_s - kh_s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in quad
  const int wg = warp >> 2;                // warpgroup: query rows 64 wg ..
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const float* q = Q + ((size_t)b * s.H + h) * s.Sq * D;
  float* o = O + ((size_t)b * s.H + h) * s.Sq * D;

  // A row that sees no key makes this tile visit every key tile; otherwise
  // only tiles that meet the band of its first to last row, or the prefix.
  const int row_end = min(q0 + kBQ, s.Sq);
  bool blind = false;
  if (tid < kBQ && q0 + tid < s.Sq) {
    const int pos = s.q_offset + q0 + tid;
    blind = s.prefix == 0 && halo::band_lo(s, pos) > halo::band_hi(s, pos);
  }
  const bool any_blind = __syncthreads_or(blind);
  const int pos_first = s.q_offset + q0, pos_last = s.q_offset + row_end - 1;
  const int band0 = halo::band_lo(s, pos_first), band1 = halo::band_hi(s, pos_last);
  const int nk = (s.Skv + kBK - 1) / kBK;
  auto next_tile = [&](int kt) {
    for (; kt < nk; ++kt) {
      const int k0 = kt * kBK, k_last = min(k0 + kBK, s.Skv) - 1;
      if (any_blind || k0 < s.prefix || !(k_last < band0 || k0 > band1)) break;
    }
    return kt;
  };
  // this KV head's split tiles; k's planes, then vᵀ's
  const unsigned char* tiles = ws + ((size_t)b * s.Hkv + hk) * nk * G::kTileBytes;
  constexpr uint32_t kKBytes = 2 * G::kKPlane, kVBytes = 2 * G::kVPlane;

  const bool vec16 = vec != 0;
  int kt = next_tile(0);  // < nk: a tile with no blind row sees some key
  copy_async<kThreads>(kh, tiles + (size_t)kt * G::kTileBytes, kKBytes);
  cp_async_commit();
  // q split into its planes once, from global memory (rows past Sq: zeros)
  for (int c = tid; c < kBQ * (D / 4); c += kThreads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float4 hq, lq;
    split4(q0 + r < s.Sq ? load4(q + (size_t)(q0 + r) * D + col, vec16)
                         : make_float4(0.f, 0.f, 0.f, 0.f),
           hq, lq);
    const uint32_t at = sw128(kBQ, r, col);
    *reinterpret_cast<float4*>(qh + at) = hq;
    *reinterpret_cast<float4*>(ql + at) = lq;
  }

  float acc[kDT * 4];  // o, in the accumulator layout of m64nD
#pragma unroll
  for (int i = 0; i < kDT * 4; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp's 16
  float m0 = halo::kMaskedScore, m1 = halo::kMaskedScore, l0 = 0.f, l1 = 0.f;
  const int pos0 = pos_first + warp * 16 + g, pos1 = pos0 + 8;
  const uint32_t q_rows = wg * 64 * 128;  // the warpgroup's rows in a q block

  // K's and vᵀ's planes each have one buffer: vᵀ of tile kt is copied
  // while its scores are computed, k of the next visited tile while its
  // softmax and p·v run.  cp.async groups: k(kt), then vᵀ(kt), then
  // k(next), ...  Where the two share one buffer (kShareKV), vᵀ is copied
  // once the scores are done and k once p·v is.
  while (kt < nk) {
    const int next = next_tile(kt + 1);
    cp_async_wait_all();  // k of this tile
    fence_proxy_async();  // what cp.async and the q split wrote is read by wgmma
    __syncthreads();      // ... and every warpgroup is done with the last tile
    if constexpr (!G::kShareKV) {
      copy_async<kThreads>(vh, tiles + (size_t)kt * G::kTileBytes + kKBytes, kVBytes);
      cp_async_commit();
    }

    // S = q·kᵀ, 64 rows x kBK keys per warpgroup: each 32-float block of
    // the head dim in a fresh accumulator (its first product overwrites
    // it), added to sc in float32
    float sc[kNT * 4], st[kNT * 4];
#pragma unroll
    for (int cb = 0; cb < G::kBlocks; ++cb) {
      constexpr int kFull = kStageD / 8;
      const int steps = D - cb * kStageD < kStageD ? (D - cb * kStageD) / 8 : kFull;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFull; ++kk) {
        if (kk < steps) {
          const uint32_t qa = cb * kBQ * 128 + q_rows + kk * 32, ka = cb * kBK * 128 + kk * 32;
          WgSS<kBK>::run(st, desc_sw128(ql_s + qa, 16, 1024), desc_sw128(kh_s + ka, 16, 1024),
                         kk > 0);
          WgSS<kBK>::run(st, desc_sw128(qh_s + qa, 16, 1024), desc_sw128(kl_s + ka, 16, 1024),
                         1);
          WgSS<kBK>::run(st, desc_sw128(qh_s + qa, 16, 1024), desc_sw128(kh_s + ka, 16, 1024),
                         1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
#pragma unroll
      for (int i = 0; i < kNT * 4; ++i) sc[i] = cb == 0 ? st[i] : sc[i] + st[i];
    }
    __syncthreads();  // every warpgroup is done with k's planes
    if constexpr (G::kShareKV) {
      copy_async<kThreads>(vh, tiles + (size_t)kt * G::kTileBytes + kKBytes, kVBytes);
    } else if (next < nk) {
      copy_async<kThreads>(kh, tiles + (size_t)next * G::kTileBytes, kKBytes);
    }
    cp_async_commit();

    // scale; mask only where the tile crosses the band's edge, the prefix
    // or Skv
    const int k0 = kt * kBK, k_end = k0 + kBK - 1;
    const bool interior =
        k_end < s.Skv &&
        (k_end < s.prefix || ((!s.causal || k_end <= pos_first) &&
                              (!s.has_window || k0 > pos_last - s.window)));
    float mx0 = HALO_NEG_INF, mx1 = HALO_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * nt + e] * s.scale;
        if (!interior) {
          const int j = k0 + nt * 8 + 2 * tq + (e & 1);
          if (j >= s.Skv)
            x = HALO_NEG_INF;
          else if (!halo::visible(s, e < 2 ? pos0 : pos1, j))
            x = halo::kMaskedScore;
        }
        sc[4 * nt + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: m starts at -1e30
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[4 * dt] *= corr0;
      acc[4 * dt + 1] *= corr0;
      acc[4 * dt + 2] *= corr1;
      acc[4 * dt + 3] *= corr1;
    }

    // o += p·v, 32 keys at a time in a fresh accumulator (its first product
    // overwrites it) added to o in float32.  p = exp(s - m) is split in
    // registers; as the A fragment, k-index tq is key 2tq of the 8-key step
    // and tq + 4 is key 2tq + 1 (the C fragment's two columns), the order
    // in which the split pass laid out vᵀ.  l sums hi + lo.
    float rs0 = 0.f, rs1 = 0.f;
    if constexpr (G::kShareKV)
      cp_async_wait_all();  // vᵀ of this tile
    else
      cp_async_wait_all_but_one();
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < kBK; c0 += kChunk) {
      uint32_t ph[kChunk / 8][4], pl[kChunk / 8][4];
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = expf(sc[4 * (c0 / 8 + ks) + e] - (e < 2 ? mn0 : mn1));
        split(p[0], ph[ks][0], pl[ks][0]);  // row g,     key 2tq
        split(p[2], ph[ks][1], pl[ks][1]);  // row g + 8, key 2tq
        split(p[1], ph[ks][2], pl[ks][2]);  // row g,     key 2tq + 1
        split(p[3], ph[ks][3], pl[ks][3]);  // row g + 8, key 2tq + 1
        rs0 += (__uint_as_float(ph[ks][0]) + __uint_as_float(pl[ks][0])) +
               (__uint_as_float(ph[ks][2]) + __uint_as_float(pl[ks][2]));
        rs1 += (__uint_as_float(ph[ks][1]) + __uint_as_float(pl[ks][1])) +
               (__uint_as_float(ph[ks][3]) + __uint_as_float(pl[ks][3]));
      }
      // kPvN columns of o a pass (two passes at D = 256)
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += kPvN) {
        float c[kPvN / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kChunk / 8; ++ks) {
          const uint32_t va = ((c0 / kChunk) * D + n0) * 128 + ks * 32;
          WgRS<kPvN>::run(c, pl[ks], desc_sw128(vh_s + va, 16, 1024), ks > 0);
          WgRS<kPvN>::run(c, ph[ks], desc_sw128(vl_s + va, 16, 1024), 1);
          WgRS<kPvN>::run(c, ph[ks], desc_sw128(vh_s + va, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(c);
#pragma unroll
        for (int i = 0; i < kPvN / 2; ++i) acc[n0 / 2 + i] += c[i];
      }
      keep(ph);
      keep(pl);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    if constexpr (G::kShareKV) {
      __syncthreads();  // every warpgroup is done with vᵀ's planes
      if (next < nk) copy_async<kThreads>(kh, tiles + (size_t)next * G::kTileBytes, kKBytes);
      cp_async_commit();
    }
    kt = next;
  }

  // l >= 1: the row's largest score contributes exp(0) = 1, split exactly
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * tq;
    if (r0 < s.Sq)
      *reinterpret_cast<float2*>(o + (size_t)r0 * D + col) =
          make_float2(acc[4 * dt] / l0, acc[4 * dt + 1] / l0);
    if (r1 < s.Sq)
      *reinterpret_cast<float2*>(o + (size_t)r1 * D + col) =
          make_float2(acc[4 * dt + 2] / l1, acc[4 * dt + 3] / l1);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* ws,
                 long long ws_bytes, int b, const Shape& s, int vec, cudaStream_t stream) {
  using G = WGeom<D>;
  const int nk = (s.Skv + G::kBK - 1) / G::kBK;
  if (ws_bytes < (long long)b * s.Hkv * nk * G::kTileBytes ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned char* w = static_cast<unsigned char*>(ws);
  fa_split_kernel<D><<<dim3(2u * nk, (unsigned)s.Hkv, (unsigned)b), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), w, s, vec);
  const dim3 grid((unsigned)((s.Sq + G::kBQ - 1) / G::kBQ), (unsigned)s.H, (unsigned)b);
  fa_wgmma_kernel<D><<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(q), w, static_cast<float*>(o), s, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As halo_flash_attention_mma, for float32 (dtype 0) only, with the split
// pass's workspace ws of ws_bytes (tf32x3_workspace_bytes); vec: q, k and v
// start on the 16-byte grid (cp.async staging and 16-byte loads of q),
// else plain loads.  o must lie on the 8-byte grid.
extern "C" int halo_flash_attention_tf32x3(const void* q, const void* k, const void* v,
                                           void* o, void* ws, long long ws_bytes, int b,
                                           int h, int hkv, int sq, int skv, int d, int causal,
                                           int has_window, int window, int prefix,
                                           float scale, int dtype, int vec, void* stream) {
  if (dtype != 0 || hkv <= 0 || h % hkv != 0 || skv <= 0 || sq <= 0 ||
      reinterpret_cast<uintptr_t>(o) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{h, hkv, sq, skv, skv - sq, causal, has_window, window, prefix, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_wgmma<32>(q, k, v, o, ws, ws_bytes, b, s, vec, st);
    case 64: return launch_wgmma<64>(q, k, v, o, ws, ws_bytes, b, s, vec, st);
    case 80: return launch_wgmma<80>(q, k, v, o, ws, ws_bytes, b, s, vec, st);
    case 96: return launch_wgmma<96>(q, k, v, o, ws, ws_bytes, b, s, vec, st);
    case 128: return launch_wgmma<128>(q, k, v, o, ws, ws_bytes, b, s, vec, st);
    case 256: return launch_wgmma<256>(q, k, v, o, ws, ws_bytes, b, s, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
