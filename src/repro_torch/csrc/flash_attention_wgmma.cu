// FLASH_ATTN for bfloat16 and float16 at head dim 256 on the tensor cores
// (wgmma, TMA, a warp-specialised ring): online-softmax GQA attention,
// q (B,H,Sq,256), k/v (B,Hkv,Skv,256) -> o (B,H,Sq,256), row-major and
// contiguous, float32 sums, o in the input type.  The masks, positions
// and the masked score -1e30 are those of attention.cuh, as in the other
// two FLASH_ATTN routes (flash_attention_mma.cu for bfloat16 and float16 up
// to head dim 128, flash_attention_tf32x3.cu for float32 at every head dim).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_fa_kernel), whose grid (B, H, Sq/bq, Skv/bk)
// runs the KV axis in order on the TPU and carries m, l and the f32
// accumulator in VMEM scratch from one KV step to the next; its two
// products go to the MXU in the input type with float32 accumulation.
//
// Bound on the H100: operations.  gemma-7b's prefill heads, 1x16x4096x256
// causal, have 1.34e8 visible (q, k) pairs of 4*256 operations each, 137
// GFLOP: 0.139 ms at the 989 TFLOP/s of the bfloat16 tensor cores, 2.05 ms
// on the float32 CUDA cores, against 134 MB of q, k, v and o (0.040 ms at
// 3.35 TB/s).  So both products must run on the tensor cores at their
// full rate, which on Hopper only wgmma reaches, and the softmax between
// them must stay in registers.
//
// Design (FlashAttention-3's layout, without its ping-pong schedule): one
// 384-thread block per (b, h, 128 query rows), query tiles heaviest first;
// the KV head is h / (H / Hkv).  One producer warpgroup (its first thread)
// issues every load by TMA; two consumer warpgroups own 64 query rows each.
// Registers: o alone takes 128 float32 registers a consumer thread.  A
// 288-thread block (one producer warp) puts 3 warps on some of the SM's
// four register-file quarters of 16,384 registers, so ptxas holds every
// thread to 168 registers, at which ptxas spilled ~600 bytes a thread and
// serialised the wgmma.  With a producer warpgroup, setmaxnreg moves
// registers from it (24 a thread) to the consumers (240 a thread).
// - Shared memory: q's 128 x 256 tile (64 KB), loaded once, and a ring of
//   two stages of one key tile each, k and v of 64 keys (2 x 32 KB a
//   stage): 192 KB of the 227 KB.  Every box is 64 head-dim columns (128
//   bytes) wide and lands with the 128-byte swizzle that desc_sw128 reads.
//   A stage's k and v each complete a "full" mbarrier (transaction bytes),
//   so q·kᵀ starts before v has arrived; its "empty" mbarrier takes one
//   arrival per consumer warp once p·v has read the stage.
// - The tensor maps are 3-D, (256, Sq, B·H) for q and (256, Skv, B·Hkv) for
//   k and v: TMA zero-fills a box's rows past Sq or Skv instead of reading
//   the next head's rows.  Operands off the 16-byte grid (TMA needs a
//   16-byte base) are first copied whole by pack16_kernel (pack16.cuh) into
//   a workspace the wrapper allocates; the rows are 512 bytes, so strides
//   always suit.
// - q·kᵀ: wgmma.m64n64k16, 16 k-steps, both operands from shared memory,
//   K-major, into 32 float32 registers a thread (a fresh accumulator per
//   key tile).  Scores are scaled by D^-1/2 in float32; masks are applied
//   per element only on tiles that cross the band's edge, the prefix or
//   Skv (keys past Skv: -inf, p = 0).  Row maxima and sums reduce over the
//   4 threads of a quad by shuffles; m and l stay in registers and o is
//   rescaled by exp(m_old - m_new) per key tile.
// - p = exp(s - m) is rounded to the input type in registers; the rounded
//   p is both the A operand of p·v and what l sums, as in the mma route
//   (plain model: ref.py::attention_mma_ref with 64-key tiles).  For
//   16-bit wgmma the accumulator fragment of q·kᵀ is the register A
//   fragment of p·v, so p needs no shuffle and no shared memory.
// - p·v: wgmma.m64n256k16, A from registers, B the v tile N-major as TMA
//   wrote it, read through the transpose bit; 4 k-steps of 16 keys into the
//   128 float32 accumulators of o a thread (32 of scores and 16 of p
//   beside them).
// - o = acc / l is stored in the input type straight from registers, pairs
//   of values, only rows < Sq.
// Key tiles wholly outside the causal/window band (and the prefix) are
// skipped, by producer and consumers alike; a query tile holding a row
// that sees no key visits every key tile and gives that row the mean of v
// over the Skv real keys, as attention_ref does.  Key tiles run in order
// and no sum uses atomics, so two calls give the same bits.  Each
// warpgroup waits on its own products (wgmma.wait_group 0), so one
// warpgroup's softmax overlaps only the other's products: a ping-pong
// schedule and the next tile's q·kᵀ under this tile's softmax are later
// work.
#include <cuda.h>

#include <cstdint>

#include "attention.cuh"
#include "common.cuh"
#include "pack16.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int kD = 256;                           // the head dim
constexpr int kBQ = 128, kBK = 64, kStages = 2;   // query rows, keys a tile, ring stages
constexpr int kConsumerThreads = 256;             // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and one producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 of the 65,536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBoxCols = 64;                      // head-dim columns a box: 128 bytes
constexpr int kBoxes = kD / kBoxCols;
constexpr uint32_t kQBox = kBQ * 128, kKVBox = kBK * 128;  // 16 KB, 8 KB
constexpr uint32_t kQBytes = kBoxes * kQBox;               // 64 KB
constexpr uint32_t kTileBytes = kBoxes * kKVBox;           // 32 KB: k or v of a tile
constexpr uint32_t kStageBytes = 2 * kTileBytes;           // k, then v
// 1 KB of alignment slack (the swizzle repeats every 1024 bytes), q, the
// ring, then the barriers: q's full, each stage's k full, v full, empty
constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 3 * kStages);

using Shape = halo::AttnShape;

// s(64 x 64, float32) = q(64 x 16, K-major) @ kᵀ (16 x 64: k's rows K-major),
// both from shared memory; scale_d = 0 overwrites s.
template <typename T> struct WgQK;
template <> struct WgQK<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HALO_WGMMA_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HALO_WGMMA_D32
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct WgQK<__half> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HALO_WGMMA_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HALO_WGMMA_D32
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// o(64 x 256, float32) += p(64 x 16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) @ v(16 x 256, N-major in shared memory: transpose
// bit set).
template <typename T> struct WgPV;
template <> struct WgPV<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HALO_WGMMA_REGS128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : HALO_WGMMA_D128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WgPV<__half> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " HALO_WGMMA_REGS128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : HALO_WGMMA_D128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Keeps the registers of p's A fragments alive until the wgmma that reads
// them has completed.
__device__ __forceinline__ void keep(const uint32_t (&a)[kBK / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBK / 16; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]));
}

// One 3-D box of the tensor map at (c0 innermost, c1, c2) into shared
// memory, completing its bytes on the barrier's transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fa16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, T* __restrict__ O, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + kQBytes;
  const uint32_t bars = ring + kStages * kStageBytes;
  const uint32_t q_full = bars;
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A row that sees no key makes this tile visit every key tile; otherwise
  // only tiles that meet the band of its first to last row, or the prefix.
  // (The barrier also publishes the mbarriers' initialisation.)
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

  if (tid >= kConsumerThreads) {
    // producer warpgroup: it gives up its registers to the consumers, and
    // its first thread loads q, then keeps the ring full with the visited
    // key tiles, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumerThreads) {
      const int q_head = b * s.H + h, kv_head = b * s.Hkv + hk;
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load_3d(q_s + c * kQBox, &map_q, q_full, c * kBoxCols, q0, q_head);
      int i = 0;
      for (int kt = next_tile(0); kt < nk; kt = next_tile(kt + 1), ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty(st), ((i / kStages) + 1) & 1);
        const uint32_t kbuf = ring + st * kStageBytes, vbuf = kbuf + kTileBytes;
        mbar_expect_tx(full_k(st), kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(kbuf + c * kKVBox, &map_k, full_k(st), c * kBoxCols, kt * kBK, kv_head);
        mbar_expect_tx(full_v(st), kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(vbuf + c * kKVBox, &map_v, full_v(st), c * kBoxCols, kt * kBK, kv_head);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in quad
  float acc[kD / 2];  // o: column 8j + 2tq + v of rows g (4j + v) and g + 8 (4j + 2 + v)
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  // rows g and g + 8 of the warp's 16
  float m0 = halo::kMaskedScore, m1 = halo::kMaskedScore, l0 = 0.f, l1 = 0.f;
  const int pos0 = pos_first + warp * 16 + g, pos1 = pos0 + 8;
  const uint32_t q_rows = q_s + wg * 64 * 128;  // the warpgroup's rows in each q box

  mbar_wait(q_full, 0);
  int i = 0;
  for (int kt = next_tile(0); kt < nk; kt = next_tile(kt + 1), ++i) {
    const int st = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const uint32_t kbuf = ring + st * kStageBytes, vbuf = kbuf + kTileBytes;

    // S = q·kᵀ, 64 rows x 64 keys per warpgroup: k-step kk reads box kk / 4
    // of q and k, 32 bytes in per step
    float sc[kBK / 2];
    mbar_wait(full_k(st), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t in_box = (kk & 3) * 32;
      WgQK<T>::run(sc, desc_sw128(q_rows + (kk >> 2) * kQBox + in_box, 16, 1024),
                   desc_sw128(kbuf + (kk >> 2) * kKVBox + in_box, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // scale; mask only where the tile crosses the band's edge, the prefix
    // or Skv
    const int k0 = kt * kBK, k_end = k0 + kBK - 1;
    const bool interior =
        k_end < s.Skv &&
        (k_end < s.prefix || ((!s.causal || k_end <= pos_first) &&
                              (!s.has_window || k0 > pos_last - s.window)));
    float mx0 = HALO_NEG_INF, mx1 = HALO_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
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

    // p = exp(s - m), rounded to the input type: the A fragments of p·v
    // (k-step ks: keys 16ks + 2tq, +1 of rows g and g + 8, then 8 keys on),
    // and what l sums
    uint32_t pa[kBK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float p0 = expf(sc[4 * nt] - mn0), p1 = expf(sc[4 * nt + 1] - mn0);
      float p2 = expf(sc[4 * nt + 2] - mn1), p3 = expf(sc[4 * nt + 3] - mn1);
      pa[nt >> 1][2 * (nt & 1)] = halo::round_pair<T>(p0, p1);
      pa[nt >> 1][2 * (nt & 1) + 1] = halo::round_pair<T>(p2, p3);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }

    // o += p·v: k-step ks reads keys 16ks .. 16ks + 15 of every v box
    mbar_wait(full_v(st), phase);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      WgPV<T>::run(acc, pa[ks], desc_sw128(vbuf + ks * 16 * 128, kKVBox, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    keep(pa);
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

  // l >= 1: the row's largest score contributes exp(0), which rounds to 1
  T* o = O + ((size_t)b * s.H + h) * s.Sq * kD;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = j * 8 + 2 * tq;
    if (r0 < s.Sq) {
      float x = acc[4 * j] / l0, y = acc[4 * j + 1] / l0;
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * kD + col) = halo::round_pair<T>(x, y);
    }
    if (r1 < s.Sq) {
      float x = acc[4 * j + 2] / l1, y = acc[4 * j + 3] / l1;
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * kD + col) = halo::round_pair<T>(x, y);
    }
  }
}

// Tensor map of (heads, rows, 256) row-major 16-bit values in boxes of
// box_rows x 64 columns of one head, 128-byte swizzle, zero fill past rows.
bool make_map_3d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, long long heads,
                 long long rows, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kD) * 2,
                                 static_cast<cuuint64_t>(rows) * kD * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* ws, long long ws_bytes,
           int b, const Shape& s, CUtensorMapDataType type, cudaStream_t stream) {
  // a runtime call first: it also makes the device's context current on
  // this host thread, which cuTensorMapEncodeTiled needs (an agent's
  // worker thread may have made none yet)
  const cudaError_t e = cudaFuncSetAttribute(
      fa16_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long q_elems = (long long)b * s.H * s.Sq * kD;
  const long long kv_elems = (long long)b * s.Hkv * s.Skv * kD;
  const void* ops[3] = {q, k, v};
  const long long elems[3] = {q_elems, kv_elems, kv_elems};
  long long need = 0;
  for (int t = 0; t < 3; ++t)
    if (misaligned(ops[t])) need += elems[t] * 2;
  if (need > ws_bytes || (need > 0 && misaligned(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* next = static_cast<unsigned char*>(ws);
  for (int t = 0; t < 3; ++t) {
    if (!misaligned(ops[t])) continue;
    const int rc = pack16(ops[t], next, static_cast<int>(elems[t] / kD), kD, kD, stream);
    if (rc != 0) return rc;
    ops[t] = next;
    next += elems[t] * 2;
  }
  CUtensorMap map_q, map_k, map_v;
  if (!make_map_3d(&map_q, ops[0], type, (long long)b * s.H, s.Sq, kBQ) ||
      !make_map_3d(&map_k, ops[1], type, (long long)b * s.Hkv, s.Skv, kBK) ||
      !make_map_3d(&map_v, ops[2], type, (long long)b * s.Hkv, s.Skv, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((s.Sq + kBQ - 1) / kBQ), (unsigned)s.H, (unsigned)b);
  fa16_wgmma_kernel<T><<<grid, kThreads, kSmem, stream>>>(map_q, map_k, map_v,
                                                        static_cast<T*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As halo_flash_attention_mma, for bfloat16 (dtype 1) and float16 (2) at
// head dim 256 only.  q, k and v may lie anywhere on the 2-byte grid: each
// that is off the 16-byte grid is first copied, q then k then v, into ws
// (16-byte aligned, ws_bytes at least their bytes); o must lie on the
// 4-byte grid.
extern "C" int halo_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                          void* ws, long long ws_bytes, int b, int h, int hkv,
                                          int sq, int skv, int d, int causal, int has_window,
                                          int window, int prefix, float scale, int dtype,
                                          void* stream) {
  if (d != kD || b <= 0 || hkv <= 0 || h % hkv != 0 || skv <= 0 || sq <= 0 ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 || encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{h, hkv, sq, skv, skv - sq, causal, has_window, window, prefix, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, ws, ws_bytes, b, s,
                                   CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
    case 2:
      return launch<__half>(q, k, v, o, ws, ws_bytes, b, s, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
