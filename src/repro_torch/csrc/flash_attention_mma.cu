// FLASH_ATTN on the tensor cores: online-softmax GQA attention for bfloat16
// and float16.  q (B,H,Sq,D), k/v (B,Hkv,Skv,D) -> o (B,H,Sq,D), row-major
// and contiguous, head dims 32, 64, 80, 96 and 128; float32 sums, o in the
// input type.  The masks, positions and the masked score -1e30 are those of
// attention.cuh, as in the other two FLASH_ATTN routes
// (flash_attention_wgmma.cu for bfloat16 and float16 at head dim 256,
// flash_attention_tf32x3.cu for float32).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_fa_kernel), whose grid (B, H, Sq/bq, Skv/bk)
// runs the KV axis in order on the TPU and carries m, l and the f32
// accumulator in VMEM scratch from one KV step to the next; its two
// products go to the MXU in the input type with float32 accumulation.
//
// Bound on the H100: operations.  At (1,32,4200,80) with Hkv 8, causal and
// a 4096 window, the 2.8e8 visible (q, k) pairs need 4*D operations each,
// 90 GFLOP, or 0.091 ms at the 989 TFLOP/s of the bfloat16 tensor cores,
// against 54 MB of q, k, v and o (0.016 ms at 3.35 TB/s).  So the two
// products must run on the tensor cores, and the softmax between them must
// not leave the registers.
//
// Design (the FlashAttention-2 layout): one 256-thread block per
// (b, h, 128 query rows), each of its 8 warps owning 16 query rows; the KV
// head is h / (H / Hkv).  K and V tiles reach the SMs from L2 (all of
// danube's K/V, 11 MB, stays there), so the L2 traffic per query row is
// what a larger query tile cuts: 128 rows per block read half the tiles
// 64 rows would, and the block is capped at 128 registers a thread for two
// blocks per SM at D <= 96 (a few hundred bytes of spills; D = 128 keeps
// one block per SM).  Query tiles run heaviest first (the last tile of a
// causal head sees the most keys), so the causal tail is the light tiles.  q·kᵀ is mma.sync.m16n8k16 with float32 accumulators: the warp's
// q rows stay in registers as A fragments (ldmatrix, once), each 64-key
// tile of k is the B operand (ldmatrix), D/16 k-steps by 8 n-tiles of 8
// keys.  Scores are scaled by D^-1/2 in float32; masks are applied per
// element only on tiles that cross the band's edge, the prefix or Skv.
// Row maxima and sums reduce over the 4 threads of a quad by shuffles;
// o is rescaled by exp(m_old - m_new) per key tile.  p is rounded to the
// input type in registers, and the rounded p is both the A operand of p·v
// (the C fragment of q·kᵀ is the A fragment of p·v, so p never goes
// through shared memory) and what l sums, so o / l is a weighted mean of
// v with the weights the product used.  v is the B operand through
// ldmatrix.trans, D/8 n-tiles by 4 k-steps.  K and V tiles are staged in
// the input type in a two-stage ring filled by cp.async: the next visited
// tile's copy is issued before this tile's math.  Shared rows are D + 8
// elements (16 bytes of padding), so the 8 rows an ldmatrix reads start on
// 8 distinct 4-bank groups at every D (a 160-byte row at D = 80 becomes
// 176 bytes, 44 words: rows start at banks 0, 12, 24, 4, 16, 28, 8, 20).
// Tiles wholly outside the causal/window band (and the prefix) are
// skipped.  Keys past Skv are zero-filled in shared memory and take no
// part (score -inf, p = 0); a query row that sees no key gets the mean of
// v over the Skv real keys, as attention_ref does, and a tile holding one
// visits every key tile.  Operands off the 16-byte grid are staged by
// plain loads instead of cp.async.
#include <cstdint>

#include "attention.cuh"
#include "common.cuh"

namespace {

constexpr int kBQ = 128, kBK = 64, kWarps = 8, kThreads = 32 * kWarps;
constexpr int kPadE = 8;  // elements of padding per shared row (16 bytes)

using Shape = halo::AttnShape;

template <int D>
struct Geom {
  static constexpr int kLd = D + kPadE;  // elements per shared row
  static constexpr size_t kSmem = sizeof(uint16_t) * (size_t)kLd * (kBQ + 4 * kBK);
};

template <typename T> struct MmaOp;
template <> struct MmaOp<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct MmaOp<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from global to shared, asynchronously; zeros when !valid (the
// source address is then not read, but must still be a valid one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows r0 .. r0 + kRows - 1 of the (limit, D) row-major g into shared
// memory (row stride kLd); rows at or past limit read as zeros.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_rows(T* sm, const T* g, int r0, int limit, bool vec) {
  constexpr int kLd = Geom<D>::kLd, kChunks = D / 8;  // 16-byte chunks per row
  if (vec) {
    for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = c % kChunks;
      const bool ok = r0 + r < limit;
      cp_async16(sm + r * kLd + cc * 8, g + (size_t)(ok ? r0 + r : 0) * D + cc * 8, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      sm[r * kLd + d] = r0 + r < limit ? g[(size_t)(r0 + r) * D + d] : halo::from_float<T>(0.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 96 ? 2 : 1)
fa_mma_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
              T* __restrict__ O, Shape s, int vec) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16, at most 128");
  constexpr int kLd = Geom<D>::kLd;
  constexpr int kKSteps = D / 16;  // q·kᵀ k-steps
  constexpr int kNT = kBK / 8;     // q·kᵀ n-tiles (keys)
  constexpr int kDT = D / 8;       // p·v n-tiles (head dim)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kBQ][kLd]
  T* Ks = Qs + kBQ * kLd;                  // [2][kBK][kLd]
  T* Vs = Ks + 2 * kBK * kLd;              // [2][kBK][kLd]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in quad
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const T* q = Q + ((size_t)b * s.H + h) * s.Sq * D;
  const T* k = K + ((size_t)b * s.Hkv + hk) * s.Skv * D;
  const T* v = V + ((size_t)b * s.Hkv + hk) * s.Skv * D;
  T* o = O + ((size_t)b * s.H + h) * s.Sq * D;

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
  const int lo = halo::band_lo(s, pos_first), hi = halo::band_hi(s, pos_last);
  const int nk = (s.Skv + kBK - 1) / kBK;
  auto next_tile = [&](int kt) {
    for (; kt < nk; ++kt) {
      const int k0 = kt * kBK, k_last = min(k0 + kBK, s.Skv) - 1;
      if (any_blind || k0 < s.prefix || !(k_last < lo || k0 > hi)) break;
    }
    return kt;
  };

  const bool vec16 = vec != 0;
  load_rows<T, D, kBQ>(Qs, q, q0, s.Sq, vec16);
  int kt = next_tile(0);  // < nk: a tile with no blind row sees some key
  load_rows<T, D, kBK>(Ks, k, kt * kBK, s.Skv, vec16);
  load_rows<T, D, kBK>(Vs, v, kt * kBK, s.Skv, vec16);
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows g and g + 8 of the warp's 16
  float m0 = halo::kMaskedScore, m1 = halo::kMaskedScore, l0 = 0.f, l1 = 0.f;
  const int pos0 = pos_first + warp * 16 + g, pos1 = pos0 + 8;
  int stage = 0;
  bool first = true;

  while (kt < nk) {
    const int next = next_tile(kt + 1);
    if (next < nk) {  // the next visited tile's copy overlaps this tile's math
      load_rows<T, D, kBK>(Ks + (stage ^ 1) * kBK * kLd, k, next * kBK, s.Skv, vec16);
      load_rows<T, D, kBK>(Vs + (stage ^ 1) * kBK * kLd, v, next * kBK, s.Skv, vec16);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                                kk * 16 + (lane >> 4) * 8);
      first = false;
    }
    const T* Kt = Ks + stage * kBK * kLd;
    const T* Vt = Vs + stage * kBK * kLd;

    // S = q·kᵀ, 16 rows x 64 keys per warp
    float sc[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        MmaOp<T>::run(sc[2 * np], qf[kk], bf[0], bf[1]);
        MmaOp<T>::run(sc[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

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
        float x = sc[nt][e] * s.scale;
        if (!interior) {
          const int j = k0 + nt * 8 + 2 * tq + (e & 1);
          if (j >= s.Skv)
            x = HALO_NEG_INF;
          else if (!halo::visible(s, e < 2 ? pos0 : pos1, j))
            x = halo::kMaskedScore;
        }
        sc[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: m starts at -1e30

    // p = exp(s - m), rounded to the input type: the A operand of p·v, and
    // what l sums
    uint32_t pf[kNT][2];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float p0 = expf(sc[nt][0] - mn0), p1 = expf(sc[nt][1] - mn0);
      float p2 = expf(sc[nt][2] - mn1), p3 = expf(sc[nt][3] - mn1);
      pf[nt][0] = halo::round_pair<T>(p0, p1);
      pf[nt][1] = halo::round_pair<T>(p2, p3);
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
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    // o += p·v: k-steps of 16 keys, n-tiles of 8 head-dim columns
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint32_t pa[4] = {pf[2 * ks][0], pf[2 * ks][1], pf[2 * ks + 1][0],
                              pf[2 * ks + 1][1]};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Vt + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                                  dp * 16 + (lane >> 4) * 8);
        MmaOp<T>::run(acc[2 * dp], pa, bf[0], bf[1]);
        MmaOp<T>::run(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
    stage ^= 1;
    kt = next;
  }

  // l >= 1: the row's largest score contributes exp(0), which rounds to 1
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * tq;
    if (r0 < s.Sq) {
      float x = acc[dt][0] * inv0, y = acc[dt][1] * inv0;
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + col) = halo::round_pair<T>(x, y);
    }
    if (r1 < s.Sq) {
      float x = acc[dt][2] * inv1, y = acc[dt][3] * inv1;
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + col) = halo::round_pair<T>(x, y);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, const Shape& s,
           int vec, cudaStream_t stream) {
  constexpr size_t smem = Geom<D>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      fa_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)((s.Sq + kBQ - 1) / kBQ), (unsigned)s.H, (unsigned)b);
  fa_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int d,
             const Shape& s, int vec, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, s, vec, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, s, vec, stream);
    case 80: return launch<T, 80>(q, k, v, o, b, s, vec, stream);
    case 96: return launch<T, 96>(q, k, v, o, b, s, vec, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Attention of q (b, h, sq, d) over k, v (b, hkv, skv, d) into o, row-major
// and contiguous; query i at position skv - sq + i, the masks of
// attention.cuh, scores scaled by `scale`.  bfloat16 (dtype 1) and float16
// (2) at head dims 32 to 128 only; vec: q, k and v start on the 16-byte grid
// (cp.async staging), else plain loads.  o must lie on the 4-byte grid.
extern "C" int halo_flash_attention_mma(const void* q, const void* k, const void* v, void* o,
                                        int b, int h, int hkv, int sq, int skv, int d,
                                        int causal, int has_window, int window, int prefix,
                                        float scale, int dtype, int vec, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || skv <= 0 || sq <= 0 ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{h, hkv, sq, skv, skv - sq, causal, has_window, window, prefix, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, b, d, s, vec, st);
    case 2: return launch_d<__half>(q, k, v, o, b, d, s, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
