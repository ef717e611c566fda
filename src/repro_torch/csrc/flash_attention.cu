// FLASH_ATTN: online-softmax GQA attention.  q (B,H,Sq,D), k/v (B,Hkv,Skv,D)
// -> o (B,H,Sq,D), row-major and contiguous, float32 inside, o in the input
// type (float32, bfloat16 or float16).  Query row i sits at position
// q_offset + i, q_offset = Skv - Sq; key j is visible to it when
//   (!causal || j <= pos || j < prefix) && (!window || j > pos - window || j < prefix),
// and a masked score is the finite -1e30, as in the reference.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_fa_kernel), whose grid (B, H, Sq/bq, Skv/bk)
// runs the KV axis in order on the TPU and carries m, l and the f32
// accumulator in VMEM scratch from one KV step to the next, on keys
// zero-padded to the block.
//
// Bound on the H100: operations.  At (1,32,4200,80) with Hkv 8, causal and
// a 4096 window, the 2.8e8 visible (q, k) pairs need 4*D operations each,
// 90 GFLOP, or 0.091 ms at the 989 TFLOP/s of the bfloat16 tensor cores,
// against 54 MB of q, k, v and o (0.016 ms at 3.35 TB/s).
//
// Design (simple first, CUDA cores; the route of bfloat16 and float16 at
// head dim 256 — float32 takes flash_attention_tf32x3.cu, bfloat16 and
// float16 up to head dim 128 flash_attention_mma.cu, see
// kernels/flash_attention/flash_attention.py::fa_route; the kernel still
// takes every type, which the card checks use to hold it beside them): one
// 256-thread block per (b, h, 64 query rows); the KV head is h / (H / Hkv).  The block stages the query
// tile (scaled by D^-1/2) and each 64-key tile of k transposed and of v in
// shared memory as float32.  Each thread owns a 4x4 block of the 64x64
// score tile (rows 4*ty.., keys 4*tx..), read with 16-byte shared loads;
// row maxima and sums are reduced over the 16 threads of a row group by
// warp shuffles, so m and l live in registers.  p goes to shared memory and
// the same thread accumulates rows 4*ty.. of o over columns tx + 16c.  The
// KV loop is the TPU grid's sequential axis.  Tiles wholly outside the
// causal/window band (and the prefix) are skipped.  Nothing is padded:
// keys past Skv take no part at all (p = 0), so a query row that sees no
// key gets the mean of v over the Skv real keys, as attention_ref does;
// such a row exists only when Sq > Skv, and a tile holding one visits every
// key tile.  Head dims 32, 64, 80, 96, 128 and 256 are instantiated.
#include "attention.cuh"
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kPad = 4;  // keeps rows 16-byte aligned for float4 reads
constexpr int kLQ = kBQ + kPad, kLK = kBK + kPad;
constexpr float kMasked = halo::kMaskedScore;
using Shape = halo::AttnShape;
using halo::band_hi;
using halo::band_lo;
using halo::visible;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * kLQ + D * kLK + kBK * D + kBK * kLQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
          T* __restrict__ O, Shape s) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kC = D / 16;  // o columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kLQ]
  float* Kt = Qt + D * kLQ;                     // [D][kLK]
  float* Vs = Kt + D * kLK;                     // [kBK][D]
  float* Pt = Vs + kBK * D;                     // [kBK][kLQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const T* q = Q + ((size_t)b * s.H + h) * s.Sq * D;
  const T* k = K + ((size_t)b * s.Hkv + hk) * s.Skv * D;
  const T* v = V + ((size_t)b * s.Hkv + hk) * s.Skv * D;
  T* o = O + ((size_t)b * s.H + h) * s.Sq * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    Qt[d * kLQ + i] = q0 + i < s.Sq ? halo::to_float(q[(size_t)(q0 + i) * D + d]) * s.scale
                                    : 0.f;
  }

  // A row that sees no key makes this tile visit every key tile; otherwise
  // only tiles that meet the band of its first to last row, or the prefix.
  const int row_end = min(q0 + kBQ, s.Sq);
  bool blind = false;
  if (tid < kBQ && q0 + tid < s.Sq) {
    const int pos = s.q_offset + q0 + tid;
    blind = s.prefix == 0 && band_lo(s, pos) > band_hi(s, pos);
  }
  const bool any_blind = __syncthreads_or(blind);
  const int lo = band_lo(s, s.q_offset + q0), hi = band_hi(s, s.q_offset + row_end - 1);

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kMasked;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.f;
  }

  const int nk = (s.Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    const int k_last = min(k0 + kBK, s.Skv) - 1;
    if (!any_blind && k0 >= s.prefix && (k_last < lo || k0 > hi)) continue;  // uniform
    __syncthreads();  // the previous tile's Kt, Vs and Pt are read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool in = k0 + j < s.Skv;
      const size_t g = (size_t)(k0 + j) * D + d;
      Kt[d * kLK + j] = in ? halo::to_float(k[g]) : 0.f;
      Vs[j * D + d] = in ? halo::to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLQ + 4 * ty]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * kLK + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qv[a], kv[c], sc[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int pos = s.q_offset + q0 + 4 * ty + a;
      float mx = __int_as_float(0xff800000);  // -inf; over keys below Skv only
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + 4 * tx + c;
        if (!visible(s, pos, j)) sc[a][c] = kMasked;
        if (j < s.Skv) mx = fmaxf(mx, sc[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = k0 + 4 * tx + c < s.Skv ? expf(sc[a][c] - m_new) : 0.f;
        Pt[(4 * tx + c) * kLQ + 4 * ty + a] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[j * kLQ + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
  }

  // l >= 1: the row's largest score contributes exp(0)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    if (row >= s.Sq) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      o[(size_t)row * D + tx + 16 * c] = halo::from_float<T>(acc[a][c] / l[a]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, const Shape& s,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)((s.Sq + kBQ - 1) / kBQ), (unsigned)s.H, (unsigned)b);
  fa_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int d,
             const Shape& s, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, s, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, s, stream);
    case 80: return launch<T, 80>(q, k, v, o, b, s, stream);
    case 96: return launch<T, 96>(q, k, v, o, b, s, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// has_window: window is set (a window <= 0 then masks every key but the
// prefix); scale multiplies q before the dot products.
extern "C" int halo_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int b, int h, int hkv, int sq, int skv, int d,
                                    int causal, int has_window, int window, int prefix,
                                    float scale, int dtype, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{h, hkv, sq, skv, skv - sq, causal, has_window, window, prefix, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T, return launch_d<T>(q, k, v, o, b, d, s, st))
  return 0;
}
