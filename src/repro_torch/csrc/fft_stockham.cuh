// Complex arithmetic and the radix-4/2 Stockham stage shared by the FFT
// kernels (fft_radix.cu, fft_chirp.cu).
//
// One stage of a self-sorting FFT in place in shared memory: with p the
// length of the sub-transforms done so far, stage R reads u_r = buf[i +
// r*len/R] for each of its len/R butterflies i, multiplies u_r by
// w_len^(r*k*len/(R*p)) with k = i mod p, takes the R-point DFT and writes
// it to buf[(i - k)*R + k + r*p].  Each thread keeps its butterflies'
// values in registers between a read and a write phase, so one buffer
// suffices.
#pragma once

#include <cuda_runtime.h>

namespace halo {

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// One radix-R stage over a row of len values at buf, by the row's tpr
// threads (this one is t), len/R >= tpr and at most Q butterflies each.
// The twiddle table holds nt values, nt a multiple of len: the stage's
// twiddle w_len^(r*k*len/(R*p)) is entry r*k*nt/(R*p).
template <int R, int Q = 4>
__device__ __forceinline__ void stage(float2* buf, const float2* __restrict__ tw, int len,
                                      int nt, int t, int tpr, int p) {
  const int nb = len / R;
  const int nq = nb / tpr;
  const int step = nt / (R * p);
  float2 u[Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q < nq) {
      const int i = t + q * tpr;
#pragma unroll
      for (int r = 0; r < R; ++r) u[q][r] = buf[i + r * nb];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q < nq) {
      const int i = t + q * tpr;
      const int k = i & (p - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) u[q][r] = cmul(u[q][r], __ldg(tw + r * k * step));
      const int j = (i - k) * R + k;
      if constexpr (R == 2) {
        buf[j] = cadd(u[q][0], u[q][1]);
        buf[j + p] = csub(u[q][0], u[q][1]);
      } else {
        const float2 a0 = cadd(u[q][0], u[q][2]), a1 = csub(u[q][0], u[q][2]);
        const float2 a2 = cadd(u[q][1], u[q][3]), a3 = csub(u[q][1], u[q][3]);
        // -i * a3 = (a3.y, -a3.x)
        buf[j] = cadd(a0, a2);
        buf[j + p] = make_float2(a1.x + a3.y, a1.y - a3.x);
        buf[j + 2 * p] = csub(a0, a2);
        buf[j + 3 * p] = make_float2(a1.x - a3.y, a1.y + a3.x);
      }
    }
  }
  __syncthreads();
}

// The len-point FFT of a row at buf (len = 2^log2len) by its tpr threads:
// a radix-2 stage first when log2len is odd, then radix-4 stages.  Q2 and
// Q4 cap the butterflies per thread of each kind of stage.
template <int Q2, int Q4>
__device__ __forceinline__ void stockham(float2* buf, const float2* __restrict__ tw, int len,
                                         int log2len, int nt, int t, int tpr) {
  int p = 1;
  if (log2len & 1) {
    stage<2, Q2>(buf, tw, len, nt, t, tpr, p);
    p = 2;
  }
  for (; p < len; p *= 4) stage<4, Q4>(buf, tw, len, nt, t, tpr, p);
}

}  // namespace halo
