// Masks shared by the three FLASH_ATTN kernels (flash_attention_mma.cu and
// flash_attention_wgmma.cu for bfloat16 and float16, flash_attention_tf32x3.cu
// for float32).
//
// Query row i sits at position q_offset + i, q_offset = Skv - Sq; key j is
// visible to the query at position pos when
//   (!causal || j <= pos || j < prefix) && (!window || j > pos - window || j < prefix),
// and a masked score is the finite -1e30, as in the reference.
#pragma once

// -inf, the start of a running row max and the score of a key past Skv
#define HALO_NEG_INF __int_as_float(0xff800000)

namespace halo {

constexpr float kMaskedScore = -1e30f;

struct AttnShape {
  int H, Hkv, Sq, Skv, q_offset;
  int causal, has_window, window, prefix;
  float scale;
};

// The interval [lo, hi] of keys the causal and window masks leave visible
// to the query at position pos (the prefix [0, prefix) aside).
__device__ __forceinline__ int band_lo(const AttnShape& s, int pos) {
  return s.has_window ? max(0, pos - s.window + 1) : 0;
}
__device__ __forceinline__ int band_hi(const AttnShape& s, int pos) {
  return s.causal ? min(pos, s.Skv - 1) : s.Skv - 1;
}
__device__ __forceinline__ bool visible(const AttnShape& s, int pos, int j) {
  const bool pre = j < s.prefix;
  return (!s.causal || j <= pos || pre) && (!s.has_window || j > pos - s.window || pre);
}

}  // namespace halo
