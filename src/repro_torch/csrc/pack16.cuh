// The copy of a 16-bit operand that TMA cannot load as it lies (a base off
// the 16-byte grid, or rows whose stride is not a multiple of 16 bytes)
// into an aligned, zero-padded workspace, shared by the wgmma routes of MMM
// (mmm_wgmma.cu) and FLASH_ATTN (flash_attention_wgmma.cu).
#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// The pack pass: src (rows x cols, row-major, 2-byte elements, any
// alignment) into dst (rows x cols_p, 16-byte aligned, cols_p a multiple of
// 8) with zeros in the columns cols .. cols_p - 1.
// Each thread builds 16-byte vectors of dst from 2-byte loads; the bits are
// copied as they are, so one kernel serves bfloat16 and float16.
__global__ void __launch_bounds__(256)
pack16_kernel(const uint16_t* __restrict__ src, uint16_t* __restrict__ dst, int rows,
              int cols, int cols_p) {
  const int vecs = cols_p / 8;
  const size_t total = (size_t)rows * vecs;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < total;
       v += (size_t)gridDim.x * blockDim.x) {
    const int r = static_cast<int>(v / vecs), c0 = static_cast<int>(v % vecs) * 8;
    const uint16_t* row = src + (size_t)r * cols;
    uint4 u;
    uint16_t* e = reinterpret_cast<uint16_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = c0 + j < cols ? row[c0 + j] : uint16_t{0};
    reinterpret_cast<uint4*>(dst)[v] = u;
  }
}

// pack16_kernel of src (rows x cols) into dst (rows x cols_p)
int pack16(const void* src, void* dst, int rows, int cols, int cols_p, cudaStream_t s) {
  const long long vecs = static_cast<long long>(rows) * (cols_p / 8);
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((vecs + 255) / 256, 1 << 16));
  pack16_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint16_t*>(src),
                                       static_cast<uint16_t*>(dst), rows, cols, cols_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
