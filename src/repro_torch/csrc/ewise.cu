// EWMM / EWMD / EWADD / EWSUB: out[i] = a[i] (*, /, +, -) b[i] over n
// elements, output in the input type.
//
// Replaces src/repro/kernels/ewise/ewise.py::ewise_pallas (_ewise_kernel),
// which streams (bm, bn) VPU tiles of padded 2-D operands through VMEM.
//
// Bound on the H100: bytes.  Each element is read twice and written once
// with one operation, so at 8192x8192 float32 the 805 MB move in at least
// 0.24 ms at 3.35 TB/s.
//
// Design: the stream is held by the bytes each thread keeps in flight.
// Under a launch plan (ewise_plan in kernels/ewise/ewise.py, a pure
// function of n, the type, the alignment and the SM count) the operands are
// items, 16-byte vectors (4 float32 or 8 bfloat16/float16 values) when all
// three pointers are 16-byte aligned and single elements when not, and
// each block covers one contiguous chunk of U items a thread, once: thread
// t of block g takes items g*U*256 + u*256 + t, u = 0..U-1, so every load
// instruction of a warp reads 512 consecutive bytes.  A thread issues all
// U loads of a and U of b before any arithmetic (U = 4: 128 bytes of
// vectors in flight a thread), then computes and stores.  Loads and stores
// carry the streaming hints (ld.global.cs, st.global.cs): each byte is read
// once and written once, so none is kept in L1 or L2 for reuse.  The n
// mod 8 (or 4) elements past the last whole vector are the last block's.
// Arithmetic is in float32 with one rounding back to the input type,
// exactly as PyTorch computes a*b, a/b, a+b and a-b, so the results are
// bit-identical to PyTorch's.  The library is built without
// --use_fast_math, so the division is IEEE.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int OP>
__device__ __forceinline__ float apply(float x, float y) {
  if constexpr (OP == 0) return x * y;
  else if constexpr (OP == 1) return x / y;
  else if constexpr (OP == 2) return x + y;
  else return x - y;
}

template <typename T, int OP>
__device__ __forceinline__ T apply_t(T x, T y) {
  return halo::from_float<T>(apply<OP>(halo::to_float(x), halo::to_float(y)));
}

// 16-byte vectors: nv = n / V of them, then the n - nv*V elements of the
// tail, taken by the last block.
template <typename T, int OP, int U>
__global__ void __launch_bounds__(kThreads)
ewise_vec_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o,
                 long long n) {
  constexpr int V = halo::Vec16<T>::kN;
  const long long nv = n / V;
  const long long first = static_cast<long long>(blockIdx.x) * U * kThreads + threadIdx.x;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* ov = reinterpret_cast<uint4*>(o);
  uint4 ra[U], rb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = first + u * kThreads;
    if (i < nv) {
      ra[u] = __ldcs(av + i);
      rb[u] = __ldcs(bv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = first + u * kThreads;
    if (i < nv) {
      uint4 ro;
      const T* pa = reinterpret_cast<const T*>(&ra[u]);
      const T* pb = reinterpret_cast<const T*>(&rb[u]);
      T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int j = 0; j < V; ++j) po[j] = apply_t<T, OP>(pa[j], pb[j]);
      __stcs(ov + i, ro);
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long i = nv * V + threadIdx.x;
    if (i < n) o[i] = apply_t<T, OP>(a[i], b[i]);
  }
}

// Single elements (a pointer off the 16-byte grid): U a thread, loads
// first.
template <typename T, int OP, int U>
__global__ void __launch_bounds__(kThreads)
ewise_scalar_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o,
                    long long n) {
  const long long first = static_cast<long long>(blockIdx.x) * U * kThreads + threadIdx.x;
  T ra[U], rb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = first + u * kThreads;
    if (i < n) {
      ra[u] = a[i];
      rb[u] = b[i];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = first + u * kThreads;
    if (i < n) o[i] = apply_t<T, OP>(ra[u], rb[u]);
  }
}

template <typename T, int OP, int U>
int launch_u(const T* a, const T* b, T* o, long long n, int vec, long long blocks,
             cudaStream_t s) {
  if (vec)
    ewise_vec_kernel<T, OP, U><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, b, o, n);
  else
    ewise_scalar_kernel<T, OP, U><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a, b, o, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP>
int launch_op(const T* a, const T* b, T* o, long long n, int vec, int items,
              long long blocks, cudaStream_t s) {
  switch (items) {
    case 1: return launch_u<T, OP, 1>(a, b, o, n, vec, blocks, s);
    case 4: return launch_u<T, OP, 4>(a, b, o, n, vec, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* o, long long n, int op, int vec, int items,
           long long blocks, cudaStream_t s) {
  // the plan covers every item with no block past them (one block at least,
  // for a tail shorter than a vector)
  const long long per_block = static_cast<long long>(items) * kThreads;
  const long long n_items = vec ? n / halo::Vec16<T>::kN : n;
  const long long need = (n_items + per_block - 1) / per_block;
  if (blocks != (need > 1 ? need : 1) || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(o);
  switch (op) {
    case 0: return launch_op<T, 0>(pa, pb, po, n, vec, items, blocks, s);
    case 1: return launch_op<T, 1>(pa, pb, po, n, vec, items, blocks, s);
    case 2: return launch_op<T, 2>(pa, pb, po, n, vec, items, blocks, s);
    case 3: return launch_op<T, 3>(pa, pb, po, n, vec, items, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// op: 0 mul, 1 div, 2 add, 3 sub.  vec: all pointers 16-byte aligned.
// items_per_thread (1 or 4) and blocks: the plan of
// kernels/ewise/ewise.py::ewise_plan, blocks of 256 threads that cover the
// n / V vectors (vec) or n elements, and no block past them.
extern "C" int halo_ewise(const void* a, const void* b, void* o, long long n, int op,
                          int dtype, int vec, int items_per_thread, long long blocks,
                          void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T,
                     return launch<T>(a, b, o, n, op, vec, items_per_thread, blocks, s))
  return static_cast<int>(cudaErrorInvalidValue);
}
