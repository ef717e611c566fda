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
// Design: one grid-stride kernel per (type, op).  When all three pointers
// are 16-byte aligned, each thread moves 16-byte vectors (4 float32 or 8
// bfloat16/float16 values) and a scalar loop takes the tail; the ragged
// edge needs no padding.  Arithmetic is in float32 with one rounding back
// to the input type, exactly as PyTorch computes a*b, a/b, a+b and a-b,
// so the results are bit-identical to PyTorch's.  The library is built
// without --use_fast_math, so the division is IEEE.
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

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
ewise_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o,
             long long n, int vec) {
  constexpr int V = halo::Vec16<T>::kN;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long start = 0;
  if (vec) {
    const long long nv = n / V;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    uint4* ov = reinterpret_cast<uint4*>(o);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 ra = av[i], rb = bv[i];
      uint4 ro;
      const T* pa = reinterpret_cast<const T*>(&ra);
      const T* pb = reinterpret_cast<const T*>(&rb);
      T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int j = 0; j < V; ++j) po[j] = apply_t<T, OP>(pa[j], pb[j]);
      ov[i] = ro;
    }
    start = nv * V;
  }
  for (long long i = start + tid; i < n; i += stride) o[i] = apply_t<T, OP>(a[i], b[i]);
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename T>
int launch(const void* a, const void* b, void* o, long long n, int op, int vec,
           cudaStream_t s) {
  const long long work = vec ? n / halo::Vec16<T>::kN + 1 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 16LL * num_sms();  // enough blocks to fill every SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(o);
  switch (op) {
    case 0: ewise_kernel<T, 0><<<(unsigned)blocks, kThreads, 0, s>>>(pa, pb, po, n, vec); break;
    case 1: ewise_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(pa, pb, po, n, vec); break;
    case 2: ewise_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, s>>>(pa, pb, po, n, vec); break;
    case 3: ewise_kernel<T, 3><<<(unsigned)blocks, kThreads, 0, s>>>(pa, pb, po, n, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 mul, 1 div, 2 add, 3 sub.  vec: all pointers 16-byte aligned.
extern "C" int halo_ewise(const void* a, const void* b, void* o, long long n, int op,
                          int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T, return launch<T>(a, b, o, n, op, vec, s))
  return static_cast<int>(cudaErrorInvalidValue);
}
