// Fused element-wise chain: out[i] = the result of a static sequence of
// (op, a, b) steps over k same-shape operands, op one of mul/div/add/sub/
// copy, each operand an input index or the previous step's result ("acc"),
// output in the input type.
//
// Replaces src/repro/kernels/fused.py::_chain_pallas (_chain_kernel), the
// generated Pallas kernel of the graph fusion pass (DESIGN.md §12), which
// applies the whole step sequence per (bm, bn) VPU tile of operands padded
// with ones, keeping intermediates in vector registers.
//
// Bound on the H100: bytes.  Each input is read once and the output written
// once, with a handful of operations per element: a 4-step chain over five
// 8192x8192 float32 inputs moves 1.61 GB, at least 0.481 ms at 3.35 TB/s,
// where four serial EW launches move 3.22 GB.
//
// Design: one grid-stride kernel per (type, input count).
// When every pointer is 16-byte aligned, each thread moves 16-byte vectors
// (4 float32 or 8 bfloat16/float16 values) and a scalar loop takes the
// tail; nothing is padded.  The step table travels by value in a small
// struct (at most 16 inputs and 32 steps).  For each vector a thread loads
// every input the steps read into registers once, then runs the steps; the
// step loop is the same for every thread, so it does not diverge, and an
// operand is picked from the registers by an unrolled select over the input
// count, which keeps the array in registers.  Each step computes in float32
// with the _rn intrinsics, which nvcc never contracts into an fma, and
// rounds to the input type, as one EW launch per step does: the chain is
// bit-identical to the serial EW kernels (and to PyTorch) in every type.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxInputs = 16;
constexpr int kMaxSteps = 32;
constexpr int kAcc = -1;

// The step table, passed by value as a kernel parameter.
struct Chain {
  const void* in[kMaxInputs];
  unsigned used;                // bit j: some step reads input j
  int n_steps;
  signed char op[kMaxSteps];    // 0 mul, 1 div, 2 add, 3 sub, 4 copy
  signed char a[kMaxSteps];     // input index, or kAcc
  signed char b[kMaxSteps];
};

__device__ __forceinline__ float apply(int op, float x, float y) {
  switch (op) {
    case 0: return __fmul_rn(x, y);
    case 1: return __fdiv_rn(x, y);
    case 2: return __fadd_rn(x, y);
    case 3: return __fsub_rn(x, y);
    default: return x;          // copy
  }
}

// v[spec][e] for an input index, acc[e] for kAcc; unrolled over the input
// count so that v stays in registers.
template <int NIN, int W>
__device__ __forceinline__ float pick(const float (&v)[NIN][W], const float (&acc)[W],
                                      int spec, int e) {
  float r = acc[e];
#pragma unroll
  for (int j = 0; j < NIN; ++j) r = spec == j ? v[j][e] : r;
  return r;
}

template <typename T, int NIN, int W>
__device__ __forceinline__ void run_steps(const Chain& c, const float (&v)[NIN][W],
                                          float (&acc)[W]) {
  for (int s = 0; s < c.n_steps; ++s) {
    const int op = c.op[s], sa = c.a[s], sb = c.b[s];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float r = apply(op, pick(v, acc, sa, e), pick(v, acc, sb, e));
      // round to the input type after every step, as a serial launch does
      acc[e] = halo::to_float(halo::from_float<T>(r));
    }
  }
}

template <typename T, int NIN>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const Chain c, T* __restrict__ o, long long n, int vec) {
  constexpr int V = halo::Vec16<T>::kN;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long start = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = tid; i < nv; i += stride) {
      float v[NIN][V];
#pragma unroll
      for (int j = 0; j < NIN; ++j) {
        if (c.used & (1u << j)) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(c.in[j]) + i);
          const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < V; ++e) v[j][e] = halo::to_float(p[e]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[j][e] = 0.f;
        }
      }
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      run_steps<T, NIN, V>(c, v, acc);
      uint4 out;
      T* po = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < V; ++e) po[e] = halo::from_float<T>(acc[e]);
      reinterpret_cast<uint4*>(o)[i] = out;
    }
    start = nv * V;
  }
  for (long long i = start + tid; i < n; i += stride) {
    float v[NIN][1];
#pragma unroll
    for (int j = 0; j < NIN; ++j)
      v[j][0] = (c.used & (1u << j)) ? halo::to_float(static_cast<const T*>(c.in[j])[i])
                                      : 0.f;
    float acc[1] = {0.f};
    run_steps<T, NIN, 1>(c, v, acc);
    o[i] = halo::from_float<T>(acc[0]);
  }
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename T, int NIN>
void launch_n(const Chain& c, void* o, long long n, int vec, cudaStream_t s) {
  const long long work = vec ? n / halo::Vec16<T>::kN + 1 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 16LL * num_sms();  // enough blocks to fill every SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  chain_kernel<T, NIN><<<(unsigned)blocks, kThreads, 0, s>>>(c, static_cast<T*>(o), n, vec);
}

template <typename T>
int launch(const Chain& c, int n_in, void* o, long long n, int vec, cudaStream_t s) {
  switch (n_in) {
#define HALO_CHAIN_CASE(k) case k: launch_n<T, k>(c, o, n, vec, s); break;
    HALO_CHAIN_CASE(1) HALO_CHAIN_CASE(2) HALO_CHAIN_CASE(3) HALO_CHAIN_CASE(4)
    HALO_CHAIN_CASE(5) HALO_CHAIN_CASE(6) HALO_CHAIN_CASE(7) HALO_CHAIN_CASE(8)
    HALO_CHAIN_CASE(9) HALO_CHAIN_CASE(10) HALO_CHAIN_CASE(11) HALO_CHAIN_CASE(12)
    HALO_CHAIN_CASE(13) HALO_CHAIN_CASE(14) HALO_CHAIN_CASE(15) HALO_CHAIN_CASE(16)
#undef HALO_CHAIN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// inputs: n_in device pointers (host array).  steps: n_steps triples
// (op, a, b) (host array); op 0 mul, 1 div, 2 add, 3 sub, 4 copy; a and b
// an input index or -1 for the previous step's result; copy ignores b.
// vec: every pointer 16-byte aligned.
extern "C" int halo_fused(const void* const* inputs, int n_in, const int* steps,
                          int n_steps, void* o, long long n, int dtype, int vec,
                          void* stream) {
  if (n_in < 1 || n_in > kMaxInputs || n_steps < 1 || n_steps > kMaxSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  Chain c = {};
  for (int j = 0; j < n_in; ++j) c.in[j] = inputs[j];
  c.n_steps = n_steps;
  for (int s = 0; s < n_steps; ++s) {
    const int op = steps[3 * s], a = steps[3 * s + 1];
    const int b = op == 4 ? kAcc : steps[3 * s + 2];
    const bool bad_a = a < kAcc || a >= n_in || (s == 0 && a == kAcc);
    const bool bad_b = b < kAcc || b >= n_in || (s == 0 && b == kAcc && op != 4);
    if (op < 0 || op > 4 || bad_a || bad_b) return static_cast<int>(cudaErrorInvalidValue);
    c.op[s] = static_cast<signed char>(op);
    c.a[s] = static_cast<signed char>(a);
    c.b[s] = static_cast<signed char>(b);
    if (a >= 0) c.used |= 1u << a;
    if (b >= 0) c.used |= 1u << b;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HALO_DISPATCH_TYPE(dtype, T, return launch<T>(c, n_in, o, n, vec, s))
  return static_cast<int>(cudaErrorInvalidValue);
}
