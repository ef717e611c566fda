// EMBED_GRAD: the gradient of an embedding lookup out = table[tokens],
//   grad(v, :) = sum over positions i with tokens(i) == v of g(i, :),
// for a (V, D) table, N positions and g (N, D), in a fixed order and in
// float32, the result rounded once to the table's type.
//
// Replaces no Pallas kernel.  The reference's lookup is jnp.take
// (src/repro/models/layers.py:68), whose VJP is an XLA scatter-add: it adds
// in a fixed order on the TPU and on the CPU.  PyTorch's backward of
// table[tokens] adds the rows of a repeated token with atomics on the
// card, in no fixed order, so two calls differ in the last bits.  This
// kernel gives the card a backward whose bits do not depend on timing.
//
// The order: positions are sorted by token with a stable sort (so each
// token's positions stay in position order) and the sorted list is cut
// into chunks of kChunk entries at fixed offsets 0, kChunk, 2 kChunk, ...
// A piece is the part of one token's run inside one chunk.  Each piece is
// summed in sorted order from 0.0f; each token's result is 0.0f plus its
// pieces in order.  The order depends only on the tokens, and the plain
// version (kernels/embed_grad/ref.py::embed_grad_ref) adds in it, with the
// same float32 roundings, so the two agree to the bit.
//
// Bound on the H100: bytes.  g is read once (N D) and the whole table's
// gradient written once (V D), a zero row for a token that does not occur:
// at danube's 2048 x 2560 bfloat16 g and 32000 x 2560 table, 174 MB, at
// least 0.052 ms at 3.35 TB/s.
//
// Design: a long run (Zipf-distributed tokens repeat one token hundreds of
// times in a batch) must not serialise one block, so the first kernel gives
// each (chunk, 256-column tile) its own block: it stages the chunk's kChunk
// (token, row) pairs in shared memory, issues the chunk's kChunk loads of g
// at once, then adds them in order, writing each piece's float32 sum to the
// workspace row of the piece's first sorted entry.  The second kernel gives
// each table row one block, which adds that token's pieces (at most
// run / kChunk + 2) and writes the row, zeros included, in the table's
// type.  No atomics: every workspace and output element has one writer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;                 // sorted entries per chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_grad_chunks_kernel(const T* __restrict__ g, const int* __restrict__ perm,
                         const int* __restrict__ sorted_tok, float* __restrict__ partial,
                         int n, int d) {
  __shared__ int s_tok[kChunk];
  __shared__ int s_row[kChunk];
  const int c0 = blockIdx.x * kChunk;
  const int len = n - c0 < kChunk ? n - c0 : kChunk;
  if (threadIdx.x < kChunk) {
    const bool in = static_cast<int>(threadIdx.x) < len;
    s_tok[threadIdx.x] = in ? sorted_tok[c0 + threadIdx.x] : -1;
    s_row[threadIdx.x] = in ? perm[c0 + threadIdx.x] : 0;
  }
  __syncthreads();
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= d) return;
  float vals[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    vals[k] = k < len ? halo::to_float(g[static_cast<long long>(s_row[k]) * d + col]) : 0.f;
  float acc = 0.f;
  int start = c0;
  int tok = s_tok[0];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k < len) {
      if (s_tok[k] != tok) {               // a new token's run begins
        partial[static_cast<long long>(start) * d + col] = acc;
        acc = 0.f;
        start = c0 + k;
        tok = s_tok[k];
      }
      acc = __fadd_rn(acc, vals[k]);
    }
  }
  partial[static_cast<long long>(start) * d + col] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embed_grad_rows_kernel(const float* __restrict__ partial, const int* __restrict__ bounds,
                       T* __restrict__ out, int d) {
  const int v = blockIdx.x;
  const int s = bounds[v];
  const int e = bounds[v + 1];
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float acc = 0.f;
    for (int p = s; p < e;) {              // the run's pieces, in order
      acc = __fadd_rn(acc, partial[static_cast<long long>(p) * d + col]);
      const int next = (p / kChunk + 1) * kChunk;
      p = next < e ? next : e;
    }
    out[static_cast<long long>(v) * d + col] = halo::from_float<T>(acc);
  }
}

}  // namespace

// g (n, d) in the table's type; perm (n) the positions in stable token
// order, sorted_tok (n) their tokens, bounds (v + 1) each token's first
// sorted entry (bounds[v] = n), all int32; partial an (n, d) float32
// workspace; out (v, d) in g's type.  n >= 0, d >= 1, v >= 1.
extern "C" int halo_embed_grad(const void* g, const void* perm, const void* sorted_tok,
                               const void* bounds, void* partial, void* out, int n, int d,
                               int v, int dtype, void* stream) {
  if (n < 0 || d < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 chunks((n + kChunk - 1) / kChunk, (d + kThreads - 1) / kThreads);
  HALO_DISPATCH_TYPE(dtype, T, {
    if (n > 0)
      embed_grad_chunks_kernel<T><<<chunks, kThreads, 0, s>>>(
          static_cast<const T*>(g), static_cast<const int*>(perm),
          static_cast<const int*>(sorted_tok), static_cast<float*>(partial), n, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    embed_grad_rows_kernel<T><<<v, kThreads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<const int*>(bounds),
        static_cast<T*>(out), d);
  })
  return static_cast<int>(cudaGetLastError());
}
