// The one-hop weight matrices of a batch of graphs, built straight from
// their padded link lists, the first step of the COO-fed APSP:
//
//     W[b] = +inf, 0 on the diagonal, min-scattered with delays[b, l] at
//            (u, v) and (v, u) for every real link l = (u, v).
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// apsp_minplus_coo` (`_coo_apsp_kernel`) together with K2: the TPU kernel
// rebuilds W from the link list inside its first squaring tile and squares
// it with `_chunked_squaring`, the code it shares with K2.  Here the same
// split holds across two kernels: this one writes W to device memory and
// the wrapper (`ops/minplus.py:apsp_coo_cuda`) squares it with K2
// (`csrc/minplus.cu`), up to ceil(log2(N - 1)) times with early stop.
//
// What bounds the build on an H100: bytes, 12 L + 4 N^2 per graph (the
// squarings after it are bound by operations, see `csrc/minplus.cu`).
//
// Exactness: the scatter is an exact float min (an integer atomic min on
// the bits of a non-negative float, max on the unsigned bits of a negative
// one), and masked links are skipped (they carry +inf in the plain version,
// inert under min), so W equals `weight_matrix_from_edges` with the
// diagonal zeroed bit for bit, and the squared result equals the plain
// chain `weight_matrix_from_edges` -> `apsp_minplus_blocked`.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// One block per graph: fill W, then min-scatter its real links.
__global__ void __launch_bounds__(kThreads)
coo_weights_kernel(const int* __restrict__ ends, const unsigned char* __restrict__ mask,
                   const float* __restrict__ delays, float* __restrict__ out,
                   int L, int N) {
  const int b = blockIdx.x;
  float* w = out + static_cast<long long>(b) * N * N;
  for (int e = threadIdx.x; e < N * N; e += kThreads) {
    w[e] = (e / N == e % N) ? 0.0f : CUDART_INF_F;
  }
  __syncthreads();
  const long long base = static_cast<long long>(b) * L;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    if (!mask[base + l]) continue;
    const int u = ends[2 * (base + l)], v = ends[2 * (base + l) + 1];
    const float d = delays[base + l];
    atomic_min_float(&w[u * N + v], d);
    atomic_min_float(&w[v * N + u], d);
  }
}

}  // namespace

// W into out (B, N, N) float32, one block per graph, on `stream`; returns
// the cudaError_t of the launch (0 = success).  ends (B, L, 2) int32, mask
// (B, L) bool, delays (B, L) float32; all contiguous.
extern "C" int mho_coo_weights_f32(const void* ends, const void* mask, const void* delays,
                                   void* out, int B, int L, int N, void* stream) {
  coo_weights_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ends), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(delays), static_cast<float*>(out), L, N);
  return static_cast<int>(cudaGetLastError());
}
