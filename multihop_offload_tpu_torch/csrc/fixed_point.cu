// Conflict-interference fixed point, batched: one thread block per instance.
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/fixed_point.py:
// fixed_point_pallas` (`_pallas_call` -> `_fp_kernel`).  Computes, for each
// instance b of the batch,
//
//     mu_0 = rate / (cf + 1)
//     10x: busy = clip(lambda / mu, 0, 1);  mu = rate / (1 + A @ busy)
//
// with A the (L, L) 0/1 conflict adjacency (`env/queueing.py:51-73`).
//
// What bounds it on an H100: bytes.  The function must read A once
// (B * L^2 * 4 bytes of float32; 11.9 MB at B=64, L=216) and does only
// 2 * L^2 operations per iteration on it, far below the card's
// operations-per-byte balance.  Ten dense mat-vecs straight from device
// memory would read A ten times.
//
// What the design does about it: A is read from device memory exactly once,
// coalesced, and narrowed on the fly to one bit per entry with
// `__ballot_sync` (a warp reads 32 neighbouring entries of a row and gets
// their nonzero mask as one 32-bit word).  32 warps, each with 8 reads in
// flight, share that pass.  The bitmask of a whole instance stays in shared
// memory for all ten iterations: L^2/8 bytes, 31 KB at L=504, where A as
// uint8 (254 KB) or float32 would not fit in the 227 KB a block may use.
// mu, busy and the mat-vec's partial sums stay in shared memory too;
// __syncthreads() separates the steps of each iteration.  A's entries are
// 0 or 1 (a conflict adjacency), so a nonzero entry is read as 1.  The
// mat-vec gives each (row, 32-column word) pair to one thread, which sums
// busy over the word's set bits in ascending order; each row then adds its
// words' partial sums in ascending order, in float32.  Its work is the
// number of conflicts, not L^2, and a high-degree row is spread over many
// threads.  Nothing carries between blocks, and any L works (the ragged
// last word is masked).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // 32 warps share the pass over A
constexpr int kLoads = 8;       // row loads in flight per warp

__global__ void __launch_bounds__(kThreads)
fixed_point_kernel(const float* __restrict__ adj,
                   const float* __restrict__ rates,
                   const float* __restrict__ cf,
                   const float* __restrict__ lam,
                   float* __restrict__ mu_out,
                   int L, int stride, int iters) {
  extern __shared__ uint32_t smem[];
  const int words = (L + 31) / 32;
  const int items = L * words;  // (row, word) pairs, row-major
  uint32_t* bits = smem;        // word w of row i at bits[i * stride + w]
  float* part = reinterpret_cast<float*>(bits + static_cast<size_t>(L) * stride);
  float* busy = part + static_cast<size_t>(L) * stride;
  float* mu = busy + L;

  const size_t off = static_cast<size_t>(blockIdx.x) * L;
  const float* A = adj + off * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // one pass over A: warp-sized (row, word) items, 32 columns per ballot.
  // Each warp issues kLoads loads before their ballots, so that several
  // 128-byte reads are in flight per warp.
  for (int t0 = warp * kLoads; t0 < items; t0 += nwarps * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int t = t0 + u;
      const int col = (t % words) * 32 + lane;
      v[u] = (t < items && col < L)
                 ? A[static_cast<size_t>(t / words) * L + col] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, v[u] != 0.0f);
      const int t = t0 + u;
      if (lane == 0 && t < items) bits[(t / words) * stride + t % words] = m;
    }
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    mu[i] = rates[off + i] / (cf[off + i] + 1.0f);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      const float x = lam[off + i] / mu[i];
      // clip(x, 0, 1); a NaN passes through, as jnp.clip / torch.clamp do
      busy[i] = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    }
    __syncthreads();
    // A @ busy in two fixed-order steps: a partial sum per (row, word) over
    // its set bits, ascending; then per row the partials, ascending
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
      const int i = t / words, w = t % words;
      uint32_t m = bits[i * stride + w];
      float s = 0.0f;
      while (m) {
        s += busy[w * 32 + __ffs(m) - 1];
        m &= m - 1;
      }
      part[i * stride + w] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      float s = 0.0f;
      for (int w = 0; w < words; ++w) s += part[i * stride + w];
      mu[i] = rates[off + i] / (1.0f + s);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) mu_out[off + i] = mu[i];
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// adj (B, L, L), rates/cf/lam/mu (B, L): float32, contiguous, on the card.
extern "C" int mho_fixed_point_f32(const void* adj, const void* rates,
                                   const void* cf, const void* lam, void* mu,
                                   int B, int L, int iters, void* stream) {
  const int words = (L + 31) / 32;
  const int stride = words | 1;  // odd row stride: 32 rows hit 32 banks
  // bitmask and per-word partial sums (L x stride each), busy and mu (L each)
  const size_t smem = 2 * static_cast<size_t>(L) * stride * sizeof(uint32_t) +
                      2 * static_cast<size_t>(L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fixed_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fixed_point_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<const float*>(rates),
      static_cast<const float*>(cf), static_cast<const float*>(lam),
      static_cast<float*>(mu), L, stride, iters);
  return static_cast<int>(cudaGetLastError());
}
