// One min-plus squaring of a batch of (N, N) distance matrices:
//
//     dst[b, i, j] = min(src[b, i, j], min_k src[b, i, k] + src[b, k, j])
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// minplus_power_kernel_call` (`_apsp_kernel` -> `_chunked_squaring`), which
// runs all ceil(log2(N-1)) squarings of `env/apsp.py:apsp_minplus` in one
// call.  Here the wrapper launches this kernel once per squaring and
// ping-pongs between two buffers.
//
// What bounds it on an H100: operations.  (min, +) has no tensor-core path;
// each candidate costs two CUDA-core fp32 instructions (FADD, then FMNMX),
// not one FMA, so a squaring is 2 * N^3 instructions per matrix at the
// card's fp32 issue rate, against only 8 * N^2 bytes of traffic.
//
// What the design does about it: an SGEMM-shaped tiling with (min, +) in
// place of (x, +).  A block of 8x8 threads owns a 32x32 output tile; each
// thread keeps a 4x4 register tile of running minima, and the block stages
// 32-deep k-slices of its row panel (transposed) and column panel in shared
// memory.  Per k a thread reads one float4 from each panel and makes 16
// candidates from them, so the two shared loads feed 32 ALU instructions
// and the ALUs, not shared memory, set the pace.  The next k-slice is
// fetched into registers while the current one is consumed.  Entries past N read as
// +inf, which is inert under (min, +), so any N works without padding.
// No symmetry is assumed.  Every candidate is one correctly rounded add and
// min is exact, so the result is bit-identical to the plain version.
//
// Early stop without a host sync: block (., ., b) of squaring `step` sets
// flags[step * B + b] when its tile changed.  Squaring `step` of matrix b
// runs only if squaring `step - 1` changed it; otherwise src == dst already
// holds for b (the previous squaring wrote dst equal to its src), so both
// ping-pong buffers hold the fixed point and the block exits at once.  The
// first tile of every squaring that runs adds one to `*executed`.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;       // output tile edge
constexpr int kK = 32;          // k-slice depth staged in shared memory
constexpr int kDim = 8;         // threads per tile edge
constexpr int kR = kTile / kDim;  // 4x4 outputs per thread
constexpr int kLd = kTile + 4;  // shared row stride: rows stay 16-byte aligned
constexpr int kPer = kK * kTile / (kDim * kDim);  // panel entries per thread

__global__ void __launch_bounds__(kDim * kDim)
minplus_square_kernel(const float* __restrict__ src, float* __restrict__ dst,
                      int* __restrict__ flags,
                      unsigned long long* __restrict__ executed,
                      int N, int B, int step) {
  const int b = blockIdx.z;
  if (step > 0 && flags[(step - 1) * B + b] == 0) return;

  __shared__ __align__(16) float As[kK][kLd];  // As[k][i] = S[i0 + i][k0 + k]
  __shared__ __align__(16) float Bs[kK][kLd];  // Bs[k][j] = S[k0 + k][j0 + j]
  const size_t base = static_cast<size_t>(b) * N * N;
  const float* S = src + base;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDim + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  float acc[kR][kR];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[a][c] = CUDART_INF_F;

  // the next k-slice's panels are loaded into registers while the current
  // one is consumed, so global-load latency overlaps the (min, +) work
  float ra[kPer], rb[kPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kDim * kDim;
      const int gi = i0 + e / kK, gk = k0 + e % kK;  // row panel: along k
      ra[u] = (gi < N && gk < N) ? S[static_cast<size_t>(gi) * N + gk]
                                 : CUDART_INF_F;
      const int hk = k0 + e / kTile, gj = j0 + e % kTile;  // column panel
      rb[u] = (hk < N && gj < N) ? S[static_cast<size_t>(hk) * N + gj]
                                 : CUDART_INF_F;
    }
  };
  load(0);
  for (int k0 = 0; k0 < N; k0 += kK) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kDim * kDim;
      As[e % kK][e / kK] = ra[u];
      Bs[e / kTile][e % kTile] = rb[u];
    }
    __syncthreads();
    if (k0 + kK < N) load(k0 + kK);
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * kR]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * kR]);
      const float av[kR] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[kR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int c = 0; c < kR; ++c) acc[a][c] = fminf(acc[a][c], av[a] + bv[c]);
    }
    __syncthreads();
  }

  int changed = 0;
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = i0 + ty * kR + a;
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      const int j = j0 + tx * kR + c;
      if (i < N && j < N) {
        const size_t at = static_cast<size_t>(i) * N + j;
        const float old = S[at];
        const float v = fminf(old, acc[a][c]);
        dst[base + at] = v;
        changed |= (v != old);
      }
    }
  }
  if (__syncthreads_or(changed) && tid == 0) flags[step * B + b] = 1;
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) atomicAdd(executed, 1ULL);
}

}  // namespace

// Launches squaring `step` on `stream`; returns the cudaError_t of the
// launch (0 = success).  src/dst (B, N, N) float32 contiguous, distinct;
// flags (steps, B) int32 zeroed before step 0; executed: one uint64.
extern "C" int mho_minplus_square_f32(const void* src, void* dst, void* flags,
                                      void* executed, int B, int N, int step,
                                      void* stream) {
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  const dim3 block(kDim, kDim);
  minplus_square_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<int*>(flags), static_cast<unsigned long long*>(executed),
      N, B, step);
  return static_cast<int>(cudaGetLastError());
}
