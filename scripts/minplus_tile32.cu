// Bench-only copy of K2's 32 x 32-tile kernel (the package's `csrc/
// minplus.cu` before its tiles followed N), driven by
// `scripts/bench_minplus.py` through the same C interface, with two knobs
// (`--variant TAG=scripts/minplus_tile32.cu:NAME=VALUE`):
//
//   kCut = 1   the same tile body with its tiles cut to N: edge
//              T = 4 ceil(ceil(N / ceil(N / 32)) / 4) (N = 112 -> 28,
//              56 -> 28, 37 -> 20, 256 -> 32), T / 4 x T / 4 threads of
//              4 x 4 minima, k-slices of T and a k loop that stops at N.
//   kClock = 1 thread 0 of every block adds its clock64 split to
//              executed[1..7]: [1] blocks, [2] issuing a slice's global
//              loads into registers, [3] waiting for them, the transposed
//              shared stores and the barrier, [4] the k loop, [5] the
//              barrier after it, [6] the epilogue (`old`'s load, the stores,
//              __syncthreads_or, the flag), [7] the block's whole time.
//              executed[0] stays the squarings run.
//
// With both at 0 it computes what the 32 x 32 kernel computed, the same way.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCut = 0;
constexpr int kClock = 0;

template <int kTile>
__global__ void __launch_bounds__((kTile / 4) * (kTile / 4))
minplus_square_kernel(const float* __restrict__ src, float* __restrict__ dst,
                      int* __restrict__ flags,
                      unsigned long long* __restrict__ executed,
                      int N, int B, int step) {
  constexpr int kK = kTile;       // k-slice depth
  constexpr int kDim = kTile / 4; // threads per tile edge
  constexpr int kR = 4;           // 4x4 outputs per thread
  constexpr int kLd = kTile + 4;
  constexpr int kPer = kK * kTile / (kDim * kDim);  // panel entries per thread

  const int b = blockIdx.z;
  if (step > 0 && flags[(step - 1) * B + b] == 0) return;
  long long t_start = 0, t = 0, split[6] = {0, 0, 0, 0, 0, 0};
  auto tick = [&](int phase) {
    if constexpr (kClock) {
      const long long now = clock64();
      split[phase] += now - t;
      t = now;
    }
  };
  if constexpr (kClock) t = t_start = clock64();

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

  float ra[kPer], rb[kPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kDim * kDim;
      const int gi = i0 + e / kK, gk = k0 + e % kK;
      ra[u] = (gi < N && gk < N) ? S[static_cast<size_t>(gi) * N + gk]
                                 : CUDART_INF_F;
      const int hk = k0 + e / kTile, gj = j0 + e % kTile;
      rb[u] = (hk < N && gj < N) ? S[static_cast<size_t>(hk) * N + gj]
                                 : CUDART_INF_F;
    }
  };
  load(0);
  tick(0);
  for (int k0 = 0; k0 < N; k0 += kK) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kDim * kDim;
      As[e % kK][e / kK] = ra[u];
      Bs[e / kTile][e % kTile] = rb[u];
    }
    __syncthreads();
    tick(1);
    if (k0 + kK < N) load(k0 + kK);
    tick(0);
    if constexpr (kCut) {
      const int kn = min(kK, N - k0);
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * kR]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * kR]);
        const float av[kR] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[kR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int c = 0; c < kR; ++c) acc[a][c] = fminf(acc[a][c], av[a] + bv[c]);
      }
    } else {
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
    }
    if constexpr (kClock) {  // the loop's results are in registers: wait on them
      float sink = CUDART_INF_F;
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int c = 0; c < kR; ++c) sink = fminf(sink, acc[a][c]);
      asm volatile("" ::"f"(sink));
    }
    tick(2);
    __syncthreads();
    tick(3);
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
  if constexpr (kClock) {
    tick(4);
    if (tid == 0) {
      // the split sits beside the squarings counter: executed[1..7]
      atomicAdd(executed + 1, 1ULL);
      atomicAdd(executed + 2, static_cast<unsigned long long>(split[0]));
      atomicAdd(executed + 3, static_cast<unsigned long long>(split[1]));
      atomicAdd(executed + 4, static_cast<unsigned long long>(split[2]));
      atomicAdd(executed + 5, static_cast<unsigned long long>(split[3]));
      atomicAdd(executed + 6, static_cast<unsigned long long>(split[4]));
      atomicAdd(executed + 7, static_cast<unsigned long long>(t - t_start));
    }
  }
}

template <int kTile>
int launch(const void* src, void* dst, void* flags, void* executed, int B, int N,
           int step, void* stream) {
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  const dim3 block(kTile / 4, kTile / 4);
  minplus_square_kernel<kTile><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<int*>(flags), static_cast<unsigned long long*>(executed), N, B, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mho_minplus_square_f32(const void* src, void* dst, void* flags,
                                      void* executed, int B, int N, int step,
                                      void* stream) {
  if constexpr (kCut) {
    const int parts = (N + 31) / 32;
    const int edge = 4 * (((N + parts - 1) / parts + 3) / 4);
    switch (edge) {
      case 4: return launch<4>(src, dst, flags, executed, B, N, step, stream);
      case 8: return launch<8>(src, dst, flags, executed, B, N, step, stream);
      case 12: return launch<12>(src, dst, flags, executed, B, N, step, stream);
      case 16: return launch<16>(src, dst, flags, executed, B, N, step, stream);
      case 20: return launch<20>(src, dst, flags, executed, B, N, step, stream);
      case 24: return launch<24>(src, dst, flags, executed, B, N, step, stream);
      case 28: return launch<28>(src, dst, flags, executed, B, N, step, stream);
      default: return launch<32>(src, dst, flags, executed, B, N, step, stream);
    }
  }
  return launch<32>(src, dst, flags, executed, B, N, step, stream);
}
