// One min-plus squaring of a batch of (N, N) bf16 distance matrices:
//
//     dst[b, i, j] = min(src[b, i, j], min_k src[b, i, k] + src[b, k, j])
//
// with every sum rounded to bf16, as a bf16 min-plus squaring computes it.
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// minplus_power_kernel_call` on the bf16 leg of the precision policy
// (`precision.py:wrap_apsp` narrows W; the Pallas kernel keeps the input's
// dtype, `ops/minplus.py:96`).  The wrapper (`ops/minplus.py:
// minplus_closure_cuda` on bf16) launches it once per squaring and ping-pongs
// between two buffers, with the early stop of the float32 kernel
// (`csrc/minplus.cu`).
//
// Exactness: a tile's bf16 operands are widened to fp32 in shared memory,
// each candidate is one fp32 add, the minimum is taken over fp32 sums, and
// the result is rounded to bf16 once on store.  That equals a bf16
// squaring bit for bit: a bf16 + bf16 sum rounded first to fp32 and then
// to bf16 is correctly rounded (24 >= 2 * 8 + 2 makes the double rounding
// innocuous), and rounding is monotone, so the rounded minimum is the
// minimum of the rounded sums (the old value is a bf16 already).
//
// What bounds it on an H100: issue slots, as the float32 kernel: 2 N^3
// CUDA-core fp32 instructions (add, min) per squaring per matrix, against
// 4 N^2 bytes of traffic.  This first bf16 kernel is the simple one: 32 x
// 32 output tiles, 256 threads of 2 x 2 minima, k-slices of 32 staged as
// fp32 in shared memory, one barrier pair a slice.  It keeps none of the
// float32 kernel's tile plans or tensor copies (their bodies are fp32-
// typed); packed `__nv_bfloat162` arithmetic is later work.
//
// Early stop without a host sync: block (., ., b) of squaring `step` sets
// flags[step * B + b] when its tile changed.  Squaring `step` of matrix b
// runs only if squaring `step - 1` changed it; otherwise both ping-pong
// buffers already hold b's fixed point and the block exits at once.  The
// first tile of every squaring that runs adds one to `*executed`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;            // output tile rows = cols = k-slice depth
constexpr int kTy = 16, kTx = 16;    // threads: 2 x 2 minima each
constexpr int kThreads = kTy * kTx;

__global__ void __launch_bounds__(kThreads)
minplus_bf16_kernel(const __nv_bfloat16* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                    int* __restrict__ flags, unsigned long long* __restrict__ executed,
                    int N, int B, int step) {
  const int b = blockIdx.z;
  if (step > 0 && flags[(step - 1) * B + b] == 0) return;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const __nv_bfloat16* m = src + static_cast<long long>(b) * N * N;

  __shared__ float sa[kTile][kTile + 1];  // rows i0.., columns k0..
  __shared__ float sb[kTile][kTile + 1];  // rows k0.., columns j0..

  float best[2][2];
  for (int r = 0; r < 2; ++r)
    for (int c = 0; c < 2; ++c) best[r][c] = CUDART_INF_F;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int ai = i0 + r, ak = k0 + c, bk = k0 + r, bj = j0 + c;
      sa[r][c] = (ai < N && ak < N) ? __bfloat162float(m[ai * N + ak]) : CUDART_INF_F;
      sb[r][c] = (bk < N && bj < N) ? __bfloat162float(m[bk * N + bj]) : CUDART_INF_F;
    }
    __syncthreads();
    const int kn = min(kTile, N - k0);
#pragma unroll 8
    for (int k = 0; k < kn; ++k) {
      const float a0 = sa[ty][k], a1 = sa[ty + kTy][k];
      const float b0 = sb[k][tx], b1 = sb[k][tx + kTx];
      best[0][0] = fminf(best[0][0], __fadd_rn(a0, b0));
      best[0][1] = fminf(best[0][1], __fadd_rn(a0, b1));
      best[1][0] = fminf(best[1][0], __fadd_rn(a1, b0));
      best[1][1] = fminf(best[1][1], __fadd_rn(a1, b1));
    }
    __syncthreads();
  }

  int changed = 0;
  __nv_bfloat16* out = dst + static_cast<long long>(b) * N * N;
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + ty + r * kTy;
    if (i >= N) continue;
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + tx + c * kTx;
      if (j >= N) continue;
      const __nv_bfloat16 old = m[i * N + j];
      const __nv_bfloat16 w = __float2bfloat16_rn(fminf(__bfloat162float(old), best[r][c]));
      changed |= __bfloat16_as_ushort(w) != __bfloat16_as_ushort(old);
      out[i * N + j] = w;
    }
  }
  if (__syncthreads_or(changed) && tid == 0) flags[step * B + b] = 1;
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) atomicAdd(executed, 1ULL);
}

}  // namespace

// Launches squaring `step` on `stream`; returns the cudaError_t of the
// launch (0 = success).  src/dst (B, N, N) bf16 contiguous, distinct; flags
// (steps, B) int32 zeroed before step 0; executed: one uint64.
extern "C" int mho_minplus_square_bf16(const void* src, void* dst, void* flags,
                                       void* executed, int B, int N, int step,
                                       void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (N + kTile - 1) / kTile, B);
  minplus_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst),
      static_cast<int*>(flags), static_cast<unsigned long long*>(executed), N, B, step);
  return static_cast<int>(cudaGetLastError());
}
