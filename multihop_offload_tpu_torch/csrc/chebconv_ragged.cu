// K5: the ChebConv propagate over the live prefix of a padded edge list:
//
//     out[b, r, f] = diag[b, r] * x[b, r, f]
//                  + sum_{e < live[b], rows[b, e] == r} vals[b, e] * x[b, cols[b, e], f]
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/chebconv.py:
// chebconv_propagate_ragged` (`_chebconv_ragged_kernel`), which takes the
// live count as a scalar-prefetch argument and skips every 512-edge block
// past it, so one compiled program serves every occupancy.  Here the live
// counts are a (B,) int32 tensor in device memory that the kernel reads
// itself: the host never reads them, and one launch serves every
// occupancy.  Entries at or past live[b] are never read.
//
// Contract: the live entries may come in ANY row order (the JAX tests draw
// random rows), so K4's CSR index, which needs the entries sorted by row,
// cannot be used.  The kernel scans the list instead.
//
// What bounds it on an H100: bytes, in principle (each live entry's 12
// bytes, diag, x and out once, a few MB in all).  In practice latency: the
// entries of one row must be added one after another, in list order.
//
// Design: a warp owns a tile of kTile rows of one slot, its lanes the
// features (32 a pass), its sums in shared memory.  A block of kWarps warps
// stages the slot's live prefix of (row, col, val) through shared memory in
// chunks.  Each warp tests 32 entries at a time (one a lane) against its
// tile, takes the ballot of the ones that fall in it, and walks the set
// bits in order: for each such entry every lane adds vals * x[col, lane]
// to its row's sum with `__fmul_rn` / `__fadd_rn` (no fused multiply-add),
// then diag * x[row] is added.  Each (row, feature) sum thus runs over its
// entries in list order, the sequential sum the CPU's `index_add` forms in
// the plain version, so the result is bit-identical to it and
// deterministic (no atomics).  A warp spends one ballot per 32 entries of
// the slot and one gather of x per entry of its own tile.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;      // warps (row tiles) per block
constexpr int kTile = 8;       // rows per warp
constexpr int kChunk = 1024;   // list entries staged in shared memory per step

__global__ void __launch_bounds__(kWarps * 32)
chebconv_ragged_kernel(const int* __restrict__ rows,    // (B, cap)
                       const int* __restrict__ cols,    // (B, cap)
                       const float* __restrict__ vals,  // (B, cap)
                       const float* __restrict__ diag,  // (B, E)
                       const float* __restrict__ x,     // (B, E, F)
                       const int* __restrict__ live,    // (B,)
                       float* __restrict__ out,         // (B, E, F)
                       int E, int F, int cap) {
  __shared__ int s_row[kChunk];
  __shared__ int s_col[kChunk];
  __shared__ float s_val[kChunk];
  __shared__ float s_acc[kWarps][kTile][32];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * kWarps + warp) * kTile;
  const int n = min(max(live[b], 0), cap);
  const long long lb = static_cast<long long>(b) * cap;
  const float* xb = x + static_cast<long long>(b) * E * F;
  float (*acc)[32] = s_acc[warp];
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int nf = min(32, F - f0);
    for (int i = 0; i < kTile; ++i) acc[i][lane] = 0.0f;
    __syncwarp();
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int m = min(kChunk, n - c0);
      __syncthreads();
      for (int k = threadIdx.x; k < m; k += kWarps * 32) {
        s_row[k] = rows[lb + c0 + k];
        s_col[k] = cols[lb + c0 + k];
        s_val[k] = vals[lb + c0 + k];
      }
      __syncthreads();
      for (int j = 0; j < m; j += 32) {
        const int k = j + lane;
        const int rl = k < m ? s_row[k] - r0 : -1;
        unsigned mask = __ballot_sync(0xffffffffu, static_cast<unsigned>(rl) < kTile);
        while (mask) {
          const int bit = __ffs(mask) - 1;
          mask &= mask - 1;
          const int row = __shfl_sync(0xffffffffu, rl, bit);
          const int e = j + bit;
          if (lane < nf) {
            const float v = s_val[e];
            const float xc = xb[static_cast<long long>(s_col[e]) * F + f0 + lane];
            acc[row][lane] = __fadd_rn(acc[row][lane], __fmul_rn(v, xc));
          }
        }
      }
    }
    __syncwarp();
    for (int i = 0; i < kTile; ++i) {
      const int r = r0 + i;
      if (r < E && lane < nf) {
        const float d = diag[static_cast<long long>(b) * E + r];
        const float xr = xb[static_cast<long long>(r) * F + f0 + lane];
        out[(static_cast<long long>(b) * E + r) * F + f0 + lane] =
            __fadd_rn(acc[i][lane], __fmul_rn(d, xr));
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Launches K5 on `stream`; returns the cudaError_t of the launch (0 =
// success).  rows, cols (B, cap) int32; vals (B, cap), diag (B, E), x and
// out (B, E, F) float32; live (B,) int32 in device memory; all contiguous.
extern "C" int mho_chebconv_ragged_f32(const void* rows, const void* cols,
                                       const void* vals, const void* diag,
                                       const void* x, const void* live, void* out,
                                       int B, int E, int F, int cap, void* stream) {
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int kRowsPerBlock = kWarps * kTile;
  const dim3 grid((E + kRowsPerBlock - 1) / kRowsPerBlock, B);
  chebconv_ragged_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(diag),
      static_cast<const float*>(x), static_cast<const int*>(live),
      static_cast<float*>(out), E, F, cap);
  return static_cast<int>(cudaGetLastError());
}
