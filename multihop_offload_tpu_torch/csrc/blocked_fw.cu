// Exact all-pairs shortest paths of a batch of (N, N) distance matrices by
// blocked Floyd-Warshall on 128 x 128 pivot blocks, in place.
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// blocked_fw_call` (`_pivot_kernel`, `_panel_kernel`, `_outer_kernel`).  For
// each pivot block kk the launcher issues three launches on one stream, no
// host sync, so 3 N / 128 launches per call:
//
//   1. pivot: close block (kk, kk) by sequential FW over its 128 steps;
//   2. panels, row and column in one launch: block (kk, j), j != kk,
//      becomes min(blk, P (x) blk) and block (i, kk), i != kk, becomes
//      min(blk, blk (x) P), each from the old block;
//   3. outer: block (i, j), i, j != kk, becomes min(c, A (x) B) with A the
//      finished (i, kk) and B the finished (kk, j).
//
// P is the closed pivot and (x) the (min, +) product.  The pivot block is
// passed through by phases 2-3, as the TPU kernel passes it through.
//
// What bounds it on an H100: operations.  (min, +) has no tensor-core path;
// each candidate is two CUDA-core fp32 instructions (FADD, then FMNMX), and
// one sweep makes N^3 candidates per matrix: 2 N^3 instructions, 64.1 us at
// N = 1,024, against 8 N^2 bytes of traffic (2.5 us).  What the design does
// about it, simply first: phases 2-3 are min-plus products of fixed
// operands, tiled like `csrc/minplus.cu` (32-deep k-slices staged in shared
// memory, a 4 x 4 register tile of running minima per thread, one float4
// from each operand feeding 16 candidates), and each 128 x 128 output block
// is cut into sub-tiles for several thread blocks: at B = 1, N = 1,024 the
// 14 panel blocks make 56 thread blocks and the 49 outer blocks 196, against
// 132 SMs.  The row and column panels do not read each other, so they share
// a launch.  The pivot is the part that does not spread: one thread block of
// 1,024 threads per matrix holds the tile in registers, 16 entries a thread,
// through 128 dependent steps on one SM; at each step the owners of row k
// and column k publish them to shared memory and one __syncthreads
// separates that from the reads.  Its 128^3 candidates a round on one SM,
// about two thirds of the kernel's time at N = 1,024, hold the kernel far
// above its bound; keeping the tile in shared memory instead, or taking two
// steps per sync, measured no faster.
//
// In place without races: row k and column k do not change at step k,
// because the diagonal is 0 (d[i][k] + d[k][k] is never smaller than
// d[i][k]), so the values published before the step are the ones FW reads
// during it.  A row-panel thread block owns all 128 rows of its columns and a
// column-panel thread block all 128 columns of its rows, so the part of the
// old block it reads is written by no other thread block, and it writes only
// after its last read; the outer phase reads the panels, which it never
// writes.
//
// Exactness: every candidate is one correctly rounded add and min is exact,
// so each phase's result does not depend on the order of k, and the whole is
// bit-identical to the plain version `ops/minplus.py:blocked_fw_plain`,
// which follows the same schedule.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kT = 128;        // pivot block edge, the TPU kernel's `_LANE`
constexpr int kPivotDim = 32;  // pivot: 32 x 32 threads, 4 x 4 entries each
constexpr int kK = 32;         // k-slice depth staged in shared memory
constexpr int kR = 4;          // 4 x 4 outputs per thread
constexpr int kThreads = 256;  // threads of a panel / outer thread block
constexpr int kStrip = 32;     // width of a panel thread block's strip

// Thread (tx, ty) holds entries (ty + 32 r, tx + 32 c), r, c < 4, of the
// pivot block in registers.  At step k the owners of row k and of column k
// publish them to shared memory, one __syncthreads, then every thread reads
// the 4 + 4 values it needs and updates its 16 entries.  The two buffers
// alternate between steps: a thread still reading step k's buffer is never
// overwritten, because step k + 1 publishes into the other one and step
// k + 2 publishes only after the sync of step k + 1, which every reader of
// step k has passed.
__global__ void __launch_bounds__(kPivotDim * kPivotDim)
fw_pivot_kernel(float* __restrict__ d, int N, int kk) {
  __shared__ float row_buf[2][kT];  // row k of the block, by column
  __shared__ float col_buf[2][kT];  // column k of the block, by row
  float* D = d + static_cast<size_t>(blockIdx.x) * N * N
             + static_cast<size_t>(kk) * kT * N + static_cast<size_t>(kk) * kT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float e[kR][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c)
      e[r][c] = D[static_cast<size_t>(ty + kPivotDim * r) * N + tx + kPivotDim * c];
  for (int k = 0; k < kT; ++k) {
    const int buf = k & 1, kr = k / kPivotDim, kl = k % kPivotDim;
    // static register indices only (a dynamic one would spill e to memory)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (ty == kl && r == kr) {
#pragma unroll
        for (int c = 0; c < kR; ++c) row_buf[buf][tx + kPivotDim * c] = e[r][c];
      }
#pragma unroll
    for (int c = 0; c < kR; ++c)
      if (tx == kl && c == kr) {
#pragma unroll
        for (int r = 0; r < kR; ++r) col_buf[buf][ty + kPivotDim * r] = e[r][c];
      }
    __syncthreads();
    float a[kR], b[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) a[r] = col_buf[buf][ty + kPivotDim * r];
#pragma unroll
    for (int c = 0; c < kR; ++c) b[c] = row_buf[buf][tx + kPivotDim * c];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kR; ++c) e[r][c] = fminf(e[r][c], a[r] + b[c]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kR; ++c)
      D[static_cast<size_t>(ty + kPivotDim * r) * N + tx + kPivotDim * c] = e[r][c];
}

// One TM x TN sub-tile C: C = min(C, A (x) B), A the TM x kT rows beside it
// in the pivot column, B the kT x TN columns above or below it in the pivot
// row; every operand has row stride N.  All of A and B is read before C is
// written (in a panel C is A or B itself, so no pointer here is restrict).
template <int TM, int TN>
__device__ __forceinline__ void minplus_tile(const float* A, const float* B, float* C,
                                             int N) {
  constexpr int kTx = TN / kR;  // threads along a row
  static_assert((TM / kR) * (TN / kR) == kThreads, "one 4 x 4 tile per thread");
  __shared__ __align__(16) float As[kK][TM + 4];  // As[k][i] = A[i][k0 + k]
  __shared__ __align__(16) float Bs[kK][TN + 4];  // Bs[k][j] = B[k0 + k][j]
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  float acc[kR][kR];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[a][c] = CUDART_INF_F;

  for (int k0 = 0; k0 < kT; k0 += kK) {
    for (int e = tid; e < TM * kK; e += kThreads) {
      const int i = e / kK, k = e % kK;
      As[k][i] = A[static_cast<size_t>(i) * N + k0 + k];
    }
    for (int e = tid; e < kK * TN; e += kThreads) {
      const int k = e / TN, j = e % TN;
      Bs[k][j] = B[static_cast<size_t>(k0 + k) * N + j];
    }
    __syncthreads();
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
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      float* e = &C[static_cast<size_t>(ty * kR + a) * N + tx * kR + c];
      *e = fminf(*e, acc[a][c]);
    }
}

__device__ __forceinline__ int skip_pivot(int b, int kk) { return b < kk ? b : b + 1; }

// Thread blocks [0, h) take a 128 x 32 strip of a row-panel block, [h, 2 h)
// a 32 x 128 strip of a column-panel block, h = (N / 128 - 1) * 4.
__global__ void __launch_bounds__(kThreads)
fw_panels_kernel(float* __restrict__ d, int N, int kk) {
  constexpr int kSub = kT / kStrip;
  const int h = (N / kT - 1) * kSub;
  float* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const float* P = M + static_cast<size_t>(kk) * kT * N + kk * kT;
  int t = blockIdx.x;
  if (t < h) {
    const int j0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    float* C = M + static_cast<size_t>(kk) * kT * N + j0;
    minplus_tile<kT, kStrip>(P, C, C, N);
  } else {
    t -= h;
    const int i0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    float* C = M + static_cast<size_t>(i0) * N + kk * kT;
    minplus_tile<kStrip, kT>(C, P, C, N);
  }
}

// Thread block t takes a 64 x 64 quarter of an off-pivot block.
__global__ void __launch_bounds__(kThreads)
fw_outer_kernel(float* __restrict__ d, int N, int kk) {
  constexpr int kQ = 64;
  const int skip = N / kT - 1;
  float* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const int q = blockIdx.x % 4, t = blockIdx.x / 4;
  const int i0 = skip_pivot(t / skip, kk) * kT + (q / 2) * kQ;
  const int j0 = skip_pivot(t % skip, kk) * kT + (q % 2) * kQ;
  minplus_tile<kQ, kQ>(M + static_cast<size_t>(i0) * N + kk * kT,
                       M + static_cast<size_t>(kk) * kT * N + j0,
                       M + static_cast<size_t>(i0) * N + j0, N);
}

}  // namespace

// Runs the whole sweep on `stream`: for each of the N / 128 pivot blocks,
// the pivot, panels and outer launches (only the pivot when N = 128).  d
// (B, N, N) float32 contiguous, N a multiple of 128, updated in place.
// Returns the first cudaError_t (0 = success).
extern "C" int mho_blocked_fw_f32(void* d, int B, int N, void* stream) {
  float* dd = static_cast<float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = N / kT, skip = nb - 1;
  cudaError_t err;
  for (int kk = 0; kk < nb; ++kk) {
    fw_pivot_kernel<<<B, dim3(kPivotDim, kPivotDim), 0, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (skip == 0) continue;
    fw_panels_kernel<<<dim3(2 * skip * (kT / kStrip), B), kThreads, 0, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fw_outer_kernel<<<dim3(skip * skip * 4, B), kThreads, 0, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
