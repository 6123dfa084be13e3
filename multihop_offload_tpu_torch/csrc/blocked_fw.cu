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
// N = 1,024, against 8 N^2 bytes of traffic (2.5 us).  The pivot cannot
// spread: its 128 steps are a chain (step k reads row k as step k - 1 left
// it), run on one SM per matrix.
//
// The pivot (`fw_pivot_kernel`) has no block-wide barrier inside its steps.
// 32 warps own 4 rows each in registers; row k, once step k - 1 has updated
// it, is published once into its own slot of shared memory and announced on
// its own mbarrier, and each warp waits only for the row the step needs, so
// warps run ahead of one another.  Its floor under this design is the
// chain, ~130 ns a step (wait, shared load, shuffle, add, min, store,
// arrival), ~130 us of the 1,024 steps at N = 1,024; SASS shows each link
// instead waiting for about a whole warp-step of issue (~48 instructions
// among the 8 warps of a scheduler), ~245 ns a step.  A cluster of thread
// blocks publishing rows to each other by distributed shared memory measured
// 3x slower: each cluster-scope release is a GPU-wide memory barrier.
//
// Panels and outer (`fw_panels_kernel`, `fw_outer_kernel`) are min-plus
// products of fixed operands, cut so that one matrix of N = 1,024 fills the
// card's 132 SMs evenly: 392 outer thread blocks of 32 x 64 (3 an SM) and
// 224 panel strips of 128 x 16 or 16 x 128 (2 an SM), 128 threads of 4 x 4
// running minima each.  A thread block stages its operands whole, as they
// lie, by cp.async, then runs its 128 k from shared memory; the rows it
// reads together are 4 banks apart, so the staging needs no transpose and
// no read meets a bank conflict.  (Staging in four 32-deep groups, each
// consumed as it lands, measured no faster on the outer phase and 2x slower
// on the panels.)
//
// In place without races: row k and column k do not change at step k,
// because the diagonal is 0 (d[i][k] + d[k][k] is never smaller than
// d[i][k]), so a row published before step k is the one FW reads during it,
// and d[i][k] is the same before and after the step.  A row-panel thread
// block owns all 128 rows of its columns and a column-panel thread block
// all 128 columns of its rows, so the part of the old block it reads is
// written by no other thread block, and it writes only after its last read;
// the outer phase reads the panels, which it never writes.
//
// Exactness: every candidate is one correctly rounded add and min is exact,
// so each phase's result does not depend on the order of k, and the whole is
// bit-identical to the plain version `ops/minplus.py:blocked_fw_plain`,
// which follows the same schedule (the tile is part of the result: 64 or N
// gives other bits).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;        // pivot block edge, the TPU kernel's `_LANE`
constexpr int kOp = 128;       // threads of a panel / outer thread block, 4 x 4 outputs each
constexpr int kLd = kT + 4;    // row stride of a staged A operand: rows 4 banks apart
constexpr int kStrip = 16;     // a panel thread block's strip: 128 x 16 or 16 x 128
constexpr int kOuterM = 32;    // an outer thread block's sub-tile: 32 x 64
constexpr int kOuterN = 64;

constexpr int kW = 32;         // pivot warps; warp w owns rows w + kW r
constexpr int kRows = kT / kW;          // rows a pivot warp owns
static_assert(kT % kW == 0 && kW % 4 == 0 && kW >= 4 && kW <= 32,
              "the pivot takes 4 to 32 warps, a multiple of 4");
// the pivot's shared memory: one published copy of each row, then a
// readiness barrier per row
constexpr size_t kPivotSmem = kT * kT * sizeof(float) + kT * sizeof(uint64_t);
// a TM x TN product's shared memory: A (TM x 128, padded rows), then B (128 x TN)
constexpr size_t strip_smem(int tm, int tn) { return (tm * kLd + kT * tn) * sizeof(float); }
constexpr size_t kPanelSmem = strip_smem(kT, kStrip) > strip_smem(kStrip, kT)
                                  ? strip_smem(kT, kStrip) : strip_smem(kStrip, kT);
constexpr size_t kOuterSmem = strip_smem(kOuterM, kOuterN);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n cp.async.wait_group 0;" ::: "memory");
}

// acquire: returns once phase 0 of `bar` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  } while (!done);
}

// The owner's publication of a lane's 4 values of row p into `dst` (in slot
// p), then its arrival on barrier p (a release: the store is visible to a
// waiter that sees the phase complete), both predicated on `own`.
__device__ __forceinline__ void publish_if(bool own, float4* dst, uint64_t* bar,
                                           const float (&e)[4]) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
      " @p st.shared.v4.f32 [%1], {%2, %3, %4, %5};\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%6];\n}\n"
      ::"r"(static_cast<int>(own)), "r"(smem_addr(dst)), "f"(e[0]), "f"(e[1]), "f"(e[2]),
      "f"(e[3]), "r"(smem_addr(bar)) : "memory");
}

// Sequential FW over the 128 steps of pivot block kk of matrix blockIdx.x,
// with no block-wide barrier inside the steps.  Warp w holds rows w + kW r,
// r < kRows, lane l columns 4 l .. 4 l + 3 of each, in registers.  Step k
// needs, per row i, d[i][k] (the warp's own: a shuffle from lane k / 4,
// register k % 4) and row k as it stood after step k - 1, which its owner
// stored into slot k of shared memory and announced on barrier k (32
// arrivals, one per lane).  Each slot is written once per launch, so a
// reader is never overwritten, and a warp waits only for the row it needs:
// warps run ahead of one another as far as the rows allow.  The owner of
// row k + 1 updates that row first and publishes it, then its other rows,
// so the chain from step to step is one wait, one shared load, a shuffle,
// 8 FP instructions, one shared store and an arrival.  The 128 steps are
// unrolled, so that no step computes an index.
__global__ void __launch_bounds__(kW * 32, 1)
fw_pivot_kernel(float* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) unsigned char pivot_smem[];
  float4 (*slot)[kT / 4] = reinterpret_cast<float4 (*)[kT / 4]>(pivot_smem);
  uint64_t* ready = reinterpret_cast<uint64_t*>(pivot_smem + kT * kT * sizeof(float));
  float* D = d + static_cast<size_t>(blockIdx.x) * N * N
             + static_cast<size_t>(kk) * kT * N + static_cast<size_t>(kk) * kT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < kT) bar_init(&ready[threadIdx.x], 32);
  float e[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 v =
        *reinterpret_cast<const float4*>(&D[static_cast<size_t>(w + kW * r) * N + 4 * lane]);
    e[r][0] = v.x, e[r][1] = v.y, e[r][2] = v.z, e[r][3] = v.w;
  }
  __syncthreads();  // the barriers are initialised
  publish_if(w == 0, &slot[0][lane], &ready[0], e[0]);  // row 0 as it is
  // every step unrolled: each register index, lane and slot is static
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    bar_wait(&ready[k]);
    const float4 b4 = slot[k][lane];
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = __shfl_sync(0xffffffffu, e[r][k % 4], k / 4);
    // row k + 1 is local row pr of warp (k + 1) % kW: every warp updates
    // its row pr first, and that warp publishes it
    const int pr = (k + 1) / kW % kRows;
#pragma unroll
    for (int c = 0; c < 4; ++c) e[pr][c] = fminf(e[pr][c], a[pr] + b[c]);
    if (k + 1 < kT) publish_if(w == (k + 1) % kW, &slot[k + 1][lane], &ready[k + 1], e[pr]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r != pr)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[r][c] = fminf(e[r][c], a[r] + b[c]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<float4*>(&D[static_cast<size_t>(w + kW * r) * N + 4 * lane]) =
        make_float4(e[r][0], e[r][1], e[r][2], e[r][3]);
}

// One TM x TN sub-tile C: C = min(C, A (x) B), A the TM x 128 rows beside
// it in the pivot column, B the 128 x TN columns above or below it in the
// pivot row; every operand has row stride N.  A and B are staged whole in
// shared memory by 16-byte cp.async, as they lie (A's rows padded to 132
// floats, so that the rows a warp reads at once start 4 banks apart: no
// transpose, no bank conflict), before C is read or written (in a panel C
// is A or B itself, so no pointer here is restrict).  Thread (ty, tx) keeps
// the running minima of rows ty + TM / 4 r, columns 4 tx .. 4 tx + 3, and
// takes 4 k at a time: 4 float4 of A, 4 of B, 64 candidates.
template <int TM, int TN>
__device__ __forceinline__ void minplus_strip(const float* A, const float* B, float* C, int N,
                                              float* smem) {
  constexpr int kTx = TN / 4, kTy = TM / 4;
  static_assert(kTx * kTy == kOp, "one 4 x 4 tile per thread");
  float* As = smem;             // As[i * kLd + k] = A[i][k]
  float* Bs = smem + TM * kLd;  // Bs[k * TN + j] = B[k][j]
  const int tid = threadIdx.x;
  for (int v = tid; v < TM * kT / 4; v += kOp) {
    const int i = v / (kT / 4), c = v % (kT / 4);
    cp_async16(&As[i * kLd + 4 * c], &A[static_cast<size_t>(i) * N + 4 * c]);
  }
  for (int v = tid; v < kT * TN / 4; v += kOp) {
    const int k = v / (TN / 4), c = v % (TN / 4);
    cp_async16(&Bs[k * TN + 4 * c], &B[static_cast<size_t>(k) * N + 4 * c]);
  }
  cp_async_wait_all();
  __syncthreads();
  const int tx = tid % kTx, ty = tid / kTx;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = CUDART_INF_F;
#pragma unroll 4
  for (int k0 = 0; k0 < kT; k0 += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(&As[(ty + kTy * r) * kLd + k0]);
      a[r][0] = v.x, a[r][1] = v.y, a[r][2] = v.z, a[r][3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(&Bs[(k0 + s) * TN + 4 * tx]);
      b[s][0] = v.x, b[s][1] = v.y, b[s][2] = v.z, b[s][3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fminf(acc[r][c], a[r][s] + b[s][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float4* out = reinterpret_cast<float4*>(&C[static_cast<size_t>(ty + kTy * r) * N + 4 * tx]);
    float4 o = *out;
    o.x = fminf(o.x, acc[r][0]), o.y = fminf(o.y, acc[r][1]);
    o.z = fminf(o.z, acc[r][2]), o.w = fminf(o.w, acc[r][3]);
    *out = o;
  }
}

__device__ __forceinline__ int skip_pivot(int b, int kk) { return b < kk ? b : b + 1; }

// Thread blocks [0, h) take a 128 x 16 strip of a row-panel block, [h, 2 h)
// a 16 x 128 strip of a column-panel block, h = (N / 128 - 1) * 8.
__global__ void __launch_bounds__(kOp)
fw_panels_kernel(float* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) float panel_smem[];
  constexpr int kSub = kT / kStrip;
  const int h = (N / kT - 1) * kSub;
  float* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const float* P = M + static_cast<size_t>(kk) * kT * N + kk * kT;
  int t = blockIdx.x;
  if (t < h) {
    const int j0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    float* C = M + static_cast<size_t>(kk) * kT * N + j0;
    minplus_strip<kT, kStrip>(P, C, C, N, panel_smem);
  } else {
    t -= h;
    const int i0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    float* C = M + static_cast<size_t>(i0) * N + kk * kT;
    minplus_strip<kStrip, kT>(C, P, C, N, panel_smem);
  }
}

// Thread block t takes a 32 x 64 eighth of an off-pivot block.
__global__ void __launch_bounds__(kOp)
fw_outer_kernel(float* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) float outer_smem[];
  constexpr int kQn = kT / kOuterN, kQ = (kT / kOuterM) * kQn;
  const int skip = N / kT - 1;
  float* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const int q = blockIdx.x % kQ, t = blockIdx.x / kQ;
  const int i0 = skip_pivot(t / skip, kk) * kT + (q / kQn) * kOuterM;
  const int j0 = skip_pivot(t % skip, kk) * kT + (q % kQn) * kOuterN;
  minplus_strip<kOuterM, kOuterN>(M + static_cast<size_t>(i0) * N + kk * kT,
                                  M + static_cast<size_t>(kk) * kT * N + j0,
                                  M + static_cast<size_t>(i0) * N + j0, N, outer_smem);
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
  if ((err = cudaFuncSetAttribute(fw_pivot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kPivotSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fw_panels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kPanelSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fw_outer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kOuterSmem))) != cudaSuccess)
    return static_cast<int>(err);
  for (int kk = 0; kk < nb; ++kk) {
    fw_pivot_kernel<<<B, kW * 32, kPivotSmem, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (skip == 0) continue;
    fw_panels_kernel<<<dim3(2 * skip * (kT / kStrip), B), kOp, kPanelSmem, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fw_outer_kernel<<<dim3(skip * skip * (kT / kOuterM) * (kT / kOuterN), B), kOp, kOuterSmem,
                      st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
