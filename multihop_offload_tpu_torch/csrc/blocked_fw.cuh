// K3's body: exact all-pairs shortest paths of a batch of (N, N) distance
// matrices by blocked Floyd-Warshall on 128 x 128 pivot blocks, in place,
// templated on the element type: float32 (`blocked_fw.cu`) and bf16
// (`blocked_fw_bf16.cu`, every candidate rounded to bf16 as a bf16 FW
// rounds it; `minplus_elem.cuh` says why packed bf16x2 arithmetic gives
// those bits).
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// blocked_fw_call` (`_pivot_kernel`, `_panel_kernel`, `_outer_kernel`), on
// both legs of the precision policy (a bf16 decision path whose padded N is
// in (256, 2048] narrows W to bf16 before it, `precision.py:wrap_apsp`).
// For each pivot block kk the launcher issues three launches on one stream,
// no host sync, so 3 N / 128 launches per call:
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
// one sweep makes N^3 candidates per matrix, an add and a min each: 2 N^3
// operations.  In float32 they are CUDA-core instructions (FADD, then
// FMNMX) at 33.5e12 a second, 64.1 us at N = 1,024, against 8 N^2 bytes
// (2.5 us); in bf16 a packed `__hadd2` and `__hmin2` take two candidates
// each, at the bf16x2 rate of 67e12 operations a second, 32.05 us, against
// 4 N^2 bytes.  The pivot cannot spread: its 128 steps are a chain (step k
// reads row k as step k - 1 left it), run on one SM per matrix.
//
// The pivot (`fw_pivot_kernel`) has no block-wide barrier inside its steps.
// 32 warps own 4 rows each in registers, a lane 4 columns of each (a run: 4
// floats, or 2 bf16 pairs); row k, once step k - 1 has updated it, is
// published once into its own slot of shared memory (128 slots of 512 bytes
// in float32, 256 in bf16) and announced on its own mbarrier, and each warp
// waits only for the row the step needs, so warps run ahead of one another.
// A step of a row is a shuffle of d[i][k] from the lane that holds it, then
// 4 adds and 4 mins in float32, or in bf16 one broadcast of the shuffled
// pair's half and 2 `__hadd2` and 2 `__hmin2`, with no conversion: the bf16
// chain from step to step is one packed add and one packed min deep, where
// widening to fp32 would add a rounding to bf16 and back to every link
// (each candidate of the sequential closure must be a bf16 before the next
// step reads it).  Its floor under this design is the chain, ~130 ns a step
// in float32 (wait, shared load, shuffle, add, min, store, arrival), ~130
// us of the 1,024 steps at N = 1,024; SASS shows each link instead waiting
// for about a whole warp-step of issue (~48 instructions among the 8 warps
// of a scheduler), ~245 ns a step.  A cluster of thread blocks publishing
// rows to each other by distributed shared memory measured 3x slower: each
// cluster-scope release is a GPU-wide memory barrier.
//
// Panels and outer (`fw_panels_kernel`, `fw_outer_kernel`) are min-plus
// products of fixed operands, cut so that one matrix of N = 1,024 fills the
// card's 132 SMs evenly: 392 outer thread blocks of 32 x 64 (3 an SM) and
// 224 panel strips of 128 x 16 or 16 x 128 (2 an SM), 128 threads of 4 x 4
// running minima each (in bf16 4 rows of 2 pairs).  A thread block stages
// its operands whole, as they lie and in the element type, by 16-byte
// cp.async, then runs its 128 k from shared memory; the rows it reads
// together are 4 banks apart, so the staging needs no transpose and no read
// meets a bank conflict.  (Staging in four 32-deep groups, each consumed as
// it lands, measured no faster on the outer phase and 2x slower on the
// panels in float32.)  Results are stored with no rounding step: in bf16
// every candidate is a bf16 already.
//
// In place without races: row k and column k do not change at step k,
// because the diagonal is 0 (d[i][k] + d[k][k] is never smaller than
// d[i][k], and rounds to it in bf16), so a row published before step k is
// the one FW reads during it, and d[i][k] is the same before and after the
// step.  A row-panel thread block owns all 128 rows of its columns and a
// column-panel thread block all 128 columns of its rows, so the part of the
// old block it reads is written by no other thread block, and it writes
// only after its last read; the outer phase reads the panels, which it
// never writes.
//
// Exactness: every candidate is one correctly rounded add and min is exact,
// so each phase's result does not depend on the order of k, and the whole is
// bit-identical to the plain version `ops/minplus.py:blocked_fw_plain`,
// which follows the same schedule (the tile is part of the result: 64 or N
// gives other bits).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "minplus_elem.cuh"

namespace {

constexpr int kT = 128;        // pivot block edge, the TPU kernel's `_LANE`
constexpr int kOp = 128;       // threads of a panel / outer thread block, 4 x 4 outputs each
constexpr int kStrip = 16;     // a panel thread block's strip: 128 x 16 or 16 x 128
constexpr int kOuterM = 32;    // an outer thread block's sub-tile: 32 x 64
constexpr int kOuterN = 64;

constexpr int kW = 32;         // pivot warps; warp w owns rows w + kW r
constexpr int kRows = kT / kW;          // rows a pivot warp owns
static_assert(kT % kW == 0 && kW % 4 == 0 && kW >= 4 && kW <= 32,
              "the pivot takes 4 to 32 warps, a multiple of 4");

// elements of a 16-byte copy; a staged A operand's row stride, kT + kV:
// rows 16 bytes (4 banks) apart
template <class E>
constexpr int kV = 16 / static_cast<int>(sizeof(E));
template <class E>
constexpr int kLd = kT + kV<E>;
// the pivot's shared memory: one published copy of each row, then a
// readiness barrier per row
template <class E>
constexpr size_t kPivotSmem = kT * kT * sizeof(E) + kT * sizeof(uint64_t);
// a TM x TN product's shared memory: A (TM x 128, padded rows), then B (128 x TN)
template <class E>
constexpr size_t strip_smem(int tm, int tn) {
  return (tm * kLd<E> + kT * tn) * sizeof(E);
}
template <class E>
constexpr size_t kPanelSmem = strip_smem<E>(kT, kStrip) > strip_smem<E>(kStrip, kT)
                                  ? strip_smem<E>(kT, kStrip) : strip_smem<E>(kStrip, kT);
template <class E>
constexpr size_t kOuterSmem = strip_smem<E>(kOuterM, kOuterN);

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

// The owner's publication of a lane's run of row p into `dst` (in slot p),
// then its arrival on barrier p (a release: the store is visible to a
// waiter that sees the phase complete), both predicated on `own`.
template <class E>
__device__ __forceinline__ void publish_if(bool own, E* dst, uint64_t* bar, const Run<E>& e) {
  if constexpr (kIsBf16<E>) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
        " @p st.shared.v2.b32 [%1], {%2, %3};\n"
        " @p mbarrier.arrive.shared::cta.b64 _, [%4];\n}\n"
        ::"r"(static_cast<int>(own)), "r"(smem_addr(dst)), "r"(as_u32(e.v[0])),
        "r"(as_u32(e.v[1])), "r"(smem_addr(bar)) : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
        " @p st.shared.v4.f32 [%1], {%2, %3, %4, %5};\n"
        " @p mbarrier.arrive.shared::cta.b64 _, [%6];\n}\n"
        ::"r"(static_cast<int>(own)), "r"(smem_addr(dst)), "f"(e.v[0]), "f"(e.v[1]),
        "f"(e.v[2]), "f"(e.v[3]), "r"(smem_addr(bar)) : "memory");
  }
}

// d[i][k] of the warp's row i whose run `e` lane l holds, from lane k / 4,
// broadcast: a float, or the bf16 pair holding column k, shuffled, with
// k's half in both halves
template <class E>
__device__ __forceinline__ Bc<E> column(const Run<E>& e, int k) {
  if constexpr (kIsBf16<E>) {
    const bf162 w = __shfl_sync(0xffffffffu, e.v[(k % 4) / 2], k / 4);
    return (k & 1) ? __high2bfloat162(w) : __low2bfloat162(w);
  } else {
    return __shfl_sync(0xffffffffu, e.v[k % 4], k / 4);
  }
}

// Sequential FW over the 128 steps of pivot block kk of matrix blockIdx.x,
// with no block-wide barrier inside the steps.  Warp w holds rows w + kW r,
// r < kRows, lane l columns 4 l .. 4 l + 3 of each, in registers.  Step k
// needs, per row i, d[i][k] (the warp's own: a shuffle from lane k / 4) and
// row k as it stood after step k - 1, which its owner stored into slot k of
// shared memory and announced on barrier k (32 arrivals, one per lane).
// Each slot is written once per launch, so a reader is never overwritten,
// and a warp waits only for the row it needs: warps run ahead of one
// another as far as the rows allow.  The owner of row k + 1 updates that
// row first and publishes it, then its other rows, so the chain from step
// to step is one wait, one shared load, a shuffle, the row's adds and mins
// (8 FP instructions in float32, 4 packed in bf16), one shared store and an
// arrival.  The 128 steps are unrolled, so that no step computes an index.
template <class E>
__global__ void __launch_bounds__(kW * 32, 1)
fw_pivot_kernel(E* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) unsigned char pivot_smem[];
  E (*slot)[kT] = reinterpret_cast<E (*)[kT]>(pivot_smem);
  uint64_t* ready = reinterpret_cast<uint64_t*>(pivot_smem + kT * kT * sizeof(E));
  E* D = d + static_cast<size_t>(blockIdx.x) * N * N
         + static_cast<size_t>(kk) * kT * N + static_cast<size_t>(kk) * kT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < kT) bar_init(&ready[threadIdx.x], 32);
  Run<E> e[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    e[r] = load_run(&D[static_cast<size_t>(w + kW * r) * N + 4 * lane]);
  __syncthreads();  // the barriers are initialised
  publish_if(w == 0, &slot[0][4 * lane], &ready[0], e[0]);  // row 0 as it is
  // every step unrolled: each register index, lane and slot is static
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    bar_wait(&ready[k]);
    const Run<E> b = load_run(&slot[k][4 * lane]);
    Bc<E> a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = column(e[r], k);
    // row k + 1 is local row pr of warp (k + 1) % kW: every warp updates
    // its row pr first, and that warp publishes it
    const int pr = (k + 1) / kW % kRows;
    relax(e[pr], a[pr], b);
    if (k + 1 < kT)
      publish_if(w == (k + 1) % kW, &slot[k + 1][4 * lane], &ready[k + 1], e[pr]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r != pr) relax(e[r], a[r], b);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    store_run(&D[static_cast<size_t>(w + kW * r) * N + 4 * lane], e[r]);
}

// One TM x TN sub-tile C: C = min(C, A (x) B), A the TM x 128 rows beside
// it in the pivot column, B the 128 x TN columns above or below it in the
// pivot row; every operand has row stride N.  A and B are staged whole in
// shared memory by 16-byte cp.async, as they lie (A's rows padded by 16
// bytes, so that the rows a warp reads at once start 4 banks apart: no
// transpose, no bank conflict), before C is read or written (in a panel C
// is A or B itself, so no pointer here is restrict).  Thread (ty, tx) keeps
// the running minima of rows ty + TM / 4 r, columns 4 tx .. 4 tx + 3, and
// takes 4 k at a time: 4 runs of A, 4 of B, 64 candidates.
template <class E, int TM, int TN>
__device__ __forceinline__ void minplus_strip(const E* A, const E* B, E* C, int N, E* smem) {
  constexpr int kTx = TN / 4, kTy = TM / 4, V = kV<E>, Ld = kLd<E>;
  static_assert(kTx * kTy == kOp, "one 4 x 4 tile per thread");
  E* As = smem;            // As[i * Ld + k] = A[i][k]
  E* Bs = smem + TM * Ld;  // Bs[k * TN + j] = B[k][j]
  const int tid = threadIdx.x;
  for (int v = tid; v < TM * kT / V; v += kOp) {
    const int i = v / (kT / V), c = v % (kT / V);
    cp_async16(&As[i * Ld + V * c], &A[static_cast<size_t>(i) * N + V * c]);
  }
  for (int v = tid; v < kT * TN / V; v += kOp) {
    const int k = v / (TN / V), c = v % (TN / V);
    cp_async16(&Bs[k * TN + V * c], &B[static_cast<size_t>(k) * N + V * c]);
  }
  cp_async_wait_all();
  __syncthreads();
  const int tx = tid % kTx, ty = tid / kTx;
  Run<E> acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = inf_run<E>();
#pragma unroll 4
  for (int k0 = 0; k0 < kT; k0 += 4) {
    Run<E> a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = load_run(&As[(ty + kTy * r) * Ld + k0]);
#pragma unroll
    for (int s = 0; s < 4; ++s) b[s] = load_run(&Bs[(k0 + s) * TN + 4 * tx]);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) relax(acc[r], bcast(a[r], s), b[s]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    E* out = &C[static_cast<size_t>(ty + kTy * r) * N + 4 * tx];
    Run<E> o = load_run(out);
    meet(o, acc[r]);
    store_run(out, o);
  }
}

__device__ __forceinline__ int skip_pivot(int b, int kk) { return b < kk ? b : b + 1; }

// Thread blocks [0, h) take a 128 x 16 strip of a row-panel block, [h, 2 h)
// a 16 x 128 strip of a column-panel block, h = (N / 128 - 1) * 8.
template <class E>
__global__ void __launch_bounds__(kOp)
fw_panels_kernel(E* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) unsigned char panel_smem[];
  constexpr int kSub = kT / kStrip;
  const int h = (N / kT - 1) * kSub;
  E* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const E* P = M + static_cast<size_t>(kk) * kT * N + kk * kT;
  E* smem = reinterpret_cast<E*>(panel_smem);
  int t = blockIdx.x;
  if (t < h) {
    const int j0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    E* C = M + static_cast<size_t>(kk) * kT * N + j0;
    minplus_strip<E, kT, kStrip>(P, C, C, N, smem);
  } else {
    t -= h;
    const int i0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    E* C = M + static_cast<size_t>(i0) * N + kk * kT;
    minplus_strip<E, kStrip, kT>(C, P, C, N, smem);
  }
}

// Thread block t takes a 32 x 64 eighth of an off-pivot block.
template <class E>
__global__ void __launch_bounds__(kOp)
fw_outer_kernel(E* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) unsigned char outer_smem[];
  constexpr int kQn = kT / kOuterN, kQ = (kT / kOuterM) * kQn;
  const int skip = N / kT - 1;
  E* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const int q = blockIdx.x % kQ, t = blockIdx.x / kQ;
  const int i0 = skip_pivot(t / skip, kk) * kT + (q / kQn) * kOuterM;
  const int j0 = skip_pivot(t % skip, kk) * kT + (q % kQn) * kOuterN;
  minplus_strip<E, kOuterM, kOuterN>(M + static_cast<size_t>(i0) * N + kk * kT,
                                     M + static_cast<size_t>(kk) * kT * N + j0,
                                     M + static_cast<size_t>(i0) * N + j0, N,
                                     reinterpret_cast<E*>(outer_smem));
}

// Runs the whole sweep on `stream`: for each of the N / 128 pivot blocks,
// the pivot, panels and outer launches (only the pivot when N = 128).  d
// (B, N, N) E contiguous and 16-byte aligned, N a multiple of 128, updated
// in place.  Returns the first cudaError_t (0 = success).
template <class E>
int blocked_fw(void* d, int B, int N, void* stream) {
  E* dd = static_cast<E*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = N / kT, skip = nb - 1;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(fw_pivot_kernel<E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kPivotSmem<E>))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fw_panels_kernel<E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kPanelSmem<E>))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fw_outer_kernel<E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kOuterSmem<E>))) != cudaSuccess)
    return static_cast<int>(err);
  for (int kk = 0; kk < nb; ++kk) {
    fw_pivot_kernel<E><<<B, kW * 32, kPivotSmem<E>, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (skip == 0) continue;
    fw_panels_kernel<E><<<dim3(2 * skip * (kT / kStrip), B), kOp, kPanelSmem<E>, st>>>(dd, N,
                                                                                     kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    fw_outer_kernel<E><<<dim3(skip * skip * (kT / kOuterM) * (kT / kOuterN), B), kOp,
                         kOuterSmem<E>, st>>>(dd, N, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace
