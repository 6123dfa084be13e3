// Exact all-pairs shortest paths of a batch of (N, N) bf16 distance
// matrices by blocked Floyd-Warshall on 128 x 128 pivot blocks, in place.
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// blocked_fw_call` (`_pivot_kernel`, `_panel_kernel`, `_outer_kernel`) on
// the bf16 leg of the precision policy: a decision path under bf16 whose
// padded N is in (256, 2048] narrows W to bf16 before the blocked FW
// (`precision.py:wrap_apsp`), and the TPU kernel then runs on bf16 tiles.
// The schedule, the launches (pivot, panels, outer for each pivot block:
// 3 N / 128 a call, no host sync), the thread-block shapes and the in-place
// argument are those of the float32 kernel `csrc/blocked_fw.cu`, whose
// source note holds; what differs is the element and where it is rounded.
//
// Tiles are widened to fp32 as they are read (every bf16 is an fp32) and
// rounded to bf16 as they are stored, the rounding where the plain version
// `ops/minplus.py:blocked_fw_plain` rounds on bf16 input:
//
//   - pivot (`_fw_close`, JAX `:139-146`): each step's candidate d[i][k] +
//     d[k][j] is rounded to bf16 before the min, because the closure is
//     sequential and in place: step k + 1 reads what step k left, so one
//     rounding at the store would change the values it reads;
//   - panels and outer (`_minplus_acc`, `:148-153`): the candidates are
//     summed and minimised in fp32 and the result rounded once, on the
//     store.  Rounding is monotone, so the min of the rounded candidates is
//     the rounding of their min, and the old entry, a bf16, passes through.
//
// Each candidate is an fp32 add of two bf16 values, within 2^-24 of the
// exact sum, far inside half a bf16 ulp, so rounding it to bf16 gives the
// one correct rounding of the CPU's bf16 add: the kernel is bit-identical
// to the plain version in bf16.  The operands are staged by 8-byte loads
// (4 bf16) widened into the float32 kernel's shared-memory layout, in
// place of its 16-byte cp.async.
//
// What bounds it on an H100: operations, as in float32: one sweep makes
// N^3 candidates per matrix, an add and a min each, 2 N^3 in all, here on
// the fp32 path (64.1 us at N = 1,024; on the card's packed bf16x2 path,
// which this kernel does not use, 32.05 us), against 4 N^2 bytes of
// traffic.  The pivot's chain holds one more instruction a step (the
// rounding) than in float32.  In place without races for the reasons the
// float32 note gives: the zero diagonal keeps row k and column k fixed at
// step k (d[i][k] + 0 rounds to d[i][k]), and each panel and outer thread
// block reads all it reads before it writes.

#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// 4 bf16 at p (8-byte aligned) widened to fp32, exactly
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// 4 fp32 rounded to bf16 and stored at p (8-byte aligned)
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(a)) |
                      (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
  const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(c)) |
                      (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(d))) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
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
fw_pivot_kernel(bf16* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) unsigned char pivot_smem[];
  float4 (*slot)[kT / 4] = reinterpret_cast<float4 (*)[kT / 4]>(pivot_smem);
  uint64_t* ready = reinterpret_cast<uint64_t*>(pivot_smem + kT * kT * sizeof(float));
  bf16* D = d + static_cast<size_t>(blockIdx.x) * N * N
             + static_cast<size_t>(kk) * kT * N + static_cast<size_t>(kk) * kT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < kT) bar_init(&ready[threadIdx.x], 32);
  float e[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 v = load4(&D[static_cast<size_t>(w + kW * r) * N + 4 * lane]);
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
    for (int c = 0; c < 4; ++c) e[pr][c] = fminf(e[pr][c], round_bf16(__fadd_rn(a[pr], b[c])));
    if (k + 1 < kT) publish_if(w == (k + 1) % kW, &slot[k + 1][lane], &ready[k + 1], e[pr]);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r != pr)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[r][c] = fminf(e[r][c], round_bf16(__fadd_rn(a[r], b[c])));
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    store4(&D[static_cast<size_t>(w + kW * r) * N + 4 * lane], e[r][0], e[r][1], e[r][2],
           e[r][3]);  // exact: every value is a bf16
}

// One TM x TN sub-tile C: C = min(C, A (x) B), A the TM x 128 rows beside
// it in the pivot column, B the 128 x TN columns above or below it in the
// pivot row; every operand has row stride N.  A and B are staged whole in
// shared memory, widened to fp32 from 8-byte loads, as they lie (A's rows padded to 132
// floats, so that the rows a warp reads at once start 4 banks apart: no
// transpose, no bank conflict), before C is read or written (in a panel C
// is A or B itself, so no pointer here is restrict).  Thread (ty, tx) keeps
// the running minima of rows ty + TM / 4 r, columns 4 tx .. 4 tx + 3, and
// takes 4 k at a time: 4 float4 of A, 4 of B, 64 candidates.
template <int TM, int TN>
__device__ __forceinline__ void minplus_strip(const bf16* A, const bf16* B, bf16* C, int N,
                                              float* smem) {
  constexpr int kTx = TN / 4, kTy = TM / 4;
  static_assert(kTx * kTy == kOp, "one 4 x 4 tile per thread");
  float* As = smem;             // As[i * kLd + k] = A[i][k]
  float* Bs = smem + TM * kLd;  // Bs[k * TN + j] = B[k][j]
  const int tid = threadIdx.x;
  for (int v = tid; v < TM * kT / 4; v += kOp) {
    const int i = v / (kT / 4), c = v % (kT / 4);
    *reinterpret_cast<float4*>(&As[i * kLd + 4 * c]) =
        load4(&A[static_cast<size_t>(i) * N + 4 * c]);
  }
  for (int v = tid; v < kT * TN / 4; v += kOp) {
    const int k = v / (TN / 4), c = v % (TN / 4);
    *reinterpret_cast<float4*>(&Bs[k * TN + 4 * c]) =
        load4(&B[static_cast<size_t>(k) * N + 4 * c]);
  }
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
    bf16* out = &C[static_cast<size_t>(ty + kTy * r) * N + 4 * tx];
    const float4 o = load4(out);
    // one rounding, on the store: min(c, round(m)) = round(min(c, m)) for a bf16 c
    store4(out, fminf(o.x, acc[r][0]), fminf(o.y, acc[r][1]), fminf(o.z, acc[r][2]),
           fminf(o.w, acc[r][3]));
  }
}

__device__ __forceinline__ int skip_pivot(int b, int kk) { return b < kk ? b : b + 1; }

// Thread blocks [0, h) take a 128 x 16 strip of a row-panel block, [h, 2 h)
// a 16 x 128 strip of a column-panel block, h = (N / 128 - 1) * 8.
__global__ void __launch_bounds__(kOp)
fw_panels_kernel(bf16* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) float panel_smem[];
  constexpr int kSub = kT / kStrip;
  const int h = (N / kT - 1) * kSub;
  bf16* M = d + static_cast<size_t>(blockIdx.y) * N * N;
  const bf16* P = M + static_cast<size_t>(kk) * kT * N + kk * kT;
  int t = blockIdx.x;
  if (t < h) {
    const int j0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    bf16* C = M + static_cast<size_t>(kk) * kT * N + j0;
    minplus_strip<kT, kStrip>(P, C, C, N, panel_smem);
  } else {
    t -= h;
    const int i0 = skip_pivot(t / kSub, kk) * kT + (t % kSub) * kStrip;
    bf16* C = M + static_cast<size_t>(i0) * N + kk * kT;
    minplus_strip<kStrip, kT>(C, P, C, N, panel_smem);
  }
}

// Thread block t takes a 32 x 64 eighth of an off-pivot block.
__global__ void __launch_bounds__(kOp)
fw_outer_kernel(bf16* __restrict__ d, int N, int kk) {
  extern __shared__ __align__(16) float outer_smem[];
  constexpr int kQn = kT / kOuterN, kQ = (kT / kOuterM) * kQn;
  const int skip = N / kT - 1;
  bf16* M = d + static_cast<size_t>(blockIdx.y) * N * N;
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
// (B, N, N) bf16 contiguous and 8-byte aligned, N a multiple of 128,
// updated in place.  Returns the first cudaError_t (0 = success).
extern "C" int mho_blocked_fw_bf16(void* d, int B, int N, void* stream) {
  bf16* dd = static_cast<bf16*>(d);
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
