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
// What bounds it on an H100: issue slots.  (min, +) has no tensor-core path,
// and Hopper's DPX add-min is for integers only, so each candidate costs two
// CUDA-core fp32 instructions (FADD, then FMNMX, which runs on the half-rate
// ALU pipe), not one FMA: a squaring is 2 * N^3 instructions per matrix at
// the card's fp32 issue rate, against only 8 * N^2 bytes of traffic.  Every
// other instruction (shared loads, addresses, the loop) takes a slot from
// them, and so does a warp stalled on a load.
//
// What the design does about it:
//   - Tiles cut to N.  The launcher picks a tile plan from (B, N): 8 x TN
//     strips with TN = N rounded up to 8 for N <= 64; 56 x 56 (or 56 x 28
//     where the batch gives fewer than 1.5 tiles an SM) up to N = 112; 64 x
//     64 (or 64 x 32) above.  The k loop runs to exactly N, so no candidate
//     is computed for k >= N.  At the paths' N (37, 56, 112, 256, 1024) the
//     tiles cover N to the granule of 8, and the grid is at most one wave of
//     resident blocks or several.
//   - A block is G k-groups of TY x TX threads (160-256 threads).  Each
//     thread keeps RM x RN running minima (rows ty + TY r, columns in
//     float4 runs 4 (tx + TX c)) over the 4-step k-chunks of its group
//     (chunk q goes to group q mod G); a thread reads the row panel as one
//     float4 along k per row and the column panel as float4s along j, so a
//     chunk's RM + RN shared loads feed 8 RM RN ALU instructions.  After
//     the k loop each group's minima go to shared memory, and every thread
//     meets the groups' minima and the old value over float4 runs of the
//     tile and stores them.
//   - Nothing is staged through registers.  The slices of the row panel
//     (rows along k, pitch KS + 4, so the rows a warp reads fall in
//     distinct banks) and of the column panel, and with the last slice the
//     tile's old values, come in a ring of ST stages, one barrier a slice:
//     on the 56 x 56 and 64-row plans by tensor copies where N % 4 == 0
//     (three tensor maps a launch; a box an operand, 4 columns wider than
//     the data so that it lands at the padded pitch; thread 0 issues them
//     on one mbarrier a stage), which keep the load queue free for the
//     shared loads; otherwise by every thread's cp.async (16 bytes where
//     N % 4 == 0, 4 elsewhere), which is faster on the strips and 56 x 28.
//   - Shared memory is dynamic (up to ~71 KB a block, two blocks an SM);
//     the launcher raises the limit with cudaFuncSetAttribute and returns
//     its error, as it does a refused tensor map, so either raises in the
//     wrapper.
// No symmetry is assumed.  Every candidate is one correctly rounded add and
// min is exact, so the result is bit-identical to the plain version
// whatever the tiling or the order of k.
//
// Early stop without a host sync: block (., ., b) of squaring `step` sets
// flags[step * B + b] when its tile changed.  Squaring `step` of matrix b
// runs only if squaring `step - 1` changed it; otherwise src == dst already
// holds for b (the previous squaring wrote dst equal to its src), so both
// ping-pong buffers hold the fixed point and the block exits at once,
// before any barrier.  The first tile of every squaring that runs adds one
// to `*executed`.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// bench-only (`scripts/bench_minplus.py --variant TAG=...:kClock=1`): thread
// 0 of every block adds its clock64 split to executed[1..7]: [1] blocks,
// [2] issuing copies, [3] the barrier and waiting for the slice, [4] the k
// loop, [5] the barrier after it, [6] the meeting of the groups' minima and
// the epilogue, [7] the block's whole time.  executed[0] stays the
// squarings run.
constexpr int kClock = 0;

// the full tile (56 x 56, 64 x 64) where the batch gives at least kFullAt / 2
// of them an SM, the half-width tile otherwise
constexpr int kFullAt = 3;

// a tile plan: TY x TX threads in each of G k-groups, RM x RN minima a
// thread, k-slices of KS in a ring of ST stages; kTensor: where N % 4 == 0
// the slices come by tensor copies (a box an operand, issued by thread 0,
// landing on an mbarrier a stage), otherwise by every thread's cp.async
template <int TY_, int RM_, int TX_, int RN_, int G_, int KS_, int ST_, bool kTensor_>
struct Plan {
  static constexpr int TY = TY_, RM = RM_, TX = TX_, RN = RN_, G = G_, KS = KS_, ST = ST_;
  static constexpr bool kTensor = kTensor_;
  static constexpr int T = G * TY * TX;            // threads
  static constexpr int TM = TY * RM, TN = TX * RN; // output tile
  static constexpr int PA = KS + 4;                // row panel pitch (floats)
  static constexpr int PB = TN + 4;                // column panel, old, partial minima
  static constexpr int SA = TM * PA, SB = KS * PB, SO = TM * PB;
  // the stages, and after the k loop the G groups' minima over them
  static constexpr int SR = ST * (SA + SB) > G * SO ? ST * (SA + SB) : G * SO;
  static constexpr int kSmemBytes = (SR + SO) * 4 + ST * 8;  // + an mbarrier a stage
  static_assert(RN % 4 == 0 && KS % (4 * G) == 0 && T % 32 == 0, "plan shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for phase `parity` of the mbarrier at `bar`.  A wait that outlasts
// ~2^26 polls (seconds) traps: a lost copy fails the launch, not hangs it.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls > (1 << 26)) __trap();
  }
}

// the tensor maps of one launch's source: boxes of the row panel's slice,
// the column panel's slice and the tile's old values, each 4 columns wider
// than the data, so that they land in shared memory at the padded pitches
struct Maps {
  CUtensorMap a, b, o;
};

// the box of `map` at (column c0, row c1, matrix c2) to shared `to`, counted
// on the mbarrier at `bar`; out-of-range entries land as 0 (never read)
__device__ __forceinline__ void tensor_copy(uint32_t to, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(to), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// One thread's share of copying a box of R rows x C columns of S (row
// stride N) to shared memory (pitch P floats) by cp.async, for boxes that
// move by whole rows or columns from slice to slice.  kVec: 16-byte copies,
// each 4-column chunk wholly in or out of range (N % 4 == 0, rows 16-byte
// aligned); otherwise 4-byte copies.  Where the T threads tile the box's
// rows evenly, a thread's copies keep one column and step T / Q rows, so
// their offsets are one multiply-add apart.
template <int R, int C, int P, int T, bool kVec>
struct Box {
  static constexpr int W = kVec ? 4 : 1;  // floats a copy
  static constexpr int Q = C / W;         // copies a row
  static constexpr int U = (R * Q + T - 1) / T;
  static constexpr bool kEven = T % Q == 0;

  // copies the part inside [0, N)^2 of rows r0 + [0, R) x columns
  // c0 + [0, C); the rest is left as it is (never read)
  __device__ __forceinline__ static void copy(float* dst, const float* __restrict__ S, int N,
                                              int r0, int c0, int tid) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int r, c;
      if constexpr (kEven) {
        r = tid / Q + u * (T / Q);
        c = tid % Q * W;
      } else {
        const int e = tid + u * T;
        r = e / Q;
        c = (e - r * Q) * W;
      }
      const int gr = r0 + r, gc = c0 + c;
      if (r < R && gr < N && gc < N) {
        const float* from = S + (gr * N + gc);
        const uint32_t to = smem_u32(dst + r * P + c);
        if constexpr (kVec)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(from));
        else
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(from));
      }
    }
  }
};

template <class P, bool kVec>
__global__ void __launch_bounds__(P::T, 2)
minplus_tile_kernel(const float* __restrict__ src, float* __restrict__ dst,
                    int* __restrict__ flags, unsigned long long* __restrict__ executed,
                    int N, int B, int step, const __grid_constant__ Maps maps) {
  constexpr int TY = P::TY, RM = P::RM, TX = P::TX, RN = P::RN, G = P::G;
  constexpr int KS = P::KS, ST = P::ST, T = P::T, TM = P::TM, TN = P::TN;
  constexpr int PA = P::PA, PB = P::PB, SA = P::SA, SB = P::SB, SO = P::SO;
  constexpr int C4 = RN / 4;
  static_assert(ST >= 2 || KS >= 64, "a single stage holds the whole k range");
  static_assert(!P::kTensor || (SA % 32 == 0 && SB % 32 == 0 && P::SR % 32 == 0),
                "tensor copies land on 128-byte boundaries");

  const int b = blockIdx.z;
  if (step > 0 && flags[(step - 1) * B + b] == 0) return;
  long long t_start = 0, t_last = 0, split[5] = {0, 0, 0, 0, 0};
  auto tick = [&](int phase) {
    if constexpr (kClock) {
      const long long now = clock64();
      split[phase] += now - t_last;
      t_last = now;
    }
  };
  if constexpr (kClock) t_last = t_start = clock64();

  extern __shared__ __align__(128) float smem[];
  float* const As = smem;                  // ST x [TM][PA]: As[i][k] = S[i0 + i][k0 + k]
  float* const Bs = smem + ST * SA;        // ST x [KS][PB]: Bs[k][j] = S[k0 + k][j0 + j]
  float* const Rs = smem;                  // G x [TM][PB]: each group's minima, after the k loop
  float* const Os = smem + P::SR;          // [TM][PB]: S[i0 + i][j0 + j]
  constexpr bool kTma = P::kTensor && kVec;
  const uint32_t bars = smem_u32(Os + SO);  // ST mbarriers, 8 bytes each

  const size_t base = static_cast<size_t>(b) * N * N;
  const float* __restrict__ S = src + base;
  const int tid = threadIdx.x;
  const int g = tid / (TY * TX);
  const int ty = tid % (TY * TX) / TX, tx = tid % TX;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const int slices = (N + KS - 1) / KS;

  // slice s's panels, and with the last slice the tile's old values: by
  // tensor copies from thread 0 (kTma), or by every thread's cp.async
  auto issue = [&](int s) {
    if constexpr (kTma) {
      if (s < slices && tid == 0) {
        const bool last = s == slices - 1;
        const uint32_t bar = bars + 8 * (s % ST);
        bar_expect(bar, 4u * (SA + SB + (last ? SO : 0)));
        tensor_copy(smem_u32(As + (s % ST) * SA), &maps.a, s * KS, i0, b, bar);
        tensor_copy(smem_u32(Bs + (s % ST) * SB), &maps.b, j0, s * KS, b, bar);
        if (last) tensor_copy(smem_u32(Os), &maps.o, j0, i0, b, bar);
      }
    } else {
      if (s < slices) {
        Box<TM, KS, PA, T, kVec>::copy(As + (s % ST) * SA, S, N, i0, s * KS, tid);
        Box<KS, TN, PB, T, kVec>::copy(Bs + (s % ST) * SB, S, N, s * KS, j0, tid);
        if (s == slices - 1) Box<TM, TN, PB, T, kVec>::copy(Os, S, N, i0, j0, tid);
      }
      cp_commit();
    }
  };
  if constexpr (kTma) {
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < ST; ++st) bar_init(bars + 8 * st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  constexpr int kAhead = ST > 1 ? ST - 1 : 1;  // slices in flight before the loop
#pragma unroll
  for (int s = 0; s < kAhead; ++s) issue(s);

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = CUDART_INF_F;

  tick(0);
  for (int s = 0; s < slices; ++s) {
    // the barrier retires slice s - 1's buffer, which issue refills; slice
    // s has landed once its mbarrier's phase turns (kTma), or once at most
    // the newer kAhead - 1 copy groups are out
    if constexpr (kTma) {
      __syncthreads();
      tick(1);
      if constexpr (ST > 1) issue(s + ST - 1);
      tick(0);
      bar_wait(bars + 8 * (s % ST), (s / ST) & 1);
      tick(1);
    } else {
      cp_wait<kAhead - 1>();
      __syncthreads();
      tick(1);
      if constexpr (ST > 1) issue(s + ST - 1);
      tick(0);
    }
    const float* A = As + (s % ST) * SA + ty * PA;
    const float* Bk = Bs + (s % ST) * SB + 4 * tx;
    const int kn = min(KS, N - s * KS);  // steps of this slice, exactly
    const int full = kn >> 2;
    for (int q = g; q < full; q += G) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        a[r] = *reinterpret_cast<const float4*>(A + r * TY * PA + 4 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float bv[RN];
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(Bk + (4 * q + e) * PB + 4 * TX * c);
          bv[4 * c] = v.x; bv[4 * c + 1] = v.y; bv[4 * c + 2] = v.z; bv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float av = e == 0 ? a[r].x : e == 1 ? a[r].y : e == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int c = 0; c < RN; ++c) acc[r][c] = fminf(acc[r][c], av + bv[c]);
        }
      }
    }
    if ((kn & 3) != 0 && full % G == g) {  // the last 1-3 steps, one at a time
      for (int k = 4 * full; k < kn; ++k) {
        float bv[RN];
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(Bk + k * PB + 4 * TX * c);
          bv[4 * c] = v.x; bv[4 * c + 1] = v.y; bv[4 * c + 2] = v.z; bv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float av = A[r * TY * PA + k];
#pragma unroll
          for (int c = 0; c < RN; ++c) acc[r][c] = fminf(acc[r][c], av + bv[c]);
        }
      }
    }
    if constexpr (kClock) {  // the minima are in registers: wait on them
      float sink = CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) sink = fminf(sink, acc[r][c]);
      asm volatile("" ::"f"(sink));
    }
    tick(2);
  }
  if constexpr (!kTma) cp_wait<0>();  // (with kTma `old` came with the last slice's phase)
  __syncthreads();  // every group is done with the stages, and `old` has landed
  tick(3);

  // each group's minima go to shared memory over the stages; then every
  // thread takes float4 runs of the tile, meets the groups' minima and the
  // old value there, and stores
  {
    float* R = Rs + g * SO + ty * PB + 4 * tx;
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < C4; ++c)
        *reinterpret_cast<float4*>(R + r * TY * PB + 4 * TX * c) =
            make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2], acc[r][4 * c + 3]);
  }
  __syncthreads();
  int changed = 0;
  constexpr int Q4 = TN / 4;
#pragma unroll
  for (int u = 0; u < (TM * Q4 + T - 1) / T; ++u) {
    const int e = tid + u * T;
    const int row = e / Q4, col = e % Q4 * 4;
    const int i = i0 + row, j = j0 + col;
    if (e < TM * Q4 && i < N && j < N) {
      float4 v = *reinterpret_cast<const float4*>(Rs + row * PB + col);
#pragma unroll
      for (int h = 1; h < G; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(Rs + h * SO + row * PB + col);
        v.x = fminf(v.x, t.x); v.y = fminf(v.y, t.y);
        v.z = fminf(v.z, t.z); v.w = fminf(v.w, t.w);
      }
      const float4 o = *reinterpret_cast<const float4*>(Os + row * PB + col);
      const float w[4] = {fminf(o.x, v.x), fminf(o.y, v.y), fminf(o.z, v.z), fminf(o.w, v.w)};
      const float old[4] = {o.x, o.y, o.z, o.w};
      float* out = dst + base + static_cast<size_t>(i) * N + j;
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(out) = make_float4(w[0], w[1], w[2], w[3]);
        changed |= (w[0] != old[0]) | (w[1] != old[1]) | (w[2] != old[2]) | (w[3] != old[3]);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (j + f < N) {
            out[f] = w[f];
            changed |= (w[f] != old[f]);
          }
        }
      }
    }
  }
  if (__syncthreads_or(changed) && tid == 0) flags[step * B + b] = 1;
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) atomicAdd(executed, 1ULL);
  if constexpr (kClock) {
    tick(4);
    if (tid == 0) {
      atomicAdd(executed + 1, 1ULL);
#pragma unroll
      for (int f = 0; f < 5; ++f)
        atomicAdd(executed + 2 + f, static_cast<unsigned long long>(split[f]));
      atomicAdd(executed + 7, static_cast<unsigned long long>(t_last - t_start));
    }
  }
}

// the plans: 8 x TN strips (N <= 64, TN = N rounded up to 8), then 56- and
// 64-row tiles, each in a full and a half width
template <int TN8>
using Strip = Plan<2, 4, 2 * TN8, 4, 8, 64, 1, false>;
using Tile56 = Plan<8, 7, 14, 4, 2, 32, 2, true>;
using Tile56x28 = Plan<8, 7, 7, 4, 4, 64, 2, false>;
using Tile64 = Plan<8, 8, 16, 4, 2, 32, 3, true>;
using Tile64x32 = Plan<8, 8, 8, 4, 4, 64, 2, true>;

struct Args {
  const float* src;
  float* dst;
  int* flags;
  unsigned long long* executed;
  int B, N, step;
  cudaStream_t stream;
};

// plan info: TM, TN, threads, k-groups, KS, stages, shared bytes, blocks
constexpr int kPlanFields = 8;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, found once through the runtime (no link
// against the driver library); null if the driver has none.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The (B, N, N) float32 matrices at `src` as a tensor map with boxes of
// `cols` x `rows` x 1; false if the driver refuses it.
bool encode(CUtensorMap* map, const float* src, int B, int N, int cols, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {4ull * N, 4ull * N * N};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(src), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P>
int run(const Args& a, int* info) {
  const dim3 grid((a.N + P::TN - 1) / P::TN, (a.N + P::TM - 1) / P::TM, a.B);
  if (info != nullptr) {
    const int v[kPlanFields] = {P::TM, P::TN, P::T, P::G, P::KS, P::ST, P::kSmemBytes,
                                static_cast<int>(grid.x * grid.y * grid.z)};
    for (int f = 0; f < kPlanFields; ++f) info[f] = v[f];
    return 0;
  }
  const bool vec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.dst) % 16 == 0;
  Maps maps{};
  if (vec && P::kTensor &&
      !(encode(&maps.a, a.src, a.B, a.N, P::PA, P::TM) &&
        encode(&maps.b, a.src, a.B, a.N, P::PB, P::KS) &&
        encode(&maps.o, a.src, a.B, a.N, P::PB, P::TM)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = vec ? minplus_tile_kernel<P, true> : minplus_tile_kernel<P, false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, P::T, P::kSmemBytes, a.stream>>>(a.src, a.dst, a.flags, a.executed,
                                                  a.N, a.B, a.step, maps);
  return static_cast<int>(cudaGetLastError());
}

// Picks the plan for (B, N) and launches it, or with `info` only describes it.
int dispatch(const Args& a, int* info) {
  const int N = a.N;
  if (N <= 64) {
    switch ((N + 7) / 8) {
      case 1: return run<Strip<1>>(a, info);
      case 2: return run<Strip<2>>(a, info);
      case 3: return run<Strip<3>>(a, info);
      case 4: return run<Strip<4>>(a, info);
      case 5: return run<Strip<5>>(a, info);
      case 6: return run<Strip<6>>(a, info);
      case 7: return run<Strip<7>>(a, info);
      default: return run<Strip<8>>(a, info);
    }
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  auto enough = [&](int t) {
    const long long per = (N + t - 1) / t;
    return 2LL * a.B * per * per >= static_cast<long long>(kFullAt) * sms;
  };
  if (N <= 112) return enough(56) ? run<Tile56>(a, info) : run<Tile56x28>(a, info);
  return enough(64) ? run<Tile64>(a, info) : run<Tile64x32>(a, info);
}

}  // namespace

// Launches squaring `step` on `stream`; returns the cudaError_t of the
// shared-memory attribute call or of the launch (0 = success).  src/dst
// (B, N, N) float32 contiguous, distinct; flags (steps, B) int32 zeroed
// before step 0; executed: one uint64.
extern "C" int mho_minplus_square_f32(const void* src, void* dst, void* flags,
                                      void* executed, int B, int N, int step,
                                      void* stream) {
  const Args a{static_cast<const float*>(src), static_cast<float*>(dst),
               static_cast<int*>(flags), static_cast<unsigned long long*>(executed),
               B, N, step, static_cast<cudaStream_t>(stream)};
  return dispatch(a, nullptr);
}

// The tile plan the launcher picks for (B, N), for logs and benches:
// info[0..7] = rows and columns of a tile, threads a block, k-groups, slice
// depth, stages, dynamic shared bytes a block, blocks a squaring.
extern "C" int mho_minplus_plan(int B, int N, int* info) {
  const Args a{nullptr, nullptr, nullptr, nullptr, B, N, 0, nullptr};
  return dispatch(a, info);
}
