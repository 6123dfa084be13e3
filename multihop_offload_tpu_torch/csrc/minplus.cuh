// K2's body: one min-plus squaring of a batch of (N, N) distance matrices,
//
//     dst[b, i, j] = min(src[b, i, j], min_k src[b, i, k] + src[b, k, j]),
//
// templated on the element type: float32 (`minplus.cu`) and bf16
// (`minplus_bf16.cu`, every candidate rounded to bf16 as a bf16 squaring
// rounds it; `minplus_elem.cuh` says why packed bf16x2 arithmetic gives
// those bits).
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/minplus.py:
// minplus_power_kernel_call` (`_apsp_kernel` -> `_chunked_squaring`), which
// runs all ceil(log2(N-1)) squarings of `env/apsp.py:apsp_minplus` in one
// call, on both legs of the precision policy (the Pallas kernel keeps its
// input's dtype, `:96`).  Here the wrapper launches this kernel once per
// squaring and ping-pongs between two buffers.
//
// What bounds it on an H100: issue slots.  (min, +) has no tensor-core path,
// and Hopper's DPX add-min is for integers only.  In float32 each candidate
// costs two CUDA-core instructions (FADD, then FMNMX, which runs on the
// half-rate ALU pipe), not one FMA: a squaring is 2 N^3 instructions per
// matrix at 33.5e12 a second, against only 8 N^2 bytes of traffic.  In bf16
// a packed `__hadd2` and `__hmin2` take two candidates each, so the same
// squaring is N^3 instructions, 2 N^3 operations at the bf16x2 rate of 67e12
// a second, against 4 N^2 bytes.  Every other instruction (shared loads,
// addresses, the loop, the bf16 broadcasts) takes a slot from them, and so
// does a warp stalled on a load.
//
// What the design does about it:
//   - Tiles cut to N.  The launcher picks a tile plan from (B, N): 8 x TN
//     strips with TN = N rounded up to 8 for N <= 64; 56 x 56 (or 56 x 28
//     where the batch gives fewer than 1.5 tiles an SM) up to N = 112; 64 x
//     64 (or 64 x 32) above.  The k loop runs to exactly N, so no candidate
//     is computed for k >= N.  At the paths' N (37, 56, 112, 256, 304, 1024)
//     the tiles cover N to the granule of 8, and the grid is at most one
//     wave of resident blocks or several.  Both element types take the same
//     plans.
//   - A block is G k-groups of TY x TX threads (160-256 threads).  Each
//     thread keeps RM x RN running minima (rows ty + TY r, columns in runs
//     of 4 at 4 (tx + TX c)) over the 4-step k-chunks of its group (chunk q
//     goes to group q mod G); a thread reads the row panel as one run along
//     k per row and the column panel as runs along j, so a chunk's RM + RN / 4
//     shared loads feed 8 RM RN candidates.  In bf16 the minima are pairs
//     along j, and a row's a[i][k] is broadcast into both halves of a pair
//     once, for the row's RN / 2 pairs: a step of a row is one broadcast and
//     RN / 2 `__hadd2` and `__hmin2`, against RN FADD and RN FMNMX in
//     float32.  After the k loop each group's minima go to shared memory,
//     and every thread meets the groups' minima and the old value over runs
//     of the tile and stores them, in bf16 with no rounding step: every
//     value is a bf16 already.
//   - Nothing is staged through registers, and nothing is widened: the
//     slices come in the element type, so a bf16 stage holds half the
//     bytes.  The slices of the row panel (rows along k, pitch KS + 16
//     bytes, so the rows a warp reads fall in distinct banks) and of the
//     column panel, and with the last slice the tile's old values, come in
//     a ring of ST stages, one barrier a slice: on the 56 x 56 and 64-row
//     plans by tensor copies where the rows are 16-byte multiples (N % 4 ==
//     0 in float32, N % 8 == 0 in bf16; three tensor maps a launch; a box an
//     operand, 16 bytes wider than the data so that it lands at the padded
//     pitch; thread 0 issues them on one mbarrier a stage), which keep the
//     load queue free for the shared loads; otherwise by every thread's
//     cp.async of the widest size the rows and the tile's columns allow
//     (16 or 4 bytes in float32; 16, 8 or 4 in bf16, whose odd N take plain
//     2-byte loads, since cp.async moves 4, 8 or 16 bytes).
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

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "minplus_elem.cuh"

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

// a tile plan for elements E: TY x TX threads in each of G k-groups, RM x RN
// minima a thread, k-slices of KS in a ring of ST stages; kTensor: where the
// rows are 16-byte multiples the slices come by tensor copies (a box an
// operand, issued by thread 0, landing on an mbarrier a stage), otherwise by
// every thread's cp.async
template <class E, int TY_, int RM_, int TX_, int RN_, int G_, int KS_, int ST_, bool kTensor_>
struct Plan {
  using Elem = E;
  static constexpr int TY = TY_, RM = RM_, TX = TX_, RN = RN_, G = G_, KS = KS_, ST = ST_;
  static constexpr bool kTensor = kTensor_;
  static constexpr int kEs = static_cast<int>(sizeof(E));  // bytes an element
  static constexpr int kPad = 16 / kEs;                     // 16 bytes of pitch padding
  static constexpr int T = G * TY * TX;            // threads
  static constexpr int TM = TY * RM, TN = TX * RN; // output tile
  static constexpr int PA = KS + kPad;             // row panel pitch (elements)
  static constexpr int PB = TN + kPad;             // column panel, old, partial minima
  static constexpr int SA = TM * PA, SB = KS * PB, SO = TM * PB;
  // the stages, and after the k loop the G groups' minima over them
  static constexpr int SR = ST * (SA + SB) > G * SO ? ST * (SA + SB) : G * SO;
  static constexpr int kSmemBytes = (SR + SO) * kEs + ST * 8;  // + an mbarrier a stage
  // the widest copy a tile's column offsets j0 = TN x allow
  static constexpr int kMaxCopy = TN * kEs % 16 == 0 ? 16 : TN * kEs % 8 == 0 ? 8 : 4;
  static_assert(RN % 4 == 0 && KS % (4 * G) == 0 && T % 32 == 0, "plan shape");
  static_assert((SR + SO) * kEs % 8 == 0, "the mbarriers are 8-byte aligned");
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
// the column panel's slice and the tile's old values, each 16 bytes wider
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
// stride N) to shared memory (pitch P elements) by cp.async of kCB bytes,
// for boxes that move by whole rows or columns from slice to slice; each
// copy's W elements wholly in or out of range (N % W == 0, rows kCB-byte
// aligned).  kCB = 2 (a bf16 at odd N): a plain load and store.  Where the
// T threads tile the box's rows evenly, a thread's copies keep one column
// and step T / Q rows, so their offsets are one multiply-add apart.
template <int R, int C, int P, int T, int kCB, class E>
struct Box {
  static constexpr int W = kCB / static_cast<int>(sizeof(E));  // elements a copy
  static constexpr int Q = C / W;                               // copies a row
  static constexpr int U = (R * Q + T - 1) / T;
  static constexpr bool kEven = T % Q == 0;
  static_assert(W >= 1 && C % W == 0, "copies tile the box's rows");

  // copies the part inside [0, N)^2 of rows r0 + [0, R) x columns
  // c0 + [0, C); the rest is left as it is (never read)
  __device__ __forceinline__ static void copy(E* dst, const E* __restrict__ S, int N, int r0,
                                              int c0, int tid) {
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
        const E* from = S + (gr * N + gc);
        E* to = dst + r * P + c;
        if constexpr (kCB == 16)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(to)),
                       "l"(from));
        else if constexpr (kCB >= 4)
          asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(to)),
                       "l"(from), "n"(kCB));
        else
          *to = *from;
      }
    }
  }
};

template <class P, int kCB>
__global__ void __launch_bounds__(P::T, 2)
minplus_tile_kernel(const typename P::Elem* __restrict__ src, typename P::Elem* __restrict__ dst,
                    int* __restrict__ flags, unsigned long long* __restrict__ executed,
                    int N, int B, int step, const __grid_constant__ Maps maps) {
  using E = typename P::Elem;
  constexpr int TY = P::TY, RM = P::RM, TX = P::TX, RN = P::RN, G = P::G;
  constexpr int KS = P::KS, ST = P::ST, T = P::T, TM = P::TM, TN = P::TN;
  constexpr int PA = P::PA, PB = P::PB, SA = P::SA, SB = P::SB, SO = P::SO, kEs = P::kEs;
  constexpr int C4 = RN / 4;  // runs of a thread's row
  static_assert(ST >= 2 || KS >= 64, "a single stage holds the whole k range");
  static_assert(!P::kTensor || (SA * kEs % 128 == 0 && SB * kEs % 128 == 0 &&
                                P::SR * kEs % 128 == 0),
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

  extern __shared__ __align__(128) unsigned char smem_bytes[];
  E* const smem = reinterpret_cast<E*>(smem_bytes);
  E* const As = smem;                  // ST x [TM][PA]: As[i][k] = S[i0 + i][k0 + k]
  E* const Bs = smem + ST * SA;        // ST x [KS][PB]: Bs[k][j] = S[k0 + k][j0 + j]
  E* const Rs = smem;                  // G x [TM][PB]: each group's minima, after the k loop
  E* const Os = smem + P::SR;          // [TM][PB]: S[i0 + i][j0 + j]
  constexpr bool kTma = P::kTensor && kCB == 16;
  const uint32_t bars = smem_u32(Os + SO);  // ST mbarriers, 8 bytes each

  const size_t base = static_cast<size_t>(b) * N * N;
  const E* __restrict__ S = src + base;
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
        bar_expect(bar, kEs * (SA + SB + (last ? SO : 0)));
        tensor_copy(smem_u32(As + (s % ST) * SA), &maps.a, s * KS, i0, b, bar);
        tensor_copy(smem_u32(Bs + (s % ST) * SB), &maps.b, j0, s * KS, b, bar);
        if (last) tensor_copy(smem_u32(Os), &maps.o, j0, i0, b, bar);
      }
    } else {
      if (s < slices) {
        Box<TM, KS, PA, T, kCB, E>::copy(As + (s % ST) * SA, S, N, i0, s * KS, tid);
        Box<KS, TN, PB, T, kCB, E>::copy(Bs + (s % ST) * SB, S, N, s * KS, j0, tid);
        if (s == slices - 1) Box<TM, TN, PB, T, kCB, E>::copy(Os, S, N, i0, j0, tid);
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

  Run<E> acc[RM][C4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < C4; ++c) acc[r][c] = inf_run<E>();

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
    const E* A = As + (s % ST) * SA + ty * PA;
    const E* Bk = Bs + (s % ST) * SB + 4 * tx;
    const int kn = min(KS, N - s * KS);  // steps of this slice, exactly
    const int full = kn >> 2;
    for (int q = g; q < full; q += G) {
      Run<E> a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = load_run(A + r * TY * PA + 4 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Run<E> bv[C4];
#pragma unroll
        for (int c = 0; c < C4; ++c) bv[c] = load_run(Bk + (4 * q + e) * PB + 4 * TX * c);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const Bc<E> av = bcast(a[r], e);
#pragma unroll
          for (int c = 0; c < C4; ++c) relax(acc[r][c], av, bv[c]);
        }
      }
    }
    if ((kn & 3) != 0 && full % G == g) {  // the last 1-3 steps, one at a time
      for (int k = 4 * full; k < kn; ++k) {
        Run<E> bv[C4];
#pragma unroll
        for (int c = 0; c < C4; ++c) bv[c] = load_run(Bk + k * PB + 4 * TX * c);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const Bc<E> av = bcast(A[r * TY * PA + k]);
#pragma unroll
          for (int c = 0; c < C4; ++c) relax(acc[r][c], av, bv[c]);
        }
      }
    }
    if constexpr (kClock) {  // the minima are in registers: wait on them
      Run<E> sink = inf_run<E>();
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < C4; ++c) meet(sink, acc[r][c]);
      keep_live(sink);
    }
    tick(2);
  }
  if constexpr (!kTma) cp_wait<0>();  // (with kTma `old` came with the last slice's phase)
  __syncthreads();  // every group is done with the stages, and `old` has landed
  tick(3);

  // each group's minima go to shared memory over the stages; then every
  // thread takes runs of the tile, meets the groups' minima and the old
  // value there, and stores
  {
    E* R = Rs + g * SO + ty * PB + 4 * tx;
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < C4; ++c) store_run(R + r * TY * PB + 4 * TX * c, acc[r][c]);
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
      Run<E> v = load_run(Rs + row * PB + col);
#pragma unroll
      for (int h = 1; h < G; ++h) meet(v, load_run(Rs + h * SO + row * PB + col));
      const Run<E> o = load_run(Os + row * PB + col);
      Run<E> w = o;
      meet(w, v);
      E* out = dst + base + static_cast<size_t>(i) * N + j;
      if constexpr (kCB >= 4 * kEs) {  // whole runs: the rows are run-aligned
        store_run(out, w);
        changed |= differs(w, o);
      } else {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (j + f < N) {
            out[f] = get(w, f);
            changed |= ne(get(w, f), get(o, f));
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
template <class E, int TN8>
using Strip = Plan<E, 2, 4, 2 * TN8, 4, 8, 64, 1, false>;
template <class E>
using Tile56 = Plan<E, 8, 7, 14, 4, 2, 32, 2, true>;
template <class E>
using Tile56x28 = Plan<E, 8, 7, 7, 4, 4, 64, 2, false>;
template <class E>
using Tile64 = Plan<E, 8, 8, 16, 4, 2, 32, 3, true>;
template <class E>
using Tile64x32 = Plan<E, 8, 8, 8, 4, 4, 64, 2, true>;

template <class E>
struct Args {
  const E* src;
  E* dst;
  int* flags;
  unsigned long long* executed;
  int B, N, step;
  cudaStream_t stream;
};

// plan info: TM, TN, threads, k-groups, KS, stages, shared bytes, blocks,
// bytes a copy, tensor copies (1) or cp.async (0)
constexpr int kPlanFields = 10;

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

// The (B, N, N) matrices at `src` as a tensor map with boxes of `cols` x
// `rows` x 1; false if the driver refuses it.
template <class E>
bool encode(CUtensorMap* map, const E* src, int B, int N, int cols, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  constexpr cuuint64_t es = sizeof(E);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {es * N, es * N * N};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      kIsBf16<E> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 3, const_cast<E*>(src), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bytes a copy of plan P moves at this launch: the widest of 16, 8, 4
// (and 2, a plain load, in bf16) that the rows (N elements), the tile's
// columns and both buffers' alignment allow.  Float32 takes 16 or 4.
template <class P>
int copy_bytes(const Args<typename P::Elem>& a) {
  using E = typename P::Elem;
  const uintptr_t at = reinterpret_cast<uintptr_t>(a.src) | reinterpret_cast<uintptr_t>(a.dst);
  const int sizes[3] = {16, 8, 4};
  for (const int c : sizes) {
    if (c > P::kMaxCopy || (!kIsBf16<E> && c == 8)) continue;
    if (a.N * P::kEs % c == 0 && at % c == 0) return c;
  }
  return P::kEs;
}

template <class P, int kCB>
int launch(const Args<typename P::Elem>& a, const dim3& grid) {
  Maps maps{};
  if (kCB == 16 && P::kTensor &&
      !(encode(&maps.a, a.src, a.B, a.N, P::PA, P::TM) &&
        encode(&maps.b, a.src, a.B, a.N, P::PB, P::KS) &&
        encode(&maps.o, a.src, a.B, a.N, P::PB, P::TM)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = minplus_tile_kernel<P, kCB>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, P::T, P::kSmemBytes, a.stream>>>(a.src, a.dst, a.flags, a.executed,
                                                  a.N, a.B, a.step, maps);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int run(const Args<typename P::Elem>& a, int* info) {
  const dim3 grid((a.N + P::TN - 1) / P::TN, (a.N + P::TM - 1) / P::TM, a.B);
  const int cb = copy_bytes<P>(a);
  if (info != nullptr) {
    const int v[kPlanFields] = {P::TM, P::TN, P::T, P::G, P::KS, P::ST, P::kSmemBytes,
                                static_cast<int>(grid.x * grid.y * grid.z), cb,
                                P::kTensor && cb == 16};
    for (int f = 0; f < kPlanFields; ++f) info[f] = v[f];
    return 0;
  }
  if constexpr (P::kMaxCopy == 16) {
    if (cb == 16) return launch<P, 16>(a, grid);
  }
  if constexpr (kIsBf16<typename P::Elem>) {
    if (cb == 8) return launch<P, 8>(a, grid);
    if (cb == 4) return launch<P, 4>(a, grid);
    return launch<P, 2>(a, grid);
  } else {
    return launch<P, 4>(a, grid);
  }
}

// Picks the plan for (B, N) and launches it, or with `info` only describes it.
template <class E>
int dispatch(const Args<E>& a, int* info) {
  const int N = a.N;
  if (N <= 64) {
    switch ((N + 7) / 8) {
      case 1: return run<Strip<E, 1>>(a, info);
      case 2: return run<Strip<E, 2>>(a, info);
      case 3: return run<Strip<E, 3>>(a, info);
      case 4: return run<Strip<E, 4>>(a, info);
      case 5: return run<Strip<E, 5>>(a, info);
      case 6: return run<Strip<E, 6>>(a, info);
      case 7: return run<Strip<E, 7>>(a, info);
      default: return run<Strip<E, 8>>(a, info);
    }
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  auto enough = [&](int t) {
    const long long per = (N + t - 1) / t;
    return 2LL * a.B * per * per >= static_cast<long long>(kFullAt) * sms;
  };
  if (N <= 112) return enough(56) ? run<Tile56<E>>(a, info) : run<Tile56x28<E>>(a, info);
  return enough(64) ? run<Tile64<E>>(a, info) : run<Tile64x32<E>>(a, info);
}

// Launches squaring `step` of (B, N, N) E matrices on `stream`; returns the
// cudaError_t of the shared-memory attribute call or of the launch (0 =
// success).  src/dst contiguous, distinct; flags (steps, B) int32 zeroed
// before step 0; executed: one uint64.
template <class E>
int square(const void* src, void* dst, void* flags, void* executed, int B, int N, int step,
           void* stream) {
  const Args<E> a{static_cast<const E*>(src), static_cast<E*>(dst), static_cast<int*>(flags),
                  static_cast<unsigned long long*>(executed), B, N, step,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, nullptr);
}

// The tile plan the launcher picks for (B, N) in elements E, for logs and
// benches: info[0..9] = rows and columns of a tile, threads a block,
// k-groups, slice depth, stages, dynamic shared bytes a block, blocks a
// squaring, bytes a copy (for buffers allocated by PyTorch), and 1 where
// the slices come by tensor copies.
template <class E>
int plan(int B, int N, int* info) {
  const Args<E> a{nullptr, nullptr, nullptr, nullptr, B, N, 0, nullptr};
  return dispatch(a, info);
}

}  // namespace
