// K2's backward: the vector-Jacobian product of the `iters` min-plus
// squarings of a batch of (N, N) float32 distance matrices,
//
//     O = min(D, M),   M[i, j] = min_k D[i, k] + D[k, j],
//
// taken as reverse-mode autodiff takes it through `env/apsp.py:24-26`
// (`jnp.minimum(d, jnp.min(d[:, :, None] + d[None, :, :], axis=1))`) over
// the whole schedule: `lax.minimum` gives half of the cotangent to each side
// of a tie, and the min reduction splits its share evenly among every k
// that attains it.  PyTorch's `minimum` and `amin` split the same way, so
// autograd through `ops/minplus.py:minplus_square_plain` is one plain
// version; `ops/minplus.py:minplus_closure_bwd_plain` is another, which
// follows this kernel's passes in plain torch.
//
// Replaces no TPU kernel: the JAX package differentiates the XLA squarings
// (`env/apsp.py:apsp_minplus(early_stop=False)`, on the tape of
// `rl/rollout.py:150-155`); there the forward is K2 (`csrc/minplus.cu`).
//
// For cotangent G of O, with D the squaring's input, the VJP is
//
//   f[i, j]      = 0, -1/2 or 1, / cnt[i, j] (the k tied), as D <, ==, > M,
//   direct[p, q] = G[p, q] x (1, 1/2, 0) likewise,
//   w[i, j]      = G[i, j] |f[i, j]|,
//   G_D[p, q]    = direct[p, q]
//                + sum_j [D[p, q] + D[q, j] == M[p, j]] w[p, j]
//                + sum_i [D[i, p] + D[p, q] == M[i, q]] w[i, q]
//
// (D[p, q] as the first and as the second operand of a candidate), and the
// backward chains it over the squarings in reverse.  M and f, the tie
// data, depend on the saved stack alone, not on G.  Early stop: the
// forward (`ops/minplus.py:_minplus_closure_saved`) keeps the input of
// every squaring in a stack of slices, squaring s reading slice s and
// writing slice s + 1; K2's early stop skips squaring s of matrix b when
// squaring s - 1 changed nothing there, and then writes no slice.
// `lead[b]` counts the leading squarings that changed b, so slice
// min(s, lead[b]) holds squaring s's input: the fixed point where it was
// skipped.  The tie data of slice t are taken for t <= lead[b] only, and
// squaring s reads those of slice min(s, lead[b]).  Every squaring of the
// schedule takes its VJP, since the VJP at the fixed point is not the
// identity (ties split the cotangent).
//
// One host call (`mho_minplus_closure_bwd_f32`) enqueues 1 + iters
// launches, chained by programmatic dependent launch (each grid lets the
// next one launch at its start; the next one stages what needs no wait,
// then `griddepcontrol.wait`s for the previous grid):
//
//   1. `bwd_ties_kernel`: the tie data of the slice the chain's first
//      squaring reads, min(iters - 1, lead[b]).
//   2. `bwd_gather_kernel`, once a squaring in reverse: its VJP with the
//      split fused into the gather.  A block stages its panels of D before
//      the wait; after it, the panels of M, f and G (`cp.async`), w = G |f|
//      in place in shared memory, and the sums; G's direct share joins in
//      the epilogue.  No scratch round trip of w, and no atomics: the same
//      bits on every call.  Beside it, in blocks of their own that need no
//      wait, the launch of squaring s takes the tie data of slice s - 1
//      for the matrices where squaring s - 1 reads it (s - 1 < lead[b]):
//      the tie pass runs beside the chain, on the slots its gathers leave,
//      instead of in front of it (all of it in the first launch cost
//      13.9-22.0 us more at (4, 112) on an H100).
//
// The tie pass is a k loop per slice: a running minimum and the count of
// its ties.  Where every row i of a tile has D[i, i] <= 0 (as
// `apsp_minplus` hands it over: a zero diagonal), M <= D, so the
// squaring's output is M, and slice t + 1 holds it: that tile's loop only
// counts the candidates equal to it (an add, a compare and a predicated
// add a candidate, against six).
//
// Everything that one grid of the backward writes and a later one reads
// (G, M, f) is read at L2 (`ld.global.cg`, `cp.async.cg`), never through an
// SM's L1: under programmatic dependent launch a grid starts before the
// one it waits for ends, and a stale line there gave wrong sums.
//
// What bounds it: operations.  The tie pass is a squaring's add and min
// per candidate plus the count, the gather two N^3 sums of (add, compare,
// select-add: an FADD, an FSET and an FFMA); PERF.md counts 6 N^3
// instructions a squaring and matrix at 33.5e12 a second.  Both passes
// tile alike: 16 x 16 outputs a block, 4 x 4 a thread (rows 4 ty + r,
// columns 4 tx + c), so each staged value is reused across a thread's row
// or column in registers: a tie step reads 4 + 4 float4 for 64
// candidates, a gather step 4 M + 4 w + 4 D float4 (the row sum) or 3
// float4 a step (the column sum) for 64.  The contraction (k, or j and i)
// is split over the groups of 16 threads of a plan, which meet in shared
// memory in a fixed order; in the gather half the groups take the row sum
// and half the column sum.  The plan follows the grid: 16 groups where a
// squaring's gather blocks fit two an SM (Wide: the RL path's (4, 112)),
// halving each thread's share of the sums, else 8 (Full: 3 blocks an
// SM).  Panels are staged whole up to N = 128 (in chunks of 128 above),
// with pitches that keep a quarter warp's float4 reads on distinct banks
// (the row panel of D is stored with its rows permuted for the same
// reason), each thread's share of a panel at compile-time strides.
// Out-of-range steps are neutral: NaN in the tie pass's row panel (a NaN
// candidate never ties or wins), 0 for w in the gather.  The chain divides
// nothing: f holds the reciprocal of the count, taken once a slice
// (`__frcp_rn`, correctly rounded).
//
// Exactness: every candidate is one correctly rounded add (`__fadd_rn`, no
// contraction), as in K2 and the plain versions, so M and the tie sets are
// theirs exactly (K2's output is that same minimum), and f and w are
// `minplus_closure_bwd_plain`'s bits (a select-add is an FFMA of 1 or 0,
// exact); the result differs from it only by the order of the float sums.
// Unreachable pairs (M = +inf) tie at every k: cnt = N, and a zero
// cotangent there gives 0, never NaN (a matching candidate adds w; nothing
// is multiplied by +inf).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 16;         // output tile kTile x kTile, both passes
constexpr int kChunk = 128;       // contraction steps staged at a time
// bench-only (`...:kClock=1`): thread 0 of every block stamps the card's
// %globaltimer into `g_clock` at each phase of its pass, read back by
// `mho_minplus_closure_bwd_clock`
constexpr int kClock = 0;

constexpr int kTY = kTile / 4;  // thread rows (and columns) of a group, 4 x 4 entries a thread
constexpr int kGroup = kTY * kTY;
constexpr int kTP = kTile + 4;  // pitch of the panels that run along the tile
static_assert(kTile % 4 == 0 && kChunk % 4 == 0, "plan shape");

// A plan: G groups of kGroup threads a block (the tie pass's k-groups; in
// the gather half of them take the row sum, half the column sum)
template <int G_, int kMinBlocks_>
struct Plan {
  static constexpr int G = G_;
  static constexpr int kMinBlocks = kMinBlocks_;  // blocks an SM the registers must allow
  static constexpr int T = G * kGroup;
  static constexpr int kHalf = G / 2;
  static_assert(kHalf * kGroup % 32 == 0, "no warp takes both sums");
};
// Wide where a squaring's gather blocks fit kWideAt an SM (the card is far
// from full, as at the RL path's (4, 112)): 16 groups halve each thread's
// share of the sums.  Full (else, as at (16, 112)): 8 groups, 3 blocks an
// SM.
using Wide = Plan<16, 2>;
using Full = Plan<8, 3>;
constexpr int kWideAt = 2;
// bench-only (`...:kPlan=0` or `1`): force Full or Wide; -1 picks by the grid
constexpr int kPlan = -1;

// the launch's geometry, the same for every block
struct Geo {
  int N, B, iters, tiles_x;
  int kq;  // contraction steps a chunk: min(N, kChunk) rounded up to 4
  int kp;  // pitch of the panels that run along the contraction: kq + 4 or + 8, kp / 4 odd
};

struct Args {
  const float* stack;
  long long slice;
  const int* lead;
  float* tie_m;  // (iters, B, N, N): M of slice t
  float* tie_f;  // (iters, B, N, N): its f
  Geo geo;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// programmatic dependent launch: let the next grid in the stream launch;
// wait until the previous grid has finished and its writes are visible
// (both no-ops in a grid launched without the attribute)
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// kClock's timeline: a row a pass (0 the first launch's tie blocks, 1 + r
// the r-th squaring of the chain, 32 + 1 + r the tie blocks beside it);
// slots: the earliest and latest block start, the latest return from the
// wait, the latest end of the loads after it, of the staging (the barrier
// after it) and of the sums, the earliest and latest end, the blocks
constexpr int kClockRows = 64;
enum {
  kStart, kStartLast, kWaited, kLoaded, kStaged, kComputed, kEndFirst, kEnd, kBlocks,
  kClockSlots
};
__device__ unsigned long long g_clock[kClockRows][kClockSlots];

__device__ __forceinline__ void stamp(int row, int slot) {
  if constexpr (kClock) {
    if (slot == kEnd) __syncthreads();  // every thread has stored
    if (threadIdx.x != 0 || row >= kClockRows) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* at = g_clock[row];
    if (slot == kStart) {
      atomicMin(at + kStart, t);
      atomicMax(at + kStartLast, t);
    } else if (slot == kEnd) {
      atomicMax(at + kEnd, t);
      atomicMin(at + kEndFirst, t);
      atomicAdd(at + kBlocks, 1ULL);
    } else {
      atomicMax(at + slot, t);
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// matrix b's slice t of the stack
__device__ __forceinline__ const float* slice_of(const Args& a, int t, int b) {
  return a.stack + t * a.slice + static_cast<long long>(b) * a.geo.N * a.geo.N;
}

__device__ __forceinline__ long long tie_off(const Args& a, int t, int b) {
  return (static_cast<long long>(t) * a.geo.B + b) * a.geo.N * a.geo.N;
}

// ---- a thread's share of a panel -----------------------------------------------
//
// A row panel is kTile rows (r0 + r) by up to kChunk steps (k0 + c) of an
// (N x N) matrix; a column panel up to kChunk steps (k0 + r) by kTile
// columns (c0 + c).  A thread of T takes U units of CW words of either:
// in a row panel row tid / kRowThreads, units tid % kRowThreads +
// kRowThreads u; in a column panel unit tid % kColUnits, rows
// tid / kColUnits + kColRows u.
template <int CW, int T>
struct Share {
  static constexpr int kRowThreads = T / kTile;
  static constexpr int kColUnits = kTile / CW;
  static constexpr int kColRows = T / kColUnits;
  static constexpr int U = kChunk / CW / kRowThreads;
  static_assert(T % kTile == 0 && T % kColUnits == 0 && kChunk / CW % kRowThreads == 0 &&
                    kChunk % kColRows == 0 && kChunk / kColRows == U,
                "shares");

  // unit u's place in the panel: (row, column) within it
  __device__ __forceinline__ static void rows_unit(int tid, int u, int& r, int& c) {
    r = tid / kRowThreads;
    c = (tid % kRowThreads + kRowThreads * u) * CW;
  }
  __device__ __forceinline__ static void cols_unit(int tid, int u, int& r, int& c) {
    r = tid / kColUnits + kColRows * u;
    c = tid % kColUnits * CW;
  }
};

// One unit of S at (gr, gc) to shared `to`: by cp.async of 16 bytes where
// CW = 4, else by a load of one word; at L2 either way.  The caller keeps
// it inside [0, N)^2.
template <int CW>
__device__ __forceinline__ void copy_unit(float* to, const float* from) {
  if constexpr (CW == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(to)), "l"(from));
  else
    *to = __ldcg(from);
}

// A row panel (rows, steps c < C) of S to shared `dst` (pitch P); `perm`:
// row r lands at row (r % 4) kTY + r / 4, so that the rows 4 tx + c of a
// quarter warp fall on distinct banks.  Entries outside [0, N)^2 are left.
template <int CW, int T>
__device__ __forceinline__ void copy_rows(float* dst, int P, const float* __restrict__ S, int N,
                                          int r0, int k0, int C, int tid, bool perm) {
  using Sh = Share<CW, T>;
#pragma unroll
  for (int u = 0; u < Sh::U; ++u) {
    int r, c;
    Sh::rows_unit(tid, u, r, c);
    if (c < C && r0 + r < N && k0 + c < N) {
      const int sr = perm ? (r & 3) * kTY + (r >> 2) : r;
      copy_unit<CW>(dst + sr * P + c, S + (static_cast<long long>(r0 + r) * N + k0 + c));
    }
  }
}

// A column panel (steps r < R, columns) of S to shared `dst` (pitch P)
template <int CW, int T>
__device__ __forceinline__ void copy_cols(float* dst, int P, const float* __restrict__ S, int N,
                                          int k0, int c0, int R, int tid) {
  using Sh = Share<CW, T>;
#pragma unroll
  for (int u = 0; u < Sh::U; ++u) {
    int r, c;
    Sh::cols_unit(tid, u, r, c);
    if (r < R && k0 + r < N && c0 + c < N)
      copy_unit<CW>(dst + r * P + c, S + (static_cast<long long>(k0 + r) * N + c0 + c));
  }
}

// w = G |f| in place over this thread's units of a staged panel: W holds
// G, Fs holds f (both pitch P); 0 outside [0, N)^2, where the copies left
// the words as they were
template <int CW>
__device__ __forceinline__ void w_unit(float* W, const float* Fs, bool in) {
  if constexpr (CW == 4) {
    const float4 g = ld4(W), f = ld4(Fs);
    *reinterpret_cast<float4*>(W) =
        in ? make_float4(g.x * fabsf(f.x), g.y * fabsf(f.y), g.z * fabsf(f.z), g.w * fabsf(f.w))
           : make_float4(0, 0, 0, 0);
  } else {
    *W = in ? *W * fabsf(*Fs) : 0.0f;
  }
}

// ... of a row panel (rows r0 + r, steps k0 + c for c < C)
template <int CW, int T>
__device__ __forceinline__ void w_rows(float* W, const float* Fs, int P, int N, int r0, int k0,
                                       int C, int tid) {
  using Sh = Share<CW, T>;
#pragma unroll
  for (int u = 0; u < Sh::U; ++u) {
    int r, c;
    Sh::rows_unit(tid, u, r, c);
    if (c < C) w_unit<CW>(W + r * P + c, Fs + r * P + c, r0 + r < N && k0 + c < N);
  }
}

// ... of a column panel (steps k0 + r for r < R, columns c0 + c)
template <int CW, int T>
__device__ __forceinline__ void w_cols(float* W, const float* Fs, int P, int N, int k0, int c0,
                                       int R, int tid) {
  using Sh = Share<CW, T>;
#pragma unroll
  for (int u = 0; u < Sh::U; ++u) {
    int r, c;
    Sh::cols_unit(tid, u, r, c);
    if (r < R) w_unit<CW>(W + r * P + c, Fs + r * P + c, k0 + r < N && c0 + c < N);
  }
}

// the shared words a block of each pass takes at this geometry
template <class P>
__host__ __device__ inline int tie_smem_words(const Geo& g) {
  const int panels = kTile * g.kp + g.kq * kTP;
  const int meet = 2 * P::G * kTile * kTile;
  return panels > meet ? panels : meet;
}

template <class P>
__host__ __device__ inline int gather_smem_words(const Geo& g) {
  const int panels = 4 * kTile * g.kp + 4 * g.kq * kTP;
  const int meet = P::G * kTile * kTile;
  return panels > meet ? panels : meet;
}

// ---- the tie pass ------------------------------------------------------------

// M and f of the tile (i0, j0) of D, written to m_out, f_out (N x N).
// kKnownM: the squaring's output O (`O`, slice t + 1) is M, since every
// row i of the tile has D[i, i] <= 0 (then M[i, j] <= D[i, i] + D[i, j] <=
// D[i, j], in floats too: a rounded add is monotone), so the k loop only
// counts the candidates equal to it (an add, a compare and a predicated
// add); else it keeps a running minimum and the count of its ties.
// P::T threads; `smem` holds tie_smem_words.
template <int CW, class P, bool kKnownM>
__device__ void tie_tile(const float* __restrict__ D, const float* __restrict__ O,
                         float* __restrict__ m_out, float* __restrict__ f_out, const Geo& geo,
                         int i0, int j0, float* smem, int row) {
  stamp(row, kStart);
  const int N = geo.N, kq = geo.kq, kp = geo.kp;
  const int tid = threadIdx.x;
  const int g = tid / kGroup, ty = tid % kGroup / kTY, tx = tid % kTY;
  float* As = smem;               // [kTile][kp]: As[i][k] = D[i0 + i][k0 + k]
  float* Bs = smem + kTile * kp;  // [kq][kTP]:   Bs[k][j] = D[k0 + k][j0 + j]
  float m[4][4];
  int cnt[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + 4 * ty + r, j = j0 + 4 * tx + c;
      m[r][c] = kKnownM && i < N && j < N ? O[static_cast<long long>(i) * N + j] : CUDART_INF_F;
      cnt[r][c] = 0;
    }
  for (int k0 = 0; k0 < N; k0 += kq) {
    const int kn = min(kq, N - k0), kn4 = (kn + 3) & ~3;
    copy_rows<CW, P::T>(As, kp, D, N, i0, k0, kq, tid, false);
    copy_cols<CW, P::T>(Bs, kTP, D, N, k0, j0, kq, tid);
    cp_commit();
    // steps kn .. kn4 - 1 of the row panel are NaN: their candidates never
    // win or tie
    for (int e = tid; e < kTile * (kn4 - kn); e += P::T)
      As[e / (kn4 - kn) * kp + kn + e % (kn4 - kn)] = CUDART_NAN_F;
    cp_wait_all();
    __syncthreads();
    if (k0 == 0) stamp(row, kStaged);
    const float* A = As + 4 * ty * kp;
    const float* Bk = Bs + 4 * tx;
    for (int qd = g; qd < kn4 / 4; qd += P::G) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(A + r * kp + 4 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 bv = ld4(Bk + (4 * qd + e) * kTP);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av = comp(a[r], e);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = __fadd_rn(av, comp(bv, c));
            if constexpr (kKnownM) {
              cnt[r][c] += v == m[r][c];
            } else {
              cnt[r][c] = v < m[r][c] ? 1 : cnt[r][c] + (v == m[r][c]);
              m[r][c] = fminf(m[r][c], v);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  stamp(row, kComputed);
  // the groups meet: the least minimum, and the ties of the groups that
  // reach it (with kKnownM every group counted against the same M)
  constexpr int kSq = kTile * kTile;
  float* Rm = smem;
  int* Rc = reinterpret_cast<int*>(smem + P::G * kSq);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int at = g * kSq + (4 * ty + r) * kTile + 4 * tx + c;
      Rm[at] = m[r][c];
      Rc[at] = cnt[r][c];
    }
  __syncthreads();
  for (int e = tid; e < kSq; e += P::T) {
    const int i = i0 + e / kTile, j = j0 + e % kTile;
    if (i >= N || j >= N) continue;
    float mm = Rm[e];
#pragma unroll
    for (int h = 1; h < P::G; ++h) mm = fminf(mm, Rm[h * kSq + e]);
    int cc = 0;
#pragma unroll
    for (int h = 0; h < P::G; ++h) cc += Rm[h * kSq + e] == mm ? Rc[h * kSq + e] : 0;
    const long long at = static_cast<long long>(i) * N + j;
    const float d = D[at];
    const float rcp = __frcp_rn(static_cast<float>(cc));
    m_out[at] = mm;
    f_out[at] = d < mm ? 0.0f : (d == mm ? -0.5f * rcp : rcp);
  }
  stamp(row, kEnd);
}

// the tile `tile` of matrix b's slice t, where squaring t ran (t <= lead[b],
// so slice t + 1 holds its output)
template <int CW, class P>
__device__ void tie_item(const Args& a, int t, int b, int tile, float* smem, int row) {
  if (t > a.lead[b]) return;
  const long long off = tie_off(a, t, b);
  const int N = a.geo.N, i0 = tile / a.geo.tiles_x * kTile, j0 = tile % a.geo.tiles_x * kTile;
  const float* D = slice_of(a, t, b);
  const int i = i0 + threadIdx.x;
  const bool known = __syncthreads_and(threadIdx.x >= kTile || i >= N ||
                                       D[static_cast<long long>(i) * N + i] <= 0.0f);
  if (known)
    tie_tile<CW, P, true>(D, slice_of(a, t + 1, b), a.tie_m + off, a.tie_f + off, a.geo, i0, j0,
                       smem, row);
  else
    tie_tile<CW, P, false>(D, nullptr, a.tie_m + off, a.tie_f + off, a.geo, i0, j0, smem, row);
}

// ---- the fused split and gather ------------------------------------------------

__device__ __forceinline__ float direct_share(float g, float f) {
  return f == 0.0f ? g : (f < 0.0f ? 0.5f * g : 0.0f);
}

// The VJP of one squaring on the tile (p0, q0) of one matrix: D its input,
// M and F its tie data, Gin the cotangent of its output, Gout that of its
// input.  P::T threads; `smem` holds gather_smem_words.  `dep`: Gin and
// the tie data come from the previous grid (wait for it before reading
// them).
template <int CW, class P>
__device__ void gather_tile(const float* __restrict__ D, const float* __restrict__ M,
                            const float* __restrict__ F, const float* __restrict__ Gin,
                            float* __restrict__ Gout, const Geo& geo, int p0, int q0, float* smem,
                            bool dep, int row) {
  constexpr int T = P::T, kHalf = P::kHalf;
  stamp(row, kStart);
  const int N = geo.N, kq = geo.kq, kp = geo.kp;
  const int tid = threadIdx.x;
  const int g = tid / kGroup, ty = tid % kGroup / kTY, tx = tid % kTY;
  float* Mr = smem;                    // [kTile][kp]: M[p0 + p][k0 + j]
  float* Wr = Mr + kTile * kp;         // [kTile][kp]: G, then w, at [p0 + p][k0 + j]
  float* Dq = Wr + kTile * kp;         // [kTile][kp]: D[q0 + q][k0 + j], rows permuted
  float* Fr = Dq + kTile * kp;         // [kTile][kp]: f[p0 + p][k0 + j]
  float* Dc = Fr + kTile * kp;         // [kq][kTP]:   D[k0 + i][p0 + p]
  float* Mc = Dc + kq * kTP;           // [kq][kTP]:   M[k0 + i][q0 + q]
  float* Wc = Mc + kq * kTP;           // [kq][kTP]:   G, then w, at [k0 + i][q0 + q]
  float* Fc = Wc + kq * kTP;           // [kq][kTP]:   f[k0 + i][q0 + q]

  // D[p, q] of this thread's 4 x 4 entries
  float dpq[4][4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + 4 * ty + r, q = q0 + 4 * tx + c;
      dpq[r][c] = p < N && q < N ? D[static_cast<long long>(p) * N + q] : 0.0f;
      acc[r][c] = 0.0f;
    }
  // the epilogue's entries: G's direct share
  constexpr int kSq = kTile * kTile;
  constexpr int kOut = (kSq + T - 1) / T;
  float direct[kOut];

  for (int k0 = 0; k0 < N; k0 += kq) {
    const int kn = min(kq, N - k0), kn4 = (kn + 3) & ~3;
    // D's panels before the wait
    copy_rows<CW, T>(Dq, kp, D, N, q0, k0, kq, tid, true);
    copy_cols<CW, T>(Dc, kTP, D, N, k0, p0, kq, tid);
    cp_commit();
    if (k0 == 0) {
      if (dep) pdl_wait();
      stamp(row, kWaited);
    }
    copy_rows<CW, T>(Mr, kp, M, N, p0, k0, kq, tid, false);
    copy_cols<CW, T>(Mc, kTP, M, N, k0, q0, kq, tid);
    copy_rows<CW, T>(Fr, kp, F, N, p0, k0, kq, tid, false);
    copy_cols<CW, T>(Fc, kTP, F, N, k0, q0, kq, tid);
    copy_rows<CW, T>(Wr, kp, Gin, N, p0, k0, kq, tid, false);
    copy_cols<CW, T>(Wc, kTP, Gin, N, k0, q0, kq, tid);
    cp_commit();
    if (k0 == 0) {
      float out_f[kOut], out_g[kOut];
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const int e = tid + u * T;
        const int p = p0 + e / kTile, q = q0 + e % kTile;
        const bool in = e < kSq && p < N && q < N;
        const long long at = static_cast<long long>(p) * N + q;
        out_f[u] = in ? __ldcg(F + at) : 0.0f;
        out_g[u] = in ? __ldcg(Gin + at) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kOut; ++u) direct[u] = direct_share(out_g[u], out_f[u]);
    }
    cp_wait_all();
    __syncthreads();
    if (k0 == 0) stamp(row, kLoaded);
    w_rows<CW, T>(Wr, Fr, kp, N, p0, k0, kn4, tid);
    w_cols<CW, T>(Wc, Fc, kTP, N, k0, q0, kn4, tid);
    __syncthreads();
    if (k0 == 0) stamp(row, kStaged);
    if (g < kHalf) {
      // D[p, q] as the first operand: candidates (p, q, j) of M[p, j]
      const float* Mp = Mr + 4 * ty * kp;
      const float* Wp = Wr + 4 * ty * kp;
      const float* Dp = Dq + tx * kp;
      for (int qd = g; qd < kn4 / 4; qd += kHalf) {
        float4 mv[4], wv[4], dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          mv[r] = ld4(Mp + r * kp + 4 * qd);
          wv[r] = ld4(Wp + r * kp + 4 * qd);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) dv[c] = ld4(Dp + c * kTY * kp + 4 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float mm = comp(mv[r], e), ww = comp(wv[r], e);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float v = __fadd_rn(dpq[r][c], comp(dv[c], e));
              acc[r][c] = fmaf(v == mm ? 1.0f : 0.0f, ww, acc[r][c]);
            }
          }
      }
    } else {
      // D[p, q] as the second operand: candidates (i, p, q) of M[i, q]
      for (int qd = g - kHalf; qd < kn4 / 4; qd += kHalf) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * qd + e;
          const float4 dc = ld4(Dc + i * kTP + 4 * ty);
          const float4 mc = ld4(Mc + i * kTP + 4 * tx);
          const float4 wc = ld4(Wc + i * kTP + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float v = __fadd_rn(comp(dc, r), dpq[r][c]);
              acc[r][c] = fmaf(v == comp(mc, c) ? 1.0f : 0.0f, comp(wc, c), acc[r][c]);
            }
        }
      }
    }
    __syncthreads();
  }
  stamp(row, kComputed);
  // the groups meet in a fixed order: the row sums, the column sums, then
  // G's direct share
  float* Rs = smem;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Rs[g * kSq + (4 * ty + r) * kTile + 4 * tx + c] = acc[r][c];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int e = tid + u * T;
    const int p = p0 + e / kTile, q = q0 + e % kTile;
    if (e >= kSq || p >= N || q >= N) continue;
    float s1 = Rs[e], s2 = Rs[kHalf * kSq + e];
#pragma unroll
    for (int h = 1; h < kHalf; ++h) {
      s1 += Rs[h * kSq + e];
      s2 += Rs[(kHalf + h) * kSq + e];
    }
    Gout[static_cast<long long>(p) * N + q] = direct[u] + (s1 + s2);
  }
  stamp(row, kEnd);
}

// squaring s's VJP on tile `tile` of matrix b
template <int CW, class P>
__device__ void gather_item(const Args& a, int s, int b, int tile, const float* gin, float* gout,
                            float* smem, bool dep) {
  const int t = min(s, a.lead[b]);
  const long long off = tie_off(a, t, b), mat = static_cast<long long>(b) * a.geo.N * a.geo.N;
  gather_tile<CW, P>(slice_of(a, t, b), a.tie_m + off, a.tie_f + off, gin + mat, gout + mat, a.geo,
                  tile / a.geo.tiles_x * kTile, tile % a.geo.tiles_x * kTile, smem, dep,
                  a.geo.iters - s);
}

// the slice the chain's first squaring (s = iters - 1) reads
template <int CW, class P>
__device__ void first_ties_item(const Args& a, int b, int tile, float* smem) {
  tie_item<CW, P>(a, min(a.geo.iters - 1, a.lead[b]), b, tile, smem, 0);
}

// beside squaring s (> 0): the tie data of slice s - 1, which squaring
// s - 1 reads where s - 1 < lead[b] (from there on it reads slice
// lead[b], which the first launch took)
template <int CW, class P>
__device__ void next_ties_item(const Args& a, int s, int b, int tile, float* smem) {
  if (s - 1 < a.lead[b]) tie_item<CW, P>(a, s - 1, b, tile, smem, kClockRows / 2 + a.geo.iters - s);
}

template <int CW, class P>
__global__ void __launch_bounds__(P::T, P::kMinBlocks)
bwd_ties_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  pdl_trigger();  // the chain's first launch may start
  first_ties_item<CW, P>(a, blockIdx.y, blockIdx.x, smem);
}

// squaring s's VJP (blockIdx.z = 1, or the whole grid where gridDim.z =
// 1); where gridDim.z = 2, blockIdx.z = 0 takes the next squaring's tie
// data, which needs no wait
template <int CW, class P>
__global__ void __launch_bounds__(P::T, P::kMinBlocks)
bwd_gather_kernel(const Args a, int s, const float* __restrict__ gin, float* __restrict__ gout) {
  extern __shared__ __align__(16) float smem[];
  if (s > 0) pdl_trigger();  // the next squaring's launch may start; after the last, none
  if (gridDim.z == 2 && blockIdx.z == 0) {
    next_ties_item<CW, P>(a, s, blockIdx.y, blockIdx.x, smem);
    return;
  }
  gather_item<CW, P>(a, s, blockIdx.y, blockIdx.x, gin, gout, smem, true);
}

// raises `kernel`'s dynamic shared memory cap to `bytes` on the current
// card, once per kernel and card (a cap only grows)
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static int raised[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && raised[device] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64) raised[device] = bytes;
  return err;
}

template <int CW, class P>
int run(const Args& a, const float* g, float* out, float* tmp, cudaStream_t st) {
  const Geo& geo = a.geo;
  const int tiles = geo.tiles_x * geo.tiles_x;
  const int tie_words = tie_smem_words<P>(geo), gather_words = gather_smem_words<P>(geo);
  // the chain's launches also hold tie blocks
  const int gather_bytes = 4 * (tie_words > gather_words ? tie_words : gather_words);
  cudaError_t err = allow_smem<bwd_ties_kernel<CW, P>>(4 * tie_words);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem<bwd_gather_kernel<CW, P>>(gather_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_ties_kernel<CW, P><<<dim3(tiles, geo.B), P::T, 4 * tie_words, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(P::T);
  cfg.dynamicSmemBytes = gather_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // squaring s writes `out` where s is even, so that squaring 0 ends there
  for (int s = geo.iters - 1; s >= 0; --s) {
    const float* gin = s == geo.iters - 1 ? g : (s % 2 ? out : tmp);
    float* gout = s % 2 ? tmp : out;
    cfg.gridDim = dim3(tiles, geo.B, s > 0 ? 2 : 1);
    err = cudaLaunchKernelEx(&cfg, bwd_gather_kernel<CW, P>, a, s, gin, gout);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// the launch's geometry for (B, N, iters)
Geo geometry(int B, int N, int iters) {
  const int n4 = (N + 3) & ~3, kq = n4 < kChunk ? n4 : kChunk;
  return Geo{N, B, iters, (N + kTile - 1) / kTile, kq, kq + ((kq / 4) % 2 == 0 ? 4 : 8)};
}

// Wide where a squaring's gather blocks fit kWideAt an SM of this card
bool wide_plan(const Geo& geo) {
  if (kPlan >= 0) return kPlan == 1;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<long long>(geo.tiles_x) * geo.tiles_x * geo.B <=
         static_cast<long long>(kWideAt) * sms;
}

}  // namespace

// The cotangent of the input of `iters` squarings of (B, N, N) float32
// matrices from `g`, the cotangent of their result, all on `stream`:
// 1 + iters launches (see the note above).  Returns the cudaError_t of the
// first failed call (0 = success).  stack: the forward's slices, `slice`
// elements apart (slice t = the input of squaring t where it ran); lead
// (B,) int32; g, out, tmp (B, N, N); tie_m and tie_f (iters, B, N, N)
// scratch; all float32 but lead, contiguous, g distinct from out and tmp.
extern "C" int mho_minplus_closure_bwd_f32(const void* stack, long long slice, const void* lead,
                                           int iters, const void* g, void* out, void* tmp,
                                           void* tie_m, void* tie_f, int B, int N,
                                           void* stream) {
  if (iters <= 0 || B <= 0 || N <= 0) return 0;
  if (B > 65535 || iters > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Geo geo = geometry(B, N, iters);
  const Args a{static_cast<const float*>(stack), slice, static_cast<const int*>(lead),
               static_cast<float*>(tie_m), static_cast<float*>(tie_f), geo};
  const uintptr_t at = reinterpret_cast<uintptr_t>(stack) | reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(tmp) |
                       reinterpret_cast<uintptr_t>(tie_m) | reinterpret_cast<uintptr_t>(tie_f) |
                       static_cast<uintptr_t>(slice * 4);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  float* tp = static_cast<float*>(tmp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_plan(geo);
  if (N % 4 == 0 && at % 16 == 0)
    return wide ? run<4, Wide>(a, gp, op, tp, st) : run<4, Full>(a, gp, op, tp, st);
  return wide ? run<1, Wide>(a, gp, op, tp, st) : run<1, Full>(a, gp, op, tp, st);
}

// The plan the launcher picks for (B, N), for logs and benches: info[0..4]
// = 1 for Wide (0 Full), threads a block, blocks a squaring's gather,
// dynamic shared bytes of a chain launch and of the first launch.
extern "C" int mho_minplus_closure_bwd_plan(int B, int N, int* info) {
  const Geo geo = geometry(B, N, 1);
  const bool wide = wide_plan(geo);
  const int gw = wide ? gather_smem_words<Wide>(geo) : gather_smem_words<Full>(geo);
  const int tw = wide ? tie_smem_words<Wide>(geo) : tie_smem_words<Full>(geo);
  info[0] = wide;
  info[1] = wide ? Wide::T : Full::T;
  info[2] = geo.tiles_x * geo.tiles_x * B;
  info[3] = 4 * (tw > gw ? tw : gw);
  info[4] = 4 * tw;
  return 0;
}

// kClock's timeline of the launches since the last read (bench-only): out
// receives kClockRows x kClockSlots uint64 (ns of %globaltimer; the slots'
// order as `kStart` ...), and the rows are reset.  Returns the cudaError_t.
extern "C" int mho_minplus_closure_bwd_clock(void* out) {
  static unsigned long long fresh[kClockRows][kClockSlots];
  cudaError_t err = cudaSuccess;
  if (out != nullptr) err = cudaMemcpyFromSymbol(out, g_clock, sizeof(fresh));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (auto& row : fresh)
    for (int f = 0; f < kClockSlots; ++f)
      row[f] = f == kStart || f == kEndFirst ? ~0ULL : 0ULL;
  return static_cast<int>(cudaMemcpyToSymbol(g_clock, fresh, sizeof(fresh)));
}
