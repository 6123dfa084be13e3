// Conflict-interference fixed point, batched: one thread block per instance.
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/fixed_point.py:
// fixed_point_pallas` (`_pallas_call` -> `_fp_kernel`).  Computes, for each
// instance b of the batch,
//
//     mu_0 = rate / (cf + 1)
//     10x: busy = clip(lambda / mu, 0, 1);  mu = rate / (1 + A @ busy)
//
// with A the (L, L) 0/1 conflict adjacency (`env/queueing.py:51-73`).  A
// nonzero entry is read as 1; A need not be symmetric (the row i sum is
// sum_j A[i][j] busy[j]).
//
// What bounds it on an H100: bytes.  The function must read A once
// (B * L^2 * 4 bytes; 11.9 MB at B=64, L=216: 3.63 us at 3.35 TB/s) and
// does two operations per conflict a round, far below the card's
// operations-per-byte balance.
//
// The design: one block of 1,024 threads per instance, A read from device
// memory once, nothing read from it inside the rounds.
// - The pass over A reads it as a flat run of L^2 floats, 16-byte loads,
//   kVec in flight per thread (64 KB per SM), any L and any alignment (a
//   ragged head before the first 16-byte boundary and the tail are read
//   as floats).  A nonzero entry sets its bit in a shared-memory bitmask
//   by an atomic OR: the bits do not depend on the order of the threads.
//   The vectors are read once, beside A, into shared memory.
// - Each row's set columns are then written as a list (uint16, ascending):
//   warp w owns a block of rows, a lane a row: degrees, prefix sums within
//   the warp and across the warps (one barrier), the columns.  The lists
//   take what shared memory is left after the bitmask; if a dense A does
//   not fit, the rounds walk the bitmask instead.
// - The rounds: busy in two buffers, one barrier a round.  T lanes a row
//   (4, or 2 or 1 at larger L, so that every row is in one pass) sum every
//   T-th entry of its list in order, then a fixed shuffle tree; the row's
//   first lane computes mu and the next busy.  The bitmask walk: a warp a
//   row, lane l adds busy[32 w + l] (kept in a register) where bit l of
//   word w is set, w ascending, then a fixed shuffle tree.  Every sum has
//   a fixed order: the same inputs give the same bits on every call.
//
// Measured on an H100 (`scripts/bench_fixed_point.py`; PERF.md §6): at
// B=64, L=216 the launch takes ~23 us against ~48 for the first design (a
// thread per (row, word) walking its set bits, three barriers a round,
// the vectors read again each round, A read ~2 loads deep): the pass over A
// ~10 us with the launch (~1.15 TB/s over 64 SMs), the lists ~4 us, the
// rounds ~0.9 us each.  The rounds cannot reach the bound: each is a
// dependent chain across the block (the gathers along the longest list,
// the shuffle tree, two correctly rounded divisions, the barrier); ten of
// them are ~9 us of the 23, 2.5x the bound of the whole function, with no
// byte of device memory moved.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // threads per block
constexpr int kVec = 4;         // 16-byte loads of A in flight per thread
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr int kMaxL = 928;        // the wrapper's cap (29 words a row)
constexpr int kWarps = kThreads / 32;
// rows a lane holds while the lists are built: warp w owns ceil(L / kWarps)
constexpr int kRowSlots = ((kMaxL + kWarps - 1) / kWarps + 31) / 32;

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ float clip01(float x) {
  // clip(x, 0, 1); a NaN passes through, as jnp.clip / torch.clamp do
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// kWords: the most 32-column words a row may have (the bitmask walk keeps
// one busy value a word in each lane's registers)
template <int kWords>
__global__ void __launch_bounds__(kThreads, 1)
fixed_point_kernel(const float* __restrict__ adj,
                   const float* __restrict__ rates,
                   const float* __restrict__ cf,
                   const float* __restrict__ lam,
                   float* __restrict__ mu_out,
                   int L, int iters, int list_cap) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = (L + 31) >> 5;
  const int stride = words | 1;  // odd row stride: 32 rows hit 32 banks
  uint32_t* bits = smem;         // word w of row i at bits[i * stride + w]
  float* busy = reinterpret_cast<float*>(bits + L * stride);  // two buffers of L
  float* rate_s = busy + 2 * L;
  float* lam_s = rate_s + L;
  uint32_t* warp_total = reinterpret_cast<uint32_t*>(lam_s + L);  // kWarps
  uint32_t* row_ptr = warp_total + kWarps;  // L + 1
  uint16_t* list = reinterpret_cast<uint16_t*>(row_ptr + L + 1);  // list_cap
  float* sum_s = reinterpret_cast<float*>(list);  // the bitmask walk's row sums

  const size_t off = static_cast<size_t>(blockIdx.x) * L;
  const float* A = adj + off * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // an empty bitmask; then the vectors, read once (mu_0 and the first
  // busy), with their loads in flight beside those of A
  for (int k = threadIdx.x; k < L * stride; k += kThreads) bits[k] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const float r = rates[off + i], l = lam[off + i];
    const float m0 = r / (cf[off + i] + 1.0f);
    rate_s[i] = r;
    lam_s[i] = l;
    busy[i] = clip01(l / m0);
    if (iters == 0) mu_out[off + i] = m0;
  }

  // one pass over A, read as a flat stream of L^2 floats: kVec 16-byte loads
  // in flight per thread (a ragged head before the first 16-byte boundary
  // and the tail read as floats); a nonzero entry sets its bit by an OR,
  // whose result does not depend on the order of the threads
  const int n = L * L;
  auto mark = [&](int f, float x) {
    if (x != 0.0f) {
      const int i = f / L, c = f - i * L;
      atomicOr(&bits[i * stride + (c >> 5)], 1u << (c & 31));
    }
  };
  const int head = min(n, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(A) & 15)) & 15) >> 2));
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  const float4* A4 = reinterpret_cast<const float4*>(A + head);
  if (static_cast<int>(threadIdx.x) < head) mark(threadIdx.x, A[threadIdx.x]);
  if (static_cast<int>(threadIdx.x) < n - tail)
    mark(tail + threadIdx.x, A[tail + threadIdx.x]);
  for (int v0 = threadIdx.x; v0 < nvec; v0 += kVec * kThreads) {
    float4 v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int k = v0 + u * kThreads;
      v[u] = k < nvec ? __ldg(A4 + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if (v[u].x != 0.0f || v[u].y != 0.0f || v[u].z != 0.0f || v[u].w != 0.0f) {
        const int f = head + 4 * (v0 + u * kThreads);
        mark(f, v[u].x);
        mark(f + 1, v[u].y);
        mark(f + 2, v[u].z);
        mark(f + 3, v[u].w);
      }
    }
  }
  if (iters == 0) return;
  __syncthreads();

  // each row's set columns as a list, ascending, where they fit.  Warp w
  // owns rows [w R, w R + R), a lane a row: their degrees, the prefix sums
  // within the warp and then across the warps, and each row's columns
  const int R = (L + kWarps - 1) / kWarps;
  const int r_lo = warp * R;
  uint32_t excl[kRowSlots];
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kRowSlots; ++k) {
    const int j = lane + 32 * k, r = r_lo + j;
    uint32_t d = 0;
    if (j < R && r < L)
      for (int w = 0; w < words; ++w) d += __popc(bits[r * stride + w]);
    const uint32_t inc = warp_inclusive_sum(d, lane);
    excl[k] = run + inc - d;
    run += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) warp_total[warp] = run;
  __syncthreads();
  const uint32_t t = lane < kWarps ? warp_total[lane] : 0u;
  const uint32_t t_inc = warp_inclusive_sum(t, lane);
  const uint32_t base = __shfl_sync(0xffffffffu, t_inc - t, warp);
  const uint32_t total = __shfl_sync(0xffffffffu, t_inc, 31);
  const bool lists = total <= static_cast<uint32_t>(list_cap);
#pragma unroll
  for (int k = 0; k < kRowSlots; ++k) {
    const int j = lane + 32 * k, r = r_lo + j;
    if (j < R && r < L) {
      uint32_t pos = base + excl[k];
      row_ptr[r] = pos;
      if (lists)
        for (int w = 0; w < words; ++w)
          for (uint32_t m = bits[r * stride + w]; m; m &= m - 1)
            list[pos++] = static_cast<uint16_t>(32 * w + __ffs(m) - 1);
    }
  }
  if (threadIdx.x == 0) row_ptr[L] = total;
  __syncthreads();

  // the rounds: each reads busy from one buffer and writes the next busy
  // into the other, so one barrier a round separates them
  // lanes a row: the most, up to 4, that keep every row in one pass
  constexpr int T = kWords <= 8 ? 4 : (kWords <= 16 ? 2 : 1);
  for (int it = 0; it < iters; ++it) {
    const float* cur = busy + (it & 1) * L;
    float* nxt = busy + ((it + 1) & 1) * L;
    const bool last = it == iters - 1;
    if (lists) {
      // T lanes a row, each summing every T-th entry of its list in order,
      // then a fixed shuffle tree; the row's first lane finishes it
      const int q = threadIdx.x % T;
      const int groups = kThreads / T;
      for (int r0 = 0; r0 < L; r0 += groups) {
        const int r = r0 + static_cast<int>(threadIdx.x) / T;
        float s = 0.0f;
        if (r < L) {
          const uint32_t end = row_ptr[r + 1];
          for (uint32_t e = row_ptr[r] + q; e < end; e += T) s += cur[list[e]];
        }
#pragma unroll
        for (int o = T / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (q == 0 && r < L) {
          const float m = rate_s[r] / (1.0f + s);
          if (last) mu_out[off + r] = m;
          else nxt[r] = clip01(lam_s[r] / m);
        }
      }
    } else {
      // bitmask walk: a warp a row; lane l adds busy[32 w + l], kept in a
      // register, where bit l of word w is set, w ascending; a fixed
      // shuffle tree; then each lane finishes the warp's rows k = lane mod 32
      float b[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int c = 32 * w + lane;
        b[w] = (w < words && c < L) ? cur[c] : 0.0f;
      }
      for (int r = warp; r < L; r += kWarps) {
        const uint32_t* row = bits + r * stride;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          if (w < words && ((row[w] >> lane) & 1u)) s += b[w];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) sum_s[r] = s;
      }
      __syncwarp();
      for (int r = warp + lane * kWarps; r < L; r += 32 * kWarps) {
        const float m = rate_s[r] / (1.0f + sum_s[r]);
        if (last) mu_out[off + r] = m;
        else nxt[r] = clip01(lam_s[r] / m);
      }
    }
    if (!last) __syncthreads();
  }
}

template <int kWords>
int launch(const void* adj, const void* rates, const void* cf, const void* lam,
           void* mu, int B, int L, int iters, int list_cap, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fixed_point_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fixed_point_kernel<kWords><<<B, kThreads, smem, stream>>>(
      static_cast<const float*>(adj), static_cast<const float*>(rates),
      static_cast<const float*>(cf), static_cast<const float*>(lam),
      static_cast<float*>(mu), L, iters, list_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// adj (B, L, L), rates/cf/lam/mu (B, L): float32, contiguous, on the card.
extern "C" int mho_fixed_point_f32(const void* adj, const void* rates,
                                   const void* cf, const void* lam, void* mu,
                                   int B, int L, int iters, void* stream) {
  const int words = (L + 31) / 32;
  if (L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(L);
  // bitmask (L x odd stride), busy twice, rates, lambdas, the warps'
  // totals, row offsets (L + 1)
  const size_t fixed = 4 * (n * (words | 1) + 5 * n + kWarps + 1);
  // the lists take the rest, up to a dense A; at least the row sums' room
  size_t list_bytes = 2 * n * n > 4 * n ? 2 * n * n : 4 * n;
  if (fixed + list_bytes > kSmemMax)
    list_bytes = fixed < kSmemMax ? (kSmemMax - fixed) & ~static_cast<size_t>(3) : 0;
  if (list_bytes < 4 * n) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + list_bytes;
  const int cap = static_cast<int>(list_bytes / 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words <= 4) return launch<4>(adj, rates, cf, lam, mu, B, L, iters, cap, smem, s);
  if (words <= 8) return launch<8>(adj, rates, cf, lam, mu, B, L, iters, cap, smem, s);
  if (words <= 16) return launch<16>(adj, rates, cf, lam, mu, B, L, iters, cap, smem, s);
  return launch<29>(adj, rates, cf, lam, mu, B, L, iters, cap, smem, s);
}
