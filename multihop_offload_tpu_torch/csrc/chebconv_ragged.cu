// K5's index: a stable counting sort of each slot's live prefix, by row
// and by column, on the card.
//
// K5 is the ChebConv propagate over the live prefix of a padded edge list,
//
//     out[b, r, f] = diag[b, r] * x[b, r, f]
//                  + sum_{e < live[b], rows[b, e] == r} vals[b, e] * x[b, cols[b, e], f],
//
// and replaces the TPU kernel `multihop_offload_tpu/ops/chebconv.py:
// chebconv_propagate_ragged` (`_chebconv_ragged_kernel`), which takes the
// live count as a scalar-prefetch argument and skips every 512-edge block
// past it, so one compiled program serves every occupancy.  Here the live
// counts are a (B,) int32 tensor in device memory that this kernel reads
// itself: the host never reads them, and one launch serves every
// occupancy.  The live entries may come in any row order (the JAX tests
// draw random rows), so the host CSR index of K4 cannot be used: this
// kernel makes it on the card, and the row walk of `chebconv.cu` then
// computes the propagate (forward over the row index, d x over the column
// index), so K4 and K5 run the same walk.
//
// Output, per slot b with n = clamp(live[b], 0, cap) and key k(e) =
// rows[b, e] (resp. cols) for e < n when it lies in [0, E), else E:
// - ptr (B, E + 1): ptr[b, r] = #{e : k(e) < r}; ptr[b, E] is the count
//   of in-range live entries, so row r's entries are [ptr[r], ptr[r + 1]);
// - order (B, cap): the entry ids sorted by key, stably, every entry past
//   the live prefix as key E: exactly `argsort(k, kind="stable")`.  The
//   walk never reads order past ptr[E]: a live entry whose row is out of
//   range, and every pad, is skipped.
//
// What bounds it on an H100: latency.  A slot holds a few thousand
// entries (8 bytes each, read once; 8 more written per key), so bytes
// would take well under a microsecond; the sort is a few dependent
// passes over shared memory between block barriers.
//
// Design: one block of kWarps warps per slot and key (grid (B, 2): the
// row sort and the column sort of a slot run side by side).
// 1. Staging: thread 0 starts Hopper's 1-D bulk asynchronous copy
//    (`cp.async.bulk`, completion on an `mbarrier`) of the keys [0, n)
//    into shared memory.  A bulk copy takes 16-byte aligned addresses and
//    a length that is a multiple of 16 bytes, and slot b's range starts
//    at byte 4 b cap of its list, so the list is copied as its aligned
//    interior: the up to 3 entries before the first 16-byte boundary and
//    the up to 3 after the last are loaded by ordinary threads.  The
//    shared buffer is shifted by (address / 4) mod 4 entries so that the
//    interior lands on a 16-byte boundary there too.
// 2. Histograms: warp w counts the keys of its own contiguous segment of
//    [0, n) into its own column hist[key][w] (int32, shared-memory
//    atomics; the order of the counts does not matter).
// 3. Scan: an exclusive scan of hist in (key, warp) order gives each warp
//    its first position in every key's bucket; hist[r][0] is ptr[b, r].
// 4. Scatter: each warp walks its segment again in list order, 32 entries
//    a step; `__match_any_sync` groups equal keys, an entry's position is
//    its warp's start in its bucket plus its rank among the equal keys of
//    lower lanes, and the group's lowest lane then advances the start.
//    Warps own ascending segments and a warp places its entries in list
//    order, so each bucket holds its entries in list order: the sort is
//    stable.  Entries past n are placed at their own index (the key-E
//    tail, in order).
//
// Caps: E <= kMaxE and cap <= kMaxCap, so that the staged list and the
// histogram fit in one block's shared memory (at the caps 64 KB + 128 KB
// of the 227 KB); the wrapper raises above them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxE = 2048;
constexpr int kMaxCap = 16384;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Entries of [0, n) before the first 16-byte boundary of a list whose
// slot starts `shift` entries past one, and the entries of the aligned
// interior after them (a multiple of 4).
__device__ __forceinline__ int head_of(int n, int shift) { return min(n, (4 - shift) & 3); }
__device__ __forceinline__ int body_of(int n, int shift) {
  return ((n - head_of(n, shift)) / 4) * 4;
}

// Stages entries [0, n) of `src` at dst[shift + e]: thread 0 issues the
// aligned interior as one bulk copy that completes on `bar` (armed for its
// bytes beforehand), the other threads load the head and the tail.
__device__ __forceinline__ void stage_list(const int* src, int n, int* dst, int shift,
                                           uint64_t* bar, int tid) {
  const int head = head_of(n, shift);
  const int body = body_of(n, shift);
  if (tid == 0 && body > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst + shift + head)), "l"(src + head),
           "r"(static_cast<unsigned>(body) * 4u), "r"(smem_addr(bar))
        : "memory");
  }
  for (int i = tid; i < head; i += kThreads) dst[shift + i] = src[i];
  for (int i = head + body + tid; i < n; i += kThreads) dst[shift + i] = src[i];
}

// One stable counting sort of keys[e], e < n, into (ptr, order).
__device__ void sort_keys(const int* keys, int n, int cap, int E, int* hist, int* warp_sums,
                          int* __restrict__ ptr, int* __restrict__ order) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int buckets = E + 1;
  const int total = buckets * kWarps;
  for (int i = tid; i < total; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int seg = (n + kWarps - 1) / kWarps;
  const int s0 = min(n, warp * seg);
  const int s1 = min(n, s0 + seg);
  const unsigned lower = (1u << lane) - 1u;
  // 2. per-warp histograms (shared-memory atomics into the warp's column)
  for (int e = s0 + lane; e < s1; e += 32) {
    const int k = keys[e];
    atomicAdd(&hist[(static_cast<unsigned>(k) < static_cast<unsigned>(E) ? k : E) * kWarps + warp],
              1);
  }
  __syncthreads();

  // 3. exclusive scan in (key, warp) order: a serial run per thread, then
  // a block scan of the runs' sums
  const int per = (total + kThreads - 1) / kThreads;
  const int t0 = min(total, tid * per);
  const int t1 = min(total, t0 + per);
  int run = 0;
  for (int i = t0; i < t1; ++i) run += hist[i];
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int start = incl - run + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = t0; i < t1; ++i) {
    const int h = hist[i];
    hist[i] = start;
    start += h;
  }
  __syncthreads();
  for (int r = tid; r < buckets; r += kThreads) ptr[r] = hist[r * kWarps];
  __syncthreads();  // the scatter below advances hist[r][0]

  // 4. scatter in list order; the tail past n keeps its own index
  for (int c = s0; c < s1; c += 32) {
    const int e = c + lane;
    const bool valid = e < s1;
    const unsigned active = __ballot_sync(kFull, valid);
    unsigned peers = 0;
    int key = 0, base = 0;
    if (valid) {
      const int k = keys[e];
      key = static_cast<unsigned>(k) < static_cast<unsigned>(E) ? k : E;
      peers = __match_any_sync(active, key);
      base = hist[key * kWarps + warp];
      order[base + __popc(peers & lower)] = e;
    }
    __syncwarp();
    if (valid && (peers & lower) == 0) hist[key * kWarps + warp] = base + __popc(peers);
    __syncwarp();
  }
  for (int e = n + tid; e < cap; e += kThreads) order[e] = e;
}

__global__ void __launch_bounds__(kThreads)
ragged_index_kernel(const int* __restrict__ rows,   // (B, cap)
                    const int* __restrict__ cols,   // (B, cap)
                    const int* __restrict__ live,   // (B,)
                    int* __restrict__ row_ptr,      // (B, E + 1)
                    int* __restrict__ row_order,    // (B, cap)
                    int* __restrict__ col_ptr,      // (B, E + 1)
                    int* __restrict__ col_order,    // (B, cap)
                    int E, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* warp_sums = reinterpret_cast<int*>(smem + 16);
  int* s_keys = reinterpret_cast<int*>(smem + 16 + 32 * 4);
  int* hist = s_keys + ((cap + 3) / 4) * 4 + 4;

  const int b = blockIdx.x;
  const bool by_col = blockIdx.y == 1;
  const int tid = threadIdx.x;
  const int n = min(max(live[b], 0), cap);
  const long long lb = static_cast<long long>(b) * cap;
  const int* src = (by_col ? cols : rows) + lb;
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) / 4) & 3);

  // 1. staging: one mbarrier, one arrival (thread 0) that arms it for the
  // bulk copy's bytes before the copy is issued
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(4u * static_cast<unsigned>(body_of(n, shift)))
                 : "memory");
  }
  __syncthreads();
  stage_list(src, n, s_keys, shift, bar, tid);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  }
  __syncthreads();  // the head and tail entries the threads loaded

  const long long pb = static_cast<long long>(b) * (E + 1);
  sort_keys(s_keys + shift, n, cap, E, hist, warp_sums, (by_col ? col_ptr : row_ptr) + pb,
            (by_col ? col_order : row_order) + lb);
}

}  // namespace

// Launches the sort on `stream`; returns the cudaError_t of the launch (0 =
// success), or cudaErrorInvalidValue above the caps.  rows, cols (B, cap)
// int32; live (B,) int32 in device memory; row_ptr, col_ptr (B, E + 1) and
// row_order, col_order (B, cap) int32 outputs; all contiguous.
extern "C" int mho_ragged_index(const void* rows, const void* cols, const void* live,
                                void* row_ptr, void* row_order, void* col_ptr,
                                void* col_order, int B, int E, int cap, void* stream) {
  if (E < 1 || E > kMaxE || cap < 1 || cap > kMaxCap || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 16 + 32 * 4 + (static_cast<size_t>((cap + 3) / 4) * 4 + 4) * 4 +
                      static_cast<size_t>(E + 1) * kWarps * 4;
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  ragged_index_kernel<<<dim3(B, 2), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const int*>(live), static_cast<int*>(row_ptr),
      static_cast<int*>(row_order), static_cast<int*>(col_ptr),
      static_cast<int*>(col_order), E, cap);
  return static_cast<int>(cudaGetLastError());
}
