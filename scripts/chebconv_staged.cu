// Bench-only copy of a staged form of K4's bf16 walks, tried on an H100 and
// not kept in the package (PERF.md §6, PR 16): the package's walks
// (`multihop_offload_tpu_torch/csrc/chebconv_bf16.cu`) read device memory
// row by row, each row a chain of dependent loads (ptr, then index and
// vals, under the transposed walk `order` before them, then x).  This form
// removes that chain: a block takes a slice of rows of one instance, x[b]
// and diag[b] go to shared memory by one bulk copy on an mbarrier while
// the threads load ptr[b], the threads then gather the slice's entries in
// walk order into 8-byte words, and the walk reads shared memory alone.
// It gives the row walk's bits.  Measured, it lost to the row walk at
// (64, 328, 32) (a block spends ~1.7 us staging, and an instance's long
// rows fall in one block) and tied it at (16, 328, 4).
//
// Driven by `scripts/bench_chebconv_staged.py`, which builds copies with
// `constexpr int`s set (`--variant TAG=scripts/chebconv_staged.cu:NAME=VALUE`):
//
//   kClock = 1   thread 0 of each block adds its clock64 split (loads
//                issued and ptr in; staged; walked) to `g_clock`, with the
//                blocks, the longest block and the longest walk, read by
//                `mho_chebconv_staged_clock`.
//   kSteps       entries of a row whose loads a step of the walk issues
//                together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kStagedThreads = 1024;  // the most a block
constexpr int kSteps = 4;
constexpr int kClock = 0;
__device__ unsigned long long g_clock[6];

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);  // exact: a bf16 is a float's top half
}

__device__ __forceinline__ unsigned float_to_bf16_bits(float a) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(a));
}

__device__ __forceinline__ float round_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

// element j of a word of 32-bit lanes, each holding two bf16 (low first)
template <typename Words>
__device__ __forceinline__ float word_elem(const Words& w, int j) {
  const unsigned* u = reinterpret_cast<const unsigned*>(&w);
  return bf16_bits_to_float((j & 1) ? (u[j >> 1] >> 16) : (u[j >> 1] & 0xffffu));
}

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = unsigned short;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[1]) {
    *p = __float2bfloat16_rn(a[0]);
  }
  static __device__ __forceinline__ float get(const T& v, int) { return bf16_bits_to_float(v); }
  // acc += bf16(v * x) for the word's bf16; v2 holds v's bf16 bits twice;
  // R: each sum rounded to bf16 (the transposed walk)
  template <bool R>
  static __device__ __forceinline__ void madd(float (&acc)[1], const T& w, unsigned v2) {
    const __nv_bfloat16 p = __hmul(__ushort_as_bfloat16(w),
                                   __ushort_as_bfloat16(static_cast<unsigned short>(v2)));
    acc[0] = __fadd_rn(acc[0], __bfloat162float(p));
    if constexpr (R) acc[0] = round_bf16(acc[0]);
  }
};
template <> struct Vec<4> {
  using T = uint2;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[4]) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(float_to_bf16_bits(a[0]) | (float_to_bf16_bits(a[1]) << 16),
                   float_to_bf16_bits(a[2]) | (float_to_bf16_bits(a[3]) << 16));
  }
  static __device__ __forceinline__ float get(const T& v, int j) { return word_elem(v, j); }
  template <bool R>
  static __device__ __forceinline__ void madd(float (&acc)[4], const T& w, unsigned v2) {
    const __nv_bfloat162 lo = __hmul2(as_bf162(w.x), as_bf162(v2));
    const __nv_bfloat162 hi = __hmul2(as_bf162(w.y), as_bf162(v2));
    acc[0] = __fadd_rn(acc[0], __low2float(lo));
    acc[1] = __fadd_rn(acc[1], __high2float(lo));
    acc[2] = __fadd_rn(acc[2], __low2float(hi));
    acc[3] = __fadd_rn(acc[3], __high2float(hi));
    if constexpr (R) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = round_bf16(acc[j]);
    }
  }
};

template <> struct Vec<8> {  // the staged form's word (shared memory only)
  using T = uint4;
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(float_to_bf16_bits(a[0]) | (float_to_bf16_bits(a[1]) << 16),
                   float_to_bf16_bits(a[2]) | (float_to_bf16_bits(a[3]) << 16),
                   float_to_bf16_bits(a[4]) | (float_to_bf16_bits(a[5]) << 16),
                   float_to_bf16_bits(a[6]) | (float_to_bf16_bits(a[7]) << 16));
  }
  static __device__ __forceinline__ float get(const T& v, int j) { return word_elem(v, j); }
  template <bool R>
  static __device__ __forceinline__ void madd(float (&acc)[8], const T& w, unsigned v2) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 pr = __hmul2(as_bf162(u[h]), as_bf162(v2));
      acc[2 * h] = __fadd_rn(acc[2 * h], __low2float(pr));
      acc[2 * h + 1] = __fadd_rn(acc[2 * h + 1], __high2float(pr));
    }
    if constexpr (R) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = round_bf16(acc[j]);
    }
  }
};

// ---- the staged form -----------------------------------------------------
//
// One block per (instance b, slice of S rows), one block an SM where the
// batch allows: its loads go out first, and the walk then reads shared
// memory alone.  Thread 0 starts an asynchronous bulk copy
// (`cp.async.bulk`, completing on an mbarrier) of the whole x[b] and of the
// slice's diag, while every thread loads the slice's ptr entries; once
// those are in, every thread gathers the slice's entries, in walk order,
// into one 8-byte word each (gather id, value twice): the forward's are
// the row range of index and vals, the transposed walk's the entries
// order names for its columns.  So a step of the walk reads one word an
// entry and one x word a lane, with no lookup behind another.  A bulk
// copy needs 16-byte-aligned addresses and sizes: x and diag are widened
// to the 16-byte boundaries of the flat array around them (the extra
// elements are never read), and one whose array is not 16-byte aligned, or
// whose widened end would pass the array's end, is copied by plain loads
// of every thread instead.  The walk is the row walk's arithmetic (the
// same products, the same fp32 adds in list order, each rounded under T),
// so it gives the row walk's bits.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for phase 0 of the mbarrier at `bar`.  A wait that outlasts ~2^26
// polls (seconds) traps: a lost copy fails the launch, not hangs it.
__device__ __forceinline__ void bar_wait(uint32_t bar) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
    if (polls > (1 << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* to, const void* from, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(to)), "l"(from), "r"(bytes), "r"(bar) : "memory");
}

// Elements [lo, hi) of a flat array of n bf16, staged from the 16-byte
// boundary at or below lo up to the one at or above hi, or n: element lo
// lands at `shift` in shared memory.
struct Span {
  const __nv_bfloat16* base;
  long long start, end;
  int shift;
  __device__ Span(const __nv_bfloat16* base_, long long lo, long long hi, long long n)
      : base(base_) {
    start = lo - lo % 8;
    end = min((hi + 7) / 8 * 8, n);
    shift = static_cast<int>(lo - start);
  }
  __device__ uint32_t bytes() const { return static_cast<uint32_t>((end - start) * 2); }
  // by one bulk copy, or (false) by every thread's plain loads
  __device__ bool bulk() const {
    return reinterpret_cast<uintptr_t>(base) % 16 == 0 && bytes() % 16 == 0 && bytes() > 0;
  }
  __device__ void issue(__nv_bfloat16* to, uint32_t bar) const {
    if (bulk()) bulk_copy(to, base + start, bytes(), bar);
  }
  __device__ void plain(__nv_bfloat16* to, int tid, int nthreads) const {
    if (bulk()) return;
    for (long long i = start + tid; i < end; i += nthreads) to[i - start] = base[i];
  }
};

__host__ __device__ constexpr int round16(long long bytes) {
  return static_cast<int>((bytes + 15) / 16 * 16);
}

// The shared bytes a block of the staged form takes
// (`scripts/bench_chebconv_staged.py:staged_smem_bytes` computes the
// same): x and diag (bf16, with room for their widening), ptr (int32) and
// the slice's entries (8 bytes each, at most the padded count, and one
// more that an empty row's first read may reach).
__host__ __device__ constexpr int staged_smem(int E, int F, int nnz) {
  return round16((static_cast<long long>(E) * F + 16) * 2) + round16((E + 16) * 2LL) +
         round16((E + 1) * 4LL) + round16((nnz + 1) * 8LL);
}

template <int G, int V, bool T>
__global__ void __launch_bounds__(kStagedThreads)
chebconv_bf16_staged(const int* __restrict__ ptr,             // (B, E + 1)
                     const int* __restrict__ order,           // (B, nnz) entry ids (T)
                     const int* __restrict__ index,           // (B, nnz) gather ids
                     const __nv_bfloat16* __restrict__ vals,  // (B, nnz)
                     const __nv_bfloat16* __restrict__ diag,  // (B, E)
                     const __nv_bfloat16* __restrict__ x,     // (B, E, F)
                     __nv_bfloat16* __restrict__ out,         // (B, E, F)
                     int B, int E, int F, int nnz, int S) {
  using VT = Vec<V>;
  using W = typename VT::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar_storage;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x / S;
  const int R = (E + S - 1) / S;
  const int r0 = min(static_cast<int>(blockIdx.x % S) * R, E);  // the slice's rows
  const int nr = min(r0 + R, E) - r0;
  if (nr <= 0) return;  // block-uniform
  // the layout of `staged_smem`
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* q = smem + round16((static_cast<long long>(E) * F + 16) * 2);
  __nv_bfloat16* sdg = reinterpret_cast<__nv_bfloat16*>(q);
  q += round16((E + 16) * 2LL);
  int* sptr = reinterpret_cast<int*>(q);  // ptr[b], all E + 1
  q += round16((E + 1) * 4LL);
  uint2* sent = reinterpret_cast<uint2*>(q);  // (gather id, value twice) an entry
  const uint32_t bar = smem_u32(&bar_storage);
  long long t0 = 0, t1 = 0, t2 = 0;
  if constexpr (kClock) t0 = clock64();

  // ---- wave 1: x[b] and the slice's diag by bulk copies, ptr by every thread
  const long long xb = static_cast<long long>(b) * E * F;
  const Span xs(x, xb, xb + static_cast<long long>(E) * F, static_cast<long long>(B) * E * F);
  const long long db = static_cast<long long>(b) * E;
  const Span ds(diag, db, db + E, static_cast<long long>(B) * E);
  if (tid == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect(bar, (xs.bulk() ? xs.bytes() : 0u) + (ds.bulk() ? ds.bytes() : 0u));
    xs.issue(sx, bar);
    ds.issue(sdg, bar);
  }
  const int* pb = ptr + static_cast<long long>(b) * (E + 1);
  for (int i0 = tid; i0 <= E; i0 += 4 * nthreads) {  // a thread's loads go out together
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = pb[min(i0 + u * nthreads, E)];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * nthreads <= E) sptr[i0 + u * nthreads] = v[u];
  }
  xs.plain(sx, tid, nthreads);
  ds.plain(sdg, tid, nthreads);
  __syncthreads();
  if constexpr (kClock) t1 = clock64();

  // ---- wave 2: the slice's entries in walk order, once its range is known
  const int p_base = sptr[r0];
  const int n_ent = max(sptr[r0 + nr] - p_base, 0);
  const long long eb = static_cast<long long>(b) * nnz;
  const unsigned short* vbits = reinterpret_cast<const unsigned short*>(vals);
  constexpr int kGather = 4;  // entries a thread loads at once
  for (int i0 = tid; i0 < n_ent; i0 += kGather * nthreads) {
    int e[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int i = min(i0 + u * nthreads, n_ent - 1);
      e[u] = T ? order[eb + p_base + i] : p_base + i;
    }
    int c[kGather];
    unsigned v[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      c[u] = index[eb + e[u]];
      v[u] = vbits[eb + e[u]];
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u)
      if (i0 + u * nthreads < n_ent) sent[i0 + u * nthreads] = make_uint2(c[u], v[u] | (v[u] << 16));
  }
  __syncthreads();
  bar_wait(bar);
  if constexpr (kClock) t2 = clock64();

  // ---- the walk, on shared memory ------------------------------------------
  // A group of G lanes a row, each lane V features.  Every lane reads its
  // row's entry words itself (the group's lanes read the same words),
  // kSteps at a time with their loads issued together and the next step's
  // words ahead; the adds run one after another in list order.  A step has
  // no branch: an entry past the row's end (which reads the row's first
  // word, or the slice's for an empty row) adds +0, which leaves the sum
  // as it is (a sum from +0 in round-to-nearest is never -0).
  const int fvn = F / V;
  const int groups = nthreads / G;
  const int g = tid / G, gl = tid % G;
  const __nv_bfloat16* sxb = sx + xs.shift;

  for (int base = 0; base < nr; base += groups) {
    if (base + g >= nr) break;
    const int r = r0 + base + g;
    const int p0 = sptr[r] - p_base;
    const int len = max(sptr[r + 1] - sptr[r], 0);
    for (int fv = gl; fv < fvn; fv += G) {
      const int foff = fv * V;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
      uint2 ent[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) ent[u] = sent[p0 + (u < len ? u : 0)];
      for (int k = 0; k < len; k += kSteps) {
        W xv[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u)
          xv[u] = *reinterpret_cast<const W*>(sxb + static_cast<long long>(ent[u].x) * F + foff);
        unsigned val[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const bool in = k + u < len;
          val[u] = in ? ent[u].y : 0u;
          if (!in) xv[u] = W{};  // +0 times +0: a product of +0, whatever x holds
          const int kn = k + kSteps + u;
          ent[u] = sent[p0 + (kn < len ? kn : 0)];  // the next step's, ahead
        }
#pragma unroll
        for (int u = 0; u < kSteps; ++u) VT::template madd<T>(acc, xv[u], val[u]);
      }
      const float d = __bfloat162float(sdg[ds.shift + r]);
      const W xr = *reinterpret_cast<const W*>(sxb + static_cast<long long>(r) * F + foff);
      float res[V];
#pragma unroll
      for (int qv = 0; qv < V; ++qv) {
        const float h = __fmul_rn(d, VT::get(xr, qv));  // exact: two bf16
        res[qv] = T ? __fadd_rn(acc[qv], round_bf16(h)) : __fadd_rn(acc[qv], h);
      }
      VT::store(out + (static_cast<long long>(b) * E + r) * F + foff, res);
    }
  }
  if constexpr (kClock) {
    __syncthreads();
    if (tid == 0) {
      const long long t3 = clock64();
      atomicAdd(&g_clock[0], static_cast<unsigned long long>(t1 - t0));
      atomicAdd(&g_clock[1], static_cast<unsigned long long>(t2 - t1));
      atomicAdd(&g_clock[2], static_cast<unsigned long long>(t3 - t2));
      atomicAdd(&g_clock[3], 1ull);
      atomicMax(&g_clock[4], static_cast<unsigned long long>(t3 - t0));
      atomicMax(&g_clock[5], static_cast<unsigned long long>(t3 - t2));
    }
  }
}

template <int G, int V, bool T>
int launch_staged(const void* ptr, const void* order, const void* index, const void* vals,
                  const void* diag, const void* x, void* out, int B, int E, int F, int nnz,
                  int S, int threads, int smem, void* stream) {
  auto kernel = chebconv_bf16_staged<G, V, T>;
  static int opted = -1;  // dynamic shared bytes this kernel may take
  if (opted < 0) {  // all of the SM's shared memory for blocks that fit beside each other
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = 48 * 1024;
  }
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  kernel<<<static_cast<unsigned>(static_cast<long long>(B) * S), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(order),
      static_cast<const int*>(index), static_cast<const __nv_bfloat16*>(vals),
      static_cast<const __nv_bfloat16*>(diag), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), B, E, F, nnz, S);
  return static_cast<int>(cudaGetLastError());
}

template <int V, bool T>
int launch_staged_v(const void* ptr, const void* order, const void* index, const void* vals,
                    const void* diag, const void* x, void* out, int B, int E, int F, int nnz,
                    int S, int threads, int smem, void* stream) {
  const int fv = F / V;
  const int g = fv <= 4 ? 4 : fv <= 8 ? 8 : fv <= 16 ? 16 : 32;
  switch (g) {
    case 4:
      return launch_staged<4, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                    threads, smem, stream);
    case 8:
      return launch_staged<8, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                    threads, smem, stream);
    case 16:
      return launch_staged<16, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                     threads, smem, stream);
    default:
      return launch_staged<32, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                     threads, smem, stream);
  }
}

bool aligned(const void* x, const void* out, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % bytes == 0;
}

}  // namespace

// The staged form of both walks (transposed = 0: the forward, `order`
// unused; 1: the transposed walk), S slices an instance, `threads` a block
// and `smem` dynamic shared bytes a block, as
// `scripts/bench_chebconv_staged.py:staged_launch` gives them; the operands
// as for the package's `mho_chebconv_propagate_bf16` and
// `mho_chebconv_transpose_bf16`.  Refuses (cudaErrorInvalidValue) a plan
// whose blocks do not hold its slice: fewer threads than a row's lanes or
// not whole warps, or less shared memory than `staged_smem`.  Returns the
// cudaError_t of the launch.
extern "C" int mho_chebconv_staged_bf16(int transposed, const void* ptr, const void* order,
                                        const void* index, const void* vals, const void* diag,
                                        const void* x, void* out, int B, int E, int F, int nnz,
                                        int S, int threads, int smem, void* stream) {
  const int v = F % 8 == 0 && F >= 32 && aligned(out, out, 16) ? 8
                : F % 4 == 0 && F >= 16 && aligned(out, out, 8) ? 4 : 1;
  const int fv = F / v;
  const int g = fv <= 4 ? 4 : fv <= 8 ? 8 : fv <= 16 ? 16 : 32;
  if (B <= 0 || E <= 0 || F <= 0 || S <= 0 || S > E || threads < g ||
      threads > kStagedThreads || threads % 32 != 0 ||
      smem < staged_smem(E, F, nnz) ||
      static_cast<long long>(B) * S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto walk) {
    constexpr bool T = decltype(walk)::value;
    if (v == 8)
      return launch_staged_v<8, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                   threads, smem, stream);
    if (v == 4)
      return launch_staged_v<4, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                   threads, smem, stream);
    return launch_staged_v<1, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, S,
                                 threads, smem, stream);
  };
  return transposed ? go(std::true_type{}) : go(std::false_type{});
}

// The staged blocks' clock64 split since the last call (cycles
// summed over blocks: loads issued and ptr in, staged, walked; the blocks;
// the longest block; the longest walk), into host[6], and zeroes it.
// Returns the cudaError_t.
extern "C" int mho_chebconv_staged_clock(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_clock, sizeof(g_clock));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_clock, zero, sizeof(zero)));
}
