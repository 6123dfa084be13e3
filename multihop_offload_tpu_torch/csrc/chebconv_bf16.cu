// The ChebConv propagate of a batch of bf16 supports, forward, as a row
// walk with fp32 accumulation:
//
//     out[b, r, f] = bf16( sum_{p in [ptr[b, r], ptr[b, r + 1])}
//                              bf16(vals[b, p] * x[b, index[b, p], f])
//                          + diag[b, r] * x[b, r, f] )
//
// the sum taken in fp32 in list order and rounded to bf16 once.  Replaces
// the TPU kernel `multihop_offload_tpu/ops/chebconv.py:
// chebconv_propagate_pallas` (`_chebconv_kernel`) on the bf16 leg of the
// precision policy, where x and the support are bf16 and the accumulation
// is fp32 (`ops/chebconv.py:203`, the math of `_xla_propagate`: each
// entry's product is a bf16 product, widened before the segment sum).  It
// walks the host CSR index of the list as the float32 kernel's forward
// does (`csrc/chebconv.cu`): row r is the range [ptr[r], ptr[r + 1]) of the
// row-sorted real entries, and the pads are never read.
//
// The transposed walk (`mho_chebconv_transpose_bf16`, the backward of the
// propagate under the Trainer's bf16 policy) follows JAX's VJP of
// `_xla_propagate` instead, which does not sum in fp32:
//
//     out[b, c, f] = bf16( acc[b, c, f] + bf16(diag[b, c] * x[b, c, f]) ),
//     acc <- bf16(acc + bf16(vals[b, e] * x[b, index[b, e], f])), from +0,
//
// over the entries e = order[b, p] of column c, p in [ptr[b, c], ptr[b, c
// + 1]) (the column ranges of `col_ptr` / `col_order`, list order within
// a column): the cotangents of the bf16 products are scatter-added in bf16,
// one rounding an add, and the diagonal term, itself rounded, comes last
// (`ops/chebconv.py:chebconv_transpose_bf16_plain`).  The chain of
// roundings is sequential per (column, feature), so it is the same loop as
// the forward with each add rounded to bf16 before the next one reads it,
// and the same bits on every call.  Each add is an fp32 add of two bf16
// values, rounded to bf16: an fp32 sum of two bf16 is within 2^-24 of
// the exact one, far inside half a bf16 ulp, so the two roundings give
// the one correct rounding the CPU's bf16 add gives.  The column's entry
// ids come through `order` (one more dependent load an entry, made for the
// whole chunk before the index and vals loads).  Its bound is the
// forward's bytes and 4 more an entry (the entry id); in practice the
// chain: a column's adds wait for one another, as the forward's do, with a
// rounding more in each link.
//
// What bounds it on an H100: bytes in principle (each entry's 6 bytes,
// diag, x and out once), latency in practice: a row's sum is a chain of
// dependent loads (ptr, then index and vals, then x) whose adds run one
// after another in list order.  A first version, a thread per (row,
// feature) walking its row alone, took twice the time of `torch.bmm` on
// the dense support at (64, 328, 32): every thread waited two load
// latencies an entry, and wider words a thread only cut the threads in
// flight.
//
// Design, the float32 kernel's with bf16 words: a group of G lanes owns a
// row, its lanes over the features in words of V bf16 (V = 4, 8 bytes,
// where F is a multiple of 4 and at least 16 and x and out are 8-byte
// aligned; else 1), G the next power of two >= F / V (at least 4, at most
// 32; wider F in passes): F = 32 is 8 lanes, 4 rows a warp; F = 4 is 4
// lanes, 8 rows a warp.
// The group reads its row in chunks of min(4 G, 32) entries: lane j loads
// the index and vals of entries j, j + G, ..., coalesced, one chunk ahead,
// and the group shuffles each entry's column and value to its feature
// lanes; within a chunk the x gathers of a batch of 8 entries go out
// together (at V = 1 the next batch's before this one's adds; at V = 4
// that costs more than it hides, measured).  Each product is the card's
// bf16 multiply, two features an instruction (`__hmul2`): the product of
// two bf16 is exact in fp32, so one rounding to bf16 gives the plain
// version's bf16 product.  Each (row, feature) sum runs over its entries
// in list order with `__fadd_rn`, no atomics, then adds diag * x in fp32
// (`__fmul_rn`, no fused multiply-add) and rounds once: the result is the
// plain version's (`layouts/sparse.py:propagate_edges`: bf16 products, a
// sequential fp32 `index_add`, then diag * x), whatever V and G, and the
// same on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// G lanes per row, V bf16 per lane and pass; T: the transposed walk (entry
// ids through `order`, each add rounded, diag * x rounded and added last)
template <int G, int V, bool T>
__global__ void __launch_bounds__(kThreads)
chebconv_bf16_kernel(const int* __restrict__ ptr,             // (B, E + 1)
                     const int* __restrict__ order,           // (B, nnz) entry ids (T)
                     const int* __restrict__ index,           // (B, nnz) gather ids
                     const __nv_bfloat16* __restrict__ vals,  // (B, nnz)
                     const __nv_bfloat16* __restrict__ diag,  // (B, E)
                     const __nv_bfloat16* __restrict__ x,     // (B, E, F)
                     __nv_bfloat16* __restrict__ out,         // (B, E, F)
                     int B, int E, int F, int nnz) {
  using VT = Vec<V>;
  constexpr int C = 4 * G < 32 ? 4 * G : 32;  // entries of a row per chunk
  constexpr int P = C / G;                    // of them, each lane's metadata
  constexpr int NB = 8;                        // entries per batch of x gathers
  constexpr int NBAT = C / NB;                // batches per chunk
  // the next batch's gathers go out before this batch's adds at V = 1
  // (at V = 4 the second buffer costs more occupancy than it hides)
  constexpr bool kPrefetchX = V == 1;
  const int gl = threadIdx.x % G;
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool has_row = row < static_cast<long long>(B) * E;
  const int b = has_row ? static_cast<int>(row / E) : 0;
  const int r = has_row ? static_cast<int>(row % E) : 0;
  int p0 = 0, len = 0;
  if (has_row) {
    const int* rp = ptr + static_cast<long long>(b) * (E + 1);
    p0 = rp[r];
    len = max(rp[r + 1] - p0, 0);
  }
  // every lane of the warp runs the same chunks: the shuffles need them all
  const int nchunks = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>((len + C - 1) / C)));
  const long long lb = static_cast<long long>(b) * nnz;
  const int* ix = index + lb;
  const int* od = T ? order + lb : nullptr;
  const __nv_bfloat16* vl = vals + lb;
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * E * F;
  const int fvn = F / V;

  // A chunk's metadata in straight runs of loads at valid positions (an
  // entry past the row reads position 0 and is zeroed after its load).
  auto gather_meta = [&](int c, int (&cc)[P], unsigned (&vv)[P]) {
    int e[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = c * C + gl + i * G;
      e[i] = k < len ? p0 + k : 0;
    }
    if constexpr (T) {  // a column's entry ids, all loads out before any is used
      int o[P];
#pragma unroll
      for (int i = 0; i < P; ++i) o[i] = od[e[i]];
#pragma unroll
      for (int i = 0; i < P; ++i) e[i] = o[i];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      cc[i] = ix[e[i]];
      const unsigned bits = __bfloat16_as_ushort(vl[e[i]]);
      vv[i] = bits | (bits << 16);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (c * C + gl + i * G >= len) {
        cc[i] = 0;
        vv[i] = 0u;
      }
    }
  };

  for (int fv0 = 0; fv0 < fvn; fv0 += G) {
    const int fv = fv0 + gl;
    const bool fok = has_row && fv < fvn;
    const int foff = fv * V;
    // the gathers run unconditionally, at a valid address (an entry past
    // the row reads column 0, a lane past F the last word), so that a
    // batch's loads are straight-line code issued before the adds
    const int foff_ld = min(fv, fvn - 1) * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;

    int col[P];
    unsigned val[P];  // each entry's vals in bf16, twice (a bf16x2)
    if (nchunks > 0) gather_meta(0, col, val);
    auto load_batch = [&](int j, typename VT::T (&xv)[NB]) {
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int k = j * NB + u;
        const int cc = __shfl_sync(kFull, col[k / G], k % G, G);
        xv[u] = VT::load(xb + static_cast<long long>(cc) * F + foff_ld);
      }
    };
    for (int c = 0; c < nchunks; ++c) {
      const bool more = c + 1 < nchunks;  // warp-uniform
      int ncol[P];
      unsigned nval[P];
      if (more) gather_meta(c + 1, ncol, nval);
      const int cnt = min(max(len - c * C, 0), C);
      const int wcnt = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(cnt)));
      typename VT::T xa[NB], xn[NB];
      load_batch(0, xa);
#pragma unroll
      for (int j = 0; j < NBAT; ++j) {
        if (j * NB < wcnt) {  // warp-uniform
          const bool next = j + 1 < NBAT && (j + 1) * NB < wcnt;
          if (kPrefetchX && next) load_batch(j + 1, xn);
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int k = j * NB + u;
            const unsigned v2 = __shfl_sync(kFull, val[k / G], k % G, G);
            if (fok && k < cnt) VT::template madd<T>(acc, xa[u], v2);
          }
          if (kPrefetchX) {
#pragma unroll
            for (int u = 0; u < NB; ++u) xa[u] = xn[u];
          } else if (next) {
            load_batch(j + 1, xa);
          }
        }
      }
      if (more) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          col[i] = ncol[i];
          val[i] = nval[i];
        }
      }
    }
    if (fok) {
      const float d = __bfloat162float(diag[row]);
      const typename VT::T xr = VT::load(xb + static_cast<long long>(r) * F + foff);
      float res[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float h = __fmul_rn(d, VT::get(xr, q));  // exact: two bf16
        res[q] = T ? __fadd_rn(acc[q], round_bf16(h)) : __fadd_rn(acc[q], h);
      }
      VT::store(out + row * F + foff, res);
    }
  }
}

template <int G, int V, bool T>
int launch(const void* ptr, const void* order, const void* index, const void* vals,
           const void* diag, const void* x, void* out, int B, int E, int F, int nnz,
           void* stream) {
  const long long rows_per_block = kThreads / G;
  const long long blocks = (static_cast<long long>(B) * E + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  chebconv_bf16_kernel<G, V, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(order),
      static_cast<const int*>(index), static_cast<const __nv_bfloat16*>(vals),
      static_cast<const __nv_bfloat16*>(diag), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), B, E, F, nnz);
  return static_cast<int>(cudaGetLastError());
}

template <int V, bool T>
int launch_v(const void* ptr, const void* order, const void* index, const void* vals,
             const void* diag, const void* x, void* out, int B, int E, int F, int nnz,
             void* stream) {
  const int fv = F / V;
  const int g = fv <= 4 ? 4 : fv <= 8 ? 8 : fv <= 16 ? 16 : 32;
  switch (g) {
    case 4: return launch<4, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
    case 8: return launch<8, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
    case 16:
      return launch<16, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
    default:
      return launch<32, V, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
  }
}

template <bool T>
int launch_width(int v, const void* ptr, const void* order, const void* index,
                 const void* vals, const void* diag, const void* x, void* out, int B, int E,
                 int F, int nnz, void* stream) {
  if (v == 4) return launch_v<4, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
  return launch_v<1, T>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
}

bool aligned(const void* x, const void* out, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % bytes == 0;
}

}  // namespace

// out (B, E, F) bf16 on `stream`; returns the cudaError_t of the launch
// (0 = success).  ptr (B, E + 1) and index (B, nnz) int32; vals (B, nnz),
// diag (B, E) and x (B, E, F) bf16; all contiguous.
extern "C" int mho_chebconv_propagate_bf16(const void* ptr, const void* index,
                                           const void* vals, const void* diag,
                                           const void* x, void* out, int B, int E, int F,
                                           int nnz, void* stream) {
  const int v = F % 4 == 0 && F >= 16 && aligned(x, out, 8) ? 4 : 1;
  return launch_width<false>(v, ptr, nullptr, index, vals, diag, x, out, B, E, F, nnz, stream);
}

// The transposed walk: out (B, E, F) bf16 on `stream`, column c the entries
// order[b, p], p in [ptr[b, c], ptr[b, c + 1]), gathering x at index[b, e]
// (the rows); ptr (B, E + 1), order and index (B, nnz) int32; vals (B, nnz),
// diag (B, E) and x (B, E, F) bf16; all contiguous.  Returns the
// cudaError_t of the launch.
extern "C" int mho_chebconv_transpose_bf16(const void* ptr, const void* order,
                                           const void* index, const void* vals,
                                           const void* diag, const void* x, void* out, int B,
                                           int E, int F, int nnz, void* stream) {
  const int v = F % 4 == 0 && F >= 16 && aligned(x, out, 8) ? 4 : 1;
  return launch_width<true>(v, ptr, order, index, vals, diag, x, out, B, E, F, nnz, stream);
}

// The same walk at a chosen word width V (1 or 4; F must be a multiple of
// it, and x and out aligned to its bytes), for
// `scripts/bench_chebconv_bf16.py`.
extern "C" int mho_chebconv_propagate_bf16_v(int v, const void* ptr, const void* index,
                                             const void* vals, const void* diag,
                                             const void* x, void* out, int B, int E, int F,
                                             int nnz, void* stream) {
  if ((v != 1 && v != 4) || F % v != 0 || !aligned(x, out, 2 * v))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_width<false>(v, ptr, nullptr, index, vals, diag, x, out, B, E, F, nnz, stream);
}
