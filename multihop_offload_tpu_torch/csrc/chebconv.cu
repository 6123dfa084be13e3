// The ChebConv propagate of a batch of supports, as one row walk:
//
//     out[b, r, f] = diag[b, r] * x[b, r, f]
//                  + sum_{p in [ptr[b, r], ptr[b, r + 1])} vals[b, e] * x[b, index[b, e], f],
//     e = order[b, p] (e = p when order is null)
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/chebconv.py:
// chebconv_propagate_pallas` (`_chebconv_kernel`), which walks edge blocks
// in grid order and turns gather and segment-sum into two one-hot matrix
// products accumulated in a VMEM-resident output block.  Hopper has no
// in-order grid to carry that accumulator, and one-hot products would
// spend E times the needed work, so the kernel reads the list by row
// through a row index.  Three callers launch it:
// - K4's forward: the host CSR index of the list (`layouts/sparse.py:
//   csr_index`), whose real entries come sorted by row (`np.nonzero`
//   order), so row r is the range [ptr[r], ptr[r + 1]) and order is null;
//   the pads lie past every range and are never read;
// - K4's backward (d x, the propagate over the transposed list): each
//   column's range of `order`, the column-sorted entry ids, with the row
//   ends as the gather index;
// - K5 (`chebconv_ragged.cu` sorts each slot's live prefix on the card),
//   forward over (row_ptr, row_order, cols), d x over (col_ptr, col_order,
//   rows).
//
// What bounds it on an H100: bytes in principle (each entry's 12 bytes,
// diag, x and out once: a few MB, ~2 us at 3.35 TB/s), latency in
// practice: a row's sum is a chain of dependent loads (ptr, then order,
// then index and vals, then x) and, to stay the CPU's sum, its adds run
// one after another in list order.
//
// Design: a group of G lanes owns a row, its lanes over the features in
// vectors of V floats (V = 4 where F is a multiple of 4 and at least 16,
// and x and out are 16-byte aligned; else 1), G the next power of two
// >= F / V (at least 4, at most 32; wider F in passes): F = 32 is 8 lanes
// of float4, 4 rows a warp; F = 4 is 4 lanes, 8 rows a warp.  The group
// reads its row in chunks of min(4 G, 32) entries: lane j loads the
// metadata (order, index, vals) of entries j, j + G, ..., coalesced, and
// the group shuffles each entry's column and value to its feature lanes.
// The loads are written as straight runs at valid addresses (no branch
// per entry), so that each run is in flight at once, and they are
// pipelined: the entry ids (order) of chunk c + 2 and the index and vals
// of chunk c + 1 are loaded while chunk c is summed, and within a chunk
// (at V = 1) the x gathers of the next batch of 8 entries go out before
// the adds of the current one.  A long row thus costs about one x latency
// per batch plus the add chain, not 2-3 dependent latencies per entry.
// Each (row, feature) sum runs over its entries in list order with
// `__fmul_rn` / `__fadd_rn` (no fused multiply-add) and no atomics, then
// adds diag * x, as the plain version's sequential `index_add` does: the
// result is bit-identical to the CPU's and deterministic.
//
// x is read from device memory (through L1 and L2), not staged in shared
// memory.  Staging was not measured: a block covers 8 to 64 rows of one
// slot, so staging x[b] (42 KB at E=328, F=32) would copy several times
// the x bytes the block gathers, and the whole x of a call (2.7 MB at
// (64, 328, 32)) stays in the 50 MB L2 anyway.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&a)[1]) { *p = a[0]; }
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
  static __device__ __forceinline__ float get(const T& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

// G lanes per row, V floats per lane and pass
template <int G, int V>
__global__ void __launch_bounds__(kThreads)
chebconv_walk_kernel(const int* __restrict__ ptr,     // (B, E + 1)
                     const int* __restrict__ order,   // (B, nnz) or null
                     const int* __restrict__ index,   // (B, nnz) gather ids
                     const float* __restrict__ vals,  // (B, nnz)
                     const float* __restrict__ diag,  // (B, E)
                     const float* __restrict__ x,     // (B, E, F)
                     float* __restrict__ out,         // (B, E, F)
                     int B, int E, int F, int nnz) {
  using VT = Vec<V>;
  constexpr int C = 4 * G < 32 ? 4 * G : 32;  // entries of a row per chunk
  constexpr int P = C / G;                    // of them, each lane's metadata
  constexpr int NB = 8;                        // entries per batch of x gathers
  constexpr int NBAT = C / NB;                // batches per chunk
  // the next batch's gathers go out before this batch's adds where the
  // second buffer is cheap (V = 1: 8 registers); at V = 4 its 32
  // registers cost more occupancy than the overlap gains (measured)
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
  const int* o = order == nullptr ? nullptr : order + lb;
  const int* ix = index + lb;
  const float* vl = vals + lb;
  const float* xb = x + static_cast<long long>(b) * E * F;
  const int fvn = F / V;

  // A chunk's metadata in straight runs of loads at valid positions (an
  // entry past the row reads position 0 and is zeroed after its load), so
  // that each run is in flight at once: the entry ids (order) two chunks
  // ahead, index and vals one chunk ahead.
  auto entry_ids = [&](int c, int (&e)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = c * C + gl + i * G;
      e[i] = k < len ? p0 + k : 0;
    }
    if (o != nullptr) {
#pragma unroll
      for (int i = 0; i < P; ++i) e[i] = o[e[i]];
    }
  };
  auto gather_meta = [&](int c, const int (&e)[P], int (&cc)[P], float (&vv)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      cc[i] = ix[e[i]];
      vv[i] = vl[e[i]];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (c * C + gl + i * G >= len) {
        cc[i] = 0;
        vv[i] = 0.0f;
      }
    }
  };

  for (int fv0 = 0; fv0 < fvn; fv0 += G) {
    const int fv = fv0 + gl;
    const bool fok = has_row && fv < fvn;
    const int foff = fv * V;
    // the gathers run unconditionally, at a valid address (an entry past
    // the row reads column 0, a lane past F the last vector), so that a
    // batch's loads are straight-line code issued before the adds
    const int foff_ld = min(fv, fvn - 1) * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;

    int col[P], e1[P];
    float val[P];
    if (nchunks > 0) {
      int e0[P];
      entry_ids(0, e0);
      gather_meta(0, e0, col, val);
      entry_ids(1, e1);
    }
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
      int ncol[P], e2[P];
      float nval[P];
      if (more) {
        gather_meta(c + 1, e1, ncol, nval);
        entry_ids(c + 2, e2);
      }
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
            const float v = __shfl_sync(kFull, val[k / G], k % G, G);
            if (fok && k < cnt) {
#pragma unroll
              for (int q = 0; q < V; ++q)
                acc[q] = __fadd_rn(acc[q], __fmul_rn(v, VT::get(xa[u], q)));
            }
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
          e1[i] = e2[i];
        }
      }
    }
    if (fok) {
      const float d = diag[row];
      const typename VT::T xr = VT::load(xb + static_cast<long long>(r) * F + foff);
      float res[V];
#pragma unroll
      for (int q = 0; q < V; ++q) res[q] = __fadd_rn(acc[q], __fmul_rn(d, VT::get(xr, q)));
      VT::store(out + row * F + foff, res);
    }
  }
}

template <int G, int V>
cudaError_t launch(const int* ptr, const int* order, const int* index, const float* vals,
                   const float* diag, const float* x, float* out, int B, int E, int F,
                   int nnz, cudaStream_t stream) {
  const long long rows_per_block = kThreads / G;
  const long long blocks = (static_cast<long long>(B) * E + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  chebconv_walk_kernel<G, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ptr, order, index, vals, diag, x, out, B, E, F, nnz);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_v(int g, const int* ptr, const int* order, const int* index,
                     const float* vals, const float* diag, const float* x, float* out,
                     int B, int E, int F, int nnz, cudaStream_t s) {
  switch (g) {
    case 4: return launch<4, V>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, s);
    case 8: return launch<8, V>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, s);
    case 16: return launch<16, V>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, s);
    default: return launch<32, V>(ptr, order, index, vals, diag, x, out, B, E, F, nnz, s);
  }
}

}  // namespace

// Launches the walk on `stream`; returns the cudaError_t of the launch
// (0 = success).  ptr (B, E + 1) int32; order (B, nnz) int32 or null (the
// identity); index (B, nnz) int32; vals (B, nnz), diag (B, E), x and out
// (B, E, F) float32; all contiguous.
extern "C" int mho_chebconv_propagate_f32(const void* ptr, const void* order,
                                          const void* index, const void* vals,
                                          const void* diag, const void* x, void* out,
                                          int B, int E, int F, int nnz, void* stream) {
  const bool aligned = (reinterpret_cast<unsigned long long>(x) % 16 == 0) &&
                       (reinterpret_cast<unsigned long long>(out) % 16 == 0);
  const int v = (F % 4 == 0 && F >= 16 && aligned) ? 4 : 1;
  const int fv = F / v;
  const int g = fv <= 4 ? 4 : fv <= 8 ? 8 : fv <= 16 ? 16 : 32;
  const auto* p = static_cast<const int*>(ptr);
  const auto* o = static_cast<const int*>(order);
  const auto* ix = static_cast<const int*>(index);
  const auto* vl = static_cast<const float*>(vals);
  const auto* dg = static_cast<const float*>(diag);
  const auto* xx = static_cast<const float*>(x);
  auto* y = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = v == 4 ? launch_v<4>(g, p, o, ix, vl, dg, xx, y, B, E, F, nnz, s)
                                 : launch_v<1>(g, p, o, ix, vl, dg, xx, y, B, E, F, nnz, s);
  return static_cast<int>(err);
}
