// The sparse-layout ChebConv propagate of a batch of supports:
//
//     out[b, r, f] = diag[b, r] * x[b, r, f] + sum_{e : rows[b, e] == r} vals[b, e] * x[b, cols[b, e], f]
//
// Replaces the TPU kernel `multihop_offload_tpu/ops/chebconv.py:
// chebconv_propagate_pallas` (`_chebconv_kernel`), which walks edge blocks
// in grid order and turns gather and segment-sum into two one-hot matrix
// products accumulated in a VMEM-resident output block.  Hopper has no
// in-order grid to carry that accumulator, and one-hot products would
// spend E times the needed work, so the kernel reads the list by row
// instead, through a CSR index the host builds with the list, once per
// instance (`layouts/sparse.py:csr_index`): the list holds its real
// entries sorted by row (`np.nonzero` order), so row r's entries are the
// range [ptr[r], ptr[r + 1]); the padding entries (row=0, col=0, val=0)
// lie past every range and are never read, so they cannot be mistaken for
// row 0's entries.  The backward pass (d x = propagate over the transposed
// list) walks each column's range of `order`, the column-sorted entry ids,
// and reads the row ends as its gather index; it needs no symmetric
// support.
//
// What bounds it on an H100: bytes.  Each entry costs one multiply-add per
// feature against 12 bytes of (row, col, val), and x is read about
// nnz / E times; the whole call is a few MB, so it is a memory-latency
// bound gather, far from the ALUs.
//
// What the design does about it: one thread per (batch, row, feature),
// neighbouring threads on neighbouring features, so a row's F threads read
// its entry ids and values once per entry (broadcast) and x[col] as one
// contiguous run.  Each output is a sequential sum in the list's own order
// with no atomics, so the result is deterministic, and with no fused
// multiply-add (`__fmul_rn`, `__fadd_rn`) it is the sum the CPU's
// sequential `index_add` forms, then plus diag * x, as the plain version
// does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chebconv_propagate_kernel(const int* __restrict__ ptr,     // (B, E + 1)
                          const int* __restrict__ order,   // (B, nnz) or null
                          const int* __restrict__ index,   // (B, nnz) gather ids
                          const float* __restrict__ vals,  // (B, nnz)
                          const float* __restrict__ diag,  // (B, E)
                          const float* __restrict__ x,     // (B, E, F)
                          float* __restrict__ out,         // (B, E, F)
                          int B, int E, int F, int nnz) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(B) * E * F) return;
  const int f = static_cast<int>(t % F);
  const long long be = t / F;
  const int r = static_cast<int>(be % E);
  const int b = static_cast<int>(be / E);
  const int* rp = ptr + static_cast<long long>(b) * (E + 1);
  const int* o = order == nullptr ? nullptr : order + static_cast<long long>(b) * nnz;
  const int* c = index + static_cast<long long>(b) * nnz;
  const float* v = vals + static_cast<long long>(b) * nnz;
  const float* xb = x + static_cast<long long>(b) * E * F;
  float acc = 0.0f;
  const int p1 = rp[r + 1];
  for (int p = rp[r]; p < p1; ++p) {
    const int e = o == nullptr ? p : o[p];
    acc = __fadd_rn(acc, __fmul_rn(v[e], xb[static_cast<long long>(c[e]) * F + f]));
  }
  out[t] = __fadd_rn(acc, __fmul_rn(diag[be], xb[static_cast<long long>(r) * F + f]));
}

}  // namespace

// Launches the propagate on `stream`; returns the cudaError_t of the launch
// (0 = success).  ptr (B, E + 1) int32; order (B, nnz) int32 or null (the
// identity); index (B, nnz) int32; vals (B, nnz), diag (B, E), x and out
// (B, E, F) float32; all contiguous.
extern "C" int mho_chebconv_propagate_f32(const void* ptr, const void* order,
                                          const void* index, const void* vals,
                                          const void* diag, const void* x, void* out,
                                          int B, int E, int F, int nnz, void* stream) {
  const long long total = static_cast<long long>(B) * E * F;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  chebconv_propagate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(order),
      static_cast<const int*>(index), static_cast<const float*>(vals),
      static_cast<const float*>(diag), static_cast<const float*>(x),
      static_cast<float*>(out), B, E, F, nnz);
  return static_cast<int>(cudaGetLastError());
}
